"""The config fields the port accepts and ignores because none of them
changes the numbers: ``use_remat`` with ``remat_policy`` (the JAX package
wraps the inner step in ``jax.checkpoint``, which bounds memory) and
``task_axis_mode`` (``vmap`` or ``lax.map`` over the tasks). Under each
setting the port's second-order meta-gradients equal its own under the
defaults bit for bit, and hold to the JAX package's step under the same
setting at the tolerances of ``test_torch_train.py`` (the JAX side run
eagerly, at that file's tiny geometry).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu.core import maml as jax_maml
from howtotrainyourmamlpytorch_tpu_torch import state as state_lib
from howtotrainyourmamlpytorch_tpu_torch.core import maml
from test_torch_train import (
    LOSS_RTOL,
    WEIGHTS,
    _assert_grads,
    _batch,
    _cfgs,
    _jax,
    _torch,
)

torch.set_num_threads(2)

#: (use_remat, remat_policy): off, the full checkpoint, and the policy
#: that saves the conv outputs
REMAT = {"no remat": (False, "full"), "remat full": (True, "full"),
         "remat save_conv": (True, "save_conv")}


@pytest.mark.parametrize("task_axis_mode", ["vmap", "map"])
@pytest.mark.parametrize("remat", list(REMAT))
def test_ignored_fields_keep_the_meta_grads(remat, task_axis_mode):
    use_remat, policy = REMAT[remat]
    jcfg, cfg = _cfgs(use_remat=use_remat, remat_policy=policy,
                      task_axis_mode=task_axis_mode)
    _, default = _cfgs()
    assert (cfg.use_remat, cfg.remat_policy, cfg.task_axis_mode) == (
        use_remat, policy, task_axis_mode)
    jstate = jax_maml.init_state(jcfg, seed=4)
    state = state_lib.from_numpy(jax.device_get(jstate), device="cpu")
    batch = _batch(cfg, 1)
    with jax.disable_jit():
        jloss, jgrads = jax_maml.make_grads_fn(jcfg, True)(
            jstate, *_jax(batch), jnp.asarray(WEIGHTS))
    loss, grads = maml.make_grads_fn(cfg, True)(state, *_torch(batch),
                                                WEIGHTS)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    _assert_grads(grads, jax.device_get(jgrads))
    dloss, dgrads = maml.make_grads_fn(default, True)(
        state, *_torch(batch), WEIGHTS)
    assert float(dloss) == float(loss)
    for group in dgrads:
        for key, g in dgrads[group].items():
            assert torch.equal(grads[group][key], g), (group, key)
