"""The port's state converter and init held to the JAX package's
``MetaState``: ``from_numpy(jax.device_get(init_state(cfg)))`` round-trips
exactly, with the same keys, shapes and dtypes."""

import jax
import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu.config import MAMLConfig as JaxConfig
from howtotrainyourmamlpytorch_tpu.core import maml as jax_maml
from howtotrainyourmamlpytorch_tpu_torch import state as state_lib
from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig

torch.set_num_threads(2)

GEOMETRY = dict(
    dataset_name="omniglot_dataset", image_height=11, image_width=11,
    image_channels=3, num_classes_per_set=3, num_samples_per_class=1,
    num_target_samples=2, batch_size=2, cnn_num_filters=4, num_stages=2,
    max_pooling=True, learnable_per_layer_per_step_inner_loop_learning_rate=True,
    number_of_training_steps_per_iter=2, number_of_evaluation_steps_per_iter=3,
    use_remat=False,
)
VARIANTS = {
    "per_step_bn": dict(per_step_bn_statistics=True),
    "shared_bn": dict(per_step_bn_statistics=False),
    "adapted_bn": dict(per_step_bn_statistics=True,
                       enable_inner_loop_optimizable_bn_params=True),
}


def _cfgs(variant):
    kw = {**GEOMETRY, **VARIANTS[variant]}
    return JaxConfig(**kw), MAMLConfig(**kw)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_from_numpy_round_trips_the_jax_state(variant):
    jcfg, _ = _cfgs(variant)
    host = jax.device_get(jax_maml.init_state(jcfg, seed=3))
    port = state_lib.from_numpy(host, device="cpu")
    back = state_lib.to_numpy(port)
    for name in ("net", "lslr", "bn"):
        want = getattr(host, name)
        got = getattr(back, name)
        assert sorted(got) == sorted(want), name
        for key in want:
            assert got[key].shape == np.shape(want[key]), key
            assert got[key].dtype == np.asarray(want[key]).dtype, key
            np.testing.assert_array_equal(got[key], want[key])
        for key, t in getattr(port, name).items():
            assert isinstance(t, torch.Tensor) and t.device.type == "cpu"


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_init_state_has_the_jax_layout(variant):
    jcfg, cfg = _cfgs(variant)
    want = jax.device_get(jax_maml.init_state(jcfg))
    got = state_lib.to_numpy(state_lib.init_state(cfg, device="cpu"))
    for name in ("net", "lslr", "bn"):
        w, g = getattr(want, name), getattr(got, name)
        assert sorted(g) == sorted(w), name
        for key in w:
            assert g[key].shape == np.shape(w[key]), key
            assert g[key].dtype == np.asarray(w[key]).dtype, key
    # the deterministic leaves agree exactly (zeros, ones, the LSLR init)
    for key in got.lslr:
        np.testing.assert_array_equal(got.lslr[key], want.lslr[key])
    for key in got.bn:
        np.testing.assert_array_equal(got.bn[key], want.bn[key])
    for key in got.net:
        if not key.endswith(".weight"):
            np.testing.assert_array_equal(got.net[key], want.net[key])


def test_init_state_is_seeded():
    _, cfg = _cfgs("per_step_bn")
    a = state_lib.init_state(cfg, seed=1, device="cpu")
    b = state_lib.init_state(cfg, seed=1, device="cpu")
    c = state_lib.init_state(cfg, seed=2, device="cpu")
    w = "conv0.conv.weight"
    assert torch.equal(a.net[w], b.net[w])
    assert not torch.equal(a.net[w], c.net[w])
    # xavier-uniform bound sqrt(6 / (fan_in + fan_out))
    bound = np.sqrt(6.0 / (9 * 3 + 9 * 4))
    assert float(a.net[w].abs().max()) <= bound
