"""Boundaries of the PyTorch port:

* no module of the port, and not ``chip_smoke.py``, imports jax, jaxlib,
  optax, orbax or anything of the JAX package (checked on the AST, so
  every import counts, however deep in a function it sits);
* nor ``triton``: every kernel of the port is hand-written CUDA C++, and
  the Triton modules that held the last of them are gone;
* entry points run on the card unless asked for the CPU: with no CUDA
  device and no device named, they raise naming ``--device cpu``;
* a tensor that is not on the CPU never reaches a plain version: the
  wrappers launch their kernel or raise;
* second order through the block works, and the one derivative no path
  takes (K5's own, the block's third) raises;
* the port's config loads every experiment JSON as the JAX package's does.
"""

import ast
import dataclasses
import glob
import importlib
import os

import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu.config import MAMLConfig as JaxConfig
from howtotrainyourmamlpytorch_tpu_torch import state as state_lib
from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
from howtotrainyourmamlpytorch_tpu_torch.kernels import conv_block
from howtotrainyourmamlpytorch_tpu_torch.serving import bench
from howtotrainyourmamlpytorch_tpu_torch.serving.engine import ServingEngine

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "howtotrainyourmamlpytorch_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "optax", "orbax", "howtotrainyourmamlpytorch_tpu")


def _port_files():
    files = sorted(glob.glob(os.path.join(PORT, "**", "*.py"), recursive=True))
    return files + [os.path.join(ROOT, "chip_smoke.py")]


def _imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant):
            yield str(node.args[0].value)


def _forbidden(name):
    root = name.split(".")[0]
    return root in FORBIDDEN


def test_the_forbidden_rule():
    assert _forbidden("jax.numpy") and _forbidden("optax")
    assert _forbidden("howtotrainyourmamlpytorch_tpu.config")
    assert _forbidden("howtotrainyourmamlpytorch_tpu")
    assert not _forbidden("howtotrainyourmamlpytorch_tpu_torch.config")
    assert not _forbidden("torch")


@pytest.mark.parametrize(
    "path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_port_imports_nothing_of_jax(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


@pytest.mark.parametrize(
    "path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_port_imports_no_triton(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] == "triton"]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"
    src = open(path).read()
    assert "triton.jit" not in src and "tl.constexpr" not in src


@pytest.mark.parametrize("gone", ["bn_act_pool", "act_pool"])
def test_the_triton_modules_are_gone(gone):
    with pytest.raises(ImportError):
        importlib.import_module(
            f"howtotrainyourmamlpytorch_tpu_torch.kernels.{gone}")


def _tiny_cfg():
    return MAMLConfig(
        dataset_name="omniglot_dataset", image_height=10, image_width=10,
        image_channels=1, num_classes_per_set=2, num_samples_per_class=1,
        num_target_samples=1, cnn_num_filters=4, num_stages=2,
        max_pooling=True, per_step_bn_statistics=True,
        serving_bucket_ladder=[1], serving_max_tenants_per_dispatch=1,
    )


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_without_a_device_raise_when_cuda_is_absent(no_cuda):
    cfg = _tiny_cfg()
    with pytest.raises(RuntimeError, match="--device cpu"):
        state_lib.init_state(cfg)
    host = state_lib.to_numpy(state_lib.init_state(cfg, device="cpu"))
    with pytest.raises(RuntimeError, match="--device cpu"):
        ServingEngine(cfg, host)
    with pytest.raises(RuntimeError, match="--device cpu"):
        state_lib.from_numpy(host)
    with pytest.raises(RuntimeError, match="--device cpu"):
        bench.run(["--fast"])
    with pytest.raises(RuntimeError, match="--device cpu"):
        ServingEngine(cfg, host, device="cuda:0")


def _meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, device="meta", dtype=dtype)


def test_wrappers_never_take_the_plain_path_off_the_cpu():
    """A tensor that is not on the CPU goes to the kernel path, which
    refuses anything but CUDA; it is never quietly computed in plain ops."""
    x = _meta(1, 2, 6, 6, 3)
    w = _meta(1, 3, 3, 3, 4)
    b = _meta(1, 4)
    y = _meta(1, 2, 6, 6, 4)
    v = _meta(1, 4)
    s, p = _meta(1, 2), _meta(1, 6, 6, 4)  # layer-norm statistics, params
    conv_block.reset_launches()
    calls = [
        lambda: conv_block.conv3x3_fwd_stats(x, w, b),
        lambda: conv_block.bn_act_pool_fwd(y, v, v, v, v),
        lambda: conv_block.bn_act_pool_bwd(
            _meta(1, 2, 3, 3, 4), _meta(1, 2, 3, 3, 4, dtype=torch.uint8),
            y, v, v, v, v),
        lambda: conv_block.conv3x3_dgrad(y, w),
        lambda: conv_block.conv3x3_wgrad(x, y),
        # the norm-first block's kernels
        lambda: conv_block.bn_input_stats(x),
        lambda: conv_block.batch_norm_fwd(y, v, v, v, v),
        lambda: conv_block.batch_norm_bwd(y, y, v, v, v, v),
        lambda: conv_block.batch_norm_bwd_bwd(y, v, v, y, y, v, v, v, v),
        lambda: conv_block.act_pool_fwd(y),
        lambda: conv_block.act_pool_bwd(
            _meta(1, 2, 3, 3, 4), _meta(1, 2, 3, 3, 4, dtype=torch.uint8),
            y),
        lambda: conv_block.act_pool_gather(
            y, _meta(1, 2, 3, 3, 4, dtype=torch.uint8), y),
        lambda: conv_block.act_fwd(y),
        lambda: conv_block.act_bwd(y, y),
        # the layer norm's kernels
        lambda: conv_block.layer_norm_stats(y),
        lambda: conv_block.layer_norm_fwd(y, s, s, p, p),
        lambda: conv_block.layer_norm_bwd(y, y, s, s, p),
        lambda: conv_block.layer_norm_bwd_bwd(y, p, p, y, y, s, s, p),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert conv_block.launches() == {k: 0 for k in conv_block.KERNELS}
    # bf16 has kernels for every block, batch norm and layer norm, conv
    # first and norm first, pooled and strided: past the dtype guard, the
    # device check refuses the meta tensor
    v3 = _meta(3)  # the norm-first block's gamma and beta: the input's
    p3 = _meta(6, 6, 3)  # the norm-first layer norm's: the input's (H, W, C)
    for block, norm, kw in (
            (conv_block.conv_bn_act_pool, v, {}),
            (conv_block.conv_bn_act_pool, v,
             dict(stride=2, pool=False, gap=True)),
            (conv_block.norm_conv_act_pool, v3, {}),
            (conv_block.norm_conv_act_pool, v3,
             dict(stride=2, pool=False, gap=True)),
            (conv_block.conv_ln_act_pool, p[0], {}),
            (conv_block.ln_conv_act_pool, p3, {})):
        with pytest.raises(ValueError, match="CUDA"):
            block(_meta(1, 2, 6, 6, 3, dtype=torch.bfloat16), w, b, norm,
                  norm, **kw)
    assert conv_block.launches() == {k: 0 for k in conv_block.KERNELS}


def test_second_order_through_the_block_is_differentiable():
    """The block's second derivative is the training path: a gradient of
    the block's weight gradient, through the hand-written Functions."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(1, 2, 6, 6, 3).astype(np.float32))
    w = torch.from_numpy(rng.randn(1, 3, 3, 3, 4).astype(np.float32))
    w.requires_grad_(True)
    b = torch.zeros(1, 4)
    g, be = torch.ones(1, 4), torch.zeros(1, 4)
    pooled, _, _ = conv_block.function_block(x, w, b, g, be)
    (gw,) = torch.autograd.grad((pooled ** 2).sum(), [w], create_graph=True)
    (ggw,) = torch.autograd.grad(gw.sum(), [w])
    assert torch.isfinite(ggw).all() and float(ggw.abs().max()) > 0


def test_third_derivative_of_the_block_raises():
    """Differentiating the block past what its Functions define raises
    instead of returning a wrong value. Second order is defined (the test
    above); what raises is a derivative of the K5 node, the second-order
    node of the block's batch norm, i.e. the block's third derivative,
    which no path takes (on the card it would otherwise treat K5's outputs
    as constants)."""
    rng = np.random.RandomState(0)
    g, be = torch.ones(1, 4), torch.zeros(1, 4)
    y = torch.from_numpy(rng.randn(1, 2, 6, 6, 4).astype(np.float32))
    y.requires_grad_(True)
    mean, _, rstd = conv_block.F.bn_stats(y.detach())
    dp, arg = conv_block.F.bn_act_pool_fwd(y.detach(), mean, rstd, g, be)
    outs = conv_block.BnActPoolBwdBwd.apply(
        torch.ones_like(y), g, be, dp, arg, y, mean, rstd, g, be)
    with pytest.raises(NotImplementedError, match="third derivative"):
        outs[1].sum().backward()


def test_config_loads_every_experiment_json_like_the_jax_package():
    paths = sorted(glob.glob(os.path.join(ROOT, "experiment_config",
                                          "*.json")))
    assert paths
    jax_fields = {f.name for f in dataclasses.fields(JaxConfig)}
    assert {f.name for f in dataclasses.fields(MAMLConfig)} == jax_fields
    for path in paths:
        got = dataclasses.asdict(MAMLConfig.from_json_file(path))
        want = dataclasses.asdict(JaxConfig.from_json_file(path))
        assert got == want, path


def test_config_validates_like_the_jax_package():
    for bad in (dict(compute_dtype="fp16"), dict(serving_bucket_ladder=[2, 1]),
                dict(bn_stats_impl="onepass"), dict(max_pooling=True,
                                                    image_height=2)):
        with pytest.raises(ValueError):
            JaxConfig(**bad)
        with pytest.raises(ValueError):
            MAMLConfig(**bad)
    cfg = MAMLConfig()
    assert cfg.resolved_bn_stats_impl("cpu") == "fused"
    assert cfg.resolved_bn_stats_impl(torch.device("cuda", 0)) == "twopass"
    assert MAMLConfig(bn_stats_impl="twopass").resolved_bn_stats_impl(
        "cpu") == "twopass"
