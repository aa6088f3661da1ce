"""The port's hand-written kernels held to their plain twins on an NVIDIA
card, at small and ragged shapes (odd image sizes, channel counts that do
not fill a tile), and the block's first and second derivatives on them
against autograd of the plain block — for the max-pooling model, the
strided one (stride-2 convs, the pool-free K2/K3/K5, the global average
pool) and the norm-first block (``bn_input_stats``, K2/K3/K5 at slope 1,
the leaky-ReLU + pool kernels, K1 stats-free and dgrad at cin 1 and 3),
and the layer-norm blocks (``layer_norm_stats/fwd/bwd/bwd_bwd``, both
orders, pooled and strided); the conv kernels at pad 0 (the unpadded
models, ``conv_padding=False``) and the unpadded blocks' derivatives; the
bf16 kernels (``compute_dtype='bfloat16'``: K1 with statistics and stats-
free, K2/K3/K5 pooled, K4, the convs at pad 1 and 0) against their bf16
twins, the bf16 block's first and second derivatives, and the TypeError of
every dtype but f32 and bf16; the layer norm's four kernels in bf16 and
the layer-norm blocks' second derivative on them; K3 and K5 in f32,
pooled, on their cooperative kernels (``csrc/bn_act_pool_bwd.cu``) at
every main-path shape and at edge shapes, a second launch bit for bit the
first, the refusal of a shape the plan cannot fit; K3 and K5 pooled in
bf16 on the same cooperative kernel at every bf16 main-path shape and at
edge shapes, off alignment, a second launch bit for bit the first, their
entries' refusals; K2 (``csrc/bn_act_fwd.cu``) pooled and pool-free, f32
and bf16, at every main-path shape and at edge shapes, off vector
alignment, a second launch bit for bit the first, its entries' refusals;
K4 wgrad in bf16 at stride 1 on its tensor-core kernel
(``csrc/conv3x3_wgrad_s1_bf16.cu``) at every main-path shape and at edge
shapes, off alignment, a second launch bit for bit the first, and its
entry's refusals; K4 wgrad at stride 2, f32 and bf16, pad 1 and 0
(``csrc/conv3x3_wgrad_s2.cu``) at every stride-2 main-path shape and at
edge shapes, off alignment, a second launch bit for bit the first, and its
entries' refusals; K1 (both modes) and K4 dgrad at stride 2 on the band
kernels of ``csrc/conv3x3_s2.cu``, f32 and bf16, at every stride-2 main-
path shape and at edge shapes, off alignment, dx's rows and columns that
no output reads an exact zero, a second launch bit for bit the first, and
their entries' refusals; ``layer_norm_stats``, ``layer_norm_bwd`` and
``layer_norm_bwd_bwd`` on ``csrc/layer_norm.cu`` in f32 and bf16 at every
layer-norm main-path shape and at edge shapes, off alignment, a second
launch bit for bit the first, their entries' refusals; ``bn_input_stats``
(``csrc/bn_input_stats.cu``) and the global average pool's forward and
backward (``csrc/global_avg_pool.cu``) in f32 and bf16 at every model
shape (C = 1, 3, 48, 64) and at edge shapes (tenants that are not a whole
number of loads, channel counts of the scalar mode), off alignment, a
second launch bit for bit the first, the bf16 GAP equal to its twin bit
for bit, their entries' refusals; ``act_fwd`` (``csrc/act.cu``) and
``layer_norm_fwd`` (``csrc/layer_norm.cu``) in f32 and bf16 at every model
shape and at edge shapes, off alignment, bit for bit their twins, a second
launch bit for bit the first, their entries' refusals; the pool-free K5
(``csrc/bn_act_bwd.cu``: ``bn_act_bwd_bwd``, and at slope 1
``batch_norm_bwd_bwd``) and ``act_pool_gather`` (``csrc/act.cu``) in f32
and bf16 at every model shape and at edge shapes, off alignment, within
their gates (the gather bit for bit), a second launch bit for bit the
first, their entries' refusals; the Triton modules gone (no kernel of the
port is Triton); and the ingest kernel ``episode_expand`` equal to its
twin bit for bit (it is a pure lookup). These need the card: marked
``cuda``, they skip where ``torch.cuda.is_available()`` is false. On the
card (``--noconftest``: the suite's conftest imports jax, which the port
never needs):

    python -m pytest tests/test_torch_kernels_cuda.py -q --noconftest

Tolerance: ``max |kernel - twin| <= 1e-5 + 1e-4 * max |twin|`` (f32, sums
in another order); the bf16 gates are stated above their tests.
"""

import importlib

import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu_torch.kernels import conv_block as cb
from howtotrainyourmamlpytorch_tpu_torch.kernels import episode_expand as ee
from howtotrainyourmamlpytorch_tpu_torch.ops import device_pipeline as dpl
from howtotrainyourmamlpytorch_tpu_torch.ops import functional as F

pytestmark = pytest.mark.cuda

SHAPES = [
    # T, N, H, W, cin, cout
    (1, 1, 5, 5, 1, 4),
    (2, 3, 11, 9, 3, 20),
    (3, 2, 21, 21, 48, 48),
    (2, 5, 10, 10, 17, 33),
]


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    from howtotrainyourmamlpytorch_tpu_torch.device import resolve_device

    return resolve_device("cuda:0")


def _close(got, want):
    err = (got.double() - want.double()).abs().max().item()
    scale = want.double().abs().max().item()
    assert err <= 1e-5 + 1e-4 * scale, (err, scale)


#: the Triton modules the port once held: every kernel is CUDA C++ now
TRITON_MODULES = ("bn_act_pool", "act_pool", "layer_norm", "bn_stats",
                  "global_avg_pool")


def _triton_modules_gone():
    for gone in TRITON_MODULES:
        with pytest.raises(ImportError):
            importlib.import_module(
                f"howtotrainyourmamlpytorch_tpu_torch.kernels.{gone}")


def _inputs(shape, device, seed=0):
    T, N, H, W, cin, cout = shape
    g = torch.Generator().manual_seed(seed)

    def r(*s, scale=1.0):
        return (torch.randn(*s, generator=g) * scale).to(device)

    return (r(T, N, H, W, cin), r(T, 3, 3, cin, cout, scale=0.3),
            r(T, cout, scale=0.1), 1 + r(T, cout, scale=0.1),
            r(T, cout, scale=0.1))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_kernels_match_their_twins(shape, device):
    x, w, b, gamma, beta = _inputs(shape, device)
    cb.reset_launches()
    got = cb.conv3x3_fwd_stats(x, w, b)
    want = F.conv3x3_fwd_stats(x, w, b)
    for a, c in zip(got, want):
        _close(a, c)
    y, mean, _, rstd = want
    pooled, arg = cb.bn_act_pool_fwd(y, mean, rstd, gamma, beta)
    pooled_p, arg_p = F.bn_act_pool_fwd(y, mean, rstd, gamma, beta)
    _close(pooled, pooled_p)
    assert torch.equal(arg, arg_p)
    dp = torch.randn(pooled.shape, device=device)
    got = cb.bn_act_pool_bwd(dp, arg, y, mean, rstd, gamma, beta)
    want = F.bn_act_pool_bwd(dp, arg, y, mean, rstd, gamma, beta)
    for a, c in zip(got, want):
        _close(a, c)
    dy = want[0]
    _close(cb.conv3x3_dgrad(dy, w), F.conv3x3_dgrad(dy, w))
    # wgrad on a random dy: K3's sums to zero over each channel (batch
    # norm's backward), so its db would be rounding noise at the size of
    # the absolute tolerance, which no gate relative to the output judges
    dy = torch.randn(dy.shape, device=device)
    for a, c in zip(cb.conv3x3_wgrad(x, dy), F.conv3x3_wgrad(x, dy)):
        _close(a, c)
    # the kernels second order adds: K1 stats-free (with and without a
    # bias) and K5
    _close(cb.conv3x3_fwd(x, w, b), F.conv3x3(x, w, b))
    _close(cb.conv3x3_fwd(x, w), F.conv3x3(x, w))
    args = (torch.randn(y.shape, device=device), torch.randn_like(gamma),
            torch.randn_like(beta), dp, arg, y, mean, rstd, gamma, beta)
    for a, c in zip(cb.bn_act_pool_bwd_bwd(*args),
                    F.bn_act_pool_bwd_bwd(*args)):
        _close(a, c)
    # with g_gamma = g_beta = 0, g_dpooled is K5's projection term alone
    zero = torch.zeros_like(gamma)
    args = (args[0], zero, zero) + args[3:]
    for a, c in zip(cb.bn_act_pool_bwd_bwd(*args),
                    F.bn_act_pool_bwd_bwd(*args)):
        _close(a, c)
    pooled = ("conv3x3_fwd_stats", "bn_act_pool_fwd", "bn_act_pool_bwd",
              "conv3x3_dgrad", "conv3x3_wgrad")
    assert cb.launches() == {**{k: 0 for k in cb.KERNELS},
                             **{k: 1 for k in pooled}, "conv3x3_fwd": 2,
                             "bn_act_pool_bwd_bwd": 2}


STRIDED_SHAPES = [
    # T, N, H, W, cin, cout: 5 -> 3, 7 -> 4 / 8 -> 4 (odd and even), the
    # image layer (cin 1), Omniglot's last layer (4 -> 2), 1x1 -> 1x1
    (1, 1, 5, 5, 1, 4),
    (2, 3, 7, 8, 3, 20),
    (2, 4, 14, 14, 1, 64),
    (3, 2, 4, 4, 64, 64),
    (2, 5, 1, 1, 17, 33),
]


@pytest.mark.parametrize("shape", STRIDED_SHAPES, ids=str)
def test_strided_kernels_match_their_twins(shape, device):
    """K1 (both modes), dgrad and wgrad at stride 2, the pool-free K2, K3
    and K5 on the conv's output, and the GAP forward and backward: each
    against its twin, one launch per call on its own counter."""
    x, w, b, gamma, beta = _inputs(shape, device)
    H, W = shape[2:4]
    cb.reset_launches()
    got = cb.conv3x3_fwd_stats(x, w, b, stride=2)
    want = F.conv3x3_fwd_stats(x, w, b, stride=2)
    for a, c in zip(got, want):
        _close(a, c)
    _close(cb.conv3x3_fwd(x, w, b, 2), F.conv3x3(x, w, b, stride=2))
    _close(cb.conv3x3_fwd(x, w, None, 2), F.conv3x3(x, w, stride=2))
    y, mean, _, rstd = want
    bn = (y, mean, rstd, gamma, beta)
    _close(cb.bn_act_fwd(*bn), F.bn_act_fwd(*bn))
    da = torch.randn(y.shape, device=device)
    for a, c in zip(cb.bn_act_bwd(da, *bn), F.bn_act_bwd(da, *bn)):
        _close(a, c)
    dy = F.bn_act_bwd(da, *bn)[0]
    _close(cb.conv3x3_dgrad(dy, w, 2, (H, W)),
           F.conv3x3_dgrad(dy, w, 2, (H, W)))
    # wgrad on a random dy, as in test_kernels_match_their_twins (K3's db
    # is rounding noise: 1.05e-5 against the 1e-5 floor once on the card)
    dy = torch.randn(dy.shape, device=device)
    for a, c in zip(cb.conv3x3_wgrad(x, dy, 2), F.conv3x3_wgrad(x, dy, 2)):
        _close(a, c)
    args = (torch.randn(y.shape, device=device), torch.randn_like(gamma),
            torch.randn_like(beta), da, *bn)
    for a, c in zip(cb.bn_act_bwd_bwd(*args), F.bn_act_bwd_bwd(*args)):
        _close(a, c)
    act = F.bn_act_fwd(*bn)
    _close(cb.global_avg_pool2d_fwd(act), F.global_avg_pool2d(act))
    g = torch.randn(act.shape[0], act.shape[1], act.shape[-1],
                    device=device)
    _close(cb.global_avg_pool2d_bwd(g, *act.shape[2:4]),
           F.global_avg_pool2d_bwd(g, *act.shape[2:4]))
    strided = ("conv3x3_s2_fwd_stats", "bn_act_fwd", "bn_act_bwd",
               "conv3x3_s2_dgrad", "conv3x3_s2_wgrad", "bn_act_bwd_bwd",
               "global_avg_pool2d_fwd", "global_avg_pool2d_bwd")
    assert cb.launches() == {**{k: 0 for k in cb.KERNELS},
                             **{k: 1 for k in strided}, "conv3x3_s2_fwd": 2}
    torch.cuda.synchronize()


@pytest.mark.parametrize("gap", [False, True], ids=["no_gap", "gap"])
def test_strided_block_derivatives_match_plain_autograd(gap, device):
    """The strided block (stride 2, no pool, with and without the global
    average pool): first derivatives, then a scalar of them differentiated
    again, on the kernels against autograd of the plain block; the conv
    bias's second derivative held to the largest entry of all (it is
    round-off around 0)."""
    x, w, b, gamma, beta = _inputs((2, 3, 9, 8, 8, 12), device, seed=4)
    kw = dict(stride=2, pool=False, gap=gap)
    firsts, seconds = [], []
    for fn in (cb.conv_bn_act_pool, F.conv_bn_act_pool):
        leaves = [t.clone().requires_grad_(True) for t in (x, w, b, gamma,
                                                          beta)]
        out, _, _ = fn(*leaves, **kw)
        rng = np.random.RandomState(5)
        ct = torch.from_numpy(
            rng.randn(*out.shape).astype(np.float32)).to(device)
        first = torch.autograd.grad((out * ct).sum(), leaves,
                                    create_graph=True)
        firsts.append([f.detach() for f in first])
        scalar = sum((g * torch.from_numpy(
            rng.randn(*g.shape).astype(np.float32)).to(device)).sum()
            for g in first[:4])
        seconds.append(torch.autograd.grad(scalar, leaves[:4]))
    for a, c in zip(*firsts):
        _close(a, c)
    got, want = seconds
    for i in (0, 1, 3):  # x, w, gamma
        _close(got[i], want[i])
    scale = max(c.abs().max().item() for c in want)
    err = (got[2].double() - want[2].double()).abs().max().item()
    assert err <= 1e-5 + 1e-4 * scale, ("b", err, scale)


def test_block_gradients_match_plain_autograd(device):
    x, w, b, gamma, beta = _inputs((2, 3, 11, 11, 8, 12), device, seed=1)
    grads = []
    for fn in (cb.conv_bn_act_pool, F.conv_bn_act_pool):
        leaves = [t.clone().requires_grad_(True) for t in (x, w, b, gamma,
                                                          beta)]
        pooled, _, _ = fn(*leaves)
        ct = torch.from_numpy(
            np.random.RandomState(0).randn(*pooled.shape).astype(np.float32)
        ).to(device)
        grads.append(torch.autograd.grad((pooled * ct).sum(), leaves))
    for a, c in zip(*grads):
        _close(a, c)


def test_block_second_derivative_matches_plain_autograd(device):
    """A scalar function of the block's first gradients (each against a
    random cotangent), differentiated again. x, w and gamma each within
    1e-5 + 1e-4 * its own largest entry. The conv bias alone is held to
    1e-5 + 1e-4 * the largest entry of all four: its second derivative is
    0 through batch norm, so its computed value is pure round-off and no
    bound relative to itself means anything."""
    x, w, b, gamma, beta = _inputs((2, 3, 11, 9, 8, 12), device, seed=2)
    results = []
    for fn in (cb.conv_bn_act_pool, F.conv_bn_act_pool):
        leaves = [t.clone().requires_grad_(True) for t in (x, w, b, gamma,
                                                          beta)]
        pooled, _, _ = fn(*leaves)
        rng = np.random.RandomState(3)
        ct = torch.from_numpy(
            rng.randn(*pooled.shape).astype(np.float32)).to(device)
        first = torch.autograd.grad((pooled * ct).sum(), leaves[:4],
                                    create_graph=True)
        scalar = sum((g * torch.from_numpy(
            rng.randn(*g.shape).astype(np.float32)).to(device)).sum()
            for g in first)
        results.append(torch.autograd.grad(scalar, leaves[:4]))
    got, want = results
    for i in (0, 1, 3):  # x, w, gamma
        _close(got[i], want[i])
    scale = max(c.abs().max().item() for c in want)
    err = (got[2].double() - want[2].double()).abs().max().item()
    assert err <= 1e-5 + 1e-4 * scale, ("b", err, scale)


def test_wrappers_reject_what_the_kernels_do_not_take(device):
    x, w, b, gamma, beta = _inputs((1, 2, 6, 6, 3, 4), device)
    with pytest.raises(TypeError, match="float32"):
        cb.conv3x3_fwd_stats(x.double(), w, b)
    with pytest.raises(ValueError, match="contiguous"):
        cb.conv3x3_fwd_stats(x.transpose(2, 3), w, b)
    with pytest.raises(ValueError, match="shape"):
        cb.conv3x3_fwd_stats(x, w[:, :, :, :2], b)
    # the strided model's kernels: stride 3, views, f64
    cb.reset_launches()
    with pytest.raises(ValueError, match="stride 1 or 2"):
        cb.conv3x3_fwd_stats(x, w, b, stride=3)
    with pytest.raises(ValueError, match="stride 1 or 2"):
        cb.conv3x3_fwd(x, w, b, 3)
    with pytest.raises(ValueError, match="stride 1 or 2"):
        cb.conv3x3_wgrad(x, torch.zeros(1, 2, 2, 2, 4, device=device), 3)
    dy = torch.zeros(1, 2, 3, 3, 4, device=device)
    with pytest.raises(ValueError, match="input size"):
        cb.conv3x3_dgrad(dy, w, 2, (8, 8))
    with pytest.raises(ValueError, match="contiguous"):
        cb.conv3x3_wgrad(x, dy.transpose(2, 3), 2)
    with pytest.raises(TypeError, match="float32"):
        cb.conv3x3_dgrad(dy.double(), w, 2, (6, 6))
    y = torch.zeros(1, 2, 3, 3, 4, device=device)
    stats = (y.new_zeros(1, 4), y.new_ones(1, 4), gamma, beta)
    with pytest.raises(TypeError, match="float32"):
        cb.bn_act_fwd(y.double(), *stats)
    with pytest.raises(ValueError, match="contiguous"):
        cb.bn_act_bwd(y.transpose(2, 3), y, *stats)
    with pytest.raises(ValueError, match="shape"):
        cb.bn_act_bwd_bwd(y, *stats[2:], y[:, :1], y, *stats)
    with pytest.raises(TypeError, match="float32"):
        cb.global_avg_pool2d_fwd(y.double())
    with pytest.raises(ValueError, match="contiguous"):
        cb.global_avg_pool2d_bwd(
            torch.zeros(1, 4, 2, device=device).transpose(1, 2), 3, 3)
    # the layer norm's: f64, a parameter of another shape, a view
    ln_stats, ln_param = (y.new_zeros(1, 2), y.new_ones(1, 2)), y[:1, 0] + 1
    with pytest.raises(TypeError, match="float32"):
        cb.layer_norm_stats(y.double())
    with pytest.raises(ValueError, match="shape"):
        cb.layer_norm_fwd(y, *ln_stats, ln_param[..., :2], ln_param)
    with pytest.raises(ValueError, match="contiguous"):
        cb.layer_norm_bwd(y.transpose(2, 3), y, *ln_stats, ln_param)
    assert set(cb.launches().values()) == {0}


NORM_FIRST_SHAPES = [
    # T, N, H, W, C: the image layers (C = 1, 3), an odd map (21 -> 10),
    # both filter counts, a channel count that fills no tile
    (1, 1, 5, 5, 1),
    (2, 3, 11, 9, 3),
    (3, 2, 21, 21, 48),
    (2, 5, 10, 10, 64),
    (2, 4, 7, 6, 17),
]


@pytest.mark.parametrize("shape", NORM_FIRST_SHAPES, ids=str)
def test_norm_first_kernels_match_their_twins(shape, device):
    """``bn_input_stats`` on pixels in [0, 1] (mean ~0.5: a sum-of-squares
    variance would cancel), ``batch_norm_fwd/bwd/bwd_bwd`` (K2/K3/K5 at
    slope 1) on its statistics, and the leaky-ReLU + pool kernels on an
    input full of exact ties (values on a grid of 0.25): the argmax equal
    to the twin's (the first maximum), one launch per call."""
    T, N, H, W, C = shape
    g = torch.Generator().manual_seed(sum(shape))

    def r(*s, scale=1.0):
        return (torch.randn(*s, generator=g) * scale).to(device)

    x = torch.rand(T, N, H, W, C, generator=g).to(device)
    gamma, beta = 1 + r(T, C, scale=0.1), r(T, C, scale=0.1)
    cb.reset_launches()
    for a, c in zip(cb.bn_input_stats(x), F.bn_input_stats(x)):
        _close(a, c)
    mean, _, rstd = F.bn_input_stats(x)
    bn = (x, mean, rstd, gamma, beta)
    _close(cb.batch_norm_fwd(*bn), F.batch_norm_fwd(*bn))
    dz = r(T, N, H, W, C)
    for a, c in zip(cb.batch_norm_bwd(dz, *bn), F.batch_norm_bwd(dz, *bn)):
        _close(a, c)
    args = (r(T, N, H, W, C), r(T, C), r(T, C), dz, *bn)
    for a, c in zip(cb.batch_norm_bwd_bwd(*args),
                    F.batch_norm_bwd_bwd(*args)):
        _close(a, c)
    y = (torch.randint(-4, 5, (T, N, H, W, C), generator=g) * 0.25).to(device)
    pooled, arg = cb.act_pool_fwd(y)
    pooled_p, arg_p = F.act_pool_fwd(y)
    _close(pooled, pooled_p)
    assert torch.equal(arg, arg_p)
    dp = r(*pooled.shape)
    _close(cb.act_pool_bwd(dp, arg, y), F.act_pool_bwd(dp, arg, y))
    g_dy = r(T, N, H, W, C)
    _close(cb.act_pool_gather(g_dy, arg, y), F.act_pool_gather(g_dy, arg, y))
    _close(cb.act_fwd(y), F.act_fwd(y))
    _close(cb.act_bwd(g_dy, y), F.act_bwd(g_dy, y))
    assert cb.launches() == {**{k: 0 for k in cb.KERNELS},
                             **{k: 1 for k in (
                                 "bn_input_stats", "batch_norm_fwd",
                                 "batch_norm_bwd", "batch_norm_bwd_bwd",
                                 "act_pool_fwd", "act_pool_bwd",
                                 "act_pool_gather", "act_fwd", "act_bwd")}}
    torch.cuda.synchronize()


@pytest.mark.parametrize("shape", [(2, 3, 21, 21, 3, 48),
                                   (2, 2, 28, 28, 1, 64)], ids=str)
def test_norm_first_conv_shapes(shape, device):
    """The shapes the norm-first block first gives the conv kernels: K1
    stats-free with bias on the normalized image (cin 3 or 1), and dgrad
    back to it (3 or 1 of dgrad's 16 channel lanes live)."""
    x, w, b, _, _ = _inputs(shape, device, seed=9)
    _close(cb.conv3x3_fwd(x, w, b), F.conv3x3(x, w, b))
    dy = torch.randn(*x.shape[:4], w.shape[-1], device=device)
    _close(cb.conv3x3_dgrad(dy, w), F.conv3x3_dgrad(dy, w))


@pytest.mark.parametrize("kw", [{}, dict(stride=2, pool=False, gap=True)],
                         ids=["pooled", "strided_gap"])
def test_norm_block_derivatives_match_plain_autograd(kw, device):
    """The norm-first block: first derivatives, then a scalar of them
    differentiated again, on the kernels against autograd of the plain
    block (pooled, and strided with the global average pool)."""
    T, N, H, W, cin, cout = 2, 3, 11, 9, 8, 8
    g = torch.Generator().manual_seed(6)

    def r(*s, scale=1.0):
        return (torch.randn(*s, generator=g) * scale).to(device)

    inputs = (r(T, N, H, W, cin), r(T, 3, 3, cin, cout, scale=0.3),
              r(T, cout, scale=0.1), 1 + r(T, cin, scale=0.1),
              r(T, cin, scale=0.1))
    firsts, seconds = [], []
    for fn in (cb.norm_conv_act_pool, F.norm_conv_act_pool):
        leaves = [t.clone().requires_grad_(True) for t in inputs]
        out, _, _ = fn(*leaves, **kw)
        rng = np.random.RandomState(5)
        ct = torch.from_numpy(
            rng.randn(*out.shape).astype(np.float32)).to(device)
        first = torch.autograd.grad((out * ct).sum(), leaves,
                                    create_graph=True)
        firsts.append([f.detach() for f in first])
        scalar = sum((gr * torch.from_numpy(
            rng.randn(*gr.shape).astype(np.float32)).to(device)).sum()
            for gr in first)
        seconds.append(torch.autograd.grad(scalar, leaves,
                                           allow_unused=True))
    for a, c in zip(*firsts):
        _close(a, c)
    # the conv bias enters only through the piecewise-constant masks, so
    # its second derivative is 0 (None where autograd finds no path)
    for a, c, leaf in zip(*seconds, inputs):
        _close(torch.zeros_like(leaf) if a is None else a,
               torch.zeros_like(leaf) if c is None else c)


LAYER_NORM_SHAPES = [
    # T, N, H, W, C: one value per row tile and less, a row of several
    # column tiles with a ragged end (11*9*20 = 1,980), rows of several
    # statistics splits (42*42*3 = 5,292; 21*21*48 = 21,168), the strided
    # model's smallest map (2*2*64)
    (1, 1, 2, 2, 3),
    (2, 3, 11, 9, 20),
    (3, 5, 42, 42, 3),
    (2, 2, 21, 21, 48),
    (8, 7, 2, 2, 64),
]


@pytest.mark.parametrize("shape", LAYER_NORM_SHAPES, ids=str)
def test_layer_norm_kernels_match_their_twins(shape, device):
    """``layer_norm_stats`` on pixels in [0, 1] with an offset (a
    sum-of-squares variance would cancel), ``layer_norm_fwd/bwd/bwd_bwd``
    on its statistics with per-tenant gamma and beta, each against its
    twin; one launch per call on each counter."""
    T, N, H, W, C = shape
    g = torch.Generator().manual_seed(sum(shape))

    def r(*s, scale=1.0):
        return (torch.randn(*s, generator=g) * scale).to(device)

    x = (3.0 + torch.rand(T, N, H, W, C, generator=g)).to(device)
    gamma, beta = 1 + r(T, H, W, C, scale=0.3), r(T, H, W, C, scale=0.1)
    cb.reset_launches()
    for a, c in zip(cb.layer_norm_stats(x), F.layer_norm_stats(x)):
        _close(a, c)
    mean, _, rstd = F.layer_norm_stats(x)
    _close(cb.layer_norm_fwd(x, mean, rstd, gamma, beta),
           F.layer_norm_fwd(x, mean, rstd, gamma, beta))
    dz = r(T, N, H, W, C)
    ln = (x, mean, rstd, gamma)
    for a, c in zip(cb.layer_norm_bwd(dz, *ln), F.layer_norm_bwd(dz, *ln)):
        _close(a, c)
    args = (r(T, N, H, W, C), r(T, H, W, C), r(T, H, W, C), dz, *ln)
    for a, c in zip(cb.layer_norm_bwd_bwd(*args),
                    F.layer_norm_bwd_bwd(*args)):
        _close(a, c)
    assert cb.launches() == {**{k: 0 for k in cb.KERNELS},
                             **{k: 1 for k in (
                                 "layer_norm_stats", "layer_norm_fwd",
                                 "layer_norm_bwd", "layer_norm_bwd_bwd")}}
    torch.cuda.synchronize()


@pytest.mark.parametrize("kw", [{}, dict(stride=2, pool=False, gap=True)],
                         ids=["pooled", "strided_gap"])
@pytest.mark.parametrize("order", ["conv_first", "norm_first"])
def test_layer_norm_block_derivatives_match_plain_autograd(order, kw,
                                                           device):
    """The layer-norm blocks: first derivatives, then a scalar of them
    differentiated again, on the kernels against autograd of the plain
    block, gamma shared ``(H, W, C)`` and beta per tenant."""
    T, N, H, W, cin, cout = 2, 3, 11, 9, 8, 8
    g = torch.Generator().manual_seed(7)

    def r(*s, scale=1.0):
        return (torch.randn(*s, generator=g) * scale).to(device)

    blocks = ((cb.conv_ln_act_pool, F.conv_ln_act_pool)
              if order == "conv_first"
              else (cb.ln_conv_act_pool, F.ln_conv_act_pool))
    ho, wo = ((H, W) if not kw else F.conv_out_hw(H, W, 2))
    hw = (ho, wo) if order == "conv_first" else (H, W)
    c = cout if order == "conv_first" else cin
    inputs = (r(T, N, H, W, cin), r(T, 3, 3, cin, cout, scale=0.3),
              r(T, cout, scale=0.1), 1 + r(*hw, c, scale=0.1),
              r(T, *hw, c, scale=0.1))
    firsts, seconds = [], []
    for fn in blocks:
        leaves = [t.clone().requires_grad_(True) for t in inputs]
        out, _, _ = fn(*leaves, **kw)
        rng = np.random.RandomState(5)
        ct = torch.from_numpy(
            rng.randn(*out.shape).astype(np.float32)).to(device)
        first = torch.autograd.grad((out * ct).sum(), leaves,
                                    create_graph=True)
        firsts.append([f.detach() for f in first])
        scalar = sum((gr * torch.from_numpy(
            rng.randn(*gr.shape).astype(np.float32)).to(device)).sum()
            for gr in first)
        seconds.append(torch.autograd.grad(scalar, leaves,
                                           allow_unused=True))
    for a, c_ in zip(*firsts):
        _close(a, c_)
    for a, c_, leaf in zip(*seconds, inputs):
        _close(torch.zeros_like(leaf) if a is None else a,
               torch.zeros_like(leaf) if c_ is None else c_)


UNPADDED_SHAPES = [
    # (T, N, H, W, cin, cout, stride): the valid 3x3 conv (pad 0) at the
    # mini-ImageNet unpadded models' stage inputs, pooled (84 -> 82, 41 ->
    # 39, 19 -> 17, 8 -> 6) and strided (84 -> 41, 41 -> 20, 20 -> 9, 9
    # -> 4; the last row of an even input is read by no output), then
    # ragged ones: odd by even, a 3x3 input (one output pixel), channel
    # counts that fill no tile
    (2, 3, 84, 84, 3, 48, 1), (2, 3, 41, 41, 48, 48, 1),
    (2, 3, 19, 19, 48, 48, 1), (2, 3, 8, 8, 48, 48, 1),
    (2, 3, 84, 84, 3, 48, 2), (2, 3, 41, 41, 48, 48, 2),
    (2, 3, 20, 20, 48, 48, 2), (2, 3, 9, 9, 48, 48, 2),
    (2, 4, 7, 8, 3, 20, 1), (2, 4, 7, 8, 3, 20, 2),
    (1, 2, 3, 3, 17, 33, 1), (1, 2, 3, 3, 17, 33, 2),
]


@pytest.mark.parametrize("shape", UNPADDED_SHAPES, ids=str)
def test_unpadded_conv_kernels_match_their_twins(shape, device):
    """K1 with statistics and stats-free (with and without bias), dgrad
    (back to cin 3 at the image layer, as the norm-first model's stage 0
    takes it) and wgrad at pad 0, each against its twin, one launch per
    call on the pad-0 counters; dgrad needs ``in_hw`` at pad 0."""
    *dims, stride = shape
    x, w, b, _, _ = _inputs(tuple(dims), device, seed=sum(shape))
    H, W = dims[2:4]
    kw = dict(stride=stride, padding=0)
    cb.reset_launches()
    got = cb.conv3x3_fwd_stats(x, w, b, **kw)
    want = F.conv3x3_fwd_stats(x, w, b, **kw)
    assert want[0].shape[2:4] == F.conv_out_hw(H, W, stride, 0)
    for a, c in zip(got, want):
        _close(a, c)
    _close(cb.conv3x3_fwd(x, w, b, **kw), F.conv3x3(x, w, b, **kw))
    _close(cb.conv3x3_fwd(x, w, None, **kw), F.conv3x3(x, w, **kw))
    dy = torch.randn(want[0].shape, device=device)
    dx = cb.conv3x3_dgrad(dy, w, stride, (H, W), 0)
    _close(dx, F.conv3x3_dgrad(dy, w, stride, (H, W), 0))
    if stride == 2 and H % 2 == 0:  # the unread last row and column
        assert not dx[:, :, -1].any() and not dx[:, :, :, -1].any()
    for a, c in zip(cb.conv3x3_wgrad(x, dy, **kw),
                    F.conv3x3_wgrad(x, dy, **kw)):
        _close(a, c)
    with pytest.raises(ValueError, match="in_hw is required"):
        cb.conv3x3_dgrad(dy, w, stride, None, 0)
    tag = "s2_p0" if stride == 2 else "p0"
    assert cb.launches() == {
        **{k: 0 for k in cb.KERNELS},
        **{f"conv3x3_{tag}_{k}": 1 for k in ("fwd_stats", "dgrad", "wgrad")},
        f"conv3x3_{tag}_fwd": 2}
    torch.cuda.synchronize()


def test_unpadded_wrappers_reject_a_vanishing_output(device):
    """A 2x2 input has no valid 3x3 conv output: the wrappers raise before
    any launch; so does a pad the kernels do not take."""
    x, w, b, _, _ = _inputs((1, 2, 2, 2, 4, 4), device)
    cb.reset_launches()
    for stride in (1, 2):
        with pytest.raises(ValueError, match="no pad-0"):
            cb.conv3x3_fwd_stats(x, w, b, stride=stride, padding=0)
        with pytest.raises(ValueError, match="no pad-0"):
            cb.conv3x3_fwd(x, w, b, stride, 0)
    with pytest.raises(ValueError, match="pad 1 or 0"):
        cb.conv3x3_fwd(x, w, b, 1, 2)
    assert set(cb.launches().values()) == {0}


@pytest.mark.parametrize("block", [
    "conv_bn", "conv_bn_strided_gap", "norm_first", "conv_ln", "ln_conv"])
def test_unpadded_block_derivatives_match_plain_autograd(block, device):
    """The unpadded blocks (pad 0): first derivatives, then a scalar of
    them differentiated again, on the kernels against autograd of the
    plain block; a second derivative that is 0 (the conv bias through
    batch norm, or where autograd finds no path) is held to the largest
    entry of all."""
    T, N, H, W, cin, cout = 2, 3, 12, 11, 8, 8
    kw = dict(padding=0)
    if block == "conv_bn_strided_gap":
        kw.update(stride=2, pool=False, gap=True)
    pair = {"conv_bn": (cb.conv_bn_act_pool, F.conv_bn_act_pool),
            "conv_bn_strided_gap": (cb.conv_bn_act_pool, F.conv_bn_act_pool),
            "norm_first": (cb.norm_conv_act_pool, F.norm_conv_act_pool),
            "conv_ln": (cb.conv_ln_act_pool, F.conv_ln_act_pool),
            "ln_conv": (cb.ln_conv_act_pool, F.ln_conv_act_pool)}[block]
    g = torch.Generator().manual_seed(8)

    def r(*s, scale=1.0):
        return (torch.randn(*s, generator=g) * scale).to(device)

    conv_hw = F.conv_out_hw(H, W, kw.get("stride", 1), 0)
    norm = {"conv_bn": (cout,), "conv_bn_strided_gap": (cout,),
            "norm_first": (cin,), "conv_ln": (*conv_hw, cout),
            "ln_conv": (H, W, cin)}[block]
    inputs = (r(T, N, H, W, cin), r(T, 3, 3, cin, cout, scale=0.3),
              r(T, cout, scale=0.1), 1 + r(*norm, scale=0.1),
              r(T, *norm, scale=0.1))
    firsts, seconds = [], []
    for fn in pair:
        leaves = [t.clone().requires_grad_(True) for t in inputs]
        out, _, _ = fn(*leaves, **kw)
        rng = np.random.RandomState(5)
        ct = torch.from_numpy(
            rng.randn(*out.shape).astype(np.float32)).to(device)
        first = torch.autograd.grad((out * ct).sum(), leaves,
                                    create_graph=True)
        firsts.append([f.detach() for f in first])
        scalar = sum((gr * torch.from_numpy(
            rng.randn(*gr.shape).astype(np.float32)).to(device)).sum()
            for gr in first)
        seconds.append(torch.autograd.grad(scalar, leaves,
                                           allow_unused=True))
    for a, c in zip(*firsts):
        _close(a, c)
    scale = max(c.abs().max().item() for c in seconds[1] if c is not None)
    for a, c, leaf in zip(*seconds, inputs):
        a = torch.zeros_like(leaf) if a is None else a
        c = torch.zeros_like(leaf) if c is None else c
        err = (a.double() - c.double()).abs().max().item()
        own = c.double().abs().max().item()
        assert err <= 1e-5 + 1e-4 * (own if own > 1e-3 * scale else scale)


# (rows in the store, H = W, C, tasks, classes, columns, support columns)
EXPAND_SHAPES = [
    (9, 5, 1, 1, 1, 1, 1),
    (40, 7, 3, 2, 3, 5, 2),
    (101, 11, 1, 3, 4, 3, 3),
    (64, 6, 3, 2, 5, 4, 0),
]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape", EXPAND_SHAPES, ids=str)
def test_episode_expand_equals_its_twin(shape, reverse, device):
    """Every k in 0..3 (and two past the ends, clamped), C in {1, 3}, odd
    sizes (H*W*C not a multiple of 4: the scalar stores), all-support and
    all-target splits, and rows outside the store (wrap once, clamp):
    kernel and twin equal bit for bit, one launch per call."""
    n, hw, c, tasks, classes, cols, spc = shape
    g = torch.Generator().manual_seed(n)
    store = torch.randint(0, 256, (n, hw, hw, c), dtype=torch.uint8,
                          generator=g).to(device)
    rows = torch.randint(-2 * n, 2 * n, (tasks, classes, cols),
                         dtype=torch.int32, generator=g).to(device)
    rot = (torch.arange(tasks * classes, dtype=torch.int32) % 6 - 1
           ).reshape(tasks, classes).to(device)
    lut = torch.randn(256, c, generator=g).to(device)
    ee.reset_launches()
    for k in (None, rot):
        got = ee.gather_decode(store, rows, k, lut, spc, reverse)
        want = dpl.expand_plain(store, rows, k, lut, spc, reverse)
        for a, b in zip(got, want):
            assert a.shape == b.shape and torch.equal(a, b)
    pixels = store[:3]
    assert torch.equal(ee.decode(pixels, lut, reverse),
                       dpl.decode_plain(pixels, lut, reverse))
    assert ee.launches() == {"episode_expand": 3}
    torch.cuda.synchronize()


def test_episode_expand_rejects_what_it_does_not_take(device):
    store = torch.zeros(4, 6, 5, 1, dtype=torch.uint8, device=device)
    rows = torch.zeros(2, 3, dtype=torch.int32, device=device)
    rot = torch.zeros(2, dtype=torch.int32, device=device)
    lut = torch.zeros(256, 1, device=device)
    with pytest.raises(ValueError, match="square"):
        ee.gather_decode(store, rows, rot, lut, 1)
    with pytest.raises(ValueError, match="int32"):
        ee.gather_decode(store, rows.long(), None, lut, 1)
    with pytest.raises(ValueError, match="lut"):
        ee.gather_decode(store, rows, None, lut[:, :0], 1)
    with pytest.raises(ValueError, match="uint8"):
        ee.decode(store.float(), lut)


# -- bf16 (compute_dtype='bfloat16'): K1, K2/K3/K5 pooled, K4, pad 1 and 0 ---
#
# Gates (the kernels load bf16, compute in f32 and round where the JAX
# package's bf16 graph rounds, as their twins do):
# * K2 equals its twin bit for bit (pooled values and argmax): the same
#   bf16 chain of single-rounded ops on the same inputs;
# * K1 (y, mean, var, rstd), K3 (dy, dgamma, dbeta), dgrad and wgrad
#   within one bf16 ulp of the twin elementwise, or 1e-4 of the output's
#   scale where that is larger: both round one f32 value, computed in
#   another order, so a value near a rounding boundary may round the other
#   way. y rounds twice (the conv's sum, then the bias add), so its bound
#   is one ulp of each; so does K1 stats-free's with a bias;
# * K5 (g_dpooled, g_y, g_gamma) within one bf16 ulp, or 1e-4 of scale:
#   f32 formulas on the bf16 inputs with K2's bf16-chain masks, each
#   output rounded once, as its twin.

BF16_SHAPES = [
    # T, N, H, W, cin, cout: the image layer, an odd map (21 -> 10), a
    # 48-channel map, channel counts that fill no tile
    (1, 1, 5, 5, 1, 4),
    (2, 3, 11, 9, 3, 20),
    (3, 2, 21, 21, 48, 48),
    (2, 5, 10, 10, 17, 33),
]


def bf16_ulp(v):
    """The spacing of bf16 at each |v| (8 significant bits)."""
    _, e = torch.frexp(v.double().abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(v, dtype=torch.float64), e - 8)


def within_ulp(got, want, what, ulps=None):
    """|got - want| <= max(ulps (default: one ulp of want), 1e-4 * max
    |want|) elementwise."""
    assert got.dtype == want.dtype == torch.bfloat16, (what, got.dtype)
    diff = (got.double() - want.double()).abs()
    tol = bf16_ulp(want) if ulps is None else ulps
    tol = torch.maximum(tol, torch.full_like(
        tol, 1e-4 * want.double().abs().max().item()))
    bad = int((diff > tol).sum())
    assert bad == 0, (what, bad, diff.max().item())


def bf16_inputs(shape, device, seed=0):
    return tuple(t.bfloat16() for t in _inputs(shape, device, seed))


@pytest.mark.parametrize("shape", BF16_SHAPES, ids=str)
def test_bf16_kernels_match_their_twins(shape, device):
    x, w, b, gamma, beta = bf16_inputs(shape, device)
    cb.reset_launches()
    got = cb.conv3x3_fwd_stats(x, w, b)
    want = F.conv3x3_fwd_stats(x, w, b)
    y_ulps = bf16_ulp(want[0]) + bf16_ulp(F.conv3x3(x, w))
    within_ulp(got[0], want[0], "K1 y", y_ulps)
    for a, c, what in zip(got[1:], want[1:], ("mean", "var", "rstd")):
        within_ulp(a, c, f"K1 {what}")
    y, mean, _, rstd = want
    pooled, arg = cb.bn_act_pool_fwd(y, mean, rstd, gamma, beta)
    pooled_p, arg_p = F.bn_act_pool_fwd(y, mean, rstd, gamma, beta)
    assert pooled.dtype == torch.bfloat16
    assert torch.equal(pooled, pooled_p) and torch.equal(arg, arg_p)
    dp = torch.randn(pooled.shape, device=device).bfloat16()
    args = (dp, arg, y, mean, rstd, gamma, beta)
    # K3: dy, dgamma and dbeta summed in f32 and rounded once, as its twin
    for a, c, what in zip(cb.bn_act_pool_bwd(*args), F.bn_act_pool_bwd(*args),
                          ("dy", "dgamma", "dbeta")):
        within_ulp(a, c, f"K3 {what}")
    # K4 on a random dy: K3's sums to zero over each channel (batch norm's
    # backward), so its db would be rounding noise
    dy = torch.randn(y.shape, device=device).bfloat16()
    within_ulp(cb.conv3x3_dgrad(dy, w), F.conv3x3_dgrad(dy, w), "dgrad")
    for a, c, what in zip(cb.conv3x3_wgrad(x, dy), F.conv3x3_wgrad(x, dy),
                          ("dw", "db")):
        within_ulp(a, c, f"wgrad {what}")
    assert cb.launches() == {**{k: 0 for k in cb.KERNELS},
                             **{f"{k}_bf16": 1 for k in (
                                 "conv3x3_fwd_stats", "bn_act_pool_fwd",
                                 "bn_act_pool_bwd", "conv3x3_dgrad",
                                 "conv3x3_wgrad")}}


@pytest.mark.parametrize("padding", [1, 0])
@pytest.mark.parametrize("shape", BF16_SHAPES, ids=str)
def test_bf16_stats_free_conv_matches_its_twin(shape, padding, device):
    """K1's stats-free mode in bf16 (second order: Dgrad's and Wgrad's
    backward) at pad 1 and 0, with the bias (one ulp of the sum and one
    of the bias add) and without (one ulp)."""
    x, w, b, _, _ = bf16_inputs(shape, device)
    if padding == 0 and min(x.shape[2:4]) < 3:
        pytest.skip("no pad-0 output")
    cb.reset_launches()
    plain = F.conv3x3(x, w, padding=padding)
    within_ulp(cb.conv3x3_fwd(x, w, padding=padding), plain, "K1 stats-free")
    want = F.conv3x3(x, w, b, padding=padding)
    within_ulp(cb.conv3x3_fwd(x, w, b, padding=padding), want,
               "K1 stats-free with bias", bf16_ulp(want) + bf16_ulp(plain))
    name = "conv3x3_fwd_bf16" if padding else "conv3x3_p0_fwd_bf16"
    assert {k: n for k, n in cb.launches().items() if n} == {name: 2}


@pytest.mark.parametrize("shape", BF16_SHAPES, ids=str)
def test_bf16_k5_matches_its_twin(shape, device):
    """K5 in bf16 on random cotangents (K3's own sum to zero per channel)
    at the pooled K2 decisions of a bf16 y, odd maps included."""
    x, w, b, gamma, beta = bf16_inputs(shape, device)
    y, mean, _, rstd = F.conv3x3_fwd_stats(x, w, b)
    _, arg = F.bn_act_pool_fwd(y, mean, rstd, gamma, beta)
    g = torch.Generator(device=device).manual_seed(1)

    def r(*s):
        return torch.randn(*s, device=device, generator=g).bfloat16()

    T, C = gamma.shape
    args = (r(*y.shape), r(T, C), r(T, C), r(*arg.shape), arg, y, mean,
            rstd, gamma, beta)
    cb.reset_launches()
    for a, c, what in zip(cb.bn_act_pool_bwd_bwd(*args),
                          F.bn_act_pool_bwd_bwd(*args),
                          ("g_dpooled", "g_y", "g_gamma")):
        within_ulp(a, c, f"K5 {what}")
    assert {k: n for k, n in cb.launches().items() if n} == {
        "bn_act_pool_bwd_bwd_bf16": 1}


@pytest.mark.parametrize("shape", BF16_SHAPES[1:], ids=str)
def test_bf16_pad0_convs_match_their_twins(shape, device):
    """K1 with statistics, dgrad and wgrad in bf16 at pad 0 (the unpadded
    bf16 model), within the gates above, on the ``conv3x3_p0_*_bf16``
    counters."""
    x, w, b, _, _ = bf16_inputs(shape, device)
    cb.reset_launches()
    got = cb.conv3x3_fwd_stats(x, w, b, padding=0)
    want = F.conv3x3_fwd_stats(x, w, b, padding=0)
    within_ulp(got[0], want[0], "K1 p0 y",
               bf16_ulp(want[0]) + bf16_ulp(F.conv3x3(x, w, padding=0)))
    for a, c, what in zip(got[1:], want[1:], ("mean", "var", "rstd")):
        within_ulp(a, c, f"K1 p0 {what}")
    dy = torch.randn(want[0].shape, device=device).bfloat16()
    hw = tuple(x.shape[2:4])
    within_ulp(cb.conv3x3_dgrad(dy, w, 1, hw, 0),
               F.conv3x3_dgrad(dy, w, 1, hw, 0), "dgrad p0")
    for a, c, what in zip(cb.conv3x3_wgrad(x, dy, padding=0),
                          F.conv3x3_wgrad(x, dy, padding=0), ("dw", "db")):
        within_ulp(a, c, f"wgrad p0 {what}")
    assert {k: n for k, n in cb.launches().items() if n} == {
        "conv3x3_p0_fwd_stats_bf16": 1, "conv3x3_p0_dgrad_bf16": 1,
        "conv3x3_p0_wgrad_bf16": 1}


def test_bf16_stops_where_no_bf16_kernel_is(device):
    """On the card every kernel has a bf16 version, the layer norm's four
    included; a tensor in any other dtype raises ``TypeError`` at the
    layer norm's wrappers, and a layer-norm block in it raises
    ``NotImplementedError`` naming its kernels, before any launch: nothing
    falls back to another dtype."""
    x, w, b, _, _ = bf16_inputs((1, 2, 6, 6, 3, 4), device)
    x, w, b = x.half(), w.half(), b.half()
    y = torch.zeros(1, 2, 6, 6, 4, device=device).half()
    s = torch.ones(1, 2, device=device).half()
    p = torch.ones(1, 6, 6, 4, device=device).half()
    cb.reset_launches()
    for match, call in (
            ("^layer_norm_stats: .*float32 or bfloat16",
             lambda: cb.layer_norm_stats(y)),
            ("^layer_norm_fwd: .*float32 or bfloat16",
             lambda: cb.layer_norm_fwd(y, s, s, p, p)),
            ("^layer_norm_bwd: .*float32 or bfloat16",
             lambda: cb.layer_norm_bwd(y, y, s, s, p)),
            ("^layer_norm_bwd_bwd: .*float32 or bfloat16",
             lambda: cb.layer_norm_bwd_bwd(y, p, p, y, y, s, s, p))):
        with pytest.raises(TypeError, match=match):
            call()
    for call in (lambda: cb.conv_ln_act_pool(x, w, b, p[0], p[0]),
                 lambda: cb.ln_conv_act_pool(x, w, b, p[0, :, :, :3],
                                             p[0, :, :, :3])):
        with pytest.raises(NotImplementedError,
                           match="f32 only.*layer_norm_stats"):
            call()
    assert set(cb.launches().values()) == {0}


def test_bf16_block_runs_on_the_bf16_kernels(device):
    """The conv-first batch-norm block in bf16 at stride 1 and pad 1: its
    forward and first backward launch the bf16 kernels only, every output
    and gradient is finite, the activation stays bf16 and the f32 leaves'
    gradients come back f32."""
    x, w, b, _, _ = bf16_inputs((2, 3, 12, 12, 3, 8), device)
    w32 = w.float().requires_grad_(True)
    b32 = b.float().requires_grad_(True)
    gamma = torch.ones(8, device=device)
    beta = torch.zeros(8, device=device)
    cb.reset_launches()
    out, mean, var = cb.conv_bn_act_pool(x, w32.bfloat16(), b32.bfloat16(),
                                         gamma, beta)
    assert out.dtype == mean.dtype == var.dtype == torch.bfloat16
    gw, gb = torch.autograd.grad(out.float().square().sum(), [w32, b32])
    assert gw.dtype == gb.dtype == torch.float32
    assert torch.isfinite(gw).all() and torch.isfinite(gb).all()
    launched = {k for k, n in cb.launches().items() if n}
    assert launched == {"conv3x3_fwd_stats_bf16", "bn_act_pool_fwd_bf16",
                        "bn_act_pool_bwd_bf16", "conv3x3_wgrad_bf16"}


@pytest.mark.parametrize("padding", [1, 0])
def test_bf16_block_second_order_runs_on_the_bf16_kernels(padding, device):
    """The conv-first batch-norm block's second derivative in bf16 (the
    training path: the gradient of ``<v, d loss / d w>``) at pad 1 and 0
    launches bf16 kernels only, K1 stats-free and K5 among them; the f32
    leaf's gradient comes back f32 and finite, and within 2x the bf16-vs-f32
    spread of the same block on the twins (the CPU, bf16 and f32) from
    the twins' bf16 result (phase 9's serve gate)."""
    x, w, b, _, _ = bf16_inputs((2, 3, 12, 12, 3, 8), device)
    gamma = torch.ones(8)
    beta = torch.zeros(8)
    v = torch.randn(w.shape, generator=torch.Generator().manual_seed(2))
    results = {}
    for name, dev, dtype in (("kernels", device, torch.bfloat16),
                             ("twins bf16", "cpu", torch.bfloat16),
                             ("twins f32", "cpu", torch.float32)):
        w32 = w.float().to(dev).requires_grad_(True)
        b32 = b.float().to(dev).requires_grad_(True)
        cb.reset_launches()
        out, _, _ = cb.function_block(
            x.to(dev, dtype), w32.to(dtype), b32.to(dtype), gamma.to(dev),
            beta.to(dev), padding=padding)
        gw, = torch.autograd.grad(out.float().square().sum(), [w32],
                                  create_graph=True)
        results[name] = torch.autograd.grad((gw * v.to(dev)).sum(),
                                            [w32])[0].cpu()
        if name == "kernels":
            launched = {k for k, n in cb.launches().items() if n}
    got = results["kernels"]
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    tag = "" if padding else "_p0"
    assert {f"conv3x3{tag}_fwd_bf16", "bn_act_pool_bwd_bwd_bf16"} <= launched
    assert all(k.endswith("_bf16") for k in launched), launched
    spread = (results["twins bf16"] - results["twins f32"]).abs().max()
    assert (got - results["twins bf16"]).abs().max() <= 2 * spread


# The strided and the norm-first models' kernels in bf16, against their bf16
# twins:
# * the stride-2 convs (pad 1 and 0; dgrad at cin 1 too), the pool-free K3
#   and K5, ``bn_input_stats`` and ``batch_norm_bwd/bwd_bwd``: within one
#   bf16 ulp elementwise, or 1e-4 of the output's scale (f32 sums rounded
#   once, in another order than the twin's);
# * the pool-free K2, ``batch_norm_fwd``, the GAP forward and backward and
#   the act-pool kernels: bit for bit (the same rounded chain, or one
#   rounding of an exact f32 value; the GAP's f32 sums of a few bf16 values
#   are exact).

BF16_STRIDED_SHAPES = [
    # T, N, H, W, cin, cout: the image layer (cin 1, 28 -> 14), odd maps
    # (7 -> 4 with pad 1, 9 -> 4 with pad 0), Omniglot's last layer (4 -> 2)
    (2, 4, 28, 28, 1, 64),
    (2, 3, 7, 7, 64, 64),
    (3, 2, 4, 4, 64, 64),
    (2, 3, 9, 9, 48, 48),
]


@pytest.mark.parametrize("padding", [1, 0])
@pytest.mark.parametrize("shape", BF16_STRIDED_SHAPES, ids=str)
def test_bf16_strided_kernels_match_their_twins(shape, padding, device):
    """The strided model's kernels in bf16: K1 at stride 2 (both modes),
    dgrad (at cin 1 too) and wgrad at stride 2, the pool-free K2 (bit for
    bit), K3 on a random da and K5 on random cotangents, and the GAP's
    forward and backward (bit for bit), each on its ``*_bf16`` counter."""
    x, w, b, gamma, beta = bf16_inputs(shape, device)
    if padding == 0 and min(x.shape[2:4]) < 3:
        pytest.skip("no pad-0 output")
    H, W = shape[2:4]
    cb.reset_launches()
    got = cb.conv3x3_fwd_stats(x, w, b, stride=2, padding=padding)
    want = F.conv3x3_fwd_stats(x, w, b, stride=2, padding=padding)
    plain = F.conv3x3(x, w, stride=2, padding=padding)
    within_ulp(got[0], want[0], "K1 s2 y", bf16_ulp(want[0])
               + bf16_ulp(plain))
    for a, c, what in zip(got[1:], want[1:], ("mean", "var", "rstd")):
        within_ulp(a, c, f"K1 s2 {what}")
    within_ulp(cb.conv3x3_fwd(x, w, None, 2, padding), plain, "K1 s2 free")
    y, mean, _, rstd = want
    bn = (y, mean, rstd, gamma, beta)
    act = cb.bn_act_fwd(*bn)
    assert torch.equal(act, F.bn_act_fwd(*bn))
    gen = torch.Generator(device=device).manual_seed(3)

    def r(*s):
        return torch.randn(*s, device=device, generator=gen).bfloat16()

    T, C = gamma.shape
    da = r(*y.shape)
    for a, c, what in zip(cb.bn_act_bwd(da, *bn), F.bn_act_bwd(da, *bn),
                          ("dy", "dgamma", "dbeta")):
        within_ulp(a, c, f"K3 pool-free {what}")
    args = (r(*y.shape), r(T, C), r(T, C), da, *bn)
    for a, c, what in zip(cb.bn_act_bwd_bwd(*args), F.bn_act_bwd_bwd(*args),
                          ("g_da", "g_y", "g_gamma")):
        within_ulp(a, c, f"K5 pool-free {what}")
    dy = r(*y.shape)
    within_ulp(cb.conv3x3_dgrad(dy, w, 2, (H, W), padding),
               F.conv3x3_dgrad(dy, w, 2, (H, W), padding), "dgrad s2")
    for a, c, what in zip(cb.conv3x3_wgrad(x, dy, 2, padding),
                          F.conv3x3_wgrad(x, dy, 2, padding), ("dw", "db")):
        within_ulp(a, c, f"wgrad s2 {what}")
    assert torch.equal(cb.global_avg_pool2d_fwd(act),
                       F.global_avg_pool2d(act))
    g = r(T, act.shape[1], C)
    assert torch.equal(cb.global_avg_pool2d_bwd(g, *act.shape[2:4]),
                       F.global_avg_pool2d_bwd(g, *act.shape[2:4]))
    tag = "_s2" if padding else "_s2_p0"
    launched = {f"conv3x3{tag}_{k}_bf16": 1 for k in (
        "fwd_stats", "fwd", "dgrad", "wgrad")}
    launched.update({f"{k}_bf16": 1 for k in (
        "bn_act_fwd", "bn_act_bwd", "bn_act_bwd_bwd",
        "global_avg_pool2d_fwd", "global_avg_pool2d_bwd")})
    assert {k: n for k, n in cb.launches().items() if n} == launched
    torch.cuda.synchronize()


@pytest.mark.parametrize("shape", NORM_FIRST_SHAPES, ids=str)
def test_bf16_norm_first_kernels_match_their_twins(shape, device):
    """The norm-first block's kernels in bf16: ``bn_input_stats`` on pixels
    in [0, 1], ``batch_norm_fwd`` (bit for bit), ``batch_norm_bwd`` and
    ``batch_norm_bwd_bwd`` on random cotangents, and the leaky-ReLU + pool
    kernels and their pool-free mode (bit for bit) on an input full of
    exact ties, each on its ``*_bf16`` counter."""
    T, N, H, W, C = shape
    g = torch.Generator().manual_seed(sum(shape))

    def r(*s, scale=1.0):
        return (torch.randn(*s, generator=g) * scale).to(device).bfloat16()

    x = torch.rand(T, N, H, W, C, generator=g).to(device).bfloat16()
    gamma, beta = (1 + r(T, C, scale=0.1)).bfloat16(), r(T, C, scale=0.1)
    cb.reset_launches()
    for a, c, what in zip(cb.bn_input_stats(x), F.bn_input_stats(x),
                          ("mean", "var", "rstd")):
        within_ulp(a, c, f"bn_input_stats {what}")
    mean, _, rstd = F.bn_input_stats(x)
    bn = (x, mean, rstd, gamma, beta)
    assert torch.equal(cb.batch_norm_fwd(*bn), F.batch_norm_fwd(*bn))
    dz = r(T, N, H, W, C)
    for a, c, what in zip(cb.batch_norm_bwd(dz, *bn),
                          F.batch_norm_bwd(dz, *bn), ("dx", "dgamma",
                                                      "dbeta")):
        within_ulp(a, c, f"batch_norm_bwd {what}")
    args = (r(T, N, H, W, C), r(T, C), r(T, C), dz, *bn)
    for a, c, what in zip(cb.batch_norm_bwd_bwd(*args),
                          F.batch_norm_bwd_bwd(*args),
                          ("g_dz", "g_x", "g_gamma")):
        within_ulp(a, c, f"batch_norm_bwd_bwd {what}")
    y = (torch.randint(-4, 5, (T, N, H, W, C), generator=g)
         * 0.25).to(device).bfloat16()
    pooled, arg = cb.act_pool_fwd(y)
    pooled_p, arg_p = F.act_pool_fwd(y)
    assert torch.equal(pooled, pooled_p) and torch.equal(arg, arg_p)
    dp = r(*pooled.shape)
    assert torch.equal(cb.act_pool_bwd(dp, arg, y),
                       F.act_pool_bwd(dp, arg, y))
    g_dy = r(T, N, H, W, C)
    assert torch.equal(cb.act_pool_gather(g_dy, arg, y),
                       F.act_pool_gather(g_dy, arg, y))
    assert torch.equal(cb.act_fwd(y), F.act_fwd(y))
    assert torch.equal(cb.act_bwd(g_dy, y), F.act_bwd(g_dy, y))
    assert {k: n for k, n in cb.launches().items() if n} == {
        f"{k}_bf16": 1 for k in (
            "bn_input_stats", "batch_norm_fwd", "batch_norm_bwd",
            "batch_norm_bwd_bwd", "act_pool_fwd", "act_pool_bwd",
            "act_pool_gather", "act_fwd", "act_bwd")}
    torch.cuda.synchronize()


@pytest.mark.parametrize("block,kw", [
    ("conv_bn_act_pool", dict(stride=2, pool=False, gap=True)),
    ("conv_bn_act_pool", dict(stride=2, pool=False, gap=True, padding=0)),
    ("norm_conv_act_pool", {}),
    ("norm_conv_act_pool", dict(stride=2, pool=False, gap=True))],
    ids=["strided", "strided_pad0", "norm_first", "strided_norm_first"])
def test_bf16_model_blocks_second_order_run_on_the_bf16_kernels(block, kw,
                                                               device):
    """The strided and the norm-first blocks' second derivative in bf16
    (the gradient of ``<v, d loss / d w>``) launches bf16 kernels only;
    the f32 leaf's gradient comes back f32 and finite, within 2x the
    bf16-vs-f32 spread of the same block on the twins (the CPU, bf16 and
    f32) from the twins' bf16 result."""
    cin = 8 if block == "norm_conv_act_pool" else 3
    x, w, b, _, _ = bf16_inputs((2, 3, 12, 12, cin, 8), device)
    c = cin if block == "norm_conv_act_pool" else 8
    gamma, beta = torch.ones(c), torch.zeros(c)
    v = torch.randn(w.shape, generator=torch.Generator().manual_seed(2))
    fn = {"conv_bn_act_pool": cb.function_block,
          "norm_conv_act_pool": cb.norm_function_block}[block]
    results = {}
    for name, dev, dtype in (("kernels", device, torch.bfloat16),
                             ("twins bf16", "cpu", torch.bfloat16),
                             ("twins f32", "cpu", torch.float32)):
        w32 = w.float().to(dev).requires_grad_(True)
        cb.reset_launches()
        out, _, _ = fn(x.to(dev, dtype), w32.to(dtype), b.to(dev, dtype),
                       gamma.to(dev), beta.to(dev), **kw)
        gw, = torch.autograd.grad(out.float().square().sum(), [w32],
                                  create_graph=True)
        results[name] = torch.autograd.grad((gw * v.to(dev)).sum(),
                                            [w32])[0].cpu()
        if name == "kernels":
            launched = {k for k, n in cb.launches().items() if n}
    got = results["kernels"]
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert launched and all(k.endswith("_bf16") for k in launched), launched
    spread = (results["twins bf16"] - results["twins f32"]).abs().max()
    assert (got - results["twins bf16"]).abs().max() <= 2 * spread


# -- bf16 layer norm (B5c): layer_norm_stats/fwd/bwd/bwd_bwd ----------------------
#
# Gates: ``layer_norm_fwd`` equals its twin bit for bit (the same chain of
# single-rounded ops on the twin's statistics); the statistics (mean, var,
# rstd: a Chan merge against the twin's two passes), ``layer_norm_bwd``
# (dx, dgamma, dbeta) and ``layer_norm_bwd_bwd`` (g_dz, g_x, g_gamma), f32
# sums rounded once, within one bf16 ulp of the twin or 1e-4 of scale.


@pytest.mark.parametrize("shape", LAYER_NORM_SHAPES, ids=str)
def test_bf16_layer_norm_kernels_match_their_twins(shape, device):
    """The layer norm's four kernels in bf16 at ragged rows, rows of several
    statistics splits and the strided model's 2x2x64 map: the statistics
    on pixels in [0, 1] with an offset, the forward on the twin's
    statistics with per-tenant gamma and beta, the backward and double
    backward on random cotangents, each on its ``*_bf16`` counter."""
    T, N, H, W, C = shape
    g = torch.Generator().manual_seed(sum(shape))

    def r(*s, scale=1.0):
        return (torch.randn(*s, generator=g) * scale).to(device).bfloat16()

    x = (3.0 + torch.rand(T, N, H, W, C, generator=g)).to(device).bfloat16()
    gamma, beta = 1 + r(T, H, W, C, scale=0.3), r(T, H, W, C, scale=0.1)
    cb.reset_launches()
    for a, c, what in zip(cb.layer_norm_stats(x), F.layer_norm_stats(x),
                          ("mean", "var", "rstd")):
        within_ulp(a, c, f"layer_norm_stats {what}")
    mean, _, rstd = F.layer_norm_stats(x)
    z = cb.layer_norm_fwd(x, mean, rstd, gamma, beta)
    assert z.dtype == torch.bfloat16
    assert torch.equal(z, F.layer_norm_fwd(x, mean, rstd, gamma, beta))
    dz = r(T, N, H, W, C)
    ln = (x, mean, rstd, gamma)
    for a, c, what in zip(cb.layer_norm_bwd(dz, *ln),
                          F.layer_norm_bwd(dz, *ln),
                          ("dx", "dgamma", "dbeta")):
        within_ulp(a, c, f"layer_norm_bwd {what}")
    args = (r(T, N, H, W, C), r(T, H, W, C), r(T, H, W, C), dz, *ln)
    for a, c, what in zip(cb.layer_norm_bwd_bwd(*args),
                          F.layer_norm_bwd_bwd(*args),
                          ("g_dz", "g_x", "g_gamma")):
        within_ulp(a, c, f"layer_norm_bwd_bwd {what}")
    assert {k: n for k, n in cb.launches().items() if n} == {
        f"{k}_bf16": 1 for k in ("layer_norm_stats", "layer_norm_fwd",
                                 "layer_norm_bwd", "layer_norm_bwd_bwd")}
    torch.cuda.synchronize()


@pytest.mark.parametrize("kw", [{}, dict(stride=2, pool=False, gap=True)],
                         ids=["pooled", "strided_gap"])
@pytest.mark.parametrize("order", ["conv_first", "norm_first"])
def test_bf16_layer_norm_blocks_second_order_run_on_the_bf16_kernels(
        order, kw, device):
    """The layer-norm blocks' second derivative in bf16 (the gradient of
    ``<v, d loss / d w>``) launches bf16 kernels only — conv first, the
    layer norm's double backward among them (norm first, the layer norm
    precedes the conv and only its forward is on this path); the f32
    leaf's gradient comes back f32 and finite, within 2x the bf16-vs-f32
    spread of the same block on the twins (the CPU, bf16 and f32) from the
    twins' bf16 result."""
    x, w, b, _, _ = bf16_inputs((2, 3, 12, 12, 3, 8), device)
    if order == "norm_first":
        fn, norm_shape = cb.ln_conv_function_block, (12, 12, 3)
    else:
        fn = cb.conv_ln_function_block
        hw = F.conv_out_hw(12, 12, kw.get("stride", 1), 1)
        norm_shape = (*hw, 8)
    gen = torch.Generator().manual_seed(3)
    gamma = 1 + 0.1 * torch.randn(norm_shape, generator=gen)
    beta = 0.1 * torch.randn(norm_shape, generator=gen)
    v = torch.randn(w.shape, generator=torch.Generator().manual_seed(2))
    results = {}
    for name, dev, dtype in (("kernels", device, torch.bfloat16),
                             ("twins bf16", "cpu", torch.bfloat16),
                             ("twins f32", "cpu", torch.float32)):
        w32 = w.float().to(dev).requires_grad_(True)
        cb.reset_launches()
        out, _, _ = fn(x.to(dev, dtype), w32.to(dtype), b.to(dev, dtype),
                       gamma.to(dev), beta.to(dev), **kw)
        gw, = torch.autograd.grad(out.float().square().sum(), [w32],
                                  create_graph=True)
        results[name] = torch.autograd.grad((gw * v.to(dev)).sum(),
                                            [w32])[0].cpu()
        if name == "kernels":
            launched = {k for k, n in cb.launches().items() if n}
    got = results["kernels"]
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert ("layer_norm_fwd_bf16" if order == "norm_first"
            else "layer_norm_bwd_bwd_bf16") in launched
    assert all(k.endswith("_bf16") for k in launched), launched
    spread = (results["twins bf16"] - results["twins f32"]).abs().max()
    assert (got - results["twins bf16"]).abs().max() <= 2 * spread


# K4 in f32 at stride 1: the band kernels (csrc/conv3x3_bwd_s1.cu). Every
# shape the shipped configs run — mini-ImageNet stages 0-3 (84/42/21/10,
# cin 3 then 48, cout 48) at N 25 and 75, T 2 and 8; Omniglot's layers 1-4
# (28/14/7/3, cin 1 then 64, cout 64) at N 20, T 8; the unpadded stages
# (84/41/19/8) — and edge shapes: a band or a split that ends inside an
# image, rows of other lengths than a band's, T = 1, cin 1, 2 and 3, channel
# counts that fill no tile (an odd cin, cout 33 and 130: two channel tiles
# of wgrad), pad 0 and 1. dgrad at stage 0 is the norm-first model's (back
# to the normalized image, cin 3).
K4_MAIN_SHAPES = (
    [(T, n, hw, cin, 48, 1) for T in (2, 8) for n in (25, 75)
     for hw, cin in ((84, 3), (42, 48), (21, 48), (10, 48))]
    + [(8, 20, hw, cin, 64, 1)
       for hw, cin in ((28, 1), (14, 64), (7, 64), (3, 64))]
    + [(T, 25, hw, cin, 48, 0) for T in (2, 8)
       for hw, cin in ((84, 3), (41, 48), (19, 48), (8, 48))]
)
K4_EDGE_SHAPES = [
    # T, N, H, W, cin, cout, pad
    (1, 1, 5, 5, 1, 4, 1),
    (1, 1, 5, 5, 1, 4, 0),
    (1, 3, 9, 7, 3, 20, 1),
    (2, 3, 11, 9, 3, 20, 0),
    (1, 2, 9, 11, 2, 16, 1),
    (1, 2, 13, 6, 17, 33, 1),
    (2, 5, 10, 10, 17, 33, 0),
    (2, 4, 6, 30, 5, 12, 1),
    (1, 7, 12, 12, 64, 64, 0),
    (1, 2, 8, 8, 48, 130, 1),
    (1, 3, 4, 9, 100, 16, 1),
]


def _k4_inputs(T, N, H, W, cin, cout, pad, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    Ho, Wo = F.conv_out_hw(H, W, 1, pad)
    x = torch.randn(T, N, H, W, cin, device="cuda", generator=g)
    dy = torch.randn(T, N, Ho, Wo, cout, device="cuda", generator=g)
    w = torch.randn(T, 3, 3, cin, cout, device="cuda", generator=g)
    return x, dy, w * (2.0 / (9 * cin)) ** 0.5


def _check_k4_band(T, N, H, W, cin, cout, pad, seed):
    """dgrad and wgrad against their twins, one launch each on the f32
    stride-1 counters, and a second launch on the same inputs bit for bit
    the first."""
    x, dy, w = _k4_inputs(T, N, H, W, cin, cout, pad, seed)
    cb.reset_launches()
    dx = cb.conv3x3_dgrad(dy, w, 1, (H, W), pad)
    _close(dx, F.conv3x3_dgrad(dy, w, 1, (H, W), pad))
    dw, db = cb.conv3x3_wgrad(x, dy, padding=pad)
    want = F.conv3x3_wgrad(x, dy, padding=pad)
    _close(dw, want[0])
    _close(db, want[1])
    tag = "_p0" if pad == 0 else ""
    assert cb.launches() == {**{k: 0 for k in cb.KERNELS},
                             f"conv3x3{tag}_dgrad": 1,
                             f"conv3x3{tag}_wgrad": 1}
    assert torch.equal(cb.conv3x3_dgrad(dy, w, 1, (H, W), pad), dx)
    again = cb.conv3x3_wgrad(x, dy, padding=pad)
    assert torch.equal(again[0], dw) and torch.equal(again[1], db)
    torch.cuda.synchronize()


@pytest.mark.parametrize("shape", K4_MAIN_SHAPES, ids=str)
def test_k4_band_kernels_match_their_twins_at_main_path_shapes(shape,
                                                               device):
    T, N, hw, cin, cout, pad = shape
    _check_k4_band(T, N, hw, hw, cin, cout, pad, seed=hw + cin + N + T)
    torch.cuda.empty_cache()


@pytest.mark.parametrize("shape", K4_EDGE_SHAPES, ids=str)
def test_k4_band_kernels_match_their_twins_at_edge_shapes(shape, device):
    _check_k4_band(*shape, seed=sum(shape))


@pytest.mark.parametrize("pad", (1, 0))
def test_k4_band_kernels_take_tensors_off_16_byte_alignment(pad, device):
    """Views 4 bytes into their storage (contiguous, so the wrappers take
    them): the band kernels copy them by 4-byte cp.async."""
    T, N, H, W, cin, cout = 2, 3, 12, 12, 48, 48
    x, dy, w = _k4_inputs(T, N, H, W, cin, cout, pad, seed=7)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, device=t.device)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        assert view.data_ptr() % 16 != 0
        return view

    xs, dys, ws = shifted(x), shifted(dy), shifted(w)
    _close(cb.conv3x3_dgrad(dys, ws, 1, (H, W), pad),
           F.conv3x3_dgrad(dy, w, 1, (H, W), pad))
    for a, c in zip(cb.conv3x3_wgrad(xs, dys, padding=pad),
                    F.conv3x3_wgrad(x, dy, padding=pad)):
        _close(a, c)


# K1 in f32 at stride 1: the band kernels (csrc/conv3x3_fwd_s1.cu), both
# modes. Every shape the shipped configs run — mini-ImageNet stages 0-3
# (84/42/21/10, cin 3 then 48, cout 48) at N 25 and 75, T 2 and 8;
# Omniglot's layers 1-4 (28/14/7/3, cin 1 then 64, cout 64) at N 20, T 8;
# the unpadded stages (84/41/19/8 -> 82/39/17/6) — and edge shapes: rows
# that the band rows do not divide, bands of one row (the small maps), T =
# 1, cin 1, 2, 3 and 17, channel counts that fill no 8-channel group (cout
# 4, 20, 33) or more than 8 groups (130), pad 0 and 1.
K1_MAIN_SHAPES = (
    [(T, n, hw, cin, 48, 1) for T in (2, 8) for n in (25, 75)
     for hw, cin in ((84, 3), (42, 48), (21, 48), (10, 48))]
    + [(8, 20, hw, cin, 64, 1)
       for hw, cin in ((28, 1), (14, 64), (7, 64), (3, 64))]
    + [(T, n, hw, cin, 48, 0) for T in (2, 8) for n in (25, 75)
       for hw, cin in ((84, 3), (41, 48), (19, 48), (8, 48))]
)
K1_EDGE_SHAPES = [
    # T, N, H, W, cin, cout, pad
    (1, 1, 5, 5, 1, 4, 1),
    (1, 1, 5, 5, 1, 4, 0),
    (1, 3, 9, 7, 3, 20, 1),
    (2, 3, 11, 9, 3, 20, 0),
    (1, 2, 9, 11, 2, 16, 1),
    (1, 2, 13, 6, 17, 33, 1),
    (2, 5, 10, 10, 17, 33, 0),
    (2, 4, 6, 30, 5, 12, 1),
    (1, 7, 12, 12, 64, 64, 0),
    (1, 2, 8, 8, 48, 130, 1),
    (3, 8, 23, 23, 48, 48, 1),
    (2, 2, 7, 7, 64, 64, 1),
    (1, 3, 3, 3, 64, 64, 1),
]


def _k1_inputs(T, N, H, W, cin, cout, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(T, N, H, W, cin, device="cuda", generator=g)
    w = torch.randn(T, 3, 3, cin, cout, device="cuda", generator=g)
    b = 0.1 * torch.randn(T, cout, device="cuda", generator=g)
    return x, w * (2.0 / (9 * cin)) ** 0.5, b


def _check_k1_band(T, N, H, W, cin, cout, pad, seed):
    """K1 with statistics and stats-free (with and without bias) against
    their twins on the f32 stride-1 counters, each launch of the band
    plan, and a second launch on the same inputs bit for bit the first."""
    x, w, b = _k1_inputs(T, N, H, W, cin, cout, seed)
    assert cb.fwd_plan(T, N, H, W, cin, cout, 1, pad,
                       cb._sms(x.device)).kernel == "band"
    cb.reset_launches()
    got = cb.conv3x3_fwd_stats(x, w, b, padding=pad)
    for a, c in zip(got, F.conv3x3_fwd_stats(x, w, b, padding=pad)):
        _close(a, c)
    y = cb.conv3x3_fwd(x, w, b, padding=pad)
    _close(y, F.conv3x3(x, w, b, padding=pad))
    y0 = cb.conv3x3_fwd(x, w, None, padding=pad)
    _close(y0, F.conv3x3(x, w, None, padding=pad))
    tag = "_p0" if pad == 0 else ""
    assert cb.launches() == {**{k: 0 for k in cb.KERNELS},
                             f"conv3x3{tag}_fwd_stats": 1,
                             f"conv3x3{tag}_fwd": 2}
    # the stats-free mode with bias is the stats mode's y, bit for bit
    assert torch.equal(y, got[0])
    again = cb.conv3x3_fwd_stats(x, w, b, padding=pad)
    assert all(torch.equal(a, c) for a, c in zip(again, got))
    assert torch.equal(cb.conv3x3_fwd(x, w, None, padding=pad), y0)
    torch.cuda.synchronize()


@pytest.mark.parametrize("shape", K1_MAIN_SHAPES, ids=str)
def test_k1_band_kernels_match_their_twins_at_main_path_shapes(shape,
                                                               device):
    T, N, hw, cin, cout, pad = shape
    _check_k1_band(T, N, hw, hw, cin, cout, pad, seed=hw + cin + N + T)
    torch.cuda.empty_cache()


@pytest.mark.parametrize("shape", K1_EDGE_SHAPES, ids=str)
def test_k1_band_kernels_match_their_twins_at_edge_shapes(shape, device):
    T, N, H, W, cin, cout, pad = shape
    plan = cb.fwd_plan(T, N, H, W, cin, cout, 1, pad, cb._sms(device))
    if shape in ((2, 2, 7, 7, 64, 64, 1), (1, 3, 3, 3, 64, 64, 1)):
        # the small maps: bands of one row, 4 channels a thread
        assert plan.band_rows == 1 and plan.channels == 4
    if shape == (3, 8, 23, 23, 48, 48, 1):
        assert 23 % plan.band_rows  # a last band shorter than the others
    _check_k1_band(*shape, seed=sum(shape))


@pytest.mark.parametrize("pad", (1, 0))
def test_k1_band_kernels_take_tensors_off_16_byte_alignment(pad, device):
    """Views 4 bytes into their storage (contiguous, so the wrappers take
    them): the band kernels copy the weights by 4-byte cp.async and store y
    a float at a time."""
    T, N, H, W, cin, cout = 2, 3, 12, 12, 48, 48
    x, w, b = _k1_inputs(T, N, H, W, cin, cout, seed=9)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, device=t.device)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        assert view.data_ptr() % 16 != 0
        return view

    xs, ws, bs = shifted(x), shifted(w), shifted(b)
    for a, c in zip(cb.conv3x3_fwd_stats(xs, ws, bs, padding=pad),
                    F.conv3x3_fwd_stats(x, w, b, padding=pad)):
        _close(a, c)
    _close(cb.conv3x3_fwd(xs, ws, bs, padding=pad),
           F.conv3x3(x, w, b, padding=pad))


# K1 (both modes) and K4 dgrad at stride 2, f32 and bf16: the band kernels
# of csrc/conv3x3_s2.cu (f32 on FFMA in the tile's order, bf16 on the
# tensor cores). Every stride-2 shape the shipped configs run — the strided
# Omniglot model's layers 1-4 (28/14/7/4, cin 1 then 64, cout 64) at N 20,
# T 8, pad 1; the unpadded strided model's stages 0-3 (84/41/20/9, cin 3
# then 48, cout 48) at N 25 and 75, T 8, pad 0; dgrad back to the image
# (cin 1 and 3: the norm-first models) at each first layer — and edge
# shapes: odd and non-square maps (7 -> 4 at pad 1, 9 -> 4 at pad 0), T =
# 1, cin 1, 2, 3, 5, 17 and 20 (the bf16 patch rows packed at cin <= 3),
# cout 1, 3, 4, 12, 20, 33 and 65 (channel groups and n8 tiles padded and
# masked; two chunks), pad 0 and 1 (the main shapes' last bands are
# shorter than the others: 41 -> 6 rows of 7, 21 quad rows -> 10 of 11). f32
# within 1e-5 + 1e-4 * max |twin|, bf16 ``within_ulp`` (y one ulp of the
# sum and one of the bias add); dx's last row and column where no output
# reads them (pad 0, an even map) an exact zero; a second launch of each
# bit for bit the first.
S2_MAIN_SHAPES = (
    [(8, 20, hw, cin, 64, 1)
     for hw, cin in ((28, 1), (14, 64), (7, 64), (4, 64))]
    + [(8, n, hw, cin, 48, 0) for n in (25, 75)
       for hw, cin in ((84, 3), (41, 48), (20, 48), (9, 48))]
)
S2_EDGE_SHAPES = [
    # T, N, H, W, cin, cout, pad
    (1, 1, 5, 5, 1, 4, 1),
    (1, 1, 5, 5, 1, 4, 0),
    (1, 3, 9, 7, 3, 20, 1),
    (2, 3, 11, 10, 3, 20, 0),
    (1, 2, 9, 11, 2, 16, 1),
    (1, 2, 13, 6, 17, 33, 1),
    (2, 5, 10, 10, 17, 33, 0),
    (2, 4, 6, 30, 5, 12, 1),
    (2, 3, 12, 12, 20, 3, 1),
    (1, 2, 10, 9, 20, 1, 0),
    (1, 2, 8, 8, 48, 65, 1),
    (3, 8, 23, 23, 48, 48, 1),
    (2, 2, 7, 7, 64, 64, 1),
    (1, 3, 4, 4, 64, 64, 0),
]
S2_DTYPES = (torch.float32, torch.bfloat16)


def _check_s2(T, N, H, W, cin, cout, pad, seed, dtype):
    """K1 with statistics and stats-free (with and without bias) and dgrad
    at stride 2 against their twins on the stride-2 counters, each on its
    band plan; the stats-free y with the bias the stats mode's bit for bit;
    dx's unread last row and column zero; a second launch of each bit for
    bit the first."""
    x, w, b = (t.to(dtype) for t in _k1_inputs(T, N, H, W, cin, cout, seed))
    bf = dtype == torch.bfloat16
    sms = cb._sms(x.device)
    kernel = "s2_mma" if bf else "s2"
    assert cb.fwd_plan(T, N, H, W, cin, cout, 2, pad, sms, bf).kernel == kernel
    assert cb.dgrad_plan(T, N, H, W, cin, cout, 2, pad, sms,
                         bf).kernel == kernel

    def hold(got, want, what, ulps=None):
        if bf:
            within_ulp(got, want, what, ulps)
        else:
            _close(got, want)

    cb.reset_launches()
    got = cb.conv3x3_fwd_stats(x, w, b, stride=2, padding=pad)
    want = F.conv3x3_fwd_stats(x, w, b, stride=2, padding=pad)
    plain = F.conv3x3(x, w, stride=2, padding=pad)
    hold(got[0], want[0], "K1 y", bf16_ulp(want[0]) + bf16_ulp(plain))
    for a, c, what in zip(got[1:], want[1:], ("mean", "var", "rstd")):
        hold(a, c, f"K1 {what}")
    y = cb.conv3x3_fwd(x, w, b, 2, pad)
    assert torch.equal(y, got[0])
    y0 = cb.conv3x3_fwd(x, w, None, 2, pad)
    hold(y0, plain, "K1 stats-free")
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    dy = torch.randn(plain.shape, device="cuda", generator=g).to(dtype)
    dx = cb.conv3x3_dgrad(dy, w, 2, (H, W), pad)
    hold(dx, F.conv3x3_dgrad(dy, w, 2, (H, W), pad), "dgrad")
    if pad == 0 and H % 2 == 0:
        assert not dx[:, :, -1].any()
    if pad == 0 and W % 2 == 0:
        assert not dx[:, :, :, -1].any()
    tag = "_s2" + ("_p0" if pad == 0 else "")
    sfx = "_bf16" if bf else ""
    assert cb.launches() == {**{k: 0 for k in cb.KERNELS},
                             f"conv3x3{tag}_fwd_stats{sfx}": 1,
                             f"conv3x3{tag}_fwd{sfx}": 2,
                             f"conv3x3{tag}_dgrad{sfx}": 1}
    again = cb.conv3x3_fwd_stats(x, w, b, stride=2, padding=pad)
    assert all(torch.equal(a, c) for a, c in zip(again, got))
    assert torch.equal(cb.conv3x3_fwd(x, w, None, 2, pad), y0)
    assert torch.equal(cb.conv3x3_dgrad(dy, w, 2, (H, W), pad), dx)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", S2_DTYPES, ids=("f32", "bf16"))
@pytest.mark.parametrize("shape", S2_MAIN_SHAPES, ids=str)
def test_s2_kernels_match_their_twins_at_main_path_shapes(shape, dtype,
                                                          device):
    T, N, hw, cin, cout, pad = shape
    _check_s2(T, N, hw, hw, cin, cout, pad, hw + cin + N, dtype)
    torch.cuda.empty_cache()


@pytest.mark.parametrize("dtype", S2_DTYPES, ids=("f32", "bf16"))
@pytest.mark.parametrize("shape", S2_EDGE_SHAPES, ids=str)
def test_s2_kernels_match_their_twins_at_edge_shapes(shape, dtype, device):
    T, N, H, W, cin, cout, pad = shape
    bf = dtype == torch.bfloat16
    plan = cb.fwd_plan(T, N, H, W, cin, cout, 2, pad, cb._sms(device), bf)
    if cout > 64 and bf:
        assert plan.grid[1] > 1  # channel chunks
    _check_s2(*shape, sum(shape), dtype)


@pytest.mark.parametrize("dtype", S2_DTYPES, ids=("f32", "bf16"))
@pytest.mark.parametrize("pad", (1, 0))
def test_s2_kernels_take_tensors_off_16_byte_alignment(pad, dtype, device):
    """Views one element into their storage (contiguous, so the wrappers
    take them): the kernels stage x, dy and the weights an element (f32: 4
    bytes) at a time and store y and dx an element at a time, with the
    aligned launch's bits."""
    T, N, H, W, cin, cout = 2, 3, 14, 13, 48, 48
    x, w, b = (t.to(dtype) for t in _k1_inputs(T, N, H, W, cin, cout, 9))
    dy = torch.randn(T, N, *F.conv_out_hw(H, W, 2, pad), cout,
                     device=device).to(dtype)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, device=t.device, dtype=t.dtype)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        assert view.data_ptr() % 16 != 0
        return view

    xs, ws, bs, dys = shifted(x), shifted(w), shifted(b), shifted(dy)
    got = cb.conv3x3_fwd_stats(xs, ws, bs, stride=2, padding=pad)
    assert all(torch.equal(a, c) for a, c in zip(
        got, cb.conv3x3_fwd_stats(x, w, b, stride=2, padding=pad)))
    assert torch.equal(cb.conv3x3_fwd(xs, ws, None, 2, pad),
                       cb.conv3x3_fwd(x, w, None, 2, pad))
    dx = cb.conv3x3_dgrad(dys, ws, 2, (H, W), pad)
    assert torch.equal(dx, cb.conv3x3_dgrad(dy, w, 2, (H, W), pad))
    want = F.conv3x3_dgrad(dy, w, 2, (H, W), pad)
    if dtype == torch.bfloat16:
        within_ulp(dx, want, "dgrad")
    else:
        _close(dx, want)


@pytest.mark.parametrize("dtype", S2_DTYPES, ids=("f32", "bf16"))
def test_s2_entries_refuse_a_plan_that_does_not_match(dtype, device):
    """The stride-2 entries check the plan's band rows, channels, blocks,
    threads and shared memory against the geometry they follow from, and
    launch nothing otherwise; the plan's own launch gives the wrapper's
    bits."""
    import ctypes

    from howtotrainyourmamlpytorch_tpu_torch.kernels import build

    bf = dtype == torch.bfloat16
    T, N, H, W, cin, cout, pad = 2, 3, 21, 21, 48, 48, 1
    x, w, b = (t.to(dtype) for t in _k1_inputs(T, N, H, W, cin, cout, 13))
    sms = cb._sms(device)
    plan = cb.fwd_plan(T, N, H, W, cin, cout, 2, pad, sms, bf)
    d = cb.dgrad_plan(T, N, H, W, cin, cout, 2, pad, sms, bf)
    Ho, Wo = F.conv_out_hw(H, W, 2, pad)
    y = torch.full((T, N, Ho, Wo, cout), 7.0, device=device).to(dtype)
    dy = torch.randn(T, N, Ho, Wo, cout, device=device).to(dtype)
    dx = torch.full((T, N, H, W, cin), 7.0, device=device).to(dtype)
    part = torch.empty(plan.scratch, device=device)
    stats = [torch.empty((T, cout), device=device).to(dtype)
             for _ in range(3)]
    P, I = ctypes.c_void_p, ctypes.c_int
    mma = ("_mma",) if bf else ("",)
    n = 12 if bf else 11
    fwd = build.function("conv3x3_s2", "conv3x3_s2_fwd" + mma[0],
                         (P,) * 4 + (I,) * n + (P,))
    with_stats = build.function("conv3x3_s2",
                                "conv3x3_s2_fwd_stats" + mma[0],
                                (P,) * 8 + (I,) * n + (ctypes.c_float, P))
    dgrad = build.function("conv3x3_s2", "conv3x3_s2_dgrad" + mma[0],
                           (P,) * 3 + (I,) * n + (P,))
    stream = torch.cuda.current_stream().cuda_stream
    geometry = (T, N, H, W, pad, cin, cout)
    eps = F.scalar_like(F.BN_EPS, x)

    def args(p):
        mid = (p.grid[0],) if bf else ()
        return (p.band_rows, p.channels, *mid, p.threads, p.smem)

    def spoiled(p):
        good = list(args(p))
        out = []
        for i, bad in ((0, p.band_rows + 1), (1, 40), (-2, p.threads + 32),
                       (-1, p.smem + 16), (-1, p.smem - 16)):
            a = list(good)
            a[i] = bad
            out.append(a)
        if bf:
            for bad in (0, N * p.bands + 1):
                a = list(good)
                a[2] = bad
                out.append(a)
        return out

    for a in spoiled(plan):
        assert fwd(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                   *geometry, *a, stream) != 0
        assert with_stats(*(t.data_ptr() for t in (x, w, b, y, part,
                                                    *stats)),
                          *geometry, *a, eps, stream) != 0
    for a in spoiled(d):
        assert dgrad(dy.data_ptr(), w.data_ptr(), dx.data_ptr(), *geometry,
                     *a, stream) != 0
    torch.cuda.synchronize()
    assert bool((y == 7.0).all()) and bool((dx == 7.0).all())
    assert fwd(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
               *geometry, *args(plan), stream) == 0
    assert dgrad(dy.data_ptr(), w.data_ptr(), dx.data_ptr(), *geometry,
                 *args(d), stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(y, cb.conv3x3_fwd(x, w, b, 2, pad))
    assert torch.equal(dx, cb.conv3x3_dgrad(dy, w, 2, (H, W), pad))


# K4 wgrad at stride 2, f32 and bf16, pad 1 and 0: csrc/conv3x3_wgrad_s2.cu
# (the band kernel, ``"s2"``; the tensor-core kernels, ``"s2_mma"``). Every
# stride-2 shape the shipped configs run — the strided Omniglot model's
# layers 1-4 (28/14/7/4, cin 1 then 64, cout 64) at N 20, T 8, pad 1; the
# unpadded strided model's stages 0-3 (84/41/20/9, cin 3 then 48, cout 48)
# at N 25, T 8 and 2, pad 0 — and edge shapes (S2_EDGE_SHAPES and more):
# odd and non-square maps (7 -> 4 and 4 -> 2 at pad 1, 9 -> 4 and 20 -> 9
# at pad 0, the last source row and column of an even map read by no
# output), T = 1, cin 1, 2, 3 (a whole kernel row a thread; the packed
# kernel), 5, 17, 20, 48, 64 and 65 (runs of 8, source chunks), cout 1, 3,
# 4, 12, 20, 33, 65 and 130 (channel groups and n8 tiles padded and masked;
# output chunks), a split of one band. f32 within 1e-5 + 1e-4 * max |twin|,
# bf16 ``within_ulp``; one launch on the stride-2 counter; a second launch
# bit for bit the first.
S2_WGRAD_MAIN_SHAPES = (
    [(8, 20, hw, cin, 64, 1)
     for hw, cin in ((28, 1), (14, 64), (7, 64), (4, 64))]
    + [(T, 25, hw, cin, 48, 0) for T in (8, 2)
       for hw, cin in ((84, 3), (41, 48), (20, 48), (9, 48))]
)
S2_WGRAD_EDGE_SHAPES = S2_EDGE_SHAPES + [
    # T, N, H, W, cin, cout, pad
    (1, 2, 8, 8, 48, 130, 0),
    (1, 3, 9, 7, 65, 65, 1),
    (2, 3, 9, 9, 65, 20, 0),
    (2, 20, 4, 4, 64, 64, 1),
    (1, 3, 3, 3, 64, 64, 0),
]


def _check_s2_wgrad(T, N, H, W, cin, cout, pad, seed, dtype):
    g = torch.Generator(device="cuda").manual_seed(seed)
    Ho, Wo = F.conv_out_hw(H, W, 2, pad)
    x = torch.randn(T, N, H, W, cin, device="cuda", generator=g).to(dtype)
    dy = torch.randn(T, N, Ho, Wo, cout, device="cuda", generator=g).to(dtype)
    bf = dtype == torch.bfloat16
    plan = cb.wgrad_plan(T, N, H, W, cin, cout, 2, pad, cb._sms(x.device), bf)
    assert plan.kernel == ("s2_mma" if bf else "s2")
    cb.reset_launches()
    dw, db = cb.conv3x3_wgrad(x, dy, 2, pad)
    tag = "_s2" + ("_p0" if pad == 0 else "")
    assert cb.launches() == {**{k: 0 for k in cb.KERNELS},
                             f"conv3x3{tag}_wgrad{'_bf16' if bf else ''}": 1}
    for a, c, what in zip((dw, db), F.conv3x3_wgrad(x, dy, 2, pad),
                          ("dw", "db")):
        assert a.dtype == dtype and a.is_contiguous()
        if bf:
            within_ulp(a, c, f"wgrad s2 {what}")
        else:
            _close(a, c)
    again = cb.conv3x3_wgrad(x, dy, 2, pad)
    assert torch.equal(again[0], dw) and torch.equal(again[1], db)
    torch.cuda.synchronize()
    return plan


@pytest.mark.parametrize("dtype", S2_DTYPES, ids=("f32", "bf16"))
@pytest.mark.parametrize("shape", S2_WGRAD_MAIN_SHAPES, ids=str)
def test_s2_wgrad_matches_its_twin_at_main_path_shapes(shape, dtype, device):
    T, N, hw, cin, cout, pad = shape
    _check_s2_wgrad(T, N, hw, hw, cin, cout, pad, hw + cin + N + T, dtype)
    torch.cuda.empty_cache()


@pytest.mark.parametrize("dtype", S2_DTYPES, ids=("f32", "bf16"))
@pytest.mark.parametrize("shape", S2_WGRAD_EDGE_SHAPES, ids=str)
def test_s2_wgrad_matches_its_twin_at_edge_shapes(shape, dtype, device):
    plan = _check_s2_wgrad(*shape, sum(shape), dtype)
    if shape == (3, 8, 23, 23, 48, 48, 1):
        assert plan.splits > 1 and plan.bands > 1


@pytest.mark.parametrize("dtype", S2_DTYPES, ids=("f32", "bf16"))
@pytest.mark.parametrize("pad", (1, 0))
def test_s2_wgrad_takes_tensors_off_16_byte_alignment(pad, dtype, device):
    """Views one element into their storage (contiguous, so the wrapper
    takes them): the kernels stage x and dy an element (f32: 4 bytes; the
    bf16 packed kernel's source rows an element) at a time, with the
    aligned launch's bits."""
    for cin in (48, 3, 1):
        T, N, H, W, cout = 2, 3, 14, 13, 48
        x = torch.randn(T, N, H, W, cin, device=device).to(dtype)
        dy = torch.randn(T, N, *F.conv_out_hw(H, W, 2, pad), cout,
                         device=device).to(dtype)

        def shifted(t):
            buf = torch.empty(t.numel() + 1, device=t.device, dtype=t.dtype)
            view = buf[1:].view(t.shape)
            view.copy_(t)
            assert view.data_ptr() % 16 != 0
            return view

        got = cb.conv3x3_wgrad(shifted(x), shifted(dy), 2, pad)
        want = cb.conv3x3_wgrad(x, dy, 2, pad)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("dtype", S2_DTYPES, ids=("f32", "bf16"))
def test_s2_wgrad_entries_refuse_a_plan_that_does_not_match(dtype, device):
    """The stride-2 wgrad entries check the plan's splits, band rows,
    kernel rows, groups, replicas (f32) or tiles and channels (bf16),
    threads and shared memory against the geometry they follow from, and
    launch nothing otherwise; the plan's own launch gives the wrapper's
    bits."""
    from howtotrainyourmamlpytorch_tpu_torch.kernels import build

    bf = dtype == torch.bfloat16
    for T, N, H, W, cin, cout, pad in ((2, 3, 21, 21, 48, 48, 1),
                                       (2, 3, 20, 20, 3, 48, 0)):
        Ho, Wo = F.conv_out_hw(H, W, 2, pad)
        x = torch.randn(T, N, H, W, cin, device=device).to(dtype)
        dy = torch.randn(T, N, Ho, Wo, cout, device=device).to(dtype)
        plan = cb.wgrad_plan(T, N, H, W, cin, cout, 2, pad,
                             cb._sms(device), bf)
        part = torch.empty(T * plan.splits * (9 * cin + 1) * cout,
                           device=device)
        dw = torch.full((T, 3, 3, cin, cout), 7.0, device=device).to(dtype)
        db = torch.full((T, cout), 7.0, device=device).to(dtype)
        fn = build.function(*cb._WGRAD_ENTRIES[plan.kernel],
                            cb._ADDR_ENTRY)
        stream = torch.cuda.current_stream(device).cuda_stream
        head = (x.data_ptr(), dy.data_ptr(), part.data_ptr(),
                part.data_ptr() + 4 * T * plan.splits * 9 * cin * cout,
                dw.data_ptr(), db.data_ptr(), T, N, H, W, pad, cin, cout)
        good = [plan.splits, plan.band_rows, plan.kernel_rows, plan.groups,
                plan.replicas, plan.m_tiles, plan.channels, plan.threads,
                plan.smem]
        spoil = [(0, 0), (0, N * plan.bands + 1), (1, Ho + 1),
                 (7, plan.threads + 32), (8, plan.smem + 16),
                 (8, plan.smem - 16)]
        spoil += ([(5, plan.m_tiles + 1), (6, 40)] if bf else
                  [(2, 2), (3, plan.groups + 1), (4, plan.replicas + 1)])
        for i, bad in spoil:
            args = list(good)
            args[i] = bad
            packed = cb._packed(*head, *args, device.index, stream)
            assert fn(packed.buffer_info()[0]) != 0
        torch.cuda.synchronize()
        assert bool((dw == 7.0).all()) and bool((db == 7.0).all())
        packed = cb._packed(*head, *good, device.index, stream)
        assert fn(packed.buffer_info()[0]) == 0
        torch.cuda.synchronize()
        want = cb.conv3x3_wgrad(x, dy, 2, pad)
        assert torch.equal(dw, want[0]) and torch.equal(db, want[1])


def test_k1_band_entries_refuse_a_plan_that_does_not_match(device):
    """The entries check the plan's threads and shared memory against the
    geometry they follow from, and launch nothing otherwise."""
    import ctypes

    from howtotrainyourmamlpytorch_tpu_torch.kernels import build

    T, N, H, W, cin, cout, pad = 2, 3, 21, 21, 48, 48, 1
    x, w, b = _k1_inputs(T, N, H, W, cin, cout, seed=13)
    plan = cb.fwd_plan(T, N, H, W, cin, cout, 1, pad, cb._sms(device))
    y = torch.full((T, N, H, W, cout), 7.0, device=device)
    part = torch.empty(plan.scratch, device=device)
    stats = [torch.empty((T, cout), device=device) for _ in range(3)]
    P, I = ctypes.c_void_p, ctypes.c_int
    plain = build.function("conv3x3_fwd_s1", "conv3x3_fwd_band",
                           (P,) * 4 + (I,) * 11 + (P,))
    with_stats = build.function("conv3x3_fwd_s1", "conv3x3_fwd_stats_band",
                                (P,) * 8 + (I,) * 11 + (ctypes.c_float, P))
    stream = torch.cuda.current_stream().cuda_stream
    geometry = (T, N, H, W, pad, cin, cout, plan.band_rows)
    other = 12 - plan.channels  # the other thread width, 4 or 8
    for channels, threads, smem in (
            (plan.channels, plan.threads + 32, plan.smem),
            (plan.channels, plan.threads, plan.smem + 16),
            (plan.channels, plan.threads, plan.smem - 16),
            (other, plan.threads, plan.smem), (6, plan.threads, plan.smem)):
        assert plain(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                     *geometry, channels, threads, smem, stream) != 0
        assert with_stats(*(t.data_ptr() for t in (x, w, b, y, part,
                                                    *stats)),
                          *geometry, channels, threads, smem, F.BN_EPS,
                          stream) != 0
    torch.cuda.synchronize()
    assert bool((y == 7.0).all())
    assert plain(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                 *geometry, plan.channels, plan.threads, plan.smem,
                 stream) == 0
    _close(y, F.conv3x3(x, w, b, padding=pad))


# K1 (both modes) and K4 dgrad in bf16 at stride 1: the tensor-core kernel
# of csrc/conv3x3_s1_bf16.cu. Every shape the shipped configs run —
# mini-ImageNet stages 0-3 (84/42/21/10, cin 3 then 48, cout 48) at N 25
# and 75, T 2 and 8; Omniglot's layers 1-4 (28/14/7/3, cin 1 then 64, cout
# 64) at N 20, T 8; the unpadded stages (84/41/19/8) — and edge shapes:
# rows that the band rows do not divide, bands of one row, T = 1, cin 1,
# 2, 3, 5, 17 and 20 (the patch rows packed at cin <= 3, channels padded to
# 16 above), cout 1, 3, 4, 12, 20 and 33 (n8 tiles padded and masked), 65
# and 130 (two and three channel chunks), odd maps, pad 0 and 1. dgrad at
# stage 0 is the norm-first model's (back to the normalized image, cin 3:
# one n8 tile, 3 channels live). The gate is ``within_ulp``'s (the tensor
# cores' f32 sums run in another order than the twin's GEMM): y within one
# bf16 ulp of the sum and one of the bias add, the rest within one ulp.
MMA_MAIN_SHAPES = (
    [(T, n, hw, cin, 48, 1) for T in (2, 8) for n in (25, 75)
     for hw, cin in ((84, 3), (42, 48), (21, 48), (10, 48))]
    + [(8, 20, hw, cin, 64, 1)
       for hw, cin in ((28, 1), (14, 64), (7, 64), (3, 64))]
    + [(T, n, hw, cin, 48, 0) for T in (2, 8) for n in (25, 75)
       for hw, cin in ((84, 3), (41, 48), (19, 48), (8, 48))]
)
MMA_EDGE_SHAPES = [
    # T, N, H, W, cin, cout, pad
    (1, 1, 5, 5, 1, 4, 1),
    (1, 1, 5, 5, 1, 4, 0),
    (1, 3, 9, 7, 3, 20, 1),
    (2, 3, 11, 9, 3, 20, 0),
    (1, 2, 9, 11, 2, 16, 1),
    (1, 2, 13, 6, 17, 33, 1),
    (2, 5, 10, 10, 17, 33, 0),
    (2, 4, 6, 30, 5, 12, 1),
    (2, 3, 12, 12, 20, 3, 1),
    (1, 2, 10, 9, 20, 1, 0),
    (1, 2, 8, 8, 48, 65, 1),
    (1, 3, 9, 7, 17, 65, 0),
    (1, 2, 8, 8, 48, 130, 1),
    (3, 8, 23, 23, 48, 48, 1),
    (1, 3, 3, 3, 64, 64, 1),
]


def _check_mma(T, N, H, W, cin, cout, pad, seed):
    """K1 with statistics and stats-free (with and without bias) and dgrad
    in bf16 against their twins on the bf16 stride-1 counters, each on the
    mma plan; the stats-free y with the bias the stats mode's bit for bit;
    a second launch of each on the same inputs bit for bit the first."""
    x, w, b = (t.bfloat16() for t in _k1_inputs(T, N, H, W, cin, cout, seed))
    sms = cb._sms(x.device)
    assert cb.fwd_plan(T, N, H, W, cin, cout, 1, pad, sms,
                       True).kernel == "mma"
    assert cb.dgrad_plan(T, N, H, W, cin, cout, 1, pad, sms,
                         True).kernel == "mma"
    cb.reset_launches()
    got = cb.conv3x3_fwd_stats(x, w, b, padding=pad)
    want = F.conv3x3_fwd_stats(x, w, b, padding=pad)
    plain = F.conv3x3(x, w, padding=pad)
    within_ulp(got[0], want[0], "K1 y", bf16_ulp(want[0]) + bf16_ulp(plain))
    for a, c, what in zip(got[1:], want[1:], ("mean", "var", "rstd")):
        within_ulp(a, c, f"K1 {what}")
    y = cb.conv3x3_fwd(x, w, b, padding=pad)
    assert torch.equal(y, got[0])
    y0 = cb.conv3x3_fwd(x, w, None, padding=pad)
    within_ulp(y0, plain, "K1 stats-free")
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    dy = torch.randn(plain.shape, device="cuda", generator=g).bfloat16()
    dx = cb.conv3x3_dgrad(dy, w, 1, (H, W), pad)
    within_ulp(dx, F.conv3x3_dgrad(dy, w, 1, (H, W), pad), "dgrad")
    tag = "_p0" if pad == 0 else ""
    assert cb.launches() == {**{k: 0 for k in cb.KERNELS},
                             f"conv3x3{tag}_fwd_stats_bf16": 1,
                             f"conv3x3{tag}_fwd_bf16": 2,
                             f"conv3x3{tag}_dgrad_bf16": 1}
    again = cb.conv3x3_fwd_stats(x, w, b, padding=pad)
    assert all(torch.equal(a, c) for a, c in zip(again, got))
    assert torch.equal(cb.conv3x3_fwd(x, w, None, padding=pad), y0)
    assert torch.equal(cb.conv3x3_dgrad(dy, w, 1, (H, W), pad), dx)
    torch.cuda.synchronize()


@pytest.mark.parametrize("shape", MMA_MAIN_SHAPES, ids=str)
def test_mma_kernels_match_their_twins_at_main_path_shapes(shape, device):
    T, N, hw, cin, cout, pad = shape
    _check_mma(T, N, hw, hw, cin, cout, pad, seed=hw + cin + N + T)
    torch.cuda.empty_cache()


@pytest.mark.parametrize("shape", MMA_EDGE_SHAPES, ids=str)
def test_mma_kernels_match_their_twins_at_edge_shapes(shape, device):
    T, N, H, W, cin, cout, pad = shape
    plan = cb.fwd_plan(T, N, H, W, cin, cout, 1, pad, cb._sms(device), True)
    if shape == (3, 8, 23, 23, 48, 48, 1):
        assert 23 % plan.band_rows  # a last band shorter than the others
    if cout > 64:
        assert plan.grid[1] > 1  # channel chunks
    _check_mma(*shape, seed=sum(shape))


@pytest.mark.parametrize("pad", (1, 0))
def test_mma_kernels_take_tensors_off_16_byte_alignment(pad, device):
    """Views 2 bytes into their storage (contiguous, so the wrappers take
    them): the kernel stages x, dy and the weights 8 bf16 at a time and
    stores y and dx an element at a time."""
    T, N, H, W, cin, cout = 2, 3, 12, 12, 48, 48
    x, w, b = (t.bfloat16() for t in _k1_inputs(T, N, H, W, cin, cout, 9))
    dy = torch.randn(T, N, *F.conv_out_hw(H, W, 1, pad), cout,
                     device=device).bfloat16()

    def shifted(t):
        buf = torch.empty(t.numel() + 1, device=t.device, dtype=t.dtype)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        assert view.data_ptr() % 16 != 0
        return view

    xs, ws, bs, dys = shifted(x), shifted(w), shifted(b), shifted(dy)
    want = F.conv3x3_fwd_stats(x, w, b, padding=pad)
    got = cb.conv3x3_fwd_stats(xs, ws, bs, padding=pad)
    assert all(torch.equal(a, c) for a, c in zip(
        got, cb.conv3x3_fwd_stats(x, w, b, padding=pad)))
    within_ulp(got[0], want[0], "K1 y", bf16_ulp(want[0])
               + bf16_ulp(F.conv3x3(x, w, padding=pad)))
    for a, c, what in zip(got[1:], want[1:], ("mean", "var", "rstd")):
        within_ulp(a, c, f"K1 {what}")
    dx = cb.conv3x3_dgrad(dys, ws, 1, (H, W), pad)
    assert torch.equal(dx, cb.conv3x3_dgrad(dy, w, 1, (H, W), pad))
    within_ulp(dx, F.conv3x3_dgrad(dy, w, 1, (H, W), pad), "dgrad")


def test_mma_entries_refuse_a_plan_that_does_not_match(device):
    """The entries check the plan's channels, blocks, threads and shared
    memory against the geometry they follow from, and launch nothing
    otherwise."""
    import ctypes

    from howtotrainyourmamlpytorch_tpu_torch.kernels import build

    T, N, H, W, cin, cout, pad = 2, 3, 21, 21, 48, 48, 1
    x, w, b = (t.bfloat16() for t in _k1_inputs(T, N, H, W, cin, cout, 13))
    plan = cb.fwd_plan(T, N, H, W, cin, cout, 1, pad, cb._sms(device), True)
    d = cb.dgrad_plan(T, N, H, W, cin, cout, 1, pad, cb._sms(device), True)
    y = torch.full((T, N, H, W, cout), 7.0, device=device).bfloat16()
    part = torch.empty(plan.scratch, device=device)
    stats = [torch.empty((T, cout), device=device).bfloat16()
             for _ in range(3)]
    P, I = ctypes.c_void_p, ctypes.c_int
    fwd = build.function("conv3x3_s1_bf16", "conv3x3_fwd_mma",
                         (P,) * 4 + (I,) * 12 + (P,))
    with_stats = build.function("conv3x3_s1_bf16", "conv3x3_fwd_stats_mma",
                                (P,) * 8 + (I,) * 12 + (ctypes.c_float, P))
    dgrad = build.function("conv3x3_s1_bf16", "conv3x3_dgrad_mma",
                           (P,) * 3 + (I,) * 12 + (P,))
    stream = torch.cuda.current_stream().cuda_stream
    geometry = (T, N, H, W, pad, cin, cout, plan.band_rows)
    eps = F.scalar_like(F.BN_EPS, x)
    for channels, blocks, threads, smem in (
            (plan.channels, plan.grid[0], plan.threads + 32, plan.smem),
            (plan.channels, plan.grid[0], plan.threads, plan.smem + 16),
            (plan.channels, plan.grid[0], plan.threads, plan.smem - 16),
            (40, plan.grid[0], plan.threads, plan.smem),
            (plan.channels, 0, plan.threads, plan.smem),
            (plan.channels, N * plan.bands + 1, plan.threads, plan.smem)):
        assert fwd(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                   *geometry, channels, blocks, threads, smem, stream) != 0
        assert with_stats(*(t.data_ptr() for t in (x, w, b, y, part,
                                                    *stats)),
                          *geometry, channels, blocks, threads, smem, eps,
                          stream) != 0
    assert dgrad(y.data_ptr(), w.data_ptr(), x.data_ptr(), T, N, H, W, pad,
                 cin, cout, d.band_rows, d.channels, d.grid[0],
                 d.threads + 32, d.smem, stream) != 0
    torch.cuda.synchronize()
    assert bool((y == 7.0).all())
    assert fwd(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
               *geometry, plan.channels, plan.grid[0], plan.threads,
               plan.smem, stream) == 0
    torch.cuda.synchronize()
    within_ulp(y, F.conv3x3(x, w, b, padding=pad), "K1 stats-free",
               2 * bf16_ulp(F.conv3x3(x, w, b, padding=pad)))


# K4 wgrad in bf16 at stride 1: the tensor-core kernel of
# csrc/conv3x3_wgrad_s1_bf16.cu. Every shape the shipped configs run — the
# mini-ImageNet stages 0-3 (84/42/21/10, cin 3 then 48, cout 48) at N 25, T
# 2 and 8; Omniglot's layers 1-4 (28/14/7/3, cin 1 then 64, cout 64) at N
# 20, T 8; the unpadded stages (84/41/19/8) — and edge shapes: cin 1, 2 and
# 3 (the packed kernel), 5, 17, 20, 65 and 100 (source chunks of 16 m_tiles
# channels), cout 1, 3, 4, 12, 20 and 33 (n8 tiles padded and masked), 65
# and 130 (output chunks), odd maps (Omniglot's 7 x 7 and 3 x 3, a 3 x 3
# input at pad 0: one output pixel), rows the bands do not divide, a split
# of one band, pad 0 and 1. dw and db are held to the twin with
# ``within_ulp``'s rule (the tensor cores' f32 sums run in another order
# than the twin's GEMM, and the splits are summed apart), and a second
# launch to the first bit for bit.
WGRAD_MMA_MAIN_SHAPES = (
    [(T, 25, hw, cin, 48, 1) for T in (2, 8)
     for hw, cin in ((84, 3), (42, 48), (21, 48), (10, 48))]
    + [(8, 20, hw, cin, 64, 1)
       for hw, cin in ((28, 1), (14, 64), (7, 64), (3, 64))]
    + [(T, 25, hw, cin, 48, 0) for T in (2, 8)
       for hw, cin in ((84, 3), (41, 48), (19, 48), (8, 48))]
)
WGRAD_MMA_EDGE_SHAPES = [
    # T, N, H, W, cin, cout, pad
    (1, 1, 5, 5, 1, 4, 1),
    (1, 1, 5, 5, 1, 4, 0),
    (1, 3, 9, 7, 3, 20, 1),
    (2, 3, 11, 9, 3, 20, 0),
    (1, 2, 9, 11, 2, 16, 1),
    (1, 2, 7, 7, 3, 65, 1),
    (1, 2, 13, 6, 17, 33, 1),
    (2, 5, 10, 10, 17, 33, 0),
    (2, 4, 6, 30, 5, 12, 1),
    (2, 3, 12, 12, 20, 3, 1),
    (1, 2, 10, 9, 20, 1, 0),
    (1, 2, 8, 8, 48, 65, 1),
    (1, 3, 9, 7, 65, 65, 0),
    (2, 3, 9, 9, 65, 20, 1),
    (1, 2, 8, 8, 100, 48, 1),
    (1, 2, 8, 8, 48, 130, 1),
    (3, 8, 23, 23, 48, 48, 1),
    (2, 20, 7, 7, 64, 64, 1),
    (2, 4, 3, 3, 64, 64, 0),
    (1, 3, 3, 3, 64, 64, 1),
]


def _check_wgrad_mma(T, N, H, W, cin, cout, pad, seed):
    """dw and db in bf16 on the mma plan against the twin within one bf16
    ulp (or 1e-4 of scale), one launch on the bf16 stride-1 counter, and a
    second launch bit for bit the first."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    Ho, Wo = F.conv_out_hw(H, W, 1, pad)
    x = torch.randn(T, N, H, W, cin, device="cuda", generator=g).bfloat16()
    dy = torch.randn(T, N, Ho, Wo, cout, device="cuda",
                     generator=g).bfloat16()
    plan = cb.wgrad_plan(T, N, H, W, cin, cout, 1, pad, cb._sms(x.device),
                         True)
    assert plan.kernel == "mma"
    cb.reset_launches()
    dw, db = cb.conv3x3_wgrad(x, dy, padding=pad)
    want_w, want_b = F.conv3x3_wgrad(x, dy, padding=pad)
    within_ulp(dw, want_w, "wgrad dw")
    within_ulp(db, want_b, "wgrad db")
    tag = "_p0" if pad == 0 else ""
    assert cb.launches() == {**{k: 0 for k in cb.KERNELS},
                             f"conv3x3{tag}_wgrad_bf16": 1}
    again = cb.conv3x3_wgrad(x, dy, padding=pad)
    assert torch.equal(again[0], dw) and torch.equal(again[1], db)
    torch.cuda.synchronize()
    return plan


@pytest.mark.parametrize("shape", WGRAD_MMA_MAIN_SHAPES, ids=str)
def test_wgrad_mma_matches_its_twin_at_main_path_shapes(shape, device):
    T, N, hw, cin, cout, pad = shape
    _check_wgrad_mma(T, N, hw, hw, cin, cout, pad, seed=hw + cin + N + T)
    torch.cuda.empty_cache()


@pytest.mark.parametrize("shape", WGRAD_MMA_EDGE_SHAPES, ids=str)
def test_wgrad_mma_matches_its_twin_at_edge_shapes(shape, device):
    plan = _check_wgrad_mma(*shape, seed=sum(shape))
    T, N, H, W, cin, cout, pad = shape
    if shape == (3, 8, 23, 23, 48, 48, 1):
        assert 23 % plan.band_rows and plan.splits > 1
    if cin > 64 or cout > 64:
        assert plan.grid[1] > 1  # source or output chunks


@pytest.mark.parametrize("pad", (1, 0))
def test_wgrad_mma_takes_tensors_off_16_byte_alignment(pad, device):
    """Views 2 bytes into their storage (contiguous, so the wrapper takes
    them): the kernel stages x and dy 8 bf16 at a time (the packed kernel's
    source rows an element at a time), with the aligned launch's bits."""
    for cin in (48, 3):
        T, N, H, W, cout = 2, 3, 12, 12, 48
        x = torch.randn(T, N, H, W, cin, device=device).bfloat16()
        dy = torch.randn(T, N, *F.conv_out_hw(H, W, 1, pad), cout,
                         device=device).bfloat16()

        def shifted(t):
            buf = torch.empty(t.numel() + 1, device=t.device, dtype=t.dtype)
            view = buf[1:].view(t.shape)
            view.copy_(t)
            assert view.data_ptr() % 16 != 0
            return view

        got = cb.conv3x3_wgrad(shifted(x), shifted(dy), padding=pad)
        want = cb.conv3x3_wgrad(x, dy, padding=pad)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        for a, c, what in zip(got, F.conv3x3_wgrad(x, dy, padding=pad),
                              ("dw", "db")):
            within_ulp(a, c, f"wgrad {what}")


def test_wgrad_mma_entry_refuses_a_plan_that_does_not_match(device):
    """The entry checks the plan's band rows, tiles, splits, threads and
    shared memory against the geometry they follow from (the arguments
    packed, as every wgrad entry takes them) and launches nothing
    otherwise."""
    from howtotrainyourmamlpytorch_tpu_torch.kernels import build

    T, N, H, W, cin, cout, pad = 2, 3, 21, 21, 48, 48, 1
    x = torch.randn(T, N, H, W, cin, device=device).bfloat16()
    dy = torch.randn(T, N, H, W, cout, device=device).bfloat16()
    plan = cb.wgrad_plan(T, N, H, W, cin, cout, 1, pad, cb._sms(device),
                         True)
    assert plan.kernel == "mma"
    part_w = torch.empty(plan.scratch[0], device=device)
    part_b = torch.empty(plan.scratch[1], device=device)
    dw = torch.full((T, 3, 3, cin, cout), 7.0, device=device).bfloat16()
    db = torch.full((T, cout), 7.0, device=device).bfloat16()
    fn = build.function("conv3x3_wgrad_s1_bf16", "conv3x3_wgrad_mma",
                        cb._ADDR_ENTRY)
    stream = torch.cuda.current_stream().cuda_stream
    head = tuple(t.data_ptr() for t in (x, dy, part_w, part_b, dw, db)) + (
        T, N, H, W, pad, cin, cout)
    # splits, band_rows, kernel_rows, groups, replicas, m_tiles, channels,
    # threads, smem
    good = [plan.splits, plan.band_rows, 0, 0, 0, plan.m_tiles,
            plan.channels, plan.threads, plan.smem]
    for i, bad in ((1, plan.band_rows + 1), (5, plan.m_tiles + 1),
                   (6, 40), (0, 0), (0, N * plan.bands + 1),
                   (7, plan.threads + 32), (8, plan.smem + 16),
                   (8, plan.smem - 16)):
        args = list(good)
        args[i] = bad
        packed = cb._packed(*head, *args, device.index, stream)
        assert fn(packed.buffer_info()[0]) != 0
    torch.cuda.synchronize()
    assert bool((dw == 7.0).all()) and bool((db == 7.0).all())
    packed = cb._packed(*head, *good, device.index, stream)
    assert fn(packed.buffer_info()[0]) == 0
    torch.cuda.synchronize()
    for a, c, what in zip((dw, db), F.conv3x3_wgrad(x, dy, padding=pad),
                          ("dw", "db")):
        within_ulp(a, c, f"wgrad {what}")


# K3 and K5 in f32, pooled: the cooperative kernels of
# csrc/bn_act_pool_bwd.cu. Every shape the shipped configs run —
# mini-ImageNet's conv outputs (84/42/21/10, 48 channels) at N 25, T 2 and
# 8, and at N 75 (the target set's backward in training) at T 2;
# Omniglot's (28/14/7/3, 64 channels) at N 20, T 8; the unpadded model's
# (82/39/17/6) at N 25, T 2 and 8; the large-batch config's T 256 (a
# block a tenant) at stage 1 — and edge shapes: T = 1, odd maps (the
# pool drops the last row and column, which still get a gradient), C not
# a multiple of 4 (a float at a time), one window a tenant, tensors off
# 16-byte alignment.
K35_MAIN_SHAPES = (
    [(T, 25, hw, 48) for T in (2, 8) for hw in (84, 42, 21, 10)]
    + [(2, 75, hw, 48) for hw in (84, 42, 21, 10)]
    + [(8, 20, hw, 64) for hw in (28, 14, 7, 3)]
    + [(T, 25, hw, 48) for T in (2, 8) for hw in (82, 39, 17, 6)]
    + [(256, 25, 42, 48)]
)
K35_EDGE_SHAPES = [
    # T, N, H, W, C
    (1, 1, 5, 5, 3),
    (1, 2, 9, 7, 20),
    (2, 3, 11, 9, 17),
    (3, 2, 21, 21, 48),
    (2, 5, 10, 10, 33),
    (1, 3, 3, 3, 64),
    (2, 4, 6, 30, 5),
    (2, 3, 2, 2, 64),
    (1, 1, 7, 7, 1),
]


def _k35_inputs(T, N, H, W, C, seed, device="cuda"):
    """K3's and K5's inputs: y, its statistics, gamma, beta, the twin K2's
    argmax, a pooled gradient, and K5's cotangents."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def r(*s, scale=1.0):
        return torch.randn(*s, device="cuda", generator=g) * scale

    y = 2.0 * r(T, N, H, W, C) + 0.3
    mean, _, rstd = F.bn_stats(y)
    gamma, beta = 1.0 + r(T, C, scale=0.1), r(T, C, scale=0.1)
    _, arg = F.bn_act_pool_fwd(y, mean, rstd, gamma, beta)
    k3 = (r(T, N, H // 2, W // 2, C), arg, y, mean, rstd, gamma, beta)
    return k3, (r(T, N, H, W, C), r(T, C), r(T, C)) + k3


def _check_k35(k3, k5):
    """K3 and K5 against their twins, one launch each on their counters,
    and a second launch of each bit for bit the first."""
    cb.reset_launches()
    got3 = cb.bn_act_pool_bwd(*k3)
    got5 = cb.bn_act_pool_bwd_bwd(*k5)
    assert cb.launches() == {**{k: 0 for k in cb.KERNELS},
                             "bn_act_pool_bwd": 1, "bn_act_pool_bwd_bwd": 1}
    for a, c in zip(got3 + got5,
                    F.bn_act_pool_bwd(*k3) + F.bn_act_pool_bwd_bwd(*k5)):
        assert a.is_contiguous() and torch.isfinite(a).all()
        _close(a, c)
    assert all(torch.equal(a, c) for a, c in zip(cb.bn_act_pool_bwd(*k3),
                                                 got3))
    assert all(torch.equal(a, c)
               for a, c in zip(cb.bn_act_pool_bwd_bwd(*k5), got5))
    torch.cuda.synchronize()


@pytest.mark.parametrize("shape", K35_MAIN_SHAPES, ids=str)
def test_k3_k5_kernels_match_their_twins_at_main_path_shapes(shape, device):
    T, N, hw, C = shape
    k3, k5 = _k35_inputs(T, N, hw, hw, C, seed=hw + C + N + T)
    plan = cb._bn_bwd_route("bn_act_pool_bwd", k3[2], True)
    assert plan.groups == -(-C // 4) and plan.grid[1] == T
    _check_k35(k3, k5)
    torch.cuda.empty_cache()


@pytest.mark.parametrize("shape", K35_EDGE_SHAPES, ids=str)
def test_k3_k5_kernels_match_their_twins_at_edge_shapes(shape, device):
    _check_k35(*_k35_inputs(*shape, seed=sum(shape)))


def test_k3_k5_kernels_take_tensors_off_16_byte_alignment(device):
    """Views 4 bytes into their storage (contiguous, so the wrappers take
    them): the kernels load and store a float at a time."""
    k3, k5 = _k35_inputs(2, 3, 11, 9, 20, seed=17)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, device=t.device, dtype=t.dtype)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view

    a, gg, gb, dp, arg, y, mean, rstd, gamma, beta = k5
    ys, dps, as_ = shifted(y), shifted(dp), shifted(a)
    assert ys.data_ptr() % 16 != 0
    assert not cb._bn_bwd_vec(20, [t.data_ptr() for t in (dps, arg, ys)
                                   + k3[3:]])
    for got, want in zip(
            cb.bn_act_pool_bwd(dps, arg, ys, mean, rstd, gamma, beta)
            + cb.bn_act_pool_bwd_bwd(as_, gg, gb, dps, arg, ys, mean, rstd,
                                     gamma, beta),
            F.bn_act_pool_bwd(*k3) + F.bn_act_pool_bwd_bwd(*k5)):
        _close(got, want)


def test_bf16_and_pool_free_k3_k5_run_cuda(device):
    """K3 and K5 pooled are CUDA in both dtypes: in bf16 each plans
    csrc/bn_act_pool_bwd.cu and is held to its twin, a second launch bit
    for bit the first. Their pool-free modes (``bn_act_bwd``,
    ``batch_norm_bwd``; ``bn_act_bwd_bwd``, ``batch_norm_bwd_bwd``) run
    csrc/bn_act_bwd.cu, each one launch on its counter, held to its twin;
    the Triton modules are gone."""
    _triton_modules_gone()
    k3, k5 = _k35_inputs(2, 3, 14, 14, 48, seed=19)
    y = k3[2].bfloat16()
    for name in ("bn_act_pool_bwd", "bn_act_pool_bwd_bwd"):
        plan = cb._bn_bwd_route(name, y, True)
        assert plan.groups == -(-48 // cb.BN_BWD_GROUP[name, True])
    _check_k3_bf16(k3)
    _check_k5_bf16(k5)
    assert not hasattr(cb, "_BN_BWD_TRITON")
    # the pool-free modes: K3 and K5 as bn_act_* and at slope 1 as
    # batch_norm_*
    _, k5 = _k35_inputs(2, 3, 14, 14, 48, seed=23)
    a, gg, gb, _, _, y, mean, rstd, gamma, beta = k5
    da = torch.randn_like(y)
    for s in (F.LEAKY_SLOPE, 1.0):
        cb.reset_launches()
        got = cb._launch_act_bwd("bn_act_bwd", da, y, mean, rstd, gamma,
                                 beta, s)
        assert cb.launches()["bn_act_bwd"] == 1
        for p, q in zip(got, F.bn_act_bwd(da, y, mean, rstd, gamma, beta,
                                          s)):
            _close(p, q)
        got = cb._launch_act_bwd_bwd("bn_act_bwd_bwd", a, gg, gb, da, y,
                                     mean, rstd, gamma, beta, s)
        assert cb.launches()["bn_act_bwd_bwd"] == 1
        for p, q in zip(got, F.bn_act_bwd_bwd(a, gg, gb, da, y, mean, rstd,
                                              gamma, beta, s)):
            _close(p, q)


# K3 pooled in bf16: the cooperative kernel of csrc/bn_act_pool_bwd.cu, 8
# channels a thread. Every shape the shipped bf16 configs give it — the
# mini-ImageNet conv outputs (84/42/21/10) at N 25, T 8 and 2; the
# unpadded model's (82/39/17/6); Omniglot's (28/14/7/3, 64 channels, the
# pool drops a row and a column at 7 and 3) at N 20; the large-batch T 256
# at stage 1 — and edge shapes (C not a whole number of 8-channel loads,
# odd maps, one window a tenant). dy, dgamma and dbeta ``within_ulp`` of
# the bf16 twin; one launch on ``bn_act_pool_bwd_bf16``; a second launch
# bit for bit the first.
K3_BF16_MAIN_SHAPES = (
    [(T, 25, hw, 48) for T in (8, 2) for hw in (84, 42, 21, 10)]
    + [(T, 25, hw, 48) for T in (8, 2) for hw in (82, 39, 17, 6)]
    + [(8, 20, hw, 64) for hw in (28, 14, 7, 3)]
    + [(256, 25, 42, 48)]
)
K3_BF16_EDGE_SHAPES = K35_EDGE_SHAPES + [(2, 3, 9, 7, 48), (1, 4, 5, 9, 12)]


def _check_k3_bf16(k3):
    k3 = tuple(t if t.dtype == torch.uint8 else t.bfloat16() for t in k3)
    dp, arg, y, mean, rstd, gamma, beta = k3
    # K2's argmax of the bf16 values (the pool's first maximum)
    arg = F.bn_act_pool_fwd(y, mean, rstd, gamma, beta)[1]
    k3 = (dp, arg, y, mean, rstd, gamma, beta)
    cb.reset_launches()
    got = cb.bn_act_pool_bwd(*k3)
    assert cb.launches() == {**{k: 0 for k in cb.KERNELS},
                             "bn_act_pool_bwd_bf16": 1}
    for a, c, what in zip(got, F.bn_act_pool_bwd(*k3),
                          ("dy", "dgamma", "dbeta")):
        assert a.dtype == torch.bfloat16
        within_ulp(a, c, f"K3 bf16 {what}")
    assert all(torch.equal(a, c) for a, c in zip(cb.bn_act_pool_bwd(*k3),
                                                 got))
    torch.cuda.synchronize()


@pytest.mark.parametrize("shape", K3_BF16_MAIN_SHAPES, ids=str)
def test_k3_bf16_matches_its_twin_at_main_path_shapes(shape, device):
    T, N, hw, C = shape
    k3, _ = _k35_inputs(T, N, hw, hw, C, seed=hw + C + N + T)
    plan = cb._bn_bwd_route("bn_act_pool_bwd", k3[2].bfloat16(), True)
    assert plan.groups == -(-C // 8) and plan.grid[1] == T
    _check_k3_bf16(k3)
    torch.cuda.empty_cache()


@pytest.mark.parametrize("shape", K3_BF16_EDGE_SHAPES, ids=str)
def test_k3_bf16_matches_its_twin_at_edge_shapes(shape, device):
    _check_k3_bf16(_k35_inputs(*shape, seed=sum(shape))[0])


def test_k3_bf16_takes_tensors_off_16_byte_alignment(device):
    """Views one element into their storage: the kernel loads and stores a
    value at a time, with the aligned launch's bits."""
    k3, _ = _k35_inputs(2, 3, 11, 9, 48, seed=17)
    dp, _, y, mean, rstd, gamma, beta = (
        t if t.dtype == torch.uint8 else t.bfloat16() for t in k3)
    arg = F.bn_act_pool_fwd(y, mean, rstd, gamma, beta)[1]

    def shifted(t):
        buf = torch.empty(t.numel() + 1, device=t.device, dtype=t.dtype)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        assert view.data_ptr() % 16 != 0
        return view

    ptrs = [t.data_ptr() for t in (shifted(dp), arg, shifted(y), mean,
                                   rstd, gamma, beta)]
    assert not cb._bn_bwd_vec(48, ptrs, True)
    got = cb.bn_act_pool_bwd(shifted(dp), shifted(arg), shifted(y), mean,
                             rstd, gamma, beta)
    want = cb.bn_act_pool_bwd(dp, arg, y, mean, rstd, gamma, beta)
    assert all(torch.equal(a, c) for a, c in zip(got, want))


def test_k3_bf16_entry_refuses_a_plan_that_does_not_match(device):
    """The bf16 entry checks the plan's blocks, chunk, slots and threads
    against the geometry (8 channels a group) and its vector loads against
    the pointers, and launches nothing otherwise."""
    from howtotrainyourmamlpytorch_tpu_torch.kernels import build

    k3, _ = _k35_inputs(2, 3, 14, 14, 48, seed=31)
    dp, _, y, mean, rstd, gamma, beta = (
        t if t.dtype == torch.uint8 else t.bfloat16() for t in k3)
    arg = F.bn_act_pool_fwd(y, mean, rstd, gamma, beta)[1]
    T, N, H, W, C = y.shape
    plan = cb._bn_bwd_route("bn_act_pool_bwd", y, True)
    dy = torch.full_like(y, 7.0)
    small = torch.empty(2 * T * C * (plan.grid[0] + 2), device=device)
    fn = build.function("bn_act_pool_bwd", "bn_act_pool_bwd_bf16",
                        cb._K3_ARGS)
    stream = torch.cuda.current_stream().cuda_stream
    out = small.view(torch.bfloat16)
    ptrs = [t.data_ptr() for t in (dp, arg, y, mean, rstd, gamma, beta, dy)]
    ptrs += [out.data_ptr(), out.data_ptr() + 2 * T * C,
             small.data_ptr() + 4 * T * C,
             small.data_ptr() + 4 * T * C * (plan.grid[0] + 1)]
    good = [plan.grid[0], plan.chunk, plan.slots, plan.threads, 1]
    for i, bad in ((0, plan.grid[0] + 1), (1, plan.chunk + 1),
                   (2, plan.slots // 2), (3, 128)):
        args = list(good)
        args[i] = bad
        assert fn(*ptrs, T, N, H, W, C, *args, 0.01, 1.0 / (N * H * W),
                  stream) != 0
    bad_ptrs = list(ptrs)
    bad_ptrs[2] += 2  # y off 16-byte alignment, vector loads asked
    assert fn(*bad_ptrs, T, N, H, W, C, *good, 0.01, 1.0 / (N * H * W),
              stream) != 0
    torch.cuda.synchronize()
    assert bool((dy == 7.0).all())


# K5 pooled in bf16: the f32 K5's cooperative kernel of
# csrc/bn_act_pool_bwd.cu on bf16 loads, 4 channels a thread, at the bf16
# K3's shapes (the Omniglot maps of 7 and 3 drop a row and a column) and
# edge shapes. g_dpooled, g_y and g_gamma ``within_ulp`` of the bf16 twin;
# one launch on ``bn_act_pool_bwd_bwd_bf16``; a second launch bit for bit
# the first.
def _check_k5_bf16(k5):
    k5 = tuple(t if t.dtype == torch.uint8 else t.bfloat16() for t in k5)
    a, gg, gb, dp, arg, y, mean, rstd, gamma, beta = k5
    # K2's argmax of the bf16 values (the pool's first maximum)
    arg = F.bn_act_pool_fwd(y, mean, rstd, gamma, beta)[1]
    k5 = (a, gg, gb, dp, arg, y, mean, rstd, gamma, beta)
    cb.reset_launches()
    got = cb.bn_act_pool_bwd_bwd(*k5)
    assert cb.launches() == {**{k: 0 for k in cb.KERNELS},
                             "bn_act_pool_bwd_bwd_bf16": 1}
    for o, c, what in zip(got, F.bn_act_pool_bwd_bwd(*k5),
                          ("g_dpooled", "g_y", "g_gamma")):
        assert o.dtype == torch.bfloat16 and o.is_contiguous()
        within_ulp(o, c, f"K5 bf16 {what}")
    assert all(torch.equal(o, c)
               for o, c in zip(cb.bn_act_pool_bwd_bwd(*k5), got))
    torch.cuda.synchronize()


@pytest.mark.parametrize("shape", K3_BF16_MAIN_SHAPES, ids=str)
def test_k5_bf16_matches_its_twin_at_main_path_shapes(shape, device):
    T, N, hw, C = shape
    _, k5 = _k35_inputs(T, N, hw, hw, C, seed=hw + C + N + T + 1)
    plan = cb._bn_bwd_route("bn_act_pool_bwd_bwd", k5[5].bfloat16(), True)
    assert plan.groups == -(-C // 4) and plan.grid[1] == T
    _check_k5_bf16(k5)
    torch.cuda.empty_cache()


@pytest.mark.parametrize("shape", K3_BF16_EDGE_SHAPES, ids=str)
def test_k5_bf16_matches_its_twin_at_edge_shapes(shape, device):
    _check_k5_bf16(_k35_inputs(*shape, seed=sum(shape) + 1)[1])


def test_k5_bf16_takes_tensors_off_8_byte_alignment(device):
    """Views one element into their storage: the kernel loads and stores a
    value at a time (vec = 0), with the aligned launch's bits."""
    _, k5 = _k35_inputs(2, 3, 11, 9, 48, seed=37)
    a, gg, gb, dp, _, y, mean, rstd, gamma, beta = (
        t if t.dtype == torch.uint8 else t.bfloat16() for t in k5)
    arg = F.bn_act_pool_fwd(y, mean, rstd, gamma, beta)[1]

    def shifted(t):
        buf = torch.empty(t.numel() + 1, device=t.device, dtype=t.dtype)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        assert view.data_ptr() % 4 != 0
        return view

    moved = (shifted(a), gg, gb, shifted(dp), shifted(arg), shifted(y),
             mean, rstd, gamma, beta)
    assert not cb._bn_bwd_vec(48, [t.data_ptr() for t in moved], True,
                              "bn_act_pool_bwd_bwd")
    assert cb._bn_bwd_vec(48, [t.data_ptr() for t in (
        a, gg, gb, dp, arg, y, mean, rstd, gamma, beta)], True,
        "bn_act_pool_bwd_bwd")
    got = cb.bn_act_pool_bwd_bwd(*moved)
    want = cb.bn_act_pool_bwd_bwd(a, gg, gb, dp, arg, y, mean, rstd, gamma,
                                  beta)
    assert all(torch.equal(o, c) for o, c in zip(got, want))


def test_k5_bf16_entry_refuses_a_plan_that_does_not_match(device):
    """The bf16 K5 entry checks the plan's blocks, chunk, slots and threads
    against the geometry (4 channels a group) and its vector loads against
    the pointers, and launches nothing otherwise."""
    from howtotrainyourmamlpytorch_tpu_torch.kernels import build

    _, k5 = _k35_inputs(2, 3, 14, 14, 48, seed=41)
    a, gg, gb, dp, _, y, mean, rstd, gamma, beta = (
        t if t.dtype == torch.uint8 else t.bfloat16() for t in k5)
    arg = F.bn_act_pool_fwd(y, mean, rstd, gamma, beta)[1]
    T, N, H, W, C = y.shape
    plan = cb._bn_bwd_route("bn_act_pool_bwd_bwd", y, True)
    g_dp, g_y = torch.full_like(dp, 7.0), torch.full_like(y, 7.0)
    g_gamma = torch.full_like(mean, 7.0)
    scratch = torch.empty(5 * T * C * (plan.grid[0] + 1), device=device)
    fn = build.function("bn_act_pool_bwd", "bn_act_pool_bwd_bwd_bf16",
                        cb._K5_ARGS)
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [t.data_ptr() for t in (a, gg, gb, dp, arg, y, mean, rstd, gamma,
                                   beta, g_dp, g_y, g_gamma)]
    ptrs += [scratch.data_ptr(),
             scratch.data_ptr() + 4 * 5 * T * C * plan.grid[0]]
    good = [plan.grid[0], plan.chunk, plan.slots, plan.threads, 1]
    for i, bad in ((0, plan.grid[0] + 1), (1, plan.chunk + 1),
                   (2, plan.slots // 2), (3, 128)):
        args = list(good)
        args[i] = bad
        assert fn(*ptrs, T, N, H, W, C, *args, 0.01, 1.0 / (N * H * W),
                  stream) != 0
    bad_ptrs = list(ptrs)
    bad_ptrs[5] += 2  # y off 8-byte alignment, vector loads asked
    assert fn(*bad_ptrs, T, N, H, W, C, *good, 0.01, 1.0 / (N * H * W),
              stream) != 0
    torch.cuda.synchronize()
    for t in (g_dp, g_y, g_gamma):
        assert bool((t == 7.0).all())


def test_k3_k5_refuse_a_shape_the_plan_cannot_fit(device):
    """More tenants than the card holds blocks at once (the cooperative
    launch needs them all resident), or more than 64 channels: the wrapper
    raises and launches nothing, in both dtypes."""
    resident = cb._sms(device) * max(
        cb._bn_bwd_blocks_per_sm(device, s, v, b) for s in (2, 5)
        for v in (False, True) for b in (False, True))
    for T, C in ((resident + 1, 4), (1, 65)):
        k3, k5 = _k35_inputs(T, 1, 2, 2, C, seed=29)
        for cast in (False, True):
            if cast:
                k3, k5 = ((t if t.dtype == torch.uint8 else t.bfloat16()
                           for t in k) for k in (k3, k5))
                k3, k5 = tuple(k3), tuple(k5)
            cb.reset_launches()
            with pytest.raises(ValueError, match="bn_bwd_plan"):
                cb.bn_act_pool_bwd(*k3)
            with pytest.raises(ValueError, match="bn_bwd_plan"):
                cb.bn_act_pool_bwd_bwd(*k5)
            assert set(cb.launches().values()) == {0}


# K2 in both modes and dtypes: csrc/bn_act_fwd.cu. Every shape the shipped
# configs give it — pooled: mini-ImageNet's conv outputs (84/42/21/10, 48
# channels) at N 25 and 75, T 8, and at T 2 (training's support), the
# large-batch config's T 256 at stage 1, Omniglot's (28/14/7/3, 64
# channels) at N 20, the unpadded model's (82/39/17/6); pool-free: the
# strided Omniglot model's conv outputs (14/7/4/2, 64 channels), the
# norm-first models' block inputs (the image at C 3, then 48 channels) and
# the strided norm-first image (C 1) — and edge shapes: T = 1, odd maps,
# C = 1, 3 and others not a multiple of 4, tenants whose element count is
# no multiple of a vector, a partial last vector. f32 within the twin gate
# (the argmax differing at no more than 1e-6 of the pooled elements, a
# near-tie that one FMA against the twin's two roundings can flip), bf16
# bit for bit.
K2_POOLED_MAIN = (
    [(8, n, hw, 48) for n in (25, 75) for hw in (84, 42, 21, 10)]
    + [(2, 25, hw, 48) for hw in (84, 42)]
    + [(8, 20, hw, 64) for hw in (28, 14, 7, 3)]
    + [(8, 25, hw, 48) for hw in (82, 39, 17, 6)]
    + [(256, 25, 42, 48)]
)
K2_FREE_MAIN = (
    [(8, 20, hw, 64) for hw in (14, 7, 4, 2)]
    + [(8, 75, 84, 3)] + [(8, 75, hw, 48) for hw in (42, 21, 10)]
    + [(8, 20, 28, 1)]
)
K2_EDGE = [
    # T, N, H, W, C
    (1, 1, 5, 5, 3),
    (1, 2, 9, 7, 20),
    (2, 3, 11, 9, 17),
    (2, 3, 7, 7, 1),
    (3, 1, 3, 5, 5),
    (2, 4, 6, 30, 8),
    (1, 3, 3, 3, 64),
]
K2_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _k2_inputs(T, N, H, W, C, dtype, seed):
    """y, its batch statistics, gamma and beta in ``dtype``."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def r(*s, scale=1.0):
        return torch.randn(*s, device="cuda", generator=g) * scale

    y = (2.0 * r(T, N, H, W, C) + 0.3).to(dtype)
    mean, _, rstd = F.bn_stats(y)
    return (y, mean, rstd, (1.0 + r(T, C, scale=0.1)).to(dtype),
            r(T, C, scale=0.1).to(dtype))


def _k2_calls(pool, slope):
    """K2's wrapper, twin and counter name in one mode: pooled, pool-free
    (``bn_act_fwd``) or, at slope 1, ``batch_norm_fwd``."""
    if pool:
        return (lambda *bn: cb.bn_act_pool_fwd(*bn, slope),
                lambda *bn: F.bn_act_pool_fwd(*bn, slope), "bn_act_pool_fwd")
    if slope == 1.0:
        return (lambda *bn: (cb.batch_norm_fwd(*bn),),
                lambda *bn: (F.batch_norm_fwd(*bn),), "batch_norm_fwd")
    return (lambda *bn: (cb.bn_act_fwd(*bn, slope),),
            lambda *bn: (F.bn_act_fwd(*bn, slope),), "bn_act_fwd")


def _check_k2(bn, pool, slope=F.LEAKY_SLOPE):
    """K2 against its twin, one launch on its counter, and a second launch
    bit for bit the first."""
    kernel, twin, name = _k2_calls(pool, slope)
    bf16 = bn[0].dtype == torch.bfloat16
    cb.reset_launches()
    got = kernel(*bn)
    assert {k: n for k, n in cb.launches().items() if n} == {
        name + ("_bf16" if bf16 else ""): 1}
    for a, c in zip(got, twin(*bn)):
        assert a.dtype == c.dtype and a.shape == c.shape
        assert a.is_contiguous()
        if bf16:
            assert torch.equal(a, c)
        elif a.dtype == torch.uint8:
            assert (a != c).float().mean().item() <= 1e-6
        else:
            assert torch.isfinite(a).all()
            _close(a, c)
    assert all(torch.equal(a, c) for a, c in zip(kernel(*bn), got))
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", list(K2_DTYPES))
@pytest.mark.parametrize("shape", K2_POOLED_MAIN, ids=str)
def test_k2_pooled_matches_its_twin_at_main_path_shapes(shape, dtype,
                                                        device):
    T, N, hw, C = shape
    _check_k2(_k2_inputs(T, N, hw, hw, C, K2_DTYPES[dtype], hw + N + T),
              pool=True)
    torch.cuda.empty_cache()


@pytest.mark.parametrize("slope", [F.LEAKY_SLOPE, 1.0])
@pytest.mark.parametrize("dtype", list(K2_DTYPES))
@pytest.mark.parametrize("shape", K2_FREE_MAIN, ids=str)
def test_k2_pool_free_matches_its_twin_at_main_path_shapes(shape, dtype,
                                                           slope, device):
    """At the leaky slope ``bn_act_fwd``, at slope 1 ``batch_norm_fwd``."""
    T, N, hw, C = shape
    _check_k2(_k2_inputs(T, N, hw, hw, C, K2_DTYPES[dtype], hw + C + T),
              pool=False, slope=slope)
    torch.cuda.empty_cache()


@pytest.mark.parametrize("pool", [True, False])
@pytest.mark.parametrize("dtype", list(K2_DTYPES))
@pytest.mark.parametrize("shape", K2_EDGE, ids=str)
def test_k2_matches_its_twin_at_edge_shapes(shape, dtype, pool, device):
    bn = _k2_inputs(*shape, K2_DTYPES[dtype], sum(shape))
    for slope in (F.LEAKY_SLOPE, 1.0):
        _check_k2(bn, pool, slope)


@pytest.mark.parametrize("dtype", list(K2_DTYPES))
def test_k2_takes_tensors_off_vector_alignment(dtype, device, monkeypatch):
    """Views one element into their storage (contiguous, so the wrappers
    take them): y off its vector alignment takes the scalar path of either
    mode (the plan asked without vectors); gamma alone off it takes one
    channel a thread pooled, and vectors of y with the tables an element
    at a time pool-free. Each equal to the twin as aligned inputs are."""
    asked = []
    plan = cb.bn_fwd_plan
    monkeypatch.setattr(cb, "bn_fwd_plan",
                        lambda *a: asked.append(a[-1]) or plan(*a))

    def shifted(t):
        buf = torch.empty(t.numel() + 1, device=t.device, dtype=t.dtype)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view

    y, mean, rstd, gamma, beta = _k2_inputs(2, 3, 10, 10, 48,
                                            K2_DTYPES[dtype], 31)
    ys, gs = shifted(y), shifted(gamma)
    assert ys.data_ptr() % 8 != 0 and gs.data_ptr() % 8 != 0
    for pool in (True, False):
        for bn, vec in (((ys, mean, rstd, gamma, beta), False),
                        ((y, mean, rstd, gs, beta), not pool),
                        ((y, mean, rstd, gamma, beta), True)):
            _check_k2(bn, pool)
            assert asked[-1] is vec


def test_k2_entries_refuse_a_plan_or_vectors_that_do_not_hold(device):
    """The entries check the plan's grid and threads against the shape and
    the vector mode against the pointers, and launch nothing otherwise."""
    import ctypes

    from howtotrainyourmamlpytorch_tpu_torch.kernels import build

    T, N, H, W, C = 2, 3, 10, 10, 48
    y, mean, rstd, gamma, beta = _k2_inputs(T, N, H, W, C, torch.float32, 37)
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    pooled = build.function("bn_act_fwd", "bn_act_pool_fwd",
                            (P,) * 7 + (I,) * 9 + (Fl, P))
    free = build.function("bn_act_fwd", "bn_act_fwd",
                          (P,) * 6 + (I,) * 9 + (Fl, P))
    out = torch.full((T, N, H // 2, W // 2, C), 7.0, device=device)
    arg = torch.zeros(out.shape, device=device, dtype=torch.uint8)
    dense = torch.full(y.shape, 7.0, device=device)
    off = torch.empty(dense.numel() + 1, device=device)[1:]
    ptrs = [t.data_ptr() for t in (y, mean, rstd, gamma, beta)]
    stream = torch.cuda.current_stream().cuda_stream
    pp = cb.bn_fwd_plan(T, N, H, W, C, True)
    fp = cb.bn_fwd_plan(T, N, H, W, C, False)
    for vec, blocks, threads in (
            (1, pp.grid[0] + 1, pp.threads), (1, pp.grid[0], 128),
            (0, pp.grid[0], pp.threads)):  # not the scalar plan's grid
        assert pooled(*ptrs, out.data_ptr(), arg.data_ptr(), T, N, H, W, C,
                      0, vec, blocks, threads, 0.01, stream) != 0
    for vec, blocks, o in ((1, fp.grid[0] - 1, dense), (0, fp.grid[0], dense),
                           (1, fp.grid[0], off)):
        assert free(*ptrs, o.data_ptr(), T, N, H, W, C, 0, vec, blocks,
                    fp.threads, 0.01, stream) != 0
    assert pooled(*ptrs, out.data_ptr(), arg.data_ptr(), T, N, H, W, 65, 0,
                  1, pp.grid[0], pp.threads, 0.01, stream) != 0
    torch.cuda.synchronize()
    assert bool((out == 7.0).all()) and bool((dense == 7.0).all())
    assert pooled(*ptrs, out.data_ptr(), arg.data_ptr(), T, N, H, W, C, 0, 1,
                  pp.grid[0], pp.threads, 0.01, stream) == 0
    _close(out, F.bn_act_pool_fwd(y, mean, rstd, gamma, beta)[0])


def test_k2_wrappers_reject_what_the_kernels_do_not_take(device):
    """f16 raises ``TypeError``, 65 channels ``NotImplementedError``, in
    every K2 wrapper, before any launch."""
    bn = _k2_inputs(1, 2, 6, 6, 4, torch.float16, 41)
    wide = _k2_inputs(1, 2, 6, 6, 65, torch.float32, 43)
    cb.reset_launches()
    for pool, slope in ((True, F.LEAKY_SLOPE), (False, F.LEAKY_SLOPE),
                        (False, 1.0)):
        kernel, _, name = _k2_calls(pool, slope)
        with pytest.raises(TypeError, match=f"^{name}: .*float32 or "
                                            "bfloat16"):
            kernel(*bn)
        with pytest.raises(NotImplementedError, match="at most 64"):
            kernel(*wide)
    assert set(cb.launches().values()) == {0}


def test_no_k2_name_reaches_a_triton_kernel(device):
    """The Triton modules are gone, and every K2 wrapper runs its CUDA
    kernel: pooled and pool-free, ``batch_norm_fwd``, f32 and bf16."""
    _triton_modules_gone()
    for dtype in K2_DTYPES.values():
        bn = _k2_inputs(2, 3, 8, 8, 48, dtype, 47)
        for pool, slope in ((True, F.LEAKY_SLOPE), (False, F.LEAKY_SLOPE),
                            (False, 1.0)):
            _check_k2(bn, pool, slope)


# -- layer_norm_stats and layer_norm_bwd on csrc/layer_norm.cu ----------------
#
# One launch a call, f32 and bf16: the statistics a warp or a cluster a row
# (``ln_stats_plan``), the backward one cooperative launch
# (``ln_bwd_plan``). Gates: f32 within 1e-5 + 1e-4 * scale of the twins,
# bf16 within one bf16 ulp (or 1e-4 of scale); a second launch bit for bit
# the first.

# (T, N, H = W, C): the mini-ImageNet layer-norm stages of both orders
# (statistics at 75 images, backward at 25), the unpadded conv outputs and
# the strided Omniglot maps with the 28 x 28 x 1 image (20 images), at T =
# 8; the conv-first stage 0 at the config's batch of 2
LN_MAIN = (
    [(8, n, hw, c) for n in (25, 75)
     for hw, c in ((84, 48), (84, 3), (42, 48), (21, 48), (10, 48))]
    + [(8, 25, hw, 48) for hw in (82, 39, 17, 6)]
    + [(8, 20, hw, 64) for hw in (14, 7, 4, 2)] + [(8, 20, 28, 1)]
    + [(2, 25, 84, 48), (2, 75, 84, 48)]
)
# odd M (no 16-byte loads: one value at a time, in either dtype or in bf16
# alone), a row of one value, rows under a warp's loads and just above,
# tenants of one image
LN_EDGE = [
    # T, N, H, W, C
    (1, 1, 1, 1, 1),
    (1, 1, 5, 5, 3),
    (2, 3, 11, 9, 20),
    (3, 2, 7, 7, 1),
    (2, 5, 16, 16, 4),
    (1, 7, 33, 32, 1),
    (5, 1, 9, 9, 64),
    (3, 4, 3, 3, 100),
]
LN_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _ln_inputs(T, N, H, W, C, dtype, seed):
    """x (with an offset: a sum-of-squares variance would cancel), its
    twin statistics, gamma and dz, in ``dtype``."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def r(*s, scale=1.0):
        return torch.randn(*s, device="cuda", generator=g) * scale

    x = (3.0 + r(T, N, H, W, C)).to(dtype)
    mean, _, rstd = F.layer_norm_stats(x)
    return (x, mean, rstd, (1.0 + r(T, H, W, C, scale=0.3)).to(dtype),
            r(T, N, H, W, C, scale=0.1).to(dtype))


def _ln_gate(got, want, what):
    for a, c, o in zip(got, want, what):
        assert a.dtype == c.dtype and a.shape == c.shape, o
        assert torch.isfinite(a).all(), o
        if a.dtype == torch.bfloat16:
            within_ulp(a, c, o)
        else:
            _close(a, c)


def _check_ln(x, mean, rstd, gamma, dz):
    """Both kernels against their twins, one launch each on its counter, a
    second launch bit for bit the first."""
    tag = "_bf16" if x.dtype == torch.bfloat16 else ""
    cb.reset_launches()
    stats = cb.layer_norm_stats(x)
    assert {k: n for k, n in cb.launches().items() if n} == {
        "layer_norm_stats" + tag: 1}
    _ln_gate(stats, F.layer_norm_stats(x), ("mean", "var", "rstd"))
    ln = (x, mean, rstd, gamma)
    cb.reset_launches()
    grads = cb.layer_norm_bwd(dz, *ln)
    assert {k: n for k, n in cb.launches().items() if n} == {
        "layer_norm_bwd" + tag: 1}
    _ln_gate(grads, F.layer_norm_bwd(dz, *ln), ("dx", "dgamma", "dbeta"))
    for again, first in ((cb.layer_norm_stats(x), stats),
                         (cb.layer_norm_bwd(dz, *ln), grads)):
        assert all(torch.equal(a, c) for a, c in zip(again, first))
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", list(LN_DTYPES))
@pytest.mark.parametrize("shape", LN_MAIN, ids=str)
def test_ln_kernels_match_their_twins_at_main_path_shapes(shape, dtype,
                                                          device):
    T, N, hw, C = shape
    _check_ln(*_ln_inputs(T, N, hw, hw, C, LN_DTYPES[dtype], hw + C + N))
    torch.cuda.empty_cache()


@pytest.mark.parametrize("dtype", list(LN_DTYPES))
@pytest.mark.parametrize("shape", LN_EDGE, ids=str)
def test_ln_kernels_match_their_twins_at_edge_shapes(shape, dtype, device):
    _check_ln(*_ln_inputs(*shape, LN_DTYPES[dtype], sum(shape)))


@pytest.mark.parametrize("dtype", list(LN_DTYPES))
def test_ln_kernels_take_tensors_off_16_byte_alignment(dtype, device,
                                                       monkeypatch):
    """Contiguous views one element into their storage, which the wrappers
    take: x off alignment makes the statistics and the backward load one
    value at a time (the plans asked without vectors), dz alone the
    backward; each equal to the twins as aligned inputs are."""
    asked = []
    plans = {k: getattr(cb, k) for k in ("ln_stats_plan", "ln_bwd_plan")}
    for k, plan in plans.items():
        monkeypatch.setattr(cb, k, lambda *a, _p=plan, _k=k:
                            asked.append((_k, a[4] if _k == "ln_bwd_plan"
                                          else a[3])) or _p(*a))

    def shifted(t):
        buf = torch.empty(t.numel() + 1, device=t.device, dtype=t.dtype)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view

    x, mean, rstd, gamma, dz = _ln_inputs(2, 3, 10, 10, 48, LN_DTYPES[dtype],
                                          53)
    xs, dzs = shifted(x), shifted(dz)
    assert xs.data_ptr() % 16 != 0 and dzs.data_ptr() % 16 != 0
    for args, vec in (((xs, mean, rstd, gamma, dz), False),
                      ((x, mean, rstd, gamma, dzs), None),
                      ((x, mean, rstd, gamma, dz), True)):
        asked.clear()
        _check_ln(*args)
        want = {"ln_stats_plan": vec if vec is not None else True,
                "ln_bwd_plan": bool(vec)}
        assert {k: v for k, v in asked} == want, asked


def test_ln_wrappers_reject_what_the_kernels_do_not_take(device):
    """f16 raises ``TypeError``, a non-contiguous x or dz ``ValueError``,
    before any launch."""
    x, mean, rstd, gamma, dz = _ln_inputs(2, 3, 6, 6, 8, torch.float32, 59)
    h = x.half()
    cb.reset_launches()
    with pytest.raises(TypeError, match="^layer_norm_stats: .*float32 or "
                                        "bfloat16"):
        cb.layer_norm_stats(h)
    with pytest.raises(TypeError, match="^layer_norm_bwd: .*float32 or "
                                        "bfloat16"):
        cb.layer_norm_bwd(dz.half(), h, mean.half(), rstd.half(),
                          gamma.half())
    with pytest.raises(ValueError, match="contiguous"):
        cb.layer_norm_stats(x.transpose(2, 3))
    with pytest.raises(ValueError, match="contiguous"):
        cb.layer_norm_bwd(dz.transpose(2, 3), x, mean, rstd, gamma)
    assert set(cb.launches().values()) == {0}


def test_ln_entries_refuse_a_plan_that_does_not_match(device):
    """The entries check the plan against the shape and the vectors against
    M and the pointers, and launch nothing otherwise."""
    from howtotrainyourmamlpytorch_tpu_torch.kernels import build

    T, N, H, W, C = 2, 3, 10, 10, 48
    R, M = T * N, H * W * C
    x, mean, rstd, gamma, dz = _ln_inputs(T, N, H, W, C, torch.float32, 61)
    stats = build.function("layer_norm", "layer_norm_stats", cb._PACKED_EPS_ENTRY)
    bwd = build.function("layer_norm", "layer_norm_bwd", cb._PACKED_EPS_ENTRY)
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.full((3, T, N), 7.0, device=device)
    o = [out[k].data_ptr() for k in range(3)]
    sp = cb.ln_stats_plan(R, M, False, True, 4)
    assert sp.route == "cluster" and sp.cluster > 1
    off = torch.empty(x.numel() + 1, device=device)[1:]

    def stats_args(xp, warp, cluster, chunk, grid):
        return cb._LN_STATS_ARGS(xp, *o, R, M, 0, 1, warp, cluster, chunk,
                                 grid, 0, stream)

    for xp, warp, cluster, chunk, grid in (
            (x, 0, sp.cluster, sp.chunk, sp.grid + 1),
            (x, 0, 3, sp.chunk, R * 3),                   # not a power of 2
            (x, 0, sp.cluster, sp.chunk // 2, sp.grid),   # M uncovered
            (x, 1, 1, M, -(-R // 8)),                     # too long a row
            (off, 0, sp.cluster, sp.chunk, sp.grid)):     # x off vectors
        assert stats(stats_args(xp.data_ptr(), warp, cluster, chunk, grid),
                     1e-5) != 0
    bp = cb.ln_bwd_plan(T, N, M, False, True, 132, 2)
    assert bp.grid == T * bp.tiles
    dx = torch.full(x.shape, 7.0, device=device)
    dgb = torch.full((2, T, H, W, C), 7.0, device=device)
    jw = bp.tiles * (bp.tpr // 32)
    scratch = torch.empty(2 * R * (jw + 1), device=device)
    ptrs = [t.data_ptr() for t in (dz, x, mean, rstd, gamma, dx, dgb[0],
                                   dgb[1])]
    part = scratch.data_ptr()
    for tpr, J, blocks, m in (
            (bp.tpr, bp.tiles + 1, bp.grid, M),
            (48, bp.tiles, bp.grid, M),
            (bp.tpr, bp.tiles, T * bp.tiles + 1, M),  # more blocks than items
            (bp.tpr, bp.tiles, 0, M),
            (bp.tpr, bp.tiles, bp.grid, M - 2)):      # M off the vectors
        assert bwd(cb._LN_BWD_ARGS(*ptrs, part, part + 8 * R * jw, T, N, m,
                                   0, 1, tpr, J, blocks, 0, stream),
                   1.0 / M) != 0
    torch.cuda.synchronize()
    assert bool((out == 7.0).all()) and bool((dx == 7.0).all())
    assert bool((dgb == 7.0).all())
    assert stats(stats_args(x.data_ptr(), 0, sp.cluster, sp.chunk, sp.grid),
                 1e-5) == 0
    _ln_gate(out.unbind(0), F.layer_norm_stats(x), ("mean", "var", "rstd"))


def test_no_ln_stats_or_bwd_call_reaches_a_triton_kernel(device):
    """The layer norm's Triton module (kernels/layer_norm.py) is gone with
    every Triton module of the port, and the statistics', the backward's
    and the double backward's wrappers run their CUDA kernels, in f32 and
    bf16."""
    _triton_modules_gone()
    for dtype in LN_DTYPES.values():
        ln = _ln_inputs(2, 3, 8, 8, 48, dtype, 67)
        _check_ln(*ln)
        _check_ln_bwd_bwd(*ln, seed=71)


# layer_norm_bwd_bwd on csrc/layer_norm.cu: one cooperative launch a call,
# f32 and bf16, at the layer-norm main-path shapes of the support images
# (25, and 20 at Omniglot; the odd maps of 21, 7 and 39 included) and at
# the edge shapes (odd M: one value a load). Gates: f32 within 1e-5 *
# min(1, scale) + 1e-4 * scale of the twin (an absolute floor that never
# covers a small output), bf16 ``within_ulp``; one launch on its counter;
# a second launch bit for bit the first.
LN_BB_MAIN = [s for s in LN_MAIN if s[1] != 75]


def _ln_bb_gate(got, want, what):
    for o, c, w in zip(got, want, what):
        assert o.dtype == c.dtype and o.shape == c.shape, w
        assert o.is_contiguous() and torch.isfinite(o).all(), w
        if o.dtype == torch.bfloat16:
            within_ulp(o, c, w)
        else:
            err = (o.double() - c.double()).abs().max().item()
            scale = c.double().abs().max().item()
            assert err <= 1e-5 * min(1.0, scale) + 1e-4 * scale, (w, err,
                                                                  scale)


def _check_ln_bwd_bwd(x, mean, rstd, gamma, dz, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    T, _, H, W, C = x.shape

    def r(*s):
        return torch.randn(*s, device="cuda", generator=g).to(x.dtype)

    args = (r(*x.shape), r(T, H, W, C), r(T, H, W, C), dz, x, mean, rstd,
            gamma)
    tag = "_bf16" if x.dtype == torch.bfloat16 else ""
    cb.reset_launches()
    got = cb.layer_norm_bwd_bwd(*args)
    assert {k: n for k, n in cb.launches().items() if n} == {
        "layer_norm_bwd_bwd" + tag: 1}
    _ln_bb_gate(got, F.layer_norm_bwd_bwd(*args), ("g_dz", "g_x", "g_gamma"))
    assert all(torch.equal(o, c)
               for o, c in zip(cb.layer_norm_bwd_bwd(*args), got))
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", list(LN_DTYPES))
@pytest.mark.parametrize("shape", LN_BB_MAIN, ids=str)
def test_ln_bwd_bwd_matches_its_twin_at_main_path_shapes(shape, dtype,
                                                         device):
    T, N, hw, C = shape
    _check_ln_bwd_bwd(*_ln_inputs(T, N, hw, hw, C, LN_DTYPES[dtype],
                                  hw + C + N + 1), seed=hw + C)
    torch.cuda.empty_cache()


@pytest.mark.parametrize("dtype", list(LN_DTYPES))
@pytest.mark.parametrize("shape", LN_EDGE, ids=str)
def test_ln_bwd_bwd_matches_its_twin_at_edge_shapes(shape, dtype, device):
    _check_ln_bwd_bwd(*_ln_inputs(*shape, LN_DTYPES[dtype], sum(shape) + 1),
                      seed=sum(shape))


@pytest.mark.parametrize("dtype", list(LN_DTYPES))
def test_ln_bwd_bwd_takes_tensors_off_16_byte_alignment(dtype, device,
                                                        monkeypatch):
    """Contiguous views one element into their storage: a, dz or x off
    alignment makes the double backward load one value at a time (its plan
    asked without vectors), held to the twin as aligned inputs are."""
    asked = []
    plan = cb.ln_bwd_plan
    monkeypatch.setattr(cb, "ln_bwd_plan",
                        lambda *a: asked.append(a[4]) or plan(*a))

    def shifted(t):
        buf = torch.empty(t.numel() + 1, device=t.device, dtype=t.dtype)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        assert view.data_ptr() % 16 != 0
        return view

    x, mean, rstd, gamma, dz = _ln_inputs(2, 3, 10, 10, 48, LN_DTYPES[dtype],
                                          73)
    for args, vec in (((x, mean, rstd, gamma, shifted(dz)), False),
                      ((shifted(x), mean, rstd, gamma, dz), False),
                      ((x, mean, rstd, gamma, dz), True)):
        asked.clear()
        _check_ln_bwd_bwd(*args, seed=79)
        assert asked == [vec, vec], asked


def test_ln_bwd_bwd_entry_refuses_a_plan_that_does_not_match(device):
    """The double backward's entry checks the plan against the shape and
    the vectors against M and the pointers, and launches nothing
    otherwise."""
    from howtotrainyourmamlpytorch_tpu_torch.kernels import build

    T, N, H, W, C = 2, 3, 10, 10, 48
    R, M = T * N, H * W * C
    x, mean, rstd, gamma, dz = _ln_inputs(T, N, H, W, C, torch.float32, 83)
    a = torch.randn_like(x)
    gg, gb = torch.randn_like(gamma), torch.randn_like(gamma)
    fn = build.function("layer_norm", "layer_norm_bwd_bwd", cb._ADDR_F_ENTRY)
    stream = torch.cuda.current_stream().cuda_stream
    bp = cb.ln_bwd_plan(T, N, M, False, True, 132, 2)
    outs = torch.full((2, *x.shape), 7.0, device=device)
    g_gamma = torch.full_like(gamma, 7.0)
    scratch = torch.empty(cb.ln_bwd_scratch(bp, R, cb.LN_BWD_BWD_SUMS),
                          device=device)
    tot = scratch.data_ptr()
    part = tot + 4 * cb.LN_BWD_BWD_COEFS * R
    off = torch.empty(x.numel() + 1, device=device)[1:]
    ins = [t.data_ptr() for t in (a, gg, gb, dz, x, mean, rstd, gamma)]
    for case in (
            (ins[4], bp.tpr, bp.tiles + 1, bp.grid, M),
            (ins[4], 48, bp.tiles, bp.grid, M),
            (ins[4], bp.tpr, bp.tiles, T * bp.tiles + 1, M),
            (ins[4], bp.tpr, bp.tiles, 0, M),
            (ins[4], bp.tpr, bp.tiles, bp.grid, M - 2),  # M off the vectors
            (off.data_ptr(), bp.tpr, bp.tiles, bp.grid, M),  # x off them
            (ins[4], bp.tpr, bp.tiles, bp.grid, M, 4)):  # tot off 16 bytes
        xp, tpr, J, blocks, m, *shift = case
        args = cb._packed(*ins[:4], xp, *ins[5:], outs[0].data_ptr(),
                          outs[1].data_ptr(), g_gamma.data_ptr(), part,
                          tot + sum(shift), T, N, m, 0, 1, tpr, J, blocks,
                          0, stream)
        assert fn(args.buffer_info()[0], 1.0 / M) != 0
    torch.cuda.synchronize()
    assert bool((outs == 7.0).all()) and bool((g_gamma == 7.0).all())


# -- bn_input_stats and the global average pool on CUDA ------------------------
#
# One launch a call, f32 and bf16: the statistics a block a tenant or one
# cooperative launch (``bn_stats_plan``), the GAP's forward and backward a
# plain launch each. Gates: f32 within 1e-5 + 1e-4 * scale of the twins,
# the bf16 statistics within one bf16 ulp (or 1e-4 of scale), the bf16 GAP
# bit for bit (one rounding of an f32 sum that is exact at these maps, or
# of one division); a second launch bit for bit the first.

# (T, N, H = W, C): every block input the norm-first models normalize — the
# mini-ImageNet stages (the image, then 48 channels) at N = 75 and 25, the
# unpadded models' stage inputs (pooled 41/19/8, strided 20/9), the strided
# Omniglot model's (the 28 x 28 x 1 image, then 14/7/4 x 64) at N = 20 — at
# T = 8, and the image at the config's batch of 2
STATS_MAIN = (
    [(8, n, hw, c) for n in (25, 75)
     for hw, c in ((84, 3), (42, 48), (21, 48), (10, 48))]
    + [(8, 75, hw, 48) for hw in (41, 19, 8, 20, 9)]
    + [(8, 20, 28, 1)] + [(8, 20, hw, 64) for hw in (14, 7, 4)]
    + [(2, 25, 84, 3), (2, 75, 84, 3)]
)
# (T, N, H, W, C): tenants that are not a whole number of loads (C = 1 and
# 3 in the scalar mode), the scalar mode's channel counts (5, 17, 100 in
# bf16), lanes of 100 and 256 channels, a tenant of one value, the block
# route and the grid route at a small map
STATS_EDGE = [
    (1, 1, 1, 1, 1),
    (1, 1, 1, 1, 3),
    (2, 3, 5, 7, 3),
    (3, 1, 3, 3, 1),
    (2, 5, 9, 9, 1),
    (2, 4, 7, 6, 17),
    (1, 2, 5, 5, 5),
    (2, 3, 4, 4, 100),
    (1, 2, 3, 3, 256),
    (4, 25, 30, 30, 3),
    (16, 2, 6, 6, 64),
]
# (T, N, H = W, C): the strided models' last maps — Omniglot 2 x 2 x 64 at
# N = 20, the unpadded mini-ImageNet 4 x 4 x 48 at N = 75 and 25 — and
# edge maps (odd, C off the loads' values)
GAP_SHAPES = [(8, 20, 2, 64), (8, 75, 4, 48), (8, 25, 4, 48),
              (2, 20, 2, 64), (1, 1, 1, 1), (2, 3, 5, 3), (3, 2, 14, 20),
              (2, 4, 7, 64)]
STATS_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _stats_input(T, N, H, W, C, dtype, seed):
    """Pixels in [0, 1] at C <= 3 (mean ~0.5: a sum-of-squares variance
    would cancel), else activations with an offset, in ``dtype``."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    if C <= 3:
        x = torch.rand(T, N, H, W, C, device="cuda", generator=g)
    else:
        x = 2.0 + torch.randn(T, N, H, W, C, device="cuda", generator=g)
    return x.to(dtype)


def _stats_gate(got, want, what):
    for a, c, o in zip(got, want, what):
        assert a.dtype == c.dtype and a.shape == c.shape, o
        assert torch.isfinite(a).all(), o
        if a.dtype == torch.bfloat16:
            within_ulp(a, c, o)
        else:
            _close(a, c)


def _check_stats(x):
    """``bn_input_stats`` against its twin, one launch on its counter, a
    second launch bit for bit the first."""
    tag = "_bf16" if x.dtype == torch.bfloat16 else ""
    cb.reset_launches()
    got = cb.bn_input_stats(x)
    assert {k: n for k, n in cb.launches().items() if n} == {
        "bn_input_stats" + tag: 1}
    _stats_gate(got, F.bn_input_stats(x), ("mean", "var", "rstd"))
    assert all(torch.equal(a, c) for a, c in zip(cb.bn_input_stats(x), got))
    torch.cuda.synchronize()


def _check_gap(T, N, H, W, C, dtype, seed):
    """Both GAP kernels against their twins (bf16 bit for bit), one launch
    each on its counter, a second launch bit for bit the first."""
    tag = "_bf16" if dtype == torch.bfloat16 else ""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(T, N, H, W, C, device="cuda", generator=gen).to(dtype)
    g = torch.randn(T, N, C, device="cuda", generator=gen).to(dtype)
    cb.reset_launches()
    out = cb.global_avg_pool2d_fwd(x)
    dx = cb.global_avg_pool2d_bwd(g, H, W)
    assert {k: n for k, n in cb.launches().items() if n} == {
        "global_avg_pool2d_fwd" + tag: 1, "global_avg_pool2d_bwd" + tag: 1}
    for got, want in ((out, F.global_avg_pool2d(x)),
                      (dx, F.global_avg_pool2d_bwd(g, H, W))):
        assert got.dtype == want.dtype and got.shape == want.shape
        if dtype == torch.bfloat16:
            assert torch.equal(got, want)
        else:
            _close(got, want)
    assert torch.equal(cb.global_avg_pool2d_fwd(x), out)
    assert torch.equal(cb.global_avg_pool2d_bwd(g, H, W), dx)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", list(STATS_DTYPES))
@pytest.mark.parametrize("shape", STATS_MAIN, ids=str)
def test_bn_input_stats_matches_its_twin_at_main_path_shapes(shape, dtype,
                                                             device):
    T, N, hw, C = shape
    _check_stats(_stats_input(T, N, hw, hw, C, STATS_DTYPES[dtype],
                              hw + C + N))
    torch.cuda.empty_cache()


@pytest.mark.parametrize("dtype", list(STATS_DTYPES))
@pytest.mark.parametrize("shape", STATS_EDGE, ids=str)
def test_bn_input_stats_matches_its_twin_at_edge_shapes(shape, dtype,
                                                        device):
    _check_stats(_stats_input(*shape, STATS_DTYPES[dtype], sum(shape)))


def test_bn_input_stats_plans_take_every_mode_and_route(device):
    """The plans of the main-path and edge shapes on this card reach every
    mode and both routes."""
    seen = set()
    for T, N, H, W, C in ([(T, N, hw, hw, C) for T, N, hw, C in STATS_MAIN]
                          + STATS_EDGE):
        for bf16 in (False, True):
            p = cb._bn_stats_route(torch.device("cuda:0"), T, N * H * W, C,
                                   bf16, True)
            seen.add((p.mode, p.route))
    assert {m for m, _ in seen} == set(cb.BN_STATS_MODES)
    assert {r for _, r in seen} == {"block", "grid"}


@pytest.mark.parametrize("dtype", list(STATS_DTYPES))
def test_bn_input_stats_takes_a_tensor_off_16_byte_alignment(dtype, device,
                                                             monkeypatch):
    """A contiguous view one element into its storage, which the wrapper
    takes: the plan is asked without vectors (the scalar mode), and the
    statistics equal the twin's as an aligned input's do."""
    asked = []
    plan = cb.bn_stats_plan
    monkeypatch.setattr(cb, "bn_stats_plan",
                        lambda *a: asked.append(a[4]) or plan(*a))
    cb._bn_stats_route.cache_clear()
    for C in (3, 48):
        x = _stats_input(2, 3, 10, 10, C, STATS_DTYPES[dtype], C)
        buf = torch.empty(x.numel() + 1, device=x.device, dtype=x.dtype)
        shifted = buf[1:].view(x.shape)
        shifted.copy_(x)
        assert shifted.data_ptr() % 16 != 0
        asked.clear()
        _check_stats(shifted)
        assert asked == [False]
        asked.clear()
        _check_stats(x)
        assert asked == [True]
    cb._bn_stats_route.cache_clear()


@pytest.mark.parametrize("dtype", list(STATS_DTYPES))
@pytest.mark.parametrize("shape", GAP_SHAPES, ids=str)
def test_gap_matches_its_twin(shape, dtype, device):
    T, N, hw, C = shape
    _check_gap(T, N, hw, hw, C, STATS_DTYPES[dtype], sum(shape))


@pytest.mark.parametrize("dtype", list(STATS_DTYPES))
def test_gap_takes_a_tensor_off_16_byte_alignment(dtype, device):
    """The forward on a contiguous view one element into its storage (one
    value a thread) equals the aligned input's output bit for bit."""
    gen = torch.Generator(device="cuda").manual_seed(71)
    x = torch.randn(2, 5, 4, 4, 64, device="cuda", generator=gen).to(
        STATS_DTYPES[dtype])
    buf = torch.empty(x.numel() + 1, device=x.device, dtype=x.dtype)
    shifted = buf[1:].view(x.shape)
    shifted.copy_(x)
    assert torch.equal(cb.global_avg_pool2d_fwd(shifted),
                       cb.global_avg_pool2d_fwd(x))


def test_stats_and_gap_wrappers_reject_what_the_kernels_do_not_take(device):
    """f16 raises ``TypeError``, a non-contiguous tensor ``ValueError``, and
    257 channels ``ValueError``, before any launch."""
    x = _stats_input(2, 3, 4, 4, 8, torch.float32, 73)
    cb.reset_launches()
    for fn in (cb.bn_input_stats, cb.global_avg_pool2d_fwd):
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            fn(x.half())
        with pytest.raises(ValueError, match="contiguous"):
            fn(x.transpose(2, 3))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        cb.global_avg_pool2d_bwd(x[:, :, 0, 0].half(), 4, 4)
    with pytest.raises(ValueError, match="contiguous"):
        cb.global_avg_pool2d_bwd(x[:, :, 0, 0].transpose(1, 2), 4, 4)
    with pytest.raises(ValueError, match="no statistics"):
        cb.bn_input_stats(torch.zeros(1, 1, 1, 1, 257, device=device))
    assert set(cb.launches().values()) == {0}


def test_stats_and_gap_entries_refuse_what_does_not_match(device):
    """The entries check the plan against the shape and the mode that C
    and the vectors give, and the vectors against the pointers, and launch
    nothing otherwise."""
    from howtotrainyourmamlpytorch_tpu_torch.kernels import build

    T, N, H, W, C = 2, 3, 10, 10, 48
    P = N * H * W
    x = _stats_input(T, N, H, W, C, torch.float32, 79)
    entry = build.function("bn_input_stats", "bn_input_stats",
                           cb._PACKED_EPS_ENTRY)
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.full((3, T, C), 7.0, device=device)
    o = [out[k].data_ptr() for k in range(3)]
    p = cb.bn_stats_plan(T, P, C, False, True, 132, 1)
    scratch = torch.empty(p.grid * 3 * C, device=device)
    off = torch.empty(x.numel() + 1, device=device)[1:]
    assert p.mode == "lanes"

    def call(xp, vec, threads, chunk, splits, grid):
        return entry(cb._BN_STATS_ARGS(
            xp, *o, scratch.data_ptr(), T, C, P * C, 0, vec, threads,
            chunk, splits, grid, 0, stream), 1e-5)

    good = (x.data_ptr(), 1, p.threads, p.chunk, p.splits, p.grid)
    for bad in ((off.data_ptr(),) + good[1:],          # x off vectors
                good[:1] + (0,) + good[2:],            # the scalar mode's
                good[:2] + (256,) + good[3:],          # not a slot multiple
                good[:3] + (p.chunk + 1,) + good[4:],  # chunk off the slots
                good[:3] + (p.chunk // 2,) + good[4:],  # units uncovered
                good[:5] + (p.grid + 1,)):             # grid != T x splits
        assert call(*bad) != 0
    gap = build.function("global_avg_pool", "global_avg_pool_fwd",
                         cb._PACKED_ENTRY)
    pooled = torch.full((T, N, C), 7.0, device=device)
    for xp, c, vec in ((off.data_ptr(), C, 1), (x.data_ptr(), 6, 1),
                       (x.data_ptr(), 0, 0)):
        assert gap(cb._GAP_ARGS(xp, pooled.data_ptr(), T * N, H * W, c, 0,
                                vec, 0, stream)) != 0
    torch.cuda.synchronize()
    assert bool((out == 7.0).all()) and bool((pooled == 7.0).all())
    assert call(*good) == 0
    _stats_gate(out.unbind(0), F.bn_input_stats(x), ("mean", "var", "rstd"))


def test_no_stats_or_gap_call_reaches_a_triton_kernel(device):
    """The Triton statistics and GAP modules are gone with every Triton
    module of the port, and ``bn_input_stats`` and both GAP wrappers run
    their CUDA kernels, in f32 and bf16."""
    _triton_modules_gone()
    for dtype in STATS_DTYPES.values():
        _check_stats(_stats_input(2, 3, 8, 8, 3, dtype, 83))
        _check_stats(_stats_input(2, 3, 8, 8, 48, dtype, 89))
        _check_gap(2, 3, 4, 4, 48, dtype, 97)


# -- K3 pool-free (bn_act_bwd, batch_norm_bwd) and act_bwd on CUDA -------------
#
# One launch a call, f32 and bf16: K3 pool-free on csrc/bn_act_bwd.cu (a
# block a tenant or one cooperative launch, ``bn_act_bwd_plan``), at slope
# 0.01 (``bn_act_bwd``) and 1 (``batch_norm_bwd``); ``act_bwd`` on
# csrc/act.cu. Gates: K3 f32 within 1e-5 + 1e-4 * scale of its twin, bf16
# within one bf16 ulp (or 1e-4 of scale); ``act_bwd`` bit for bit; a
# second launch bit for bit the first.

# (T, N, H = W, C): the strided Omniglot conv outputs (N = 20), the
# unpadded strided mini-ImageNet ones (N = 25), and the norm-first block
# inputs — the image at N = 25 and 75, pooled 42/21/10, unpadded 41/19/8,
# unpadded strided 20/9 (N = 25), the strided model's 28 x 28 x 1 image
# (N = 20) — at T = 8, and the large maps at T = 2
K3_FREE_MAIN = (
    [(8, 20, hw, 64) for hw in (14, 7, 4, 2)]
    + [(8, 25, hw, 48) for hw in (41, 20, 9, 4)]
    + [(8, n, 84, 3) for n in (25, 75)]
    + [(8, 25, hw, 48) for hw in (42, 21, 10, 19, 8)]
    + [(8, 20, 28, 1)]
    + [(2, 20, 14, 64), (2, 25, 41, 48), (2, 25, 84, 3), (2, 75, 84, 3),
       (2, 25, 42, 48)]
)
# (T, N, H, W, C): tenants that are not a whole number of loads (C = 1 and
# 3 in the scalar mode), the scalar mode's channel counts (5, 17, 100),
# lanes of 256 channels, a tenant of one value, a grid route of small maps
K3_FREE_EDGE = [
    (1, 1, 1, 1, 1),
    (1, 1, 1, 1, 3),
    (2, 3, 5, 7, 3),
    (3, 1, 3, 3, 1),
    (2, 5, 9, 9, 1),
    (2, 4, 7, 6, 17),
    (1, 2, 5, 5, 5),
    (2, 3, 4, 4, 100),
    (1, 2, 3, 3, 256),
    (4, 25, 30, 30, 3),
    (16, 2, 6, 6, 64),
]
K3_FREE_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
K3_FREE_SLOPES = {"leaky": F.LEAKY_SLOPE, "slope1": 1.0}


def _k3_free_inputs(T, N, H, W, C, dtype, seed):
    """da, x and its statistics, gamma, beta, in ``dtype``: pixels in [0,
    1] at C <= 3, else activations with an offset."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def r(*s):
        return torch.randn(*s, device="cuda", generator=g)

    x = (torch.rand(T, N, H, W, C, device="cuda", generator=g) if C <= 3
         else 0.5 + 2.0 * r(T, N, H, W, C)).to(dtype)
    mean, _, rstd = F.bn_input_stats(x)
    gamma = (1.0 + 0.1 * r(T, C)).to(dtype)
    beta = (0.1 * r(T, C)).to(dtype)
    return r(T, N, H, W, C).to(dtype), x, mean, rstd, gamma, beta


def _k3_free_calls(slope):
    """(kernel wrapper, twin, counter) of K3 pool-free at ``slope``."""
    if slope == 1.0:
        return cb.batch_norm_bwd, F.batch_norm_bwd, "batch_norm_bwd"
    return (lambda *a: cb.bn_act_bwd(*a, slope),
            lambda *a: F.bn_act_bwd(*a, slope), "bn_act_bwd")


def _check_k3_free(args, slope):
    """K3 pool-free against its twin, one launch on its counter, a second
    launch bit for bit the first."""
    kernel, twin, name = _k3_free_calls(slope)
    tag = "_bf16" if args[1].dtype == torch.bfloat16 else ""
    cb.reset_launches()
    got = kernel(*args)
    assert {k: n for k, n in cb.launches().items() if n} == {name + tag: 1}
    for a, c, what in zip(got, twin(*args), ("dy", "dgamma", "dbeta")):
        assert a.dtype == c.dtype and a.shape == c.shape, what
        assert torch.isfinite(a).all(), what
        if a.dtype == torch.bfloat16:
            within_ulp(a, c, what)
        else:
            _close(a, c)
    assert all(torch.equal(a, c) for a, c in zip(kernel(*args), got))
    torch.cuda.synchronize()


@pytest.mark.parametrize("slope", list(K3_FREE_SLOPES))
@pytest.mark.parametrize("dtype", list(K3_FREE_DTYPES))
@pytest.mark.parametrize("shape", K3_FREE_MAIN, ids=str)
def test_k3_free_matches_its_twin_at_main_path_shapes(shape, dtype, slope,
                                                      device):
    T, N, hw, C = shape
    _check_k3_free(_k3_free_inputs(T, N, hw, hw, C, K3_FREE_DTYPES[dtype],
                                   hw + C + N + T),
                   K3_FREE_SLOPES[slope])
    torch.cuda.empty_cache()


@pytest.mark.parametrize("slope", list(K3_FREE_SLOPES))
@pytest.mark.parametrize("dtype", list(K3_FREE_DTYPES))
@pytest.mark.parametrize("shape", K3_FREE_EDGE, ids=str)
def test_k3_free_matches_its_twin_at_edge_shapes(shape, dtype, slope,
                                                 device):
    _check_k3_free(_k3_free_inputs(*shape, K3_FREE_DTYPES[dtype],
                                   sum(shape)),
                   K3_FREE_SLOPES[slope])


def test_k3_free_plans_take_every_mode_and_route(device):
    """The plans of the main-path and edge shapes on this card reach every
    mode, both routes, and the grid route with and without the stage."""
    seen = set()
    for T, N, H, W, C in ([(T, N, hw, hw, C) for T, N, hw, C in
                           K3_FREE_MAIN] + K3_FREE_EDGE):
        for bf16 in (False, True):
            p = cb._bn_act_bwd_route(torch.device("cuda:0"), T, N * H * W,
                                     C, bf16, True)
            seen.add((p.mode, p.route, bool(p.stage)))
    assert {m for m, _, _ in seen} == set(cb.BN_STATS_MODES)
    assert {r for _, r, _ in seen} == {"block", "grid"}
    assert {("packed3", "grid"), ("lanes", "grid")} <= {
        (m, r) for m, r, _ in seen}
    assert {("lanes", "grid", True), ("lanes", "grid", False),
            ("packed3", "grid", True)} <= seen


# (T, N, H = W, C): shapes whose plans keep the chunks in shared memory
# (strided L1 and L2, the image at T = 2; in bf16 also the image and stage
# 2 at T = 8)
K3_FREE_STAGED = [(8, 20, 14, 64), (8, 20, 7, 64), (2, 25, 84, 3),
                  (8, 25, 84, 3), (8, 25, 21, 48)]


@pytest.mark.parametrize("dtype", list(K3_FREE_DTYPES))
@pytest.mark.parametrize("shape", K3_FREE_STAGED, ids=str)
def test_k3_free_stage_gives_the_apply_from_l2_bits(shape, dtype, device,
                                                    monkeypatch):
    """The staged apply (the block's packets of da and y read back from
    shared memory) equals the apply that reads them again from L2 bit for
    bit: the same values in the same order."""
    T, N, hw, C = shape
    args = _k3_free_inputs(T, N, hw, hw, C, K3_FREE_DTYPES[dtype], 101)
    bf16 = dtype == "bf16"
    dev = torch.device("cuda:0")
    cb._bn_act_bwd_route.cache_clear()
    staged = cb._bn_act_bwd_route(dev, T, N * hw * hw, C, bf16, True).stage
    got = [cb.bn_act_bwd(*args), cb.batch_norm_bwd(*args)]
    monkeypatch.setattr(cb, "BN_ACT_BWD_STAGE_BYTES", 0)
    cb.bn_act_bwd_plan.cache_clear()
    cb._bn_act_bwd_route.cache_clear()
    assert not cb._bn_act_bwd_route(dev, T, N * hw * hw, C, bf16,
                                    True).stage
    want = [cb.bn_act_bwd(*args), cb.batch_norm_bwd(*args)]
    cb.bn_act_bwd_plan.cache_clear()
    cb._bn_act_bwd_route.cache_clear()
    # in f32 the T = 8 image and stage 2 need more than a block's memory
    assert staged or (not bf16 and shape in ((8, 25, 84, 3),
                                             (8, 25, 21, 48)))
    for g, w in zip(got, want):
        assert all(torch.equal(a, c) for a, c in zip(g, w))
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", list(K3_FREE_DTYPES))
def test_k3_free_takes_tensors_off_16_byte_alignment(dtype, device,
                                                     monkeypatch):
    """da and x as contiguous views one element into their storage, which
    the wrappers take: the plan is asked without vectors (the scalar
    mode), and the outputs equal the twin's as aligned inputs' do."""
    asked = []
    plan = cb.bn_act_bwd_plan
    monkeypatch.setattr(cb, "bn_act_bwd_plan",
                        lambda *a: asked.append(a[4]) or plan(*a))
    cb._bn_act_bwd_route.cache_clear()

    def shifted(t):
        buf = torch.empty(t.numel() + 1, device=t.device, dtype=t.dtype)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view

    for C in (3, 48):
        args = _k3_free_inputs(2, 3, 10, 10, C, K3_FREE_DTYPES[dtype], C)
        for which in (0, 1):  # da, then x, off alignment
            off = list(args)
            off[which] = shifted(args[which])
            assert off[which].data_ptr() % 16 != 0
            for slope in K3_FREE_SLOPES.values():
                asked.clear()
                cb._bn_act_bwd_route.cache_clear()
                _check_k3_free(tuple(off), slope)
                assert asked == [False]
        asked.clear()
        cb._bn_act_bwd_route.cache_clear()
        _check_k3_free(args, F.LEAKY_SLOPE)
        assert asked == [True]
    cb._bn_act_bwd_route.cache_clear()


# (T, N, H = W, C) of act_bwd: the strided norm-first model's conv outputs
# (N = 20, 64 channels) at T = 8 and 2, and edge shapes (a tail past the
# last vector, odd channel counts, one value)
ACT_SHAPES = ([(8, 20, hw, 64) for hw in (14, 7, 4, 2)] + [(2, 20, 14, 64)]
              + [(1, 1, 1, 1), (2, 3, 5, 3), (3, 2, 3, 7), (1, 1, 3, 5)])


def _act_inputs(T, N, hw, C, dtype, seed):
    """da and y in ``dtype``, y with exact zeros of both signs."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    y = torch.randn(T, N, hw, hw, C, device="cuda", generator=g)
    y.view(-1)[::7] = 0.0
    y.view(-1)[3::11] = -0.0
    da = torch.randn(T, N, hw, hw, C, device="cuda", generator=g)
    return da.to(dtype), y.to(dtype)


def _check_act_bwd(da, y):
    """``act_bwd`` equal to its twin bit for bit, one launch on its
    counter, a second launch bit for bit the first."""
    tag = "_bf16" if y.dtype == torch.bfloat16 else ""
    cb.reset_launches()
    got = cb.act_bwd(da, y)
    assert {k: n for k, n in cb.launches().items() if n} == {
        "act_bwd" + tag: 1}
    want = F.act_bwd(da, y)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)
    assert torch.equal(cb.act_bwd(da, y), got)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", list(K3_FREE_DTYPES))
@pytest.mark.parametrize("shape", ACT_SHAPES, ids=str)
def test_act_bwd_equals_its_twin(shape, dtype, device):
    _check_act_bwd(*_act_inputs(*shape, K3_FREE_DTYPES[dtype], sum(shape)))


@pytest.mark.parametrize("dtype", list(K3_FREE_DTYPES))
def test_act_bwd_takes_tensors_off_16_byte_alignment(dtype, device):
    """da, y or both one element into their storage (one element a
    thread): equal to the twin bit for bit."""
    da, y = _act_inputs(2, 5, 7, 64, K3_FREE_DTYPES[dtype], 61)
    for which in ((0,), (1,), (0, 1)):
        args = [da, y]
        for i in which:
            buf = torch.empty(args[i].numel() + 1, device=device,
                              dtype=args[i].dtype)
            args[i] = buf[1:].view(y.shape)
            args[i].copy_((da, y)[i])
        _check_act_bwd(*args)


def test_k3_free_and_act_bwd_reject_what_the_kernels_do_not_take(device):
    """f16 raises ``TypeError``, a non-contiguous tensor, a table of
    another shape or 257 channels ``ValueError``, before any launch."""
    args = _k3_free_inputs(2, 3, 4, 4, 8, torch.float32, 73)
    da, x, mean, rstd, gamma, beta = args
    cb.reset_launches()
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        cb.bn_act_bwd(*(t.half() for t in args))
    with pytest.raises(TypeError, match="must be torch.float32"):
        cb.bn_act_bwd(da, x, mean.bfloat16(), rstd, gamma, beta)
    with pytest.raises(ValueError, match="contiguous"):
        cb.batch_norm_bwd(da.transpose(2, 3), x, mean, rstd, gamma, beta)
    with pytest.raises(ValueError, match="shape"):
        cb.bn_act_bwd(da, x, mean[:, :4], rstd, gamma, beta)
    wide = torch.zeros(1, 1, 1, 1, 257, device=device)
    ones = torch.ones(1, 257, device=device)
    with pytest.raises(ValueError, match="no pool-free K3"):
        cb.bn_act_bwd(wide, wide, ones, ones, ones, ones)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        cb.act_bwd(da.half(), x.half())
    with pytest.raises(ValueError, match="contiguous"):
        cb.act_bwd(da, x.transpose(2, 3))
    with pytest.raises(ValueError, match="shape"):
        cb.act_bwd(da[:1], x)
    assert set(cb.launches().values()) == {0}


def test_k3_free_and_act_bwd_entries_refuse_what_does_not_match(device):
    """The entries check the plan against the shape and the mode that C
    and the vectors give, and the vectors against the pointers, and
    launch nothing otherwise."""
    from howtotrainyourmamlpytorch_tpu_torch.kernels import build

    T, N, H, W, C = 2, 6, 12, 12, 48
    P = N * H * W
    da, x, mean, rstd, gamma, beta = _k3_free_inputs(T, N, H, W, C,
                                                     torch.float32, 79)
    entry = build.function("bn_act_bwd", "bn_act_bwd", cb._ADDR_2F_ENTRY)
    stream = torch.cuda.current_stream().cuda_stream
    dy = torch.full_like(x, 7.0)
    sums = torch.full((2, T, C), 7.0, device=device)
    p = cb.bn_act_bwd_plan(T, P, C, False, True, 4, 2)
    assert p.route == "grid" and p.mode == "lanes"
    scratch = torch.empty(2 * C * (p.grid + T), device=device)
    off = torch.empty(x.numel() + 1, device=device)[1:]

    def call(dap, vec, threads, chunk, splits, grid, stage):
        part = scratch.data_ptr()
        args = cb._packed(
            dap, x.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            gamma.data_ptr(), beta.data_ptr(), dy.data_ptr(),
            sums[0].data_ptr(), sums[1].data_ptr(), part,
            part + 8 * C * p.grid, T, C, P * C, 0, vec, threads, chunk,
            splits, grid, 0, stream, stage)
        return entry(args.buffer_info()[0], F.LEAKY_SLOPE, 1.0 / P)

    assert p.stage
    good = (da.data_ptr(), 1, p.threads, p.chunk, p.splits, p.grid, p.stage)
    for bad in ((off.data_ptr(),) + good[1:],          # da off vectors
                good[:1] + (0,) + good[2:],            # the scalar mode's
                good[:2] + (256,) + good[3:],          # not a slot multiple
                good[:3] + (p.chunk + 1,) + good[4:],  # chunk off the slots
                good[:3] + (p.chunk // 2,) + good[4:],  # units uncovered
                good[:5] + (p.grid + 1, p.stage),      # grid != T x splits
                good[:6] + (p.stage - 16,),            # a stage too small
                good[:6] + (-1,),
                (da.data_ptr(), 0) + good[2:]):        # staged scalars
        assert call(*bad) != 0
    act = build.function("act", "act_bwd", cb._ADDR_F_ENTRY)
    n = x.numel()
    for dap, vec, blocks in ((off.data_ptr(), 1, -(-n // 4 // 256)),
                             (da.data_ptr(), 1, -(-n // 256)),
                             (da.data_ptr(), 0, -(-n // 4 // 256))):
        args = cb._packed(dap, x.data_ptr(), dy.data_ptr(), n, 0, vec,
                          blocks, 0, stream)
        assert act(args.buffer_info()[0], F.LEAKY_SLOPE) != 0
    torch.cuda.synchronize()
    assert bool((dy == 7.0).all()) and bool((sums == 7.0).all())
    assert call(*good) == 0
    want = F.bn_act_bwd(da, x, mean, rstd, gamma, beta)
    for a, c in zip((dy, sums[0], sums[1]), want):
        _close(a, c)
    # the same plan without the stage: the same bits
    staged = (dy.clone(), sums.clone())
    assert call(*good[:6], 0) == 0
    torch.cuda.synchronize()
    assert torch.equal(dy, staged[0]) and torch.equal(sums, staged[1])


def test_no_k3_free_or_act_bwd_call_reaches_a_triton_kernel(device):
    """The Triton modules that held the pool-free K3 and ``act_bwd`` are
    gone, and ``bn_act_bwd``, ``batch_norm_bwd`` and ``act_bwd`` run their
    CUDA kernels, in f32 and bf16."""
    _triton_modules_gone()
    for dtype in K3_FREE_DTYPES.values():
        for slope in K3_FREE_SLOPES.values():
            _check_k3_free(_k3_free_inputs(2, 3, 8, 8, 3, dtype, 83), slope)
            _check_k3_free(_k3_free_inputs(2, 3, 8, 8, 48, dtype, 89), slope)
        _check_act_bwd(*_act_inputs(2, 3, 8, 64, dtype, 97))


# -- K5 pool-free (bn_act_bwd_bwd, batch_norm_bwd_bwd) on CUDA ----------------
#
# One launch a call, f32 and bf16, on csrc/bn_act_bwd.cu (K3's layout and
# routes, ``bn_act_bwd_bwd_plan``), at slope 0.01 (``bn_act_bwd_bwd``) and
# 1 (``batch_norm_bwd_bwd``). Gates: f32 within 1e-5 + 1e-4 * scale of the
# twin, bf16 within one bf16 ulp (or 1e-4 of scale); one launch on its
# counter; a second launch bit for bit the first.

# (T, N, H = W, C): K3's shapes (the strided and unpadded strided conv
# outputs, every norm-first block input, the large maps at T = 2)
K5_FREE_MAIN = K3_FREE_MAIN


def _k5_free_inputs(T, N, H, W, C, dtype, seed):
    """The cotangents a, ggamma and gbeta, then K3's arguments (da, x and
    its statistics, gamma, beta), in ``dtype``."""
    k3 = _k3_free_inputs(T, N, H, W, C, dtype, seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)

    def r(*s):
        return torch.randn(*s, device="cuda", generator=g).to(dtype)

    return (r(T, N, H, W, C), r(T, C), r(T, C)) + k3


def _k5_free_calls(slope):
    """(kernel wrapper, twin, counter) of K5 pool-free at ``slope``."""
    if slope == 1.0:
        return (cb.batch_norm_bwd_bwd, F.batch_norm_bwd_bwd,
                "batch_norm_bwd_bwd")
    return (lambda *a: cb.bn_act_bwd_bwd(*a, slope),
            lambda *a: F.bn_act_bwd_bwd(*a, slope), "bn_act_bwd_bwd")


def _check_k5_free(args, slope):
    """K5 pool-free against its twin, one launch on its counter, a second
    launch bit for bit the first."""
    kernel, twin, name = _k5_free_calls(slope)
    tag = "_bf16" if args[4].dtype == torch.bfloat16 else ""
    cb.reset_launches()
    got = kernel(*args)
    assert {k: n for k, n in cb.launches().items() if n} == {name + tag: 1}
    for a, c, what in zip(got, twin(*args), ("g_da", "g_y", "g_gamma")):
        assert a.dtype == c.dtype and a.shape == c.shape, what
        assert a.is_contiguous() and torch.isfinite(a).all(), what
        if a.dtype == torch.bfloat16:
            within_ulp(a, c, what)
        else:
            _close(a, c)
    assert all(torch.equal(a, c) for a, c in zip(kernel(*args), got))
    torch.cuda.synchronize()


@pytest.mark.parametrize("slope", list(K3_FREE_SLOPES))
@pytest.mark.parametrize("dtype", list(K3_FREE_DTYPES))
@pytest.mark.parametrize("shape", K5_FREE_MAIN, ids=str)
def test_k5_free_matches_its_twin_at_main_path_shapes(shape, dtype, slope,
                                                      device):
    T, N, hw, C = shape
    _check_k5_free(_k5_free_inputs(T, N, hw, hw, C, K3_FREE_DTYPES[dtype],
                                   hw + C + N + T + 5),
                   K3_FREE_SLOPES[slope])
    torch.cuda.empty_cache()


@pytest.mark.parametrize("slope", list(K3_FREE_SLOPES))
@pytest.mark.parametrize("dtype", list(K3_FREE_DTYPES))
@pytest.mark.parametrize("shape", K3_FREE_EDGE, ids=str)
def test_k5_free_matches_its_twin_at_edge_shapes(shape, dtype, slope,
                                                 device):
    _check_k5_free(_k5_free_inputs(*shape, K3_FREE_DTYPES[dtype],
                                   sum(shape) + 5),
                   K3_FREE_SLOPES[slope])


def test_k5_free_plans_take_every_mode_and_route(device):
    """The plans of the main-path and edge shapes on this card reach every
    mode, both routes, and the grid route with and without the stage."""
    seen = set()
    for T, N, H, W, C in ([(T, N, hw, hw, C) for T, N, hw, C in
                           K5_FREE_MAIN] + K3_FREE_EDGE):
        for bf16 in (False, True):
            p = cb._bn_act_bwd_bwd_route(torch.device("cuda:0"), T,
                                         N * H * W, C, bf16, True)
            seen.add((p.mode, p.route, bool(p.stage)))
    assert {m for m, _, _ in seen} == set(cb.BN_STATS_MODES)
    assert {r for _, r, _ in seen} == {"block", "grid"}
    assert {("lanes", "grid", True), ("lanes", "grid", False),
            ("packed3", "grid", False)} <= seen


# (T, N, H = W, C): shapes whose plans keep the chunks of a, da and y in
# shared memory (strided L1 and L2; in bf16 also stage 2 at T = 8)
K5_FREE_STAGED = [(8, 20, 14, 64), (8, 20, 7, 64), (8, 25, 10, 48),
                  (8, 25, 21, 48)]


@pytest.mark.parametrize("dtype", list(K3_FREE_DTYPES))
@pytest.mark.parametrize("shape", K5_FREE_STAGED, ids=str)
def test_k5_free_stage_gives_the_apply_from_l2_bits(shape, dtype, device,
                                                    monkeypatch):
    """The staged apply (the block's packets of a, da and y read back from
    shared memory) equals the apply that reads them again from L2 bit for
    bit: the same values in the same order."""
    T, N, hw, C = shape
    args = _k5_free_inputs(T, N, hw, hw, C, K3_FREE_DTYPES[dtype], 103)
    bf16 = dtype == "bf16"
    dev = torch.device("cuda:0")
    cb._bn_act_bwd_bwd_route.cache_clear()
    staged = cb._bn_act_bwd_bwd_route(dev, T, N * hw * hw, C, bf16,
                                      True).stage
    got = [cb.bn_act_bwd_bwd(*args), cb.batch_norm_bwd_bwd(*args)]
    monkeypatch.setattr(cb, "BN_ACT_BWD_BWD_STAGE_BYTES", 0)
    cb.bn_act_bwd_bwd_plan.cache_clear()
    cb._bn_act_bwd_bwd_route.cache_clear()
    assert not cb._bn_act_bwd_bwd_route(dev, T, N * hw * hw, C, bf16,
                                        True).stage
    want = [cb.bn_act_bwd_bwd(*args), cb.batch_norm_bwd_bwd(*args)]
    cb.bn_act_bwd_bwd_plan.cache_clear()
    cb._bn_act_bwd_bwd_route.cache_clear()
    # in f32 stage 2 needs more than a block's memory
    assert staged or (not bf16 and shape == (8, 25, 21, 48))
    for g, w in zip(got, want):
        assert all(torch.equal(a, c) for a, c in zip(g, w))
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", list(K3_FREE_DTYPES))
def test_k5_free_takes_tensors_off_16_byte_alignment(dtype, device,
                                                     monkeypatch):
    """a, da or x as contiguous views one element into their storage,
    which the wrappers take: the plan is asked without vectors (the
    scalar mode), and the outputs equal the twin's as aligned inputs'
    do."""
    asked = []
    plan = cb.bn_act_bwd_bwd_plan
    monkeypatch.setattr(cb, "bn_act_bwd_bwd_plan",
                        lambda *a: asked.append(a[4]) or plan(*a))
    cb._bn_act_bwd_bwd_route.cache_clear()

    def shifted(t):
        buf = torch.empty(t.numel() + 1, device=t.device, dtype=t.dtype)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view

    for C in (3, 48):
        args = _k5_free_inputs(2, 3, 10, 10, C, K3_FREE_DTYPES[dtype], C)
        for which in (0, 3, 4):  # a, da, then x, off alignment
            off = list(args)
            off[which] = shifted(args[which])
            assert off[which].data_ptr() % 16 != 0
            for slope in K3_FREE_SLOPES.values():
                asked.clear()
                cb._bn_act_bwd_bwd_route.cache_clear()
                _check_k5_free(tuple(off), slope)
                assert asked == [False]
        asked.clear()
        cb._bn_act_bwd_bwd_route.cache_clear()
        _check_k5_free(args, F.LEAKY_SLOPE)
        assert asked == [True]
    cb._bn_act_bwd_bwd_route.cache_clear()


def test_k5_free_rejects_and_its_entry_refuses_what_does_not_match(device):
    """The wrappers: f16 ``TypeError``, a non-contiguous tensor, a table or
    cotangent of another shape, 257 channels ``ValueError``, before any
    launch. The entry checks the plan against the shape and the mode that
    C and the vectors give, and the vectors against the pointers, and
    launches nothing otherwise; a good plan gives the twin's values, with
    and without the stage the same bits."""
    from howtotrainyourmamlpytorch_tpu_torch.kernels import build

    args = _k5_free_inputs(2, 3, 4, 4, 8, torch.float32, 73)
    a, gg, gb, da, x, mean, rstd, gamma, beta = args
    cb.reset_launches()
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        cb.bn_act_bwd_bwd(*(t.half() for t in args))
    with pytest.raises(TypeError, match="must be torch.float32"):
        cb.bn_act_bwd_bwd(a, gg.bfloat16(), *args[2:])
    with pytest.raises(ValueError, match="contiguous"):
        cb.batch_norm_bwd_bwd(a.transpose(2, 3), *args[1:])
    with pytest.raises(ValueError, match="shape"):
        cb.bn_act_bwd_bwd(a, gg, gb[:, :4], *args[3:])
    wide = torch.zeros(1, 1, 1, 1, 257, device=device)
    ones = torch.ones(1, 257, device=device)
    with pytest.raises(ValueError, match="no pool-free K5"):
        cb.bn_act_bwd_bwd(wide, ones, ones, wide, wide, ones, ones, ones,
                          ones)
    assert set(cb.launches().values()) == {0}

    T, N, H, W, C = 2, 6, 12, 12, 48
    P = N * H * W
    a, gg, gb, da, x, mean, rstd, gamma, beta = _k5_free_inputs(
        T, N, H, W, C, torch.float32, 79)
    entry = build.function("bn_act_bwd", "bn_act_bwd_bwd", cb._ADDR_2F_ENTRY)
    stream = torch.cuda.current_stream().cuda_stream
    g_da = torch.full_like(x, 7.0)
    g_y = torch.full_like(x, 7.0)
    g_gamma = torch.full((T, C), 7.0, device=device)
    p = cb.bn_act_bwd_bwd_plan(T, P, C, False, True, 8, 2)
    assert p.route == "grid" and p.mode == "lanes" and p.stage
    scratch = torch.empty(5 * C * (p.grid + T), device=device)
    off = torch.empty(x.numel() + 1, device=device)[1:]

    def call(ap, vec, threads, chunk, splits, grid, stage):
        part = scratch.data_ptr()
        packed = cb._packed(
            ap, da.data_ptr(), x.data_ptr(), mean.data_ptr(),
            rstd.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            gg.data_ptr(), gb.data_ptr(), g_da.data_ptr(), g_y.data_ptr(),
            g_gamma.data_ptr(), part, part + 20 * C * p.grid, T, C, P * C,
            0, vec, threads, chunk, splits, grid, 0, stream, stage)
        return entry(packed.buffer_info()[0], F.LEAKY_SLOPE, 1.0 / P)

    good = (a.data_ptr(), 1, p.threads, p.chunk, p.splits, p.grid, p.stage)
    for bad in ((off.data_ptr(),) + good[1:],          # a off vectors
                good[:1] + (0,) + good[2:],            # the scalar mode's
                good[:2] + (256,) + good[3:],          # not a slot multiple
                good[:3] + (p.chunk + 1,) + good[4:],  # chunk off the slots
                good[:3] + (p.chunk // 2,) + good[4:],  # units uncovered
                good[:5] + (p.grid + 1, p.stage),      # grid != T x splits
                good[:6] + (p.stage - 16,),            # a stage too small
                good[:6] + (-1,),
                (a.data_ptr(), 0) + good[2:]):         # staged scalars
        assert call(*bad) != 0
    torch.cuda.synchronize()
    for t in (g_da, g_y, g_gamma):
        assert bool((t == 7.0).all())
    assert call(*good) == 0
    want = F.bn_act_bwd_bwd(a, gg, gb, da, x, mean, rstd, gamma, beta)
    for got, c in zip((g_da, g_y, g_gamma), want):
        _close(got, c)
    staged = (g_da.clone(), g_y.clone(), g_gamma.clone())
    assert call(*good[:6], 0) == 0
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip((g_da, g_y, g_gamma),
                                                  staged))


# -- act_fwd on csrc/act.cu, layer_norm_fwd on csrc/layer_norm.cu -----------
#
# One launch a call, f32 and bf16, each bit for bit its twin (act_fwd: one
# rounding of an exact product; layer_norm_fwd: the twin's four ops each
# rounded, in bf16 each to bf16) and a second launch bit for bit the first.

# (T, N, H, W, C) of layer_norm_fwd beyond ``LN_MAIN``: the images a shipped
# geometry's task gives at the Omniglot pooled maps (28/14/7/3 x 64, 5 and
# 100 images) and at the mini-ImageNet 1-shot support (5 images)
LN_FWD_MORE = [(8, n, hw, hw, 64) for hw in (28, 3) for n in (5, 100)] + [
    (2, 5, 84, 84, 48), (8, 5, 21, 21, 48)]


def _check_ln_fwd(x, mean, rstd, gamma, beta):
    """``layer_norm_fwd`` equal to its twin bit for bit, one launch on its
    counter, a second launch bit for bit the first."""
    tag = "_bf16" if x.dtype == torch.bfloat16 else ""
    cb.reset_launches()
    z = cb.layer_norm_fwd(x, mean, rstd, gamma, beta)
    assert {k: n for k, n in cb.launches().items() if n} == {
        "layer_norm_fwd" + tag: 1}
    want = F.layer_norm_fwd(x, mean, rstd, gamma, beta)
    assert z.dtype == want.dtype and z.shape == want.shape
    assert torch.equal(z, want)
    assert torch.equal(cb.layer_norm_fwd(x, mean, rstd, gamma, beta), z)
    torch.cuda.synchronize()


def _ln_fwd_inputs(T, N, H, W, C, dtype, seed):
    """x (with an offset), its twin statistics, gamma and beta, in
    ``dtype``."""
    x, mean, rstd, gamma, dz = _ln_inputs(T, N, H, W, C, dtype, seed)
    beta = (dz[:, 0] * 10.0).contiguous()
    return x, mean, rstd, gamma, beta


@pytest.mark.parametrize("dtype", list(LN_DTYPES))
@pytest.mark.parametrize("shape", [(T, N, hw, hw, C) for T, N, hw, C in
                                   LN_MAIN] + LN_FWD_MORE + LN_EDGE, ids=str)
def test_ln_fwd_equals_its_twin(shape, dtype, device):
    _check_ln_fwd(*_ln_fwd_inputs(*shape, LN_DTYPES[dtype], sum(shape) + 7))
    torch.cuda.empty_cache()


@pytest.mark.parametrize("dtype", list(LN_DTYPES))
def test_ln_fwd_takes_tensors_off_16_byte_alignment(dtype, device,
                                                    monkeypatch):
    """x, gamma or beta one element into their storage, and an odd M:
    the plan is asked without vectors (a value a thread) at each launch,
    and z equals the twin bit for bit; aligned tensors take the
    vectors."""
    asked = []
    plan = cb.ln_fwd_plan
    monkeypatch.setattr(cb, "ln_fwd_plan",
                        lambda *a: asked.append(a[4]) or plan(*a))

    def shifted(t):
        buf = torch.empty(t.numel() + 1, device=t.device, dtype=t.dtype)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view

    args = _ln_fwd_inputs(2, 3, 10, 10, 48, LN_DTYPES[dtype], 71)
    for which in (0, 3, 4):  # x, gamma, beta
        off = list(args)
        off[which] = shifted(args[which])
        assert off[which].data_ptr() % 16 != 0
        asked.clear()
        _check_ln_fwd(*off)
        assert asked and not any(asked)
    asked.clear()
    _check_ln_fwd(*args)
    assert asked and all(asked)
    asked.clear()
    _check_ln_fwd(*_ln_fwd_inputs(2, 3, 5, 5, 3, LN_DTYPES[dtype], 73))
    assert asked and not any(asked)  # M = 75: no 16-byte loads


def test_ln_fwd_rejects_what_the_kernel_does_not_take(device):
    """f16 raises ``TypeError``, a non-contiguous x or parameters of
    another shape ``ValueError``, before any launch."""
    x, mean, rstd, gamma, beta = _ln_fwd_inputs(2, 3, 6, 6, 8,
                                                torch.float32, 75)
    cb.reset_launches()
    with pytest.raises(TypeError, match="^layer_norm_fwd: .*float32 or "
                                        "bfloat16"):
        cb.layer_norm_fwd(*(t.half() for t in (x, mean, rstd, gamma, beta)))
    with pytest.raises(ValueError, match="contiguous"):
        cb.layer_norm_fwd(x.transpose(2, 3), mean, rstd, gamma, beta)
    with pytest.raises(ValueError, match="shape"):
        cb.layer_norm_fwd(x, mean, rstd, gamma[:1], beta)
    with pytest.raises(TypeError, match="must be torch.float32"):
        cb.layer_norm_fwd(x, mean.bfloat16(), rstd, gamma, beta)
    assert set(cb.launches().values()) == {0}


def test_ln_fwd_entry_refuses_a_plan_that_does_not_match(device):
    """The entry checks the plan against the shape and the vectors against
    M and the pointers, and launches nothing otherwise."""
    from howtotrainyourmamlpytorch_tpu_torch.kernels import build

    T, N, H, W, C = 2, 9, 6, 6, 64
    M = H * W * C
    x, mean, rstd, gamma, beta = _ln_fwd_inputs(T, N, H, W, C,
                                                torch.float32, 77)
    entry = build.function("layer_norm", "layer_norm_fwd", cb._ADDR_ENTRY)
    stream = torch.cuda.current_stream().cuda_stream
    z = torch.full_like(x, 7.0)
    off = torch.empty(x.numel() + 1, device=device)[1:]
    p = cb.ln_fwd_plan(T, N, M, False, True)
    scalar = cb.ln_fwd_plan(T, N, M, False, False)
    assert p.tiles > 1 and scalar.tiles != p.tiles

    def call(xp, m, vec, tiles, grid):
        args = cb._packed(xp, mean.data_ptr(), rstd.data_ptr(),
                          gamma.data_ptr(), beta.data_ptr(), z.data_ptr(), T,
                          N, m, 0, vec, tiles, grid, 0, stream)
        return entry(args.buffer_info()[0])

    good = (x.data_ptr(), M, 1, p.tiles, p.grid)
    for bad in ((off.data_ptr(),) + good[1:],        # x off the vectors
                good[:1] + (M - 2,) + good[2:],      # M off the vectors
                good[:3] + (p.tiles + 1, p.grid),
                good[:3] + (scalar.tiles, scalar.grid),  # a value a thread
                good[:4] + (p.grid + 1,),
                good[:4] + (0,)):
        assert call(*bad) != 0
    torch.cuda.synchronize()
    assert bool((z == 7.0).all())
    assert call(*good) == 0
    assert torch.equal(z, F.layer_norm_fwd(x, mean, rstd, gamma, beta))


@pytest.mark.parametrize("dtype", list(K3_FREE_DTYPES))
@pytest.mark.parametrize("shape", ACT_SHAPES, ids=str)
def test_act_fwd_equals_its_twin(shape, dtype, device):
    """``act_fwd`` equal to its twin bit for bit (zeros of both signs
    included), one launch on its counter, a second launch bit for bit the
    first."""
    _, y = _act_inputs(*shape, K3_FREE_DTYPES[dtype], sum(shape) + 3)
    _check_act_fwd(y)


def _check_act_fwd(y):
    tag = "_bf16" if y.dtype == torch.bfloat16 else ""
    cb.reset_launches()
    z = cb.act_fwd(y)
    assert {k: n for k, n in cb.launches().items() if n} == {
        "act_fwd" + tag: 1}
    want = F.act_fwd(y)
    assert z.dtype == want.dtype and z.shape == want.shape
    assert torch.equal(z, want)
    assert torch.equal(z.float().view(torch.int32),
                       want.float().view(torch.int32))  # -0.0 kept
    assert torch.equal(cb.act_fwd(y), z)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", list(K3_FREE_DTYPES))
def test_act_fwd_takes_tensors_off_16_byte_alignment(dtype, device):
    """y one element into its storage (one element a thread): equal to the
    twin bit for bit."""
    _, y = _act_inputs(2, 5, 7, 64, K3_FREE_DTYPES[dtype], 63)
    buf = torch.empty(y.numel() + 1, device=device, dtype=y.dtype)
    off = buf[1:].view(y.shape)
    off.copy_(y)
    assert off.data_ptr() % 16 != 0
    _check_act_fwd(off)


def test_act_fwd_rejects_and_its_entry_refuses_what_does_not_match(device):
    """The wrapper: f16 ``TypeError``, a non-contiguous tensor
    ``ValueError``, before any launch. The entry: a grid that does not
    match n, or vectors off the pointers, launches nothing."""
    from howtotrainyourmamlpytorch_tpu_torch.kernels import build

    _, y = _act_inputs(2, 3, 4, 8, torch.float32, 81)
    cb.reset_launches()
    with pytest.raises(TypeError, match="^act_fwd: .*float32 or bfloat16"):
        cb.act_fwd(y.half())
    with pytest.raises(ValueError, match="contiguous"):
        cb.act_fwd(y.transpose(2, 3))
    assert set(cb.launches().values()) == {0}
    entry = build.function("act", "act_fwd", cb._ADDR_F_ENTRY)
    stream = torch.cuda.current_stream().cuda_stream
    z = torch.full_like(y, 7.0)
    off = torch.empty(y.numel() + 1, device=device)[1:]
    n = y.numel()
    for yp, vec, blocks in ((off.data_ptr(), 1, cb.act_blocks(n, False, 1)),
                            (y.data_ptr(), 1, cb.act_blocks(n, False, 0)),
                            (y.data_ptr(), 0, cb.act_blocks(n, False, 1)),
                            (y.data_ptr(), 1, 0)):
        args = cb._packed(yp, z.data_ptr(), n, 0, vec, blocks, 0, stream)
        assert entry(args.buffer_info()[0], F.LEAKY_SLOPE) != 0
    torch.cuda.synchronize()
    assert bool((z == 7.0).all())


def test_no_act_fwd_or_ln_fwd_call_reaches_a_triton_kernel(device):
    """The Triton ``act_fwd`` and ``layer_norm_fwd`` are gone with every
    Triton module of the port, and both wrappers run their CUDA kernels,
    in f32 and bf16."""
    _triton_modules_gone()
    for dtype in K3_FREE_DTYPES.values():
        _check_act_fwd(_act_inputs(2, 3, 8, 64, dtype, 97)[1])
        _check_ln_fwd(*_ln_fwd_inputs(2, 3, 8, 8, 48, dtype, 67))


# -- act_pool_fwd and act_pool_bwd on csrc/act.cu --------------------------------
#
# One launch a call, f32 and bf16, each bit for bit its twin: the pooled
# values and the argmax, and dy with the twin's zeros (d * 0 off the argmax
# in a window, +0 on an odd map's dropped row and column), compared as
# integers so that a zero's sign counts; a second launch bit for bit the
# first.

# (T, N, H, W, C): the norm-first and layer-norm blocks' conv outputs at
# T = 8 (48 channels; the padded stages 84/42/21/10 and the unpadded
# 82/39/17/6, the forward's N = 75 and the backward's 25) and Omniglot's
# pooled maps (28/14/7/3 x 64, N = 20)
ACT_POOL_MAIN = ([(8, n, hw, hw, 48) for hw in (84, 42, 21, 10)
                  for n in (25, 75)]
                 + [(8, 25, hw, hw, 48) for hw in (82, 39, 17, 6)]
                 + [(8, 20, hw, hw, 64) for hw in (28, 7, 3)])
# edge shapes: odd in one or both dims, C off the vector (one channel a
# thread: 47, 3, 1), the least map, a vector of 4 but not of 8 (C = 12)
ACT_POOL_EDGE = [(2, 3, 21, 21, 47), (2, 3, 5, 7, 8), (3, 2, 7, 4, 12),
                 (1, 1, 2, 2, 1), (2, 2, 9, 9, 3), (1, 2, 3, 2, 16)]
ACT_POOL_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _bits(t):
    """A float tensor's bits as integers (a zero's sign counts)."""
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _act_pool_inputs(T, N, H, W, C, dtype, seed):
    """y on a grid of 0.25 (exact ties in many windows, at positive and at
    negative maxima; zeros of both signs) plus a continuous part on half
    its elements, and a pooled gradient of both signs, in ``dtype``."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (T, N, H, W, C)
    y = torch.randint(-4, 4, shape, device="cuda", generator=g) * 0.25
    y = y + torch.randn(shape, device="cuda", generator=g) * (
        torch.rand(shape, device="cuda", generator=g) < 0.5)
    y.view(-1)[3::13] = -0.0
    dp = torch.randn(T, N, H // 2, W // 2, C, device="cuda", generator=g)
    return y.to(dtype), dp.to(dtype)


def _check_act_pool(y, dp):
    """The three kernels equal their twins bit for bit, one launch each on
    its counter, a second launch bit for bit the first; returns dy."""
    tag = "_bf16" if y.dtype == torch.bfloat16 else ""
    cb.reset_launches()
    pooled, arg = cb.act_pool_fwd(y)
    assert {k: n for k, n in cb.launches().items() if n} == {
        "act_pool_fwd" + tag: 1}
    want, want_arg = F.act_pool_fwd(y)
    assert pooled.dtype == y.dtype and arg.dtype == torch.uint8
    assert torch.equal(_bits(pooled), _bits(want))
    assert torch.equal(arg, want_arg)
    again = cb.act_pool_fwd(y)
    assert torch.equal(_bits(again[0]), _bits(pooled))
    assert torch.equal(again[1], arg)
    cb.reset_launches()
    dy = cb.act_pool_bwd(dp, arg, y)
    assert {k: n for k, n in cb.launches().items() if n} == {
        "act_pool_bwd" + tag: 1}
    assert dy.dtype == y.dtype and dy.shape == y.shape
    assert torch.equal(_bits(dy), _bits(F.act_pool_bwd(dp, arg, y)))
    assert torch.equal(_bits(cb.act_pool_bwd(dp, arg, y)), _bits(dy))
    # the gather, on a g_dy of both signs with zeros of both signs
    g_dy = torch.randn_like(y)
    g_dy.view(-1)[5::11] = -0.0
    g_dy.view(-1)[7::17] = 0.0
    cb.reset_launches()
    got = cb.act_pool_gather(g_dy, arg, y)
    assert {k: n for k, n in cb.launches().items() if n} == {
        "act_pool_gather" + tag: 1}
    assert got.dtype == y.dtype and got.shape == arg.shape
    assert torch.equal(_bits(got), _bits(F.act_pool_gather(g_dy, arg, y)))
    assert torch.equal(_bits(cb.act_pool_gather(g_dy, arg, y)), _bits(got))
    torch.cuda.synchronize()
    return dy


@pytest.mark.parametrize("dtype", list(ACT_POOL_DTYPES))
@pytest.mark.parametrize("shape", ACT_POOL_MAIN, ids=str)
def test_act_pool_equals_its_twin_at_main_path_shapes(shape, dtype, device):
    _check_act_pool(*_act_pool_inputs(*shape, ACT_POOL_DTYPES[dtype],
                                      sum(shape)))
    torch.cuda.empty_cache()


@pytest.mark.parametrize("dtype", list(ACT_POOL_DTYPES))
@pytest.mark.parametrize("shape", ACT_POOL_EDGE, ids=str)
def test_act_pool_equals_its_twin_at_edge_shapes(shape, dtype, device):
    _check_act_pool(*_act_pool_inputs(*shape, ACT_POOL_DTYPES[dtype],
                                      sum(shape) + 1))


@pytest.mark.parametrize("dtype", list(ACT_POOL_DTYPES))
def test_act_pool_takes_tensors_off_16_byte_alignment(dtype, device,
                                                      monkeypatch):
    """y, the pooled gradient, g_dy or the argmax one element into its
    storage (one channel a thread): bit for bit the twins, on the scalar
    plan."""
    y, dp = _act_pool_inputs(2, 3, 21, 21, 48, ACT_POOL_DTYPES[dtype], 71)
    _, arg = F.act_pool_fwd(y)

    def off(t):
        buf = torch.empty(t.numel() + 1, device=device, dtype=t.dtype)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view

    asked = []
    plan = cb.act_pool_plan
    monkeypatch.setattr(cb, "act_pool_plan",
                        lambda *a: asked.append(a[-1]) or plan(*a))
    _check_act_pool(off(y), dp)
    assert asked == [False] * 6
    for args in ((off(dp), arg, y), (dp, off(arg), y)):
        asked.clear()
        got = cb.act_pool_bwd(*args)
        assert asked == [False]
        assert torch.equal(_bits(got), _bits(F.act_pool_bwd(*args)))
    g_dy = torch.randn_like(y)
    for args in ((off(g_dy), arg, y), (g_dy, off(arg), y)):
        asked.clear()
        got = cb.act_pool_gather(*args)
        assert asked == [False]
        assert torch.equal(_bits(got), _bits(F.act_pool_gather(*args)))
    asked.clear()
    _check_act_pool(y, dp)
    assert asked == [True] * 6


@pytest.mark.parametrize("dtype", list(ACT_POOL_DTYPES))
@pytest.mark.parametrize("hw", [21, 39], ids=str)
def test_act_pool_bwd_writes_the_dropped_row_and_column(hw, dtype, device):
    """dy's memory first holds NaN (a freed buffer of dy's size, which the
    caching allocator hands to the next allocation of that size): the
    launch itself writes +0 on the odd map's dropped row and column."""
    y, dp = _act_pool_inputs(2, 25, hw, hw, 48, ACT_POOL_DTYPES[dtype], hw)
    _, arg = F.act_pool_fwd(y)
    torch.cuda.synchronize()
    junk = torch.full_like(y, float("nan"))
    where = junk.data_ptr()
    del junk
    dy = cb.act_pool_bwd(dp, arg, y)
    assert dy.data_ptr() == where  # the NaN block, reused
    assert not _bits(dy[:, :, hw - 1]).any()
    assert not _bits(dy[:, :, :, hw - 1]).any()
    assert torch.equal(_bits(dy), _bits(F.act_pool_bwd(dp, arg, y)))


@pytest.mark.parametrize("shape", [(4, 1, 8192, 8192, 8),
                                   (2, 1, 32768, 32768, 1)], ids=str)
def test_act_pool_takes_the_64_bit_route(shape, device):
    """A bf16 y of 2**31 elements (each tenant under 2**31, as
    ``_check_act`` bounds them) takes the 64-bit plan, with vectors and
    one channel a thread; the last tenant, whose offsets pass 2**31, is
    its twin's bits in the forward, the backward and the gather."""
    T, N, H, W, C = shape
    assert cb.act_pool_plan(T, N, H, W, C, True, C % 8 == 0).wide
    g = torch.Generator(device="cuda").manual_seed(5)
    y = torch.randn(shape, device="cuda", generator=g, dtype=torch.bfloat16)
    dp = torch.randn(T, N, H // 2, W // 2, C, device="cuda", generator=g,
                     dtype=torch.bfloat16)
    pooled, arg = cb.act_pool_fwd(y)
    want, want_arg = F.act_pool_fwd(y[-1:])
    assert torch.equal(_bits(pooled[-1:]), _bits(want))
    assert torch.equal(arg[-1:], want_arg)
    del want, want_arg
    dy = cb.act_pool_bwd(dp, arg, y)
    assert torch.equal(_bits(dy[-1:]),
                       _bits(F.act_pool_bwd(dp[-1:], arg[-1:], y[-1:])))
    del pooled
    got = cb.act_pool_gather(dy, arg, y)  # dy as g_dy: y's shape
    assert torch.equal(_bits(got[-1:]), _bits(
        F.act_pool_gather(dy[-1:], arg[-1:], y[-1:])))
    del y, dp, arg, dy, got
    torch.cuda.empty_cache()


def test_act_pool_rejects_and_its_entries_refuse_what_does_not_match(
        device):
    """The wrappers: f16 ``TypeError``; a non-contiguous tensor, a pooled
    gradient or argmax of another shape or dtype, a map under 2x2
    ``ValueError``, before any launch. The entries: a plan whose blocks,
    index width or vectors do not hold launches nothing."""
    from howtotrainyourmamlpytorch_tpu_torch.kernels import build

    y, dp = _act_pool_inputs(2, 3, 6, 6, 8, torch.float32, 87)
    _, arg = F.act_pool_fwd(y)
    cb.reset_launches()
    with pytest.raises(TypeError, match="^act_pool_fwd: .*float32 or "
                                        "bfloat16"):
        cb.act_pool_fwd(y.half())
    with pytest.raises(ValueError, match="contiguous"):
        cb.act_pool_fwd(y.transpose(2, 3))
    with pytest.raises(ValueError, match="no act-pool launch"):
        cb.act_pool_fwd(y[:, :, :1].contiguous())
    with pytest.raises(ValueError, match="shape"):
        cb.act_pool_bwd(dp[:, :, :2], arg, y)
    with pytest.raises(ValueError, match="argmax"):
        cb.act_pool_bwd(dp, arg.int(), y)
    with pytest.raises(TypeError, match="dpooled"):
        cb.act_pool_bwd(dp.bfloat16(), arg, y)
    with pytest.raises(ValueError, match="shape"):
        cb.act_pool_gather(y[:, :1].contiguous(), arg, y)
    with pytest.raises(TypeError, match="g_dy"):
        cb.act_pool_gather(y.bfloat16(), arg, y)
    with pytest.raises(ValueError, match="argmax"):
        cb.act_pool_gather(y, arg[:, :1].contiguous(), y)
    assert set(cb.launches().values()) == {0}
    fwd = build.function("act", "act_pool_fwd", cb._ADDR_F_ENTRY)
    bwd = build.function("act", "act_pool_bwd", cb._ADDR_F_ENTRY)
    stream = torch.cuda.current_stream().cuda_stream
    T, N, H, W, C = y.shape
    out = torch.full((T, N, H // 2, W // 2, C), 7.0, device=device)
    darg = torch.full(out.shape, 9, device=device, dtype=torch.uint8)
    dy = torch.full_like(y, 7.0)
    plan = cb.act_pool_plan(T, N, H, W, C, False, True)
    scalar = cb.act_pool_plan(T, N, H, W, C, False, False)
    y_off = torch.empty(y.numel() + 1, device=device)[1:]
    for yp, argp, vec, wide, blocks in (
            (y.data_ptr(), darg.data_ptr(), 1, 0, plan.fwd_blocks + 1),
            (y.data_ptr(), darg.data_ptr(), 1, 0, scalar.fwd_blocks),
            (y.data_ptr(), darg.data_ptr(), 0, 0, plan.fwd_blocks),
            (y.data_ptr(), darg.data_ptr(), 1, 1, plan.fwd_blocks),
            (y_off.data_ptr(), darg.data_ptr(), 1, 0, plan.fwd_blocks),
            (y.data_ptr(), darg.data_ptr() + 1, 1, 0, plan.fwd_blocks)):
        args = cb._packed(yp, out.data_ptr(), argp, T, N, H, W, C, 0, vec,
                          wide, blocks, 0, stream)
        assert fwd(args.buffer_info()[0], F.LEAKY_SLOPE) != 0
    # C = 6 is off the vector; H = 1 has no window
    for shape in ((T, N, H, W, 6), (T, N, 1, W, C)):
        args = cb._packed(y.data_ptr(), out.data_ptr(), darg.data_ptr(),
                          *shape, 0, 1, 0, plan.fwd_blocks, 0, stream)
        assert fwd(args.buffer_info()[0], F.LEAKY_SLOPE) != 0
    for blocks in (plan.fwd_blocks - 1, plan.bwd_blocks + 1):
        args = cb._packed(dp.data_ptr(), arg.data_ptr(), y.data_ptr(),
                          dy.data_ptr(), T, N, H, W, C, 0, 1, 0, blocks, 0,
                          stream)
        assert bwd(args.buffer_info()[0], F.LEAKY_SLOPE) != 0
    torch.cuda.synchronize()
    assert bool((out == 7.0).all()) and bool((darg == 9).all())
    assert bool((dy == 7.0).all())
    gather = build.function("act", "act_pool_gather", cb._ADDR_F_ENTRY)
    g_dy = torch.randn_like(y)
    g_off = torch.empty(y.numel() + 1, device=device)[1:]
    for gp, argp, vec, wide, blocks in (
            (g_dy.data_ptr(), arg.data_ptr(), 1, 0, plan.fwd_blocks + 1),
            (g_dy.data_ptr(), arg.data_ptr(), 0, 0, plan.fwd_blocks),
            (g_dy.data_ptr(), arg.data_ptr(), 1, 1, plan.fwd_blocks),
            (g_off.data_ptr(), arg.data_ptr(), 1, 0, plan.fwd_blocks),
            (g_dy.data_ptr(), arg.data_ptr() + 1, 1, 0, plan.fwd_blocks)):
        args = cb._packed(gp, y.data_ptr(), argp, out.data_ptr(), T, N, H,
                          W, C, 0, vec, wide, blocks, 0, stream)
        assert gather(args.buffer_info()[0], F.LEAKY_SLOPE) != 0
    torch.cuda.synchronize()
    assert bool((out == 7.0).all())
    args = cb._packed(g_dy.data_ptr(), y.data_ptr(), arg.data_ptr(),
                      out.data_ptr(), T, N, H, W, C, 0, 1, 0,
                      plan.fwd_blocks, 0, stream)
    assert gather(args.buffer_info()[0], F.LEAKY_SLOPE) == 0
    assert torch.equal(_bits(out), _bits(F.act_pool_gather(g_dy, arg, y)))
    args = cb._packed(dp.data_ptr(), arg.data_ptr(), y.data_ptr(),
                      dy.data_ptr(), T, N, H, W, C, 0, 1, 0, plan.bwd_blocks,
                      0, stream)
    assert bwd(args.buffer_info()[0], F.LEAKY_SLOPE) == 0
    assert torch.equal(_bits(dy), _bits(F.act_pool_bwd(dp, arg, y)))


def test_no_act_pool_fwd_or_bwd_call_reaches_a_triton_kernel(device):
    """kernels/act_pool.py, which held the Triton act-pool kernels, is
    gone with every Triton module of the port, and the act-pool forward,
    backward and gather run their CUDA kernels, in f32 and bf16."""
    _triton_modules_gone()
    for dtype in ACT_POOL_DTYPES.values():
        _check_act_pool(*_act_pool_inputs(2, 3, 9, 8, 48, dtype, 97))
