"""``bn_input_stats`` (csrc/bn_input_stats.cu) and the global average pool
(csrc/global_avg_pool.cu), on the CPU.

The statistics' launch plan (``conv_block.bn_stats_plan``) at every
``bn_input_stats`` shape of the port's models — the mini-ImageNet
norm-first stage inputs (84 x 84 x 3, then 42/21/10 x 48), the unpadded
models' (84 x 84 x 3, 41/19/8 x 48 pooled, 20/9 x 48 strided) and the
strided Omniglot norm-first model's (28 x 28 x 1, then 14/7/4 x 64) — at
T = 1, 2, 8 and 16 and the
images a task gives them (5, 20, 25, 75), in f32 and bf16, with and
without 16-byte loads: every value covered once, each thread's channels
fixed across its units, shared memory within a block's, the cooperative
grid within the ``blocks_per_sm`` x 132 it is given. Then the kernel's
summation order emulated in numpy (f32) from the plan — each thread's
units folded G at a time (G = ``conv_block.BN_STATS_GROUP``, the
kernel's group: each channel's sum in (unit, value) order, the
group's mean and squared deviations, one merge a group with the thread's
shared weight), the threads of a channel's slot merged in thread order
(L lanes a channel, lane-strided with Chan's merge of one division, then
a shuffle tree), the blocks of a tenant likewise in split order (32
lanes) — and held to the twin
(``ops/functional.py::bn_input_stats``): f32 within 1e-5 + 1e-4 * scale,
bf16 (the sums in f32 on the widened loads, each output rounded once
where the twin rounds) within one bf16 ulp; at one small shape to the JAX
package's ``batch_norm`` statistics (``jnp.mean`` / ``jnp.var`` and
``lax.rsqrt``, run eagerly on the CPU); and the GAP's forward and
backward (the pixel-order f32 sum over an IEEE division) to
``global_avg_pool2d`` and its ``jax.vjp``.

The kernels themselves run only on the card
(``tests/test_torch_kernels_cuda.py``).
"""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu.ops import functional as JF
from howtotrainyourmamlpytorch_tpu_torch.kernels import conv_block as cb
from howtotrainyourmamlpytorch_tpu_torch.ops import functional as F

SMS = 132  # an H100 SXM's SMs
STATIC_SMEM = 48 * 1024  # static shared memory a block may take
# (H = W, C) of every block input the norm-first models normalize
MAPS = ((84, 3), (42, 48), (21, 48), (10, 48),  # mini-ImageNet
        (41, 48), (19, 48), (8, 48),            # unpadded pooled
        (20, 48), (9, 48),                      # unpadded strided
        (28, 1), (14, 64), (7, 64), (4, 64))    # strided Omniglot
SHAPES = [(T, n, hw, c) for T in (1, 2, 8, 16) for n in (5, 20, 25, 75)
          for hw, c in MAPS]
DTYPES = {"f32": False, "bf16": True}
BLOCKS_PER_SM = (1, 2, 3, 4)
RTOL, ATOL = 1e-4, 1e-5  # the card's twin gate
f32 = np.float32


def _values(bf16):
    return 8 if bf16 else 4  # a 16-byte load


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_stats_plan_covers_each_value_once_and_fits_the_card(shape, dtype):
    T, N, hw, C = shape
    bf16 = DTYPES[dtype]
    P, E = N * hw * hw, N * hw * hw * C
    for vec in (True, False):
        for bps in BLOCKS_PER_SM:
            p = cb.bn_stats_plan(T, P, C, bf16, vec, SMS, bps)
            assert p == cb.bn_stats_plan(T, P, C, bf16, vec, SMS, bps)
            assert p.mode == cb.bn_stats_mode(C, E, bf16, vec)
            # the mode: 16-byte loads at C = 1, 3 and multiples of a load
            if vec and C in (1, 3):
                assert p.mode == f"packed{C}" and p.vec == _values(bf16)
            elif vec:
                assert p.mode == "lanes" and C % p.vec == 0
            else:
                assert p.mode == "scalar" and p.vec == 1
            # a tenant is whole units; a unit's value i has channel (slot
            # x chans + i mod chans): the thread's chans channels, fixed
            W = p.unit * p.vec
            assert p.units * W == E and p.slots * p.chans == C
            assert W % p.chans == 0
            if p.mode.startswith("packed"):
                assert p.slots == 1 and W % C == 0
            # a block's live threads a multiple of the slots, every chunk
            # starting at one: a thread's units (first + tid + k threads)
            # are all its slot mod slots
            assert p.threads % p.slots == 0
            assert cb.BN_STATS_THREADS - p.slots < p.threads
            assert p.threads <= cb.BN_STATS_THREADS
            assert p.chunk % p.slots == 0
            # the chunks partition a tenant's units, none empty
            assert (p.splits - 1) * p.chunk < p.units <= p.splits * p.chunk
            assert p.grid == T * p.splits
            # the grid route only where it fits the card at once (the
            # cooperative launch): a wave of a block a SM, or two where
            # each thread gets WAVE_LOADS loads; the block route where one
            # block's threads get BLOCK_LOADS loads at most (or T exceeds
            # the SMs)
            loads = p.units * p.unit
            if p.route == "grid":
                assert p.splits > 1 and p.grid <= SMS * min(bps, 2)
                assert loads > p.threads * cb.BN_STATS_BLOCK_LOADS
                waves = 2 if p.grid > SMS else 1
                assert waves == 1 or loads >= (
                    p.grid // T * p.threads * cb.BN_STATS_WAVE_LOADS)
                assert SMS * (waves - 1) < p.grid <= SMS * waves
            else:
                assert p.splits == 1
                assert (loads <= p.threads * cb.BN_STATS_BLOCK_LOADS
                        or T > SMS // 2)
            # the static shared memory: a thread's count and its channels'
            # (mean, M2)
            assert 4 * cb.BN_STATS_THREADS * (1 + 2 * p.chans) <= STATIC_SMEM


def test_group_and_constants_are_the_kernels():
    """The plan's and the emulation's constants are the ones the kernel
    is compiled with (csrc/bn_input_stats.cu): the block's threads, the
    most channels, and the units a group by the loads a unit."""
    src = (pathlib.Path(cb.__file__).parent / "csrc" /
           "bn_input_stats.cu").read_text()
    one, three = re.search(r"constexpr int G = U == 1 \? (\d+) : (\d+);",
                           src).groups()
    assert cb.BN_STATS_GROUP == {1: int(one), 3: int(three)}
    assert re.search(r"constexpr int kThreads = (\d+);", src).group(1) == \
        str(cb.BN_STATS_THREADS)
    assert re.search(r"constexpr int kMaxC = (\d+);", src).group(1) == \
        str(cb.BN_STATS_MAX_C)


def test_stats_plan_refuses_what_the_kernel_does_not_take():
    for bad in ((0, 16, 3), (2, 0, 3), (2, 16, 0), (2, 16, 257)):
        with pytest.raises(ValueError, match="no statistics"):
            cb.bn_stats_plan(*bad)
    with pytest.raises(ValueError, match="no statistics"):
        cb.bn_stats_plan(2, 16, 3, False, True, SMS, 0)
    # E off a load's values: the scalar mode, whatever the pointer
    assert cb.bn_stats_plan(2, 7, 3, False, True).mode == "scalar"
    assert cb.bn_stats_plan(2, 4, 17, False, True).mode == "scalar"
    assert cb.bn_stats_plan(2, 8, 2, True, True).mode == "scalar"


# -- the kernel's order, emulated -----------------------------------------------


def _bf16(a):
    """Round f32 to the nearest bf16 (ties to even), kept as f32."""
    return torch.from_numpy(np.array(a, dtype=f32)).to(
        torch.bfloat16).float().numpy()


def _fma(a, b, c):
    """f32 fmaf: the product and the sum in f64, rounded once."""
    return (a.astype(np.float64) * b + c).astype(f32)


def _merge(a, b):
    """The kernel's ``merge`` of (n, mean, m2) ``a`` with ``b`` after it,
    elementwise (Chan's, one division): an empty ``b`` leaves ``a``."""
    n, m, q = a
    nb, mb, qb = b
    nn = n + nb
    w = nb / np.where(nn == 0, f32(1), nn)
    d = mb - m
    merged = (nn, _fma(d, w, m), q + (qb + d * d * n * w))
    return tuple(np.where(nb == 0, old, new).astype(f32)
                 for old, new in zip(a, merged))


def _tree(parts, width):
    """Lane 0 of a shuffle-down tree of merges over the last axis (width
    lanes): lane l takes lane l + stride after itself, strides width / 2
    .. 1."""
    parts = [np.array(p) for p in parts]
    off = width // 2
    while off:
        head = _merge(tuple(p[..., :off] for p in parts),
                      tuple(p[..., off:2 * off] for p in parts))
        for p, h in zip(parts, head):
            p[..., :off] = h
        off //= 2
    return tuple(p[..., 0] for p in parts)


def _lanes_then_tree(parts, width):
    """``width`` lanes' merge of partials (..., k) in order: lane l the
    partials l, l + width, ..., then the tree."""
    k = parts[0].shape[-1]
    lanes = [np.zeros(parts[0].shape[:-1] + (width,), f32)
             for _ in range(3)]
    for i in range(k):
        cur = tuple(lane[..., i % width] for lane in lanes)
        new = _merge(cur, tuple(p[..., i] for p in parts))
        for lane, v in zip(lanes, new):
            lane[..., i % width] = v
    return _tree(lanes, width)


def _channel_lanes(C):
    """The lanes of a channel in the block's merge: the largest power of
    two <= 32 with C of them within the block's 256 threads."""
    lanes = 32
    while lanes * C > cb.BN_STATS_THREADS:
        lanes //= 2
    return lanes


def _fold_block(vals, plan):
    """Each live thread's (n, mean (chans,), m2 (chans,)) over the block's
    units ``vals`` (units, W): thread tid the units tid, tid + threads,
    ..., G a group."""
    units = vals.shape[0]
    th, chans, W = plan.threads, plan.chans, plan.unit * plan.vec
    G = cb.BN_STATS_GROUP[plan.unit]
    per = W // chans
    k_max = -(-units // th)
    idx = np.arange(th)[:, None] + th * np.arange(k_max)[None, :]
    valid = idx < units
    v = np.where(valid[..., None], vals[np.minimum(idx, units - 1)], f32(0))
    n = np.zeros(th, f32)
    mean = np.zeros((th, chans), f32)
    m2 = np.zeros((th, chans), f32)
    for g0 in range(0, k_max, G):
        ks = range(g0, min(g0 + G, k_max))
        live = valid[:, g0:g0 + G].sum(1)
        run = live > 0
        nb = (live * per).astype(f32)
        inv = f32(1) / np.where(run, nb, f32(1))
        s = np.zeros((th, chans), f32)
        for k in ks:
            for i in range(W):
                s[:, i % chans] = s[:, i % chans] + v[:, k, i]
        mb = s * inv[:, None]
        q2 = np.zeros((th, chans), f32)
        for k in ks:
            for i in range(W):
                d = v[:, k, i] - mb[:, i % chans]
                q2[:, i % chans] = np.where(valid[:, k], _fma(
                    d, d, q2[:, i % chans]), q2[:, i % chans])
        nn = n + nb
        w = nb / np.where(run, nn, f32(1))
        nw = n * w
        d = mb - mean
        mean = np.where(run[:, None], _fma(d, w[:, None], mean), mean)
        m2 = np.where(run[:, None], m2 + (q2 + d * d * nw[:, None]), m2)
        n = np.where(run, nn, n)
    return n, mean, m2


def _emulated_stats(x, plan, C, eps, bf16):
    """The statistics of x (T, E) in the kernel's order (f32)."""
    T = x.shape[0]
    W = plan.unit * plan.vec
    lanes = _channel_lanes(C)
    parts = [np.zeros((T, plan.splits, C), f32) for _ in range(3)]
    for t in range(T):
        units = x[t].reshape(plan.units, W)
        for s in range(plan.splits):
            first = s * plan.chunk
            n, mean, m2 = _fold_block(
                units[first:min(first + plan.chunk, plan.units)], plan)
            for c in range(C):
                slot, j = divmod(c, plan.chans)
                th = slot + plan.slots * np.arange(plan.threads // plan.slots)
                st = _lanes_then_tree((n[th], mean[th, j], m2[th, j]),
                                      lanes)
                for p, v in zip(parts, st):
                    p[t, s, c] = v
    if plan.splits == 1:
        n, mean, m2 = (p[:, 0] for p in parts)
    else:
        n, mean, m2 = _lanes_then_tree(tuple(
            p.transpose(0, 2, 1) for p in parts), 32)  # the splits last
    var = m2 / n
    if not bf16:
        return mean, var, f32(1) / np.sqrt(var + f32(eps))
    vb = _bf16(var)
    return _bf16(mean), vb, _bf16(f32(1) / np.sqrt(_bf16(vb + f32(eps))))


def _close(got, want, what):
    got = torch.as_tensor(np.asarray(got, dtype=np.float64))
    want = torch.as_tensor(want).double()
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    assert err <= ATOL + RTOL * scale, (what, err, scale)


def _within_ulp(got, want, what):
    """Within one bf16 ulp of the twin (or 1e-4 of its scale)."""
    got = torch.as_tensor(np.asarray(got, dtype=np.float64))
    want = want.double()
    _, e = torch.frexp(want.abs().clamp_min(2.0 ** -126))
    tol = torch.ldexp(torch.ones_like(want), e - 8)
    tol = tol.clamp_min(1e-4 * want.abs().max().item())
    assert bool(((got - want).abs() <= tol).all()), (
        what, (got - want).abs().max().item())


def _image(T, N, H, W, C, seed, bf16):
    """Pixels in [0, 1] at C <= 3, else activations with an offset (numpy
    f32, bf16 values in bf16) and the tensor in the dtype."""
    rng = np.random.RandomState(seed)
    x = (rng.rand(T, N, H, W, C) if C <= 3
         else 2.0 + rng.randn(T, N, H, W, C)).astype(f32)
    if bf16:
        x = _bf16(x)
    return x, torch.from_numpy(x).to(torch.bfloat16 if bf16 else
                                     torch.float32)


# (T, N, H, W, C, vec, sms): every mode and both routes at small maps (few
# SMs make the grid route at sizes the emulation takes): packed3 and
# packed1 split and whole, lanes at 48 and 64 channels (12 and 16 slots in
# f32, 6 and 8 in bf16), the scalar mode at 17 channels, off alignment at
# 3 and 48, one tenant of many blocks, a grid the card caps
EMULATED = [
    (2, 5, 64, 64, 3, True, 4),
    (2, 3, 8, 8, 3, True, 4),
    (2, 40, 28, 28, 1, True, 4),
    (3, 20, 28, 28, 1, True, 132),
    (2, 4, 10, 10, 48, True, 4),
    (2, 5, 12, 12, 64, True, 4),
    (2, 10, 8, 8, 17, True, 4),
    (2, 4, 7, 6, 17, True, 132),
    (2, 3, 9, 9, 3, False, 4),
    (2, 6, 10, 10, 48, False, 4),
    (1, 8, 32, 32, 48, True, 132),
    (4, 6, 16, 16, 64, True, 2),
]


def _emulated_plan(shape, bf16):
    T, N, H, W, C, vec, sms = shape
    return cb.bn_stats_plan(T, N * H * W, C, bf16, vec, sms, 2)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", EMULATED, ids=str)
def test_emulated_stats_equal_the_twin(shape, dtype):
    T, N, H, W, C, _, _ = shape
    bf16 = DTYPES[dtype]
    plan = _emulated_plan(shape, bf16)
    x, xt = _image(T, N, H, W, C, sum(shape[:5]), bf16)
    eps = F.scalar_like(F.BN_EPS, xt)
    got = _emulated_stats(x.reshape(T, -1), plan, C, eps, bf16)
    for g, w, what in zip(got, F.bn_input_stats(xt), ("mean", "var",
                                                        "rstd")):
        if bf16:
            _within_ulp(g, w, what)
        else:
            _close(g, w, what)


def test_emulated_stats_take_every_mode_and_route():
    seen = {(p.mode, p.route) for shape in EMULATED
            for bf16 in (False, True)
            for p in [_emulated_plan(shape, bf16)]}
    assert {m for m, _ in seen} == set(cb.BN_STATS_MODES)
    assert ("packed3", "grid") in seen and ("lanes", "grid") in seen
    assert ("packed1", "block") in seen and ("scalar", "grid") in seen


def test_emulated_stats_equal_the_jax_batch_norm_statistics():
    """At a small map on the grid route (packed3: the image's three
    channels), the emulated mean, variance and rstd against the JAX
    package's ``batch_norm`` per tenant: its normalized output at gamma 1,
    beta 0 (``lax.rsqrt(var + eps)``) and its running statistics at
    momentum 1 (the batch mean, and the unbiased ``jnp.var``)."""
    T, N, H, W, C = 2, 5, 64, 64, 3
    plan = cb.bn_stats_plan(T, N * H * W, C, False, True, 4, 2)
    assert plan.route == "grid" and plan.mode == "packed3"
    x, _ = _image(T, N, H, W, C, 11, False)
    mean, var, rstd = _emulated_stats(x.reshape(T, -1), plan, C, F.BN_EPS,
                                      False)
    m = N * H * W
    for t in range(T):
        y, run_mean, run_var = JF.batch_norm(
            jnp.asarray(x[t]), jnp.ones(C), jnp.zeros(C), jnp.zeros(C),
            jnp.zeros(C), momentum=1.0, eps=F.BN_EPS)
        _close(mean[t], np.array(run_mean), "mean")
        _close(var[t], np.array(run_var) * ((m - 1) / m), "var")
        _close((x[t] - mean[t]) * rstd[t], np.array(y), "normalized")


# -- the global average pool ----------------------------------------------------


def _emulated_gap(x):
    """x (T, N, H, W, C) -> (T, N, C): each image's pixels summed in pixel
    order in f32, over an f32 division by H * W."""
    T, N, H, W, C = x.shape
    s = np.zeros((T, N, C), f32)
    for p in x.reshape(T, N, H * W, C).transpose(2, 0, 1, 3):
        s = s + p
    return s / f32(H * W)


@pytest.mark.parametrize("shape", [(8, 20, 2, 2, 64), (2, 5, 4, 4, 48),
                                   (2, 3, 5, 7, 3), (1, 1, 1, 1, 1)],
                         ids=str)
def test_emulated_gap_equals_the_twins(shape):
    """The forward in pixel order against the twin (f32 within the gate;
    bf16, one rounding of the exact f32 sum, bit for bit), the backward's
    one division a value against the twin's (bit for bit in both)."""
    T, N, H, W, C = shape
    rng = np.random.RandomState(sum(shape))
    x = rng.randn(*shape).astype(f32)
    g = rng.randn(T, N, C).astype(f32)
    _close(_emulated_gap(x), F.global_avg_pool2d(torch.from_numpy(x)),
           "gap f32")
    xb, gb = _bf16(x), _bf16(g)
    want = F.global_avg_pool2d(torch.from_numpy(xb).bfloat16())
    assert np.array_equal(_bf16(_emulated_gap(xb)), want.float().numpy())
    for gg, dtype in ((g, torch.float32), (gb, torch.bfloat16)):
        twin = F.global_avg_pool2d_bwd(torch.from_numpy(gg).to(dtype), H, W)
        got = np.broadcast_to((gg / f32(H * W))[:, :, None, None, :],
                              shape)
        if dtype == torch.bfloat16:
            got = _bf16(got)
        assert np.array_equal(got, twin.float().numpy())


def test_emulated_gap_equals_the_jax_mean_and_its_vjp():
    """The emulated forward against ``global_avg_pool2d`` (``jnp.mean``
    over H and W) and the backward's ``g / (H W)`` against its
    ``jax.vjp``, per tenant, in f32."""
    T, N, H, W, C = 2, 5, 4, 4, 48
    rng = np.random.RandomState(13)
    x = rng.randn(T, N, H, W, C).astype(f32)
    g = rng.randn(T, N, C).astype(f32)
    out = _emulated_gap(x)
    for t in range(T):
        y, vjp = jax.vjp(JF.global_avg_pool2d, jnp.asarray(x[t]))
        _close(out[t], np.array(y).reshape(N, C), "gap")
        (dx,) = vjp(jnp.asarray(g[t].reshape(N, 1, 1, C)))
        _close(np.broadcast_to((g[t] / f32(H * W))[:, None, None, :],
                               (N, H, W, C)), np.array(dx), "gap vjp")
