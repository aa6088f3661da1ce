"""The pool-free K3 and K5 (csrc/bn_act_bwd.cu: ``bn_act_bwd`` and
``bn_act_bwd_bwd``, and at slope 1 ``batch_norm_bwd`` and
``batch_norm_bwd_bwd``) and ``act_bwd`` (csrc/act.cu), on the CPU.

The K3 launch plan (``conv_block.bn_act_bwd_plan``, ``bn_input_stats``'
units and routes with K3's constants) at every shape the port's models
give it — the strided Omniglot conv outputs (14/7/4/2 x 64), the unpadded
strided mini-ImageNet ones (41/20/9/4 x 48) and every norm-first block
input (the 84 x 84 x 3 image, 42/21/10 x 48 pooled, 41/19/8 x 48
unpadded, the strided model's 28 x 28 x 1 image and 14/7/4 x 64, the
unpadded strided 20/9 x 48) — at T = 2, 8 and 256 and N = 5, 20, 25, 75
and 100, in f32 and bf16, with and without 16-byte loads: every value in
one block's chunk, each thread's channels fixed, the cooperative grid
within the card, shared memory within a block's, and the stage (a
block's packets of da and y kept in shared memory from the reduce to the
apply) wherever it fits on the grid route in one wave. The constants are
the
kernel's (pinned to the source). Then the kernel's order (the same with
and without the stage) emulated in numpy
from the plan — each thread's dz and dz xhat summed over its units in
(unit, value) order (the masks K2's: the f32 FMA, or the bf16 chain with
each op rounded), a channel's threads summed in thread order by L lanes
and a shuffle tree, a tenant's blocks by 32 lanes and a tree, then the
apply on the sums — held to the twin (``ops/functional.py::bn_act_bwd``,
``::batch_norm_bwd``: f32 within 1e-5 + 1e-4 * scale, bf16 within one
bf16 ulp) at every mode and route and at slopes 0.01 and 1; at one small
map cut over several blocks to ``jax.vjp`` of the JAX package's
``batch_norm`` -> ``leaky_relu`` (run eagerly on the CPU); and the port's
``act_bwd`` twin to ``jax.vjp`` of ``leaky_relu``, bit for bit in f32 and
bf16.

K5 likewise: its plan (K3's layout with three tensors: the stage holds a
block's packets of a, da and y within ``BN_ACT_BWD_BWD_STAGE_BYTES``, the
static arrays within a block's 48 KB) at every shape the models give it,
every value covered once; the kernel's order emulated in numpy (the five
sums of each thread in (unit, value) order, the block's and the grid's
merges as K3's, the coefficients and the apply) against the twin
(``::bn_act_bwd_bwd``, ``::batch_norm_bwd_bwd``) at every mode and route
and at both slopes, and at a small map cut over several blocks to the
JAX package's own second derivative (``jax.vjp`` of the ``jax.vjp`` of
``batch_norm`` -> ``leaky_relu``, run eagerly), in f32.

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
BLOCK_SMEM = 232448  # shared memory a block may take in all
# (H = W, C) of every tensor the pool-free K3 takes: the strided Omniglot
# conv outputs, the unpadded strided mini-ImageNet conv outputs, and the
# norm-first models' block inputs (batch_norm_bwd)
MAPS = ((14, 64), (7, 64), (4, 64), (2, 64),
        (41, 48), (20, 48), (9, 48), (4, 48),
        (84, 3), (42, 48), (21, 48), (10, 48),
        (19, 48), (8, 48),
        (28, 1))
TENANTS = (2, 8, 256)
IMAGES = (5, 20, 25, 75, 100)
DTYPES = {"f32": False, "bf16": True}
BLOCKS_PER_SM = (1, 2, 3)
SLOPES = (F.LEAKY_SLOPE, 1.0)
RTOL, ATOL = 1e-4, 1e-5  # the card's twin gate
f32 = np.float32


def _values(bf16):
    return 8 if bf16 else 4  # a 16-byte load


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("hw_c", MAPS, ids=str)
def test_k3_plan_covers_each_value_once_and_fits_the_card(hw_c, dtype):
    hw, C = hw_c
    bf16 = DTYPES[dtype]
    for T in TENANTS:
        for N in IMAGES:
            P, E = N * hw * hw, N * hw * hw * C
            for vec in (True, False):
                for bps in BLOCKS_PER_SM:
                    p = cb.bn_act_bwd_plan(T, P, C, bf16, vec, SMS, bps)
                    assert p.mode == cb.bn_stats_mode(C, E, bf16, vec)
                    if vec and C in (1, 3):
                        assert p.mode == f"packed{C}"
                        assert p.vec == _values(bf16)
                    elif vec:
                        assert p.mode == "lanes" and C % p.vec == 0
                    else:
                        assert p.mode == "scalar" and p.vec == 1
                    # whole units; a thread's chans channels fixed
                    W = p.unit * p.vec
                    assert p.units * W == E and p.slots * p.chans == C
                    assert W % p.chans == 0
                    assert p.threads % p.slots == 0
                    assert cb.BN_ACT_BWD_THREADS - p.slots < p.threads
                    assert p.threads <= cb.BN_ACT_BWD_THREADS
                    assert p.chunk % p.slots == 0
                    # the chunks partition a tenant's units, none empty
                    assert ((p.splits - 1) * p.chunk < p.units
                            <= p.splits * p.chunk)
                    assert p.grid == T * p.splits
                    loads = p.units * p.unit
                    if p.route == "grid":
                        # every block resident at once (the grid barrier)
                        assert p.splits > 1
                        assert p.grid <= SMS * min(bps, 2)
                        assert loads > (p.threads
                                        * cb.BN_ACT_BWD_BLOCK_LOADS)
                    else:
                        assert p.splits == 1
                        assert (loads <= p.threads
                                * cb.BN_ACT_BWD_BLOCK_LOADS
                                or T > SMS // 2)
                    # static shared memory: each thread's two sums a
                    # channel, and the block route's (2, 256) sums
                    static = (4 * cb.BN_ACT_BWD_THREADS * 2 * p.chans
                              + 4 * 2 * cb.BN_ACT_BWD_MAX_C)
                    assert static <= STATIC_SMEM
                    # the stage: every packet of da and y of each thread's
                    # units, wherever it fits, on the grid route in one
                    # wave with 16-byte loads; within a block's memory
                    need = (-(-p.chunk // p.threads) * p.unit * 2
                            * p.threads * 16)
                    can = (p.route == "grid" and p.mode != "scalar"
                           and p.grid <= SMS)
                    assert p.stage == (
                        need if can and need <= cb.BN_ACT_BWD_STAGE_BYTES
                        else 0)
                    assert static + p.stage <= BLOCK_SMEM


def test_k3_plan_routes_at_the_model_shapes():
    """At T = 8 (N = 20 at Omniglot's 64 channels and 28 x 28 image, 25
    at mini-ImageNet's) the maps of a tenant over 20 loads a thread take
    the grid route (strided L1, the image, norm-first stage 3), the
    smallest a block a tenant (strided L3-L4); and the images' one and
    three channels load at full width (packed1, packed3)."""
    route = {(hw, c): cb.bn_act_bwd_plan(
        8, (20 if c in (1, 64) else 25) * hw * hw, c) for hw, c in MAPS}
    assert route[(14, 64)].route == "grid"
    assert route[(84, 3)].route == "grid"
    assert route[(84, 3)].mode == "packed3"
    assert route[(28, 1)].mode == "packed1"
    assert route[(10, 48)].route == "grid"
    for hw_c in ((4, 64), (2, 64)):
        assert route[hw_c].route == "block"
    # strided L1 and L2 keep their chunks in shared memory; the image in
    # f32 (270 KB a block) does not, in bf16 it does
    assert route[(14, 64)].stage and route[(7, 64)].stage
    assert not route[(84, 3)].stage
    assert cb.bn_act_bwd_plan(8, 25 * 84 * 84, 3, True).stage


def test_constants_are_the_kernels():
    """The plan's and the emulation's constants are the ones the kernels
    are compiled with (csrc/bn_act_bwd.cu, csrc/act.cu): a block's
    threads, the most channels, the units a group by the loads a unit."""
    csrc = pathlib.Path(cb.__file__).parent / "csrc"
    src = (csrc / "bn_act_bwd.cu").read_text()
    one, three = re.search(r"constexpr int G = U == 1 \? (\d+) : (\d+);",
                           src).groups()
    assert cb.BN_ACT_BWD_GROUP == {1: int(one), 3: int(three)}
    assert re.search(r"constexpr int kThreads = (\d+);", src).group(1) == \
        str(cb.BN_ACT_BWD_THREADS)
    assert re.search(r"constexpr int kMaxC = (\d+);", src).group(1) == \
        str(cb.BN_ACT_BWD_MAX_C)
    modes = re.search(r"enum Mode \{ kScalar = 0, kLanes = 1, kPacked1 = 2, "
                      r"kPacked3 = 3 \};", src)
    assert modes and cb.BN_STATS_MODES == ("scalar", "lanes", "packed1",
                                           "packed3")
    act = (csrc / "act.cu").read_text()
    assert re.search(r"constexpr int kThreads = (\d+);", act).group(1) == \
        str(cb.ACT_THREADS)


def test_k3_plan_refuses_what_the_kernel_does_not_take():
    for bad in ((0, 16, 3), (2, 0, 3), (2, 16, 0), (2, 16, 257)):
        with pytest.raises(ValueError, match="no pool-free K3"):
            cb.bn_act_bwd_plan(*bad)
    with pytest.raises(ValueError, match="no pool-free K3"):
        cb.bn_act_bwd_plan(2, 16, 3, False, True, SMS, 0)
    # E off a load's values: the scalar mode, whatever the pointers
    assert cb.bn_act_bwd_plan(2, 7, 3, False, True).mode == "scalar"
    assert cb.bn_act_bwd_plan(2, 8, 2, True, True).mode == "scalar"


# -- the kernel's order, emulated -----------------------------------------------


def _bf16(a):
    """Round f32 to the nearest bf16 (ties to even), kept as f32."""
    return torch.from_numpy(np.asarray(a, dtype=f32)).to(
        torch.bfloat16).float().numpy()


def _fma(a, b, c):
    """f32 fmaf: the product exact in f64, the sum rounded (f64, then
    f32: the sign, which the masks read, is exact)."""
    return (a.astype(np.float64) * b + c).astype(f32)


def _terms(x, da, mean, rstd, gamma, beta, slope, bf16):
    """xhat and dz of every value, (T, E) f32: channel e mod C; the mask
    K2's (the f32 FMA, or the bf16 chain)."""
    C = mean.shape[1]
    ch = np.arange(x.shape[1]) % C
    m, r, g, b = (v[:, ch] for v in (mean, rstd, gamma, beta))
    xh = (x - m) * r
    if bf16:
        z = _bf16(_bf16(_bf16(_bf16(x - m) * r) * g) + b)
    else:
        z = _fma(xh, g, b)
    return xh, np.where(z >= 0, da, da * f32(slope)).astype(f32)


def _tree(lanes):
    """Lane 0 of a shuffle-down tree of sums over the last axis."""
    lanes = np.array(lanes)
    off = lanes.shape[-1] // 2
    while off:
        lanes[..., :off] = lanes[..., :off] + lanes[..., off:2 * off]
        off //= 2
    return lanes[..., 0]


def _lanes_then_tree(parts, width):
    """``width`` lanes' sum of partials (..., k) in order: lane l the
    partials l, l + width, ..., then the tree."""
    lanes = np.zeros(parts.shape[:-1] + (width,), f32)
    for i in range(parts.shape[-1]):
        lanes[..., i % width] = lanes[..., i % width] + parts[..., i]
    return _tree(lanes)


def _channel_lanes(C):
    lanes = 32
    while lanes * C > cb.BN_ACT_BWD_THREADS:
        lanes //= 2
    return lanes


def _block_sums(xh, dz, plan, C):
    """One block's (2, C) sums of dz and dz xhat over its units (units,
    W): thread tid the units tid, tid + threads, ... in (unit, value)
    order, then L lanes a channel over the threads of its slot."""
    th, chans, W = plan.threads, plan.chans, plan.unit * plan.vec
    units = xh.shape[0]
    sums = np.zeros((2, th, chans), f32)
    for k in range(-(-units // th)):
        idx = np.arange(th) + k * th
        valid = idx < units
        idx = np.minimum(idx, units - 1)
        for i in range(W):
            d, x = dz[idx, i], xh[idx, i]
            j = i % chans
            sums[0, :, j] = np.where(valid, sums[0, :, j] + d, sums[0, :, j])
            sums[1, :, j] = np.where(valid, _fma(d, x, sums[1, :, j]),
                                     sums[1, :, j])
    c = np.arange(C)
    slot, j = c // chans, c % chans
    threads = slot[:, None] + plan.slots * np.arange(th // plan.slots)
    return _lanes_then_tree(sums[:, threads, j[:, None]], _channel_lanes(C))


def _emulated_k3(plan, da, x, mean, rstd, gamma, beta, slope):
    """The kernel's (dy, dgamma, dbeta) from the twin's inputs (torch,
    f32 or bf16), in its order."""
    bf16 = x.dtype == torch.bfloat16
    T, N, H, W, C = x.shape
    flat = [v.float().numpy().reshape(T, -1) for v in (x, da)]
    tab = [v.float().numpy() for v in (mean, rstd, gamma, beta)]
    xh, dz = _terms(*flat, *tab, slope, bf16)
    Wu = plan.unit * plan.vec
    xh_u, dz_u = (v.reshape(T, plan.units, Wu) for v in (xh, dz))
    part = np.zeros((T, plan.splits, 2, C), f32)
    for t in range(T):
        for s in range(plan.splits):
            lo, hi = s * plan.chunk, min((s + 1) * plan.chunk, plan.units)
            part[t, s] = _block_sums(xh_u[t, lo:hi], dz_u[t, lo:hi], plan, C)
    if plan.splits == 1:
        tot = part[:, 0]
    else:
        tot = _lanes_then_tree(part.transpose(0, 2, 3, 1), 32)
    inv_m = f32(1.0 / (N * H * W))
    m, r, g, b = tab
    grs = g * r
    ch = np.arange(xh.shape[1]) % C
    mdz, mdx = tot[:, 0] * inv_m, tot[:, 1] * inv_m
    dy = grs[:, ch] * _fma(-xh, mdx[:, ch], dz - mdz[:, ch])
    out = (dy.reshape(x.shape), tot[:, 1], tot[:, 0])
    return tuple(_bf16(v) if bf16 else v for v in out)


def _close(got, want, what):
    got = torch.as_tensor(np.asarray(got, dtype=np.float64))
    want = torch.as_tensor(np.asarray(want, dtype=np.float64))
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


def _inputs(T, N, H, W, C, seed, bf16):
    """da, x and its statistics, gamma, beta (the twin's argument order),
    from a numpy seed: pixels in [0, 1] at C <= 3, else activations with an
    offset; bf16 values rounded to bf16."""
    rng = np.random.RandomState(seed)
    dtype = torch.bfloat16 if bf16 else torch.float32

    def t(a):
        return torch.from_numpy(a.astype(f32)).to(dtype)

    x = t(rng.rand(T, N, H, W, C) if C <= 3
          else 0.5 + 2.0 * rng.randn(T, N, H, W, C))
    mean, _, rstd = F.bn_input_stats(x)
    gamma = t(1.0 + 0.1 * rng.randn(T, C))
    beta = t(0.1 * rng.randn(T, C))
    da = t(rng.randn(T, N, H, W, C))
    return da, x, mean, rstd, gamma, beta


# (T, N, H, W, C, vec, sms): every mode and both routes at small maps (few
# SMs make the grid route at sizes the emulation takes): packed3 and
# packed1 split and whole, lanes at 48 and 64 channels, the scalar mode at
# 17 channels and off alignment at 3 and 48, a tenant of many blocks (more
# than 32: the merge's lanes take several each), odd maps
EMULATED = [
    (2, 5, 64, 64, 3, True, 4),
    (2, 3, 8, 8, 3, True, 132),
    (2, 40, 28, 28, 1, True, 4),
    (3, 5, 7, 7, 1, True, 132),
    (2, 6, 12, 12, 48, True, 4),
    (2, 5, 7, 7, 64, True, 132),
    (2, 10, 8, 8, 17, True, 4),
    (2, 3, 9, 9, 3, False, 4),
    (2, 6, 10, 10, 48, False, 4),
    (1, 20, 14, 14, 64, True, 80),
]


def _emulated_plan(shape, bf16):
    T, N, H, W, C, vec, sms = shape
    return cb.bn_act_bwd_plan(T, N * H * W, C, bf16, vec, sms, 2)


@pytest.mark.parametrize("slope", SLOPES, ids=("leaky", "slope1"))
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", EMULATED, ids=str)
def test_emulated_k3_equals_the_twin(shape, dtype, slope):
    T, N, H, W, C, _, _ = shape
    bf16 = DTYPES[dtype]
    plan = _emulated_plan(shape, bf16)
    args = _inputs(T, N, H, W, C, sum(shape[:5]), bf16)
    s = F.scalar_like(slope, args[1])
    got = _emulated_k3(plan, *args, s)
    want = (F.bn_act_bwd(*args, slope) if slope != 1.0
            else F.batch_norm_bwd(*args))
    for g, w, what in zip(got, want, ("dy", "dgamma", "dbeta")):
        if bf16:
            _within_ulp(g, w, what)
        else:
            _close(g, w, what)


def test_emulated_k3_takes_every_mode_and_route():
    seen = {(p.mode, p.route) for shape in EMULATED
            for bf16 in (False, True)
            for p in [_emulated_plan(shape, bf16)]}
    assert {m for m, _ in seen} == set(cb.BN_STATS_MODES)
    assert {r for _, r in seen} == {"block", "grid"}
    assert ("packed3", "grid") in seen and ("lanes", "grid") in seen
    assert ("packed1", "grid") in seen and ("scalar", "grid") in seen
    assert max(_emulated_plan(s, False).splits for s in EMULATED) > 32
    # the staged apply reads the same packets: the emulation is both's
    stages = {bool(_emulated_plan(s, bf16).stage) for s in EMULATED
              for bf16 in (False, True)}
    assert stages == {False, True}


def _jax_block(slope):
    def block(x, gamma, beta):
        z, _, _ = JF.batch_norm(x, gamma, beta, None, None, eps=F.BN_EPS)
        return JF.leaky_relu(z, slope)
    return block


@pytest.mark.parametrize("slope", SLOPES, ids=("leaky", "slope1"))
def test_emulated_k3_equals_the_jax_vjp(slope):
    """At a small map cut over several blocks (the grid route, lanes of
    48 channels), the emulated K3 against ``jax.vjp`` of the JAX package's
    ``batch_norm`` (batch statistics) -> ``leaky_relu`` per tenant, in
    f32, within the card's f32 gate (1e-5 + 1e-4 * scale): the JAX side
    takes its own statistics (``jnp.mean``, ``jnp.var``, ``lax.rsqrt``)."""
    shape = (2, 6, 12, 12, 48, True, 4)
    T, N, H, W, C, _, _ = shape
    plan = _emulated_plan(shape, False)
    assert plan.route == "grid" and plan.mode == "lanes"
    da, x, mean, rstd, gamma, beta = _inputs(T, N, H, W, C, 7, False)
    got = _emulated_k3(plan, da, x, mean, rstd, gamma, beta, slope)
    for t in range(T):
        _, vjp = jax.vjp(_jax_block(slope), *(
            jnp.asarray(v[t].numpy()) for v in (x, gamma, beta)))
        want = vjp(jnp.asarray(da[t].numpy()))
        for g, w, what in zip((v[t] for v in got), want,
                              ("dy", "dgamma", "dbeta")):
            _close(g, np.array(w), what)


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_act_bwd_twin_equals_the_jax_vjp_bit_for_bit(dtype):
    """``F.act_bwd`` (csrc/act.cu's twin, which the kernel equals bit for
    bit on the card) against ``jax.vjp`` of the JAX package's
    ``leaky_relu`` in the same dtype: equal, every value."""
    rng = np.random.RandomState(3)
    y = rng.randn(2, 5, 7, 7, 64).astype(f32)
    da = rng.randn(*y.shape).astype(f32)
    ty, tda = (torch.from_numpy(v).to(getattr(torch, dtype))
               for v in (y, da))
    jy, jda = (jnp.asarray(v.float().numpy()).astype(dtype)
               for v in (ty, tda))
    _, vjp = jax.vjp(lambda v: JF.leaky_relu(v, F.LEAKY_SLOPE), jy)
    (want,) = vjp(jda)
    got = F.act_bwd(tda, ty)
    assert got.dtype == ty.dtype
    assert np.array_equal(got.float().numpy(),
                          np.asarray(want.astype(jnp.float32)))


# -- K5 pool-free: the plan --------------------------------------------------

K5_STATIC_SMEM = 48 * 1024  # static shared memory a block may take


def _k5_static(chans):
    """K5's static shared memory: one round of the block's sums
    (``ss[CH][256]``) and the (13, 256) table of per-channel values."""
    return 4 * (cb.BN_ACT_BWD_THREADS * chans
                + cb.BN_ACT_BWD_BWD_COEFS * cb.BN_ACT_BWD_MAX_C)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("hw_c", MAPS, ids=str)
def test_k5_plan_covers_each_value_once_and_fits_the_card(hw_c, dtype):
    """K5's plan is K3's layout (the same units and modes: every value in
    one block's chunk, each thread's channels fixed, the cooperative grid
    within the card) with its own block-route threshold and a stage of
    three tensors, wherever it fits in K5's budget; static and dynamic
    shared memory within a block's."""
    hw, C = hw_c
    bf16 = DTYPES[dtype]
    for T in TENANTS:
        for N in IMAGES:
            P = N * hw * hw
            for vec in (True, False):
                for bps in BLOCKS_PER_SM:
                    p = cb.bn_act_bwd_bwd_plan(T, P, C, bf16, vec, SMS, bps)
                    k3 = cb.bn_act_bwd_plan(T, P, C, bf16, vec, SMS, bps)
                    assert (p.mode, p.vec, p.unit, p.chans, p.slots,
                            p.threads, p.units) == (
                        k3.mode, k3.vec, k3.unit, k3.chans, k3.slots,
                        k3.threads, k3.units)
                    assert p.chunk % p.slots == 0
                    assert p.units * p.unit * p.vec == P * C
                    assert ((p.splits - 1) * p.chunk < p.units
                            <= p.splits * p.chunk)
                    assert p.grid == T * p.splits
                    loads = p.units * p.unit
                    if p.route == "grid":
                        assert p.grid <= SMS * min(bps, 2)
                        assert loads > (p.threads
                                        * cb.BN_ACT_BWD_BWD_BLOCK_LOADS)
                    else:
                        assert (loads <= p.threads
                                * cb.BN_ACT_BWD_BWD_BLOCK_LOADS
                                or T > SMS // 2)
                    static = _k5_static(p.chans)
                    assert static <= K5_STATIC_SMEM
                    need = (-(-p.chunk // p.threads) * p.unit * 3
                            * p.threads * 16)
                    can = (p.route == "grid" and p.mode != "scalar"
                           and p.grid <= SMS)
                    assert p.stage == (
                        need if can and need <= cb.BN_ACT_BWD_BWD_STAGE_BYTES
                        else 0)
                    assert static + p.stage <= BLOCK_SMEM


def test_k5_plan_routes_at_the_model_shapes():
    """At T = 8: strided L1-L3 (14/7/4 x 64, N = 20) stage their chunks
    of a, da and y on the grid route, L4 (five loads a thread) takes a
    block a tenant; the norm-first stage 1 (42 x 42 x 48, N = 25) takes
    two waves (it cannot stage), the image one wave of the packed3 mode,
    its bf16 stage 2 stages; the strided norm-first image (28 x 28 x 1)
    the grid route in the packed1 mode."""
    def plan(hw, C, N, bf16=False):
        return cb.bn_act_bwd_bwd_plan(8, N * hw * hw, C, bf16)

    for hw in (14, 7, 4):
        assert plan(hw, 64, 20).route == "grid" and plan(hw, 64, 20).stage
    assert plan(2, 64, 20).route == plan(2, 64, 20, True).route == "block"
    nf1 = plan(42, 48, 25)
    assert nf1.splits == 2 * SMS // 8 and not nf1.stage
    image = plan(84, 3, 25)
    assert image.mode == "packed3" and image.route == "grid"
    assert not plan(21, 48, 25).stage and plan(21, 48, 25, True).stage
    small = plan(28, 1, 20)
    assert small.mode == "packed1" and small.route == "grid"


def test_k5_constants_are_the_kernels():
    """K5's constants are those it is compiled with (csrc/bn_act_bwd.cu):
    the units a group by the loads a unit, its sums and table rows; its
    stage budget keeps a block within its shared memory."""
    src = (pathlib.Path(cb.__file__).parent / "csrc"
           / "bn_act_bwd.cu").read_text()
    one, three = re.search(
        r"constexpr int G5 = U == 1 \? (\d+) : (\d+);", src).groups()
    assert cb.BN_ACT_BWD_BWD_GROUP == {1: int(one), 3: int(three)}
    assert re.search(r"constexpr int kSums5 = (\d+);", src).group(1) == \
        str(cb.BN_ACT_BWD_BWD_SUMS)
    assert re.search(r"constexpr int kCoefs5 = (\d+);", src).group(1) == \
        str(cb.BN_ACT_BWD_BWD_COEFS)
    assert _k5_static(8) + cb.BN_ACT_BWD_BWD_STAGE_BYTES <= BLOCK_SMEM


def test_k5_plan_refuses_what_the_kernel_does_not_take():
    for bad in ((0, 16, 3), (2, 0, 3), (2, 16, 0), (2, 16, 257)):
        with pytest.raises(ValueError, match="no pool-free K5"):
            cb.bn_act_bwd_bwd_plan(*bad)
    with pytest.raises(ValueError, match="no pool-free K5"):
        cb.bn_act_bwd_bwd_plan(2, 16, 3, False, True, SMS, 0)
    # more channels than the Triton kernel took (64): a plan, up to 256
    assert cb.bn_act_bwd_bwd_plan(2, 16, 256).mode == "lanes"
    assert cb.bn_act_bwd_bwd_plan(2, 16, 100, True).mode == "scalar"


# -- K5 pool-free: the kernel's order, emulated ------------------------------


def _block_sums5(av, xh, dz, plan, C):
    """One block's (5, C) sums over its units (units, W): sum a, a xhat,
    dz, dz xhat and a dz, each thread's in (unit, value) order (the
    products by FMAs), then L lanes a channel over the threads of its
    slot, one sum a round."""
    th, chans, W = plan.threads, plan.chans, plan.unit * plan.vec
    units = xh.shape[0]
    sums = np.zeros((5, th, chans), f32)
    for k in range(-(-units // th)):
        idx = np.arange(th) + k * th
        valid = idx < units
        idx = np.minimum(idx, units - 1)
        for i in range(W):
            a, d, x = av[idx, i], dz[idx, i], xh[idx, i]
            j = i % chans
            new = (sums[0, :, j] + a, _fma(a, x, sums[1, :, j]),
                   sums[2, :, j] + d, _fma(d, x, sums[3, :, j]),
                   _fma(a, d, sums[4, :, j]))
            for s, v in enumerate(new):
                sums[s, :, j] = np.where(valid, v, sums[s, :, j])
    c = np.arange(C)
    slot, j = c // chans, c % chans
    threads = slot[:, None] + plan.slots * np.arange(th // plan.slots)
    return _lanes_then_tree(sums[:, threads, j[:, None]], _channel_lanes(C))


def _emulated_k5(plan, a, ggamma, gbeta, da, x, mean, rstd, gamma, beta,
                 slope):
    """The kernel's (g_da, g_y, g_gamma) from the twin's inputs (torch, f32
    or bf16), in its order: the masks K2's, the five sums reduced as K3's
    two, then each channel's coefficients and the apply in f32, each
    output rounded once."""
    bf16 = x.dtype == torch.bfloat16
    T, N, H, W, C = x.shape
    flat = [v.float().numpy().reshape(T, -1) for v in (x, da, a)]
    tab = [v.float().numpy() for v in (mean, rstd, gamma, beta)]
    gg, gb = (v.float().numpy() for v in (ggamma, gbeta))
    xh, dz = _terms(flat[0], flat[1], *tab, slope, bf16)
    av = flat[2]
    m, r, g, b = tab
    ch = np.arange(xh.shape[1]) % C
    if bf16:
        z = _bf16(_bf16(_bf16(_bf16(flat[0] - m[:, ch]) * r[:, ch])
                        * g[:, ch]) + b[:, ch])
    else:
        z = _fma(xh, g[:, ch], b[:, ch])
    Wu = plan.unit * plan.vec
    parts = [v.reshape(T, plan.units, Wu) for v in (av, xh, dz)]
    part = np.zeros((T, plan.splits, 5, C), f32)
    for t in range(T):
        for s in range(plan.splits):
            lo, hi = s * plan.chunk, min((s + 1) * plan.chunk, plan.units)
            part[t, s] = _block_sums5(*(v[t, lo:hi] for v in parts), plan, C)
    tot = (part[:, 0] if plan.splits == 1
           else _lanes_then_tree(part.transpose(0, 2, 3, 1), 32))
    inv_m = f32(1.0 / (N * H * W))
    s_a, s_ax, s_dz, s_dzx, s_adz = (tot[:, k] for k in range(5))
    m_a, m_ax, m_dz, m_dzx = (v * inv_m for v in (s_a, s_ax, s_dz, s_dzx))
    cross = s_adz - (m_a * s_dz + m_ax * s_dzx)
    grs = g * r
    mean_g = -grs * (m_dzx * m_a + m_ax * m_dz) + gg * m_dz
    mean_gx = f32(-2.0) * grs * m_ax * m_dzx + gg * m_dzx
    lr = r * r * inv_m * g * cross
    gdz = (grs[:, ch] * (av - m_a[:, ch] - xh * m_ax[:, ch])
           + gg[:, ch] * xh + gb[:, ch])
    g_da = np.where(z >= 0, gdz, gdz * f32(slope))
    big_g = -grs[:, ch] * (m_dzx[:, ch] * av + m_ax[:, ch] * dz) \
        + gg[:, ch] * dz
    g_y = (r[:, ch] * (big_g - mean_g[:, ch] - xh * mean_gx[:, ch])
           - xh * lr[:, ch])
    out = (g_da.reshape(x.shape), g_y.reshape(x.shape), r * cross)
    return tuple(_bf16(v) if bf16 else v.astype(f32) for v in out)


def _k5_inputs(T, N, H, W, C, seed, bf16):
    """K5's arguments in the twin's order: the cotangents a, ggamma and
    gbeta, then K3's (da, x and its statistics, gamma, beta)."""
    da, x, mean, rstd, gamma, beta = _inputs(T, N, H, W, C, seed, bf16)
    rng = np.random.RandomState(seed + 1)

    def t(v):
        return torch.from_numpy(v.astype(f32)).to(x.dtype)

    return (t(rng.randn(T, N, H, W, C)), t(rng.randn(T, C)),
            t(rng.randn(T, C)), da, x, mean, rstd, gamma, beta)


# K3's shapes, and lanes on the block route at K5's lower threshold (the
# strided L4's two by two map)
K5_EMULATED = EMULATED + [(2, 5, 2, 2, 64, True, 132)]


def _emulated_k5_plan(shape, bf16):
    T, N, H, W, C, vec, sms = shape
    return cb.bn_act_bwd_bwd_plan(T, N * H * W, C, bf16, vec, sms, 2)


@pytest.mark.parametrize("slope", SLOPES, ids=("leaky", "slope1"))
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", K5_EMULATED, ids=str)
def test_emulated_k5_equals_the_twin(shape, dtype, slope):
    T, N, H, W, C, _, _ = shape
    bf16 = DTYPES[dtype]
    plan = _emulated_k5_plan(shape, bf16)
    args = _k5_inputs(T, N, H, W, C, sum(shape[:5]) + 3, bf16)
    s = F.scalar_like(slope, args[4])
    got = _emulated_k5(plan, *args, s)
    want = (F.bn_act_bwd_bwd(*args, slope) if slope != 1.0
            else F.batch_norm_bwd_bwd(*args))
    for g, w, what in zip(got, want, ("g_da", "g_y", "g_gamma")):
        if bf16:
            _within_ulp(g, w, what)
        else:
            _close(g, w, what)


def test_emulated_k5_takes_every_mode_and_route():
    seen = {(p.mode, p.route) for shape in K5_EMULATED
            for bf16 in (False, True)
            for p in [_emulated_k5_plan(shape, bf16)]}
    assert {m for m, _ in seen} == set(cb.BN_STATS_MODES)
    assert {("packed3", "grid"), ("lanes", "grid"), ("packed1", "grid"),
            ("scalar", "grid"), ("lanes", "block")} <= seen
    assert max(_emulated_k5_plan(s, False).splits for s in K5_EMULATED) > 32
    stages = {bool(_emulated_k5_plan(s, bf16).stage) for s in K5_EMULATED
              for bf16 in (False, True)}
    assert stages == {False, True}


@pytest.mark.parametrize("slope", SLOPES, ids=("leaky", "slope1"))
def test_emulated_k5_equals_the_jax_second_derivative(slope):
    """At a small map cut over several blocks (the grid route, lanes of
    48 channels), the emulated K5 against the JAX package's own second
    derivative per tenant, in f32: ``jax.vjp`` of the function that maps
    (da, x, gamma) to ``jax.vjp`` of ``batch_norm`` (batch statistics) ->
    ``leaky_relu`` at da, taken at the cotangents (a, ggamma, gbeta);
    within the card's f32 gate (1e-5 + 1e-4 * scale). beta's gradient is
    zero (it enters only through the masks)."""
    shape = (2, 6, 12, 12, 48, True, 4)
    T, N, H, W, C, _, _ = shape
    plan = _emulated_k5_plan(shape, False)
    assert plan.route == "grid" and plan.mode == "lanes"
    args = _k5_inputs(T, N, H, W, C, 11, False)
    a, gg, gb, da, x, mean, rstd, gamma, beta = args
    got = _emulated_k5(plan, *args, slope)
    block = _jax_block(slope)
    for t in range(T):
        jb = jnp.asarray(beta[t].numpy())

        def first(d, v, g):
            _, vjp = jax.vjp(lambda v_, g_: block(v_, g_, jb), v, g)
            dx, dgamma = vjp(d)
            _, vjp_b = jax.vjp(lambda b_: block(v, g, b_), jb)
            return dx, dgamma, vjp_b(d)[0]

        _, vjp2 = jax.vjp(first, *(jnp.asarray(v[t].numpy())
                                    for v in (da, x, gamma)))
        want = vjp2(tuple(jnp.asarray(v[t].numpy()) for v in (a, gg, gb)))
        for g, w, what in zip((v[t] for v in got), want,
                              ("g_da", "g_y", "g_gamma")):
            _close(g, np.array(w), what)
