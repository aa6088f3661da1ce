"""The launch plan of K2 (``conv_block.bn_fwd_plan``, the kernels of
``kernels/csrc/bn_act_fwd.cu``), pooled and pool-free, on the CPU: a pure
function of the shape, checked at every shape the shipped configs give K2
— pooled, the mini-ImageNet conv outputs (84/42/21/10, and the unpadded
82/39/17/6; 48 channels) at N = 25 and 75 and T = 1, 2, 8 and 256, and
Omniglot's (28/14/7/3, 64 channels); pool-free, the strided models' conv
outputs and the norm-first models' block inputs (C = 1, 3, 48, 64) — in
f32 and bf16, with vector loads and an element at a time: every output
element written by exactly one thread, no thread reading past y, and each
element's (tenant, channel) the one the kernel's index arithmetic finds.

Then the kernel emulated in plain PyTorch, thread by thread as the plan
lays it out (the same loads, the f32 FMA taken in f64 and rounded once,
the window's first maximum winning a tie), against the twins
(``ops/functional.py::bn_act_pool_fwd``, ``::bn_act_fwd``,
``::batch_norm_fwd``): bf16 bit for bit, f32 within 1e-6 of the output's
scale with the argmax equal; and against the JAX package's ``batch_norm``
:368 (its normalize tail :429-430 on its own statistics) -> ``leaky_relu``
:363 -> ``max_pool2d(impl='reduce_window')`` :325, run eagerly on the CPU
(bf16 bit for bit).

The kernels themselves run only on the card
(``tests/test_torch_kernels_cuda.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu.ops import functional as JF
from howtotrainyourmamlpytorch_tpu_torch.kernels import conv_block as cb
from howtotrainyourmamlpytorch_tpu_torch.ops import functional as F

BF16 = torch.bfloat16
MINI = (84, 42, 21, 10)
UNPADDED = (82, 39, 17, 6)
OMNIGLOT = (28, 14, 7, 3)
# (T, N, H = W, C) of every pooled K2 call: mini-ImageNet 5-way 5-shot
# (support 25, target 75) at batch 1 (a serve tenant), 2, 8 and the
# large-batch config's 256, and 5-way 1-shot (support 5); the unpadded
# model; Omniglot 20-way 1-shot, and 5-way 1-shot and 20-way 5-shot
# (support 5 and 100); and the image channels of no shipped pooled call
# (scalar loads only)
POOLED = (
    [(T, n, hw, 48) for T in (1, 2, 8, 256) for n in (25, 75) for hw in MINI]
    + [(T, 5, hw, 48) for T in (2, 8) for hw in MINI]
    + [(T, n, hw, 48) for T in (2, 8) for n in (25, 75) for hw in UNPADDED]
    + [(T, 20, hw, 64) for T in (1, 8, 256) for hw in OMNIGLOT]
    + [(8, n, hw, 64) for n in (5, 100) for hw in OMNIGLOT]
    + [(2, 5, 9, 1), (8, 25, 11, 3)]
)
# (T, N, H = W, C) of every pool-free K2 call: the strided Omniglot model's
# conv outputs (14/7/4/2, 64 channels), the unpadded strided model's
# (41/20/9/4, 48), the norm-first models' block inputs (the image at C = 3,
# then 48 channels; the strided norm-first model's image at C = 1)
FREE = (
    [(T, 20, hw, 64) for T in (1, 8, 256) for hw in (14, 7, 4, 2)]
    + [(T, n, hw, 48) for T in (2, 8) for n in (25, 75)
       for hw in (41, 20, 9, 4)]
    + [(T, n, hw, C) for T in (1, 2, 8, 256) for n in (25, 75)
       for hw, C in ((84, 3), (42, 48), (21, 48), (10, 48))]
    + [(T, 20, 28, 1) for T in (1, 8, 256)]
)
CHUNK = 1 << 20  # threads enumerated at a time
WHOLE = 1 << 22  # pool-free tensors up to this size enumerated whole


# -- the plan, as the kernels index it -----------------------------------------


def _pooled_threads(plan, N, H, W, C, lo, hi):
    """Threads ``lo`` to ``hi`` of one tenant's grid row, those with work,
    as the pooled kernel indexes them: the offset of each one's first tap
    in the tenant's y, and of its output (both at its first channel)."""
    Ho, Wo = H // 2, W // 2
    lane = np.arange(lo, hi, dtype=np.int64)
    pix = lane // plan.groups
    keep = pix < N * Ho * Wo
    lane, pix = lane[keep], pix[keep]
    c0 = (lane - pix * plan.groups) * plan.items
    n, hw = np.divmod(pix, Ho * Wo)
    ho, wo = np.divmod(hw, Wo)
    return ((n * H + 2 * ho) * W + 2 * wo) * C + c0, pix * C + c0


def _tap(k, W, C):
    """Tap k's offset from the window's first (2 * dh + dw order)."""
    return ((k >> 1) * W + (k & 1)) * C


@functools.lru_cache(maxsize=None)
def _pooled_coverage(N, H, W, C, vec):
    """One tenant's pooled elements written by the plan's threads (each
    count), and the least and most offset its threads read in y."""
    plan = cb.bn_fwd_plan(1, N, H, W, C, True, False, vec)
    Ho, Wo = H // 2, W // 2
    counts = np.zeros(N * Ho * Wo * C, dtype=np.int64)
    lo, hi = np.inf, -np.inf
    width = plan.grid[0] * plan.threads
    for start in range(0, width, CHUNK):
        first, out = _pooled_threads(plan, N, H, W, C, start,
                                     min(start + CHUNK, width))
        if not len(out):
            continue
        for j in range(plan.items):
            counts += np.bincount(out + j, minlength=counts.size)
        lo = min(lo, first.min())
        hi = max(hi, first.max() + _tap(3, W, C) + plan.items - 1)
    return counts, lo, hi


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("vec", [True, False])
@pytest.mark.parametrize("shape", POOLED, ids=str)
def test_pooled_plan_writes_each_pooled_element_once(shape, vec, bf16):
    T, N, hw, C = shape
    if vec and C % 4:
        with pytest.raises(ValueError, match="with vectors"):
            cb.bn_fwd_plan(T, N, hw, hw, C, True, bf16, vec)
        return
    plan = cb.bn_fwd_plan(T, N, hw, hw, C, True, bf16, vec)
    assert plan == cb.bn_fwd_plan(T, N, hw, hw, C, True, bf16, vec)  # pure
    # a thread a pooled pixel x 4 channels (1 without vectors), the same in
    # either dtype; grid y the tenant, x just enough blocks for its pixels
    assert plan.threads == cb.BN_FWD_THREADS == 256
    assert plan.items == (4 if vec else 1)
    assert plan.groups == -(-C // plan.items)
    assert plan.work == N * (hw // 2) ** 2 * plan.groups
    assert plan.grid[1] == T
    assert (plan.grid[0] - 1) * plan.threads < plan.work
    assert plan.grid[0] * plan.threads >= plan.work
    assert plan == cb.bn_fwd_plan(T, N, hw, hw, C, True, not bf16, vec)
    counts, lo, hi = _pooled_coverage(N, hw, hw, C, vec)
    assert (counts == 1).all()
    assert lo >= 0 and hi < N * hw * hw * C  # within the tenant's y


def _locate(e0, tenant, C):
    t = e0 // tenant
    r = e0 - t * tenant
    return t, r, r % C


def _advance(t, r, c, step, tenant, C):
    c = c + step
    c = np.where(c == C, 0, c)
    r = r + step
    wrap = r == tenant
    return np.where(wrap, t + 1, t), np.where(wrap, 0, r), c


def _free_entries(plan, shape, threads, vec_params):
    """The elements the pool-free kernel's ``threads`` write, and for each
    the (T, C) table entry it reads, emulating its ``locate`` and
    ``advance``: the table entries as vectors of 4 (``vec_params``: C % 4
    == 0 and the tables aligned) or an element at a time."""
    T, N, H, W, C = shape
    tenant = N * H * W * C
    total = T * tenant
    items = plan.items
    e0 = threads.astype(np.int64) * items
    e0 = e0[e0 < total]
    t, r, c = _locate(e0, tenant, C)
    elems, entries = [], []
    full = e0 + items <= total if items > 1 else np.zeros(e0.shape, bool)
    step = 4 if vec_params else 1
    ft, fr, fc = t[full], r[full], c[full]
    for q in range(0, items, step):
        for j in range(step):
            elems.append(e0[full] + q + j)
            entries.append(ft * C + fc + j)
        ft, fr, fc = _advance(ft, fr, fc, step, tenant, C)
    # the last partial vector, or an element a thread
    pt, pr, pc = t[~full], r[~full], c[~full]
    for j in range(items):
        ok = e0[~full] + j < total
        elems.append((e0[~full] + j)[ok])
        entries.append((pt * C + pc)[ok])
        pt, pr, pc = _advance(pt, pr, pc, 1, tenant, C)
    return np.concatenate(elems), np.concatenate(entries)


def _free_sample(plan, shape):
    """Every thread of a small tensor; of a large one the first and last
    thousand and the three either side of each tenant boundary."""
    T, N, H, W, C = shape
    tenant = N * H * W * C
    width = plan.grid[0] * plan.threads
    if T * tenant <= WHOLE:
        return np.arange(width)
    edges = np.arange(1, T, dtype=np.int64) * tenant // plan.items
    near = (edges[:, None] + np.arange(-3, 4)).ravel()
    return np.unique(np.concatenate(
        [np.arange(1000), np.arange(width - 1000, width), near]))


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("vec", [True, False])
@pytest.mark.parametrize("shape", FREE, ids=str)
def test_free_plan_writes_each_element_once(shape, vec, bf16):
    T, N, hw, C = shape
    plan = cb.bn_fwd_plan(T, N, hw, hw, C, False, bf16, vec)
    assert plan == cb.bn_fwd_plan(T, N, hw, hw, C, False, bf16, vec)
    # 16 bytes a thread (4 f32, 8 bf16), or an element; one grid row
    assert plan.threads == 256 and plan.grid[1] == 1 and plan.groups == 0
    assert plan.items == ((8 if bf16 else 4) if vec else 1)
    total = T * N * hw * hw * C
    assert plan.work == -(-total // plan.items)
    assert (plan.grid[0] - 1) * plan.threads < plan.work
    assert plan.grid[0] * plan.threads >= plan.work
    # the elements a thread takes are consecutive, so each element has one
    # thread and none reads past the tensor (a vector only where it fits)
    threads = _free_sample(plan, (T, N, hw, hw, C))
    for vec_params in ((False, True) if vec and C % 4 == 0 else (False,)):
        elems, entries = _free_entries(plan, (T, N, hw, hw, C), threads,
                                       vec_params)
        assert elems.min() >= 0 and elems.max() < total
        if T * N * hw * hw * C <= WHOLE:
            assert (np.bincount(elems, minlength=total) == 1).all()
        else:
            assert len(np.unique(elems)) == len(elems)
        tenant = N * hw * hw * C
        assert np.array_equal(entries, elems // tenant * C + elems % C)


@pytest.mark.parametrize("pool", [True, False])
def test_bn_fwd_plan_refuses_what_the_kernels_do_not_take(pool):
    for bad in ((0, 3, 8, 8, 48), (2, 3, 8, 8, 65), (2, 3, 8, 8, 0),
                (2, 2 ** 15, 256, 256, 1)):
        with pytest.raises(ValueError, match="no .*K2"):
            cb.bn_fwd_plan(*bad, pool)
    if pool:  # no window, no vectors at C % 4 != 0, one grid row a tenant
        for bad in ((2, 3, 1, 8, 48), (2, 3, 8, 1, 48), (2, 3, 8, 8, 3),
                    (65536, 1, 2, 2, 4)):
            with pytest.raises(ValueError, match="no pooled K2"):
                cb.bn_fwd_plan(*bad, True)
        assert cb.bn_fwd_plan(2, 3, 8, 8, 3, True, vec=False).items == 1
    else:
        assert cb.bn_fwd_plan(2, 3, 1, 1, 3, False).work == 5


# -- the kernels, emulated ------------------------------------------------------


def _act(v, m, r, g, b, slope):
    """The kernels' activation: in bf16 every op rounded (torch's bf16
    ops compute each in f32 and round it), in f32 xhat rounded and the
    FMA taken in f64 and rounded once."""
    if v.dtype == BF16:
        z = (((v - m) * r) * g) + b
        return torch.where(z >= 0, z, z * slope)
    x = (v - m) * r
    z = (x.double() * g.double() + b.double()).float()
    return torch.where(z >= 0, z, z * slope)


def _emulated_pooled(plan, y, mean, rstd, gamma, beta, slope):
    """Pooled K2 thread by thread: each loads its window's four taps at its
    channels and keeps the first maximum."""
    T, N, H, W, C = y.shape
    Ho, Wo = H // 2, W // 2
    out = torch.full((T, N * Ho * Wo * C), float("nan"), dtype=y.dtype)
    arg = torch.full((T, N * Ho * Wo * C), 255, dtype=torch.uint8)
    first, dst = _pooled_threads(plan, N, H, W, C, 0,
                                 plan.grid[0] * plan.threads)
    j = np.arange(plan.items)
    first = torch.from_numpy(first[:, None] + j)
    dst = torch.from_numpy(dst[:, None] + j)
    chan = dst % C
    for t in range(T):
        yt = y[t].reshape(-1)
        p = [v[t][chan] for v in (mean, rstd, gamma, beta)]
        best = _act(yt[first], *p, slope)
        win = torch.zeros(best.shape, dtype=torch.uint8)
        for k in range(1, 4):
            a = _act(yt[first + _tap(k, W, C)], *p, slope)
            upd = a > best
            best = torch.where(upd, a, best)
            win = torch.where(upd, torch.tensor(k, dtype=torch.uint8), win)
        out[t, dst.reshape(-1)] = best.reshape(-1)
        arg[t, dst.reshape(-1)] = win.reshape(-1)
    shape = (T, N, Ho, Wo, C)
    return out.reshape(shape), arg.reshape(shape)


def _emulated_free(plan, y, mean, rstd, gamma, beta, slope, vec_params):
    """Pool-free K2 thread by thread, each element's table entry found as
    the kernel finds it."""
    elems, entries = _free_entries(
        plan, tuple(y.shape), np.arange(plan.grid[0] * plan.threads),
        vec_params)
    e, k = torch.from_numpy(elems), torch.from_numpy(entries)
    out = torch.full((y.numel(),), float("nan"), dtype=y.dtype)
    out[e] = _act(y.reshape(-1)[e],
                  *(v.reshape(-1)[k] for v in (mean, rstd, gamma, beta)),
                  slope)
    return out.reshape(y.shape)


def _inputs(T, N, H, W, C, dtype, seed):
    """y on a grid of 0.25 (exact ties in many pool windows, both signs)
    plus a continuous part on half its elements, its batch statistics (the
    twin's ``bn_stats``), gamma and beta, from a numpy seed."""
    rng = np.random.RandomState(seed)
    grid = rng.randint(-6, 6, size=(T, N, H, W, C)) * 0.25
    y = grid + (rng.rand(T, N, H, W, C) < 0.5) * rng.randn(T, N, H, W, C)
    y = torch.from_numpy(y.astype(np.float32)).to(dtype)
    mean, _, rstd = F.bn_stats(y)
    gamma = torch.from_numpy(
        (1 + 0.3 * rng.randn(T, C)).astype(np.float32)).to(dtype)
    beta = torch.from_numpy((0.3 * rng.randn(T, C)).astype(np.float32))
    return y, mean, rstd, gamma, beta.to(dtype)


def _close(got, want, what):
    """f32: within 1e-6 of the output's scale (xhat * gamma + beta in one
    rounding against the twin's two)."""
    err = (got.double() - want.double()).abs().max().item()
    scale = want.double().abs().max().item()
    assert err <= 1e-6 * scale, (what, err, scale)


# small shapes: odd maps (the dropped row and column), C % 4 != 0, tenants
# whose element count is no multiple of a vector (a vector spans two
# tenants), a partial last vector, several blocks a tenant
EMULATED = [
    # T, N, H, W, C
    (2, 3, 9, 7, 20),
    (1, 2, 5, 5, 3),
    (3, 2, 6, 4, 1),
    (2, 3, 10, 10, 48),
    (1, 4, 7, 7, 64),
    (3, 1, 3, 5, 5),
    (2, 2, 11, 9, 8),
]
DTYPES = {"f32": torch.float32, "bf16": BF16}


@pytest.mark.parametrize("slope", [F.LEAKY_SLOPE, 1.0])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("vec", [True, False])
@pytest.mark.parametrize("shape", EMULATED, ids=str)
def test_emulated_pooled_equals_the_twin(shape, vec, dtype, slope):
    T, N, H, W, C = shape
    if vec and C % 4:
        return  # the wrapper takes one channel a thread here
    bn = _inputs(*shape, DTYPES[dtype], sum(shape))
    plan = cb.bn_fwd_plan(T, N, H, W, C, True, dtype == "bf16", vec)
    s = F.scalar_like(slope, bn[0])
    got, arg = _emulated_pooled(plan, *bn, s)
    want, arg_p = F.bn_act_pool_fwd(*bn, slope)
    assert torch.equal(arg, arg_p)
    if dtype == "bf16":
        assert got.dtype == BF16 and torch.equal(got, want)
    else:
        _close(got, want, "pooled")


@pytest.mark.parametrize("slope", [F.LEAKY_SLOPE, 1.0])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("vec", ["params", "y", "scalar"])
@pytest.mark.parametrize("shape", EMULATED, ids=str)
def test_emulated_free_equals_the_twin(shape, vec, dtype, slope):
    """At slope 1 the twin is ``batch_norm_fwd``. ``params``: vector loads
    of y and of the tables (C % 4 == 0), ``y``: of y alone."""
    T, N, H, W, C = shape
    if vec == "params" and C % 4:
        return
    bn = _inputs(*shape, DTYPES[dtype], 2 * sum(shape))
    plan = cb.bn_fwd_plan(T, N, H, W, C, False, dtype == "bf16",
                          vec != "scalar")
    got = _emulated_free(plan, *bn, F.scalar_like(slope, bn[0]),
                         vec == "params")
    want = (F.batch_norm_fwd(*bn) if slope == 1.0
            else F.bn_act_fwd(*bn, slope))
    if dtype == "bf16":
        assert got.dtype == BF16 and torch.equal(got, want)
    else:
        _close(got, want, "activation")


def _jax_stats(xj):
    """``batch_norm``'s own statistics of one tenant (stats_impl
    'twopass'): jnp.mean, jnp.var, lax.rsqrt(var + eps) in x's dtype."""
    axes = (0, 1, 2)
    mean, var = jnp.mean(xj, axis=axes), jnp.var(xj, axis=axes)
    return mean, jax.lax.rsqrt(var + F.BN_EPS).astype(xj.dtype)


def _to_torch(a, dtype):
    return torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(dtype)


@pytest.mark.parametrize("slope", [F.LEAKY_SLOPE, 1.0])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", [
    # pool, (T, N, H, W, C), vec
    (True, (2, 3, 9, 7, 8), True),
    (True, (2, 2, 6, 6, 3), False),
    (False, (2, 3, 5, 5, 3), True),
    (False, (2, 2, 4, 4, 48), True),
    (False, (2, 2, 7, 7, 1), True),
], ids=str)
def test_emulated_k2_equals_the_jax_package(case, dtype, slope):
    """The JAX package's ``batch_norm`` (batch statistics, twopass) ->
    ``leaky_relu`` -> ``max_pool2d(impl='reduce_window')`` per tenant, run
    eagerly, against the emulated kernel on the same y, gamma and beta and
    on the statistics ``batch_norm`` computes: bf16 bit for bit, f32
    within 1e-6 of the scale."""
    pool, shape, vec = case
    T, N, H, W, C = shape
    dt = DTYPES[dtype]
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    rng = np.random.RandomState(sum(shape) + int(pool))
    y = (rng.randint(-6, 6, size=shape) * 0.25
         + rng.randn(*shape) * (rng.rand(*shape) < 0.5)).astype(np.float32)
    gamma = (1 + 0.3 * rng.randn(T, C)).astype(np.float32)
    beta = (0.3 * rng.randn(T, C)).astype(np.float32)
    outs, means, rstds = [], [], []
    with jax.disable_jit():
        for t in range(T):
            xj = jnp.asarray(y[t]).astype(jdt)
            z, _, _ = JF.batch_norm(xj, jnp.asarray(gamma[t]),
                                    jnp.asarray(beta[t]), None, None,
                                    stats_impl="twopass")
            a = JF.leaky_relu(z, slope)
            outs.append(JF.max_pool2d(a, impl="reduce_window") if pool
                        else a)
            mean, rstd = _jax_stats(xj)
            means.append(mean)
            rstds.append(rstd)
    want = torch.stack([_to_torch(o, dt) for o in outs])
    bn = (torch.from_numpy(y).to(dt),
          torch.stack([_to_torch(m, dt) for m in means]),
          torch.stack([_to_torch(r, dt) for r in rstds]),
          torch.from_numpy(gamma).to(dt), torch.from_numpy(beta).to(dt))
    plan = cb.bn_fwd_plan(T, N, H, W, C, pool, dtype == "bf16", vec)
    s = F.scalar_like(slope, bn[0])
    got = (_emulated_pooled(plan, *bn, s)[0] if pool
           else _emulated_free(plan, *bn, s, vec and C % 4 == 0))
    if dtype == "bf16":
        assert torch.equal(got, want)
    else:
        _close(got, want, "against JAX")
