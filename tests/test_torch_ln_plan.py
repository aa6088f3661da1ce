"""``layer_norm_stats``, ``layer_norm_bwd`` and ``layer_norm_bwd_bwd``
(csrc/layer_norm.cu), on the CPU: their launch plans (``conv_block.ln_stats_plan``, ``ln_bwd_plan``) at
every layer-norm shape of the port's models — the conv-first outputs of
the mini-ImageNet stages (84/42/21/10 x 48: M = 338,688, 84,672, 21,168,
4,800), the norm-first image (84 x 84 x 3: 21,168), the unpadded conv
outputs (82/39/17/6 x 48), the strided Omniglot outputs (14/7/4/2 x 64:
12,544, 3,136, 1,024, 256) and its 28 x 28 x 1 image (784) — at T = 1, 2
and 8 and the images a task gives them (5, 20, 25, 75), in f32 and bf16:
every element covered once, a cluster of at most 8 blocks, shared memory
within a block's 227 KB, the cooperative grid within the ``blocks_per_sm``
x 132 it is given. Then each kernel's summation order emulated in numpy
(f32) from the plan — the statistics' loads folded with Chan's merge in
each thread's order, four loads a merge in f32 and one in bf16, the
warps' shuffle trees, the warps and the cluster's
blocks merged in rank order; the backward's row partials a (row, tile,
warp) over the warp's lanes, the column sums over a row group's rows and
then the row groups in order, the (tile, warp) partials of a row added a
lane each and a shuffle tree — and
held to the twins (``ops/functional.py::layer_norm_stats``,
``::layer_norm_bwd``): f32 within 1e-5 + 1e-4 * scale, bf16 (the sums in
f32 on the widened loads, each output rounded once where the twins round)
within one bf16 ulp; and at one small shape to the JAX package's
``layer_norm`` :447 and its ``jax.vjp`` (run eagerly on the CPU). The
double backward's plan (``ln_bwd_plan`` on its own kernel's occupancy) at
every layer-norm shape ``chip_smoke.py`` gives it, and its seven row sums
in the kernel's order, held to the twin
(``ops/functional.py::layer_norm_bwd_bwd``) in f32 and bf16 and to the
JAX package's second derivative of ``layer_norm`` (``jax.vjp`` of its
``jax.vjp``).

The kernels themselves run only on the card
(``tests/test_torch_kernels_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu.ops import functional as JF
from howtotrainyourmamlpytorch_tpu_torch.kernels import conv_block as cb
from howtotrainyourmamlpytorch_tpu_torch.ops import functional as F

SMS = 132  # an H100 SXM's SMs
BLOCK_SMEM = 232448  # the shared memory a block may take on sm_90
# M of every tensor the layer-norm models normalize
MINI = (84 * 84 * 48, 42 * 42 * 48, 21 * 21 * 48, 10 * 10 * 48,
        84 * 84 * 3)
UNPADDED = tuple(hw * hw * 48 for hw in (82, 39, 17, 6))
STRIDED = tuple(hw * hw * 64 for hw in (14, 7, 4, 2)) + (28 * 28 * 1,)
M_VALUES = MINI + UNPADDED + STRIDED
SHAPES = [(T, n, M) for T in (1, 2, 8) for n in (5, 20, 25, 75)
          for M in M_VALUES]
DTYPES = {"f32": False, "bf16": True}
# the blocks a SM the occupancy query may give the backward, and one
BLOCKS_PER_SM = (1, 2, 4, 8)
RTOL, ATOL = 1e-4, 1e-5  # the card's twin gate
f32 = np.float32


def _is_pow2(n):
    return n >= 1 and n & (n - 1) == 0


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_stats_plan_covers_each_value_once_and_fits_the_card(shape, dtype):
    T, N, M = shape
    R, bf16 = T * N, DTYPES[dtype]
    plan = cb.ln_stats_plan(R, M, bf16, True, SMS)
    assert plan == cb.ln_stats_plan(R, M, bf16, True, SMS)  # pure
    v = 8 if bf16 else 4
    assert plan.vec == v and M % v == 0 and plan.chunk % v == 0
    loads = M // v
    if plan.route == "warp":
        # a warp a row, 8 rows a block: every row once
        assert loads <= cb.LN_WARP_ROW_VECS
        assert plan.cluster == 1 and plan.chunk == M
        assert (plan.grid - 1) * cb.LN_WARP_ROWS < R
        assert R <= plan.grid * cb.LN_WARP_ROWS
        return
    assert plan.route == "cluster" and loads > cb.LN_WARP_ROW_VECS
    # a cluster a row, of at most 8 blocks; block r the values [r chunk,
    # (r + 1) chunk): every value once, no block empty
    assert _is_pow2(plan.cluster) and plan.cluster <= cb.LN_MAX_CLUSTER
    assert plan.grid == R * plan.cluster
    assert (plan.cluster - 1) * plan.chunk < M <= plan.cluster * plan.chunk
    # at least two loads a thread in each block
    assert plan.chunk >= 2 * cb.LN_THREADS * v or plan.cluster == 1
    # two blocks a SM where the rows allow them
    assert (plan.grid >= 2 * SMS or plan.cluster == cb.LN_MAX_CLUSTER
            or plan.cluster * 2 * 2 * cb.LN_THREADS * v > M)
    # the statistics' static shared memory: a block's warps and its own
    assert 4 * (3 * cb.LN_THREADS // 32 + 3) <= BLOCK_SMEM


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bwd_plan_covers_each_value_once_and_fits_the_card(shape, dtype):
    T, N, M = shape
    bf16 = DTYPES[dtype]
    v = 8 if bf16 else 4
    loads = M // v
    for bps in BLOCKS_PER_SM:
        plan = cb.ln_bwd_plan(T, N, M, bf16, True, SMS, bps)
        assert plan == cb.ln_bwd_plan(T, N, M, bf16, True, SMS, bps)
        assert plan.vec == v and plan.threads == cb.LN_THREADS == 256
        # a row group's threads: a power of two from a warp to the block
        assert _is_pow2(plan.tpr) and 32 <= plan.tpr <= plan.threads
        assert plan.groups * plan.tpr == plan.threads
        # the tiles of tpr loads cover a row's loads once
        assert (plan.tiles - 1) * plan.tpr < loads <= plan.tiles * plan.tpr
        # the items (tenant, tile) in even shares, none empty, each once;
        # every block resident at once (the cooperative launch needs it),
        # as many as the card holds where the items allow
        items = T * plan.tiles
        assert plan.grid == min(items, SMS * bps)
        edges = [b * items // plan.grid for b in range(plan.grid + 1)]
        assert edges[0] == 0 and edges[-1] == items
        assert all(b - a in (items // plan.grid, -(-items // plan.grid))
                   for a, b in zip(edges, edges[1:]))
        # a row group narrower than the row only where the card would
        # otherwise get fewer items than SMs
        widest = max(32, min(256, 1 << (loads - 1).bit_length()))
        assert plan.tpr == widest or T * plan.tiles >= SMS \
            or plan.tpr == 32
        if plan.tpr < widest:
            assert T * -(-loads // (2 * plan.tpr)) < SMS
        # shared memory within a block's
        assert cb.ln_bwd_smem(v) <= BLOCK_SMEM


def test_plans_refuse_what_the_kernels_do_not_take():
    for bad in ((0, 16), (4, 0), (4, 18)):
        with pytest.raises(ValueError, match="no statistics"):
            cb.ln_stats_plan(*bad, False, True)
    with pytest.raises(ValueError, match="no statistics"):
        cb.ln_stats_plan(4, 20, True, True)  # 20 values: not 16 bytes
    assert cb.ln_stats_plan(4, 18, False, False).vec == 1
    for bad in ((0, 3, 16), (2, 0, 16), (2, 3, 0), (2, 3, 18)):
        with pytest.raises(ValueError, match="no backward"):
            cb.ln_bwd_plan(*bad, False, True)
    with pytest.raises(ValueError, match="no backward"):
        cb.ln_bwd_plan(2, 3, 16, False, True, SMS, 0)
    assert cb.ln_bwd_plan(2, 3, 18, False, False).vec == 1


# -- the kernels' order, emulated -----------------------------------------------


def _chan(a, b):
    """Chan's merge of (n, mean, m2) ``a`` with ``b`` after it, elementwise,
    as the kernel's ``merge`` (one division): an empty ``b`` leaves
    ``a``."""
    n, m, q = a
    nb, mb, qb = b
    nn = n + nb
    w = nb / np.where(nn == 0, f32(1), nn)
    d = mb - m
    out = (nn, m + d * w, q + (qb + d * d * n * w))
    return tuple(np.where(nb == 0, old, new).astype(f32)
                 for old, new in zip(a, out))


def _tree(parts, combine):
    """Lane 0 of a shuffle-down tree over the last axis (32 lanes): lane l
    takes lane l + stride after itself, strides 16 .. 1."""
    parts = [np.array(p) for p in parts]
    off = 16
    while off:
        head = combine(tuple(p[..., :off] for p in parts),
                       tuple(p[..., off:2 * off] for p in parts))
        for p, h in zip(parts, head):
            p[..., :off] = h
        off //= 2
    return tuple(p[..., 0] for p in parts)


UNROLL = 4  # the loads a thread has in flight (``kUnroll``)


def _fold_run(row, begin, end, lanes, v, group):
    """Each of ``lanes`` threads' (n, mean, m2) over the loads [begin, end)
    of ``row`` (rows, M): thread l the loads begin + l, begin + l + lanes,
    ... in order, ``group`` loads a merge (4 in f32, 1 in bf16): each
    load's sum in order and then the group's, their mean, each load's M2
    in order and then the group's, one merge."""
    R = row.shape[0]
    st = [np.zeros((R, lanes), f32) for _ in range(3)]
    lane = np.arange(lanes)
    for g0 in range(begin, end, UNROLL * lanes):
        k = g0 + lane[None, :] + lanes * np.arange(UNROLL)[:, None]
        live = k < end  # (UNROLL, lanes)
        idx = np.minimum(k, end - 1)[..., None] * v + np.arange(v)
        vals = np.where(live[None, ..., None], row[:, idx], f32(0))
        for a in range(0, UNROLL, group):
            us = range(a, a + group)
            su, mu = {}, {}
            for u in us:
                su[u] = vals[:, u, :, 0]
                for i in range(1, v):
                    su[u] = su[u] + vals[:, u, :, i]
            s = su[a]
            for u in us[1:]:
                s = s + su[u]
            nb = (live[a:a + group].sum(0) * v).astype(f32)[None].repeat(R, 0)
            mb = s / np.maximum(nb, f32(1))
            for u in us:
                mu[u] = np.zeros_like(mb)
                for i in range(v):
                    d = vals[:, u, :, i] - mb
                    mu[u] = mu[u] + d * d
            m2 = mu[a]
            for u in us[1:]:
                m2 = np.where(live[u][None], m2 + mu[u], m2)
            st = list(_chan(st, (nb, mb, m2)))
    return st


def _store_stats(c, eps, bf16):
    n, mean, m2 = c
    var = m2 / n
    if not bf16:
        return mean, var, f32(1) / np.sqrt(var + f32(eps))
    rb = _bf16
    vb = rb(var)
    return rb(mean), vb, rb(f32(1) / np.sqrt(rb(vb + f32(eps))))


def _bf16(a):
    """Round f32 to the nearest bf16 (ties to even), kept as f32."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=f32)).to(
        torch.bfloat16).float().numpy()


def _emulated_stats(x, plan, eps, bf16):
    """The statistics of the rows of x (R, M) in the kernel's order."""
    R, M = x.shape
    v = plan.vec
    loads = M // v
    if plan.route == "warp":
        lanes = _fold_run(x, 0, loads, 32, v, 1 if bf16 else UNROLL)
        return _store_stats(_tree(lanes, _chan), eps, bf16)
    per = plan.chunk // v
    total = None
    for rank in range(plan.cluster):
        lanes = _fold_run(x, rank * per, min((rank + 1) * per, loads),
                          cb.LN_THREADS, v, 1 if bf16 else UNROLL)
        warps = [_tree(tuple(p[:, 32 * w:32 * (w + 1)] for p in lanes),
                       _chan) for w in range(cb.LN_THREADS // 32)]
        block = tuple(np.zeros(R, f32) for _ in range(3))
        for w in warps:
            block = _chan(block, w)
        total = block if total is None else _chan(total, block)
    return _store_stats(total, eps, bf16)


def _sum_tree(parts):
    return _tree((parts,), lambda a, b: (a[0] + b[0],))[0]


def _emulated_bwd(dz, x, mean, rstd, gamma, plan, T, N):
    """dx, dgamma, dbeta of (T * N, M) dz and x, (T * N,) statistics and
    (T, M) gamma in the kernel's order (f32 sums)."""
    R, M = x.shape
    v, tpr, G, J = plan.vec, plan.tpr, plan.groups, plan.tiles
    loads, width = M // v, tpr * v
    pad = J * width - M
    zrow = np.zeros((R, pad), f32)
    d = np.concatenate([dz, zrow], 1).reshape(R, J, tpr, v)
    xx = np.concatenate([x, zrow], 1).reshape(R, J, tpr, v)
    gam = np.concatenate([gamma, np.zeros((T, pad), f32)], 1).reshape(
        T, J, tpr, v)
    gam = np.repeat(gam, N, 0)
    xh = (xx - mean[:, None, None, None]) * rstd[:, None, None, None]
    gv = d * gam
    # each thread's partials over its load, the values in order
    pg = np.zeros((R, J, tpr), f32)
    pgx = np.zeros((R, J, tpr), f32)
    for i in range(v):
        pg = pg + gv[..., i]
        pgx = pgx + gv[..., i] * xh[..., i]
    # each warp's partials: a tree over its lanes, one pair a (row, tile,
    # warp)
    wpg = tpr // 32
    part = np.zeros((R, J * wpg, 2), f32)
    for k, p in enumerate((pg, pgx)):
        part[..., k] = _sum_tree(p.reshape(R, J, wpg, 32)).reshape(
            R, J * wpg)
    # the column sums: a thread its group's rows n = g, g + G, ... in
    # order, then the groups in order
    dzr = d.reshape(T, N, J, tpr, v)
    agr = (d * xh).reshape(T, N, J, tpr, v)
    sums = []
    for src in (agr, dzr):
        groups = []
        for g in range(G):
            acc = np.zeros((T, J, tpr, v), f32)
            for n in range(g, N, G):
                acc = acc + src[:, n]
            groups.append(acc)
        tot = groups[0] if G == 1 else np.zeros_like(groups[0])
        if G > 1:
            for acc in groups:
                tot = tot + acc
        sums.append(tot.reshape(T, J * width)[:, :M])
    # the row sums: lane l the (tile, warp) partials l, l + 32, ..., then
    # a tree
    lanes = np.zeros((R, 2, 32), f32)
    for e in range(J * wpg):
        lanes[:, :, e % 32] = lanes[:, :, e % 32] + part[:, e]
    row = np.stack([_sum_tree(lanes[:, k]) for k in range(2)], 1)
    inv_m = f32(1.0 / M)
    m_g = (row[:, 0] * inv_m)[:, None]
    m_gx = (row[:, 1] * inv_m)[:, None]
    xh_flat = (x - mean[:, None]) * rstd[:, None]
    g_flat = dz * np.repeat(gamma, N, 0)
    dx = rstd[:, None] * (g_flat - m_g - xh_flat * m_gx)
    assert loads * v == M
    return dx, sums[0], sums[1]


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


def _inputs(T, N, M, seed, bf16):
    """x with an offset, dz, gamma (numpy f32, bf16 values in bf16) and
    the twin's statistics."""
    rng = np.random.RandomState(seed)
    x = (3.0 + rng.randn(T, N, M)).astype(f32)
    dz = (0.1 * rng.randn(T, N, M)).astype(f32)
    gamma = (1.0 + 0.3 * rng.randn(T, M)).astype(f32)
    if bf16:
        x, dz, gamma = _bf16(x), _bf16(dz), _bf16(gamma)
    dtype = torch.bfloat16 if bf16 else torch.float32
    xt = torch.from_numpy(x).to(dtype).reshape(T, N, 1, 1, M)
    mean, var, rstd = F.layer_norm_stats(xt)
    return x, dz, gamma, xt, (mean, var, rstd)


# (T, N, M, sms): warp rows (M of 256 loads and under), clusters of 1-8
# blocks (more SMs a row ask for more blocks a row), odd M (a value a
# load), rows of one tile and of several with a ragged last one, row groups
# of 32-256 threads (fewer SMs than items keep them wide)
EMULATED = [
    (2, 3, 256, SMS),
    (1, 5, 1000, SMS),
    (2, 3, 4800, 4),
    (1, 2, 9216, 4),
    (1, 2, 16384, 8),
    (2, 5, 3136, 2),
    (3, 2, 1575, 8),
    (1, 1, 77, 1),
    (2, 3, 2048, 12),
    (2, 3, 2048, 6),
    (2, 4, 12544, 16),
]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", EMULATED, ids=str)
def test_emulated_stats_equal_the_twin(shape, dtype):
    T, N, M, sms = shape
    bf16 = DTYPES[dtype]
    vec = M % (8 if bf16 else 4) == 0
    plan = cb.ln_stats_plan(T * N, M, bf16, vec, sms)
    x, _, _, xt, twin = _inputs(T, N, M, sum(shape), bf16)
    eps = F.scalar_like(F.LN_EPS, xt)
    got = _emulated_stats(x.reshape(T * N, M), plan, eps, bf16)
    for g, w, what in zip(got, twin, ("mean", "var", "rstd")):
        w = w.reshape(-1)
        if bf16:
            _within_ulp(g, w, what)
        else:
            _close(g, w, what)


def test_emulated_stats_take_every_cluster_size():
    """The plans of the emulated shapes reach the warp route and clusters
    of 1, 2, 4 and 8 blocks."""
    seen = {(p.route, p.cluster) for T, N, M, sms in EMULATED
            for bf16 in (False, True)
            for p in [cb.ln_stats_plan(T * N, M, bf16,
                                       M % (8 if bf16 else 4) == 0, sms)]}
    assert {("warp", 1), ("cluster", 1), ("cluster", 2), ("cluster", 4),
            ("cluster", 8)} <= seen


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", EMULATED, ids=str)
def test_emulated_bwd_equals_the_twin(shape, dtype):
    T, N, M, sms = shape
    bf16 = DTYPES[dtype]
    vec = M % (8 if bf16 else 4) == 0
    plan = cb.ln_bwd_plan(T, N, M, bf16, vec, sms, 2)
    x, dz, gamma, xt, (mean, _, rstd) = _inputs(T, N, M, 3 * sum(shape),
                                                bf16)
    mu, rs = (v.float().numpy().reshape(-1) for v in (mean, rstd))
    got = _emulated_bwd(dz.reshape(T * N, M), x.reshape(T * N, M), mu, rs,
                        gamma, plan, T, N)
    dtype_t = xt.dtype
    twin = F.layer_norm_bwd(
        torch.from_numpy(dz).to(dtype_t).reshape(xt.shape), xt, mean, rstd,
        torch.from_numpy(gamma).to(dtype_t).reshape(T, 1, 1, M))
    for g, w, what in zip(got, twin, ("dx", "dgamma", "dbeta")):
        w = w.reshape(g.shape)
        if bf16:
            _within_ulp(_bf16(g), w, what)
        else:
            _close(g, w, what)


def test_emulated_bwd_takes_every_row_group():
    seen = {p.tpr for T, N, M, sms in EMULATED for bf16 in (False, True)
            for p in [cb.ln_bwd_plan(T, N, M, bf16,
                                     M % (8 if bf16 else 4) == 0, sms, 2)]}
    assert {32, 64, 128, 256} <= seen


def test_emulated_kernels_equal_the_jax_layer_norm_and_its_vjp():
    """At a small map (7 x 7 x 24, M = 1,176) on the cluster route and row
    groups of 64 threads: the emulated statistics against the JAX
    package's ``layer_norm`` normalized output, and the emulated backward
    against ``jax.vjp`` of it in x, gamma and beta, per tenant."""
    T, N, H, W, C = 2, 3, 7, 7, 24
    M = H * W * C
    stats_plan = cb.ln_stats_plan(T * N, M, False, True, 2)
    bwd_plan = cb.ln_bwd_plan(T, N, M, False, True, 8, 2)
    assert stats_plan.cluster == 1 and stats_plan.route == "cluster"
    assert bwd_plan.tpr == 64 and bwd_plan.groups == 4
    x, dz, gamma, _, _ = _inputs(T, N, M, 5, False)
    beta = (0.1 * np.random.RandomState(6).randn(T, M)).astype(f32)
    mean, _, rstd = _emulated_stats(x.reshape(T * N, M), stats_plan,
                                    F.LN_EPS, False)
    dx, dgamma, dbeta = _emulated_bwd(dz.reshape(T * N, M),
                                      x.reshape(T * N, M), mean, rstd,
                                      gamma, bwd_plan, T, N)
    shape = (N, H, W, C)
    for t in range(T):
        xs = jnp.asarray(x[t].reshape(shape))
        gs, bs = (jnp.asarray(v[t].reshape(H, W, C)) for v in (gamma, beta))
        z, vjp = jax.vjp(lambda a, g, b: JF.layer_norm(a, g, b, F.LN_EPS),
                         xs, gs, bs)
        rows = slice(t * N, (t + 1) * N)
        xhat = ((x[t] - mean[rows, None]) * rstd[rows, None])
        _close(xhat * gamma[t] + beta[t],
               np.array(z).reshape(N, M), "z")
        want = vjp(jnp.asarray(dz[t].reshape(shape)))
        _close(dx[rows], np.array(want[0]).reshape(N, M), "dx")
        _close(dgamma[t], np.array(want[1]).reshape(M), "dgamma")
        _close(dbeta[t], np.array(want[2]).reshape(M), "dbeta")


# -- the double backward ---------------------------------------------------------

# (T, N, M) of every tensor chip_smoke.py's layer-norm phases give the double
# backward: the mini-ImageNet conv-first stages and the norm-first image at
# the 25 support images, the strided Omniglot layers and its 28 x 28 x 1
# image at 20, T = 8
BB_SHAPES = ([(8, 25, M) for M in MINI]
             + [(8, 20, M) for M in STRIDED])
SUMS = 7  # the double backward's row sums (``kSums``)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", BB_SHAPES, ids=str)
def test_bwd_bwd_plan_covers_each_value_once_and_fits_the_card(shape, dtype):
    """The double backward's plan is the backward's (``ln_bwd_plan``) on
    its own occupancy: at one and two blocks a SM every value of a row in
    one tile once, the items in even shares, every block resident; its
    scratch seven partials a (row, tile, warp) and eight coefficients a
    row; its
    shared memory one column sum a value of a block's load."""
    T, N, M = shape
    bf16 = DTYPES[dtype]
    v = 8 if bf16 else 4
    loads = M // v
    assert cb.LN_BWD_BWD_SUMS == SUMS
    for bps in (1, 2):
        plan = cb.ln_bwd_plan(T, N, M, bf16, True, SMS, bps)
        assert plan.vec == v and plan.groups * plan.tpr == plan.threads
        assert (plan.tiles - 1) * plan.tpr < loads <= plan.tiles * plan.tpr
        items = T * plan.tiles
        assert plan.grid == min(items, SMS * bps)
        edges = [b * items // plan.grid for b in range(plan.grid + 1)]
        assert all(b > a for a, b in zip(edges, edges[1:]))
        jw = plan.tiles * (plan.tpr // 32)
        R = T * N
        assert cb.ln_bwd_scratch(plan, R, SUMS) == R * (SUMS * jw + 8)
        assert cb.ln_bwd_scratch(plan, R) == 2 * R * (jw + 1)
        assert cb.ln_bwd_smem(v, SUMS) == 4 * v * cb.LN_THREADS <= BLOCK_SMEM


def _emulated_bwd_bwd(a, ggamma, gbeta, dz, x, mean, rstd, gamma, plan, T,
                      N):
    """g_dz, g_x, g_gamma of (T * N, M) a, dz and x, (T * N,) statistics
    and (T, M) ggamma, gbeta and gamma in the kernel's order (f32): (1) a
    thread's seven partials over its load's values in order, each warp's by
    a shuffle tree, one a (row, sum, tile, warp); (2) a row's partials of
    each sum, lane l the (tile, warp) partials l, l + 32, ..., then a tree;
    (3) the outputs from the row means, and g_gamma a thread's sum over its
    group's rows from the last to the first, then the groups in order."""
    R, M = x.shape
    v, tpr, G, J = plan.vec, plan.tpr, plan.groups, plan.tiles
    width = tpr * v
    pad = J * width - M

    def rows(t):
        return np.concatenate([t, np.zeros((R, pad), f32)], 1).reshape(
            R, J, tpr, v)

    def cols(t):
        return np.repeat(np.concatenate([t, np.zeros((T, pad), f32)], 1)
                         .reshape(T, J, tpr, v), N, 0)

    av, d, xx = rows(a), rows(dz), rows(x)
    gam, ggm = cols(gamma), cols(ggamma)
    xh = (xx - mean[:, None, None, None]) * rstd[:, None, None, None]
    gv = d * gam
    ggd = ggm * d
    terms = (av, av * xh, gv, gv * xh, av * gv, ggd, ggd * xh)
    wpg = tpr // 32
    part = np.zeros((R, SUMS, J * wpg), f32)
    for k, term in enumerate(terms):
        p = np.zeros((R, J, tpr), f32)
        for i in range(v):
            p = p + term[..., i]
        part[:, k] = _sum_tree(p.reshape(R, J, wpg, 32)).reshape(R, J * wpg)
    lanes = np.zeros((R, SUMS, 32), f32)
    for e in range(J * wpg):
        lanes[..., e % 32] = lanes[..., e % 32] + part[..., e]
    m = np.stack([_sum_tree(lanes[:, k]) for k in range(SUMS)], 1)
    m = m * f32(1.0 / M)
    m_a, m_ax, m_g, m_gx, m_ag, m_ggd, m_ggdx = (m[:, k:k + 1]
                                                 for k in range(SUMS))
    rs = rstd[:, None]
    mean_g = -rs * (m_a * m_gx + m_g * m_ax) + m_ggd
    mean_gx = f32(-2.0) * rs * m_ax * m_gx + m_ggdx
    cross = m_ag - m_a * m_g - m_ax * m_gx
    gam_f, ggm_f = np.repeat(gamma, N, 0), np.repeat(ggamma, N, 0)
    xh_f = (x - mean[:, None]) * rs
    p_a = a - m_a - xh_f * m_ax
    g_dz = gam_f * rs * p_a + ggm_f * xh_f + np.repeat(gbeta, N, 0)
    big_g = -rs * (a * m_gx + dz * gam_f * m_ax) + ggm_f * dz
    g_x = rs * (big_g - mean_g - xh_f * mean_gx) - xh_f * rs * rs * cross
    term = (dz * rs * p_a).reshape(T, N, M)
    groups = []
    for g in range(G):
        acc = np.zeros((T, M), f32)
        for n in reversed(range(g, N, G)):
            acc = acc + term[:, n]
        groups.append(acc)
    g_gamma = groups[0]
    if G > 1:
        g_gamma = np.zeros((T, M), f32)
        for acc in groups:
            g_gamma = g_gamma + acc
    return g_dz, g_x, g_gamma


def _bb_inputs(T, N, M, seed, bf16):
    """a, ggamma, gbeta (numpy f32, bf16 values in bf16) beside
    ``_inputs``' x, dz, gamma and statistics."""
    x, dz, gamma, xt, stats = _inputs(T, N, M, seed, bf16)
    rng = np.random.RandomState(seed + 1)
    a = rng.randn(T, N, M).astype(f32)
    ggamma = rng.randn(T, M).astype(f32)
    gbeta = rng.randn(T, M).astype(f32)
    if bf16:
        a, ggamma, gbeta = _bf16(a), _bf16(ggamma), _bf16(gbeta)
    return a, ggamma, gbeta, x, dz, gamma, xt, stats


def _close_scaled(got, want, what):
    """Within 1e-5 * min(1, scale) + 1e-4 * scale (the card's gate of the
    double backward: an absolute floor that never covers a small output)."""
    got = torch.as_tensor(np.asarray(got, dtype=np.float64))
    want = torch.as_tensor(np.asarray(want, dtype=np.float64))
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    assert err <= ATOL * min(1.0, scale) + RTOL * scale, (what, err, scale)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", EMULATED, ids=str)
def test_emulated_bwd_bwd_equals_the_twin(shape, dtype):
    T, N, M, sms = shape
    bf16 = DTYPES[dtype]
    vec = M % (8 if bf16 else 4) == 0
    plan = cb.ln_bwd_plan(T, N, M, bf16, vec, sms, 2)
    a, ggamma, gbeta, x, dz, gamma, xt, (mean, _, rstd) = _bb_inputs(
        T, N, M, 7 * sum(shape), bf16)
    mu, rs = (v.float().numpy().reshape(-1) for v in (mean, rstd))
    got = _emulated_bwd_bwd(a.reshape(T * N, M), ggamma, gbeta,
                            dz.reshape(T * N, M), x.reshape(T * N, M), mu,
                            rs, gamma, plan, T, N)
    dtype_t = xt.dtype

    def t(v, shape):
        return torch.from_numpy(v).to(dtype_t).reshape(shape)

    twin = F.layer_norm_bwd_bwd(
        t(a, xt.shape), t(ggamma, (T, 1, 1, M)), t(gbeta, (T, 1, 1, M)),
        t(dz, xt.shape), xt, mean, rstd, t(gamma, (T, 1, 1, M)))
    for g, w, what in zip(got, twin, ("g_dz", "g_x", "g_gamma")):
        w = w.reshape(g.shape)
        if bf16:
            _within_ulp(_bf16(g), w, what)
        else:
            _close_scaled(g, w, what)


def test_emulated_bwd_bwd_equals_the_jax_second_derivative():
    """At a small map (7 x 7 x 24, M = 1,176) on row groups of 64 threads,
    f32: the emulated double backward (on the twin's statistics) against
    ``jax.vjp`` of the JAX package's ``layer_norm`` :447 differentiated
    once by ``jax.vjp`` — the gradients of <a, dx> + <ggamma, dgamma> +
    <gbeta, dbeta> with respect to dz, x (through the statistics too) and
    gamma — per tenant, within 1e-5 + 1e-4 * scale."""
    T, N, H, W, C = 2, 3, 7, 7, 24
    M = H * W * C
    plan = cb.ln_bwd_plan(T, N, M, False, True, 8, 2)
    assert plan.tpr == 64 and plan.groups == 4
    a, ggamma, gbeta, x, dz, gamma, _, (mean, _, rstd) = _bb_inputs(
        T, N, M, 9, False)
    got = _emulated_bwd_bwd(a.reshape(T * N, M), ggamma, gbeta,
                            dz.reshape(T * N, M), x.reshape(T * N, M),
                            mean.numpy().reshape(-1),
                            rstd.numpy().reshape(-1), gamma, plan, T, N)
    beta = (0.1 * np.random.RandomState(10).randn(T, M)).astype(f32)
    shape = (N, H, W, C)

    def first(dzs, xs, gs, bs):
        _, vjp = jax.vjp(lambda u, g, b: JF.layer_norm(u, g, b, F.LN_EPS),
                         xs, gs, bs)
        return vjp(dzs)

    for t in range(T):
        j = [jnp.asarray(v) for v in (dz[t].reshape(shape),
                                      x[t].reshape(shape),
                                      gamma[t].reshape(H, W, C),
                                      beta[t].reshape(H, W, C))]
        _, vjp2 = jax.vjp(lambda u, v, g: first(u, v, g, j[3]), *j[:3])
        want = vjp2((jnp.asarray(a[t].reshape(shape)),
                     jnp.asarray(ggamma[t].reshape(H, W, C)),
                     jnp.asarray(gbeta[t].reshape(H, W, C))))
        rows = slice(t * N, (t + 1) * N)
        _close(got[0][rows], np.array(want[0]).reshape(N, M), "g_dz")
        _close(got[1][rows], np.array(want[1]).reshape(N, M), "g_x")
        _close(got[2][t], np.array(want[2]).reshape(M), "g_gamma")
