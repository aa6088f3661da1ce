"""The launch plan of K3 and K5 pooled (``conv_block.bn_bwd_plan``, the
cooperative kernels of ``kernels/csrc/bn_act_pool_bwd.cu``), on the CPU,
in f32 and bf16: a pure function of the shape, checked at every shape the shipped
configs give K3 and K5 — the mini-ImageNet conv outputs (84/42/21/10, and
the unpadded 82/39/17/6; 48 channels) and Omniglot's (28/14/7/3, 64
channels), at the configs' task batches (2, 8 and the large-batch
config's 256) and image counts — and emulated in plain PyTorch: each
thread's windows summed in order, each block's slots in order, each
column's blocks merged over 32 lane-strided runs and a shuffle tree, then
the apply pass on the merged sums, against the twins
(``ops/functional.py::bn_act_pool_bwd``, ``::bn_act_pool_bwd_bwd``)
within f32 round-off; and at one small odd map against the JAX package's
``batch_norm`` :368 -> ``leaky_relu`` :363 -> ``max_pool2d`` :325,
differentiated once and twice by ``jax.vjp`` (run eagerly on the CPU).

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
from test_torch_conv_mma_plan import _ulp, _within_ulp

BF16 = torch.bfloat16
SMS = 132  # an H100 SXM's SMs
# (H = W, C) of each pooled conv output: mini-ImageNet pad 1 and pad 0,
# Omniglot
MINI = ((84, 48), (42, 48), (21, 48), (10, 48))
UNPADDED = ((82, 48), (39, 48), (17, 48), (6, 48))
OMNIGLOT = ((28, 64), (14, 64), (7, 64), (3, 64))
# (T, N, H = W, C): mini-ImageNet 5-way 1- and 5-shot (support 5 / 25,
# target 75) at batch 2, 8 and 256; Omniglot 20-way 1- and 5-shot (20 and
# 100 images) and 5-way (5, 25) at batch 2, 8 and 256
MAIN_SHAPES = (
    [(T, n, hw, C) for T in (2, 8, 256) for n in (5, 25, 75)
     for hw, C in MINI + UNPADDED]
    + [(T, n, hw, C) for T in (2, 8, 256) for n in (5, 20, 25, 100)
       for hw, C in OMNIGLOT]
)
# the blocks a SM the occupancy query gives the kernels on an H100 (K3 3
# with 16-byte loads, 2 without; K5 2), and one more
BLOCKS_PER_SM = (2, 3, 4)
RTOL, ATOL = 1e-4, 1e-5  # the card's twin gate


def _window_positions(H, W):
    """Each window's positions, ``(windows an image, 4)`` pixel indices in
    the order 2 * dh + dw, -1 where an odd map's window has none."""
    Hc, Wc = -(-H // 2), -(-W // 2)
    hw, ww = np.meshgrid(np.arange(Hc), np.arange(Wc), indexing="ij")
    out = np.full((Hc * Wc, 4), -1)
    for q in range(4):
        h, w = 2 * hw + q // 2, 2 * ww + q % 2
        ok = (h < H) & (w < W)
        out[:, q] = np.where(ok, h * W + w, -1).reshape(-1)
    return out


@pytest.mark.parametrize("bps", BLOCKS_PER_SM)
@pytest.mark.parametrize("shape", MAIN_SHAPES, ids=str)
def test_plan_covers_each_position_once_and_fits_the_card(shape, bps):
    T, N, hw, C = shape
    plan = cb.bn_bwd_plan(T, N, hw, hw, C, SMS, bps)
    assert plan == cb.bn_bwd_plan(T, N, hw, hw, C, SMS, bps)  # pure
    blocks, grid_t = plan.grid
    assert grid_t == T
    # a block of 256 threads: slots windows x ceil(C / 4) channel groups
    assert plan.threads == cb.BN_BWD_THREADS == 256
    assert plan.groups == -(-C // 4)
    assert plan.slots == 256 // plan.groups
    assert plan.slots * plan.groups <= plan.threads
    # the windows tile each image: every position in exactly one window,
    # the pooled 2 x 2 windows whole
    Hc = -(-hw // 2)
    assert plan.windows == N * Hc * Hc
    pos = _window_positions(hw, hw)
    got = np.sort(pos[pos >= 0])
    assert np.array_equal(got, np.arange(hw * hw))
    full = (pos >= 0).all(axis=1)
    assert full.sum() == (hw // 2) ** 2
    # the chunks, of whole slots of windows, tile each tenant's windows;
    # no chunk spans two tenants (each block is one tenant's, grid y)
    assert plan.chunk % plan.slots == 0 and plan.chunk >= plan.slots
    assert (blocks - 1) * plan.chunk < plan.windows <= blocks * plan.chunk
    # every block co-resident (the cooperative launch needs it)
    assert blocks * T <= SMS * bps
    # the chunks as short as the co-resident blocks allow: one slots of
    # windows shorter would take more blocks a tenant than the card holds
    if plan.chunk > plan.slots:
        assert -(-plan.windows // (plan.chunk - plan.slots)) > SMS * bps // T
    # so every SM gets a block where the windows allow (at T = 2, every
    # map but the smallest)
    assert blocks * T >= min(SMS, T * -(-plan.windows // plan.slots))


def test_the_flagship_plans_fill_the_card_at_batch_2():
    """The design's shapes: at T = 2 the mini-ImageNet maps of 84 and 42
    pixels (82 and 39 unpadded) spread each tenant over more than half the
    SMs, so every SM gets a block, and over more than half the card's
    co-resident blocks; 21 windows x 12 groups of 4 channels a block."""
    for hw in (84, 42, 82, 39):
        for bps in (2, 3):
            plan = cb.bn_bwd_plan(2, 25, hw, hw, 48, SMS, bps)
            assert plan.grid[0] > SMS // 2 and plan.grid[0] > SMS * bps // 4
            assert plan.slots == 21 and plan.groups == 12


@pytest.mark.parametrize("shape", [(2, 25, 84, 84, 48), (8, 20, 7, 7, 64),
                                   (2, 3, 11, 9, 17)], ids=str)
def test_bf16_k3_plans_the_cuda_kernel_in_groups_of_8(shape):
    """Both dtypes plan K3 and K5 on the CUDA kernels: K3 in f32 a thread 4
    channels (one 16-byte load of f32), in bf16 8 (one of bf16), so a bf16
    block takes twice the windows at a time; K5 4 channels a thread in
    both dtypes (one 8-byte load of bf16: its five sums of 8 channels
    would not fit the register budget), so the bf16 K5's plan is the f32
    K5's. The pool-free modes never plan: their wrappers (``bn_act_bwd``,
    ``batch_norm_bwd`` and their derivatives) launch csrc/bn_act_bwd.cu
    and the Triton K5."""
    T, N, H, W, C = shape
    f32 = cb.bn_bwd_plan(*shape, SMS, 2)
    bf16 = cb.bn_bwd_plan(*shape, SMS, 2, bf16=True)
    assert (f32.groups, bf16.groups) == (-(-C // 4), -(-C // 8))
    assert bf16.slots == 256 // bf16.groups >= f32.slots
    assert bf16.windows == f32.windows == N * -(-H // 2) * -(-W // 2)
    k5 = cb.bn_bwd_plan(*shape, SMS, 2, name="bn_act_pool_bwd_bwd")
    assert k5 == f32 == cb.bn_bwd_plan(*shape, SMS, 2, True,
                                       "bn_act_pool_bwd_bwd")
    assert cb.BN_BWD_GROUP == {
        ("bn_act_pool_bwd", False): 4, ("bn_act_pool_bwd", True): 8,
        ("bn_act_pool_bwd_bwd", False): 4, ("bn_act_pool_bwd_bwd", True): 4}


def test_bn_bwd_plan_refuses_what_the_card_cannot_hold():
    with pytest.raises(ValueError, match="tenants need a block"):
        cb.bn_bwd_plan(265, 25, 84, 84, 48, SMS, 2)
    for bad in ((2, 3, 1, 8, 48), (2, 3, 8, 8, 65), (2, 3, 8, 8, 0)):
        with pytest.raises(ValueError, match="no pooled K3/K5"):
            cb.bn_bwd_plan(*bad, SMS, 2)


# -- the kernels' order, emulated ---------------------------------------------


def _windows(v):
    """(T, N, H, W, C) -> (T, windows, 4, C): each window's positions in
    the order 2 * dh + dw, zero where an odd map's window has none."""
    T, N, H, W, C = v.shape
    Hc, Wc = -(-H // 2), -(-W // 2)
    p = v.new_zeros(T, N, 2 * Hc, 2 * Wc, C)
    p[:, :, :H, :W] = v
    p = p.reshape(T, N, Hc, 2, Wc, 2, C).permute(0, 1, 2, 4, 3, 5, 6)
    return p.reshape(T, N * Hc * Wc, 4, C)


def _emulated_sum(plan, terms):
    """The kernels' per-(tenant, channel) sum of ``terms`` ``(T, windows,
    4, C)``: a thread (block b, slot s) adds window b * chunk + s + k *
    slots, k = 0, 1, ..., position by position into its running sum; a
    block adds its slots in order; a warp merges a column's blocks, lane l
    the blocks l, l + 32, ... in order, then a tree of strides 16 to 1 into
    lane 0."""
    T, _, _, C = terms.shape
    B, chunk, slots = plan.grid[0], plan.chunk, plan.slots
    pad = terms.new_zeros(T, B * chunk - plan.windows, 4, C)
    w = torch.cat([terms, pad], 1).reshape(T, B, chunk // slots, slots, 4, C)
    acc = terms.new_zeros(T, B, slots, C)
    for k in range(chunk // slots):
        for q in range(4):
            acc = acc + w[:, :, k, :, q]
    block = terms.new_zeros(T, B, C)
    for s in range(slots):
        block = block + acc[:, :, s]
    lanes = terms.new_zeros(T, 32, C)
    for b in range(B):
        lanes[:, b % 32] = lanes[:, b % 32] + block[:, b]
    off = 16
    while off:
        lanes[:, :off] = lanes[:, :off] + lanes[:, off:2 * off]
        off //= 2
    return lanes[:, 0]


def _pc(v):
    return v[:, None, None, None, :]


def _emulated_k3(plan, dp, arg, y, mean, rstd, gamma, beta, slope):
    """K3 as the kernel orders it: the sums of dz and dz xhat (dz nonzero
    at each pooled window's argmax only), then dy from them."""
    H, W = y.shape[2:4]
    xhat = (y - _pc(mean)) * _pc(rstd)
    z = xhat * _pc(gamma) + _pc(beta)
    dz = F._unpool(dp, arg, H, W)
    dz = torch.where(z >= 0, dz, dz * slope)
    s_dz = _emulated_sum(plan, _windows(dz))
    s_dzx = _emulated_sum(plan, _windows(dz * xhat))
    inv_m = 1.0 / (y.shape[1] * H * W)
    dy = _pc(gamma * rstd) * (dz - _pc(s_dz * inv_m)
                              - xhat * _pc(s_dzx * inv_m))
    return dy, s_dzx, s_dz


def _emulated_k5(plan, a, ggamma, gbeta, dp, arg, y, mean, rstd, gamma,
                 beta, slope):
    """K5 as the kernel orders it: the five sums, the per-channel values
    of the apply pass, then g_dpooled, g_y, g_gamma."""
    H, W = y.shape[2:4]
    xhat = (y - _pc(mean)) * _pc(rstd)
    z = xhat * _pc(gamma) + _pc(beta)
    pos = z >= 0
    dz = F._unpool(dp, arg, H, W)
    dz = torch.where(pos, dz, dz * slope)
    s_a, s_ax, s_dz, s_dzx, s_adz = (
        _emulated_sum(plan, _windows(v))
        for v in (a, a * xhat, dz, dz * xhat, a * dz))
    inv_m = 1.0 / (y.shape[1] * H * W)
    m_a, m_ax = s_a * inv_m, s_ax * inv_m
    m_dz, m_dzx = s_dz * inv_m, s_dzx * inv_m
    cross = s_adz - (m_a * s_dz + m_ax * s_dzx)
    grs = gamma * rstd
    mean_g = -grs * (m_dzx * m_a + m_ax * m_dz) + ggamma * m_dz
    mean_gx = -2.0 * grs * m_ax * m_dzx + ggamma * m_dzx
    lr = rstd * rstd * inv_m * gamma * cross
    big_g = -_pc(grs) * (_pc(m_dzx) * a + _pc(m_ax) * dz) + _pc(ggamma) * dz
    g_y = (_pc(rstd) * (big_g - _pc(mean_g) - xhat * _pc(mean_gx))
           - xhat * _pc(lr))
    gdz = (_pc(grs) * (a - _pc(m_a) - xhat * _pc(m_ax))
           + _pc(ggamma) * xhat + _pc(gbeta))
    gdz = torch.where(pos, gdz, gdz * slope)
    g_dp = torch.gather(F._windows(gdz), -1,
                        arg.long().unsqueeze(-1)).squeeze(-1)
    return g_dp, g_y, rstd * cross


def _inputs(T, N, H, W, C, seed):
    """y, its statistics, gamma, beta, K2's argmax (the twin's), a pooled
    gradient, and K5's cotangents, from a numpy seed."""
    rng = np.random.RandomState(seed)

    def r(*s, scale=1.0):
        return torch.from_numpy((rng.randn(*s) * scale).astype(np.float32))

    y = 2.0 * r(T, N, H, W, C) + 0.3
    mean, _, rstd = F.bn_stats(y)
    gamma, beta = 1.0 + r(T, C, scale=0.1), r(T, C, scale=0.1)
    _, arg = F.bn_act_pool_fwd(y, mean, rstd, gamma, beta)
    dp = r(T, N, H // 2, W // 2, C)
    k3 = (dp, arg, y, mean, rstd, gamma, beta)
    return k3, (r(T, N, H, W, C), r(T, C), r(T, C)) + k3


def _close(got, want, what):
    err = (got.double() - want.double()).abs().max().item()
    scale = want.double().abs().max().item()
    assert err <= ATOL + RTOL * scale, (what, err, scale)


# small shapes whose plans cut a tenant over several blocks (sms and
# blocks a SM chosen for that), odd maps (the dropped row and column), C
# not a multiple of 4, one window a thread and several, more than 32 blocks
# a tenant (the merge's lanes take several each)
EMULATED = [
    # T, N, H, W, C, sms, blocks a SM
    (2, 3, 9, 7, 20, 4, 2),
    (2, 3, 11, 9, 17, 8, 1),
    (1, 1, 5, 5, 3, 1, 1),
    (2, 4, 11, 11, 64, 8, 2),
    (3, 2, 21, 21, 48, 16, 3),
    (1, 20, 14, 14, 64, 64, 1),
    (2, 4, 6, 30, 5, 3, 2),
    (2, 5, 10, 10, 48, 2, 2),
]


@pytest.mark.parametrize("shape", EMULATED, ids=str)
def test_emulated_k3_equals_the_twin(shape):
    T, N, H, W, C, sms, bps = shape
    plan = cb.bn_bwd_plan(T, N, H, W, C, sms, bps)
    k3, _ = _inputs(T, N, H, W, C, sum(shape))
    slope = F.scalar_like(F.LEAKY_SLOPE, k3[2])
    for got, want, what in zip(_emulated_k3(plan, *k3, slope),
                               F.bn_act_pool_bwd(*k3),
                               ("dy", "dgamma", "dbeta")):
        _close(got, want, what)


@pytest.mark.parametrize("shape", EMULATED, ids=str)
def test_emulated_k5_equals_the_twin(shape):
    T, N, H, W, C, sms, bps = shape
    plan = cb.bn_bwd_plan(T, N, H, W, C, sms, bps)
    _, k5 = _inputs(T, N, H, W, C, 2 * sum(shape))
    slope = F.scalar_like(F.LEAKY_SLOPE, k5[5])
    for got, want, what in zip(_emulated_k5(plan, *k5, slope),
                               F.bn_act_pool_bwd_bwd(*k5),
                               ("g_dpooled", "g_y", "g_gamma")):
        _close(got, want, what)


def _jax_block(y, gamma, beta):
    """The JAX package's batch norm (batch statistics) -> leaky-ReLU ->
    2 x 2 max pool of one tenant's conv output."""
    z, _, _ = JF.batch_norm(y, gamma, beta, None, None, eps=F.BN_EPS)
    return JF.max_pool2d(JF.leaky_relu(z, F.LEAKY_SLOPE), impl="reshape")


def _jax_k3(dp, y, gamma, beta):
    _, vjp = jax.vjp(_jax_block, y, gamma, beta)
    return vjp(dp)


def test_emulated_k3_and_k5_equal_the_jax_vjp_once_and_twice():
    """At a small odd map (9 x 7: the pool drops a row and a column, which
    still get a gradient through the batch statistics) cut over several
    blocks: the emulated K3 against ``jax.vjp`` of the JAX block, and the
    emulated K5 against ``jax.vjp`` of that vjp (the derivative
    second-order MAML takes), per tenant."""
    T, N, H, W, C, sms, bps = shape = (2, 3, 9, 7, 20, 4, 2)
    plan = cb.bn_bwd_plan(T, N, H, W, C, sms, bps)
    assert plan.grid[0] > 1
    k3, k5 = _inputs(T, N, H, W, C, 11)
    slope = F.scalar_like(F.LEAKY_SLOPE, k3[2])
    dp, _, y, _, _, gamma, beta = k3
    a, ggamma, gbeta = k5[:3]
    got3 = _emulated_k3(plan, *k3, slope)
    got5 = _emulated_k5(plan, *k5, slope)
    for t in range(T):
        j = [jnp.asarray(v[t].numpy()) for v in (dp, y, gamma, beta)]
        want3 = _jax_k3(*j)
        _, vjp2 = jax.vjp(_jax_k3, *j)
        want5 = vjp2(tuple(jnp.asarray(v[t].numpy())
                           for v in (a, ggamma, gbeta)))
        for got, want, what in zip((g[t] for g in got3), want3,
                                   ("dy", "dgamma", "dbeta")):
            _close(got, torch.from_numpy(np.array(want)), what)
        for got, want, what in zip((g[t] for g in got5), want5[:3],
                                   ("g_dpooled", "g_y", "g_gamma")):
            _close(got, torch.from_numpy(np.array(want)), what)
        # beta enters only through the piecewise-constant masks
        assert float(jnp.abs(want5[3]).max()) == 0.0


# -- K3 in bf16 ------------------------------------------------------------------


@pytest.mark.parametrize("bps", (2, 3))
@pytest.mark.parametrize("shape", MAIN_SHAPES, ids=str)
def test_bf16_plan_covers_each_window_once_and_fits_the_card(shape, bps):
    """The bf16 K3's plan: 8 channels a thread (one 16-byte load), 256 //
    ceil(C / 8) windows at a time, the chunks whole slots of windows that
    tile each tenant's windows once, every block co-resident."""
    T, N, hw, C = shape
    plan = cb.bn_bwd_plan(T, N, hw, hw, C, SMS, bps, bf16=True)
    assert plan == cb.bn_bwd_plan(T, N, hw, hw, C, SMS, bps, bf16=True)
    blocks, grid_t = plan.grid
    assert grid_t == T
    assert plan.groups == -(-C // 8) and plan.slots == 256 // plan.groups
    assert plan.windows == N * (-(-hw // 2)) ** 2
    assert plan.chunk % plan.slots == 0 and plan.chunk >= plan.slots
    assert (blocks - 1) * plan.chunk < plan.windows <= blocks * plan.chunk
    assert blocks * T <= SMS * bps
    assert blocks * T >= min(SMS, T * -(-plan.windows // plan.slots))


def _bf16(v):
    return v.to(BF16).float()


def _emulated_k3_bf16(plan, dp, arg, y, mean, rstd, gamma, beta, slope):
    """The bf16 K3 as the kernel orders and rounds it: the masks by K2's
    chain (each op of ``(y - mean) * rstd * gamma + beta`` rounded to
    bf16), xhat in f32 from the bf16 values, the sums of dz and dz xhat in
    the plan's order (``_emulated_sum``), dy from them; dy, dgamma and dbeta
    each rounded once to bf16."""
    H, W = y.shape[2:4]
    y, mean, rstd, gamma, beta, dp = (
        v.float() for v in (y, mean, rstd, gamma, beta, dp))
    xhat = (y - _pc(mean)) * _pc(rstd)
    z = _bf16(_bf16(_bf16(_bf16(y - _pc(mean)) * _pc(rstd)) * _pc(gamma))
              + _pc(beta))
    dz = F._unpool(dp, arg, H, W)
    dz = torch.where(z >= 0, dz, dz * slope)
    s_dz = _emulated_sum(plan, _windows(dz))
    s_dzx = _emulated_sum(plan, _windows(dz * xhat))
    inv_m = 1.0 / (y.shape[1] * H * W)
    dy = _pc(gamma * rstd) * (dz - _pc(s_dz * inv_m)
                              - xhat * _pc(s_dzx * inv_m))
    return dy.to(BF16), s_dzx.to(BF16), s_dz.to(BF16)


def _bf16_inputs(T, N, H, W, C, seed):
    """K3's bf16 inputs: y whose four positions of each window lie at least
    0.1 apart (0.3 steps in a random order, uniform noise within 0.1: no
    window ties in bf16, so the f32 block's argmax is the bf16 chain's and
    no tie splits JAX's gradient of the max), its bf16 statistics, gamma,
    beta, the twin K2's argmax and a pooled gradient."""
    rng = np.random.RandomState(seed)
    Hc, Wc = -(-H // 2), -(-W // 2)
    steps = np.argsort(rng.rand(T, N, Hc, Wc, C, 4), axis=-1) * 0.3
    steps = steps.reshape(T, N, Hc, Wc, C, 2, 2).transpose(
        0, 1, 2, 5, 3, 6, 4).reshape(T, N, 2 * Hc, 2 * Wc, C)
    y = (steps[:, :, :H, :W] + rng.uniform(-0.1, 0.1, (T, N, H, W, C))
         + 0.05 * rng.randn(T, N, 1, 1, C) - 0.4)
    y = torch.from_numpy(y.astype(np.float32)).to(BF16)
    mean, _, rstd = F.bn_stats(y)
    gamma = torch.from_numpy(
        (1.0 + 0.1 * rng.randn(T, C)).astype(np.float32)).to(BF16)
    beta = torch.from_numpy((0.1 * rng.randn(T, C)).astype(np.float32)).to(
        BF16)
    _, arg = F.bn_act_pool_fwd(y, mean, rstd, gamma, beta)
    dp = torch.from_numpy(rng.randn(T, N, H // 2, W // 2, C).astype(
        np.float32)).to(BF16)
    return dp, arg, y, mean, rstd, gamma, beta


@pytest.mark.parametrize("shape", EMULATED, ids=str)
def test_emulated_bf16_k3_equals_the_twin(shape):
    """Within one bf16 ulp or 1e-4 of the output's scale (the card's gate):
    the twin sums dz and dz xhat in another order."""
    T, N, H, W, C, sms, bps = shape
    plan = cb.bn_bwd_plan(T, N, H, W, C, sms, bps, bf16=True)
    k3 = _bf16_inputs(T, N, H, W, C, sum(shape))
    slope = F.scalar_like(F.LEAKY_SLOPE, k3[2])
    got = _emulated_k3_bf16(plan, *k3, slope)
    for g, w, what in zip(got, F.bn_act_pool_bwd(*k3),
                          ("dy", "dgamma", "dbeta")):
        _within_ulp(g, w, what)


def _jax_decisions(y, gamma, beta):
    """The JAX block's pool argmax (first maximum) and leaky signs at each
    argmax, in its own dtype."""
    z, _, _ = JF.batch_norm(y, gamma, beta, None, None, eps=F.BN_EPS)
    a = JF.leaky_relu(z, F.LEAKY_SLOPE)
    H, W, C = a.shape[1:]
    win = a[:, :H // 2 * 2, :W // 2 * 2].reshape(
        -1, H // 2, 2, W // 2, 2, C).transpose(0, 1, 3, 5, 2, 4).reshape(
        -1, H // 2, W // 2, C, 4)
    zw = z[:, :H // 2 * 2, :W // 2 * 2].reshape(
        -1, H // 2, 2, W // 2, 2, C).transpose(0, 1, 3, 5, 2, 4).reshape(
        -1, H // 2, W // 2, C, 4)
    k = jnp.argmax(win, axis=-1)
    return (np.array(k),
            np.array(jnp.take_along_axis(zw, k[..., None], -1)[..., 0] >= 0))


def test_emulated_bf16_k3_equals_the_jax_vjp():
    """At a small odd map (9 x 7: the pool drops a row and a column) cut
    over several blocks, per tenant, the emulated bf16 K3 against
    ``jax.vjp`` of the JAX block: (1) the bf16 block's decisions (its pool
    argmax and leaky signs, from the bf16 ``jax.vjp``'s forward) are the
    twin K2's; (2) against the f32 ``jax.vjp`` on the same bf16 values,
    whose decisions are the same on these inputs (asserted), each output
    rounded once: within 2 bf16 ulps or 1e-3 of the output's scale (the
    kernel takes K1's statistics rounded to bf16, the f32 block its own);
    (3) against the bf16 ``jax.vjp``: no farther than that vjp lies from
    the f32 one, plus one ulp (XLA:CPU sums the bf16 gradient's reductions
    in a bf16 accumulator, the kernel in f32)."""
    T, N, H, W, C, sms, bps = (2, 3, 9, 7, 48, 4, 2)
    plan = cb.bn_bwd_plan(T, N, H, W, C, sms, bps, bf16=True)
    assert plan.grid[0] > 1
    k3 = _bf16_inputs(T, N, H, W, C, 13)
    dp, arg, y, mean, rstd, gamma, beta = k3
    slope = F.scalar_like(F.LEAKY_SLOPE, y)
    got = _emulated_k3_bf16(plan, *k3, slope)
    z = F._affine_act(y, mean, rstd, gamma, beta)[1]
    sign = torch.gather(F._windows(z), -1,
                        arg.long().unsqueeze(-1)).squeeze(-1) >= 0
    win = F._windows(F.bn_act_fwd(y, mean, rstd, gamma, beta))
    assert ((win == win.max(-1, keepdim=True).values).sum(-1) == 1).all()
    with jax.disable_jit():
        for t in range(T):
            j16 = [jnp.asarray(v[t].float().numpy()).astype(jnp.bfloat16)
                   for v in (dp, y, gamma, beta)]
            j32 = [v.astype(jnp.float32) for v in j16]
            for j in (j16, j32):
                k, pos = _jax_decisions(*j[1:])
                assert np.array_equal(k, arg[t].numpy().astype(np.int64))
                assert np.array_equal(pos, sign[t].numpy())
            want32 = _jax_k3(*j32)
            want16 = _jax_k3(*j16)
            for i, what in enumerate(("dy", "dgamma", "dbeta")):
                g = got[i][t].double()
                w32 = torch.from_numpy(np.array(want32[i])).double()
                w16 = torch.from_numpy(
                    np.array(want16[i].astype(jnp.float32))).double()
                ulp = _ulp(w32.to(BF16))
                tol = torch.clamp_min(2 * ulp, 1e-3 * w32.abs().max().item())
                assert ((g - w32.to(BF16).double()).abs() <= tol).all(), what
                spread = (w16 - w32).abs().max().item()
                assert ((g - w16).abs() <= spread + _ulp(w16.to(BF16))
                        ).all(), what


# -- K5 in bf16 ------------------------------------------------------------------

# the bf16 K5's shapes: every pooled conv output of the shipped configs at
# the support images second-order training differentiates (N = 25, and 20
# at Omniglot), T = 2, 8 and 256
K5_BF16_SHAPES = [s for s in MAIN_SHAPES if s[1] in (20, 25)]


@pytest.mark.parametrize("shape", K5_BF16_SHAPES, ids=str)
def test_bf16_k5_plan_covers_each_window_once_and_fits_the_card(shape):
    """The bf16 K5's plan: 4 channels a thread (one 8-byte load), 256 //
    ceil(C / 4) windows at a time, the chunks whole slots of windows that
    tile each tenant's windows once, every block co-resident, at the two
    and three blocks a SM the occupancy query may give it."""
    T, N, hw, C = shape
    for bps in (2, 3):
        plan = cb.bn_bwd_plan(T, N, hw, hw, C, SMS, bps, True,
                              "bn_act_pool_bwd_bwd")
        blocks, grid_t = plan.grid
        assert grid_t == T and plan.threads == 256
        assert plan.groups == -(-C // 4) and plan.slots == 256 // plan.groups
        assert plan.windows == N * (-(-hw // 2)) ** 2
        assert plan.chunk % plan.slots == 0 and plan.chunk >= plan.slots
        assert (blocks - 1) * plan.chunk < plan.windows <= blocks * plan.chunk
        assert blocks * T <= SMS * bps
        assert blocks * T >= min(SMS, T * -(-plan.windows // plan.slots))


def _emulated_k5_bf16(plan, a, ggamma, gbeta, dp, arg, y, mean, rstd, gamma,
                      beta, slope):
    """The bf16 K5 as the kernel orders and rounds it: the masks by K2's
    chain (each op of ``(y - mean) * rstd * gamma + beta`` rounded to
    bf16), xhat in f32 from the bf16 values, the five sums in the plan's
    order (``_emulated_sum``), the apply pass's per-channel values from
    them in f32; g_dpooled, g_y and g_gamma each rounded once to bf16."""
    H, W = y.shape[2:4]
    a, ggamma, gbeta, dp, y, mean, rstd, gamma, beta = (
        v.float() for v in (a, ggamma, gbeta, dp, y, mean, rstd, gamma,
                            beta))
    xhat = (y - _pc(mean)) * _pc(rstd)
    z = _bf16(_bf16(_bf16(_bf16(y - _pc(mean)) * _pc(rstd)) * _pc(gamma))
              + _pc(beta))
    pos = z >= 0
    dz = F._unpool(dp, arg, H, W)
    dz = torch.where(pos, dz, dz * slope)
    s_a, s_ax, s_dz, s_dzx, s_adz = (
        _emulated_sum(plan, _windows(v))
        for v in (a, a * xhat, dz, dz * xhat, a * dz))
    inv_m = 1.0 / (y.shape[1] * H * W)
    m_a, m_ax = s_a * inv_m, s_ax * inv_m
    m_dz, m_dzx = s_dz * inv_m, s_dzx * inv_m
    cross = s_adz - (m_a * s_dz + m_ax * s_dzx)
    grs = gamma * rstd
    mean_g = -grs * (m_dzx * m_a + m_ax * m_dz) + ggamma * m_dz
    mean_gx = -2.0 * grs * m_ax * m_dzx + ggamma * m_dzx
    lr = rstd * rstd * inv_m * gamma * cross
    big_g = -_pc(grs) * (_pc(m_dzx) * a + _pc(m_ax) * dz) + _pc(ggamma) * dz
    g_y = (_pc(rstd) * (big_g - _pc(mean_g) - xhat * _pc(mean_gx))
           - xhat * _pc(lr))
    gdz = (_pc(grs) * (a - _pc(m_a) - xhat * _pc(m_ax))
           + _pc(ggamma) * xhat + _pc(gbeta))
    gdz = torch.where(pos, gdz, gdz * slope)
    g_dp = torch.gather(F._windows(gdz), -1,
                        arg.long().unsqueeze(-1)).squeeze(-1)
    return g_dp.to(BF16), g_y.to(BF16), (rstd * cross).to(BF16)


@pytest.mark.parametrize("shape", EMULATED, ids=str)
def test_emulated_bf16_k5_equals_the_twin(shape):
    """Within one bf16 ulp or 1e-4 of the output's scale (the card's gate),
    on the bf16 K3 inputs (no window ties) and bf16 cotangents: the twin
    sums the five in another order."""
    T, N, H, W, C, sms, bps = shape
    plan = cb.bn_bwd_plan(T, N, H, W, C, sms, bps, True,
                          "bn_act_pool_bwd_bwd")
    k3 = _bf16_inputs(T, N, H, W, C, 3 * sum(shape))
    rng = np.random.RandomState(5 * sum(shape))
    a, ggamma, gbeta = (
        torch.from_numpy(rng.randn(*s).astype(np.float32)).to(BF16)
        for s in ((T, N, H, W, C), (T, C), (T, C)))
    k5 = (a, ggamma, gbeta) + k3
    slope = F.scalar_like(F.LEAKY_SLOPE, k3[2])
    got = _emulated_k5_bf16(plan, *k5, slope)
    for g, w, what in zip(got, F.bn_act_pool_bwd_bwd(*k5),
                          ("g_dpooled", "g_y", "g_gamma")):
        _within_ulp(g, w, what)
