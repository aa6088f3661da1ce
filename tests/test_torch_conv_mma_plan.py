"""The launch plan of the bf16 stride-1 convs on the tensor cores
(``conv_block.mma_plan``, reached through ``fwd_plan`` and ``dgrad_plan``:
K1 with statistics and stats-free, K4 dgrad, csrc/conv3x3_s1_bf16.cu), on
the CPU: a pure function of the shape, checked at every shape the shipped
configs give these kernels — the mini-ImageNet stages (84/42/21/10 at pad
1, 84/41/19/8 at pad 0; cin 3 then 48, cout 48) at 5, 25 and 75 images,
Omniglot's layers (28/14/7/3; cin 1 then 64, cout 64) at 5, 20, 25 and 100
images, dgrad back to the normalized image (cin 3), at the configs' task
batches — and emulated in plain PyTorch: the kernel's decomposition driven
by the plan (the band with its halo on the ``Wo + 2``-wide grid, the taps
as row offsets, the patch rows packed into K at cin <= 3, dgrad's weights
read in place flipped and transposed at pad ``2 - pad``, f32 sums of k16
slices tap by tap, the epilogue's roundings, each band's (count, mean, M2)
combined from its warps' and merged in the merge kernel's order) against
the plain twins within one bf16 ulp (two for a y with a bias: the sum and
the bias add each round), and at one small shape per pad and mode against
the JAX package's bf16 ``_conv2d_raw`` and its statistics (run eagerly on
the CPU) and, for dgrad, against the gradient XLA derives for
``_conv2d_raw`` in f32 on the same bf16 values, rounded once.

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
from test_torch_conv_fwd_plan import _chan_merge

BF16 = torch.bfloat16
SMS = 132  # an H100 SXM's SMs
MINI = ((84, 3), (42, 48), (21, 48), (10, 48))
MINI_P0 = ((84, 3), (41, 48), (19, 48), (8, 48))
OMNIGLOT = ((28, 1), (14, 64), (7, 64), (3, 64))
# (T, N, H, W, cin, cout, pad) of K1: mini-ImageNet 5-way 1- and 5-shot
# (support 5 / 25, target 75) at batch 2 and 8, padded and unpadded;
# Omniglot 5- and 20-way, 1- and 5-shot (5, 20, 25, 100 images) at batch 8
FWD_SHAPES = (
    [(T, n, hw, hw, cin, 48, 1) for T in (2, 8) for n in (5, 25, 75)
     for hw, cin in MINI]
    + [(T, n, hw, hw, cin, 48, 0) for T in (2, 8) for n in (5, 25, 75)
       for hw, cin in MINI_P0]
    + [(8, n, hw, hw, cin, 64, 1) for n in (5, 20, 25, 100)
       for hw, cin in OMNIGLOT]
)
# (T, N, H, W, cin, cout, pad) of dgrad (dx H x W x cin from dy of cout
# channels): the support backward at stages 1-3 and back to the normalized
# image (cin 3) of the norm-first models, padded and unpadded; Omniglot
# layers 2-4
DGRAD_SHAPES = (
    [(T, n, hw, hw, cin, 48, 1) for T in (2, 8) for n in (5, 25, 75)
     for hw, cin in MINI]
    + [(T, n, hw, hw, cin, 48, 0) for T in (2, 8) for n in (5, 25, 75)
       for hw, cin in MINI_P0]
    + [(8, n, hw, hw, cin, 64, 1) for n in (5, 20, 25, 100)
       for hw, cin in OMNIGLOT[1:]]
)
# odd channel counts (cout 20, 3 and 1; cin 20, 3 and 1) and a cout of two
# chunks
ODD_SHAPES = [
    (2, 3, 11, 9, 3, 20, 1), (2, 3, 11, 9, 20, 3, 0), (1, 2, 9, 9, 1, 1, 1),
    (2, 4, 12, 12, 20, 20, 1), (1, 2, 8, 8, 48, 130, 1),
    (1, 2, 9, 7, 17, 65, 0),
]


def _geometry(dgrad, T, N, H, W, cin, cout, pad, sms=SMS):
    """The plan and the kernel's view of the conv: (plan, source (Hs, Ws,
    Cs), output (Ho, Wo, Co), the taps' origin)."""
    if dgrad:
        plan = cb.dgrad_plan(T, N, H, W, cin, cout, 1, pad, sms, True)
        Hs, Ws = F.conv_out_hw(H, W, 1, pad)
        return plan, (Hs, Ws, cout), (H, W, cin), 2 - pad
    plan = cb.fwd_plan(T, N, H, W, cin, cout, 1, pad, sms, True)
    return plan, (H, W, cin), (*F.conv_out_hw(H, W, 1, pad), cout), pad


def _check_plan(dgrad, shape, sms=SMS):
    T, N, H, W, cin, cout, pad = shape
    plan, (Hs, Ws, Cs), (Ho, Wo, Co), _ = _geometry(dgrad, *shape, sms)
    assert plan.kernel == "mma"
    m = cb.mma_plan(T, N, Ws, Ho, Wo, Cs, Co, dgrad, sms)
    assert (plan.grid, plan.threads, plan.smem) == (m.grid, m.threads,
                                                    m.smem)
    blocks, chunks, tenants = plan.grid
    assert tenants == T <= 65535 and chunks <= 65535
    # every output channel once: chunks of 8 x a tile count a block
    assert plan.channels // 8 in cb.MMA_TILES and plan.channels % 8 == 0
    assert plan.channels <= cb.MMA_MAX_CHANNELS
    assert (chunks - 1) * plan.channels < Co <= chunks * plan.channels
    # every output row once: bands of band_rows rows tile each image
    rows, nb = plan.band_rows, plan.bands
    assert (nb - 1) * rows < Ho <= nb * rows
    # every band once: a block walks `per` consecutive bands of its tenant
    X = N * nb
    assert m.per == -(-X // blocks)
    assert (blocks - 1) * m.per < X <= blocks * m.per
    # a warp a run of 32 pixels of the band's Wo + 2 wide grid, every
    # output pixel of the band within them
    Wp = Wo + 2
    assert plan.threads == 32 * -(-((rows - 1) * Wp + Wo) // 32)
    assert 0 < plan.threads <= cb.MMA_MAX_THREADS
    # the shared memory fits a block, and two a SM wherever a band of one
    # row allows
    assert plan.smem <= cb.BLOCK_SMEM
    if (cb.mma_smem(dgrad, Ws, Wo, Cs, 1, plan.channels)[1]
            <= cb.MMA_SMEM_BYTES):
        assert plan.smem <= cb.MMA_SMEM_BYTES
        assert 2 * (plan.smem + 1024) <= cb.SM_SMEM
    bps = max(1, min(cb.MMA_BLOCKS_PER_SM,
                     cb.SM_SMEM // (plan.smem + 1024)))
    # the grid is what the card holds at once (a tenant's chunk at least
    # one block), and each block takes as few bands as that allows
    assert T * chunks * blocks <= bps * sms + T * chunks
    assert m.per <= -(-T * chunks * X // (bps * sms))
    # at least two blocks a SM wherever the rows allow
    if T * chunks * N * Ho >= cb.MMA_BLOCKS_PER_SM * sms:
        assert T * chunks * X >= cb.MMA_BLOCKS_PER_SM * sms
    return plan, m


@pytest.mark.parametrize("shape", FWD_SHAPES + ODD_SHAPES, ids=str)
def test_fwd_mma_plan_covers_each_output_once_and_fits_the_card(shape):
    T, N, H, W, cin, cout, pad = shape
    plan, _ = _check_plan(False, shape)
    assert plan.scratch == (T, N * plan.bands, 3, cout)
    assert plan == cb.fwd_plan(*shape[:6], 1, pad, SMS, True)  # pure


@pytest.mark.parametrize("shape", DGRAD_SHAPES + ODD_SHAPES, ids=str)
def test_dgrad_mma_plan_covers_each_input_pixel_once_and_fits_the_card(
        shape):
    plan, _ = _check_plan(True, shape)
    assert plan.splits == 1
    assert plan == cb.dgrad_plan(*shape[:6], 1, shape[6], SMS, True)


@pytest.mark.parametrize("dgrad", (False, True), ids=("fwd", "dgrad"))
@pytest.mark.parametrize("shape", [
    (8, 75, 42, 48, 48, 1), (8, 25, 42, 48, 48, 1), (8, 75, 41, 48, 48, 0),
    (8, 75, 21, 48, 48, 1)], ids=str)
def test_the_large_mma_plans_are_what_the_design_says(shape, dgrad):
    """The maps the design was sized on: 48 channels a block (6 n8 tiles a
    warp); bands of as many rows as 8 warps of 32 pixels take where the
    band, the weights and the statistics fit 113 KB, so two blocks fit a
    SM (5 rows at 42 x 42: 7 warps), balanced over the image; and one
    block a resident slot: T = 8 at N = 75 gives each tenant 33 blocks,
    each walking its bands."""
    T, N, hw, cin, cout, pad = shape
    plan, m = _check_plan(dgrad, (T, N, hw, hw, cin, cout, pad))
    assert plan.channels == 48 and plan.grid[1] == 1
    assert 2 * (plan.smem + 1024) <= cb.SM_SMEM
    Ho = hw + 2 * pad - 2
    Ws, Wo = (Ho, hw) if dgrad else (hw, Ho)
    most = max(r for r in range(1, Wo + 1)
               if cb.mma_smem(dgrad, Ws, Wo, 48, r, 48)[0]
               <= cb.MMA_MAX_THREADS
               and cb.mma_smem(dgrad, Ws, Wo, 48, r, 48)[1]
               <= cb.MMA_SMEM_BYTES)
    assert plan.bands == -(-Wo // most)
    if (hw, pad) == (42, 1):
        assert plan.band_rows == 5 and plan.threads == 224
    if N == 75:
        assert m.per > 1
        if hw in (42, 41):
            assert plan.grid[0] * T == cb.MMA_BLOCKS_PER_SM * SMS


def test_small_cin_packs_the_patch_rows_in_k():
    """At cin <= 3 the forward packs a pixel's 9 cin patch values into K =
    16 (cin 1) or 32 (cin 2, 3): one tap, the band's patch matrix in
    shared memory built from the band's source rows, which two slots hold
    as they lie in memory (5 rows of 84 x cin for 3 output rows at pad 0:
    the next band's in flight while this one computes); dgrad's K is dy's
    channels, never packed (dgrad to cin 3 takes one n8 tile of channels,
    3 of them live)."""
    for cin, K in ((1, 16), (2, 32), (3, 32)):
        threads, smem = cb.mma_smem(False, 84, 82, cin, 3, 48)
        warps = threads // 32
        raw = -(-2 * 5 * 84 * cin // 16) * 16
        assert smem == (max(2 * 32 * warps * (K + 8), 2 * 32 * warps * 56)
                        + 2 * raw + 2 * K * 56 + 4 * 3 * warps * 48)
    d = cb.dgrad_plan(8, 25, 84, 84, 3, 48, 1, 1, SMS, True)
    assert d.channels == 8


def test_mma_plan_refuses_rows_no_block_holds():
    with pytest.raises(ValueError, match="mma_plan"):
        cb.fwd_plan(1, 1, 4, 4096, 64, 64, 1, 1, SMS, True)
    with pytest.raises(ValueError, match="mma_plan"):
        cb.dgrad_plan(1, 1, 4, 4096, 64, 64, 1, 1, SMS, True)
    with pytest.raises(ValueError, match="no conv3x3"):
        cb.fwd_plan(1, 1, 2, 2, 3, 4, 1, 0, SMS, True)


def test_stride_2_and_f32_take_no_mma_plan():
    """bf16 at stride 2 plans the stride-2 tensor-core kernel
    (``s2_mma_plan``, csrc/conv3x3_s2.cu), f32 at stride 1 the band
    kernels: neither takes ``mma_plan``'s."""
    assert cb.fwd_plan(8, 20, 28, 28, 1, 64, 2, 1, SMS,
                       True).kernel == "s2_mma"
    assert cb.fwd_plan(8, 25, 42, 42, 48, 48, 1, 1, SMS).kernel == "band"
    assert cb.dgrad_plan(8, 20, 14, 14, 64, 64, 2, 1, SMS,
                         True).kernel == "s2_mma"
    assert cb.dgrad_plan(8, 25, 42, 42, 48, 48, 1, 1, SMS).kernel == "band"


# -- the kernel's decomposition, emulated -------------------------------------


def _bf(v):
    """f32 values rounded to bf16 (and back to f32)."""
    return v.to(BF16).float()


def _emulate(dgrad, src, w, bias, pad, sms):
    """The mma kernel's output at stride 1 (and, forward, its (T, N *
    bands, 3, cout) partials), step by step as csrc/conv3x3_s1_bf16.cu
    takes it under the plan: f32 values of bf16 numbers."""
    T, N = src.shape[:2]
    if dgrad:  # src is dy; dx is H x W x cin_fwd
        Hs, Ws, Cs = src.shape[2:]
        H, W = Hs + 2 - 2 * pad, Ws + 2 - 2 * pad
        shape = (T, N, H, W, w.shape[3], Cs, pad)
    else:
        shape = (T, N, *src.shape[2:], w.shape[4], pad)
    plan, (Hs, Ws, Cs), (Ho, Wo, Co), org = _geometry(dgrad, *shape, sms)
    s32, w32 = src.float(), w.float()
    CR, nb, NB = plan.band_rows, plan.bands, plan.channels
    Wp = Wo + 2
    rows_px = plan.threads
    packed = not dgrad and Cs <= 3
    KC = -(-(9 * Cs if packed else Cs) // 16) * 16
    taps = 1 if packed else 9
    band_px = rows_px if packed else max((CR + 2) * Wp,
                                         rows_px + 2 * Wp + 2)
    out = torch.zeros(T, N, Ho, Wo, Co)
    part = torch.zeros(T, N * nb, 3, Co)
    q = torch.arange(rows_px)
    qr, qc = q // Wp, q % Wp
    for chunk in range(plan.grid[1]):
        n0 = chunk * NB
        nv = min(NB, Co - n0)
        # B: (T, taps, KC, NB), zero past the channels; dgrad reads
        # w[2-kh][2-kw] in place, its rows n (cin_fwd) of k (cout_fwd)
        B = torch.zeros(T, taps, KC, NB)
        for tap in range(taps):
            kh, kw = divmod(tap, 3)
            if dgrad:
                B[:, tap, :Cs, :nv] = w32[:, 2 - kh, 2 - kw,
                                          n0:n0 + nv].transpose(-1, -2)
            elif packed:
                B[:, 0, :9 * Cs, :nv] = w32.reshape(T, 9 * Cs, Co)[
                    :, :, n0:n0 + nv]
            else:
                B[:, tap, :Cs, :nv] = w32[:, kh, kw, :, n0:n0 + nv]
        bj = torch.zeros(T, NB)
        if bias is not None:
            bj[:, :nv] = bias.float()[:, n0:n0 + nv]
        for bi in range(nb):
            oh0 = bi * CR
            rows = min(CR, Ho - oh0)
            if packed:  # the band's patch matrix, k = tap * cin + ci
                A = torch.zeros(T, N, rows_px, KC)
                for k in range(9 * Cs):
                    tap, ci = divmod(k, Cs)
                    ih = oh0 - org + qr + tap // 3
                    iw = qc - org + tap % 3
                    ok = (ih >= 0) & (ih < Hs) & (iw >= 0) & (iw < Ws)
                    A[:, :, ok, k] = s32[:, :, ih[ok], iw[ok], ci]
            else:  # the band's rows with their halo, zero outside
                p = torch.arange(band_px)
                r = p // Wp
                ih, iw = oh0 - org + r, p % Wp - org
                ok = ((r < rows + 2) & (ih >= 0) & (ih < Hs) & (iw >= 0)
                      & (iw < Ws))
                A = torch.zeros(T, N, band_px, KC)
                A[:, :, ok, :Cs] = s32[:, :, ih[ok], iw[ok]]
            acc = torch.zeros(T, N, rows_px, NB)
            for tap in range(taps):
                shift = 0 if packed else tap // 3 * Wp + tap % 3
                for k0 in range(0, KC, 16):
                    acc = acc + torch.matmul(
                        A[:, :, shift:shift + rows_px, k0:k0 + 16],
                        B[:, None, tap, k0:k0 + 16])
            v = _bf(acc)
            if bias is not None:
                v = _bf(v + bj[:, None, None])
            valid = (qr < rows) & (qc < Wo)
            out[:, :, oh0 + qr[valid], qc[valid], n0:n0 + nv] = v[
                :, :, valid, :nv]
            # each warp's count, sum and M2 (about its own mean) over its
            # valid pixels; the band's mean the warps' sums over the count,
            # its M2 the warps' M2 plus count x (warp mean - band mean)^2
            warps = []
            for w0 in range(0, rows_px, 32):
                vw = v[:, :, valid & (q >= w0) & (q < w0 + 32), :nv]
                if vw.shape[2]:
                    mw = vw.sum(2) * (1.0 / vw.shape[2])
                    warps.append((vw.shape[2], vw.sum(2),
                                  ((vw - mw[:, :, None]) ** 2).sum(2)))
            n = sum(c for c, _, _ in warps)
            mean = sum(sw for _, sw, _ in warps) / n
            m2 = sum(m2w + c * (sw / c - mean) ** 2 for c, sw, m2w in warps)
            band = torch.arange(N) * nb + bi
            part[:, band, 0, n0:n0 + nv] = float(n)
            part[:, band, 1, n0:n0 + nv] = mean
            part[:, band, 2, n0:n0 + nv] = m2
    return out.to(BF16), part, plan


def _merge(part, eps):
    """The merge kernel (bn_stats_merge.cuh) on (T, P, 3, C) partials: 256
    threads each merging partials i, i + 256, ... in turn, a pairwise tree
    of strides 128, 64, ..., 1; mean and var rounded once to bf16, rstd
    the f32 rsqrt of the bf16 var + eps rounded once."""
    T, P, _, C = part.shape
    zero = torch.zeros(T, C)
    lanes = [(zero, zero, zero)] * 256
    for i in range(P):
        lanes[i % 256] = _chan_merge(lanes[i % 256], tuple(part[:, i].unbind(
            1)))
    stride = 128
    while stride:
        for i in range(stride):
            lanes[i] = _chan_merge(lanes[i], lanes[i + stride])
        stride //= 2
    n, mean, m2 = lanes[0]
    var = _bf(m2 / n)
    return (mean.to(BF16), var.to(BF16),
            (1.0 / torch.sqrt(_bf(var + eps))).to(BF16))


def _ulp(v):
    """bf16's spacing at each |v| (8 significant bits)."""
    _, e = torch.frexp(v.double().abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(v, dtype=torch.float64), e - 8)


def _within_ulp(got, want, what, ulps=None):
    """|got - want| <= max(ulps (default: one ulp of want), 1e-4 * max
    |want|) elementwise: the card's gate."""
    assert got.dtype == want.dtype == BF16, (what, got.dtype, want.dtype)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    diff = (got.double() - want.double()).abs()
    tol = _ulp(want) if ulps is None else ulps
    tol = torch.clamp_min(tol, 1e-4 * want.double().abs().max().item())
    bad = int((diff > tol).sum())
    assert bad == 0, (what, bad, diff.max().item())


def _arrays(shape, seed):
    T, N, H, W, cin, cout = shape[:6]
    rng = np.random.RandomState(seed)
    x = rng.randn(T, N, H, W, cin).astype(np.float32)
    w = (rng.randn(T, 3, 3, cin, cout) * (2.0 / (9 * cin)) ** 0.5
         ).astype(np.float32)
    b = (rng.randn(T, cout) * 0.1).astype(np.float32)
    return x, w, b


# small shapes (sms chosen so that an image takes several bands and a block
# several bands): both pads, cin 1 and 3 (packed), 17 and 48, cout 3, 20,
# 48 and 65 (two chunks), odd maps, bands that do not divide the output
EMULATED = [
    # T, N, H, W, cin, cout, pad, sms
    (2, 3, 11, 9, 3, 20, 1, 2),
    (2, 3, 11, 9, 3, 20, 0, 2),
    (1, 2, 9, 9, 1, 8, 1, 2),
    (1, 2, 21, 21, 48, 48, 1, 1),
    (1, 2, 19, 19, 48, 48, 0, 1),
    (1, 3, 10, 10, 17, 33, 1, 2),
    (2, 2, 7, 7, 64, 64, 1, 4),
    (1, 2, 9, 7, 17, 65, 0, 1),
]


@pytest.mark.parametrize("shape", EMULATED, ids=str)
def test_mma_forward_emulated_equals_the_twin(shape):
    """K1 with statistics by the kernel's decomposition (the merge in its
    order) against the bf16 twin: y within one ulp of the sum and one of
    the bias add, mean, var and rstd within one ulp; and the stats-free
    mode without a bias within one ulp."""
    T, N, H, W, cin, cout, pad, sms = shape
    x, w, b = (torch.from_numpy(a).to(BF16) for a in _arrays(shape,
                                                            sum(shape)))
    y, part, plan = _emulate(False, x, w, b, pad, sms)
    assert plan.kernel == "mma"
    assert plan.bands > 1 or plan.grid[0] < N
    want = F.conv3x3_fwd_stats(x, w, b, padding=pad)
    plain = F.conv3x3(x, w, padding=pad)
    _within_ulp(y, want[0], "y", _ulp(want[0]) + _ulp(plain))
    eps = F.scalar_like(F.BN_EPS, x)
    for got, c, what in zip(_merge(part, eps), want[1:],
                            ("mean", "var", "rstd")):
        _within_ulp(got, c, what)
    y0, _, _ = _emulate(False, x, w, None, pad, sms)
    _within_ulp(y0, plain, "stats-free")


@pytest.mark.parametrize("shape", EMULATED, ids=str)
def test_mma_dgrad_emulated_equals_the_twin(shape):
    """dgrad by the kernel's decomposition (dy the source at pad 2 - pad,
    w read in place flipped and transposed) against the bf16 twin within
    one ulp."""
    T, N, H, W, cin, cout, pad, sms = shape
    _, w, _ = _arrays(shape, 3 * sum(shape))
    Ho, Wo = F.conv_out_hw(H, W, 1, pad)
    rng = np.random.RandomState(sum(shape))
    dy = torch.from_numpy(rng.randn(T, N, Ho, Wo, cout).astype(
        np.float32)).to(BF16)
    w = torch.from_numpy(w).to(BF16)
    dx, _, plan = _emulate(True, dy, w, None, pad, sms)
    assert plan.kernel == "mma" and dx.shape == (T, N, H, W, cin)
    _within_ulp(dx, F.conv3x3_dgrad(dy, w, 1, (H, W), pad), "dx")


def _from_jax(a):
    return torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(BF16)


JAX_SHAPES = [(2, 3, 11, 9, 3, 20, 2), (1, 2, 12, 10, 17, 24, 2)]


@pytest.mark.parametrize("pad", (1, 0))
@pytest.mark.parametrize("shape", JAX_SHAPES, ids=("packed", "taps"))
def test_mma_forward_emulated_equals_the_jax_bf16_conv(shape, pad):
    """The same numpy-seeded inputs through the JAX package's
    ``_conv2d_raw`` in bf16 (the im2col GEMM, the bias add in bf16) and
    its statistics (``jnp.mean``, ``jnp.var``, ``lax.rsqrt`` of var + eps,
    as ``batch_norm``), per tenant, against the emulated kernel: y within
    one ulp of the sum and one of the bias add, the statistics within one
    ulp; the stats-free mode without a bias within one ulp."""
    T, N, H, W, cin, cout, sms = shape
    x, w, b = _arrays((T, N, H, W, cin, cout), 7 + pad + cin)
    tx, tw, tb = (torch.from_numpy(a).to(BF16) for a in (x, w, b))
    y, part, _ = _emulate(False, tx, tw, tb, pad, sms)
    y0, _, _ = _emulate(False, tx, tw, None, pad, sms)
    stats = _merge(part, F.scalar_like(F.BN_EPS, tx))
    for t in range(T):
        xj, wj, bj = (jnp.asarray(a[t]).astype(jnp.bfloat16)
                      for a in (x, w, b))
        want = JF._conv2d_raw(xj, wj, bj, 1, pad, "im2col", "off")
        plain = JF._conv2d_raw(xj, wj, None, 1, pad, "im2col", "off")
        _within_ulp(y[t], _from_jax(want), "y",
                    _ulp(_from_jax(want)) + _ulp(_from_jax(plain)))
        _within_ulp(y0[t], _from_jax(plain), "stats-free")
        axes = (0, 1, 2)
        var = jnp.var(want, axis=axes)
        for got, c, what in zip(
                (s[t] for s in stats),
                (jnp.mean(want, axis=axes), var,
                 jax.lax.rsqrt(var + F.BN_EPS)), ("mean", "var", "rstd")):
            assert c.dtype == jnp.bfloat16
            _within_ulp(got, _from_jax(c), what)


@pytest.mark.parametrize("pad", (1, 0))
@pytest.mark.parametrize("shape", JAX_SHAPES, ids=("packed", "taps"))
def test_mma_dgrad_emulated_equals_the_jax_gradient(shape, pad):
    """The gradient XLA derives for ``_conv2d_raw`` with respect to x
    (``jax.vjp``), in f32 on the same bf16 values and rounded once (the
    port's cast point for dgrad), per tenant, against the emulated kernel
    within one ulp."""
    T, N, H, W, cin, cout, sms = shape
    x, w, _ = _arrays((T, N, H, W, cin, cout), 11 + pad + cin)
    Ho, Wo = F.conv_out_hw(H, W, 1, pad)
    dy = np.random.RandomState(pad + cin).randn(T, N, Ho, Wo, cout).astype(
        np.float32)
    tdy, tw = torch.from_numpy(dy).to(BF16), torch.from_numpy(w).to(BF16)
    dx, _, _ = _emulate(True, tdy, tw, None, pad, sms)
    for t in range(T):
        xj, wj, dyj = (jnp.asarray(a[t]).astype(jnp.bfloat16).astype(
            jnp.float32) for a in (x, w, dy))
        _, vjp = jax.vjp(lambda v: JF._conv2d_raw(v, wj, None, 1, pad,
                                                  "im2col", "off"), xj)
        (want,) = vjp(dyj)
        _within_ulp(dx[t], _from_jax(want.astype(jnp.bfloat16)), "dx")
