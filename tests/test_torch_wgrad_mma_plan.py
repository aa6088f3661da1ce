"""The launch plan of K4 wgrad in bf16 at stride 1 on the tensor cores
(``conv_block.wgrad_plan``, kernel ``"mma"``: csrc/conv3x3_wgrad_s1_bf16.cu),
on the CPU: a pure function of the shape, checked at every shape the
shipped configs give the kernel — the mini-ImageNet stages (84/42/21/10 at
pad 1, 84/41/19/8 at pad 0; cin 3 then 48, cout 48) at 5, 25 and 75 images
and task batches 2 and 8 (stage 0 at cin 3 is also the norm-first models'
image), Omniglot's layers (28/14/7/3; cin 1 then 64, cout 64) at 5, 20, 25
and 100 images — and at odd channel counts (1, 3, 20, 65); and emulated in
plain PyTorch: the kernel's decomposition driven by the plan (each band's x
rows with their halo and its dy rows on the ``Wo + 2``-wide grid, dy's
extra columns zero; the taps as row offsets into the x band, a warp a tap;
the packed patch rows with a row of ones at cin <= 3, the k16 steps dealt
to 8 warps and their tiles summed in warp order; the source and output
channel chunks; f32 sums of k16 slices in band order; the splits' partials
summed in split order and rounded once) against the plain twin within one
bf16 ulp or 1e-4 of the output's scale, and at one small shape per pad
against the JAX package's gradient of ``_conv2d_raw`` (run eagerly on the
CPU): dw from its bf16 ``jax.vjp``; db from the same gradient in f32 on
the same bf16 values, rounded once, because XLA:CPU sums a bf16 reduction
in a bf16 accumulator where the package on an accelerator, and the port,
sum in f32.

The kernel itself runs only on the card (``tests/test_torch_kernels_cuda.py``).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu.ops import functional as JF
from howtotrainyourmamlpytorch_tpu_torch.kernels import conv_block as cb
from howtotrainyourmamlpytorch_tpu_torch.ops import functional as F
from test_torch_conv_mma_plan import _within_ulp

BF16 = torch.bfloat16
SMS = 132  # an H100 SXM's SMs
MINI = ((84, 3), (42, 48), (21, 48), (10, 48))
MINI_P0 = ((84, 3), (41, 48), (19, 48), (8, 48))
OMNIGLOT = ((28, 1), (14, 64), (7, 64), (3, 64))
# (T, N, H, W, cin, cout, pad)
SHAPES = (
    [(T, n, hw, hw, cin, 48, 1) for T in (2, 8) for n in (5, 25, 75)
     for hw, cin in MINI]
    + [(T, n, hw, hw, cin, 48, 0) for T in (2, 8) for n in (5, 25, 75)
       for hw, cin in MINI_P0]
    + [(8, n, hw, hw, cin, 64, 1) for n in (5, 20, 25, 100)
       for hw, cin in OMNIGLOT]
    # odd channel counts: cin 1 and 3 (packed), 20 and 65 (source chunks),
    # cout 1, 3, 20 and 65 (n8 tiles padded and masked, output chunks)
    + [(2, 3, 11, 9, 1, 20, 1), (2, 3, 11, 9, 3, 65, 0),
       (2, 4, 12, 12, 20, 20, 1), (1, 2, 9, 7, 65, 65, 0),
       (2, 3, 10, 10, 65, 3, 1), (1, 2, 8, 8, 20, 1, 0),
       (1, 2, 9, 9, 3, 1, 1)]
)


def _check_plan(shape, sms=SMS):
    T, N, H, W, cin, cout, pad = shape
    plan = cb.wgrad_plan(T, N, H, W, cin, cout, 1, pad, sms, True)
    assert plan.kernel == "mma"
    assert plan == cb.wgrad_plan(T, N, H, W, cin, cout, 1, pad, sms,
                                 True)  # pure
    Ho, Wo = F.conv_out_hw(H, W, 1, pad)
    S, chunks, tenants = plan.grid
    assert tenants == T and S == plan.splits and 1 <= S <= 65535
    # threads: a warp a tap, or 8 warps over the packed kernel's k16 steps,
    # within the kernel's __launch_bounds__ (9 warps)
    packed = cin <= 3
    assert plan.threads == 32 * (cb.WGRAD_MMA_PACKED_WARPS if packed
                                 else cb.WGRAD_MMA_TAP_WARPS)
    assert plan.threads <= 32 * cb.WGRAD_MMA_TAP_WARPS
    # every (tap, source channel, output channel) once: source chunks of
    # 16 m_tiles channels (packed: one, the 9 cin patch rows and a row of
    # ones in K), output chunks of `channels`, each at most the tiles a
    # warp holds
    mt, NB = plan.m_tiles, plan.channels
    assert NB % 8 == 0 and NB // 8 in cb.MMA_TILES and NB <= 64
    co_chunks = -(-cout // NB)
    assert (co_chunks - 1) * NB < cout <= co_chunks * NB
    if packed:
        assert 16 * mt == -(-(9 * cin + 1) // 16) * 16 and chunks == co_chunks
    else:
        assert 1 <= mt <= cb.WGRAD_MMA_MAX_MT
        assert mt * NB // 8 <= cb.WGRAD_MMA_TILES
        ci_chunks = -(-cin // (16 * mt))
        assert (ci_chunks - 1) * 16 * mt < cin <= ci_chunks * 16 * mt
        assert chunks == ci_chunks * co_chunks
    # every output row once: bands of band_rows rows tile each image
    rows, nb = plan.band_rows, plan.bands
    assert (nb - 1) * rows < Ho <= nb * rows
    # every band of a tenant once, in order: the splits tile the bands
    seen = list(itertools.chain.from_iterable(
        plan.split_bands(s, N) for s in range(S)))
    assert seen == list(range(N * nb))
    assert all(len(plan.split_bands(s, N)) for s in range(S))
    assert plan.scratch == ((T, S, 9 * cin * cout), (T, S, cout))
    # the shared memory fits a block, and the blocks a SM that the
    # kernel's registers allow (two, or one at 16 tiles a warp and more)
    # wherever a band of one row allows
    assert (plan.threads, plan.smem) == cb.wgrad_mma_smem(W, Wo, cin, rows,
                                                          mt, NB)
    assert plan.smem <= cb.BLOCK_SMEM
    bps = cb.wgrad_mma_blocks_per_sm(cin, mt, NB)
    assert bps == (1 if not packed and mt * NB // 8 >= 16 else 2)
    one_row = cb.wgrad_mma_smem(W, Wo, cin, 1, mt, NB)[1]
    if one_row + 1024 <= cb.SM_SMEM // bps:
        assert bps * (plan.smem + 1024) <= cb.SM_SMEM
    bps = max(1, min(bps, cb.SM_SMEM // (plan.smem + 1024)))
    # one wave at most (unless a tenant's chunk alone exceeds it), and the
    # partials no larger than the inputs' bytes unless the splits are those
    # that keep a block's walk to WGRAD_MMA_BANDS bands
    assert T * chunks * S <= bps * sms or S == 1
    partial = 4 * (9 * cin + 1) * cout
    inputs = 2 * N * (H * W * cin + Ho * Wo * cout)
    assert (S * partial <= inputs
            or S <= -(-N * nb // cb.WGRAD_MMA_BANDS))
    return plan


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_wgrad_mma_plan_covers_each_output_once_and_fits_the_card(shape):
    _check_plan(shape)


@pytest.mark.parametrize("shape", [
    (8, 25, 42, 42, 48, 48, 1), (8, 25, 41, 41, 48, 48, 0),
    (8, 25, 84, 84, 3, 48, 1), (8, 25, 84, 84, 3, 48, 0),
    (8, 20, 14, 14, 64, 64, 1)], ids=str)
def test_the_large_wgrad_mma_plans_are_what_the_design_says(shape):
    """The maps the design was sized on: at 48 channels a warp a tap with
    3 x 6 tiles (one source and one output chunk), one block a SM; at cin
    3 the packed K of 32 (27 patch rows and the ones), two blocks a SM; at
    64 channels two source chunks of 32 (2 x 8 tiles), one block a SM;
    bands of as many rows as two slots take within the block's share of
    the SM's shared memory; and one wave of splits, each walking its bands
    (at T = 8: 16 splits a tenant at one block a SM, 33 at two)."""
    T, N, H, W, cin, cout, pad = shape
    plan = _check_plan(shape)
    Ho, Wo = F.conv_out_hw(H, W, 1, pad)
    bps = cb.wgrad_mma_blocks_per_sm(cin, plan.m_tiles, plan.channels)
    assert bps * (plan.smem + 1024) <= cb.SM_SMEM
    most = max(r for r in range(1, Ho + 1)
               if cb.wgrad_mma_smem(W, Wo, cin, r, plan.m_tiles,
                                    plan.channels)[1] + 1024
               <= cb.SM_SMEM // bps)
    if cout == 48:
        assert plan.bands == -(-Ho // most)
        assert plan.channels == 48
        assert plan.grid == ((16, 1, T) if cin == 48 else (33, 1, T))
        assert plan.m_tiles == (2 if cin == 3 else 3)
        assert len(plan.split_bands(0, N)) > 1
    else:
        assert (plan.m_tiles, plan.channels, plan.grid[1]) == (2, 64, 2)
    if (H, pad, cin) == (42, 1, 48):
        assert plan.band_rows == 9 and plan.threads == 288


def test_wgrad_mma_plan_refuses_rows_no_block_holds():
    with pytest.raises(ValueError, match="wgrad_plan"):
        cb.wgrad_plan(1, 1, 4, 4096, 64, 64, 1, 1, SMS, True)
    with pytest.raises(ValueError, match="no conv3x3"):
        cb.wgrad_plan(1, 1, 2, 2, 3, 4, 1, 0, SMS, True)


# -- the kernel's decomposition, emulated -------------------------------------


def _emulate(x, dy, pad, sms):
    """dw and db by the mma kernel's decomposition under the plan, step by
    step as csrc/conv3x3_wgrad_s1_bf16.cu takes them: f32 values of bf16
    numbers, one rounding at the end."""
    T, N, H, W, cin = x.shape
    cout = dy.shape[-1]
    plan = cb.wgrad_plan(T, N, H, W, cin, cout, 1, pad, sms, True)
    Ho, Wo = dy.shape[2:4]
    Wp = Wo + 2
    CR, nb, S = plan.band_rows, plan.bands, plan.splits
    packed = cin <= 3
    KC, NB = 16 * plan.m_tiles, plan.channels
    kpx = -(-CR * Wp // 16) * 16
    x32, dy32 = x.float(), dy.float()
    part_w = torch.zeros(T, S, 9, cin, cout)
    part_b = torch.zeros(T, S, cout)
    q = torch.arange(kpx)
    qr, qc = q // Wp, q % Wp
    for s in range(S):
        # the block's accumulators, for all its chunks at once: a warp a
        # tap (its f32 sum over the split's bands, k16 step by k16 step)
        # and the ones row's db; packed, a tile a warp
        taps = torch.zeros(T, 9, cin, cout)
        db = torch.zeros(T, cout)
        warps = torch.zeros(T, cb.WGRAD_MMA_PACKED_WARPS, KC, cout)
        for band in plan.split_bands(s, N):
            img, bi = divmod(band, nb)
            oh0 = bi * CR
            rows = min(CR, Ho - oh0)
            # dy on the Wp grid: zero past Wo and past the band's rows
            D = torch.zeros(T, kpx, cout)
            ok = (qr < rows) & (qc < Wo)
            D[:, ok] = dy32[:, img, oh0 + qr[ok], qc[ok]]
            steps = -(-rows * Wp // 16)
            if packed:
                # the patch rows, k = (3 kh + kw) cin + ci, then the ones
                A = torch.zeros(T, kpx, KC)
                for k in range(9 * cin):
                    tap, ci = divmod(k, cin)
                    ih = oh0 - pad + qr + tap // 3
                    iw = qc - pad + tap % 3
                    inside = (ih >= 0) & (ih < H) & (iw >= 0) & (iw < W)
                    A[:, inside, k] = x32[:, img, ih[inside], iw[inside], ci]
                A[:, :, 9 * cin] = 1.0
                for ks in range(steps):
                    k16 = slice(16 * ks, 16 * ks + 16)
                    wi = ks % cb.WGRAD_MMA_PACKED_WARPS
                    warps[:, wi] = warps[:, wi] + torch.matmul(
                        A[:, k16].transpose(1, 2), D[:, k16])
                continue
            # the x band with its halo, zero outside the image
            p = torch.arange(kpx + 2 * Wp + 2)
            r = p // Wp
            ih, iw = oh0 - pad + r, p % Wp - pad
            inside = ((r < rows + 2) & (ih >= 0) & (ih < H) & (iw >= 0)
                      & (iw < W))
            X = torch.zeros(T, p.numel(), cin)
            X[:, inside] = x32[:, img, ih[inside], iw[inside]]
            ones = torch.ones(T, 1, 16)
            for ks in range(steps):
                k16 = slice(16 * ks, 16 * ks + 16)
                for tap in range(9):
                    shift = tap // 3 * Wp + tap % 3
                    a = X[:, shift + 16 * ks:shift + 16 * ks + 16]
                    taps[:, tap] = taps[:, tap] + torch.matmul(
                        a.transpose(1, 2), D[:, k16])
                db = db + torch.matmul(ones, D[:, k16])[:, 0]
        if packed:
            # the warps' tiles summed in warp order
            tile = torch.zeros(T, KC, cout)
            for wi in range(cb.WGRAD_MMA_PACKED_WARPS):
                tile = tile + warps[:, wi]
            part_w[:, s] = tile[:, :9 * cin].reshape(T, 9, cin, cout)
            part_b[:, s] = tile[:, 9 * cin]
        else:
            part_w[:, s] = taps
            part_b[:, s] = db
    dw = torch.zeros(T, 9, cin, cout)
    dbias = torch.zeros(T, cout)
    for s in range(S):  # the reduce: split order, one rounding
        dw = dw + part_w[:, s]
        dbias = dbias + part_b[:, s]
    assert NB <= 64 and KC >= (9 * cin + 1 if packed else 16)
    return (dw.reshape(T, 3, 3, cin, cout).to(BF16), dbias.to(BF16), plan)


def _inputs(shape, seed):
    T, N, H, W, cin, cout, pad = shape
    rng = np.random.RandomState(seed)
    Ho, Wo = F.conv_out_hw(H, W, 1, pad)
    x = rng.randn(T, N, H, W, cin).astype(np.float32)
    dy = rng.randn(T, N, Ho, Wo, cout).astype(np.float32)
    return x, dy


# small shapes (sms chosen so that an image takes several bands and a split
# several bands, one ending inside an image): both pads, cin 1, 2 and 3
# (packed), 5, 17, 48 and 65 (source chunks), cout 3, 20, 48 and 65
# (output chunks), odd maps, bands that do not divide the output
EMULATED = [
    # T, N, H, W, cin, cout, pad, sms
    (2, 3, 11, 9, 3, 20, 1, 2),
    (2, 3, 11, 9, 3, 20, 0, 2),
    (1, 2, 9, 9, 1, 8, 1, 2),
    (1, 2, 7, 8, 2, 65, 0, 1),
    (1, 2, 21, 21, 48, 48, 1, 1),
    (1, 2, 19, 19, 48, 48, 0, 1),
    (1, 3, 10, 10, 17, 33, 1, 2),
    (2, 2, 7, 7, 64, 64, 1, 4),
    (1, 2, 9, 7, 65, 65, 0, 1),
    (2, 3, 6, 12, 5, 3, 1, 2),
]


@pytest.mark.parametrize("shape", EMULATED, ids=str)
def test_wgrad_mma_emulated_equals_the_twin(shape):
    """dw and db by the kernel's decomposition against the bf16 twin
    (``im2col`` then one ``matmul``, and ``dy.sum``) within one bf16 ulp or
    1e-4 of the output's scale: the card's gate."""
    T, N, H, W, cin, cout, pad, sms = shape
    x, dy = (torch.from_numpy(a).to(BF16)
             for a in _inputs(shape[:7], sum(shape)))
    dw, db, plan = _emulate(x, dy, pad, sms)
    assert plan.kernel == "mma"
    want_w, want_b = F.conv3x3_wgrad(x, dy, padding=pad)
    _within_ulp(dw, want_w, "dw")
    _within_ulp(db, want_b, "db")


def test_emulated_splits_and_bands_cut_the_sum():
    """The emulated shapes cut a tenant's bands into several splits, one
    ending inside an image, and an image into several bands."""
    cut = inside = False
    for T, N, H, W, cin, cout, pad, sms in EMULATED:
        plan = cb.wgrad_plan(T, N, H, W, cin, cout, 1, pad, sms, True)
        cut |= plan.splits > 1 and plan.bands > 1
        inside |= any(len(plan.split_bands(s, N)) % plan.bands
                      for s in range(plan.splits))
    assert cut and inside


def _from_jax(a):
    return torch.from_numpy(np.array(a.astype(jnp.float32))).to(BF16)


JAX_SHAPES = [(2, 3, 11, 9, 3, 20, 2), (1, 2, 12, 10, 17, 24, 2)]


@pytest.mark.parametrize("pad", (1, 0))
@pytest.mark.parametrize("shape", JAX_SHAPES, ids=("packed", "taps"))
def test_wgrad_mma_emulated_equals_the_jax_gradient(shape, pad):
    """The gradient XLA derives for ``_conv2d_raw`` with respect to w and
    b, per tenant, on the same numpy-seeded bf16 inputs, against the
    emulated kernel within one bf16 ulp or 1e-4 of scale: dw from the bf16
    ``jax.vjp`` (XLA:CPU's bf16 dot sums in f32 and rounds once, the
    kernel's cast points); db from the same ``jax.vjp`` in f32 on the bf16
    values, rounded once (XLA:CPU's bf16 reduction of the bias's cotangent
    runs in a bf16 accumulator, one row at a time; the package's f32 sums,
    the twin and the kernel do not)."""
    T, N, H, W, cin, cout, sms = shape
    x, dy = _inputs((T, N, H, W, cin, cout, pad), 5 + pad + cin)
    w = np.zeros((3, 3, cin, cout), np.float32)
    b = np.zeros((cout,), np.float32)
    tx, tdy = torch.from_numpy(x).to(BF16), torch.from_numpy(dy).to(BF16)
    dw, db, _ = _emulate(tx, tdy, pad, sms)
    with jax.disable_jit():
        for t in range(T):
            xj, dyj = (jnp.asarray(a[t]).astype(jnp.bfloat16)
                       for a in (x, dy))
            _, vjp = jax.vjp(lambda w_, b_: JF._conv2d_raw(
                xj, w_, b_, 1, pad, "im2col", "off"),
                jnp.asarray(w).astype(jnp.bfloat16),
                jnp.asarray(b).astype(jnp.bfloat16))
            jw, _ = vjp(dyj)
            assert jw.dtype == jnp.bfloat16
            _within_ulp(dw[t], _from_jax(jw), "dw")
            _, vjp32 = jax.vjp(lambda w_, b_: JF._conv2d_raw(
                xj.astype(jnp.float32), w_, b_, 1, pad, "im2col", "off"),
                jnp.asarray(w), jnp.asarray(b))
            _, jb = vjp32(dyj.astype(jnp.float32))
            _within_ulp(db[t], _from_jax(jb.astype(jnp.bfloat16)), "db")
