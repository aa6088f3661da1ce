"""K1 and K4 dgrad at stride 2 (csrc/conv3x3_s2.cu), on the CPU: the launch
plans (``conv_block.fwd_plan`` and ``dgrad_plan`` at stride 2, kernels
``"s2"`` in f32 and ``"s2_mma"`` in bf16) at every stride-2 shape the
shipped configs give them — the strided Omniglot model (28/14/7/4, cin 1
then 64, cout 64, pad 1) at 5, 20, 25 and 100 images, the unpadded strided
mini-ImageNet model (84/41/20/9, cin 3 then 48, cout 48, pad 0) at 25 and 75
images, at their task batches; dgrad back to the image (cin 1 and 3) for
the norm-first models — and the kernels' decomposition emulated in plain
PyTorch from the plan: the forward's bands of ``2 CR + 1`` input rows as
even and odd column planes, read tap by tap at the plane offsets the kernel
computes (or, at cin <= 3 in bf16, as packed patch rows); the dgrad's bands
of quad rows and the four parity classes of ``s2_dgrad_taps``, each with
only its live taps. On integer-valued inputs in f64 every sum is exact, so
the emulations equal the twins exactly, dx's rows and columns that no
output reads included (an exact zero). The tap table itself: every tap
once, dx built from it equal to ``F.conv3x3_dgrad`` in f64 exactly and to
the JAX package's ``jax.vjp`` of ``_conv2d_raw`` at stride 2 (run eagerly
on the CPU) within 1e-5 in f32. The stride-2 wgrad's plans and
emulations: tests/test_torch_wgrad_s2_plan.py.

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
OMNIGLOT = ((28, 1), (14, 64), (7, 64), (4, 64))
UNPADDED = ((84, 3), (41, 48), (20, 48), (9, 48))
# (T, N, H, cin, cout, pad) of K1 at stride 2: the strided Omniglot model
# (5- and 20-way, 1- and 5-shot: 5, 20, 25, 100 images) at batch 8; the
# unpadded strided mini-ImageNet model (support 25, target 75) at batch 2
# and 8
FWD_SHAPES = (
    [(8, n, hw, cin, 64, 1) for n in (5, 20, 25, 100) for hw, cin in OMNIGLOT]
    + [(T, n, hw, cin, 48, 0) for T in (2, 8) for n in (25, 75)
       for hw, cin in UNPADDED]
)
# dgrad (dx H x H x cin from dy of cout channels): the support backward at
# layers 2-4 and, for the norm-first models, back to the image (cin 1 at
# Omniglot, cin 3 unpadded)
DGRAD_SHAPES = FWD_SHAPES


def _blocks(grid):
    return grid[0] * grid[1] * grid[2]


@pytest.mark.parametrize("bf16", (False, True), ids=("f32", "bf16"))
@pytest.mark.parametrize("shape", FWD_SHAPES, ids=str)
def test_k1_stride_2_plans_the_band_kernels(shape, bf16):
    T, N, hw, cin, cout, pad = shape
    plan = cb.fwd_plan(T, N, hw, hw, cin, cout, 2, pad, SMS, bf16)
    Ho, Wo = F.conv_out_hw(hw, hw, 2, pad)
    # the bands tile each image's output rows; the statistics' partials a
    # band each
    rows, nb = plan.band_rows, plan.bands
    assert (nb - 1) * rows < Ho <= nb * rows
    assert plan.scratch == (T, N * nb, 3, cout)
    if bf16:
        m = cb.s2_mma_plan(T, N, hw, hw, cin, cout, pad, False, SMS)
        assert plan.kernel == "s2_mma"
        assert (plan.grid, plan.threads, plan.smem, plan.channels) == (
            m.grid, m.threads, m.smem, m.channels)
        # 64 x 64 weights (74 KB) exceed a block's share: 32-channel chunks
        chunks = 2 if 2 * 9 * cin * cout > cb.S2_MMA_WEIGHT_BYTES else 1
        assert plan.grid[2] == T and plan.grid[1] == chunks
        assert plan.channels == cout // chunks
        assert plan.channels // 8 in cb.MMA_TILES
        # a warp every 32 output pixels of a band; two blocks a SM
        assert plan.threads == 32 * -(-rows * Wo // 32) <= cb.MMA_MAX_THREADS
        assert plan.smem == cb.s2_mma_smem(False, hw, hw, pad, cin, rows,
                                           plan.channels)[1]
        assert plan.smem <= cb.MMA_SMEM_BYTES
        # every band once: a block walks `per` consecutive bands
        assert (plan.grid[0] - 1) * m.per < N * nb <= plan.grid[0] * m.per
        assert _blocks(plan.grid) <= 2 * SMS
        return
    assert plan.kernel == "s2"
    assert plan.grid == (N * nb, 1, T)
    assert plan.channels in (8, 4)
    G = -(-cout // plan.channels)
    assert plan.threads == -(-rows * Wo // 8) * G <= cb.FWD_MAX_THREADS
    assert 0 < plan.smem <= cb.FWD_SMEM_BYTES
    # 8 channels a thread at the image layers (cin <= 4: the bytes bind)
    # where that fills the card, else 4
    if plan.channels == 4 and cin <= 4:
        wide = cb._s2_fwd_plan(T, N, hw, hw, cin, cout, pad, SMS, 8)
        assert (wide.grid[0] * T * wide.threads
                < cb.FWD_FILL_THREADS * SMS)
    assert cin <= 4 or plan.channels == 4
    # at least two blocks a SM wherever the rows allow
    if T * N * Ho >= 2 * SMS:
        assert T * N * nb >= 2 * SMS


@pytest.mark.parametrize("bf16", (False, True), ids=("f32", "bf16"))
@pytest.mark.parametrize("shape", DGRAD_SHAPES, ids=str)
def test_dgrad_stride_2_plans_the_band_kernels(shape, bf16):
    T, N, hw, cin, cout, pad = shape
    # dgrad's dx is the forward's input: cin from dy's cout (the layers
    # past the first map cout to cout)
    plan = cb.dgrad_plan(T, N, hw, hw, cin, cout, 2, pad, SMS, bf16)
    NA = NB = (hw + pad + 1) // 2
    # the bands of quad rows tile each image's NA quad rows, and the quads
    # tile dx: 2 NA rows from row -pad cover rows 0 .. hw - 1
    assert 2 * NA - pad >= hw and 2 * (NA - 1) - pad < hw
    rows, nb = plan.band_rows, plan.bands
    assert (nb - 1) * rows < NA <= nb * rows
    if bf16:
        m = cb.s2_mma_plan(T, N, hw, hw, cin, cout, pad, True, SMS)
        assert plan.kernel == "s2_mma" and plan.splits == 1
        assert (plan.grid, plan.threads, plan.smem, plan.channels) == (
            m.grid, m.threads, m.smem, m.channels)
        chunks = 2 if 2 * 9 * cin * cout > cb.S2_MMA_WEIGHT_BYTES else 1
        assert plan.grid[1] == chunks
        assert plan.channels == 8 * -(-cin // (8 * chunks))
        assert plan.threads == 32 * -(-rows * NB // 32) <= cb.MMA_MAX_THREADS
        assert plan.smem == cb.s2_mma_smem(True, hw, hw, pad, cout, rows,
                                           plan.channels)[1]
        assert plan.smem <= cb.MMA_SMEM_BYTES
        assert (plan.grid[0] - 1) * m.per < N * nb <= plan.grid[0] * m.per
        return
    assert plan.kernel == "s2" and plan.splits == 1
    assert plan.grid == (N * nb, 1, T)
    assert plan.channels == (1 if cin == 1 else 4)
    CG = -(-cin // plan.channels)
    assert plan.threads == -(-rows * NB // 8) * CG <= cb.DGRAD_MAX_THREADS
    assert 0 < plan.smem <= cb.DGRAD_SMEM_BYTES
    if T * N * NA >= 2 * SMS:
        assert T * N * nb >= 2 * SMS


@pytest.mark.parametrize("shape", [
    (8, 20, 28, 1, 64), (8, 20, 14, 64, 64), (8, 25, 84, 3, 48),
    (8, 25, 41, 48, 48), (2, 25, 20, 48, 48), (8, 20, 4, 64, 64)], ids=str)
def test_stride_2_wgrad_plans_the_band_and_mma_kernels(shape):
    """Both dtypes at stride 2 and both pads run the wgrad kernels of
    csrc/conv3x3_wgrad_s2.cu: f32 the band kernel (``"s2"``: grid (splits,
    kernel-row slices x channel tiles, T), all three kernel rows a block at
    cin <= 4), bf16 the tensor-core kernel (``"s2_mma"``: grid (splits,
    channel chunks, T), the packed kernel's 8 warps at cin <= 3, a warp a
    tap above); each with one f32 partial a split
    (tests/test_torch_wgrad_s2_plan.py holds their emulations)."""
    T, N, hw, cin, cout = shape
    for pad in (1, 0):
        Ho = (hw + 2 * pad - 3) // 2 + 1
        for bf16 in (False, True):
            plan = cb.wgrad_plan(T, N, hw, hw, cin, cout, 2, pad, SMS, bf16)
            assert plan.kernel == ("s2_mma" if bf16 else "s2")
            assert plan.grid[0] == plan.splits and plan.grid[2] == T
            assert (plan.bands - 1) * plan.band_rows < Ho
            assert Ho <= plan.bands * plan.band_rows
            if bf16:
                warps = (cb.WGRAD_MMA_PACKED_WARPS if cin <= 3
                         else cb.WGRAD_MMA_TAP_WARPS)
                assert plan.threads == 32 * warps
            else:
                assert plan.kernel_rows == (3 if cin <= 4 else 1)
            assert plan.scratch == ((T, plan.splits, 9 * cin * cout),
                                    (T, plan.splits, cout))


def test_s2_plans_refuse_rows_no_block_holds():
    with pytest.raises(ValueError, match="fwd_plan"):
        cb.fwd_plan(1, 1, 4, 8192, 64, 64, 2, 1, SMS)
    with pytest.raises(ValueError, match="s2_mma_plan"):
        cb.fwd_plan(1, 1, 4, 8192, 64, 64, 2, 1, SMS, True)
    with pytest.raises(ValueError, match="dgrad_plan"):
        cb.dgrad_plan(1, 1, 4, 8192, 64, 64, 2, 1, SMS)
    with pytest.raises(ValueError, match="no conv3x3"):
        cb.dgrad_plan(1, 1, 2, 2, 3, 4, 2, 0, SMS)


# -- the parity decomposition --------------------------------------------------


@pytest.mark.parametrize("pad", (1, 0))
def test_s2_dgrad_taps_take_every_tap_once(pad):
    """The four classes take the 9 taps once between them (4 + 2 + 2 + 1),
    each in the tile's order ((kh, kw) descending), with the dy offset
    (ih + pad - kh) / 2 - ih // 2 of each class's pixels."""
    taps = cb.s2_dgrad_taps(pad)
    assert sorted(taps) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    every = [(kh, kw) for cls in taps.values() for kh, kw, _, _ in cls]
    assert sorted(every) == [(kh, kw) for kh in range(3) for kw in range(3)]
    assert sorted(len(c) for c in taps.values()) == [1, 2, 2, 4]
    for (ph, pw), cls in taps.items():
        assert list(cls) == sorted(cls, reverse=True)
        for kh, kw, dh, dw in cls:
            for ih in (ph, ph + 2, ph + 6):
                assert (ih + pad - kh) % 2 == 0
                assert (ih + pad - kh) // 2 == ih // 2 + dh
            for iw in (pw, pw + 4):
                assert (iw + pad - kw) // 2 == iw // 2 + dw
    with pytest.raises(ValueError):
        cb.s2_dgrad_taps(2)


def _dgrad_from_taps(dy, w, H, W, pad):
    """dx from the tap table: each parity class's pixels take its taps in
    order, dy read at (ih // 2 + dh, iw // 2 + dw), zero outside dy."""
    T, N, Ho, Wo, cout = dy.shape
    cin = w.shape[3]
    dx = dy.new_zeros(T, N, H, W, cin)
    for (ph, pw), cls in cb.s2_dgrad_taps(pad).items():
        ih = torch.arange(ph, H, 2)
        iw = torch.arange(pw, W, 2)
        acc = dy.new_zeros(T, N, len(ih), len(iw), cin)
        for kh, kw, dh, dw in cls:
            oh, ow = ih // 2 + dh, iw // 2 + dw
            rok = (oh >= 0) & (oh < Ho)
            cok = (ow >= 0) & (ow < Wo)
            v = dy.new_zeros(T, N, len(ih), len(iw), cout)
            v[:, :, rok.nonzero()[:, 0][:, None], cok.nonzero()[:, 0]] = dy[
                :, :, oh[rok][:, None], ow[cok]]
            acc = acc + torch.einsum("tnhwo,tio->tnhwi", v, w[:, kh, kw])
        dx[:, :, ph::2, pw::2] = acc
    return dx


def _ints(rng, *shape, lo=-3, hi=4):
    return torch.from_numpy(rng.randint(lo, hi, size=shape).astype(np.float64))


# (H, cin, cout, pad): 28 -> 14 and 7 -> 4 at pad 1; 84 -> 41, 41 -> 20,
# 20 -> 9, 9 -> 4 at pad 0 (84 and 20: a last row no output reads); odd and
# non-square maps
TAP_SHAPES = [(28, 1, 5, 1), (7, 6, 5, 1), (14, 4, 3, 1), (84, 3, 4, 0),
              (41, 5, 3, 0), (20, 4, 6, 0), (9, 7, 5, 0), (8, 3, 2, 1),
              (5, 2, 3, 0)]


@pytest.mark.parametrize("shape", TAP_SHAPES, ids=str)
def test_dgrad_from_the_tap_table_equals_the_twin_exactly(shape):
    H, cin, cout, pad = shape
    W = H + 1 if H < 20 else H
    Ho, Wo = F.conv_out_hw(H, W, 2, pad)
    rng = np.random.RandomState(H + cin)
    dy = _ints(rng, 2, 2, Ho, Wo, cout)
    w = _ints(rng, 2, 3, 3, cin, cout)
    got = _dgrad_from_taps(dy, w, H, W, pad)
    want = F.conv3x3_dgrad(dy, w, 2, (H, W), pad)
    assert torch.equal(got, want)
    # at pad 0 an even map's last row (column) is read by no output: row
    # H - 1 would read dy row (H - 1 - 1) / 2 = Ho
    if pad == 0 and H % 2 == 0:
        assert not got[:, :, -1].any()
    if pad == 0 and W % 2 == 0:
        assert not got[:, :, :, -1].any()
    assert pad == 1 or H % 2 or got[:, :, -2].any()


@pytest.mark.parametrize("shape", TAP_SHAPES[:6], ids=str)
def test_dgrad_from_the_tap_table_matches_the_jax_vjp(shape):
    """Against the gradient XLA derives for the JAX package's
    ``_conv2d_raw`` at stride 2 (``lax`` lowering), run eagerly, in f32."""
    H, cin, cout, pad = shape
    W = H
    Ho, Wo = F.conv_out_hw(H, W, 2, pad)
    rng = np.random.RandomState(7 * H + cin)
    x = rng.randn(2, H, W, cin).astype(np.float32)
    w = (rng.randn(3, 3, cin, cout) / 3).astype(np.float32)
    dy = rng.randn(2, Ho, Wo, cout).astype(np.float32)
    with jax.disable_jit():
        _, vjp = jax.vjp(lambda a: JF._conv2d_raw(a, jnp.asarray(w), None, 2,
                                                  pad, "lax", "off"),
                         jnp.asarray(x))
        (want,) = vjp(jnp.asarray(dy))
    got = _dgrad_from_taps(torch.from_numpy(dy)[None],
                           torch.from_numpy(w)[None], H, W, pad)[0]
    want = torch.from_numpy(np.array(want))
    err = (got.double() - want.double()).abs().max().item()
    assert err <= 1e-5 * max(1.0, want.abs().max().item())


# -- the kernels' decomposition, emulated ---------------------------------------

# (T, N, H, W, cin, cout, pad, sms): plans that cut an image into several
# bands (sms chosen for that), bands that do not divide the rows, odd and
# non-square maps, both pads, cin 1 and 3 (the packed bf16 forward)
EMULATED = [
    (2, 3, 28, 28, 1, 8, 1, 8),
    (2, 3, 14, 14, 16, 8, 1, 8),
    (1, 3, 7, 9, 6, 12, 1, 4),
    (2, 2, 84, 84, 3, 8, 0, 16),
    (2, 2, 41, 41, 8, 8, 0, 16),
    (1, 3, 20, 19, 5, 7, 0, 4),
    (2, 2, 9, 9, 16, 16, 0, 4),
    (1, 2, 4, 4, 8, 8, 1, 2),
]


def _fwd_emulated(x, w, pad, plan, packed):
    """The forward kernels' y, band by band: the band's 2 CR + 1 input rows
    (from row 2 oh0 - pad, zero outside the image and past the band's
    rows) staged as plane rows 2 rr + (c & 1) of Wq = Wo + 1 pixels, band
    column c at index c // 2; output pixel (r, ow) reads tap (kh, kw) at
    plane pixel 4 r Wq + ow + (2 kh + (kw & 1)) Wq + kw // 2 — or, packed,
    its 9 cin patch values in K order (kh, kw, ci)."""
    T, N, H, W, cin = x.shape
    Ho, Wo = F.conv_out_hw(H, W, 2, pad)
    Wq = Wo + 1
    y = x.new_zeros(T, N, Ho, Wo, w.shape[-1])
    wk = w.reshape(T, 9, cin, -1)
    for band in range(plan.bands):
        oh0 = band * plan.band_rows
        rows = min(plan.band_rows, Ho - oh0)
        q = torch.arange(rows * Wo)
        r, ow = q // Wo, q % Wo
        if packed:
            cols = []
            for tap in range(9):
                kh, kw = divmod(tap, 3)
                ih, iw = 2 * (oh0 + r) - pad + kh, 2 * ow - pad + kw
                ok = (ih >= 0) & (ih < H) & (iw >= 0) & (iw < W)
                v = x.new_zeros(T, N, len(q), cin)
                v[:, :, ok] = x[:, :, ih[ok], iw[ok]]
                cols.append(v)
            A = torch.cat(cols, -1)
            acc = A @ w.reshape(T, 1, 9 * cin, -1)
        else:
            planes = x.new_zeros(T, N, (2 * plan.band_rows + 1) * 2 * Wq, cin)
            for rr in range(2 * rows + 1):
                ih = 2 * oh0 - pad + rr
                if not 0 <= ih < H:
                    continue
                for c in range(2 * Wq):
                    iw = c - pad
                    if 0 <= iw < W:
                        planes[:, :, (2 * rr + c % 2) * Wq + c // 2] = x[
                            :, :, ih, iw]
            acc = 0
            for tap in range(9):
                kh, kw = divmod(tap, 3)
                p = 4 * r * Wq + ow + (2 * kh + kw % 2) * Wq + kw // 2
                acc = acc + planes[:, :, p] @ wk[:, None, tap]
        y[:, :, oh0:oh0 + rows] = acc.reshape(T, N, rows, Wo, -1)
    return y


def _dgrad_emulated(dy, w, H, W, pad, plan):
    """The dgrad kernels' dx, band by band: the band's quad rows A0 .. A0 +
    rows - 1 read dy rows A0 - 1 .. A0 + rows - 1 and columns -1 .. NB - 1,
    staged on a Wb = NB + 1 wide grid (zero outside dy and past the band);
    class (a & 1, b & 1) of quad (A, B) takes the taps of ``kS2Taps`` in
    order, tap (kh, kw) at staged pixel (r + (kh != 2)) Wb + b + (kw !=
    2), and is dx pixel (2 A + (a & 1) - pad, 2 B + (b & 1) - pad) where
    that lies in dx."""
    T, N, Ho, Wo, cout = dy.shape
    cin = w.shape[3]
    NA, NB = (H + pad + 1) // 2, (W + pad + 1) // 2
    Wb = NB + 1
    order = ((8, 6, 2, 0), (7, 1), (5, 3), (4,))
    dx = dy.new_full((T, N, H, W, cin), float("nan"))
    for band in range(plan.bands):
        A0 = band * plan.band_rows
        rows = min(plan.band_rows, NA - A0)
        staged = dy.new_zeros(T, N, (plan.band_rows + 1) * Wb, cout)
        for br in range(rows + 1):
            oh = A0 - 1 + br
            if 0 <= oh < Ho:
                staged[:, :, br * Wb + 1:br * Wb + 1 + Wo] = dy[:, :, oh]
        m = torch.arange(rows * NB)
        r, b = m // NB, m % NB
        for cls, taps in enumerate(order):
            acc = 0
            for tap in taps:
                kh, kw = divmod(tap, 3)
                p = (r + (kh != 2)) * Wb + b + (kw != 2)
                acc = acc + staged[:, :, p] @ w[:, kh, kw].transpose(
                    -1, -2)[:, None]
            ih = 2 * (A0 + r) + cls // 2 - pad
            iw = 2 * b + cls % 2 - pad
            ok = (ih >= 0) & (ih < H) & (iw >= 0) & (iw < W)
            dx[:, :, ih[ok], iw[ok]] = acc[:, :, ok]
    return dx


@pytest.mark.parametrize("bf16", (False, True), ids=("f32", "bf16"))
@pytest.mark.parametrize("shape", EMULATED, ids=str)
def test_emulated_kernels_equal_the_twins_exactly(shape, bf16):
    T, N, H, W, cin, cout, pad, sms = shape
    rng = np.random.RandomState(sum(shape))
    x = _ints(rng, T, N, H, W, cin)
    w = _ints(rng, T, 3, 3, cin, cout)
    plan = cb.fwd_plan(T, N, H, W, cin, cout, 2, pad, sms, bf16)
    assert plan.kernel == ("s2_mma" if bf16 else "s2")
    y = _fwd_emulated(x, w, pad, plan, bf16 and cin <= 3)
    assert torch.equal(y, F.conv3x3(x, w, stride=2, padding=pad))
    Ho, Wo = y.shape[2:4]
    dy = _ints(rng, T, N, Ho, Wo, cout)
    plan = cb.dgrad_plan(T, N, H, W, cin, cout, 2, pad, sms, bf16)
    assert plan.kernel == ("s2_mma" if bf16 else "s2")
    dx = _dgrad_emulated(dy, w, H, W, pad, plan)
    want = F.conv3x3_dgrad(dy, w, 2, (H, W), pad)
    assert torch.equal(dx, want)  # every dx pixel written, none twice


def test_emulated_shapes_cut_images_into_bands():
    """The emulated shapes exercise what the main path's do: several bands
    an image, in both kernels and dtypes, and a last band of fewer rows."""
    ragged = 0
    for T, N, H, W, cin, cout, pad, sms in EMULATED:
        for bf16 in (False, True):
            f = cb.fwd_plan(T, N, H, W, cin, cout, 2, pad, sms, bf16)
            d = cb.dgrad_plan(T, N, H, W, cin, cout, 2, pad, sms, bf16)
            Ho = F.conv_out_hw(H, W, 2, pad)[0]
            assert f.bands > 1 or Ho == 1
            assert d.bands > 1
            ragged += Ho % f.band_rows != 0
    assert ragged
