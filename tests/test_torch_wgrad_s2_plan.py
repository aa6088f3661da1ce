"""K4 wgrad at stride 2 (csrc/conv3x3_wgrad_s2.cu), on the CPU: the launch
plans (``conv_block.wgrad_plan`` at stride 2, kernel ``"s2"`` in f32 and
``"s2_mma"`` in bf16) at every stride-2 shape the shipped configs give
them — the strided Omniglot model (28/14/7/4, cin 1 then 64, cout 64, pad
1) at 5, 20, 25 and 100 images, the unpadded strided mini-ImageNet model
(84/41/20/9, cin 3 then 48, cout 48, pad 0) at 5, 25, 75 and 100 images, at
task batches 2 and 8 — and the kernels' decomposition emulated in plain
PyTorch from the plan, step by step as the kernels take it:

* f32: each band's source rows staged as the kernel stages them (the 2 CR
  + 1 rows, or the CR rows one kernel row reads, at column pad of rows of
  RS floats, zero outside the image), each thread's run read at the
  address its walk computes (a pixel 2 cin floats on, a row RSO), the
  replicas' pixels summed apart and met in the kernel's pairwise tree, db
  by the bias warp, the splits' partials summed in split order; against
  the twin within 1e-5 of the output's scale (f32 round-off of other sum
  orders);
* bf16: each band's source rows as even and odd column planes, each lane's
  A row at the plane pixel its own (r, c) walk gives, a warp a tap, the
  dense dy band, db by a row of ones; at cin <= 3 the packed patch rows,
  the k16 steps dealt to 8 warps summed in warp order; f32 sums of k16
  slices in band order, the splits' partials in split order, one rounding;
  against the bf16 twin within one bf16 ulp or 1e-4 of the output's scale
  (the card's gate).

Both at cin 1, 3 and >= 4, pad 1 and 0, even and odd widths, with a plan
cut over several bands and splits; and against the JAX package's gradient
of ``_conv2d_raw`` at stride 2 with respect to w and b (``jax.vjp``, run
eagerly on the CPU): f32 within 1e-5 + 1e-4 of scale; bf16 dw from the
bf16 ``jax.vjp`` within one ulp, db from the same gradient in f32 on the
bf16 values rounded once (XLA:CPU sums a bf16 bias gradient in a bf16
accumulator; the package's f32 sums, the twin and the kernel do not).

The kernels themselves run only on the card
(``tests/test_torch_kernels_cuda.py``).
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
OMNIGLOT = ((28, 1), (14, 64), (7, 64), (4, 64))
UNPADDED = ((84, 3), (41, 48), (20, 48), (9, 48))
# (T, N, H, cin, cout, pad): the strided Omniglot model (5- and 20-way, 1-
# and 5-shot) at batch 8, the unpadded strided mini-ImageNet model (5-way 1-
# and 5-shot support 5 and 25, target 75; 100 images) at batch 2 and 8
SHAPES = (
    [(8, n, hw, cin, 64, 1) for n in (5, 20, 25, 100) for hw, cin in OMNIGLOT]
    + [(T, n, hw, cin, 48, 0) for T in (2, 8) for n in (5, 25, 75, 100)
       for hw, cin in UNPADDED]
)


def _blocks(grid):
    return grid[0] * grid[1] * grid[2]


def _check_coverage(plan, N, Ho):
    """Every output pixel in exactly one band of one split: the bands tile
    each image's output rows, the splits tile a tenant's bands in order."""
    rows, nb = plan.band_rows, plan.bands
    assert (nb - 1) * rows < Ho <= nb * rows
    seen = list(itertools.chain.from_iterable(
        plan.split_bands(s, N) for s in range(plan.splits)))
    assert seen == list(range(N * nb))
    assert all(len(plan.split_bands(s, N)) for s in range(plan.splits))
    covered = np.zeros((N, Ho), int)
    for s in range(plan.splits):
        for band in plan.split_bands(s, N):
            img, bi = divmod(band, nb)
            covered[img, bi * rows:min(Ho, (bi + 1) * rows)] += 1
    assert (covered == 1).all()


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_s2_wgrad_band_plan_covers_each_pixel_once_and_fits_the_card(shape):
    T, N, hw, cin, cout, pad = shape
    plan = cb.wgrad_plan(T, N, hw, hw, cin, cout, 2, pad, SMS)
    assert plan == cb.wgrad_plan(T, N, hw, hw, cin, cout, 2, pad, SMS)
    Ho, Wo = F.conv_out_hw(hw, hw, 2, pad)
    assert plan.kernel == "s2"
    assert plan.grid == (plan.splits, plan.grid[1], T)
    # all three kernel rows a block at cin <= 4 (one run a row at cin <= 3:
    # no dead K row), one row a block (three slices) above
    assert plan.kernel_rows == (3 if cin <= 4 else 1)
    groups = -(-cout // 8)  # 8-channel groups
    assert plan.grid[1] == 3 // plan.kernel_rows * -(-groups // plan.groups)
    # two blocks a SM
    assert 0 < plan.smem and 2 * (plan.smem + 1024) <= cb.SM_SMEM
    assert plan.threads % 32 == 0
    assert 32 < plan.threads <= cb.WGRAD_MAX_THREADS + 32
    assert 1 <= plan.replicas <= plan.band_rows * Wo
    _check_coverage(plan, N, Ho)
    assert plan.scratch == ((T, plan.splits, 9 * cin * cout),
                            (T, plan.splits, cout))
    # a split's partial within its share of x and dy, unless the splits are
    # those that keep a walk to WGRAD_MMA_BANDS bands; two blocks a SM
    # wherever the rows and that rule allow
    partial = 4 * (9 * cin + 1) * cout
    inputs = 4 * N * (hw * hw * cin + Ho * Wo * cout)
    cap = max(inputs // partial, -(-N * plan.bands // cb.WGRAD_MMA_BANDS))
    assert plan.splits <= max(1, cap)
    if T * N * Ho * plan.grid[1] >= 2 * SMS and plan.splits < cap:
        assert _blocks(plan.grid) >= 2 * SMS


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_s2_wgrad_mma_plan_covers_each_pixel_once_and_fits_the_card(shape):
    T, N, hw, cin, cout, pad = shape
    plan = cb.wgrad_plan(T, N, hw, hw, cin, cout, 2, pad, SMS, True)
    assert plan == cb.wgrad_plan(T, N, hw, hw, cin, cout, 2, pad, SMS, True)
    Ho, Wo = F.conv_out_hw(hw, hw, 2, pad)
    assert plan.kernel == "s2_mma"
    S, chunks, tenants = plan.grid
    assert tenants == T and S == plan.splits
    packed = cin <= 3
    assert plan.threads == 32 * (cb.WGRAD_MMA_PACKED_WARPS if packed
                                 else cb.WGRAD_MMA_TAP_WARPS)
    mt, NB = plan.m_tiles, plan.channels
    if packed:
        assert 16 * mt == -(-(9 * cin + 1) // 16) * 16
        assert chunks == -(-cout // NB)
    else:
        assert mt * NB // 8 <= cb.WGRAD_MMA_TILES
        assert chunks == -(-cin // (16 * mt)) * -(-cout // NB)
    _check_coverage(plan, N, Ho)
    assert (plan.threads, plan.smem) == cb.wgrad_mma_smem(
        hw, Wo, cin, plan.band_rows, mt, NB, 2)
    bps = cb.wgrad_mma_blocks_per_sm(cin, mt, NB)
    assert bps * (plan.smem + 1024) <= cb.SM_SMEM
    # one wave at most, the partials no larger than the inputs' bytes
    # unless the splits are those that keep a walk to WGRAD_MMA_BANDS bands
    assert T * chunks * S <= bps * SMS or S == 1
    partial = 4 * (9 * cin + 1) * cout
    inputs = 2 * N * (hw * hw * cin + Ho * Wo * cout)
    assert (S * partial <= inputs
            or S <= -(-N * plan.bands // cb.WGRAD_MMA_BANDS))


def test_s2_wgrad_plans_refuse_rows_no_block_holds():
    with pytest.raises(ValueError, match="wgrad_plan"):
        cb.wgrad_plan(1, 1, 4, 8192, 64, 64, 2, 1, SMS)
    with pytest.raises(ValueError, match="wgrad_plan"):
        cb.wgrad_plan(1, 1, 4, 8192, 64, 64, 2, 1, SMS, True)
    with pytest.raises(ValueError, match="no conv3x3"):
        cb.wgrad_plan(1, 1, 2, 2, 3, 4, 2, 0, SMS)


# -- the kernels' decomposition, emulated -------------------------------------


def _emulate_band(x, dy, pad, sms):
    """dw and db by the f32 band kernel's decomposition under the plan."""
    T, N, H, W, cin = x.shape
    cout = dy.shape[-1]
    plan = cb.wgrad_plan(T, N, H, W, cin, cout, 2, pad, sms)
    assert plan.kernel == "s2"
    Ho, Wo = dy.shape[2:4]
    CR, nb, S, KH, R = (plan.band_rows, plan.bands, plan.splits,
                        plan.kernel_rows, plan.replicas)
    TK = 9 if cin <= 3 else 8
    L = 3 * cin
    KGR = -(-L // TK)
    off = (4 - pad * cin % 4) % 4
    RS = cb._round4(off + max(W + pad, 2 * Wo + 1) * cin)
    RSO = 2 * RS if KH == 3 else RS
    xrows_most = 2 * CR + 1 if KH == 3 else CR
    xs_floats = cb._round4(xrows_most * RS + TK)
    px = 2 * cin
    Rr, Rc = divmod(R, Wo)
    astep = Rr * RSO + Rc * px
    awrap = RSO - Wo * px
    part_w = torch.zeros(T, S, 9 * cin, cout)
    part_b = torch.zeros(T, S, cout)
    for s in range(S):
        for kh0 in range(0, 3, KH):  # the kernel-row slices' blocks
            # acc[rep][khl * L + j]: each replica's tile
            acc = torch.zeros(R, T, KH * L, cout)
            bsum = torch.zeros(T, cout)
            for band in plan.split_bands(s, N):
                img, bi = divmod(band, nb)
                oh0 = bi * CR
                rows = min(CR, Ho - oh0)
                npix = rows * Wo
                xs = torch.zeros(T, xs_floats)
                xrows = 2 * rows + 1 if KH == 3 else rows
                rstep = 1 if KH == 3 else 2
                for r in range(xrows):
                    ih = 2 * oh0 - pad + kh0 + rstep * r
                    if 0 <= ih < H:
                        at = off + pad * cin + r * RS
                        xs[:, at:at + W * cin] = x[:, img, ih].reshape(T, -1)
                d = dy[:, img, oh0:oh0 + rows].reshape(T, npix, cout)
                if kh0 == 0:
                    bsum = bsum + d.sum(1)
                for rep in range(min(R, npix)):
                    r0, c0 = divmod(rep, Wo)
                    for khl in range(KH):
                        for kg in range(KGR):
                            j0 = kg * TK
                            a = khl * RS + off + j0 + r0 * RSO + c0 * px
                            c = c0
                            addrs = []
                            for _ in range(rep, npix, R):
                                addrs.append(a)
                                a += astep
                                c += Rc
                                if c >= Wo:
                                    c -= Wo
                                    a += awrap
                            idx = (torch.tensor(addrs)[:, None]
                                   + torch.arange(TK)[None])
                            av = xs[:, idx]  # (T, pixels, TK)
                            dv = d[:, rep::R]
                            run = torch.einsum("tpk,tpc->tkc", av, dv)
                            live = min(TK, L - j0)
                            at = khl * L + j0
                            acc[rep, :, at:at + live] += run[:, :live]
            # the replicas' pairwise tree
            cur = R
            while cur > 1:
                half = (cur + 1) // 2
                for rep in range(half, cur):
                    acc[rep - half] += acc[rep]
                cur = half
            part_w[:, s, kh0 * L:(kh0 + KH) * L] = acc[0]
            if kh0 == 0:
                part_b[:, s] = bsum
    dw = torch.zeros(T, 9 * cin, cout)
    db = torch.zeros(T, cout)
    for s in range(S):  # the reduce: split order
        dw = dw + part_w[:, s]
        db = db + part_b[:, s]
    return dw.reshape(T, 3, 3, cin, cout), db, plan


def _emulate_mma(x, dy, pad, sms):
    """dw and db by the bf16 mma kernels' decomposition under the plan:
    f32 values of bf16 numbers, one rounding at the end."""
    T, N, H, W, cin = x.shape
    cout = dy.shape[-1]
    plan = cb.wgrad_plan(T, N, H, W, cin, cout, 2, pad, sms, True)
    assert plan.kernel == "s2_mma"
    Ho, Wo = dy.shape[2:4]
    CR, nb, S = plan.band_rows, plan.bands, plan.splits
    packed = cin <= 3
    KC = 16 * plan.m_tiles
    PW = Wo + 1
    kpx = -(-CR * Wo // 16) * 16
    x32, dy32 = x.float(), dy.float()
    part_w = torch.zeros(T, S, 9, cin, cout)
    part_b = torch.zeros(T, S, cout)
    dr, dc = divmod(16, Wo)
    for s in range(S):
        taps = torch.zeros(T, 9, cin, cout)
        db = torch.zeros(T, cout)
        warps = torch.zeros(T, cb.WGRAD_MMA_PACKED_WARPS, KC, cout)
        for band in plan.split_bands(s, N):
            img, bi = divmod(band, nb)
            oh0 = bi * CR
            rows = min(CR, Ho - oh0)
            npix = rows * Wo
            ih0 = 2 * oh0 - pad
            # dy, dense: zero past the band's rows
            D = torch.zeros(T, kpx, cout)
            D[:, :npix] = dy32[:, img, oh0:oh0 + rows].reshape(T, npix, cout)
            steps = -(-npix // 16)
            if packed:
                # a thread a pixel: the patch row of pixel q = r Wo + c
                A = torch.zeros(T, kpx, KC)
                q = torch.arange(kpx)
                r, c = q // Wo, q % Wo
                ih_lo = max(0, ih0)
                rows_in = min(H, ih0 + 2 * CR + 1) - ih_lo
                for k in range(9 * cin):
                    tap, ci = divmod(k, cin)
                    rr = ih0 + 2 * r - ih_lo + tap // 3
                    iw = 2 * c - pad + tap % 3
                    ok = (rr >= 0) & (rr < rows_in) & (iw >= 0) & (iw < W)
                    A[:, ok, k] = x32[:, img, ih_lo + rr[ok], iw[ok], ci]
                A[:, :, 9 * cin] = 1.0
                for ks in range(steps):
                    k16 = slice(16 * ks, 16 * ks + 16)
                    wi = ks % cb.WGRAD_MMA_PACKED_WARPS
                    warps[:, wi] = warps[:, wi] + torch.matmul(
                        A[:, k16].transpose(1, 2), D[:, k16])
                continue
            # the source rows as even and odd column planes
            xpx = (2 * CR + 1) * 2 * PW
            p = torch.arange(xpx)
            R_, qq = p // (2 * PW), p % (2 * PW)
            odd = (qq >= PW).long()
            iw = 2 * (qq - odd * PW) + odd - pad
            ih = ih0 + R_
            inside = ((R_ <= 2 * rows) & (ih >= 0) & (ih < H) & (iw >= 0)
                      & (iw < W))
            X = torch.zeros(T, xpx, cin)
            X[:, inside] = x32[:, img, ih[inside], iw[inside]]
            # each lane's pixel walk: lane pl's pixel of step ks
            lane_r = [pl // Wo for pl in range(16)]
            lane_c = [pl % Wo for pl in range(16)]
            for ks in range(steps):
                xp = []
                for pl in range(16):
                    q = 16 * ks + pl
                    xp.append(lane_r[pl] * 4 * PW + lane_c[pl]
                              if q < npix else 0)
                    lane_c[pl] += dc
                    lane_r[pl] += dr
                    if lane_c[pl] >= Wo:
                        lane_c[pl] -= Wo
                        lane_r[pl] += 1
                xp = torch.tensor(xp)
                Dk = D[:, 16 * ks:16 * ks + 16]
                for tap in range(9):
                    kh, kw = divmod(tap, 3)
                    shift = kh * 2 * PW + (kw & 1) * PW + (kw >> 1)
                    a = X[:, xp + shift]
                    taps[:, tap] = taps[:, tap] + torch.matmul(
                        a.transpose(1, 2), Dk)
                db = db + Dk.sum(1)
        if packed:
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
    return (dw.reshape(T, 3, 3, cin, cout).to(BF16), dbias.to(BF16), plan)


def _inputs(shape, seed):
    T, N, H, W, cin, cout, pad = shape
    rng = np.random.RandomState(seed)
    Ho, Wo = F.conv_out_hw(H, W, 2, pad)
    x = rng.randn(T, N, H, W, cin).astype(np.float32)
    dy = rng.randn(T, N, Ho, Wo, cout).astype(np.float32)
    return x, dy


def _close(got, want, what):
    scale = want.abs().max().item()
    err = (got.double() - want.double()).abs().max().item()
    assert err <= 1e-5 * max(scale, 1.0), (what, err, scale)


# small shapes (sms chosen so that an image takes several bands and a split
# several bands, one ending inside an image): both pads, even and odd
# widths, cin 1 and 3 (a whole kernel row a thread; bf16 packed), 5, 17,
# 48 and 64 (runs of 8; source chunks), cout 3, 20, 33 and 64
EMULATED = [
    # T, N, H, W, cin, cout, pad, sms
    (2, 3, 11, 9, 3, 20, 1, 2),
    (2, 3, 12, 10, 3, 20, 0, 2),
    (1, 3, 9, 9, 1, 8, 1, 2),
    (1, 2, 10, 13, 1, 20, 0, 1),
    (1, 2, 14, 14, 48, 48, 1, 1),
    (1, 2, 13, 13, 48, 48, 0, 1),
    (1, 3, 10, 11, 17, 33, 1, 2),
    (2, 2, 7, 7, 64, 64, 1, 4),
    (2, 3, 8, 12, 5, 3, 0, 2),
]


@pytest.mark.parametrize("shape", EMULATED, ids=str)
def test_s2_wgrad_band_emulated_equals_the_twin(shape):
    T, N, H, W, cin, cout, pad, sms = shape
    x, dy = (torch.from_numpy(a) for a in _inputs(shape[:7], sum(shape)))
    dw, db, plan = _emulate_band(x, dy, pad, sms)
    want_w, want_b = F.conv3x3_wgrad(x, dy, stride=2, padding=pad)
    _close(dw, want_w, "dw")
    _close(db, want_b, "db")


@pytest.mark.parametrize("shape", EMULATED, ids=str)
def test_s2_wgrad_mma_emulated_equals_the_twin(shape):
    T, N, H, W, cin, cout, pad, sms = shape
    x, dy = (torch.from_numpy(a).to(BF16)
             for a in _inputs(shape[:7], 2 * sum(shape)))
    dw, db, plan = _emulate_mma(x, dy, pad, sms)
    want_w, want_b = F.conv3x3_wgrad(x, dy, stride=2, padding=pad)
    _within_ulp(dw, want_w, "dw")
    _within_ulp(db, want_b, "db")


@pytest.mark.parametrize("bf16", (False, True), ids=("f32", "bf16"))
def test_emulated_s2_plans_cut_the_sum(bf16):
    """The emulated shapes cut a tenant's bands into several splits, one
    ending inside an image, and an image into several bands; the f32
    plans take replicas and one kernel row a block somewhere."""
    cut = inside = replicas = one_row = False
    for T, N, H, W, cin, cout, pad, sms in EMULATED:
        plan = cb.wgrad_plan(T, N, H, W, cin, cout, 2, pad, sms, bf16)
        cut |= plan.splits > 1 and plan.bands > 1
        inside |= any(len(plan.split_bands(s, N)) % plan.bands
                      for s in range(plan.splits))
        replicas |= plan.replicas > 1
        one_row |= plan.kernel_rows == 1
    assert cut and inside
    assert bf16 or (replicas and one_row)


JAX_SHAPES = [(2, 3, 11, 9, 3, 20, 2), (1, 2, 12, 10, 17, 24, 2),
              (1, 2, 9, 9, 1, 16, 2)]


@pytest.mark.parametrize("pad", (1, 0))
@pytest.mark.parametrize("shape", JAX_SHAPES, ids=("cin3", "cin17", "cin1"))
def test_s2_wgrad_emulated_equals_the_jax_gradient(shape, pad):
    """The gradient XLA derives for ``_conv2d_raw`` at stride 2 with
    respect to w and b, per tenant, on the same numpy-seeded inputs,
    against the emulated kernels: f32 within 1e-5 + 1e-4 of scale; bf16 dw
    from the bf16 ``jax.vjp`` within one bf16 ulp or 1e-4 of scale (XLA:CPU's
    bf16 dot sums in f32 and rounds once, the kernel's cast points), db from
    the same ``jax.vjp`` in f32 on the bf16 values, rounded once."""
    T, N, H, W, cin, cout, sms = shape
    x, dy = _inputs((T, N, H, W, cin, cout, pad), 7 + pad + cin)
    w = np.zeros((3, 3, cin, cout), np.float32)
    b = np.zeros((cout,), np.float32)
    dw32, db32, _ = _emulate_band(torch.from_numpy(x), torch.from_numpy(dy),
                                  pad, sms)
    tx, tdy = torch.from_numpy(x).to(BF16), torch.from_numpy(dy).to(BF16)
    dw16, db16, _ = _emulate_mma(tx, tdy, pad, sms)

    def from_jax(a):
        return torch.from_numpy(np.array(a.astype(jnp.float32)))

    with jax.disable_jit():
        for t in range(T):
            _, vjp = jax.vjp(lambda w_, b_: JF._conv2d_raw(
                jnp.asarray(x[t]), w_, b_, 2, pad, "im2col", "off"),
                jnp.asarray(w), jnp.asarray(b))
            jw, jb = vjp(jnp.asarray(dy[t]))
            for got, want in ((dw32[t], from_jax(jw)),
                              (db32[t], from_jax(jb))):
                err = (got - want).abs().max().item()
                assert err <= 1e-5 + 1e-4 * want.abs().max().item(), err
            xj, dyj = (jnp.asarray(a[t]).astype(jnp.bfloat16)
                       for a in (x, dy))
            _, vjp16 = jax.vjp(lambda w_, b_: JF._conv2d_raw(
                xj, w_, b_, 2, pad, "im2col", "off"),
                jnp.asarray(w).astype(jnp.bfloat16),
                jnp.asarray(b).astype(jnp.bfloat16))
            jw16, _ = vjp16(dyj)
            assert jw16.dtype == jnp.bfloat16
            _within_ulp(dw16[t], from_jax(jw16).to(BF16), "dw")
            _, vjp32 = jax.vjp(lambda w_, b_: JF._conv2d_raw(
                xj.astype(jnp.float32), w_, b_, 2, pad, "im2col", "off"),
                jnp.asarray(w), jnp.asarray(b))
            _, jb16 = vjp32(dyj.astype(jnp.float32))
            _within_ulp(db16[t], from_jax(jb16).to(BF16), "db")
