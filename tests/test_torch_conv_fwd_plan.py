"""The launch plan of K1's band kernels (``conv_block.fwd_plan``, f32 at
stride 1, both modes), on the CPU: a pure function of the shape, checked at
every shape the shipped configs give K1 — the set of
``tests/test_torch_conv_bwd_plan.py``: the mini-ImageNet stages (84/42/21/10
at pad 1, 84/41/19/8 at pad 0; cin 3 then 48, cout 48) and Omniglot's
layers (28/14/7/3; cin 1 then 64, cout 64), at the configs' task batches
(2, 8 and the large-batch config's 256) and image counts — and emulated in
plain PyTorch: the twin's conv taken band by band from each band's input
rows with their halo against the whole twin within f32 round-off (no
block splits an output's sum: each runs over (kh, kw, ci) in order in one
thread, the plain conv's order); each band's (count, mean, M2) merged in
the merge kernel's order against the twin's statistics, and at one small
shape per pad against the JAX package's ``batch_norm`` statistics
(``ops/functional.py`` :368, run eagerly on the CPU).

The kernels themselves run only on the card
(``tests/test_torch_kernels_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu.ops import functional as JF
from howtotrainyourmamlpytorch_tpu_torch.kernels import conv_block as cb
from howtotrainyourmamlpytorch_tpu_torch.ops import functional as F

SMS = 132  # an H100 SXM's SMs
MINI = ((84, 3), (42, 48), (21, 48), (10, 48))
MINI_P0 = ((84, 3), (41, 48), (19, 48), (8, 48))
OMNIGLOT = ((28, 1), (14, 64), (7, 64), (3, 64))
# (T, N, H = W, cin, cout, pad): mini-ImageNet 5-way 1- and 5-shot (support
# 5 / 25, target 75) at batch 2, 8 and 256; Omniglot 5- and 20-way, 1- and
# 5-shot (5, 20, 25, 100 images) at batch 8
MAIN_SHAPES = (
    [(T, n, hw, cin, 48, 1) for T in (2, 8, 256) for n in (5, 25, 75)
     for hw, cin in MINI]
    + [(T, n, hw, cin, 48, 0) for T in (2, 8) for n in (25, 75)
       for hw, cin in MINI_P0]
    + [(8, n, hw, cin, 64, 1) for n in (5, 20, 25, 100)
       for hw, cin in OMNIGLOT]
)


def _runs(plan, Wo):
    """8-pixel runs of a band on its ``Wo + 2``-wide grid."""
    return -(-((plan.band_rows - 1) * (Wo + 2) + Wo) // 8)


@pytest.mark.parametrize("shape", MAIN_SHAPES, ids=str)
def test_fwd_plan_covers_each_row_once_and_fits_the_card(shape):
    T, N, hw, cin, cout, pad = shape
    plan = cb.fwd_plan(T, N, hw, hw, cin, cout, 1, pad, SMS)
    Ho = hw + 2 * pad - 2
    assert plan.kernel == "band"
    assert plan.grid == (N * plan.bands, 1, T) and plan.grid[2] <= 65535
    # the bands tile each image's output rows
    rows = plan.band_rows
    assert (plan.bands - 1) * rows < Ho <= plan.bands * rows
    # a thread a run x a group of 8 channels (4 where the card would hold
    # too few threads), within the block limits
    assert plan.channels in (8, 4)
    assert plan.threads == _runs(plan, Ho) * -(-cout // plan.channels)
    if plan.channels == 4:
        wide = cb._band_plan(T, N, Ho, Ho, cin, cout, SMS, 8)
        assert (wide.grid[0] * T * wide.threads
                < cb.FWD_FILL_THREADS * SMS)
    assert 0 < plan.threads <= cb.FWD_MAX_THREADS <= cb.BAND_LAUNCH_BOUND
    assert 0 < plan.smem <= cb.FWD_SMEM_BYTES <= cb.BLOCK_SMEM
    # two blocks of the largest plan fit a SM's 228 KB (1 KB reserved each)
    assert 2 * (cb.FWD_SMEM_BYTES + 1024) <= 228 * 1024
    assert plan.scratch == (T, N * plan.bands, 3, cout)
    # the card holds at least 2 blocks a SM wherever the rows allow
    if T * N * Ho >= 2 * SMS:
        assert T * N * plan.bands >= 2 * SMS


@pytest.mark.parametrize("shape", [
    (8, 75, 84, 3, 48, 1), (8, 75, 42, 48, 48, 1), (8, 75, 21, 48, 48, 1),
    (8, 20, 14, 64, 64, 1), (8, 75, 41, 48, 48, 0)], ids=str)
def test_the_large_band_plans_are_what_the_design_says(shape):
    """The shapes the design was sized on: at least two blocks a SM, of at
    most 256 threads and 100 KB (two blocks a SM); at cin 3 the bytes of y
    bind, so the band is as many rows as 256 threads take (3 at 84 pixels
    a row); 8 channels a thread (Omniglot's 14 x 14 holds 271 threads a
    SM so)."""
    T, N, hw, cin, cout, pad = shape
    plan = cb.fwd_plan(T, N, hw, hw, cin, cout, 1, pad, SMS)
    assert plan.grid[0] * plan.grid[2] >= 2 * SMS
    assert plan.channels == 8
    if (hw, cin, pad) == (84, 3, 1):
        assert plan.band_rows == 3 and plan.threads == 192


@pytest.mark.parametrize("shape", [
    (8, 20, 7, 64, 64), (8, 20, 3, 64, 64), (8, 25, 10, 48, 48),
    (2, 5, 42, 48, 48)], ids=str)
def test_small_maps_take_bands_of_fewer_rows(shape):
    """Where whole images are too few for two blocks a SM (Omniglot 7 x 7
    and 3 x 3, mini-ImageNet 10 x 10, few images), the bands take fewer
    rows, down to one, until the grid has two blocks a SM; and a thread
    takes 4 channels, where 8 would leave the card fewer than
    ``FWD_FILL_THREADS`` threads a SM."""
    T, N, hw, cin, cout = shape
    plan = cb.fwd_plan(T, N, hw, hw, cin, cout, 1, 1, SMS)
    assert plan.band_rows < hw and plan.bands > 1
    assert T * N * plan.bands >= 2 * SMS or plan.band_rows == 1
    assert plan.channels == 4


@pytest.mark.parametrize("shape", [
    (8, 20, 28, 1, 64, 2), (8, 25, 84, 3, 48, 2), (8, 25, 42, 48, 48, 1),
    (2, 25, 41, 48, 48, 1)], ids=str)
def test_bf16_and_stride_2_take_the_mma_and_s2_kernels(shape):
    """At stride 2 f32 runs the band kernel of csrc/conv3x3_s2.cu
    (``"s2"``, a block a band of one image) and bf16 its tensor-core kernel
    (``"s2_mma"`` on ``s2_mma_plan``'s grid); bf16 at stride 1 runs the
    tensor-core kernel of csrc/conv3x3_s1_bf16.cu on ``mma_plan``'s grid.
    Every one's statistics' partials are a band each."""
    T, N, hw, cin, cout, stride = shape
    Ho = (hw - 1) // stride + 1
    for bf16 in ((False, True) if stride == 2 else (True,)):
        plan = cb.fwd_plan(T, N, hw, hw, cin, cout, stride, 1, SMS, bf16)
        if stride == 1:
            m = cb.mma_plan(T, N, hw, Ho, Ho, cin, cout, False, SMS)
        elif bf16:
            m = cb.s2_mma_plan(T, N, hw, hw, cin, cout, 1, False, SMS)
        if bf16:
            assert plan.kernel == ("mma" if stride == 1 else "s2_mma")
            assert plan.channels == m.channels and plan.smem == m.smem
            assert plan.grid == m.grid and plan.bands == m.bands
        else:
            assert plan.kernel == "s2" and plan.channels in (8, 4)
            assert plan.grid == (N * plan.bands, 1, T)
        assert (plan.bands - 1) * plan.band_rows < Ho
        assert Ho <= plan.bands * plan.band_rows
        assert plan.scratch == (T, N * plan.bands, 3, cout)


def test_fwd_plan_refuses_rows_no_block_holds():
    with pytest.raises(ValueError, match="fwd_plan"):
        cb.fwd_plan(1, 1, 4, 4096, 64, 64)
    with pytest.raises(ValueError, match="no conv3x3"):
        cb.fwd_plan(1, 1, 2, 2, 3, 4, 1, 0)


# small shapes whose plans cut an image into several bands, at both pads
# (sms chosen for that), bands of one row and of rows that do not divide
# the output
EMULATED = [
    # T, N, H, W, cin, cout, pad, sms
    (2, 3, 11, 9, 3, 20, 1, 8),
    (2, 3, 11, 9, 3, 20, 0, 8),
    (1, 2, 21, 21, 48, 48, 1, 4),
    (1, 2, 19, 19, 48, 48, 0, 4),
    (2, 3, 14, 14, 64, 64, 1, 16),
    (2, 2, 7, 7, 64, 64, 1, 16),
    (2, 2, 3, 3, 64, 64, 1, 16),
    (1, 3, 10, 10, 17, 33, 1, 8),
    (1, 2, 8, 8, 48, 48, 0, 8),
]


def _arrays(shape, seed):
    T, N, H, W, cin, cout = shape[:6]
    rng = np.random.RandomState(seed)
    x = rng.randn(T, N, H, W, cin).astype(np.float32)
    w = (rng.randn(T, 3, 3, cin, cout) * (2.0 / (9 * cin)) ** 0.5
         ).astype(np.float32)
    b = (rng.randn(T, cout) * 0.1).astype(np.float32)
    return x, w, b


def _close(got, want, tol=1e-5):
    scale = want.abs().max().item()
    err = (got.double() - want.double()).abs().max().item()
    assert err <= tol * max(scale, 1.0), (err, scale)


@pytest.mark.parametrize("shape", EMULATED, ids=str)
def test_band_by_band_from_each_halo_equals_the_twin(shape):
    """Each band's y from its own CR + 2 input rows (zero outside the image
    at pad 1), the bias last: the whole twin's y."""
    T, N, H, W, cin, cout, pad, sms = shape
    x, w, b = (torch.from_numpy(a) for a in _arrays(shape, sum(shape)))
    plan = cb.fwd_plan(T, N, H, W, cin, cout, 1, pad, sms)
    assert plan.kernel == "band" and plan.bands > 1
    Ho, Wo = F.conv_out_hw(H, W, 1, pad)
    padded = torch.zeros(T, N, H + 2 * pad, W + 2 * pad, cin)
    padded[:, :, pad:pad + H, pad:pad + W] = x
    y = torch.empty(T, N, Ho, Wo, cout)
    for band in range(plan.bands):
        oh0 = band * plan.band_rows
        rows = min(plan.band_rows, Ho - oh0)
        halo = padded[:, :, oh0:oh0 + rows + 2]
        y[:, :, oh0:oh0 + rows] = F.conv2d(halo, w, b, 1, 0)
    _close(y, F.conv3x3(x, w, b, padding=pad))


def _chan_merge(a, bb):
    """The merge kernel's ``chan_merge`` on (n, mean, m2) triples of
    per-channel tensors; an empty side keeps the other."""
    n, mu, m2 = a
    nb, mub, m2b = bb
    nn = n + nb
    d = mub - mu
    safe = torch.where(nn > 0, nn, torch.ones_like(nn))
    mean = torch.where(n == 0, mub, torch.where(nb == 0, mu,
                                                 mu + d * (nb / safe)))
    m2n = torch.where(n == 0, m2b, torch.where(
        nb == 0, m2, m2 + m2b + d * d * (n * nb / safe)))
    return nn, mean, m2n


def _merged_stats(plan, y, eps):
    """Per band and channel (count, mean, M2) over the band's pixels, then
    the merge kernel's order: 256 threads each merging partials i, i + 256,
    ... in turn, then a pairwise tree of strides 128, 64, ..., 1."""
    T, N, Ho, Wo, C = y.shape
    parts = []
    for img in range(N):
        for band in range(plan.bands):
            oh0 = band * plan.band_rows
            v = y[:, img, oh0:oh0 + plan.band_rows].reshape(T, -1, C)
            cnt = torch.full((T, C), float(v.shape[1]))
            mean = v.sum(dim=1) / cnt
            m2 = ((v - mean[:, None]) ** 2).sum(dim=1)
            parts.append((cnt, mean, m2))
    zero = torch.zeros(T, C)
    lanes = [(zero, zero, zero)] * 256
    for i, p in enumerate(parts):
        lanes[i % 256] = _chan_merge(lanes[i % 256], p)
    stride = 128
    while stride:
        for i in range(stride):
            lanes[i] = _chan_merge(lanes[i], lanes[i + stride])
        stride //= 2
    n, mean, m2 = lanes[0]
    var = m2 / n
    return mean, var, 1.0 / torch.sqrt(var + eps)


@pytest.mark.parametrize("shape", EMULATED, ids=str)
def test_band_statistics_merged_in_order_equal_the_twins(shape):
    T, N, H, W, cin, cout, pad, sms = shape
    x, w, b = (torch.from_numpy(a) for a in _arrays(shape, 2 * sum(shape)))
    plan = cb.fwd_plan(T, N, H, W, cin, cout, 1, pad, sms)
    y, mean, var, rstd = F.conv3x3_fwd_stats(x, w, b, padding=pad)
    for got, want in zip(_merged_stats(plan, y, F.BN_EPS), (mean, var, rstd)):
        _close(got, want)


@pytest.mark.parametrize("pad", (1, 0))
def test_band_statistics_equal_the_jax_batch_norm(pad):
    """At one small shape per pad, the merged band statistics against the
    JAX package's ``batch_norm`` (run eagerly on the CPU, per tenant): its
    batch mean and unbiased variance come out as the running statistics of
    momentum 1 from zero, and its output with gamma 1 and beta 0 is the
    normalization by them."""
    shape = (2, 3, 11, 9, 3, 20, pad, 8)
    T, N, H, W, cin, cout, _, sms = shape
    x, w, b = (torch.from_numpy(a) for a in _arrays(shape, 5 + pad))
    plan = cb.fwd_plan(T, N, H, W, cin, cout, 1, pad, sms)
    assert plan.bands > 1
    y = F.conv3x3(x, w, b, padding=pad)
    mean, var, rstd = _merged_stats(plan, y, F.BN_EPS)
    n = N * y.shape[2] * y.shape[3]
    for t in range(T):
        yj = jnp.asarray(y[t].numpy())
        ones, zeros = jnp.ones(cout), jnp.zeros(cout)
        z, run_mean, run_var = JF.batch_norm(yj, ones, zeros, zeros, zeros,
                                             momentum=1.0, eps=F.BN_EPS)
        _close(mean[t], torch.from_numpy(np.array(run_mean)))
        _close(var[t] * (n / (n - 1)), torch.from_numpy(np.array(run_var)))
        _close((y[t] - mean[t]) * rstd[t], torch.from_numpy(np.array(z)),
               1e-4)
