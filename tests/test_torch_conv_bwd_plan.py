"""The launch plans of K4's band kernels (``conv_block.wgrad_plan`` and
``conv_block.dgrad_plan``, f32 at stride 1), on the CPU: pure functions of
the shape, checked at every shape the shipped configs give K4 — the
mini-ImageNet stages (84/42/21/10 at pad 1, 84/41/19/8 at pad 0; cin 3
then 48, cout 48) and Omniglot's layers (28/14/7/3; cin 1 then 64, cout
64), at the configs' task batches (2, 8 and the large-batch config's 256)
and image counts — and emulated in plain PyTorch: the twin's wgrad taken
split by split over the plan's bands and summed in split order, and the
twin's dgrad computed band by band from each band's dy rows with their
halo, each against the whole twin within f32 round-off.

The kernels themselves run only on the card
(``tests/test_torch_kernels_cuda.py``).
"""

import itertools

import numpy as np
import pytest
import torch

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


def _rows(shape):
    """A shape's output rows over all its tenants' images: the most blocks
    a plan can give it (a band is at least one row)."""
    T, N, hw, _, _, pad = shape
    return T * N * (hw + 2 * pad - 2)


def _blocks(grid):
    return grid[0] * grid[1] * grid[2]


@pytest.mark.parametrize("shape", MAIN_SHAPES, ids=str)
def test_wgrad_plan_covers_each_pixel_once_and_fits_the_card(shape):
    T, N, hw, cin, cout, pad = shape
    plan = cb.wgrad_plan(T, N, hw, hw, cin, cout, 1, pad, SMS)
    Ho = hw + 2 * pad - 2
    assert plan.kernel == "band"
    assert plan.grid == (plan.splits, plan.grid[1], T)
    assert plan.grid[2] <= 65535
    assert 0 < plan.smem <= cb.BLOCK_SMEM
    # the FFMA threads in whole warps, and a warp for db
    assert plan.threads % 32 == 0
    assert 32 < plan.threads <= cb.WGRAD_MAX_THREADS + 32
    assert plan.kernel_rows in (1, 3) and 3 // plan.kernel_rows <= plan.grid[1]
    # the bands tile each image's output rows ...
    rows = plan.band_rows
    assert (plan.bands - 1) * rows < Ho <= plan.bands * rows
    # ... and the splits tile the tenant's bands, each band in one split
    seen = list(itertools.chain.from_iterable(
        plan.split_bands(s, N) for s in range(plan.splits)))
    assert seen == list(range(N * plan.bands))
    assert all(len(plan.split_bands(s, N)) for s in range(plan.splits))
    assert plan.scratch == ((T, plan.splits, 9 * cin * cout),
                            (T, plan.splits, cout))
    # the card holds at least 2 blocks a SM wherever the rows allow
    if _rows(shape) * plan.grid[1] >= 2 * SMS:
        assert _blocks(plan.grid) >= 2 * SMS


@pytest.mark.parametrize("shape", MAIN_SHAPES, ids=str)
def test_dgrad_plan_covers_each_row_once_and_fits_the_card(shape):
    T, N, hw, cin, cout, pad = shape
    plan = cb.dgrad_plan(T, N, hw, hw, cin, cout, 1, pad, SMS)
    assert plan.kernel == "band"
    assert plan.grid == (N * plan.bands, 1, T) and plan.grid[2] <= 65535
    rows = plan.band_rows
    assert (plan.bands - 1) * rows < hw <= plan.bands * rows
    assert 0 < plan.smem <= cb.BLOCK_SMEM
    assert 0 < plan.threads <= cb.DGRAD_MAX_THREADS
    # every pixel of a band has a thread's row: 8 pixels x (8 or 4)
    # channels a thread, in groups that split the sum over cout
    groups = -(-cin // (4 if cin <= 4 else 8))
    assert plan.threads == (plan.splits * -(-plan.band_rows * hw // 8)
                            * groups)
    assert 1 <= plan.splits <= -(-cout // 4)
    if T * N * hw >= 2 * SMS:
        assert _blocks(plan.grid) >= 2 * SMS


@pytest.mark.parametrize("shape", [
    (8, 25, 84, 3, 48), (8, 25, 42, 48, 48), (8, 20, 14, 64, 64),
    (2, 25, 84, 3, 48)], ids=str)
def test_the_large_band_plans_are_what_the_design_says(shape):
    """The shapes the design was sized on: wgrad at cin 3 takes all 27 k
    rows and replicas up to 224 threads, a ring of at most 75 KB a block,
    2 blocks a SM; at cin 48 and 64 one kernel row a block (three
    slices); dgrad a block of <= 128 threads and <= 75 KB, at least 2
    blocks a SM."""
    T, N, hw, cin, cout = shape
    w = cb.wgrad_plan(T, N, hw, hw, cin, cout, 1, 1, SMS)
    d = cb.dgrad_plan(T, N, hw, hw, cin, cout, 1, 1, SMS)
    assert w.kernel_rows == (3 if cin <= 4 else 1)
    assert w.grid[1] == 3 // w.kernel_rows
    assert w.smem <= cb.WGRAD_RING_BYTES
    assert _blocks(w.grid) == 2 * SMS
    assert d.smem <= cb.DGRAD_SMEM_BYTES
    assert _blocks(d.grid) >= 2 * SMS


@pytest.mark.parametrize("shape", [
    (8, 20, 28, 1, 64, 2), (8, 25, 84, 3, 48, 2), (8, 25, 42, 48, 48, 1),
    (2, 25, 41, 48, 48, 1)], ids=str)
def test_bf16_and_stride_2_plan_the_mma_and_s2_kernels(shape):
    """The dtype and the stride decide the wgrad kernel: f32 at stride 1
    the band kernel (above), at stride 2 its stride-2 form (``"s2"``,
    csrc/conv3x3_wgrad_s2.cu); bf16 the tensor-core kernels, ``"mma"`` at
    stride 1 (csrc/conv3x3_wgrad_s1_bf16.cu) and ``"s2_mma"`` at stride 2;
    every one on its own grid (splits, chunks or slices, tenants) with one
    partial a split. bf16 dgrad at stride 1 runs ``mma_plan``'s grid
    (csrc/conv3x3_s1_bf16.cu; stride 2: tests/test_torch_conv_s2_plan.py)."""
    T, N, hw, cin, cout, stride = shape
    Ho = (hw - 1) // stride + 1
    for bf16 in ((False, True) if stride == 2 else (True,)):
        plan = cb.wgrad_plan(T, N, hw, hw, cin, cout, stride, 1, SMS, bf16)
        want = {(1, True): "mma", (2, False): "s2", (2, True): "s2_mma"}
        assert plan.kernel == want[stride, bf16]
        assert plan.grid[0] == plan.splits and plan.grid[2] == T
        assert plan.scratch == ((T, plan.splits, 9 * cin * cout),
                                (T, plan.splits, cout))
        assert (plan.bands - 1) * plan.band_rows < Ho <= (plan.bands
                                                          * plan.band_rows)
        if stride == 1:
            d = cb.dgrad_plan(T, N, hw, hw, cin, cout, stride, 1, SMS, bf16)
            m = cb.mma_plan(T, N, Ho, hw, hw, cout, cin, True, SMS)
            assert d.kernel == "mma" and d.grid == m.grid
            assert d.channels == m.channels and d.smem == m.smem


def test_plans_refuse_rows_no_block_holds():
    with pytest.raises(ValueError, match="dgrad_plan"):
        cb.dgrad_plan(1, 1, 4, 4096, 64, 64)
    with pytest.raises(ValueError, match="wgrad_plan"):
        cb.wgrad_plan(1, 1, 4, 4096, 64, 64)
    with pytest.raises(ValueError, match="no conv3x3"):
        cb.wgrad_plan(1, 1, 2, 2, 3, 4, 1, 0)


def _arrays(shape, seed):
    T, N, H, W, cin, cout, pad = shape
    rng = np.random.RandomState(seed)
    Ho, Wo = F.conv_out_hw(H, W, 1, pad)
    x = torch.from_numpy(rng.randn(T, N, H, W, cin).astype(np.float32))
    dy = torch.from_numpy(rng.randn(T, N, Ho, Wo, cout).astype(np.float32))
    w = torch.from_numpy(rng.randn(T, 3, 3, cin, cout).astype(np.float32))
    return x, dy, w


# small shapes whose plans cut an image into several bands and a tenant's
# bands into several splits (one ending inside an image), at both pads
EMULATED = [
    # T, N, H, W, cin, cout, pad
    (2, 3, 11, 9, 3, 20, 1),
    (2, 3, 11, 9, 3, 20, 0),
    (1, 4, 12, 7, 16, 24, 1),
    (1, 2, 21, 21, 48, 48, 1),
    (1, 2, 19, 19, 48, 48, 0),
    (2, 3, 14, 14, 64, 64, 1),
]


def _close(got, want):
    scale = want.abs().max().item()
    err = (got.double() - want.double()).abs().max().item()
    assert err <= 1e-5 * max(scale, 1.0), (err, scale)


@pytest.mark.parametrize("shape", EMULATED, ids=str)
def test_wgrad_split_by_split_sums_to_the_twin(shape):
    T, N, H, W, cin, cout, pad = shape
    x, dy, _ = _arrays(shape, sum(shape))
    plan = cb.wgrad_plan(T, N, H, W, cin, cout, 1, pad, sms=4)
    assert plan.splits > 1 and plan.bands > 1
    Ho = dy.shape[2]
    dw = torch.zeros(T, 3, 3, cin, cout)
    db = torch.zeros(T, cout)
    for s in range(plan.splits):
        part = torch.zeros_like(dy)
        for b in plan.split_bands(s, N):
            img, band = divmod(b, plan.bands)
            oh0 = band * plan.band_rows
            rows = slice(oh0, min(Ho, oh0 + plan.band_rows))
            part[:, img, rows] = dy[:, img, rows]
        pw, pb = F.conv3x3_wgrad(x, part, padding=pad)
        dw += pw
        db += pb
    want_w, want_b = F.conv3x3_wgrad(x, dy, padding=pad)
    _close(dw, want_w)
    _close(db, want_b)


@pytest.mark.parametrize("shape", EMULATED, ids=str)
def test_dgrad_band_by_band_from_each_halo_equals_the_twin(shape):
    """Each band's dx from its own dy rows (the band's rows shifted by 2 -
    pad, 2 more rows, columns -(2 - pad) .. W + 1 - (2 - pad), zero outside
    dy): the transposed conv as a valid correlation of that halo with the
    flipped weights."""
    T, N, H, W, cin, cout, pad = shape
    _, dy, w = _arrays(shape, 3 * sum(shape))
    plan = cb.dgrad_plan(T, N, H, W, cin, cout, 1, pad, sms=4)
    assert plan.bands > 1
    org = 2 - pad
    Ho, Wo = dy.shape[2:4]
    padded = torch.zeros(T, N, H + 2, W + 2, cout)  # dy at (r - org, c - org)
    padded[:, :, org:org + Ho, org:org + Wo] = dy
    w_t = w.flip(1, 2).transpose(-1, -2)
    dx = torch.empty(T, N, H, W, cin)
    for band in range(plan.bands):
        ih0 = band * plan.band_rows
        rows = min(plan.band_rows, H - ih0)
        halo = padded[:, :, ih0:ih0 + rows + 2]
        dx[:, :, ih0:ih0 + rows] = F.conv2d(halo, w_t, None, 1, 0)
    _close(dx, F.conv3x3_dgrad(dy, w, 1, (H, W), pad))
