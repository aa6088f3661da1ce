"""The launch plan of ``act_pool_fwd``, ``act_pool_bwd`` and
``act_pool_gather`` (``conv_block.act_pool_plan``, the pooled kernels of
``kernels/csrc/act.cu``) on the CPU: a pure function of the shape, checked
at every act-pool shape ``chip_smoke.py`` runs — the norm-first and
layer-norm blocks' conv outputs, padded (84/42/21/10) and unpadded
(82/39/17/6) at 48 channels, N = 25 and 75, and Omniglot's pooled maps
(28/14/7/3 at 64 channels) — in f32 and bf16, with vectors and a channel
a thread: the forward's threads write every pooled element once and read
only inside y, the backward's write every element of dy once, the dropped
odd row and column included; odd C and unaligned pointers take one
channel a thread (``act_pool_vec``), and the large-batch geometry's stage
0 (T = 256) the 64-bit index arithmetic, whose 32-bit form would wrap.

Then both kernels emulated in plain PyTorch, thread by thread as the plan
lays them out (the same index arithmetic, the taps loaded as vectors, the
bf16 negative side rounded before the compare, the first maximum winning
a tie, the argmax bytes packed into one 32- or 64-bit word; the backward
reading y at a tap only where a lane of its vector selects it), against
the twins (``ops/functional.py::act_pool_fwd``, ``::act_pool_bwd``) bit
for bit in f32 and bf16, zeros' signs included, at odd maps and on inputs
that hold exact ties; and against the JAX package's ``max_pool2d(
leaky_relu(x), impl='reduce_window')`` :325/:363 and its ``jax.vjp``, run
on the CPU: every value equal (no tolerance; only the sign of a zero off
the argmax may differ, which a value compare does not see). The gather
likewise, on the forward's mapping (each thread its argmax word once,
g_dy and y only at the taps a lane of its vector selects, the mask from
y): bit for bit ``::act_pool_gather`` with exact ties and zeros of both
signs, every pooled element written once, and value-equal to the JAX
package's second derivative (``jax.vjp`` in the cotangent of the
``jax.vjp`` of ``max_pool2d(leaky_relu(x), impl='reduce_window')``).

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
# (T, N, H = W, C) of every act-pool call chip_smoke.py makes: the
# mini-ImageNet norm-first and layer-norm models' conv outputs, padded and
# unpadded, at the support (25) and the target (75) images of T = 8
# tenants, and the pooled Omniglot maps (64 channels, N = 20)
SHAPES = ([(8, n, hw, 48) for hw in (84, 42, 21, 10) for n in (25, 75)]
          + [(8, n, hw, 48) for hw in (82, 39, 17, 6) for n in (25, 75)]
          + [(8, 20, hw, 64) for hw in (28, 14, 7, 3)])


# -- the plan, as the kernels index it -----------------------------------------


def _locate(plan, H, W, C, lanes, bwd, dtype=np.int64):
    """``locate`` of csrc/act.cu for the threads ``lanes`` of the forward
    (or with ``bwd`` the backward), in the index type ``dtype``: each thread's
    window (h, w), the offsets of its first tap in y and of its pooled
    element, at its first channel."""
    Hw, Ww = plan.windows if bwd else plan.pooled
    Ho, Wo = plan.pooled
    l = lanes.astype(dtype)
    G, V = dtype(plan.groups), dtype(plan.items)
    q = l // G
    c0 = (l - q * G) * V
    r = q // dtype(Ww)
    img = r // dtype(Hw)
    w = q - r * dtype(Ww)
    h = r - img * dtype(Hw)
    two = dtype(2)
    y = ((img * dtype(H) + two * h) * dtype(W) + two * w) * dtype(C) + c0
    pooled = ((img * dtype(Ho) + h) * dtype(Wo) + w) * dtype(C) + c0
    return h, w, y, pooled


def _tap(k, W, C):
    """Tap k's offset from the window's first (2 * dh + dw order)."""
    return ((k >> 1) * W + (k & 1)) * C


def _work(plan, T, N, bwd):
    Hw, Ww = plan.windows if bwd else plan.pooled
    return T * N * Hw * Ww * plan.groups


@functools.lru_cache(maxsize=None)
def _coverage(N, H, W, C, bf16, vec):
    """Over N images: how often the forward's threads write each pooled
    element, the backward's each element of dy, and the least and most
    offset of y the forward reads."""
    plan = cb.act_pool_plan(1, N, H, W, C, bf16, vec)
    j = np.arange(plan.items)
    lanes = np.arange(_work(plan, 1, N, False))
    _, _, y, pooled = _locate(plan, H, W, C, lanes, False)
    out = np.bincount((pooled[:, None] + j).ravel(),
                      minlength=N * (H // 2) * (W // 2) * C)
    taps = y[:, None] + np.array([_tap(k, W, C) for k in range(4)])
    read = (taps.min(), taps.max() + plan.items - 1)
    h, w, y, _ = _locate(plan, H, W, C,
                         np.arange(_work(plan, 1, N, True)), True)
    written = []
    for k in range(4):
        inside = (2 * h + (k >> 1) < H) & (2 * w + (k & 1) < W)
        written.append((y[inside, None] + _tap(k, W, C) + j).ravel())
    dy = np.bincount(np.concatenate(written), minlength=N * H * W * C)
    return out, dy, read


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plan_covers_every_window_and_every_element_once(shape):
    """In f32 and bf16, with vectors and a channel a thread: the plan is
    pure, its grids just cover their threads, and over two images (the
    index arithmetic is the same at every image) the forward writes each
    pooled element once and reads inside y, the backward each element of
    dy once — the dropped odd row and column among them."""
    T, N, hw, C = shape
    for bf16 in (False, True):
        for vec in (True, False):
            plan = cb.act_pool_plan(T, N, hw, hw, C, bf16, vec)
            assert plan == cb.act_pool_plan(T, N, hw, hw, C, bf16, vec)
            assert plan.threads == cb.ACT_THREADS == 256
            assert plan.items == ((8 if bf16 else 4) if vec else 1)
            assert plan.groups * plan.items == C
            assert plan.pooled == (hw // 2, hw // 2)
            assert plan.windows == (-(-hw // 2), -(-hw // 2))
            assert not plan.wide
            for blocks, bwd in ((plan.fwd_blocks, False),
                                (plan.bwd_blocks, True)):
                work = _work(plan, T, N, bwd)
                assert (blocks - 1) * plan.threads < work
                assert blocks * plan.threads >= work
            out, dy, (lo, hi) = _coverage(2, hw, hw, C, bf16, vec)
            assert (out == 1).all() and (dy == 1).all()
            assert lo == 0 and hi < 2 * hw * hw * C
    assert (plan.bwd_blocks > plan.fwd_blocks) == (hw % 2 == 1)


@pytest.mark.parametrize("shape", [(2, 3, 21, 21, 47), (2, 3, 9, 7, 3),
                                   (1, 2, 5, 4, 12), (3, 1, 2, 3, 1)],
                         ids=str)
def test_odd_channels_and_odd_maps_take_a_channel_a_thread(shape):
    """C off the vector (47, 3, 1; 12 is a vector of f32 but not of bf16)
    refuses the vector plan; the scalar plan covers every element once."""
    T, N, H, W, C = shape
    for bf16 in (False, True):
        items = 8 if bf16 else 4
        if C % items:
            with pytest.raises(ValueError, match="with vectors"):
                cb.act_pool_plan(T, N, H, W, C, bf16, True)
            assert not cb.act_pool_vec(C, bf16, (0, 256), 0)
        plan = cb.act_pool_plan(T, N, H, W, C, bf16, False)
        assert plan.items == 1 and plan.groups == C
        out, dy, (lo, hi) = _coverage(N, H, W, C, bf16, False)
        assert (out == 1).all() and (dy == 1).all()
        assert lo == 0 and hi < N * H * W * C


def test_unaligned_pointers_take_a_channel_a_thread():
    """``act_pool_vec``: every float tensor on 16 bytes and the argmax on
    the vector's channels (4 f32, 8 bf16), C a whole number of vectors;
    one element or byte off any of them, a channel a thread."""
    base = 1 << 20
    for bf16, items in ((False, 4), (True, 8)):
        ptrs = (base, base + 4096, base + 8192)
        assert cb.act_pool_vec(48, bf16, ptrs, base + 64)
        assert cb.act_pool_vec(48, bf16, ptrs[:2], base + items)
        for i in range(3):
            off = list(ptrs)
            off[i] += 2 if bf16 else 4  # one element into its storage
            assert not cb.act_pool_vec(48, bf16, off, base)
        assert not cb.act_pool_vec(48, bf16, ptrs, base + 1)
        assert not cb.act_pool_vec(48, bf16, ptrs, base + items // 2)
        assert not cb.act_pool_vec(items + 2, bf16, ptrs, base)


def test_the_large_batch_stage_0_takes_the_64_bit_route():
    """T = 256 at stage 0 (N = 25, 84x84x48) holds more than 2**31
    elements in all (each tenant far fewer): the plan asks for 64-bit
    index arithmetic, under which the last threads' offsets lie inside the
    tensor past 2**31, where a 32-bit int would wrap; T = 8 stays
    32-bit. The route turns exactly at 2**31 elements."""
    T, N, hw, C = 256, 25, 84, 48
    total = T * N * hw * hw * C
    assert total > 2 ** 31 > N * hw * hw * C
    assert not cb.act_pool_plan(8, N, hw, hw, C).wide
    for bf16 in (False, True):
        plan = cb.act_pool_plan(T, N, hw, hw, C, bf16, True)
        assert plan.wide
        for bwd in (False, True):
            work = _work(plan, T, N, bwd)
            lanes = np.arange(work - 3 * plan.groups, work)
            h, w, y, pooled = _locate(plan, hw, hw, C, lanes, bwd)
            assert (y[:, None] + _tap(3, hw, C) + plan.items - 1
                    < total).all()
            assert y.max() >= 2 ** 31
            img = T * N - 1
            assert (y[-plan.groups:] == img * hw * hw * C + (
                (2 * h[-1]) * hw + 2 * w[-1]) * C
                + np.arange(plan.groups) * plan.items).all()
            with np.errstate(over="ignore"):
                _, _, y32, _ = _locate(plan, hw, hw, C, lanes, bwd,
                                       np.int32)
            assert (y32.astype(np.int64) != y).all()
    assert cb.act_pool_plan(2, 1, 2 ** 15, 2 ** 15, 1, True, False).wide
    assert not cb.act_pool_plan(2, 1, 2 ** 15, 2 ** 15 - 1, 1, True,
                                False).wide


def test_act_pool_plan_refuses_what_the_kernels_do_not_take():
    for bad in ((0, 3, 8, 8, 48), (2, 0, 8, 8, 48), (2, 3, 8, 8, 0),
                (2, 3, 1, 8, 48), (2, 3, 8, 1, 48)):
        for vec in (True, False):
            with pytest.raises(ValueError, match="no act-pool launch"):
                cb.act_pool_plan(*bad, False, vec)


# -- the kernels, emulated ------------------------------------------------------


def _leaky(v, slope):
    """``leaky`` of csrc/act.cu on f32 values: one IEEE multiply."""
    return torch.where(v >= 0, v, v * slope)


def _emulated_fwd(plan, y, slope):
    """The forward thread by thread: each loads its window's four taps at
    its channels (f32 values), applies the leaky-ReLU (in bf16 the negative
    side rounded to bf16 before the compare), keeps the first maximum, and
    stores its pooled values (rounded once to y's dtype) and its argmax
    bytes as one word of ``items`` bytes."""
    T, N, H, W, C = y.shape
    Ho, Wo = plan.pooled
    V = plan.items
    yf = y.float().reshape(-1)
    _, _, first, dst = _locate(plan, H, W, C,
                               np.arange(_work(plan, T, N, False)), False)
    j = np.arange(V)
    best = arg = None
    for k in range(4):
        v = _leaky(yf[torch.from_numpy(first[:, None] + _tap(k, W, C) + j)],
                   slope)
        if y.dtype == BF16:
            v = v.to(BF16).float()
        if k == 0:
            best, arg = v, torch.zeros(v.shape, dtype=torch.int64)
        else:
            upd = v > best  # the first maximum wins a tie
            best = torch.where(upd, v, best)
            arg = torch.where(upd, torch.tensor(k), arg)
    out = torch.full((T * N * Ho * Wo * C,), float("nan"), dtype=y.dtype)
    out[torch.from_numpy(dst[:, None] + j).reshape(-1)] = best.reshape(
        -1).to(y.dtype)
    # the argmax bytes: one little-endian word of V bytes a thread
    words = (arg.numpy().astype(np.uint64) << (8 * j).astype(np.uint64)).sum(
        1, dtype=np.uint64)
    raw = np.full(T * N * Ho * Wo * C, 255, dtype=np.uint8)
    word_type = {1: np.uint8, 4: np.uint32, 8: np.uint64}[V]
    raw.view(word_type)[dst // V] = words.astype(word_type)
    shape = (T, N, Ho, Wo, C)
    return out.reshape(shape), torch.from_numpy(raw).reshape(shape)


def _emulated_bwd(plan, dp, arg, y, slope):
    """The backward thread by thread over ceil(H/2) x ceil(W/2) windows,
    into dy prefilled with NaN (an element no thread writes stays NaN): a
    window of the dropped row or column writes +0 at its taps inside the
    map; any other loads its pooled gradient d and argmax word, and at each
    tap reads y only where a lane of its vector selects the tap (else +0,
    which keeps the off-argmax d * 0) and writes leaky(sel ? d : d * 0, y)
    rounded once to y's dtype. Returns dy and the taps whose y it read."""
    T, N, H, W, C = y.shape
    Ho, Wo = plan.pooled
    V = plan.items
    h, w, first, src = _locate(plan, H, W, C,
                               np.arange(_work(plan, T, N, True)), True)
    j = np.arange(V)
    dy = torch.full((y.numel(),), float("nan"), dtype=y.dtype)
    yf = y.float().reshape(-1)
    tail = (h >= Ho) | (w >= Wo)
    for k in range(4):
        inside = tail & (2 * h + (k >> 1) < H) & (2 * w + (k & 1) < W)
        at = torch.from_numpy(first[inside, None] + _tap(k, W, C) + j)
        dy[at.reshape(-1)] = 0.0
    first, src = first[~tail], src[~tail]
    word_type = {1: np.uint8, 4: np.uint32, 8: np.uint64}[V]
    words = arg.numpy().reshape(-1).view(word_type)[src // V]
    sel = torch.from_numpy(((words[:, None].astype(np.uint64)
                             >> (8 * j).astype(np.uint64)) & 0xff
                            ).astype(np.int64))
    d = dp.float().reshape(-1)[torch.from_numpy(src[:, None] + j)]
    off = d * 0.0  # the twin's one-hot product: the sign of d
    loads = 0
    for k in range(4):
        hit = (sel == k).any(1, keepdim=True)
        loads += int(hit.sum())
        at = torch.from_numpy(first[:, None] + _tap(k, W, C) + j)
        yk = torch.where(hit, yf[at], torch.zeros(()))
        o = torch.where(yk >= 0, torch.where(sel == k, d, off),
                        torch.where(sel == k, d, off) * slope)
        dy[at.reshape(-1)] = o.reshape(-1).to(y.dtype)
    return dy.reshape(y.shape), loads


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _inputs(T, N, H, W, C, dtype, seed):
    """y on a grid of 0.25 (exact ties in many windows, at positive and at
    negative maxima; zeros of both signs) plus a continuous part on half
    its elements, and a pooled gradient of both signs, from a numpy seed;
    in bf16 the grid's negative side also ties after the slope's
    rounding."""
    rng = np.random.RandomState(seed)
    shape = (T, N, H, W, C)
    y = rng.randint(-4, 4, size=shape) * 0.25 + rng.randn(*shape) * (
        rng.rand(*shape) < 0.5)
    y = y.astype(np.float32)
    y.reshape(-1)[3::13] = -0.0
    dp = rng.randn(T, N, H // 2, W // 2, C).astype(np.float32)
    return torch.from_numpy(y).to(dtype), torch.from_numpy(dp).to(dtype)


# small shapes: odd in one or both dims (the dropped row and column), C a
# whole number of vectors of both dtypes (16, 48) or of f32 alone (12),
# off the vector (3, 1); several images and tenants
EMULATED = [
    # T, N, H, W, C
    (2, 3, 9, 7, 16),
    (2, 2, 10, 10, 48),
    (1, 3, 7, 7, 12),
    (3, 2, 5, 6, 3),
    (2, 2, 3, 3, 1),
]
DTYPES = {"f32": torch.float32, "bf16": BF16}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", EMULATED, ids=str)
def test_emulated_kernels_equal_the_twins_bit_for_bit(shape, dtype):
    """Both kernels emulated with vectors (where C takes them) and a
    channel a thread: the pooled values, the argmax and dy are the twins'
    bits, zeros' signs included; no element of dy is left unwritten; the
    backward skips y at the taps no lane of a vector selects."""
    T, N, H, W, C = shape
    bf16 = dtype == "bf16"
    y, dp = _inputs(*shape, DTYPES[dtype], sum(shape))
    slope = F.scalar_like(F.LEAKY_SLOPE, y)
    want, want_arg = F.act_pool_fwd(y)
    want_dy = F.act_pool_bwd(dp, want_arg, y)
    if N * H * W * C > 256:  # the inputs hold exact ties
        ties = F._windows(F.act_fwd(y))
        assert int(((ties == ties.amax(-1, keepdim=True)).sum(-1) > 1).sum())
    for vec in (True, False):
        if vec and C % (8 if bf16 else 4):
            continue
        plan = cb.act_pool_plan(T, N, H, W, C, bf16, vec)
        got, arg = _emulated_fwd(plan, y, slope)
        assert torch.equal(_bits(got), _bits(want))
        assert torch.equal(arg, want_arg)
        dy, loads = _emulated_bwd(plan, dp, arg, y, slope)
        assert torch.equal(_bits(dy), _bits(want_dy))
        taps = 4 * dp.numel() // plan.items
        assert loads < taps if vec else loads == dp.numel()


def _to_torch(a, dtype):
    return torch.from_numpy(np.array(a.astype(jnp.float32))).to(dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(2, 3, 9, 7, 16), (2, 2, 6, 6, 48),
                                   (2, 2, 5, 5, 3)], ids=str)
def test_emulated_kernels_equal_the_jax_package(shape, dtype):
    """The JAX package's ``leaky_relu`` -> ``max_pool2d(impl=
    'reduce_window')`` per tenant and its ``jax.vjp``, on the CPU, against
    the emulated kernels on the same y and pooled gradient: the pooled
    values equal, and dy's values equal (the gradient to the first
    maximum at exact ties). No tolerance."""
    T, N, H, W, C = shape
    bf16 = dtype == "bf16"
    y, dp = _inputs(*shape, DTYPES[dtype], 3 * sum(shape))
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    jy = jnp.asarray(y.float().numpy()).astype(jdt)

    def act_pool(v):
        return JF.max_pool2d(JF.leaky_relu(v), impl="reduce_window")

    jout, vjp = jax.vjp(jax.vmap(act_pool), jy)
    (jdy,) = vjp(jnp.asarray(dp.float().numpy()).astype(jdt))
    plan = cb.act_pool_plan(T, N, H, W, C, bf16, C % (8 if bf16 else 4) == 0)
    slope = F.scalar_like(F.LEAKY_SLOPE, y)
    got, arg = _emulated_fwd(plan, y, slope)
    dy, _ = _emulated_bwd(plan, dp, arg, y, slope)
    assert torch.equal(got, _to_torch(jout, y.dtype))
    assert torch.equal(dy, _to_torch(jdy, y.dtype))


def _emulated_gather(plan, g_dy, arg, y, slope):
    """The gather thread by thread over the pooled windows, into a pooled
    tensor prefilled with NaN: each loads its argmax word, then g_dy and y
    at a tap only where a lane of its vector selects it (else +0), and
    writes leaky(g, y) at its lanes' argmax taps, rounded once to y's
    dtype. Returns the output and the taps whose g_dy and y it read."""
    T, N, H, W, C = y.shape
    Ho, Wo = plan.pooled
    V = plan.items
    _, _, first, dst = _locate(plan, H, W, C,
                               np.arange(_work(plan, T, N, False)), False)
    j = np.arange(V)
    word_type = {1: np.uint8, 4: np.uint32, 8: np.uint64}[V]
    words = arg.numpy().reshape(-1).view(word_type)[dst // V]
    sel = torch.from_numpy(((words[:, None].astype(np.uint64)
                             >> (8 * j).astype(np.uint64)) & 0xff
                            ).astype(np.int64))
    gf, yf = g_dy.float().reshape(-1), y.float().reshape(-1)
    picked_g = torch.zeros(sel.shape)
    picked_y = torch.zeros(sel.shape)
    loads = 0
    for k in range(4):
        hit = (sel == k).any(1, keepdim=True)
        loads += int(hit.sum())
        at = torch.from_numpy(first[:, None] + _tap(k, W, C) + j)
        gk = torch.where(hit, gf[at], torch.zeros(()))
        yk = torch.where(hit, yf[at], torch.zeros(()))
        picked_g = torch.where(sel == k, gk, picked_g)
        picked_y = torch.where(sel == k, yk, picked_y)
    out = torch.full((T * N * Ho * Wo * C,), float("nan"), dtype=y.dtype)
    out[torch.from_numpy(dst[:, None] + j).reshape(-1)] = _leaky_masked(
        picked_g, picked_y, slope).reshape(-1).to(y.dtype)
    return out.reshape(T, N, Ho, Wo, C), loads


def _leaky_masked(g, y, slope):
    """``leaky`` of csrc/act.cu in the gradient: g where y >= 0, else one
    IEEE multiply by the slope."""
    return torch.where(y >= 0, g, g * slope)


def _gather_inputs(T, N, H, W, C, dtype, seed):
    """y with exact ties and zeros of both signs (``_inputs``), its twin's
    argmax, and g_dy of both signs with zeros of both signs."""
    y, _ = _inputs(T, N, H, W, C, dtype, seed)
    _, arg = F.act_pool_fwd(y)
    rng = np.random.RandomState(seed + 1)
    g = rng.randn(T, N, H, W, C).astype(np.float32)
    g.reshape(-1)[5::11] = -0.0
    g.reshape(-1)[7::17] = 0.0
    return y, arg, torch.from_numpy(g).to(dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", EMULATED, ids=str)
def test_emulated_gather_equals_the_twin_bit_for_bit(shape, dtype):
    """The gather emulated with vectors (where C takes them) and a
    channel a thread: the twin's bits, zeros' signs included; every pooled
    element written; g_dy and y skipped at the taps no lane of a vector
    selects."""
    T, N, H, W, C = shape
    bf16 = dtype == "bf16"
    y, arg, g_dy = _gather_inputs(*shape, DTYPES[dtype], 2 * sum(shape))
    slope = F.scalar_like(F.LEAKY_SLOPE, y)
    want = F.act_pool_gather(g_dy, arg, y)
    for vec in (True, False):
        if vec and C % (8 if bf16 else 4):
            continue
        plan = cb.act_pool_plan(T, N, H, W, C, bf16, vec)
        got, loads = _emulated_gather(plan, g_dy, arg, y, slope)
        assert not torch.isnan(got).any()
        assert torch.equal(_bits(got), _bits(want))
        taps = 4 * arg.numel() // plan.items
        assert loads < taps if vec else loads == arg.numel()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(2, 3, 9, 7, 16), (2, 2, 6, 6, 48),
                                   (2, 2, 5, 5, 3)], ids=str)
def test_emulated_gather_equals_the_jax_second_derivative(shape, dtype):
    """The JAX package's second derivative through ``max_pool2d(
    leaky_relu(x), impl='reduce_window')`` per tenant: the ``jax.vjp`` of
    the pooled cotangent's ``jax.vjp``, at g_dy, on the CPU, against the
    emulated gather on the same y, argmax and g_dy: every value equal."""
    T, N, H, W, C = shape
    bf16 = dtype == "bf16"
    y, arg, g_dy = _gather_inputs(*shape, DTYPES[dtype], 5 * sum(shape))
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    jy = jnp.asarray(y.float().numpy()).astype(jdt)

    def act_pool(v):
        return JF.max_pool2d(JF.leaky_relu(v), impl="reduce_window")

    _, vjp = jax.vjp(jax.vmap(act_pool), jy)
    dp0 = jnp.zeros(tuple(arg.shape), jdt)
    _, vjp2 = jax.vjp(lambda dp: vjp(dp)[0], dp0)
    (jg,) = vjp2(jnp.asarray(g_dy.float().numpy()).astype(jdt))
    plan = cb.act_pool_plan(T, N, H, W, C, bf16, C % (8 if bf16 else 4) == 0)
    got, _ = _emulated_gather(plan, g_dy, arg, y,
                              F.scalar_like(F.LEAKY_SLOPE, y))
    assert torch.equal(got, _to_torch(jg, y.dtype))
