"""``layer_norm_fwd`` (csrc/layer_norm.cu) and ``act_fwd`` (csrc/act.cu), on
the CPU.

The forward's launch plan (``conv_block.ln_fwd_plan``) at every tensor the
layer-norm models of the seven shipped geometries normalize — the
mini-ImageNet conv-first outputs (84/42/21/10 x 48) and norm-first image
(84 x 84 x 3), the unpadded conv outputs (82/39/17/6 x 48), the Omniglot
pooled conv outputs (28/14/7/3 x 64) and image (28 x 28 x 1), the strided
Omniglot outputs (14/7/4/2 x 64) — at the images a task of its geometry
gives (mini-ImageNet 5, 25, 75; Omniglot 5, 20, 25, 100) and T = 1, 2, 4
and 8, in f32 and bf16, with and without 16-byte loads: a numpy model of
the kernel's index map covers every element of x and z once, reads a
(tenant, column) of gamma and beta once an image of its tenant, runs a
tenant's images in order, leaves no block without work, and keeps the
grid within its limit; the refusals. The packed arguments of both entries
at the places the ``.cu`` sources read them, and ``act_fwd``'s grid over
every element once. The kernel's arithmetic emulated in numpy — f32 the
twin's four ops each rounded, bf16 the chain with each op rounded to bf16
— equal to the twin (``ops/functional.py::layer_norm_fwd``) bit for bit.
Parity with the JAX package (run eagerly on the CPU): ``F.act_fwd``
against ``leaky_relu`` :363 (``jax.nn.leaky_relu``) bit for bit in f32 and
bf16; ``F.layer_norm_stats`` + ``F.layer_norm_fwd`` against ``layer_norm``
:447 bit for bit in bf16, and in f32 within 4e-6 * max(1, max |z|) (the
twin takes rstd as 1 / sqrt, the JAX package ``lax.rsqrt``: a few ulps of
rstd, carried through the affine).

The kernels themselves run only on the card
(``tests/test_torch_kernels_cuda.py``).
"""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu.ops import functional as JF
from howtotrainyourmamlpytorch_tpu_torch.kernels import conv_block as cb
from howtotrainyourmamlpytorch_tpu_torch.ops import functional as F

CSRC = pathlib.Path(cb.__file__).parent / "csrc"
# (H * W * C, the images a task gives) of every tensor a layer-norm model
# normalizes: mini-ImageNet (5-way 1- and 5-shot: 5 or 25 support, 75
# targets) and Omniglot (20- and 5-way, 1- and 5-shot: 5, 20, 25 or 100
# support, 5 or 20 targets)
MINI_N = (5, 25, 75)
OMNIGLOT_N = (5, 20, 25, 100)
MINI_M = tuple(hw * hw * 48 for hw in (84, 42, 21, 10)) + (84 * 84 * 3,) \
    + tuple(hw * hw * 48 for hw in (82, 39, 17, 6))
OMNIGLOT_M = tuple(hw * hw * 64 for hw in (28, 14, 7, 3, 4, 2)) \
    + (28 * 28 * 1,)
SHAPES = sorted({(M, n) for M in MINI_M for n in MINI_N}
                | {(M, n) for M in OMNIGLOT_M for n in OMNIGLOT_N})
TENANTS = (1, 2, 4, 8)
DTYPES = {"f32": False, "bf16": True}
f32 = np.float32


def _check_plan(T, N, M, bf16, vec):
    """The plan, and the kernel's index map as numpy: block b the tile b %
    tiles of image r = b // tiles, thread i its load vi = tile x threads +
    i of the image (live where vi < M / vec), reading x and z at r M + vi
    vec and gamma and beta at (r // N) M + vi vec."""
    plan = cb.ln_fwd_plan(T, N, M, bf16, vec)
    assert plan == cb.ln_fwd_plan(T, N, M, bf16, vec)  # pure
    v = (8 if bf16 else 4) if vec else 1
    assert plan.vec == v and M % v == 0
    assert plan.threads == cb.LN_THREADS == 256
    assert plan.grid == T * N * plan.tiles <= 2 ** 31 - 1
    vecs = M // v
    b = np.arange(plan.grid, dtype=np.int64)
    r = b // plan.tiles
    # the images in (tenant, image) order, each its `tiles` blocks: a
    # tenant's blocks run together
    assert (np.diff(r) >= 0).all()
    assert (np.bincount(r, minlength=T * N) == plan.tiles).all()
    # within an image, tile j's threads the loads j x threads + i: every
    # load once (so every element of x and z once), no tile without work
    vi = np.arange(plan.tiles)[:, None] * plan.threads \
        + np.arange(plan.threads)
    live = vi < vecs
    assert live.any(axis=1).all()
    assert np.array_equal(np.sort(vi[live]), np.arange(vecs))
    # gamma and beta: image r reads its tenant r // N's loads, so a
    # (tenant, load) once an image of its tenant
    assert (np.bincount(r // N, minlength=T) == N * plan.tiles).all()
    return plan


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_fwd_plan_covers_each_value_once_and_fits_the_card(shape, dtype):
    M, N = shape
    for T in TENANTS:
        for vec in (True, False):
            _check_plan(T, N, M, DTYPES[dtype], vec)


def test_fwd_plan_tiles_at_the_model_shapes():
    """The conv-first stage 0 at T = 8, N = 75: 331 tiles an image in f32
    (84,672 loads), 166 in bf16; the strided L4 map (2 x 2 x 64) one tile
    an image, 64 of its 256 threads live in f32."""
    big = cb.ln_fwd_plan(8, 75, 84 * 84 * 48, False, True)
    assert (big.tiles, big.grid) == (331, 8 * 75 * 331)
    assert cb.ln_fwd_plan(8, 75, 84 * 84 * 48, True, True).tiles == 166
    small = cb.ln_fwd_plan(8, 20, 256, False, True)
    assert (small.tiles, small.grid, small.vec) == (1, 160, 4)


def test_fwd_plan_refuses_what_the_kernel_does_not_take():
    for bad in ((0, 5, 256), (2, 0, 256), (2, 5, 0)):
        with pytest.raises(ValueError, match="no forward"):
            cb.ln_fwd_plan(*bad)
    with pytest.raises(ValueError, match="no forward"):
        cb.ln_fwd_plan(2, 5, 6, False, True)  # 6 values: no 16-byte loads
    with pytest.raises(ValueError, match="no forward"):
        cb.ln_fwd_plan(2, 5, 12, True, True)  # bf16 loads of 8 values
    assert cb.ln_fwd_plan(2, 5, 6, False, False).vec == 1
    with pytest.raises(ValueError, match="exceed the launch grid"):
        cb.ln_fwd_plan(2 ** 10, 100, 2 ** 26, False, True)


def _entry_body(src, name):
    """The text of extern "C" entry ``name`` of a .cu source."""
    start = src.index(f"int {name}(const long long* a")
    return src[start:src.index("\n}\n", start)]


def test_layer_norm_fwd_packs_its_arguments_where_the_entry_reads_them():
    """``conv_block._ln_fwd_packed`` puts each value at the index
    csrc/layer_norm.cu's ``layer_norm_fwd`` reads it from."""
    body = _entry_body((CSRC / "layer_norm.cu").read_text(),
                       "layer_norm_fwd")
    where = {}
    for name in ("T", "N", "M", "bf16", "vec", "tiles"):
        where[name] = int(re.search(
            rf"\b{name} = \(int\)a\[(\d+)\]", body).group(1))
    where["grid"] = int(re.search(r"grid = a\[(\d+)\]", body).group(1))
    where["device"] = int(re.search(r"OnDevice on\(\(int\)a\[(\d+)\]\)",
                                    body).group(1))
    where["stream"] = int(re.search(r"ptr<CUstream_st>\(a\[(\d+)\]\)",
                                    body).group(1))
    ptrs = [int(k) for k in re.findall(r"ptr<(?:const )?void>\(a\[(\d+)\]\)",
                                       body.split("FwdArgs f =")[1])]
    assert ptrs == list(range(6))  # x, mean, rstd, gamma, beta, z
    plan = cb.ln_fwd_plan(8, 20, 2304, True, True)
    got = list(cb._ln_fwd_packed((101, 102, 103, 104, 105, 106), 8, 20, 2304,
                                 True, True, plan, 3, 77))
    assert got[:6] == [101, 102, 103, 104, 105, 106]
    want = dict(T=8, N=20, M=2304, bf16=1, vec=1, tiles=plan.tiles,
                grid=plan.grid, device=3, stream=77)
    assert {k: got[i] for k, i in where.items()} == want
    assert len(got) == 1 + max(where.values())


@pytest.mark.parametrize("entry,n_ptrs", [("act_fwd", 2), ("act_bwd", 3)])
def test_act_entries_read_the_packed_arguments_where_they_are_put(entry,
                                                                  n_ptrs):
    """``conv_block._act_packed`` puts the pointers, n, bf16, vec, the
    blocks, the device and the stream at the indices csrc/act.cu's entry
    reads them from."""
    body = _entry_body((CSRC / "act.cu").read_text(), entry)
    ptrs = [int(k) for k in re.findall(
        r"maml::ptr<(?:const )?void>\(a\[(\d+)\]\)", body)]
    assert ptrs == list(range(n_ptrs))
    n = int(re.search(r"\),\s*a\[(\d+)\],\s*slope\}", body).group(1))
    rest = re.search(r"launch<(?:true|false)>\(args, \(int\)a\[(\d+)\], "
                     r"\(int\)a\[(\d+)\], a\[(\d+)\], \(int\)a\[(\d+)\], "
                     r"a\[(\d+)\]\)", body).groups()
    bf16, vec, blocks, device, stream = (int(k) for k in rest)
    got = list(cb._act_packed(tuple(range(201, 201 + n_ptrs)), 1000, True,
                              False, 5, 99))
    assert got[:n_ptrs] == list(range(201, 201 + n_ptrs))
    assert (got[n], got[bf16], got[vec], got[blocks], got[device],
            got[stream]) == (1000, 1, 0, cb.act_blocks(1000, True, False), 5,
                             99)
    assert len(got) == n_ptrs + 6


# element counts of act_fwd: the strided norm-first conv outputs (T = 8,
# N = 20, 14/7/4/2 x 64), and tails of every length past the last vector
ACT_SIZES = ([8 * 20 * hw * hw * 64 for hw in (14, 7, 4, 2)]
             + [1, 3, 4, 5, 7, 8, 9, 15, 17, 255, 1023, 1024, 1025, 8191,
                2 * 256 * 8 + 3])


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_act_grid_takes_every_element_once(dtype):
    """The kernel's map from (block, thread) to elements, in numpy: a
    thread its 16 bytes where they lie wholly inside the tensor, else the
    rest of them one at a time (or one element without vectors); every
    element once, no block without a live thread."""
    bf16 = DTYPES[dtype]
    for n in ACT_SIZES:
        for vec in (True, False):
            v = (8 if bf16 else 4) if vec else 1
            blocks = cb.act_blocks(n, bf16, vec)
            e0 = np.arange(blocks * cb.ACT_THREADS, dtype=np.int64) * v
            assert e0[-cb.ACT_THREADS] < n  # the last block has work
            e0 = e0[e0 < n]
            take = np.minimum(v, n - e0)
            counts = np.zeros(n, np.int64)
            for i in range(v):
                np.add.at(counts, e0[take > i] + i, 1)
            assert (counts == 1).all()


def _bf16(a):
    """f32 values rounded to the nearest bf16 (ties to even), as f32."""
    b = np.asarray(a, f32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(f32)


def _emulated_fwd(x, mean, rstd, gamma, beta, bf16):
    """The kernel's arithmetic on one (T, N, M) layout: f32 the four ops
    each rounded (no FMA), bf16 each op rounded to bf16 (the chain of
    bn_act_chain.cuh at slope 1)."""
    m, r = mean[:, :, None], rstd[:, :, None]
    g, b = gamma[:, None, :], beta[:, None, :]
    rnd = _bf16 if bf16 else (lambda v: v)
    z = rnd((x - m).astype(f32))
    z = rnd((z * r).astype(f32))
    z = rnd((z * g).astype(f32))
    return rnd((z + b).astype(f32))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(2, 5, 6, 6, 64), (3, 4, 7, 5, 3),
                                   (1, 3, 28, 28, 1)], ids=str)
def test_emulated_fwd_equals_the_twin_bit_for_bit(shape, dtype):
    T, N, H, W, C = shape
    tdt = torch.bfloat16 if DTYPES[dtype] else torch.float32
    rng = np.random.RandomState(sum(shape))
    x = torch.from_numpy((2.0 + 3.0 * rng.randn(*shape)).astype(f32)).to(tdt)
    gamma = torch.from_numpy(
        (1.0 + 0.3 * rng.randn(T, H, W, C)).astype(f32)).to(tdt)
    beta = torch.from_numpy((0.2 * rng.randn(T, H, W, C)).astype(f32)).to(tdt)
    mean, _, rstd = F.layer_norm_stats(x)
    want = F.layer_norm_fwd(x, mean, rstd, gamma, beta)
    M = H * W * C
    got = _emulated_fwd(*(t.float().numpy().reshape(s) for t, s in (
        (x, (T, N, M)), (mean, (T, N)), (rstd, (T, N)), (gamma, (T, M)),
        (beta, (T, M)))), DTYPES[dtype])
    assert np.array_equal(got.reshape(shape), want.float().numpy())


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_act_fwd_twin_equals_the_jax_leaky_relu_bit_for_bit(dtype):
    """``F.act_fwd`` (csrc/act.cu's forward twin, which the kernel equals
    bit for bit on the card) against the JAX package's ``leaky_relu`` and
    ``jax.nn.leaky_relu`` in the same dtype, zeros of both signs included:
    equal, every value."""
    rng = np.random.RandomState(5)
    y = rng.randn(2, 5, 7, 7, 64).astype(f32)
    y.reshape(-1)[::7] = 0.0
    y.reshape(-1)[3::11] = -0.0
    ty = torch.from_numpy(y).to(getattr(torch, dtype))
    jy = jnp.asarray(ty.float().numpy()).astype(dtype)
    got = F.act_fwd(ty)
    assert got.dtype == ty.dtype
    for want in (JF.leaky_relu(jy, F.LEAKY_SLOPE),
                 jax.nn.leaky_relu(jy, negative_slope=F.LEAKY_SLOPE)):
        want = np.asarray(want.astype(jnp.float32))
        assert np.array_equal(got.float().numpy().view(np.uint32),
                              want.view(np.uint32))


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("shape", [(2, 3, 5, 5, 8), (2, 4, 6, 6, 64),
                                   (1, 5, 12, 12, 3)], ids=str)
def test_layer_norm_twins_equal_the_jax_layer_norm(shape, dtype):
    """``F.layer_norm_stats`` + ``F.layer_norm_fwd`` (the kernels' twins)
    against the JAX package's ``layer_norm`` per tenant in the same dtype,
    with per-tenant gamma and beta: bf16 bit for bit; f32 within 4e-6 *
    max(1, max |z|)."""
    T, N, H, W, C = shape
    rng = np.random.RandomState(sum(shape))
    x = (1.5 + rng.randn(*shape)).astype(f32)
    gamma = (1.0 + 0.2 * rng.randn(T, H, W, C)).astype(f32)
    beta = (0.1 * rng.randn(T, H, W, C)).astype(f32)
    tdt = getattr(torch, dtype)
    tx, tg, tb = (torch.from_numpy(v).to(tdt) for v in (x, gamma, beta))
    mean, _, rstd = F.layer_norm_stats(tx)
    got = F.layer_norm_fwd(tx, mean, rstd, tg, tb).float().numpy()
    for t in range(T):
        want = np.asarray(JF.layer_norm(
            *(jnp.asarray(v.float().numpy()).astype(dtype)
              for v in (tx[t], tg[t], tb[t]))).astype(jnp.float32))
        if dtype == "bfloat16":
            assert np.array_equal(got[t], want)
        else:
            err = np.abs(got[t] - want).max()
            assert err <= 4e-6 * max(1.0, np.abs(want).max()), err
