"""Wrappers of the port's kernels, their launch counters, and the
``autograd.Function``s that join them into the model's blocks,
differentiable twice: conv -> batch-norm -> leaky-ReLU -> (2x2 max pool |
nothing) -> (global average pool), the norm-first block
(``block_order='norm_conv_relu'``), batch-norm of the input -> conv ->
leaky-ReLU -> (2x2 max pool | nothing) -> (global average pool), and the
same two orders with a layer norm over each image's (H, W, C) in place of
the batch norm (``norm_layer='layer_norm'``).

==========================  ======  ========================  ==================
kernel                      route   source                    launches/call
==========================  ======  ========================  ==================
``conv3x3_fwd_stats``       CUDA    csrc/conv3x3_fwd_s1.cu    conv + merge: 2
``conv3x3_fwd``             CUDA    csrc/conv3x3_fwd_s1.cu    1 (stats-free)
``bn_act_pool_fwd``         CUDA    csrc/bn_act_fwd.cu        1
``bn_act_pool_bwd``         CUDA    csrc/bn_act_pool_bwd.cu   1 (cooperative)
``conv3x3_dgrad``           CUDA    csrc/conv3x3_bwd_s1.cu    1
``conv3x3_wgrad``           CUDA    csrc/conv3x3_bwd_s1.cu    wgrad + reduce: 2
``bn_act_pool_bwd_bwd``     CUDA    csrc/bn_act_pool_bwd.cu   1 (cooperative)
``conv3x3_s2_*``            CUDA    K1, dgrad: csrc/          as at stride 1
                                    conv3x3_s2.cu; wgrad:
                                    csrc/conv3x3_wgrad_s2.cu
``conv3x3_p0_*``            CUDA    the same sources          as at pad 1
``conv3x3_s2_p0_*``         CUDA    the same sources          as at pad 1
``bn_act_fwd``              CUDA    csrc/bn_act_fwd.cu        1 (pool-free)
``bn_act_bwd``              CUDA    csrc/bn_act_bwd.cu        1 (pool-free; a
                                                              block a tenant,
                                                              or cooperative)
``bn_act_bwd_bwd``          CUDA    csrc/bn_act_bwd.cu        1 (pool-free; a
                                                              block a tenant,
                                                              or cooperative)
``global_avg_pool2d_fwd``   CUDA    csrc/global_avg_pool.cu   1
``global_avg_pool2d_bwd``   CUDA    csrc/global_avg_pool.cu   1
``bn_input_stats``          CUDA    csrc/bn_input_stats.cu    1 (a block a
                                                              tenant, or
                                                              cooperative)
``batch_norm_fwd``          CUDA    csrc/bn_act_fwd.cu        1 (slope 1)
``batch_norm_bwd``          CUDA    csrc/bn_act_bwd.cu        1 (slope 1)
``batch_norm_bwd_bwd``      CUDA    csrc/bn_act_bwd.cu        1 (slope 1)
``act_pool_fwd``            CUDA    csrc/act.cu               1
``act_pool_bwd``            CUDA    csrc/act.cu               1
``act_pool_gather``         CUDA    csrc/act.cu               1
``act_fwd``                 CUDA    csrc/act.cu               1 (pool-free)
``act_bwd``                 CUDA    csrc/act.cu               1 (pool-free)
``layer_norm_stats``        CUDA    csrc/layer_norm.cu        1 (a warp or a
                                                              cluster a row)
``layer_norm_fwd``          CUDA    csrc/layer_norm.cu        1
``layer_norm_bwd``          CUDA    csrc/layer_norm.cu        1 (cooperative)
``layer_norm_bwd_bwd``      CUDA    csrc/layer_norm.cu        1 (cooperative)
``*_bf16``                  as f32  K1, dgrad at stride 1:    as in f32
                                    csrc/conv3x3_s1_bf16.cu;
                                    wgrad at stride 1: csrc/
                                    conv3x3_wgrad_s1_bf16.cu;
                                    K1, dgrad at stride 2:
                                    conv3x3_s2.cu; wgrad at
                                    stride 2:
                                    conv3x3_wgrad_s2.cu;
                                    K2: bn_act_fwd.cu;
                                    K3 and K5 pooled:
                                    bn_act_pool_bwd.cu
==========================  ======  ========================  ==================

K1 (both modes) and K4 dgrad stage a band of rows with its halo in
shared memory once and multiply on FFMA in f32, on the tensor cores in
bf16 (``mma.sync``, f32 sums): at stride 1 the band kernels of
``csrc/conv3x3_fwd_s1.cu`` and ``csrc/conv3x3_bwd_s1.cu`` (f32) and
``csrc/conv3x3_s1_bf16.cu`` (bf16); at stride 2 those of
``csrc/conv3x3_s2.cu`` in both dtypes (K1 on the input split into even and
odd column planes, dgrad by the four parity classes of
``s2_dgrad_taps``, each with only its live taps). K4 wgrad runs the f32
band kernel of ``csrc/conv3x3_bwd_s1.cu`` and the bf16 tensor-core kernel
of ``csrc/conv3x3_wgrad_s1_bf16.cu`` at stride 1, and the same two designs
at stride 2 in ``csrc/conv3x3_wgrad_s2.cu`` (the source's pixel stride
doubled; in bf16 the source rows as even and odd column planes), each
then its reduce. ``fwd_plan``, ``dgrad_plan`` (through ``mma_plan`` in
bf16 at stride 1, ``s2_mma_plan`` in bf16 at stride 2) and ``wgrad_plan``
give each launch (grid, bands, splits, shared memory, scratch) as a pure
function of the shape.
K3 and K5 pooled run the cooperative kernels of
``csrc/bn_act_pool_bwd.cu`` in both dtypes (reduce, grid barrier, merge,
barrier, apply in one launch, on the grid ``bn_bwd_plan`` sizes from the
occupancy query). K3 and K5 pool-free run ``csrc/bn_act_bwd.cu`` in
both dtypes, one launch a call (``bn_act_bwd_plan`` and
``bn_act_bwd_bwd_plan``: ``bn_input_stats``' units and routes, a block a
tenant at the small maps, else one cooperative launch, whose blocks keep
their chunks of the inputs in shared memory where they fit; K5 sums five
per-channel sums and reads its coefficients from a table in shared
memory), and
``act_fwd`` / ``act_bwd`` ``csrc/act.cu``, 16 bytes of the flat tensor a
thread. ``act_pool_fwd`` / ``act_pool_bwd`` run the same source's pooled
kernels in both dtypes, one launch a call (``act_pool_plan``: a thread a
2x2 window x 16 bytes of channels; the backward's grid takes the dropped
odd row and column too, and reads y at a tap only where a lane of its
vector routes its gradient there); ``act_pool_gather`` runs the same
source's kernel on the forward's mapping (g_dy and y read only at the
taps a lane of its vector selects). K2 runs ``csrc/bn_act_fwd.cu`` in
both modes and both dtypes (one kernel each, templated on the element type;
``bn_fwd_plan`` gives its launch): pooled a thread a pooled pixel x 4
channels, pool-free 16 bytes of the flat tensor a thread. The layer
norm's statistics, forward, backward and double backward run
``csrc/layer_norm.cu`` in both dtypes, one launch a call:
``layer_norm_stats`` a warp a row at the small maps and a thread block
cluster a row above (``ln_stats_plan``), ``layer_norm_fwd`` a block a
tile of one image, gamma and beta shared by a tenant's images in L2
(``ln_fwd_plan``), ``layer_norm_bwd`` and ``layer_norm_bwd_bwd`` one
cooperative launch each over (tenant, column tile) items
(``ln_bwd_plan``, sized from each kernel's occupancy query; two row sums
and seven).
``bn_input_stats`` runs ``csrc/bn_input_stats.cu`` in both dtypes, one
launch a call (``bn_stats_plan``: a block a tenant at the small maps, else
one cooperative launch of a few blocks a tenant, their partials merged
after a grid barrier); the global average pool and its backward run
``csrc/global_avg_pool.cu``, a plain launch each.

The ``conv3x3_s2_*`` names are the four conv kernels at stride 2 (the
strided model, ``max_pooling=False``), counted apart from stride 1, and
the ``conv3x3_p0_*`` / ``conv3x3_s2_p0_*`` names the same kernels at pad
0 (the unpadded models, ``conv_padding=False``), counted apart from pad
1; the ``bn_act_*`` names are K2, K3 and K5 without the pool. The
``batch_norm_*`` names are the same pool-free K2, K3 and K5 at
``negative_slope = 1.0`` (``z * 1.0 == z`` in f32, so the leaky-ReLU is
the identity and they compute batch norm, its backward through the batch
statistics and its double backward): the norm-first block's standalone
batch norm, counted apart from the activation use.

Each wrapper takes its plain twin (``ops.functional``) for a tensor on the
CPU, and for a CUDA tensor launches its kernel or raises: it checks
device, dtype, shape, stride and contiguity, launches on the current
stream, allocates outputs and scratch with ``torch.empty`` and adds one to
its counter per call that launched. The f32 kernels multiply on FFMA
only (no TF32); the bf16 convs multiply bf16 on the tensor cores and sum
in f32, as XLA's bf16 conv does.

bf16 (``compute_dtype='bfloat16'``): every kernel of every model, served
and trained second order — K1 with statistics and stats-free, K2, K3 and
K5 pooled and pool-free, K4 dgrad and wgrad, the convs at stride 1 or 2
and pad 1 or 0, the global average pool, the norm-first block's
``bn_input_stats`` and ``batch_norm_*``, the act-pool kernels and the
layer norm's four — takes bf16 tensors (``BF16_KERNELS``), counted on
``<name>_bf16``; they load bf16, compute in f32 and store bf16 in the JAX
package's cast points (each kernel's source says where it rounds), with
f32 scratch. Any other dtype raises ``TypeError`` at the wrapper
(``kernel_dtype``), and a block raises before its first launch
(``_check_block_input``): no bf16 path falls back to f32. Every model
therefore runs in bf16 on the card: batch norm or layer norm, conv first
or norm first, pooled or strided, padded or not.

All tensors carry the tenant axis: activations ``(T, N, H, W, C)``
(NHWC), weights ``(T, 3, 3, cin, cout)`` (HWIO), per-channel tensors
``(T, C)``, pooled features ``(T, N, C)``.

The Functions (forward -> backward; every backward is built from further
Functions, so the block's first gradient can be differentiated again, as
second-order MAML does):

* ``Conv3x3``: K1 (with statistics, or stats-free) -> ``Dgrad`` for x,
  ``Wgrad`` for w and b;
* ``Dgrad``: K4 dgrad -> ``Conv3x3`` stats-free for dy, ``Wgrad`` for w;
* ``Wgrad``: K4 wgrad -> ``Conv3x3`` stats-free with bias for dy,
  ``Dgrad`` for x. The three convs are bilinear, so they are closed under
  differentiation, at either stride and pad (each carries both);
* ``BnActPool``: K2 -> ``BnActPoolBwd``, pooled or pool-free;
* ``BnActPoolBwd``: K3 -> K5, pooled or pool-free;
* ``Gap``: the GAP forward -> ``GapBwd``; ``GapBwd``: the GAP backward ->
  ``Gap``. Both are linear, so every derivative order closes;
* ``BatchNorm``: ``bn_input_stats`` + ``batch_norm_fwd`` ->
  ``BatchNormBwd`` (``batch_norm_bwd``) -> ``batch_norm_bwd_bwd``;
* ``ActPool``: ``act_pool_fwd`` (or ``act_fwd``) -> ``ActPoolBwd``
  (``act_pool_bwd`` / ``act_bwd``) -> ``ActPoolGather``
  (``act_pool_gather``; pool-free, ``ActPoolBwd`` itself) -> ``ActPoolBwd``.
  Linear in the cotangent, so every order closes; the derivative in y is
  zero almost everywhere (the argmax and the sign are piecewise
  constant);
* ``LayerNorm``: ``layer_norm_stats`` + ``layer_norm_fwd`` ->
  ``LayerNormBwd`` (``layer_norm_bwd``) -> ``layer_norm_bwd_bwd``. The
  layer-norm blocks are K1 stats-free with bias -> ``LayerNorm`` ->
  ``ActPool`` (conv first) and ``LayerNorm`` -> K1 stats-free ->
  ``ActPool`` (norm first), with ``Gap`` in the strided model's last
  block.

K5's own derivative (the block's third) is taken by no path: on the card
asking for it raises; on the CPU the twin's formulas are plain ops that
autograd differentiates, which the f64 ``gradgradcheck`` of
``BnActPoolBwd``, ``BatchNormBwd`` and ``LayerNormBwd`` uses; the same
holds for ``layer_norm_bwd_bwd``.
"""

from __future__ import annotations

import array
import contextlib
import ctypes
import functools
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..ops import functional as F
from . import build

Tensor = torch.Tensor

KERNELS = (
    "conv3x3_fwd_stats",
    "bn_act_pool_fwd",
    "bn_act_pool_bwd",
    "conv3x3_dgrad",
    "conv3x3_wgrad",
    "conv3x3_fwd",
    "bn_act_pool_bwd_bwd",
    "conv3x3_s2_fwd_stats",
    "bn_act_fwd",
    "bn_act_bwd",
    "conv3x3_s2_dgrad",
    "conv3x3_s2_wgrad",
    "conv3x3_s2_fwd",
    "bn_act_bwd_bwd",
    "global_avg_pool2d_fwd",
    "global_avg_pool2d_bwd",
    "bn_input_stats",
    "batch_norm_fwd",
    "batch_norm_bwd",
    "batch_norm_bwd_bwd",
    "act_pool_fwd",
    "act_pool_bwd",
    "act_pool_gather",
    "act_fwd",
    "act_bwd",
    "layer_norm_stats",
    "layer_norm_fwd",
    "layer_norm_bwd",
    "layer_norm_bwd_bwd",
    "conv3x3_p0_fwd_stats",
    "conv3x3_p0_dgrad",
    "conv3x3_p0_wgrad",
    "conv3x3_p0_fwd",
    "conv3x3_s2_p0_fwd_stats",
    "conv3x3_s2_p0_dgrad",
    "conv3x3_s2_p0_wgrad",
    "conv3x3_s2_p0_fwd",
)
#: the kernels with a bf16 instantiation, counted on ``<name>_bf16``: every
#: kernel, of every model that serving and second-order training run
BF16_KERNELS = KERNELS
KERNELS += tuple(f"{name}_bf16" for name in BF16_KERNELS)
#: the conv strides and pads the kernels take
STRIDES = (1, 2)
PADDINGS = (1, 0)

#: launches per kernel since the last ``reset_launches()`` (CUDA only)
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}

#: K1 and K4 dgrad in bf16 at stride 1 (csrc/conv3x3_s1_bf16.cu, mma.sync):
#: most threads a block (8 warps of 32 band pixels each: two blocks a SM
#: within 128 registers a thread), the shared memory a block may take where
#: a band of one row allows (two blocks fit a SM's 228 KB, 1 KB reserved
#: each), the most output channels a block (more: chunks on grid.y), the
#: n8 tiles a warp may hold, a SM's shared memory and the blocks a SM the
#: plan sizes its grid for
MMA_MAX_THREADS = 256
MMA_WARP_PIXELS = 32
MMA_SMEM_BYTES = 113 * 1024
MMA_MAX_CHANNELS = 64
MMA_TILES = (1, 2, 4, 6, 8)
#: the stride-2 mma kernel: the most bytes of a tenant's weights a block
#: stages; above (64 x 64 channels, Omniglot's layers 2-4) a block takes
#: 32 output channels, twice the blocks with half the weights each (a
#: block of one warp staging all 74 KB ran slower; at 48 channels the
#: chunks did)
S2_MMA_WEIGHT_BYTES = 64 * 1024
S2_MMA_CHUNK = 32
SM_SMEM = 228 * 1024
MMA_BLOCKS_PER_SM = 2
#: K4 wgrad in bf16 at stride 1 (csrc/conv3x3_wgrad_s1_bf16.cu, mma.sync):
#: a warp a tap (9 warps), or 8 warps over the packed kernel's k16 steps
#: (cin <= 3); the most m16 x n8 accumulator tiles a warp holds (72 f32 a
#: thread), the most m16 tiles of source channels, and the tiles a warp
#: from which the taps kernel runs one block a SM (its ``__launch_bounds__``:
#: two blocks of 288 threads, five warps on some SM sub-partition, leave 96
#: registers a thread, too few for 64 accumulators and the fragments)
WGRAD_MMA_TAP_WARPS = 9
WGRAD_MMA_PACKED_WARPS = 8
WGRAD_MMA_TILES = 18
WGRAD_MMA_MAX_MT = 4
WGRAD_MMA_ONE_BLOCK_TILES = 16
#: the bands a wgrad mma block (and an f32 stride-2 band block) walks at
#: most where the splits' partials would otherwise outweigh x and dy (the
#: small maps: a band there is a few k16 steps, and a longer walk is a
#: chain of staging latencies)
WGRAD_MMA_BANDS = 4
#: the K1 band kernels (csrc/conv3x3_fwd_s1.cu, f32 at stride 1): most
#: threads a block (8 warps: two blocks a SM within 128 registers a
#: thread), the shared memory a block's band and weight ring may take (two
#: blocks a SM), the band pixels past its last row that a last run reads,
#: and the threads a SM below which a thread takes 4 channels, not 8
FWD_MAX_THREADS = 256
FWD_SMEM_BYTES = 100 * 1024
FWD_SLACK = 8
FWD_FILL_THREADS = 256
#: the K4 band kernels (csrc/conv3x3_bwd_s1.cu, f32 at stride 1): most
#: threads a block — for wgrad the FFMA threads, beside its db warp: 8
#: warps, two blocks a SM within 128 registers a thread (a SM
#: sub-partition's 16K registers); for dgrad 4 warps, one warp a
#: sub-partition, so that shared memory sets its blocks a SM — and the
#: dynamic shared memory a block may take on sm_90
WGRAD_MAX_THREADS = 224
DGRAD_MAX_THREADS = 128
BAND_LAUNCH_BOUND = 256  # their ``__launch_bounds__``: no block is larger
BLOCK_SMEM = 232448
#: the bytes a wgrad block's two-band ring and a dgrad block's band and
#: weight ring may take: three blocks fit a SM's 228 KB
WGRAD_RING_BYTES = 75 * 1024
DGRAD_SMEM_BYTES = 75 * 1024
#: a wgrad band's pixels, as rows of the output allow
WGRAD_BAND_PIXELS = 128
#: blocks a SM the band kernels' plans give the card (where the shape has
#: that many bands)
BAND_BLOCKS_PER_SM = 2

#: K3 and K5 pooled in both dtypes (csrc/bn_act_pool_bwd.cu, one
#: cooperative launch a call): a block's threads (``kThreads`` there), the
#: most channels they take, the partial sums a (tenant, channel) of each,
#: and the channels of a thread's group by (kernel, bf16): one load, 16
#: bytes (4 f32, or ``kV16`` = 8 bf16 in K3) or 8 (4 bf16 in K5, whose 5
#: sums of 8 channels would not fit the register budget)
BN_BWD_THREADS = 256
BN_BWD_MAX_C = 64
BN_BWD_SUMS = {"bn_act_pool_bwd": 2, "bn_act_pool_bwd_bwd": 5}
BN_BWD_GROUP = {("bn_act_pool_bwd", False): 4, ("bn_act_pool_bwd", True): 8,
                ("bn_act_pool_bwd_bwd", False): 4,
                ("bn_act_pool_bwd_bwd", True): 4}
#: K2 in both modes and dtypes (csrc/bn_act_fwd.cu): a block's threads
#: (``kThreads`` there) and the most channels it takes
BN_FWD_THREADS = 256
BN_FWD_MAX_C = 64
#: the layer norm's kernels (csrc/layer_norm.cu, one launch a call each): a
#: block's threads (``kThreads`` there), the most loads of a row that one
#: warp takes (``kWarpRowVecs``), the rows of such a block, the largest
#: cluster a row (``kMaxCluster``), the row sums of the backward and of the
#: double backward (``kSums``) and the double backward's coefficients a row
#: (``kCoefs``)
LN_THREADS = 256
LN_WARP_ROW_VECS = 256
LN_WARP_ROWS = 8
LN_MAX_CLUSTER = 8
LN_BWD_SUMS = 2
LN_BWD_BWD_SUMS = 7
LN_BWD_BWD_COEFS = 8
#: bn_input_stats (csrc/bn_input_stats.cu, one launch a call): a block's
#: threads (``kThreads`` there), the most channels it takes, the loads a
#: thread of one block a tenant at and under which a tenant takes the
#: block route, the loads a thread of two waves from which the grid route
#: takes two (on an H100 each faster there, PERF.md §6), the modes in the
#: occupancy entry's order (``Mode`` there), and the units a thread folds
#: a group (one merge) by the loads a unit (``G`` there: 8 of one load, 4
#: of the three loads at C = 3)
BN_STATS_THREADS = 256
BN_STATS_MAX_C = 256
BN_STATS_BLOCK_LOADS = 20
BN_STATS_WAVE_LOADS = 16
BN_STATS_MODES = ("scalar", "lanes", "packed1", "packed3")
BN_STATS_GROUP = {1: 8, 3: 4}
#: K3 pool-free (csrc/bn_act_bwd.cu, one launch a call, the layout of
#: bn_input_stats): a block's threads, the most channels, the loads a
#: thread of one block a tenant at and under which a tenant takes the
#: block route, the loads a thread of two waves from which the grid route
#: takes two, and the units a thread loads at a time by the loads a unit
#: (``G`` there: 4 of da's and y's one load, 2 of their three at C = 3)
BN_ACT_BWD_THREADS = 256
BN_ACT_BWD_MAX_C = 256
BN_ACT_BWD_BLOCK_LOADS = 20
BN_ACT_BWD_WAVE_LOADS = 16
BN_ACT_BWD_GROUP = {1: 4, 3: 2}
#: the most dynamic shared memory a pool-free K3 block keeps its chunk of
#: da and y in between the reduce and the apply (the grid route in one
#: wave; with the static arrays within a block's 227 KB)
BN_ACT_BWD_STAGE_BYTES = 200 * 1024
#: K5 pool-free (csrc/bn_act_bwd.cu, K3's layout, threads and channels):
#: the loads a thread of one block a tenant at and under which a tenant
#: takes the block route (a block reduces and applies three tensors with
#: five sums, so K5 leaves it sooner than K3: on an H100 the strided L3
#: map, 20 loads a thread, took 0.0149 ms by device time on the block
#: route and 0.0085 on the grid route, PERF.md §6), the units a thread
#: loads at a time by the loads a unit (``G5`` there: 2 of a's, da's and
#: y's one load, 1 of their three at C = 3), its per-channel sums and
#: table rows (``kSums5``, ``kCoefs5``), and the most dynamic shared memory
#: a block keeps its chunk of a, da and y in (with the static arrays, 21
#: KB at most, within a block's 227 KB)
BN_ACT_BWD_BWD_BLOCK_LOADS = 6
BN_ACT_BWD_BWD_GROUP = {1: 2, 3: 1}
BN_ACT_BWD_BWD_SUMS = 5
BN_ACT_BWD_BWD_COEFS = 13
BN_ACT_BWD_BWD_STAGE_BYTES = 201 * 1024
#: act_fwd and act_bwd (csrc/act.cu): a block's threads
ACT_THREADS = 256

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def reset_launches() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


def launches() -> Dict[str, int]:
    return dict(LAUNCHES)


def _on_cpu(x: Tensor) -> bool:
    return x.device.type == "cpu"


def kernel_dtype(name: str, x: Tensor) -> torch.dtype:
    """The dtype kernel ``name`` (a counter name: ``conv3x3_s2_dgrad`` is
    the stride-2 dgrad) runs in for the activation ``x``: float32, or
    bfloat16 (every kernel has both, ``BF16_KERNELS``). Raises
    ``TypeError`` for any other dtype."""
    if x.dtype in (torch.float32, torch.bfloat16):
        return x.dtype
    raise TypeError(f"{name}: the kernels take float32 or bfloat16, got "
                    f"{x.dtype}")


def _counter(name: str, x: Tensor) -> str:
    """The launch counter of kernel ``name`` on ``x``'s dtype."""
    return f"{name}_bf16" if x.dtype == torch.bfloat16 else name


def _check(name: str, what: str, t: Tensor, shape, device,
           dtype: torch.dtype = torch.float32) -> None:
    if t.device != device:
        raise ValueError(f"{name}: {what} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: {what} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name}: {what} must have shape {tuple(shape)}, got "
            f"{tuple(t.shape)}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name}: {what} must be contiguous")


def _check_act(name: str, x: Tensor) -> Tuple[int, int, int, int, int]:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {x.device}")
    if x.dim() != 5:
        raise ValueError(
            f"{name}: expected a (T, N, H, W, C) activation, got "
            f"{tuple(x.shape)}"
        )
    _check(name, "the activation", x, x.shape, x.device,
           kernel_dtype(name, x))
    if math.prod(x.shape[1:]) >= 2 ** 31:
        raise ValueError(f"{name}: one tenant's activation must hold fewer "
                         "than 2**31 elements (32-bit offsets)")
    return tuple(x.shape)


def _ptr(t: Tensor) -> int:
    return t.data_ptr()


def _stream(device) -> int:
    """PyTorch's current stream on ``device``, as the kernels take it: the
    raw handle (``torch.cuda.current_stream`` builds a Stream object, ~5 us
    of host time a call on the H100's host, PERF.md §6)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def _device(device):
    """A context that makes ``device`` current: none where it already is
    (the K1 wrappers' host time, where a small conv is host-bound)."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


#: the dtypes every kernel takes (``kernel_dtype``)
_DTYPES = (torch.float32, torch.bfloat16)


def _check_flat(name: str, x: Tensor) -> Tuple[int, int, int, int, int]:
    """Check an activation a kernel reads as each tenant's flat run of
    values; returns its shape. An activation the kernels take passes in a
    few host operations (a call's host time counts at the small maps); any
    other gets ``_check_act``'s error."""
    if (x.dtype not in _DTYPES or x.dim() != 5 or not x.is_contiguous()
            or x.device.type != "cuda"
            or x.numel() >= x.shape[0] << 31):
        _check_act(name, x)
    return tuple(x.shape)


#: the entries of csrc/layer_norm.cu (but its forward) and
#: csrc/bn_input_stats.cu take their arguments packed as 64-bit integers,
#: in one ctypes argument (a call's host time counts at the small maps),
#: and one float; those of csrc/global_avg_pool.cu the packed integers
#: alone; csrc/act.cu's, csrc/bn_act_bwd.cu's, ``layer_norm_fwd`` and the
#: four wgrad kernels' the packed integers by address (``_packed``) and
#: none, one or two floats
_PACKED_EPS_ENTRY = (ctypes.POINTER(ctypes.c_longlong), _F)
_PACKED_ENTRY = (ctypes.POINTER(ctypes.c_longlong),)
_ADDR_ENTRY = (_P,)
_ADDR_F_ENTRY = (_P, _F)
_ADDR_2F_ENTRY = (_P, _F, _F)


def _packed(*values: int) -> array.array:
    """64-bit integers packed for an entry that takes them by address
    (``.buffer_info()[0]``, the array alive for the call): an
    ``array.array`` builds in about a third of a ctypes array's host
    time."""
    return array.array("q", values)

#: f32 scratch of the one-launch kernels (layer_norm_bwd, bn_input_stats,
#: the pool-free K3 and K5), one buffer a (device, stream), grown as needed: a
#: launch writes every value of it that it reads before reading it, and
#: the launches on one stream run in order
_SCRATCH: Dict[Tuple[int, int], Tensor] = {}


def _scratch(device, stream: int, n: int) -> Tensor:
    key = (device.index, stream)
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < n:
        buf = _SCRATCH[key] = torch.empty(n, device=device)
    return buf


def _conv_name(name: str, stride: int, padding: int = 1) -> str:
    """The counter of conv kernel ``name`` at ``stride`` and ``padding``:
    its own name at stride 1 and pad 1, ``conv3x3_s2_*`` at stride 2,
    ``conv3x3_p0_*`` / ``conv3x3_s2_p0_*`` at pad 0; raises for a stride
    or a pad the kernels do not take."""
    if stride not in STRIDES or padding not in PADDINGS:
        raise ValueError(f"{name}: the conv kernels take stride 1 or 2 and "
                         f"pad 1 or 0, got stride {stride}, pad {padding}")
    tag = ("_s2" if stride == 2 else "") + ("_p0" if padding == 0 else "")
    return name.replace("conv3x3_", f"conv3x3{tag}_")


def _conv_out(name: str, H: int, W: int, stride: int, padding: int
              ) -> Tuple[int, int]:
    """The conv's output size; raises where it vanishes (an unpadded conv
    of an input under 3 pixels)."""
    Ho, Wo = F.conv_out_hw(H, W, stride, padding)
    if Ho < 1 or Wo < 1:
        raise ValueError(f"{name}: a {H}x{W} input has no pad-{padding} "
                         "3x3 conv output")
    return Ho, Wo


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round4(a: int) -> int:
    return _cdiv(a, 4) * 4


@functools.lru_cache(maxsize=None)
def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


# -- K1 -----------------------------------------------------------------------


class FwdPlan(NamedTuple):
    """The launch of K1 at one shape, both modes: ``kernel`` ``"band"``
    (f32 at stride 1, csrc/conv3x3_fwd_s1.cu), ``"mma"`` (bf16 at stride
    1, csrc/conv3x3_s1_bf16.cu), ``"s2"`` (f32 at stride 2) or
    ``"s2_mma"`` (bf16 at stride 2, both csrc/conv3x3_s2.cu). A band
    kernel's block (``"band"``, ``"s2"``) takes ``band_rows`` output rows
    of one image and all output channels, ``bands`` a image, ``channels``
    (8 or 4) a thread; an mma block walks ``grid[0]``'s share of a
    tenant's bands of ``band_rows`` rows, ``channels`` output channels at
    a time (``grid[1]`` chunks); ``smem`` its dynamic shared memory;
    ``scratch`` the shape of the statistics' partials, ``(T, bands a
    tenant, 3, cout)``."""

    kernel: str
    grid: Tuple[int, int, int]
    threads: int
    smem: int
    band_rows: int
    bands: int
    channels: int
    scratch: Tuple[int, int, int, int]


@functools.lru_cache(maxsize=None)
def fwd_plan(T: int, N: int, H: int, W: int, cin: int, cout: int,
             stride: int = 1, pad: int = 1, sms: int = 132,
             bf16: bool = False) -> FwdPlan:
    """K1's launch for x ``(T, N, H, W, cin)`` and ``cout`` output
    channels on a card of ``sms`` SMs. A pure function of the shape: the
    wrappers call it, and so do the CPU tests. bf16 runs the mma kernels
    (``mma_plan`` at stride 1, ``s2_mma_plan`` at stride 2), f32 at stride
    2 the band kernel of ``_s2_fwd_plan``.

    The band kernel (f32, stride 1): a thread holds a run of 8 consecutive
    pixels of the band's ``Wo + 2``-wide grid x 8 channels (4 where 8 would
    leave the card fewer than ``FWD_FILL_THREADS`` threads a SM: the small
    maps; at stride 2 also at cin > 4, where the FLOPs bind and twice the
    threads ran faster), a block every run of its band x every channel
    group; the most rows a band that keep a block at most
    ``FWD_MAX_THREADS`` threads and its band (``CR +
    2`` input rows and ``FWD_SLACK`` pixels, each pixel cin rounded up to
    4 floats, and 4 more every 8 pixels) and two-stage weight ring (a
    stage: one tap, or all nine at cin <= 4, x cin x cout rounded up to 8)
    within ``FWD_SMEM_BYTES``, and the grid at ``BAND_BLOCKS_PER_SM``
    blocks a SM, balanced over the image. No block splits an output's sum
    (its order is the plain conv's). A row that no block of
    ``BAND_LAUNCH_BOUND`` threads and ``BLOCK_SMEM`` holds raises (at cin
    and cout 64, output rows over about 250 pixels)."""
    Ho, Wo = F.conv_out_hw(H, W, stride, pad)
    if min(T, N, Ho, Wo, cin, cout) < 1 or T > 65535:
        raise ValueError(f"fwd_plan: no conv3x3 forward of a {H}x{W} input "
                         f"at stride {stride}, pad {pad} (T={T}, N={N}, "
                         f"cin={cin}, cout={cout})")
    if bf16:
        m = (mma_plan(T, N, W, Ho, Wo, cin, cout, False, sms) if stride == 1
             else s2_mma_plan(T, N, H, W, cin, cout, pad, False, sms))
        return FwdPlan("mma" if stride == 1 else "s2_mma", m.grid,
                       m.threads, m.smem, m.band_rows, m.bands, m.channels,
                       (T, N * m.bands, 3, cout))
    if stride == 1:
        make = functools.partial(_band_plan, T, N, Ho, Wo, cin, cout, sms)
    else:
        make = functools.partial(_s2_fwd_plan, T, N, H, W, cin, cout, pad,
                                 sms)
        if cin > 4:  # the FLOP-bound layers: twice the threads
            return make(4)
    plan = make(8)
    if (cout > 4 and plan.grid[0] * T * plan.threads
            < FWD_FILL_THREADS * sms):
        plan = make(4)
    return plan


def _band_plan(T, N, Ho, Wo, cin, cout, sms, channels) -> FwdPlan:
    """``fwd_plan``'s band kernel with ``channels`` (8 or 4) a thread."""
    Wp = Wo + 2
    G = _cdiv(cout, channels)
    CS = _round4(cin)
    taps = 9 if cin <= 4 else 1  # a weight stage's

    def threads(CR):  # a run of 8 pixels x a channel group each
        return _cdiv((CR - 1) * Wp + Wo, 8) * G

    def stage(CR):  # floats: the band (4 more every 8 pixels), the ring
        pixels = (CR + 2) * Wp + FWD_SLACK
        return (_round4(pixels * CS + pixels // 8 * 4)
                + 2 * taps * cin * channels * G)

    CR = 1
    for rows in range(2, Ho + 1):
        if (threads(rows) > FWD_MAX_THREADS
                or 4 * stage(rows) > FWD_SMEM_BYTES
                or T * N * _cdiv(Ho, rows) < BAND_BLOCKS_PER_SM * sms):
            break
        CR = rows
    nb = _cdiv(Ho, CR)
    CR = _cdiv(Ho, nb)
    if threads(CR) > BAND_LAUNCH_BOUND or 4 * stage(CR) > BLOCK_SMEM:
        raise ValueError(f"fwd_plan: a {Wo}-pixel output row at cin {cin}, "
                         f"cout {cout} does not fit a block")
    # the stages, or the statistics' warp sums and means where larger
    sums = (_cdiv(threads(CR), 32) + 1) * channels * G
    return FwdPlan("band", (N * nb, 1, T), threads(CR),
                   4 * max(stage(CR), sums), CR, nb, channels,
                   (T, N * nb, 3, cout))


def _s2_fwd_plan(T, N, H, W, cin, cout, pad, sms, channels) -> FwdPlan:
    """``fwd_plan``'s band kernel at stride 2 (f32, csrc/conv3x3_s2.cu)
    with ``channels`` (8 or 4) a thread: a thread a run of 8 consecutive
    output pixels of its band x a channel group, a block every run of its
    band; the band's ``2 CR + 1`` input rows split into even and odd
    column planes of ``Wo + 1`` pixels (each pixel cin rounded up to 4
    floats, and 4 more every 8 pixels) and the two-stage weight ring of
    the stride-1 band kernel; the most rows a band that keep a block
    within ``FWD_MAX_THREADS`` threads and ``FWD_SMEM_BYTES`` and the grid
    at ``BAND_BLOCKS_PER_SM`` blocks a SM, balanced over the image. No
    block splits an output's sum (its order is the tile's)."""
    Ho, Wo = F.conv_out_hw(H, W, 2, pad)
    G = _cdiv(cout, channels)
    CS = _round4(cin)
    taps = 9 if cin <= 4 else 1  # a weight stage's

    def threads(CR):  # a run of 8 output pixels x a channel group each
        return _cdiv(CR * Wo, 8) * G

    def stage(CR):  # floats: the planes (4 more every 8 pixels), the ring
        pixels = (2 * CR + 1) * 2 * (Wo + 1)
        return (_round4(pixels * CS + pixels // 8 * 4)
                + 2 * taps * cin * channels * G)

    CR = 1
    for rows in range(2, Ho + 1):
        if (threads(rows) > FWD_MAX_THREADS
                or 4 * stage(rows) > FWD_SMEM_BYTES
                or T * N * _cdiv(Ho, rows) < BAND_BLOCKS_PER_SM * sms):
            break
        CR = rows
    nb = _cdiv(Ho, CR)
    CR = _cdiv(Ho, nb)
    if threads(CR) > BAND_LAUNCH_BOUND or 4 * stage(CR) > BLOCK_SMEM:
        raise ValueError(f"fwd_plan: a {Wo}-pixel stride-2 output row at "
                         f"cin {cin}, cout {cout} does not fit a block")
    # the stages, or the statistics' warp sums and means where larger
    sums = (_cdiv(threads(CR), 32) + 1) * channels * G
    return FwdPlan("s2", (N * nb, 1, T), threads(CR),
                   4 * max(stage(CR), sums), CR, nb, channels,
                   (T, N * nb, 3, cout))


class MmaPlan(NamedTuple):
    """The launch of csrc/conv3x3_s1_bf16.cu at one shape (K1 or dgrad in
    bf16 at stride 1): ``grid`` (blocks a tenant's channel chunk, chunks,
    T), ``threads`` (a warp every 32 band pixels), ``smem`` its dynamic
    shared memory; a block walks ``per`` consecutive bands of
    ``band_rows`` output rows, ``bands`` an image, ``channels`` output
    channels (8 x n8 tiles a warp)."""

    grid: Tuple[int, int, int]
    threads: int
    smem: int
    band_rows: int
    bands: int
    channels: int
    per: int


def mma_smem(dgrad: bool, Ws: int, Wo: int, Cs: int, band_rows: int,
             channels: int) -> Tuple[int, int]:
    """(threads, shared memory) of an mma block whose bands have
    ``band_rows`` rows of ``Wo`` output pixels, from a source ``Ws`` pixels
    wide of ``Cs`` channels (x's cin, or dy's cout at dgrad) to
    ``channels`` output channels: the geometry of ``mma_geom`` in
    csrc/conv3x3_s1_bf16.cu. The band on the ``Wo + 2``-wide grid with its
    halo and the rows the last warp's taps read past it, each pixel
    round16(K) + 8 bf16, or the warps' staged outputs where larger; forward
    at cin <= 3 instead two slots of the band's source rows as they lie in
    memory (the next band's in flight while this one computes) and a
    region of its own for the patch matrix (9 cin values a pixel packed
    into 16 or 32) or the staged outputs. Then the weights (forward: the
    taps' K rows of ``channels`` (+ 8 where the tiles are even) bf16;
    dgrad: 9 x ``channels`` rows of round16(Cs) + 8) and, forward, each
    warp's (count, sum, M2) of each channel."""
    Wp = Wo + 2
    warps = _cdiv((band_rows - 1) * Wp + Wo, MMA_WARP_PIXELS)
    packed = not dgrad and Cs <= 3
    KC = _cdiv(9 * Cs if packed else Cs, 16) * 16
    SA = KC + 8
    OS = channels if channels // 8 % 2 else channels + 8
    WS = KC + 8 if dgrad else OS
    rows_px = MMA_WARP_PIXELS * warps
    band_px = rows_px if packed else max((band_rows + 2) * Wp,
                                         rows_px + 2 * Wp + 2)
    band = _cdiv(max(2 * band_px * SA, 2 * rows_px * OS), 16) * 16
    raw = _cdiv(2 * _cdiv((band_rows + 2) * Ws * Cs, 2) * 2, 16) * 16
    a, slots = (band, 2 * raw) if packed else (0, band)
    w = 2 * 9 * channels * WS if dgrad else 2 * (1 if packed else 9) * KC * WS
    stats = 0 if dgrad else 4 * 3 * warps * channels
    return MMA_WARP_PIXELS * warps, a + slots + w + stats


@functools.lru_cache(maxsize=None)
def mma_plan(T: int, N: int, Ws: int, Ho: int, Wo: int, Cs: int, Co: int,
             dgrad: bool, sms: int = 132) -> MmaPlan:
    """The mma kernel's launch for a source ``Ws`` pixels wide of ``Cs``
    channels (x, or dy at dgrad) and an output ``(T, N, Ho, Wo, Co)`` (y,
    or dx). A pure
    function of the shape: ``fwd_plan`` and ``dgrad_plan`` call it, and so
    do the CPU tests.

    The output channels in the fewest chunks of at most
    ``MMA_MAX_CHANNELS``, each rounded up to 8 x an n8 tile count of
    ``MMA_TILES`` (48 at 48 channels, 64 at 64, 8 at dgrad to cin 3); the
    most rows a band that keep a block at most ``MMA_MAX_THREADS`` threads
    and ``MMA_SMEM_BYTES`` of shared memory and the grid at
    ``MMA_BLOCKS_PER_SM`` blocks a SM, balanced over the image; then as
    many blocks as the card holds at once (two a SM where the shared
    memory allows, else one), each walking ``per`` consecutive bands of
    its tenant, so each block loads its tenant's weights once. Every sum
    runs over (tap, k16 step) in order in one warp: no block splits an
    output's sum. A row that no block of ``MMA_MAX_THREADS`` threads and
    ``BLOCK_SMEM`` holds raises (at 64 channels, rows over about 220
    pixels)."""
    chunks = _cdiv(Co, MMA_MAX_CHANNELS)
    need = _cdiv(_cdiv(Co, chunks), 8)
    channels = 8 * min(nt for nt in MMA_TILES if nt >= need)
    target = MMA_BLOCKS_PER_SM * sms
    CR = 1
    for rows in range(2, Ho + 1):
        threads, smem = mma_smem(dgrad, Ws, Wo, Cs, rows, channels)
        if (threads > MMA_MAX_THREADS or smem > MMA_SMEM_BYTES
                or T * chunks * N * _cdiv(Ho, rows) < target):
            break
        CR = rows
    nb = _cdiv(Ho, CR)
    CR = _cdiv(Ho, nb)
    threads, smem = mma_smem(dgrad, Ws, Wo, Cs, CR, channels)
    if threads > MMA_MAX_THREADS or smem > BLOCK_SMEM:
        raise ValueError(f"mma_plan: a {Wo}-pixel output row from {Cs} to "
                         f"{Co} channels does not fit a block")
    resident = max(1, min(MMA_BLOCKS_PER_SM, SM_SMEM // (smem + 1024))) * sms
    per = _cdiv(T * chunks * N * nb, resident)
    blocks = _cdiv(N * nb, per)
    return MmaPlan((blocks, chunks, T), threads, smem, CR, nb, channels,
                   _cdiv(N * nb, blocks))


def s2_mma_smem(dgrad: bool, H: int, W: int, pad: int, Cs: int,
                band_rows: int, channels: int) -> Tuple[int, int]:
    """(threads, shared memory) of a stride-2 mma block (the geometry of
    ``s2_mma_geom`` in csrc/conv3x3_s2.cu) for the conv of an ``H x W``
    input at ``pad`` whose source has ``Cs`` channels (x's cin, or dy's
    cout at dgrad), ``band_rows`` GEMM rows a band and ``channels`` output
    channels a block. The GEMM rows are output rows of ``Wo`` pixels, or
    at dgrad quad rows of ``NB = (W + pad + 1) // 2`` quads; a warp every
    32 of a band's. The band: forward its ``2 band_rows + 1`` input rows
    as even and odd column planes of ``Wo + 1`` pixels, dgrad its
    ``band_rows + 1`` dy rows of ``NB + 1`` pixels, each pixel round16(Cs)
    + 8 bf16, or the forward's staged outputs where larger; forward at cin
    <= 3 instead its input rows as they lie in memory and a region of its
    own for the patch matrix (9 cin values a pixel packed into 16 or 32)
    or the staged outputs. Then the weights (forward: the taps' K rows of
    ``channels`` (+ 8 where the tiles are even) bf16; dgrad: 9 x
    ``channels`` rows of round16(Cs) + 8) and, forward, each warp's
    (count, sum, M2) of each channel."""
    Ho, Wo = F.conv_out_hw(H, W, 2, pad)
    if dgrad:
        Wr = (W + pad + 1) // 2
        Wq = Wr + 1
    else:
        Wr, Wq = Wo, Wo + 1
    warps = _cdiv(band_rows * Wr, MMA_WARP_PIXELS)
    packed = not dgrad and Cs <= 3
    KC = _cdiv(9 * Cs if packed else Cs, 16) * 16
    SA = KC + 8
    OS = channels if channels // 8 % 2 else channels + 8
    WS = KC + 8 if dgrad else OS
    rows_px = MMA_WARP_PIXELS * warps
    if packed:
        band_px = rows_px
    elif dgrad:
        band_px = (band_rows + 1) * Wq
    else:
        band_px = (2 * band_rows + 1) * 2 * Wq
    band = _cdiv(2 * band_px * SA if dgrad
                 else max(2 * band_px * SA, 2 * rows_px * OS), 16) * 16
    raw = _cdiv(2 * _cdiv((2 * band_rows + 1) * W * Cs, 2) * 2, 16) * 16
    a, slot = (band, raw) if packed else (0, band)
    w = 2 * 9 * channels * WS if dgrad else 2 * (1 if packed else 9) * KC * WS
    stats = 0 if dgrad else 4 * 3 * warps * channels
    return rows_px, a + slot + w + stats


@functools.lru_cache(maxsize=None)
def s2_mma_plan(T: int, N: int, H: int, W: int, cin: int, cout: int,
                pad: int, dgrad: bool, sms: int = 132) -> MmaPlan:
    """The stride-2 mma kernel's launch (K1 or dgrad in bf16,
    csrc/conv3x3_s2.cu) for the conv of x ``(T, N, H, W, cin)`` to
    ``cout`` channels at ``pad``: dgrad's source is dy (cout channels),
    its output dx (cin). ``band_rows`` counts GEMM rows (output rows, or
    dgrad's quad rows), ``bands`` them an image. The rule of ``mma_plan``:
    the output channels in the fewest chunks of at most
    ``MMA_MAX_CHANNELS``; the most rows a band that keep a block within
    ``MMA_MAX_THREADS`` threads and ``MMA_SMEM_BYTES`` and the grid at
    ``MMA_BLOCKS_PER_SM`` blocks a SM, balanced over the image; then as
    many blocks as the card holds at once, each walking ``per``
    consecutive bands of its tenant (its weights load once). Every sum
    runs in one warp (no split). Where the tenant's weights exceed
    ``S2_MMA_WEIGHT_BYTES``, chunks of at most ``S2_MMA_CHUNK``."""
    Ho, Wo = F.conv_out_hw(H, W, 2, pad)
    Cs, Co = (cout, cin) if dgrad else (cin, cout)
    R = (H + pad + 1) // 2 if dgrad else Ho
    most = (S2_MMA_CHUNK if 2 * 9 * Cs * Co > S2_MMA_WEIGHT_BYTES
            else MMA_MAX_CHANNELS)
    chunks = _cdiv(Co, most)
    need = _cdiv(_cdiv(Co, chunks), 8)
    channels = 8 * min(nt for nt in MMA_TILES if nt >= need)
    target = MMA_BLOCKS_PER_SM * sms
    CR = 1
    for rows in range(2, R + 1):
        threads, smem = s2_mma_smem(dgrad, H, W, pad, Cs, rows, channels)
        if (threads > MMA_MAX_THREADS or smem > MMA_SMEM_BYTES
                or T * chunks * N * _cdiv(R, rows) < target):
            break
        CR = rows
    nb = _cdiv(R, CR)
    CR = _cdiv(R, nb)
    threads, smem = s2_mma_smem(dgrad, H, W, pad, Cs, CR, channels)
    if threads > MMA_MAX_THREADS or smem > BLOCK_SMEM:
        raise ValueError(f"s2_mma_plan: a {W}-pixel row from {Cs} to {Co} "
                         "channels does not fit a block")
    resident = max(1, min(MMA_BLOCKS_PER_SM, SM_SMEM // (smem + 1024))) * sms
    per = _cdiv(T * chunks * N * nb, resident)
    blocks = _cdiv(N * nb, per)
    return MmaPlan((blocks, chunks, T), threads, smem, CR, nb, channels,
                   _cdiv(N * nb, blocks))


def conv3x3_fwd_stats(x: Tensor, w: Tensor, b: Tensor,
                      eps: float = F.BN_EPS, stride: int = 1,
                      padding: int = 1
                      ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """``y = conv3x3(x, w) + b`` (``stride``, ``padding``) and y's
    per-(tenant, channel) batch mean, biased variance and rstd: f32 on the
    band kernels, bf16 on the mma kernels, at stride 1 or 2
    (``fwd_plan``); each merges its statistics' partials in a second
    launch."""
    if _on_cpu(x):
        return F.conv3x3_fwd_stats(x, w, b, eps, stride=stride,
                                   padding=padding)
    name = _conv_name("conv3x3_fwd_stats", stride, padding)
    T, N, H, W, cin = _check_act(name, x)
    cout = w.shape[-1]
    _check(name, "w", w, (T, 3, 3, cin, cout), x.device, x.dtype)
    _check(name, "b", b, (T, cout), x.device, x.dtype)
    Ho, Wo = _conv_out(name, H, W, stride, padding)
    plan = fwd_plan(T, N, H, W, cin, cout, stride, padding, _sms(x.device),
                    x.dtype == torch.bfloat16)
    y = torch.empty((T, N, Ho, Wo, cout), device=x.device, dtype=x.dtype)
    part = torch.empty(plan.scratch, device=x.device)
    mean, var, rstd = torch.empty((3, T, cout), device=x.device,
                                  dtype=x.dtype).unbind(0)
    counter = _counter(name, x)
    ptrs = (_ptr(x), _ptr(w), _ptr(b), _ptr(y), _ptr(part), _ptr(mean),
            _ptr(var), _ptr(rstd))
    eps = F.scalar_like(eps, x)
    with _device(x.device):
        if plan.kernel == "band":
            fn = build.function("conv3x3_fwd_s1", "conv3x3_fwd_stats_band",
                                (_P,) * 8 + (_I,) * 11 + (_F, _P))
            rc = fn(*ptrs, T, N, H, W, padding, cin, cout, plan.band_rows,
                    plan.channels, plan.threads, plan.smem, eps,
                    _stream(x.device))
        elif plan.kernel == "mma":
            fn = build.function("conv3x3_s1_bf16", "conv3x3_fwd_stats_mma",
                                (_P,) * 8 + (_I,) * 12 + (_F, _P))
            rc = fn(*ptrs, T, N, H, W, padding, cin, cout, plan.band_rows,
                    plan.channels, plan.grid[0], plan.threads, plan.smem,
                    eps, _stream(x.device))
        elif plan.kernel == "s2":
            fn = build.function("conv3x3_s2", "conv3x3_s2_fwd_stats",
                                (_P,) * 8 + (_I,) * 11 + (_F, _P))
            rc = fn(*ptrs, T, N, H, W, padding, cin, cout, plan.band_rows,
                    plan.channels, plan.threads, plan.smem, eps,
                    _stream(x.device))
        else:
            fn = build.function("conv3x3_s2", "conv3x3_s2_fwd_stats_mma",
                                (_P,) * 8 + (_I,) * 12 + (_F, _P))
            rc = fn(*ptrs, T, N, H, W, padding, cin, cout, plan.band_rows,
                    plan.channels, plan.grid[0], plan.threads, plan.smem,
                    eps, _stream(x.device))
    build.check(rc, counter)
    LAUNCHES[counter] += 1
    return y, mean, var, rstd


def conv3x3_fwd(x: Tensor, w: Tensor, b: Optional[Tensor] = None,
                stride: int = 1, padding: int = 1) -> Tensor:
    """K1's stats-free mode: ``y = conv3x3(x, w) (+ b)``, one launch of
    the kernel ``fwd_plan`` names."""
    if _on_cpu(x):
        return F.conv3x3(x, w, b, stride=stride, padding=padding)
    name = _conv_name("conv3x3_fwd", stride, padding)
    T, N, H, W, cin = _check_act(name, x)
    cout = w.shape[-1]
    _check(name, "w", w, (T, 3, 3, cin, cout), x.device, x.dtype)
    if b is not None:
        _check(name, "b", b, (T, cout), x.device, x.dtype)
    y = torch.empty((T, N, *_conv_out(name, H, W, stride, padding), cout),
                    device=x.device, dtype=x.dtype)
    plan = fwd_plan(T, N, H, W, cin, cout, stride, padding, _sms(x.device),
                    x.dtype == torch.bfloat16)
    counter = _counter(name, x)
    ptrs = (_ptr(x), _ptr(w), None if b is None else _ptr(b), _ptr(y))
    with _device(x.device):
        if plan.kernel == "band":
            fn = build.function("conv3x3_fwd_s1", "conv3x3_fwd_band",
                                (_P,) * 4 + (_I,) * 11 + (_P,))
            rc = fn(*ptrs, T, N, H, W, padding, cin, cout, plan.band_rows,
                    plan.channels, plan.threads, plan.smem,
                    _stream(x.device))
        elif plan.kernel == "mma":
            fn = build.function("conv3x3_s1_bf16", "conv3x3_fwd_mma",
                                (_P,) * 4 + (_I,) * 12 + (_P,))
            rc = fn(*ptrs, T, N, H, W, padding, cin, cout, plan.band_rows,
                    plan.channels, plan.grid[0], plan.threads, plan.smem,
                    _stream(x.device))
        elif plan.kernel == "s2":
            fn = build.function("conv3x3_s2", "conv3x3_s2_fwd",
                                (_P,) * 4 + (_I,) * 11 + (_P,))
            rc = fn(*ptrs, T, N, H, W, padding, cin, cout, plan.band_rows,
                    plan.channels, plan.threads, plan.smem,
                    _stream(x.device))
        else:
            fn = build.function("conv3x3_s2", "conv3x3_s2_fwd_mma",
                                (_P,) * 4 + (_I,) * 12 + (_P,))
            rc = fn(*ptrs, T, N, H, W, padding, cin, cout, plan.band_rows,
                    plan.channels, plan.grid[0], plan.threads, plan.smem,
                    _stream(x.device))
    build.check(rc, counter)
    LAUNCHES[counter] += 1
    return y


# -- K2 / K3 / K5 -------------------------------------------------------------


def _check_bn_args(name, y, tensors, device):
    T, _, _, _, C = _check_act(name, y)
    for what, t in tensors.items():
        _check(name, what, t, (T, C), device, y.dtype)


def _check_pooled(name, dpooled, argmax, y):
    """Check a pooled gradient and the window argmax against y."""
    T, N, H, W, C = y.shape
    pooled_shape = (T, N, H // 2, W // 2, C)
    _check(name, "dpooled", dpooled, pooled_shape, y.device, y.dtype)
    if argmax.dtype != torch.uint8 or tuple(argmax.shape) != pooled_shape \
            or not argmax.is_contiguous() or argmax.device != y.device:
        raise ValueError(
            f"{name}: argmax must be a contiguous uint8 {pooled_shape} "
            f"tensor on {y.device}"
        )


class BnFwdPlan(NamedTuple):
    """The launch of K2 at one shape (csrc/bn_act_fwd.cu): ``grid`` (blocks,
    T) pooled, (blocks, 1) pool-free, of ``threads``. Pooled, a thread
    takes ``items`` consecutive channels (4, or 1 without vectors) of one
    pooled pixel, ``groups`` = ceil(C / items) threads a pooled pixel, and
    a tenant has ``work`` such threads; pool-free, a thread takes ``items``
    consecutive elements of the flat tensor (16 bytes: 4 in f32, 8 in
    bf16; 1 without vectors), ``work`` threads in all (groups 0)."""

    grid: Tuple[int, int]
    threads: int
    items: int
    groups: int
    work: int


@functools.lru_cache(maxsize=None)
def bn_fwd_plan(T: int, N: int, H: int, W: int, C: int, pool: bool,
                bf16: bool = False, vec: bool = True) -> BnFwdPlan:
    """K2's launch for y ``(T, N, H, W, C)``, pooled (``pool``) or
    pool-free, in f32 or bf16, with vector loads (``vec``: pooled, C % 4
    == 0 and every tensor aligned to a vector; pool-free, y and the output
    aligned to 16 bytes) or an element at a time. A pure function of the
    shape: the wrappers call it, and so do the CPU tests. Raises for a
    shape the kernels do not take."""
    if (min(T, N, H, W, C) < 1 or C > BN_FWD_MAX_C
            or N * H * W * C >= 2 ** 31
            or pool and (H < 2 or W < 2 or T > 65535 or vec and C % 4)):
        raise ValueError(f"bn_fwd_plan: no {'pooled' if pool else 'pool-free'}"
                         f" K2 of a (T={T}, N={N}, {H}x{W}, C={C}) map"
                         f"{' with vectors' if vec else ''}")
    if pool:
        items = 4 if vec else 1
        groups = _cdiv(C, items)
        work = N * (H // 2) * (W // 2) * groups
        return BnFwdPlan((_cdiv(work, BN_FWD_THREADS), T), BN_FWD_THREADS,
                         items, groups, work)
    items = (8 if bf16 else 4) if vec else 1
    work = _cdiv(T * N * H * W * C, items)
    return BnFwdPlan((_cdiv(work, BN_FWD_THREADS), 1), BN_FWD_THREADS,
                     items, 0, work)


def _check_bn_fwd(name, y, mean, rstd, gamma, beta):
    _check_bn_args(name, y, dict(mean=mean, rstd=rstd, gamma=gamma,
                                 beta=beta), y.device)
    if y.shape[-1] > BN_FWD_MAX_C:
        raise NotImplementedError(f"{name} takes at most {BN_FWD_MAX_C} "
                                  f"channels, got {y.shape[-1]}")


def bn_act_pool_fwd(y: Tensor, mean: Tensor, rstd: Tensor, gamma: Tensor,
                    beta: Tensor, negative_slope: float = F.LEAKY_SLOPE
                    ) -> Tuple[Tensor, Tensor]:
    """Normalize, affine, leaky-ReLU and 2x2 max pool; returns the pooled
    activation and the uint8 window argmax. One launch of
    csrc/bn_act_fwd.cu (``bn_fwd_plan``)."""
    if _on_cpu(y):
        return F.bn_act_pool_fwd(y, mean, rstd, gamma, beta, negative_slope)
    name = "bn_act_pool_fwd"
    _check_bn_fwd(name, y, mean, rstd, gamma, beta)
    T, N, H, W, C = y.shape
    # two allocations: one shared by two views took longer on the host
    # (PERF.md §6), where a call at the small maps is host-bound
    shape = (T, N, H // 2, W // 2, C)
    out = torch.empty(shape, device=y.device, dtype=y.dtype)
    arg = torch.empty(shape, device=y.device, dtype=torch.uint8)
    ptrs = [t.data_ptr() for t in (y, mean, rstd, gamma, beta, out, arg)]
    v = 4 * y.element_size()
    vec = C % 4 == 0 and ptrs[-1] % 4 == 0 and all(
        q % v == 0 for q in ptrs[:-1])
    bf16 = y.dtype == torch.bfloat16
    plan = bn_fwd_plan(T, N, H, W, C, True, bf16, vec)
    counter = _counter(name, y)
    with _device(y.device):
        rc = build.function("bn_act_fwd", "bn_act_pool_fwd",
                            (_P,) * 7 + (_I,) * 9 + (_F, _P))(
            *ptrs, T, N, H, W, C, int(bf16), int(vec), plan.grid[0],
            plan.threads, F.scalar_like(negative_slope, y),
            _stream(y.device))
    build.check(rc, counter)
    LAUNCHES[counter] += 1
    return out, arg


def _launch_act_fwd(name, y, mean, rstd, gamma, beta, slope) -> Tensor:
    """K2's pool-free mode on the card (csrc/bn_act_fwd.cu), counted on
    ``name`` (on ``<name>_bf16`` in bf16)."""
    _check_bn_fwd(name, y, mean, rstd, gamma, beta)
    T, N, H, W, C = y.shape
    out = torch.empty_like(y)
    ptrs = [t.data_ptr() for t in (y, mean, rstd, gamma, beta, out)]
    vec = ptrs[0] % 16 == 0 and ptrs[-1] % 16 == 0
    bf16 = y.dtype == torch.bfloat16
    plan = bn_fwd_plan(T, N, H, W, C, False, bf16, vec)
    counter = _counter(name, y)
    with _device(y.device):
        rc = build.function("bn_act_fwd", "bn_act_fwd",
                            (_P,) * 6 + (_I,) * 9 + (_F, _P))(
            *ptrs, T, N, H, W, C, int(bf16), int(vec), plan.grid[0],
            plan.threads, F.scalar_like(slope, y), _stream(y.device))
    build.check(rc, counter)
    LAUNCHES[counter] += 1
    return out


def bn_act_fwd(y: Tensor, mean: Tensor, rstd: Tensor, gamma: Tensor,
               beta: Tensor, negative_slope: float = F.LEAKY_SLOPE) -> Tensor:
    """K2's pool-free mode: normalize, affine and leaky-ReLU."""
    if _on_cpu(y):
        return F.bn_act_fwd(y, mean, rstd, gamma, beta, negative_slope)
    return _launch_act_fwd("bn_act_fwd", y, mean, rstd, gamma, beta,
                           negative_slope)


class BnBwdPlan(NamedTuple):
    """The cooperative launch of K3 or K5 pooled at one shape
    (csrc/bn_act_pool_bwd.cu, both dtypes): a block of ``threads`` takes
    ``slots`` windows at a time x ``groups`` groups of one load of channels
    (``BN_BWD_GROUP``), ``chunk`` consecutive windows of one tenant in all;
    ``grid`` is (blocks a tenant, T); a tenant has ``windows`` windows."""

    grid: Tuple[int, int]
    threads: int
    groups: int
    slots: int
    chunk: int
    windows: int


@functools.lru_cache(maxsize=None)
def bn_bwd_plan(T: int, N: int, H: int, W: int, C: int, sms: int = 132,
                blocks_per_sm: int = 2, bf16: bool = False,
                name: str = "bn_act_pool_bwd") -> BnBwdPlan:
    """The launch of K3 (``name`` ``bn_act_pool_bwd``) or K5
    (``bn_act_pool_bwd_bwd``), both dtypes, for y ``(T, N, H, W, C)`` on a
    card of ``sms`` SMs that holds ``blocks_per_sm`` of their blocks at
    once (the occupancy query). A pure function of the shape, the kernel
    and the dtype: the wrappers call it, and so do the CPU tests.

    Each tenant's map in windows of 2 x 2 positions (an odd map's last row
    or column in windows of one row or column), ceil(H / 2) x ceil(W / 2)
    an image; a block ``BN_BWD_THREADS`` threads, a thread a group of
    ``BN_BWD_GROUP[name, bf16]`` channels (one load: 4 f32, 8 bf16 in K3,
    4 bf16 in K5), ``slots`` = threads // groups windows at a time; each
    tenant's windows over as many blocks as the card holds at once (but no
    block without a window for each of its slots), in chunks of whole
    ``slots`` windows; no chunk spans two tenants. Raises where the card
    cannot hold a block a tenant at once (the cooperative launch needs
    every block resident). The pool-free modes have wrappers of their own:
    K3 (``bn_act_bwd``, ``batch_norm_bwd``) and K5 (``bn_act_bwd_bwd``,
    ``batch_norm_bwd_bwd``) on csrc/bn_act_bwd.cu (``bn_act_bwd_plan``,
    ``bn_act_bwd_bwd_plan``)."""
    if min(T, N, C) < 1 or H < 2 or W < 2 or C > BN_BWD_MAX_C:
        raise ValueError(f"bn_bwd_plan: no pooled K3/K5 of a (T={T}, N={N}, "
                         f"{H}x{W}, C={C}) map")
    resident = sms * blocks_per_sm
    if T > resident:
        raise ValueError(f"bn_bwd_plan: {T} tenants need a block each at "
                         f"once; the card holds {resident}")
    groups = _cdiv(C, BN_BWD_GROUP[name, bf16])
    slots = BN_BWD_THREADS // groups
    windows = N * _cdiv(H, 2) * _cdiv(W, 2)
    blocks = min(resident // T, _cdiv(windows, slots))
    chunk = _cdiv(_cdiv(windows, blocks), slots) * slots
    return BnBwdPlan((_cdiv(windows, chunk), T), BN_BWD_THREADS, groups,
                     slots, chunk, windows)


def _bn_bwd_vec(C: int, ptrs, bf16: bool = False,
                name: str = "bn_act_pool_bwd") -> bool:
    """K3's or K5's vector loads, for the pointers ``ptrs`` of their input
    tensors (the uint8 argmax sixth from the end): C a whole number of a
    group's channels (``BN_BWD_GROUP``), every f32 or bf16 tensor aligned
    to a group's bytes (16, or 8 in the bf16 K5), the argmax to its
    channels; else a value at a time."""
    arg = len(ptrs) - 6
    group = BN_BWD_GROUP[name, bf16]
    size = group * (2 if bf16 else 4)
    return C % group == 0 and ptrs[arg] % group == 0 and all(
        p % size == 0 for i, p in enumerate(ptrs) if i != arg)


@functools.lru_cache(maxsize=None)
def _bn_bwd_blocks_per_sm(device, sums: int, vec: bool,
                          bf16: bool = False) -> int:
    """The occupancy query of the cooperative K3 (2 sums) or K5 (5), f32
    or bf16."""
    fn = build.function("bn_act_pool_bwd", "bn_act_pool_bwd_blocks_per_sm",
                        (_I, _I, _I, ctypes.POINTER(ctypes.c_int)))
    out = ctypes.c_int(0)
    with _device(device):
        rc = fn(sums, int(vec), int(bf16), ctypes.byref(out))
    build.check(rc, "bn_act_pool_bwd_blocks_per_sm")
    return out.value


def _bn_bwd_route(name: str, y: Tensor, vec: bool) -> BnBwdPlan:
    """``bn_bwd_plan`` of K3 (``name`` ``bn_act_pool_bwd``) or K5 at y's
    shape and dtype on y's card."""
    T, N, H, W, C = y.shape
    bf16 = y.dtype == torch.bfloat16
    return bn_bwd_plan(T, N, H, W, C, _sms(y.device),
                       _bn_bwd_blocks_per_sm(y.device, BN_BWD_SUMS[name],
                                             vec, bf16), bf16, name)


#: the CUDA entries of K3 and K5 by (name, bf16): function, argument types
_K3_ARGS = (_P,) * 12 + (_I,) * 10 + (_F, _F, _P)
_K5_ARGS = (_P,) * 15 + (_I,) * 10 + (_F, _F, _P)
_BN_BWD_ENTRIES = {
    ("bn_act_pool_bwd", False): ("bn_act_pool_bwd_f32", _K3_ARGS),
    ("bn_act_pool_bwd", True): ("bn_act_pool_bwd_bf16", _K3_ARGS),
    ("bn_act_pool_bwd_bwd", False): ("bn_act_pool_bwd_bwd_f32", _K5_ARGS),
    ("bn_act_pool_bwd_bwd", True): ("bn_act_pool_bwd_bwd_bf16", _K5_ARGS),
}


def _bn_bwd_cuda(name: str, plan: BnBwdPlan, vec: bool, tensors, ptrs,
                 slope: float) -> Tuple[Tensor, Tensor, Tensor]:
    """The CUDA K3 (``name`` ``bn_act_pool_bwd``: ``tensors`` dpooled,
    argmax, y, mean, rstd, gamma, beta; returns dy, dgamma, dbeta) or K5
    (``bn_act_pool_bwd_bwd``: a, ggamma, gbeta and K3's; returns
    g_dpooled, g_y, g_gamma), f32 or bf16, on validated tensors at ``ptrs``,
    launched by ``plan``. The (T, C) outputs (in y's dtype) and the f32
    scratch (the blocks' partial sums, the merged sums) share one
    allocation: a call's host time counts at the small maps."""
    y, dpooled = tensors[-5], tensors[-7]
    T, N, H, W, C = y.shape
    bf16 = y.dtype == torch.bfloat16
    sums, vecs = BN_BWD_SUMS[name], 2 if name == "bn_act_pool_bwd" else 1
    big = ((torch.empty_like(y),) if vecs == 2
           else (torch.empty_like(dpooled), torch.empty_like(y)))
    TC = T * C
    # the (T, C) outputs: vecs * TC values of y's dtype, in f32 words
    head = _cdiv(vecs * TC, 2) if bf16 else vecs * TC
    small = torch.empty(head + sums * TC * (plan.grid[0] + 1),
                        device=y.device)
    base = small.data_ptr()
    part = base + 4 * head
    esize = y.element_size()
    entry, argtypes = _BN_BWD_ENTRIES[name, bf16]
    with _device(y.device):
        rc = build.function("bn_act_pool_bwd", entry, argtypes)(
            *ptrs, *(t.data_ptr() for t in big),
            *(base + esize * k * TC for k in range(vecs)), part,
            part + 4 * sums * TC * plan.grid[0], T, N, H, W, C,
            plan.grid[0], plan.chunk, plan.slots, plan.threads, int(vec),
            slope, 1.0 / (N * H * W), _stream(y.device))
    build.check(rc, name)
    outs = small[:head].view(y.dtype)[:vecs * TC].view(vecs, T, C)
    return (*big, *outs.unbind(0))


def bn_act_pool_bwd(dpooled: Tensor, argmax: Tensor, y: Tensor, mean: Tensor,
                    rstd: Tensor, gamma: Tensor, beta: Tensor,
                    negative_slope: float = F.LEAKY_SLOPE
                    ) -> Tuple[Tensor, Tensor, Tensor]:
    """The backward of ``bn_act_pool_fwd`` through batch norm with batch
    statistics; returns ``(dy, dgamma, dbeta)``. One launch of the
    cooperative CUDA kernel in either dtype (``bn_bwd_plan``)."""
    if _on_cpu(y):
        return F.bn_act_pool_bwd(dpooled, argmax, y, mean, rstd, gamma, beta,
                                 negative_slope)
    name = "bn_act_pool_bwd"
    _check_bn_args(name, y, dict(mean=mean, rstd=rstd, gamma=gamma,
                                 beta=beta), y.device)
    _check_pooled(name, dpooled, argmax, y)
    C = y.shape[-1]
    tensors = (dpooled, argmax, y, mean, rstd, gamma, beta)
    ptrs = [t.data_ptr() for t in tensors]
    vec = _bn_bwd_vec(C, ptrs, y.dtype == torch.bfloat16)
    plan = _bn_bwd_route(name, y, vec)
    out = _bn_bwd_cuda(name, plan, vec, tensors, ptrs,
                       F.scalar_like(negative_slope, y))
    LAUNCHES[_counter(name, y)] += 1
    return out


def bn_act_bwd(da: Tensor, y: Tensor, mean: Tensor, rstd: Tensor,
               gamma: Tensor, beta: Tensor,
               negative_slope: float = F.LEAKY_SLOPE
               ) -> Tuple[Tensor, Tensor, Tensor]:
    """K3's pool-free mode: the backward of ``bn_act_fwd``; returns
    ``(dy, dgamma, dbeta)``. One launch of csrc/bn_act_bwd.cu."""
    if _on_cpu(y):
        return F.bn_act_bwd(da, y, mean, rstd, gamma, beta, negative_slope)
    return _launch_act_bwd("bn_act_bwd", da, y, mean, rstd, gamma, beta,
                           negative_slope)


def _check_like(name, y, full, tables) -> None:
    """Check the tensors of ``full`` (name: tensor) against y's shape and
    those of ``tables`` against (T, C), each of y's dtype and device and
    contiguous: in a few host operations each where they pass (a call's
    host time counts at the small maps), else with ``_check``'s error."""
    dtype, device, tc = y.dtype, y.device, (y.shape[0], y.shape[-1])
    for group, shape in ((full, y.shape), (tables, tc)):
        for what, t in group.items():
            if not (t.dtype is dtype and t.shape == shape
                    and t.is_contiguous() and t.device == device):
                _ln_same(name, what, t, shape, y)


def _launch_act_bwd(name, da, y, mean, rstd, gamma, beta, slope
                    ) -> Tuple[Tensor, Tensor, Tensor]:
    """K3's pool-free mode on the card, counted on ``name`` (on
    ``<name>_bf16`` in bf16): one launch of csrc/bn_act_bwd.cu
    (``bn_act_bwd_plan``; the kernel writes dy, dgamma and dbeta), dgamma
    and dbeta views of one allocation, the grid route's f32 scratch kept a
    stream (``_scratch``)."""
    T, N, H, W, C = _check_flat(name, y)
    dtype, device = y.dtype, y.device
    _check_like(name, y, dict(da=da), dict(mean=mean, rstd=rstd,
                                           gamma=gamma, beta=beta))
    P = N * H * W
    bf16 = dtype is torch.bfloat16
    dap, yp = da.data_ptr(), y.data_ptr()
    # dy is a fresh allocation: aligned
    plan = _bn_act_bwd_route(device, T, P, C, bf16, (dap | yp) % 16 == 0)
    dy = torch.empty_like(y)
    sums = y.new_empty((2, T, C))  # dgamma, dbeta
    base = sums.data_ptr()
    stream = _stream(device)
    part = tot = 0
    if plan.splits > 1:  # (T, S, 2, C) partials, then (T, 2, C) totals
        part = _scratch(device, stream, 2 * C * (plan.grid + T)).data_ptr()
        tot = part + 8 * C * plan.grid
    args = _packed(dap, yp, mean.data_ptr(), rstd.data_ptr(),
                   gamma.data_ptr(), beta.data_ptr(), dy.data_ptr(), base,
                   base + T * C * y.element_size(), part, tot, T, C, P * C,
                   bf16, plan.mode != "scalar", plan.threads, plan.chunk,
                   plan.splits, plan.grid, device.index, stream,
                   plan.stage)
    rc = build.function("bn_act_bwd", "bn_act_bwd", _ADDR_2F_ENTRY)(
        args.buffer_info()[0], F.scalar_like(slope, y), 1.0 / P)
    counter = _counter(name, y)
    build.check(rc, counter)
    LAUNCHES[counter] += 1
    return dy, sums[0], sums[1]


@functools.lru_cache(maxsize=None)
def _bn_act_bwd_blocks_per_sm(device, bf16: bool, mode: str) -> int:
    """The occupancy query of the pool-free K3's grid-route kernel."""
    fn = build.function("bn_act_bwd", "bn_act_bwd_blocks_per_sm",
                        (_I, _I, ctypes.POINTER(ctypes.c_int)))
    out = ctypes.c_int(0)
    with _device(device):
        rc = fn(int(bf16), BN_STATS_MODES.index(mode), ctypes.byref(out))
    build.check(rc, "bn_act_bwd_blocks_per_sm")
    return out.value


@functools.lru_cache(maxsize=None)
def _bn_act_bwd_route(device, T: int, P: int, C: int, bf16: bool,
                      vec: bool) -> BnStatsPlan:
    """``bn_act_bwd_plan`` on ``device``'s SMs and occupancy."""
    mode = bn_stats_mode(C, P * C, bf16, vec)
    return bn_act_bwd_plan(T, P, C, bf16, vec, _sms(device),
                           _bn_act_bwd_blocks_per_sm(device, bf16, mode))


def bn_act_pool_bwd_bwd(a: Tensor, ggamma: Tensor, gbeta: Tensor,
                        dpooled: Tensor, argmax: Tensor, y: Tensor,
                        mean: Tensor, rstd: Tensor, gamma: Tensor,
                        beta: Tensor, negative_slope: float = F.LEAKY_SLOPE
                        ) -> Tuple[Tensor, Tensor, Tensor]:
    """K5, the backward of ``bn_act_pool_bwd``: from the cotangents of its
    ``(dy, dgamma, dbeta)`` outputs, the gradients with respect to
    ``dpooled``, ``y`` and ``gamma`` (beta's is zero). One launch of the
    cooperative CUDA kernel in either dtype (``bn_bwd_plan``)."""
    if _on_cpu(y):
        return F.bn_act_pool_bwd_bwd(a, ggamma, gbeta, dpooled, argmax, y,
                                     mean, rstd, gamma, beta, negative_slope)
    name = "bn_act_pool_bwd_bwd"
    _check_bn_args(name, y, dict(mean=mean, rstd=rstd, gamma=gamma,
                                 beta=beta, ggamma=ggamma, gbeta=gbeta),
                   y.device)
    _check(name, "a", a, y.shape, y.device, y.dtype)
    _check_pooled(name, dpooled, argmax, y)
    C = y.shape[-1]
    tensors = (a, ggamma, gbeta, dpooled, argmax, y, mean, rstd, gamma, beta)
    ptrs = [t.data_ptr() for t in tensors]
    vec = _bn_bwd_vec(C, ptrs, y.dtype == torch.bfloat16, name)
    plan = _bn_bwd_route(name, y, vec)
    out = _bn_bwd_cuda(name, plan, vec, tensors, ptrs,
                       F.scalar_like(negative_slope, y))
    LAUNCHES[_counter(name, y)] += 1
    return out


def bn_act_bwd_bwd(a: Tensor, ggamma: Tensor, gbeta: Tensor, da: Tensor,
                   y: Tensor, mean: Tensor, rstd: Tensor, gamma: Tensor,
                   beta: Tensor, negative_slope: float = F.LEAKY_SLOPE
                   ) -> Tuple[Tensor, Tensor, Tensor]:
    """K5's pool-free mode, the backward of ``bn_act_bwd``: the gradients
    with respect to ``da``, ``y`` and ``gamma`` (beta's is zero)."""
    if _on_cpu(y):
        return F.bn_act_bwd_bwd(a, ggamma, gbeta, da, y, mean, rstd, gamma,
                                beta, negative_slope)
    return _launch_act_bwd_bwd("bn_act_bwd_bwd", a, ggamma, gbeta, da, y,
                               mean, rstd, gamma, beta, negative_slope)


def _launch_act_bwd_bwd(name, a, ggamma, gbeta, da, y, mean, rstd, gamma,
                        beta, slope) -> Tuple[Tensor, Tensor, Tensor]:
    """K5's pool-free mode on the card, counted on ``name`` (on
    ``<name>_bf16`` in bf16): one launch of csrc/bn_act_bwd.cu
    (``bn_act_bwd_bwd_plan``; the kernel writes g_da, g_y and g_gamma), the
    grid route's f32 scratch kept a stream (``_scratch``)."""
    T, N, H, W, C = _check_flat(name, y)
    dtype, device = y.dtype, y.device
    tc = (T, C)
    _check_like(name, y, dict(a=a, da=da),
                dict(mean=mean, rstd=rstd, gamma=gamma, beta=beta,
                     ggamma=ggamma, gbeta=gbeta))
    P = N * H * W
    bf16 = dtype is torch.bfloat16
    ap, dap, yp = a.data_ptr(), da.data_ptr(), y.data_ptr()
    # g_da and g_y are fresh allocations: aligned
    plan = _bn_act_bwd_bwd_route(device, T, P, C, bf16,
                                 (ap | dap | yp) % 16 == 0)
    g_da = torch.empty_like(y)
    g_y = torch.empty_like(y)
    g_gamma = y.new_empty(tc)
    stream = _stream(device)
    part = tot = 0
    if plan.splits > 1:  # (T, S, 5, C) partials, then (T, 5, C) totals
        sums = BN_ACT_BWD_BWD_SUMS * C
        part = _scratch(device, stream, sums * (plan.grid + T)).data_ptr()
        tot = part + 4 * sums * plan.grid
    args = _packed(ap, dap, yp, mean.data_ptr(), rstd.data_ptr(),
                   gamma.data_ptr(), beta.data_ptr(), ggamma.data_ptr(),
                   gbeta.data_ptr(), g_da.data_ptr(), g_y.data_ptr(),
                   g_gamma.data_ptr(), part, tot, T, C, P * C, bf16,
                   plan.mode != "scalar", plan.threads, plan.chunk,
                   plan.splits, plan.grid, device.index, stream, plan.stage)
    rc = build.function("bn_act_bwd", "bn_act_bwd_bwd", _ADDR_2F_ENTRY)(
        args.buffer_info()[0], F.scalar_like(slope, y), 1.0 / P)
    counter = _counter(name, y)
    build.check(rc, counter)
    LAUNCHES[counter] += 1
    return g_da, g_y, g_gamma


@functools.lru_cache(maxsize=None)
def _bn_act_bwd_bwd_blocks_per_sm(device, bf16: bool, mode: str) -> int:
    """The occupancy query of the pool-free K5's grid-route kernel."""
    fn = build.function("bn_act_bwd", "bn_act_bwd_bwd_blocks_per_sm",
                        (_I, _I, ctypes.POINTER(ctypes.c_int)))
    out = ctypes.c_int(0)
    with _device(device):
        rc = fn(int(bf16), BN_STATS_MODES.index(mode), ctypes.byref(out))
    build.check(rc, "bn_act_bwd_bwd_blocks_per_sm")
    return out.value


@functools.lru_cache(maxsize=None)
def _bn_act_bwd_bwd_route(device, T: int, P: int, C: int, bf16: bool,
                          vec: bool) -> BnStatsPlan:
    """``bn_act_bwd_bwd_plan`` on ``device``'s SMs and occupancy."""
    mode = bn_stats_mode(C, P * C, bf16, vec)
    return bn_act_bwd_bwd_plan(T, P, C, bf16, vec, _sms(device),
                               _bn_act_bwd_bwd_blocks_per_sm(device, bf16,
                                                             mode))


# -- the norm-first block's kernels: standalone batch norm (B5b) ----------------


class BnStatsPlan(NamedTuple):
    """The launch of ``bn_input_stats`` at one shape
    (csrc/bn_input_stats.cu), and of the pool-free K3 and K5
    (csrc/bn_act_bwd.cu, ``bn_act_bwd_plan``: the units of da and y;
    ``bn_act_bwd_bwd_plan``: of a, da and y). A thread takes units of
    ``unit`` loads of ``vec`` values (16 bytes, or one value) and holds
    ``chans`` channels: ``mode`` ``"lanes"`` (C a multiple of a load's
    values: a load is ``vec`` consecutive channels), ``"packed1"`` /
    ``"packed3"`` (C = 1 or 3: a unit is lcm(C, vec) values, value i of
    channel i mod C) or ``"scalar"`` (a value a unit). A tenant's E values
    are ``units`` whole units (E a multiple of vec, and 3 coprime to it,
    make E a multiple of lcm(C, vec)), in chunks of ``chunk`` units (a
    multiple of ``slots`` = C / chans: a thread's units are all its slot
    mod slots) to ``splits`` blocks of ``threads`` live threads (a multiple
    of slots); ``grid`` = T x splits. ``route``
    ``"block"`` (splits 1: a block a tenant, a plain launch) or ``"grid"``
    (one cooperative launch, its blocks' partials merged after a grid
    barrier). ``stage`` (the pool-free K3 and K5 only): the dynamic shared
    memory a block keeps its packets of the inputs in from the reduce to
    the apply, or 0 (the apply reads them again from L2)."""

    route: str
    mode: str
    vec: int
    unit: int
    chans: int
    slots: int
    threads: int
    units: int
    chunk: int
    splits: int
    grid: int
    stage: int = 0


def bn_stats_mode(C: int, E: int, bf16: bool, vec: bool) -> str:
    """``bn_input_stats``' mode for C channels of E values a tenant, with
    16-byte loads where ``vec`` (x 16-byte aligned) and E allow them."""
    v = _ln_load(bf16, True)
    if not vec or E % v:
        return "scalar"
    if C % v == 0:
        return "lanes"
    return {1: "packed1", 3: "packed3"}.get(C, "scalar")


def _flat_plan(what: str, T: int, P: int, C: int, bf16: bool, vec: bool,
               sms: int, blocks_per_sm: int, block_threads: int,
               block_loads: int, wave_loads: int, max_c: int
               ) -> BnStatsPlan:
    """The launch of a kernel that lays each tenant's P x C values out as
    ``bn_input_stats`` does (``BnStatsPlan``), in blocks of
    ``block_threads``: a tenant of at most ``block_loads`` loads a thread
    of one block takes the block route; a larger one S blocks, the grid T
    x S one wave of a block a SM, or two where the card holds two blocks a
    SM and each thread gets at least ``wave_loads`` loads (every block
    resident at once, as the grid barrier needs); a block a tenant where T
    exceeds the SMs. Raises for a shape the kernels do not take."""
    if min(T, P, C, blocks_per_sm) < 1 or C > max_c:
        raise ValueError(f"{what} (T={T}, P={P}, C={C}) with "
                         f"{blocks_per_sm} blocks a SM")
    E = P * C
    mode = bn_stats_mode(C, E, bf16, vec)
    v = 1 if mode == "scalar" else _ln_load(bf16, True)
    unit = 3 if mode == "packed3" else 1
    chans = {"scalar": 1, "lanes": v, "packed1": 1, "packed3": 3}[mode]
    slots = C // chans
    threads = block_threads // slots * slots
    units = E // (unit * v)
    assert units * unit * v == E
    loads = units * unit
    splits = 1
    if loads > threads * block_loads:
        splits = max(1, sms // T)
        if (blocks_per_sm >= 2
                and 2 * sms // T * threads * wave_loads <= loads):
            splits = 2 * sms // T
    chunk = _cdiv(_cdiv(units, splits), slots) * slots
    splits = _cdiv(units, chunk)
    return BnStatsPlan("grid" if splits > 1 else "block", mode, v, unit,
                       chans, slots, threads, units, chunk, splits,
                       T * splits)


@functools.lru_cache(maxsize=None)
def bn_stats_plan(T: int, P: int, C: int, bf16: bool = False,
                  vec: bool = True, sms: int = 132, blocks_per_sm: int = 2
                  ) -> BnStatsPlan:
    """``bn_input_stats``' launch for T tenants of P pixels x C channels in
    f32 or bf16, with 16-byte loads where ``vec`` (x 16-byte aligned) and
    the shape allow, on a card of ``sms`` SMs that holds ``blocks_per_sm``
    of the grid route's blocks at once (the occupancy query). A pure
    function of the shape: the wrapper calls it, and so do the CPU tests.
    A tenant of at most ``BN_STATS_BLOCK_LOADS`` loads a thread of one
    block takes the block route; a larger one S blocks, the grid T x S one
    wave of a block a SM, or two where the card holds two blocks a SM and
    each thread gets at least ``BN_STATS_WAVE_LOADS`` loads (every block
    resident at once, as the grid barrier needs); a block a tenant where T
    exceeds the SMs. Raises for a shape the kernels do not take."""
    return _flat_plan("bn_stats_plan: no statistics of", T, P, C, bf16, vec,
                      sms, blocks_per_sm, BN_STATS_THREADS,
                      BN_STATS_BLOCK_LOADS, BN_STATS_WAVE_LOADS,
                      BN_STATS_MAX_C)


def _staged(p: BnStatsPlan, sms: int, tensors: int, budget: int
            ) -> BnStatsPlan:
    """``p`` with the stage of a kernel that reads ``tensors`` tensors
    twice: on the grid route in one wave of a block a SM with 16-byte
    loads, each thread's units times their loads, 16 bytes each of each
    tensor, where that fits in ``budget`` bytes."""
    if p.route == "grid" and p.mode != "scalar" and p.grid <= sms:
        stage = _cdiv(p.chunk, p.threads) * p.unit * tensors * p.threads * 16
        if stage <= budget:
            return p._replace(stage=stage)
    return p


@functools.lru_cache(maxsize=None)
def bn_act_bwd_plan(T: int, P: int, C: int, bf16: bool = False,
                    vec: bool = True, sms: int = 132, blocks_per_sm: int = 2
                    ) -> BnStatsPlan:
    """The pool-free K3's launch (csrc/bn_act_bwd.cu: ``bn_act_bwd``, and
    ``batch_norm_bwd`` at slope 1) for T tenants of P pixels x C channels
    of da and y, in f32 or bf16, with 16-byte loads where ``vec`` (da, y
    and dy 16-byte aligned) and the shape allow, on a card of ``sms`` SMs
    that holds ``blocks_per_sm`` of the grid route's blocks at once (the
    occupancy query): ``bn_input_stats``' units, modes and routes
    (``bn_stats_plan``) with K3's constants (``BN_ACT_BWD_*``). On the grid
    route in one wave of a block a SM with 16-byte loads, a block keeps
    its packets of da and y in ``stage`` bytes of shared memory, where
    they fit in ``BN_ACT_BWD_STAGE_BYTES`` (each thread's units times their
    loads, 16 bytes each of da and y). A pure function of the shape: the
    wrappers call it, and so do the CPU tests. Raises for a shape the
    kernel does not take."""
    p = _flat_plan("bn_act_bwd_plan: no pool-free K3 of", T, P, C, bf16,
                   vec, sms, blocks_per_sm, BN_ACT_BWD_THREADS,
                   BN_ACT_BWD_BLOCK_LOADS, BN_ACT_BWD_WAVE_LOADS,
                   BN_ACT_BWD_MAX_C)
    return _staged(p, sms, 2, BN_ACT_BWD_STAGE_BYTES)


@functools.lru_cache(maxsize=None)
def bn_act_bwd_bwd_plan(T: int, P: int, C: int, bf16: bool = False,
                        vec: bool = True, sms: int = 132,
                        blocks_per_sm: int = 2) -> BnStatsPlan:
    """The pool-free K5's launch (csrc/bn_act_bwd.cu: ``bn_act_bwd_bwd``,
    and ``batch_norm_bwd_bwd`` at slope 1) for T tenants of P pixels x C
    channels of a, da and y, in f32 or bf16, with 16-byte loads where
    ``vec`` (a, da, y, g_da and g_y 16-byte aligned) and the shape allow,
    on a card of ``sms`` SMs that holds ``blocks_per_sm`` of K5's
    grid-route blocks at once (its own occupancy query): K3's units,
    modes and routes (``bn_act_bwd_plan``), the block route only up to
    ``BN_ACT_BWD_BWD_BLOCK_LOADS`` loads a thread, and a stage of a
    block's packets of a, da and y where they fit in
    ``BN_ACT_BWD_BWD_STAGE_BYTES``. A pure function of the shape: the
    wrappers call it, and so do the CPU tests. Raises for a shape the
    kernel does not take."""
    p = _flat_plan("bn_act_bwd_bwd_plan: no pool-free K5 of", T, P, C, bf16,
                   vec, sms, blocks_per_sm, BN_ACT_BWD_THREADS,
                   BN_ACT_BWD_BWD_BLOCK_LOADS, BN_ACT_BWD_WAVE_LOADS,
                   BN_ACT_BWD_MAX_C)
    return _staged(p, sms, 3, BN_ACT_BWD_BWD_STAGE_BYTES)


@functools.lru_cache(maxsize=None)
def _bn_stats_blocks_per_sm(device, bf16: bool, mode: str) -> int:
    """The occupancy query of ``bn_input_stats``' grid-route kernel."""
    fn = build.function("bn_input_stats", "bn_input_stats_blocks_per_sm",
                        (_I, _I, ctypes.POINTER(ctypes.c_int)))
    out = ctypes.c_int(0)
    with _device(device):
        rc = fn(int(bf16), BN_STATS_MODES.index(mode), ctypes.byref(out))
    build.check(rc, "bn_input_stats_blocks_per_sm")
    return out.value


@functools.lru_cache(maxsize=None)
def _bn_stats_route(device, T: int, P: int, C: int, bf16: bool,
                    vec: bool) -> BnStatsPlan:
    """``bn_stats_plan`` on ``device``'s SMs and occupancy."""
    mode = bn_stats_mode(C, P * C, bf16, vec)
    return bn_stats_plan(T, P, C, bf16, vec, _sms(device),
                         _bn_stats_blocks_per_sm(device, bf16, mode))


#: the packed arguments of csrc/bn_input_stats.cu's entry
#: (``_PACKED_EPS_ENTRY``)
_BN_STATS_ARGS = ctypes.c_longlong * 16


def bn_input_stats(x: Tensor, eps: float = F.BN_EPS
                   ) -> Tuple[Tensor, Tensor, Tensor]:
    """The block input's per-(tenant, channel) batch mean, biased variance
    and rstd, ``(T, C)`` each in x's dtype: one launch of
    csrc/bn_input_stats.cu (``bn_stats_plan``), the three outputs views of
    one allocation, the grid route's f32 scratch kept a stream
    (``_scratch``)."""
    if _on_cpu(x):
        return F.bn_input_stats(x, eps)
    name = "bn_input_stats"
    T, N, H, W, C = _check_flat(name, x)
    P = N * H * W
    bf16 = x.dtype is torch.bfloat16
    xp, device = x.data_ptr(), x.device
    plan = _bn_stats_route(device, T, P, C, bf16, xp % 16 == 0)
    out = x.new_empty((3, T, C))  # fewer host operations than torch.empty
    base, step = out.data_ptr(), T * C * (2 if bf16 else 4)
    stream = _stream(device)
    part = (_scratch(device, stream, plan.grid * 3 * C).data_ptr()
            if plan.splits > 1 else 0)
    rc = build.function("bn_input_stats", "bn_input_stats", _PACKED_EPS_ENTRY)(
        _BN_STATS_ARGS(xp, base, base + step, base + 2 * step, part, T, C,
                       P * C, bf16, plan.mode != "scalar", plan.threads,
                       plan.chunk, plan.splits, plan.grid, device.index,
                       stream),
        F.scalar_like(eps, x))
    counter = _counter(name, x)
    build.check(rc, counter)
    LAUNCHES[counter] += 1
    return out.unbind(0)


def batch_norm_fwd(x: Tensor, mean: Tensor, rstd: Tensor, gamma: Tensor,
                   beta: Tensor) -> Tensor:
    """Batch norm with the given statistics: K2's pool-free mode at slope
    1."""
    if _on_cpu(x):
        return F.batch_norm_fwd(x, mean, rstd, gamma, beta)
    return _launch_act_fwd("batch_norm_fwd", x, mean, rstd, gamma, beta, 1.0)


def batch_norm_bwd(dz: Tensor, x: Tensor, mean: Tensor, rstd: Tensor,
                   gamma: Tensor, beta: Tensor
                   ) -> Tuple[Tensor, Tensor, Tensor]:
    """The backward of batch norm through the batch statistics, ``(dx,
    dgamma, dbeta)``: K3's pool-free mode at slope 1."""
    if _on_cpu(x):
        return F.batch_norm_bwd(dz, x, mean, rstd, gamma, beta)
    return _launch_act_bwd("batch_norm_bwd", dz, x, mean, rstd, gamma, beta,
                           1.0)


def batch_norm_bwd_bwd(a: Tensor, ggamma: Tensor, gbeta: Tensor, dz: Tensor,
                       x: Tensor, mean: Tensor, rstd: Tensor, gamma: Tensor,
                       beta: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """The backward of ``batch_norm_bwd``: the gradients with respect to
    ``dz``, ``x`` and ``gamma`` (beta's is zero): K5's pool-free mode at
    slope 1."""
    if _on_cpu(x):
        return F.batch_norm_bwd_bwd(a, ggamma, gbeta, dz, x, mean, rstd,
                                    gamma, beta)
    return _launch_act_bwd_bwd("batch_norm_bwd_bwd", a, ggamma, gbeta, dz, x,
                               mean, rstd, gamma, beta, 1.0)


# -- the norm-first block's kernels: leaky-ReLU + max pool (B2) ------------------


class ActPoolPlan(NamedTuple):
    """The launches of ``act_pool_fwd``, ``act_pool_bwd`` and
    ``act_pool_gather`` at one shape (csrc/act.cu), ``threads`` a block: a
    thread takes one 2x2 window x ``items`` consecutive channels (16
    bytes, 4 f32 or 8 bf16; 1 without vectors), ``groups`` = C / items
    threads a window, the window's channel groups on consecutive threads.
    The forward and the gather run over each image's ``pooled`` (Ho, Wo)
    windows on ``fwd_blocks`` blocks; the
    backward over its ``windows`` (ceil(H / 2), ceil(W / 2)), the dropped
    odd row and column included (it writes their zeros), on
    ``bwd_blocks``. ``wide``: 64-bit index arithmetic, where y holds
    2**31 elements or more; else 32-bit."""

    threads: int
    items: int
    groups: int
    pooled: Tuple[int, int]
    windows: Tuple[int, int]
    fwd_blocks: int
    bwd_blocks: int
    wide: bool


@functools.lru_cache(maxsize=None)
def act_pool_plan(T: int, N: int, H: int, W: int, C: int, bf16: bool = False,
                  vec: bool = True) -> ActPoolPlan:
    """The launches of ``act_pool_fwd`` / ``act_pool_bwd`` /
    ``act_pool_gather`` for y ``(T, N, H, W, C)`` in f32 or bf16, with
    vectors (``vec``: C a multiple of the vector and the tensors aligned to
    it) or a channel a thread. A pure function of the shape: the three
    wrappers call it, and so do the CPU tests;
    the entries refuse a plan that does not match. Raises for a shape the
    kernels do not take (a map under 2x2: no window)."""
    items = _ln_load(bf16, vec)
    if min(T, N, C) < 1 or H < 2 or W < 2 or C % items:
        raise ValueError(f"act_pool_plan: no act-pool launch of a (T={T}, "
                         f"N={N}, {H}x{W}, C={C}) map"
                         f"{' with vectors' if vec else ''}")
    groups = C // items
    pooled = (H // 2, W // 2)
    windows = (_cdiv(H, 2), _cdiv(W, 2))
    return ActPoolPlan(
        ACT_THREADS, items, groups, pooled, windows,
        _cdiv(T * N * pooled[0] * pooled[1] * groups, ACT_THREADS),
        _cdiv(T * N * windows[0] * windows[1] * groups, ACT_THREADS),
        T * N * H * W * C >= 2 ** 31)


def act_pool_vec(C: int, bf16: bool, ptrs, argp: int) -> bool:
    """The act-pool kernels' vectors, for the pointers ``ptrs`` of their
    f32 or bf16 tensors and ``argp`` of the uint8 argmax: C a whole number
    of 16-byte vectors (4 f32, 8 bf16), every float tensor on 16 bytes and
    the argmax on a vector's channels; else a channel a thread."""
    items = _ln_load(bf16, True)
    return C % items == 0 and argp % items == 0 and all(
        q % 16 == 0 for q in ptrs)


def _check_pooled_fast(name, dpooled, argmax, y, pooled_shape) -> None:
    """``_check_pooled`` in a few host operations where it passes."""
    if (dpooled.dtype is not y.dtype or dpooled.shape != pooled_shape
            or argmax.dtype is not torch.uint8
            or argmax.shape != pooled_shape or not dpooled.is_contiguous()
            or not argmax.is_contiguous() or dpooled.device != y.device
            or argmax.device != y.device):
        _check_pooled(name, dpooled, argmax, y)


def act_pool_fwd(y: Tensor, negative_slope: float = F.LEAKY_SLOPE
                 ) -> Tuple[Tensor, Tensor]:
    """Leaky-ReLU and the 2x2 max pool; returns the pooled activation and
    the uint8 window argmax. One launch of csrc/act.cu
    (``act_pool_plan``)."""
    if _on_cpu(y):
        return F.act_pool_fwd(y, negative_slope)
    name = "act_pool_fwd"
    T, N, H, W, C = _check_flat(name, y)
    device = y.device
    shape = (T, N, H // 2, W // 2, C)
    out = torch.empty(shape, device=device, dtype=y.dtype)
    arg = torch.empty(shape, device=device, dtype=torch.uint8)
    yp, outp, argp = y.data_ptr(), out.data_ptr(), arg.data_ptr()
    bf16 = y.dtype is torch.bfloat16
    vec = act_pool_vec(C, bf16, (yp, outp), argp)
    plan = act_pool_plan(T, N, H, W, C, bf16, vec)
    args = _packed(yp, outp, argp, T, N, H, W, C, bf16, vec, plan.wide,
                   plan.fwd_blocks, device.index, _stream(device))
    rc = build.function("act", "act_pool_fwd", _ADDR_F_ENTRY)(
        args.buffer_info()[0], F.scalar_like(negative_slope, y))
    counter = _counter(name, y)
    build.check(rc, counter)
    LAUNCHES[counter] += 1
    return out, arg


def act_pool_bwd(dpooled: Tensor, argmax: Tensor, y: Tensor,
                 negative_slope: float = F.LEAKY_SLOPE) -> Tensor:
    """The backward of ``act_pool_fwd``: ``dy`` from the pooled gradient
    and the window argmax, the dropped odd row and column +0. One launch
    of csrc/act.cu (``act_pool_plan``)."""
    if _on_cpu(y):
        return F.act_pool_bwd(dpooled, argmax, y, negative_slope)
    name = "act_pool_bwd"
    T, N, H, W, C = _check_flat(name, y)
    _check_pooled_fast(name, dpooled, argmax, y, (T, N, H // 2, W // 2, C))
    device = y.device
    dy = torch.empty_like(y)  # every element written by the launch
    dp, argp, yp, dyp = (dpooled.data_ptr(), argmax.data_ptr(), y.data_ptr(),
                         dy.data_ptr())
    bf16 = y.dtype is torch.bfloat16
    vec = act_pool_vec(C, bf16, (dp, yp, dyp), argp)
    plan = act_pool_plan(T, N, H, W, C, bf16, vec)
    args = _packed(dp, argp, yp, dyp, T, N, H, W, C, bf16, vec, plan.wide,
                   plan.bwd_blocks, device.index, _stream(device))
    rc = build.function("act", "act_pool_bwd", _ADDR_F_ENTRY)(
        args.buffer_info()[0], F.scalar_like(negative_slope, y))
    counter = _counter(name, y)
    build.check(rc, counter)
    LAUNCHES[counter] += 1
    return dy


def act_pool_gather(g_dy: Tensor, argmax: Tensor, y: Tensor,
                    negative_slope: float = F.LEAKY_SLOPE) -> Tensor:
    """The adjoint of ``act_pool_bwd`` in its gradient: ``g_dy *
    leaky_relu'(y)`` at each window's argmax, in the pooled shape. One
    launch of csrc/act.cu on the forward's plan (``act_pool_plan``)."""
    if _on_cpu(y):
        return F.act_pool_gather(g_dy, argmax, y, negative_slope)
    name = "act_pool_gather"
    T, N, H, W, C = _check_flat(name, y)
    _ln_same(name, "g_dy", g_dy, y.shape, y)
    device = y.device
    shape = (T, N, H // 2, W // 2, C)
    out = torch.empty(shape, device=device, dtype=y.dtype)
    _check_pooled_fast(name, out, argmax, y, shape)
    gp, argp, yp, outp = (g_dy.data_ptr(), argmax.data_ptr(), y.data_ptr(),
                          out.data_ptr())
    bf16 = y.dtype is torch.bfloat16
    vec = act_pool_vec(C, bf16, (gp, yp, outp), argp)
    plan = act_pool_plan(T, N, H, W, C, bf16, vec)
    args = _packed(gp, yp, argp, outp, T, N, H, W, C, bf16, vec, plan.wide,
                   plan.fwd_blocks, device.index, _stream(device))
    rc = build.function("act", "act_pool_gather", _ADDR_F_ENTRY)(
        args.buffer_info()[0], F.scalar_like(negative_slope, y))
    counter = _counter(name, y)
    build.check(rc, counter)
    LAUNCHES[counter] += 1
    return out


def act_blocks(n: int, bf16: bool, vec: bool) -> int:
    """The blocks of ``act_fwd`` / ``act_bwd`` (csrc/act.cu) over n
    elements: a thread 16 bytes (4 f32 or 8 bf16 values) with ``vec``, else
    one element, ``ACT_THREADS`` a block."""
    return _cdiv(_cdiv(n, _ln_load(bf16, vec)), ACT_THREADS)


def _act_packed(ptrs, n: int, bf16: bool, vec: bool, device: int,
                stream: int) -> array.array:
    """The packed arguments of csrc/act.cu's entries: the tensors' pointers
    (y, z; or da, y, dy), then n, bf16, vec, the blocks, the device and
    the stream."""
    return _packed(*ptrs, n, bf16, vec, act_blocks(n, bf16, vec), device,
                   stream)


def act_fwd(y: Tensor, negative_slope: float = F.LEAKY_SLOPE) -> Tensor:
    """The leaky-ReLU alone (the pool-free mode): one launch of
    csrc/act.cu, flat over the tensor."""
    if _on_cpu(y):
        return F.act_fwd(y, negative_slope)
    name = "act_fwd"
    _check_flat(name, y)
    device = y.device
    z = torch.empty_like(y)  # fresh: aligned
    yp = y.data_ptr()
    args = _act_packed((yp, z.data_ptr()), y.numel(),
                       y.dtype is torch.bfloat16, yp % 16 == 0,
                       device.index, _stream(device))
    rc = build.function("act", "act_fwd", _ADDR_F_ENTRY)(
        args.buffer_info()[0], F.scalar_like(negative_slope, y))
    counter = _counter(name, y)
    build.check(rc, counter)
    LAUNCHES[counter] += 1
    return z


def act_bwd(da: Tensor, y: Tensor, negative_slope: float = F.LEAKY_SLOPE
            ) -> Tensor:
    """``da * leaky_relu'(y)`` (the pool-free mode; its own adjoint): one
    launch of csrc/act.cu, flat over the tensor."""
    if _on_cpu(y):
        return F.act_bwd(da, y, negative_slope)
    name = "act_bwd"
    _check_flat(name, y)
    _ln_same(name, "da", da, y.shape, y)
    device = y.device
    dy = torch.empty_like(y)  # fresh: aligned
    dap, yp = da.data_ptr(), y.data_ptr()
    args = _act_packed((dap, yp, dy.data_ptr()), y.numel(),
                       y.dtype is torch.bfloat16, (dap | yp) % 16 == 0,
                       device.index, _stream(device))
    rc = build.function("act", "act_bwd", _ADDR_F_ENTRY)(
        args.buffer_info()[0], F.scalar_like(negative_slope, y))
    counter = _counter(name, y)
    build.check(rc, counter)
    LAUNCHES[counter] += 1
    return dy


# -- the layer norm (B5c) ------------------------------------------------------


def _ln_same(name: str, what: str, t: Tensor, shape, x: Tensor) -> None:
    """``_check`` of ``t`` against x's device and dtype, in a few host
    operations where it passes."""
    if (t.dtype is not x.dtype or t.shape != shape or not t.is_contiguous()
            or t.device != x.device):
        _check(name, what, t, shape, x.device, x.dtype)


def _check_ln_args(name: str, x: Tensor, mean: Tensor, rstd: Tensor,
                   params: Dict[str, Tensor]) -> Tuple[int, int, int, int,
                                                       int]:
    """Check a layer norm's activation, its (T, N) statistics and its (T,
    H, W, C) parameters; returns x's shape."""
    T, N, H, W, C = _check_flat(name, x)
    _ln_same(name, "mean", mean, (T, N), x)
    _ln_same(name, "rstd", rstd, (T, N), x)
    for what, t in params.items():
        _ln_same(name, what, t, (T, H, W, C), x)
    return T, N, H, W, C


class LnStatsPlan(NamedTuple):
    """The launch of ``layer_norm_stats`` at one shape
    (csrc/layer_norm.cu): ``route`` ``"warp"`` (a warp a row,
    ``LN_WARP_ROWS`` rows a block, ``grid`` blocks) or ``"cluster"`` (a
    thread block cluster of ``cluster`` blocks a row, block r the values
    [r chunk, (r + 1) chunk) of it; ``grid`` = R x cluster); a load takes
    ``vec`` values (16 bytes, or one value)."""

    route: str
    grid: int
    cluster: int
    chunk: int
    vec: int


def _pow2_at_most(n: int) -> int:
    return 1 << (max(1, n).bit_length() - 1)


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def _ln_load(bf16: bool, vec: bool) -> int:
    """The values a layer-norm load takes: 16 bytes (4 f32, 8 bf16) with
    ``vec``, else one."""
    return (8 if bf16 else 4) if vec else 1


@functools.lru_cache(maxsize=None)
def ln_stats_plan(R: int, M: int, bf16: bool = False, vec: bool = True,
                  sms: int = 132) -> LnStatsPlan:
    """``layer_norm_stats``' launch for R rows (images) of M values, in f32
    or bf16, with 16-byte loads (``vec``: M a multiple of their values and
    x 16-byte aligned) or a value at a time, on a card of ``sms`` SMs. A
    pure function of the shape: the wrapper calls it, and so do the CPU
    tests. Rows of at most ``LN_WARP_ROW_VECS`` loads take a warp each;
    larger rows a cluster each, of as many blocks (a power of two, at most
    ``LN_MAX_CLUSTER``) as give the card two blocks a SM, but no block
    fewer than two loads a thread. Raises for a shape the kernels do not
    take."""
    v = _ln_load(bf16, vec)
    if min(R, M) < 1 or M % v:
        raise ValueError(f"ln_stats_plan: no statistics of {R} rows of {M} "
                         f"values{' with vectors' if vec else ''}")
    loads = M // v
    if loads <= LN_WARP_ROW_VECS:
        return LnStatsPlan("warp", _cdiv(R, LN_WARP_ROWS), 1, M, v)
    cluster = min(LN_MAX_CLUSTER,
                  _pow2_at_least(_cdiv(2 * sms, R)),
                  _pow2_at_most(loads // (2 * LN_THREADS)))
    return LnStatsPlan("cluster", R * cluster, cluster,
                       _cdiv(loads, cluster) * v, v)


#: the packed arguments of csrc/layer_norm.cu's entries (``_PACKED_EPS_ENTRY``)
_LN_STATS_ARGS = ctypes.c_longlong * 14
_LN_BWD_ARGS = ctypes.c_longlong * 20


def layer_norm_stats(x: Tensor, eps: float = F.LN_EPS
                     ) -> Tuple[Tensor, Tensor, Tensor]:
    """Each image's mean, population variance and rstd over its (H, W, C),
    ``(T, N)`` each, in x's dtype: one launch of csrc/layer_norm.cu
    (``ln_stats_plan``), the three outputs views of one allocation."""
    if _on_cpu(x):
        return F.layer_norm_stats(x, eps)
    name = "layer_norm_stats"
    T, N, H, W, C = _check_flat(name, x)
    R, M = T * N, H * W * C
    bf16 = x.dtype is torch.bfloat16
    xp, device = x.data_ptr(), x.device
    vec = M % _ln_load(bf16, True) == 0 and xp % 16 == 0
    plan = ln_stats_plan(R, M, bf16, vec, _sms(device))
    out = x.new_empty((3, T, N))  # fewer host operations than torch.empty
    base, step = out.data_ptr(), R * (2 if bf16 else 4)
    rc = build.function("layer_norm", "layer_norm_stats", _PACKED_EPS_ENTRY)(
        _LN_STATS_ARGS(xp, base, base + step, base + 2 * step, R, M, bf16,
                       vec, plan.route == "warp", plan.cluster, plan.chunk,
                       plan.grid, device.index, _stream(device)),
        F.scalar_like(eps, x))
    counter = _counter(name, x)
    build.check(rc, counter)
    LAUNCHES[counter] += 1
    return out.unbind(0)


class LnFwdPlan(NamedTuple):
    """The launch of ``layer_norm_fwd`` at one shape (csrc/layer_norm.cu,
    one plain launch): ``grid`` = T x N x ``tiles`` blocks of ``threads``,
    block b the tile b % tiles of image b // tiles (images in (tenant,
    image) order), a tile ``threads`` loads of ``vec`` values (16 bytes,
    or one value) of the image, gamma and beta."""

    grid: int
    threads: int
    tiles: int
    vec: int


@functools.lru_cache(maxsize=None)
def ln_fwd_plan(T: int, N: int, M: int, bf16: bool = False, vec: bool = True
                ) -> LnFwdPlan:
    """``layer_norm_fwd``'s launch for T tenants of N images of M values, in
    f32 or bf16, with 16-byte loads (``vec``: M a multiple of their values,
    and x, gamma, beta and z 16-byte aligned) or a value at a time. A pure
    function of the shape: the wrapper calls it, and so do the CPU tests.
    A thread takes one load of an image and the same load of its tenant's
    gamma and beta. Raises for a shape the kernel does not take."""
    v = _ln_load(bf16, vec)
    if min(T, N, M) < 1 or M % v:
        raise ValueError(f"ln_fwd_plan: no forward of (T={T}, N={N}) rows "
                         f"of {M} values{' with vectors' if vec else ''}")
    tiles = _cdiv(M // v, LN_THREADS)
    if T * N * tiles > 2 ** 31 - 1:
        raise ValueError(f"ln_fwd_plan: (T={T}, N={N}) rows of {M} values "
                         "exceed the launch grid")
    return LnFwdPlan(T * N * tiles, LN_THREADS, tiles, v)


def layer_norm_fwd(x: Tensor, mean: Tensor, rstd: Tensor, gamma: Tensor,
                   beta: Tensor) -> Tensor:
    """Layer norm with the given per-image statistics: ``(x - mean) * rstd
    * gamma + beta``, one launch of csrc/layer_norm.cu (``ln_fwd_plan``),
    bit for bit the twin."""
    if _on_cpu(x):
        return F.layer_norm_fwd(x, mean, rstd, gamma, beta)
    name = "layer_norm_fwd"
    T, N, H, W, C = _check_ln_args(name, x, mean, rstd,
                                   dict(gamma=gamma, beta=beta))
    M = H * W * C
    bf16 = x.dtype is torch.bfloat16
    device = x.device
    z = torch.empty_like(x)  # fresh: aligned
    xp, gp, bp = x.data_ptr(), gamma.data_ptr(), beta.data_ptr()
    vec = M % _ln_load(bf16, True) == 0 and (xp | gp | bp) % 16 == 0
    plan = ln_fwd_plan(T, N, M, bf16, vec)
    args = _ln_fwd_packed((xp, mean.data_ptr(), rstd.data_ptr(), gp, bp,
                           z.data_ptr()), T, N, M, bf16, vec, plan,
                          device.index, _stream(device))
    rc = build.function("layer_norm", "layer_norm_fwd", _ADDR_ENTRY)(
        args.buffer_info()[0])
    counter = _counter(name, x)
    build.check(rc, counter)
    LAUNCHES[counter] += 1
    return z


def _ln_fwd_packed(ptrs, T: int, N: int, M: int, bf16: bool, vec: bool,
                   plan: LnFwdPlan, device: int, stream: int
                   ) -> array.array:
    """The packed arguments of csrc/layer_norm.cu's ``layer_norm_fwd``: x,
    mean, rstd, gamma, beta and z's pointers, then T, N, M, bf16, vec, the
    plan's tiles and grid, the device and the stream."""
    return _packed(*ptrs, T, N, M, bf16, vec, plan.tiles, plan.grid, device,
                   stream)


class LnBwdPlan(NamedTuple):
    """The launch of ``layer_norm_bwd`` or ``layer_norm_bwd_bwd`` at one
    shape (csrc/layer_norm.cu, one cooperative launch): ``grid`` blocks of
    ``threads``, block b the (tenant, column tile) items [b I / grid, (b +
    1) I / grid) of the I = T x ``tiles`` items; a tile is one load of each
    of ``tpr`` threads (a row group: ``tpr * vec`` values), and a block's
    ``groups`` = threads / tpr row groups share an item's rows (row n to
    group n mod groups)."""

    grid: int
    threads: int
    tpr: int
    groups: int
    tiles: int
    vec: int


@functools.lru_cache(maxsize=None)
def ln_bwd_plan(T: int, N: int, M: int, bf16: bool = False, vec: bool = True,
                sms: int = 132, blocks_per_sm: int = 2) -> LnBwdPlan:
    """``layer_norm_bwd``'s or ``layer_norm_bwd_bwd``'s launch for T
    tenants of N rows (images) of M values, in f32 or bf16, with 16-byte
    loads (``vec``) or a value at a time, on a card of ``sms`` SMs that
    holds ``blocks_per_sm`` of the kernel's blocks at once (its occupancy
    query). A pure function of the shape: the wrappers call it, and so do
    the CPU tests. The row group is the
    power of two of threads at or above a row's loads (32 to
    ``LN_THREADS``), halved while the card would get fewer items than SMs;
    the items go in even shares to as many blocks as the card holds at
    once (every block resident, as the grid barriers need; each SM the
    same number of blocks where the items allow it). Raises for a shape
    the kernels do not take."""
    v = _ln_load(bf16, vec)
    if min(T, N, M, blocks_per_sm) < 1 or M % v:
        raise ValueError(f"ln_bwd_plan: no backward of (T={T}, N={N}) rows "
                         f"of {M} values{' with vectors' if vec else ''}")
    loads = M // v
    tpr = max(32, min(LN_THREADS, _pow2_at_least(loads)))
    while tpr > 32 and T * _cdiv(loads, tpr) < sms:
        tpr //= 2
    tiles = _cdiv(loads, tpr)
    return LnBwdPlan(min(T * tiles, sms * blocks_per_sm), LN_THREADS, tpr,
                     LN_THREADS // tpr, tiles, v)


def ln_bwd_smem(vec: int, sums: int = LN_BWD_SUMS) -> int:
    """The bytes of shared memory a ``layer_norm_bwd`` block (``sums`` 2:
    dgamma's and dbeta's row-group sums) or a ``layer_norm_bwd_bwd`` block
    (7: g_gamma's) takes (static: ``cols`` there) with loads of ``vec``
    values."""
    return 4 * (2 if sums == LN_BWD_SUMS else 1) * vec * LN_THREADS


def ln_bwd_scratch(plan: LnBwdPlan, R: int, sums: int = LN_BWD_SUMS) -> int:
    """The f32 scratch of ``layer_norm_bwd`` (``sums`` 2: each (row, sum,
    tile, warp)'s partial, then each row's two sums) or
    ``layer_norm_bwd_bwd`` (7: each row's ``LN_BWD_BWD_COEFS``
    coefficients first, 16-byte aligned, then each (row, sum, tile,
    warp)'s partial) on ``plan`` over R rows."""
    rest = sums if sums == LN_BWD_SUMS else LN_BWD_BWD_COEFS
    return R * (sums * plan.tiles * (plan.tpr // 32) + rest)


@functools.lru_cache(maxsize=None)
def _ln_bwd_blocks_per_sm(device, bf16: bool, vec: bool,
                          sums: int = LN_BWD_SUMS) -> int:
    """The occupancy query of ``layer_norm_bwd``'s kernel (``sums`` 2) or
    ``layer_norm_bwd_bwd``'s (7)."""
    fn = build.function("layer_norm", "layer_norm_bwd_blocks_per_sm",
                        (_I, _I, _I, ctypes.POINTER(ctypes.c_int)))
    out = ctypes.c_int(0)
    with _device(device):
        rc = fn(sums, int(bf16), int(vec), ctypes.byref(out))
    build.check(rc, "layer_norm_bwd_blocks_per_sm")
    return out.value


def layer_norm_bwd(dz: Tensor, x: Tensor, mean: Tensor, rstd: Tensor,
                   gamma: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """The backward of layer norm through its statistics: ``(dx, dgamma,
    dbeta)``, the parameters' gradients per tenant ``(T, H, W, C)``. One
    cooperative launch of csrc/layer_norm.cu (``ln_bwd_plan``), its f32
    scratch kept a stream (``_scratch``)."""
    if _on_cpu(x):
        return F.layer_norm_bwd(dz, x, mean, rstd, gamma)
    name = "layer_norm_bwd"
    T, N, H, W, C = _check_ln_args(name, x, mean, rstd, dict(gamma=gamma))
    _ln_same(name, "dz", dz, x.shape, x)
    R, M = T * N, H * W * C
    bf16 = x.dtype is torch.bfloat16
    device = x.device
    dx = torch.empty_like(x)
    dgamma, dbeta = torch.empty_like(gamma), torch.empty_like(gamma)
    ptrs = [t.data_ptr() for t in (dz, x, mean, rstd, gamma, dx, dgamma,
                                   dbeta)]
    # dx, dgamma and dbeta are fresh allocations: aligned
    vec = M % _ln_load(bf16, True) == 0 and (
        ptrs[0] | ptrs[1] | ptrs[4]) % 16 == 0
    plan = ln_bwd_plan(T, N, M, bf16, vec, _sms(device),
                       _ln_bwd_blocks_per_sm(device, bf16, vec))
    stream = _stream(device)
    # a (row, tile, warp)'s two partial sums, then a row's two sums
    jw = plan.tiles * (plan.tpr // 32)
    part = _scratch(device, stream, ln_bwd_scratch(plan, R)).data_ptr()
    rc = build.function("layer_norm", "layer_norm_bwd", _PACKED_EPS_ENTRY)(
        _LN_BWD_ARGS(*ptrs, part, part + 8 * R * jw, T, N, M, bf16,
                     vec, plan.tpr, plan.tiles, plan.grid, device.index,
                     stream),
        1.0 / M)
    counter = _counter(name, x)
    build.check(rc, counter)
    LAUNCHES[counter] += 1
    return dx, dgamma, dbeta


def layer_norm_bwd_bwd(a: Tensor, ggamma: Tensor, gbeta: Tensor, dz: Tensor,
                       x: Tensor, mean: Tensor, rstd: Tensor, gamma: Tensor
                       ) -> Tuple[Tensor, Tensor, Tensor]:
    """The backward of ``layer_norm_bwd``: from the cotangents of its
    ``(dx, dgamma, dbeta)``, the gradients with respect to ``dz``, ``x``
    and ``gamma``. One cooperative launch of csrc/layer_norm.cu
    (``ln_bwd_plan`` on its kernel's occupancy), g_dz and g_x views of one
    allocation, its f32 scratch kept a stream (``_scratch``)."""
    if _on_cpu(x):
        return F.layer_norm_bwd_bwd(a, ggamma, gbeta, dz, x, mean, rstd,
                                    gamma)
    name = "layer_norm_bwd_bwd"
    T, N, H, W, C = _check_ln_args(name, x, mean, rstd, dict(
        ggamma=ggamma, gbeta=gbeta, gamma=gamma))
    _ln_same(name, "a", a, x.shape, x)
    _ln_same(name, "dz", dz, x.shape, x)
    R, M = T * N, H * W * C
    bf16 = x.dtype is torch.bfloat16
    device = x.device
    grads = x.new_empty((2, *x.shape))  # g_dz, g_x: aligned where x's vectors
    g_gamma = torch.empty_like(gamma)
    ins = [t.data_ptr() for t in (a, ggamma, gbeta, dz, x, mean, rstd,
                                  gamma)]
    vec = M % _ln_load(bf16, True) == 0 and (
        ins[0] | ins[1] | ins[2] | ins[3] | ins[4] | ins[7]) % 16 == 0
    plan = ln_bwd_plan(T, N, M, bf16, vec, _sms(device),
                       _ln_bwd_blocks_per_sm(device, bf16, vec,
                                             LN_BWD_BWD_SUMS))
    stream = _stream(device)
    # each row's coefficients (a fresh buffer: aligned), then each (row,
    # sum)'s (tile, warp) partials
    tot = _scratch(device, stream,
                   ln_bwd_scratch(plan, R, LN_BWD_BWD_SUMS)).data_ptr()
    base = grads.data_ptr()
    args = _packed(*ins, base, base + x.numel() * x.element_size(),
                   g_gamma.data_ptr(), tot + 4 * LN_BWD_BWD_COEFS * R, tot,
                   T, N, M, bf16, vec, plan.tpr, plan.tiles, plan.grid,
                   device.index, stream)
    rc = build.function("layer_norm", "layer_norm_bwd_bwd", _ADDR_F_ENTRY)(
        args.buffer_info()[0], 1.0 / M)
    counter = _counter(name, x)
    build.check(rc, counter)
    LAUNCHES[counter] += 1
    g_dz, g_x = grads.unbind(0)
    return g_dz, g_x, g_gamma


# -- K4 -----------------------------------------------------------------------


class WgradPlan(NamedTuple):
    """The launch of K4 wgrad at one shape. ``kernel`` is ``"band"`` (f32
    at stride 1, csrc/conv3x3_bwd_s1.cu), ``"mma"`` (bf16 at stride 1,
    csrc/conv3x3_wgrad_s1_bf16.cu), ``"s2"`` (f32 at stride 2) or
    ``"s2_mma"`` (bf16 at stride 2, both csrc/conv3x3_wgrad_s2.cu);
    ``grid`` is the first launch's (the second sums the ``splits``
    partials of each tenant in split order). ``band_rows`` output rows of
    one image a band, ``bands`` a image; band and s2: ``kernel_rows`` (3 or
    1) a block, ``groups`` 8-channel groups a block, ``replicas`` of the
    output tile a block; mma and s2_mma: ``m_tiles`` m16 tiles of source
    channels a block (16 ``m_tiles`` channels; packed at cin <= 3, the
    packed K / 16), ``channels`` output channels a block; ``smem`` is the
    dynamic shared memory; ``scratch`` the shapes of the partials
    ``part_w`` and ``part_b``."""

    kernel: str
    grid: Tuple[int, int, int]
    threads: int
    smem: int
    splits: int
    band_rows: int
    bands: int
    kernel_rows: int
    groups: int
    replicas: int
    scratch: Tuple[Tuple[int, int, int], Tuple[int, int, int]]
    m_tiles: int = 0
    channels: int = 0

    def split_bands(self, split: int, images: int) -> range:
        """The bands (image * ``bands`` + band) that ``split`` of a tenant
        of ``images`` images sums, in the kernels' order."""
        total = images * self.bands
        return range(total * split // self.splits,
                     total * (split + 1) // self.splits)


@functools.lru_cache(maxsize=None)
def wgrad_plan(T: int, N: int, H: int, W: int, cin: int, cout: int,
               stride: int = 1, pad: int = 1, sms: int = 132,
               bf16: bool = False) -> WgradPlan:
    """K4 wgrad's launch for x ``(T, N, H, W, cin)`` and ``cout`` output
    channels on a card of ``sms`` SMs. A pure function of the shape: the
    wrapper calls it, and so do the CPU tests. f32 runs the band kernel
    (``"band"`` at stride 1, ``"s2"`` at stride 2), bf16 the mma kernel
    (``"mma"``, ``"s2_mma"``; ``_wgrad_mma_plan``).

    The band kernels (f32): a thread holds TK x 8 accumulators (TK = 9, a
    whole kernel row, at cin <= 3, else 8); a block takes all three kernel
    rows where that is at most ``WGRAD_MAX_THREADS`` threads, else one
    (three slices in ``grid[1]``), and ``replicas`` copies of its tile up
    to that many threads; bands of about ``WGRAD_BAND_PIXELS`` output
    pixels, fewer rows while the two-band ring exceeds
    ``WGRAD_RING_BYTES`` or the bands are too few for
    ``BAND_BLOCKS_PER_SM`` blocks a SM (at most a replica a pixel of a
    band); and enough splits of each tenant's bands for that many blocks,
    as far as the bands go (at stride 2 no more than keep a split's partial
    within its share of x and dy, as ``_wgrad_mma_plan``'s rule). A band
    stages its source rows: at stride 1 its
    ``band_rows + kernel_rows - 1`` rows of ``Wo + 2`` pixels; at stride 2
    its ``2 band_rows + 1`` rows (all three kernel rows) or the
    ``band_rows`` rows its outputs read (one), each of ``max(W + pad, 2 Wo
    + 1)`` pixels. A row whose band of one row needs more than
    ``BLOCK_SMEM`` raises (at cin and cout 64, rows over about 220
    pixels)."""
    Ho, Wo = F.conv_out_hw(H, W, stride, pad)
    if (min(T, N, Ho, Wo, cin, cout) < 1 or T > 65535
            or stride not in STRIDES or pad not in PADDINGS):
        raise ValueError(f"wgrad_plan: no conv3x3 wgrad of a {H}x{W} input "
                         f"at stride {stride}, pad {pad} (T={T}, N={N}, "
                         f"cin={cin}, cout={cout})")
    if bf16:
        return _wgrad_mma_plan(T, N, H, W, cin, cout, stride, pad, sms)
    TK = 9 if cin <= 3 else 8
    KGR = _cdiv(3 * cin, TK)
    NG = _cdiv(cout, 8)
    if 3 * KGR * NG <= WGRAD_MAX_THREADS:
        KH, NGB = 3, NG
    else:
        KH, NGB = 1, min(NG, WGRAD_MAX_THREADS // KGR)
        if NGB < 1:
            raise ValueError(f"wgrad_plan: cin {cin} needs more than "
                             f"{WGRAD_MAX_THREADS} threads a kernel row")
    TPR = KH * KGR * NGB
    off = (4 - pad * cin % 4) % 4
    if stride == 1:
        RS = _round4(off + (Wo + 2) * cin)

        def xrows(CR):
            return CR + KH - 1
    else:
        RS = _round4(off + max(W + pad, 2 * Wo + 1) * cin)

        def xrows(CR):
            return 2 * CR + 1 if KH == 3 else CR

    def ring(CR):
        return 2 * (_round4(xrows(CR) * RS + TK) + CR * Wo * 8 * NG) * 4

    ky = 3 // KH * _cdiv(NG, NGB)
    target = BAND_BLOCKS_PER_SM * sms
    CR = min(Ho, _cdiv(WGRAD_BAND_PIXELS, Wo))
    while CR > 1 and (ring(CR) > WGRAD_RING_BYTES
                      or T * ky * N * _cdiv(Ho, CR) < target):
        CR -= 1
    nb = _cdiv(Ho, CR)
    CR = _cdiv(Ho, nb)
    R = max(1, min(WGRAD_MAX_THREADS // TPR, CR * Wo))
    # the ring, or the replicas' tree where larger, then db's running sums
    smem = max(ring(CR), (R // 2) * TK * 8 * TPR * 4) + 8 * NG * 4
    if smem > BLOCK_SMEM:
        raise ValueError(f"wgrad_plan: a band of {Wo} pixels at cin {cin}, "
                         f"cout {cout} needs {smem} B of shared memory")
    S = max(1, min(_cdiv(target, T * ky), N * nb))
    if stride == 2:
        # as the mma plan: a split's f32 partial within its share of the
        # tenant's x and dy bytes, unless a block would then walk more than
        # WGRAD_MMA_BANDS bands (the 64 x 64 maps of 7 and 4 pixels)
        inputs = 4 * N * (H * W * cin + Ho * Wo * cout)
        partial = 4 * (9 * cin + 1) * cout
        S = max(1, min(S, max(inputs // partial,
                              _cdiv(N * nb, WGRAD_MMA_BANDS))))
    threads = _cdiv(R * TPR, 32) * 32 + 32  # and a warp for db
    return WgradPlan("band" if stride == 1 else "s2", (S, ky, T), threads,
                     smem, S, CR, nb, KH, NGB, R,
                     ((T, S, 9 * cin * cout), (T, S, cout)))


def wgrad_mma_smem(W: int, Wo: int, cin: int, band_rows: int, m_tiles: int,
                   channels: int, stride: int = 1) -> Tuple[int, int]:
    """(threads, shared memory) of a bf16 wgrad block (the geometry of
    ``wgrad_mma_geom`` in csrc/conv3x3_wgrad_s1_bf16.cu at stride 1, of
    ``s2_mma_geom`` in csrc/conv3x3_wgrad_s2.cu at stride 2) whose bands
    have ``band_rows`` rows of ``Wo`` output pixels, K over ``kpx`` band
    pixels: at stride 1 on the ``Wo + 2``-wide grid, ``kpx =
    round16(band_rows (Wo + 2))``; at stride 2 dense, ``kpx =
    round16(band_rows Wo)``. Two slots, each the band's x and its dy
    (``kpx`` pixels of ``channels`` bf16, + 8 where the n8 tiles are
    even). The taps kernel's x: at stride 1 ``kpx + 2 (Wo + 2) + 2``
    pixels with the taps' halo, at stride 2 the ``2 band_rows + 1`` source
    rows as two column planes of ``Wo + 1`` pixels each; 16 ``m_tiles`` +
    8 bf16 a pixel; then its db warps' running sums (a lane's 4 f32 a warp
    of each n8 tile). Packed at cin <= 3: the band's source rows (``band_rows
    + 2`` at stride 1, ``2 band_rows + 1`` at stride 2) of ``W`` x cin bf16
    as they lie in memory; before the slots the band's patch matrix
    (``kpx`` pixels of K + 8 bf16), and the 8 warps' f32 tiles (K x
    ``channels``) where larger than all that."""
    if stride == 1:
        Wp = Wo + 2
        kpx = _cdiv(band_rows * Wp, 16) * 16
        xpx = kpx + 2 * Wp + 2
        raw_rows = band_rows + 2
    else:
        kpx = _cdiv(band_rows * Wo, 16) * 16
        xpx = (2 * band_rows + 1) * 2 * (Wo + 1)
        raw_rows = 2 * band_rows + 1
    KC = 16 * m_tiles
    SD = channels if channels // 8 % 2 else channels + 8
    d = _cdiv(2 * kpx * SD, 16) * 16
    if cin > 3:
        x = _cdiv(2 * xpx * (KC + 8), 16) * 16
        return 32 * WGRAD_MMA_TAP_WARPS, 2 * (x + d) + 512 * channels // 8
    raw = _cdiv(2 * _cdiv(raw_rows * W * cin, 2) * 2, 16) * 16
    a = _cdiv(2 * kpx * (KC + 8), 16) * 16
    tree = 4 * WGRAD_MMA_PACKED_WARPS * KC * channels
    return 32 * WGRAD_MMA_PACKED_WARPS, max(a + 2 * (raw + d), tree)


def _wgrad_mma_tiles(cin: int, cout: int) -> Tuple[int, int, int, int]:
    """(m_tiles, source chunks, channels, output chunks) of the mma wgrad:
    the output channels in the fewest chunks of at most
    ``MMA_MAX_CHANNELS``, each 8 x an n8 tile count of ``MMA_TILES``; the
    source channels (the taps kernel) in the fewest chunks of at most
    ``WGRAD_MMA_MAX_MT`` m16 tiles with at most ``WGRAD_MMA_TILES`` tiles a
    warp (one chunk of 3 at 48 channels; two of 2 at 64), balanced; packed
    (cin <= 3) the 9 cin patch rows and the row of ones in K = 16 or 32."""
    co_chunks = _cdiv(cout, MMA_MAX_CHANNELS)
    need = _cdiv(_cdiv(cout, co_chunks), 8)
    nt = min(t for t in MMA_TILES if t >= need)
    if cin <= 3:
        return _cdiv(9 * cin + 1, 16), 1, 8 * nt, co_chunks
    m16 = _cdiv(cin, 16)
    most = min(WGRAD_MMA_MAX_MT, WGRAD_MMA_TILES // nt)
    mt = _cdiv(m16, _cdiv(m16, most))
    return mt, _cdiv(cin, 16 * mt), 8 * nt, co_chunks


def wgrad_mma_blocks_per_sm(cin: int, m_tiles: int, channels: int) -> int:
    """The blocks a SM the mma wgrad's ``__launch_bounds__`` give it: one
    for the taps kernel at ``WGRAD_MMA_ONE_BLOCK_TILES`` or more tiles a
    warp (48 and 64 channels), else ``MMA_BLOCKS_PER_SM``."""
    if cin > 3 and m_tiles * channels // 8 >= WGRAD_MMA_ONE_BLOCK_TILES:
        return 1
    return MMA_BLOCKS_PER_SM


def _wgrad_mma_plan(T, N, H, W, cin, cout, stride, pad, sms) -> WgradPlan:
    """``wgrad_plan``'s mma kernels (bf16; ``"mma"`` at stride 1,
    ``"s2_mma"`` at stride 2): the tiles of ``_wgrad_mma_tiles``; the most
    rows a band that keep a block's shared memory within its share of a SM
    (``wgrad_mma_blocks_per_sm`` blocks a SM, 1 KB reserved each:
    ``MMA_SMEM_BYTES`` at two) and the grid at that many blocks a SM,
    balanced over the image; then splits of each tenant's bands
    (``split_bands``) for as many blocks as the card holds at once (one
    wave: 16 splits a tenant at stage 1, T = 8), but no more than keep a
    split's f32 partial, (9 cin + 1) x cout, within its share of the
    tenant's x and dy bytes (the partials are written and read back)
    unless a block would then walk more than ``WGRAD_MMA_BANDS`` bands (the
    small maps: 5 splits of Omniglot's 20 images at 3 x 3), and no more
    than the bands. Every sum runs in one warp over its bands in order,
    k16 step by k16 step; the splits are summed in order by the second
    launch. A row that no block of ``BLOCK_SMEM`` holds raises."""
    Ho, Wo = F.conv_out_hw(H, W, stride, pad)
    mt, ci_chunks, channels, co_chunks = _wgrad_mma_tiles(cin, cout)
    chunks = ci_chunks * co_chunks
    bps = wgrad_mma_blocks_per_sm(cin, mt, channels)
    budget = SM_SMEM // bps - 1024
    target = bps * sms
    CR = 1
    for rows in range(2, Ho + 1):
        _, smem = wgrad_mma_smem(W, Wo, cin, rows, mt, channels, stride)
        if (smem > budget
                or T * chunks * N * _cdiv(Ho, rows) < target):
            break
        CR = rows
    nb = _cdiv(Ho, CR)
    CR = _cdiv(Ho, nb)
    threads, smem = wgrad_mma_smem(W, Wo, cin, CR, mt, channels, stride)
    if smem > BLOCK_SMEM:
        raise ValueError(f"wgrad_plan: a {Wo}-pixel output row from {cin} "
                         f"to {cout} channels does not fit a block")
    resident = max(1, min(bps, SM_SMEM // (smem + 1024))) * sms
    inputs = 2 * N * (H * W * cin + Ho * Wo * cout)
    partial = 4 * (9 * cin + 1) * cout
    S = max(1, min(N * nb, resident // (T * chunks),
                   max(inputs // partial, _cdiv(N * nb, WGRAD_MMA_BANDS))))
    return WgradPlan("mma" if stride == 1 else "s2_mma", (S, chunks, T),
                     threads, smem, S, CR, nb, 0, 0, 0,
                     ((T, S, 9 * cin * cout), (T, S, cout)), mt, channels)


class DgradPlan(NamedTuple):
    """The launch of K4 dgrad at one shape: ``kernel`` ``"band"`` (f32 at
    stride 1), ``"mma"`` (bf16 at stride 1), ``"s2"`` (f32 at stride 2) or
    ``"s2_mma"`` (bf16 at stride 2); a band kernel's block takes
    ``band_rows`` input rows of one image and all input channels, ``bands``
    a image, its threads in ``splits`` groups that split the sum over
    cout; ``smem`` its dynamic shared memory (the band with its halo and
    the two-tap weight ring, or the groups' tree where larger). An ``"s2"``
    block takes ``band_rows`` quad rows (two input rows each, ``bands`` an
    image), ``channels`` (4, or 1 at cin 1) input channels a thread, no
    split. An mma
    block walks ``grid[0]``'s share of a tenant's bands, ``channels`` input
    channels at a time (``mma_plan``, ``s2_mma_plan``)."""

    kernel: str
    grid: Tuple[int, int, int]
    threads: int
    smem: int
    band_rows: int
    bands: int
    splits: int
    channels: int = 0


@functools.lru_cache(maxsize=None)
def dgrad_plan(T: int, N: int, H: int, W: int, cin: int, cout: int,
               stride: int = 1, pad: int = 1, sms: int = 132,
               bf16: bool = False) -> DgradPlan:
    """K4 dgrad's launch for dx ``(T, N, H, W, cin)`` from a dy of ``cout``
    channels. bf16 runs the mma kernels (``mma_plan`` at stride 1, dy the
    source and dx the output; ``s2_mma_plan`` at stride 2), f32 at stride 2
    the band kernel of ``_s2_dgrad_plan``. The band kernel (f32, stride
    1): 8 pixels x 8 channels a
    thread (8 x 4 at cin <= 4); the most rows a band that keep a block at
    most ``DGRAD_MAX_THREADS`` threads and ``DGRAD_SMEM_BYTES`` of shared
    memory and the grid at ``BAND_BLOCKS_PER_SM`` blocks a SM, balanced
    over the image; then as many groups splitting the sum over cout as
    keep the block within ``DGRAD_MAX_THREADS`` threads. A row that no
    block of ``BAND_LAUNCH_BOUND`` threads and ``BLOCK_SMEM`` holds raises
    (at cin and cout 64, rows over about 220 pixels)."""
    Ho, Wo = F.conv_out_hw(H, W, stride, pad)
    if min(T, N, Ho, Wo, cin, cout) < 1 or T > 65535:
        raise ValueError(f"dgrad_plan: no conv3x3 dgrad of a {H}x{W} input "
                         f"at stride {stride}, pad {pad} (T={T}, N={N}, "
                         f"cin={cin}, cout={cout})")
    if bf16:
        m = (mma_plan(T, N, Wo, H, W, cout, cin, True, sms) if stride == 1
             else s2_mma_plan(T, N, H, W, cin, cout, pad, True, sms))
        return DgradPlan("mma" if stride == 1 else "s2_mma", m.grid,
                         m.threads, m.smem, m.band_rows, m.bands, 1,
                         m.channels)
    if stride != 1:
        return _s2_dgrad_plan(T, N, H, W, cin, cout, pad, sms,
                              1 if cin == 1 else 4)
    TN = 4 if cin <= 4 else 8
    CG = _cdiv(cin, TN)
    CP = _round4(cout)
    CP += 4 if CP // 4 % 2 == 0 else 0

    def threads(CR):
        return _cdiv(CR * W, 8) * CG

    def smem(CR):
        return ((CR + 2) * (W + 2) * CP + 2 * CG * TN * CP) * 4

    CR = 1
    for rows in range(2, H + 1):
        if (threads(rows) > DGRAD_MAX_THREADS
                or smem(rows) > DGRAD_SMEM_BYTES
                or T * N * _cdiv(H, rows) < BAND_BLOCKS_PER_SM * sms):
            break
        CR = rows
    nb = _cdiv(H, CR)
    CR = _cdiv(H, nb)
    if threads(CR) > BAND_LAUNCH_BOUND or smem(CR) > BLOCK_SMEM:
        raise ValueError(f"dgrad_plan: a {W}-pixel row at cin {cin}, cout "
                         f"{cout} does not fit a block")
    # groups splitting the sum over cout, up to the most threads (a row
    # wider than DGRAD_MAX_THREADS takes one group, up to the bound)
    KS = max(1, min(DGRAD_MAX_THREADS // threads(CR), _round4(cout) // 4))
    tree = (KS // 2) * 8 * TN * threads(CR) * 4
    return DgradPlan("band", (N * nb, 1, T), KS * threads(CR),
                     max(smem(CR), tree), CR, nb, KS)


def s2_dgrad_taps(pad: int) -> Dict[Tuple[int, int], Tuple[
        Tuple[int, int, int, int], ...]]:
    """The stride-2 dgrad's parity classes at ``pad``: for each class
    ``(ih % 2, iw % 2)`` of dx pixels, its live taps ``(kh, kw, dh, dw)``:
    dx pixel (ih, iw) takes ``dy[ih // 2 + dh, iw // 2 + dw] *
    w[kh, kw]`` (zero where that lies outside dy), in the order the tile
    summed them — ``(kh, kw)`` descending, its K = (2 - kh, 2 - kw, co) —
    which csrc/conv3x3_s2.cu keeps (``kS2Taps``, whose classes are those of
    ``ih + pad``). Input row ih reads dy row (ih + pad - kh) / 2 where that
    is an integer: kh 0 and 2 where ih + pad is even, kh 1 where it is
    odd; so the four classes take the 9 taps once between them, 4 + 2 + 2
    + 1."""
    if pad not in PADDINGS:
        raise ValueError(f"s2_dgrad_taps: pad 1 or 0, got {pad}")
    out = {}
    for ph in (0, 1):
        for pw in (0, 1):
            out[(ph, pw)] = tuple(
                (kh, kw, (ph + pad - kh) // 2, (pw + pad - kw) // 2)
                for kh in (2, 1, 0) if (ph + pad - kh) % 2 == 0
                for kw in (2, 1, 0) if (pw + pad - kw) % 2 == 0)
    return out


def _s2_dgrad_plan(T, N, H, W, cin, cout, pad, sms, channels) -> DgradPlan:
    """``dgrad_plan``'s band kernel at stride 2 (f32, csrc/conv3x3_s2.cu)
    with ``channels`` (4, or 1 at cin 1) input channels a thread. dx's pixels in
    quads (2 x 2, of ``ih + pad`` and ``iw + pad`` even and odd): ``NA =
    (H + pad + 1) // 2`` quad rows of ``NB = (W + pad + 1) // 2`` quads an
    image; a band of CR quad rows reads dy rows A0 - 1 .. A0 + CR - 1 with
    columns -1 .. NB - 1, each pixel's cout floats on a stride of cout
    (rounded up to 4, + 4 where the float4 reads would conflict); a thread
    8 quads x a channel group, the four classes one after the other; the
    two-tap weight ring of the stride-1 kernel. The most quad rows a band
    that keep a block within ``DGRAD_MAX_THREADS`` threads and
    ``DGRAD_SMEM_BYTES`` and the grid at ``BAND_BLOCKS_PER_SM`` blocks a
    SM, balanced over the image. No block splits a sum (its order is the
    tile's)."""
    NA, NB = (H + pad + 1) // 2, (W + pad + 1) // 2
    CG = _cdiv(cin, channels)
    CP = _round4(cout)
    CP += 4 if CP // 4 % 2 == 0 else 0

    def threads(CR):
        return _cdiv(CR * NB, 8) * CG

    def smem(CR):
        return ((CR + 1) * (NB + 1) * CP + 2 * CG * channels * CP) * 4

    CR = 1
    for rows in range(2, NA + 1):
        if (threads(rows) > DGRAD_MAX_THREADS
                or smem(rows) > DGRAD_SMEM_BYTES
                or T * N * _cdiv(NA, rows) < BAND_BLOCKS_PER_SM * sms):
            break
        CR = rows
    nb = _cdiv(NA, CR)
    CR = _cdiv(NA, nb)
    if threads(CR) > BAND_LAUNCH_BOUND or smem(CR) > BLOCK_SMEM:
        raise ValueError(f"dgrad_plan: a {W}-pixel stride-2 row at cin "
                         f"{cin}, cout {cout} does not fit a block")
    return DgradPlan("s2", (N * nb, 1, T), threads(CR), smem(CR), CR, nb, 1,
                     channels)


def conv3x3_dgrad(dy: Tensor, w: Tensor, stride: int = 1,
                  in_hw: Optional[Tuple[int, int]] = None,
                  padding: int = 1) -> Tensor:
    """The input gradient of the 3x3 conv at ``stride`` and ``padding``;
    ``in_hw`` is the input's (H, W), required at stride 2 and at pad 0
    (dy's size does not determine it, or not as dy's own), and dy's own at
    stride 1, pad 1. f32 runs the band kernels, bf16 the mma kernels, at
    stride 1 or 2 (``dgrad_plan``)."""
    name = _conv_name("conv3x3_dgrad", stride, padding)
    if in_hw is None:
        if stride != 1 or padding != 1:
            raise ValueError(f"{name}: in_hw is required at stride {stride}, "
                             f"pad {padding}")
        in_hw = tuple(dy.shape[2:4])
    if _on_cpu(dy):
        return F.conv3x3_dgrad(dy, w, stride=stride, in_hw=in_hw,
                               padding=padding)
    T, N, Ho, Wo, cout = _check_act(name, dy)
    if F.conv_out_hw(*in_hw, stride, padding) != (Ho, Wo):
        raise ValueError(f"{name}: the input size {in_hw} does not give "
                         f"dy's {Ho}x{Wo} at stride {stride}, pad "
                         f"{padding}")
    H, W = in_hw
    cin = w.shape[-2]
    _check(name, "w", w, (T, 3, 3, cin, cout), dy.device, dy.dtype)
    plan = dgrad_plan(T, N, H, W, cin, cout, stride, padding,
                      _sms(dy.device), dy.dtype == torch.bfloat16)
    dx = torch.empty((T, N, H, W, cin), device=dy.device, dtype=dy.dtype)
    counter = _counter(name, dy)
    with torch.cuda.device(dy.device):
        if plan.kernel == "band":
            fn = build.function("conv3x3_bwd_s1", "conv3x3_dgrad_band",
                                (_P,) * 3 + (_I,) * 11 + (_P,))
            rc = fn(_ptr(dy), _ptr(w), _ptr(dx), T, N, H, W, padding, cin,
                    cout, plan.band_rows, plan.splits, plan.threads,
                    plan.smem, _stream(dy.device))
        elif plan.kernel == "mma":
            fn = build.function("conv3x3_s1_bf16", "conv3x3_dgrad_mma",
                                (_P,) * 3 + (_I,) * 12 + (_P,))
            rc = fn(_ptr(dy), _ptr(w), _ptr(dx), T, N, H, W, padding, cin,
                    cout, plan.band_rows, plan.channels, plan.grid[0],
                    plan.threads, plan.smem, _stream(dy.device))
        elif plan.kernel == "s2":
            fn = build.function("conv3x3_s2", "conv3x3_s2_dgrad",
                                (_P,) * 3 + (_I,) * 11 + (_P,))
            rc = fn(_ptr(dy), _ptr(w), _ptr(dx), T, N, H, W, padding, cin,
                    cout, plan.band_rows, plan.channels, plan.threads,
                    plan.smem, _stream(dy.device))
        else:
            fn = build.function("conv3x3_s2", "conv3x3_s2_dgrad_mma",
                                (_P,) * 3 + (_I,) * 12 + (_P,))
            rc = fn(_ptr(dy), _ptr(w), _ptr(dx), T, N, H, W, padding, cin,
                    cout, plan.band_rows, plan.channels, plan.grid[0],
                    plan.threads, plan.smem, _stream(dy.device))
    build.check(rc, counter)
    LAUNCHES[counter] += 1
    return dx


#: the entry of each wgrad kernel (``WgradPlan.kernel``): (source stem,
#: function); every one takes the packed arguments of csrc/wgrad_reduce.cuh
_WGRAD_ENTRIES = {
    "band": ("conv3x3_bwd_s1", "conv3x3_wgrad_band"),
    "mma": ("conv3x3_wgrad_s1_bf16", "conv3x3_wgrad_mma"),
    "s2": ("conv3x3_wgrad_s2", "conv3x3_s2_wgrad_band"),
    "s2_mma": ("conv3x3_wgrad_s2", "conv3x3_s2_wgrad_mma"),
}


def conv3x3_wgrad(x: Tensor, dy: Tensor, stride: int = 1, padding: int = 1
                  ) -> Tuple[Tensor, Tensor]:
    """The weight (HWIO) and bias gradients of the 3x3 conv at ``stride``
    and ``padding``: f32 on the band kernels, bf16 on the tensor-core
    kernels, at stride 1 and 2 (``wgrad_plan``); each sums its split
    partials in a second launch of the same call."""
    if _on_cpu(x):
        return F.conv3x3_wgrad(x, dy, stride=stride, padding=padding)
    name = _conv_name("conv3x3_wgrad", stride, padding)
    T, N, H, W, cin = _check_act(name, x)
    cout = dy.shape[-1]
    Ho, Wo = _conv_out(name, H, W, stride, padding)
    _check(name, "dy", dy, (T, N, Ho, Wo, cout), x.device, x.dtype)
    device = x.device
    plan = wgrad_plan(T, N, H, W, cin, cout, stride, padding, _sms(device),
                      x.dtype == torch.bfloat16)
    # the partials part_w and part_b (plan.scratch) in one f32 allocation
    nw = T * plan.splits * 9 * cin * cout
    part = torch.empty(nw + T * plan.splits * cout, device=device)
    part_w = part.data_ptr()
    dw = torch.empty((T, 3, 3, cin, cout), device=device, dtype=x.dtype)
    db = torch.empty((T, cout), device=device, dtype=x.dtype)
    args = _packed(x.data_ptr(), dy.data_ptr(), part_w, part_w + 4 * nw,
                   dw.data_ptr(), db.data_ptr(), T, N, H, W, padding, cin,
                   cout, plan.splits, plan.band_rows, plan.kernel_rows,
                   plan.groups, plan.replicas, plan.m_tiles, plan.channels,
                   plan.threads, plan.smem, device.index, _stream(device))
    rc = build.function(*_WGRAD_ENTRIES[plan.kernel], _ADDR_ENTRY)(
        args.buffer_info()[0])
    counter = _counter(name, x)
    build.check(rc, counter)
    LAUNCHES[counter] += 1
    return dw, db


# -- global average pool --------------------------------------------------------


#: the packed arguments of csrc/global_avg_pool.cu's entries
#: (``_PACKED_ENTRY``)
_GAP_ARGS = ctypes.c_longlong * 9


def global_avg_pool2d_fwd(x: Tensor) -> Tensor:
    """The mean over H and W: ``(T, N, H, W, C) -> (T, N, C)``, one launch
    of csrc/global_avg_pool.cu."""
    if _on_cpu(x):
        return F.global_avg_pool2d(x)
    name = "global_avg_pool2d_fwd"
    T, N, H, W, C = _check_flat(name, x)
    bf16 = x.dtype is torch.bfloat16
    xp, device = x.data_ptr(), x.device
    out = x.new_empty((T, N, C))  # fresh: aligned
    vec = C % _ln_load(bf16, True) == 0 and xp % 16 == 0
    rc = build.function("global_avg_pool", "global_avg_pool_fwd",
                        _PACKED_ENTRY)(
        _GAP_ARGS(xp, out.data_ptr(), T * N, H * W, C, bf16, vec,
                  device.index, _stream(device)))
    counter = _counter(name, x)
    build.check(rc, counter)
    LAUNCHES[counter] += 1
    return out


def global_avg_pool2d_bwd(dpool: Tensor, h: int, w: int) -> Tensor:
    """The GAP's backward: ``(T, N, C) -> (T, N, h, w, C)``, each pixel
    ``dpool / (h * w)``, one launch of csrc/global_avg_pool.cu."""
    if _on_cpu(dpool):
        return F.global_avg_pool2d_bwd(dpool, h, w)
    name = "global_avg_pool2d_bwd"
    if (dpool.dtype not in _DTYPES or dpool.dim() != 3
            or not dpool.is_contiguous() or dpool.device.type != "cuda"):
        if dpool.device.type != "cuda" or dpool.dim() != 3:
            raise ValueError(f"{name}: expected a (T, N, C) CUDA tensor, "
                             f"got {tuple(dpool.shape)} on {dpool.device}")
        _check(name, "dpool", dpool, dpool.shape, dpool.device,
               kernel_dtype(name, dpool))
    T, N, C = dpool.shape
    bf16 = dpool.dtype is torch.bfloat16
    device = dpool.device
    dx = dpool.new_empty((T, N, h, w, C))  # fresh: aligned
    rc = build.function("global_avg_pool", "global_avg_pool_bwd",
                        _PACKED_ENTRY)(
        _GAP_ARGS(dpool.data_ptr(), dx.data_ptr(), T * N, h * w, C, bf16,
                  C % _ln_load(bf16, True) == 0, device.index,
                  _stream(device)))
    counter = _counter(name, dpool)
    build.check(rc, counter)
    LAUNCHES[counter] += 1
    return dx


# -- the block ------------------------------------------------------------------


class Conv3x3(torch.autograd.Function):
    """``y = conv3x3(x, w) (+ b)`` at ``stride`` and ``padding``. With
    ``with_stats`` (K1) it also returns y's batch ``(mean, var, rstd)``,
    not differentiable (BN's dependence on them is inside K3 and K5, and
    the running stats take no gradient); without, K1's stats-free mode and
    ``y`` alone."""

    @staticmethod
    def forward(ctx, x, w, b, with_stats, stride=1, padding=1):
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.padding = stride, padding
        if not with_stats:
            return conv3x3_fwd(x, w, b, stride, padding)
        y, mean, var, rstd = conv3x3_fwd_stats(x, w, b, stride=stride,
                                               padding=padding)
        ctx.mark_non_differentiable(mean, var, rstd)
        return y, mean, var, rstd

    @staticmethod
    def backward(ctx, dy, *_stats):
        x, w = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        dy = dy.contiguous()
        dx = (Dgrad.apply(dy, w, ctx.stride, tuple(x.shape[2:4]),
                          ctx.padding) if need_x else None)
        dw = db = None
        if need_w or need_b:
            dw, db = Wgrad.apply(x, dy, ctx.stride, ctx.padding)
        return (dx, dw if need_w else None, db if need_b else None, None,
                None, None)


class Dgrad(torch.autograd.Function):
    """K4 dgrad: ``dx`` (of size ``in_hw``) of the conv at ``stride`` and
    ``padding`` with weights ``w`` from ``dy``."""

    @staticmethod
    def forward(ctx, dy, w, stride=1, in_hw=None, padding=1):
        ctx.save_for_backward(dy, w)
        ctx.stride, ctx.padding = stride, padding
        return conv3x3_dgrad(dy, w, stride, in_hw, padding)

    @staticmethod
    def backward(ctx, g_dx):
        dy, w = ctx.saved_tensors
        need_dy, need_w = ctx.needs_input_grad[:2]
        g_dx = g_dx.contiguous()
        g_dy = (Conv3x3.apply(g_dx, w, None, False, ctx.stride, ctx.padding)
                if need_dy else None)
        g_w = (Wgrad.apply(g_dx, dy, ctx.stride, ctx.padding)[0] if need_w
               else None)
        return g_dy, g_w, None, None, None


class Wgrad(torch.autograd.Function):
    """K4 wgrad: ``(dw, db)`` of the conv at ``stride`` and ``padding``
    from its input ``x`` and ``dy``."""

    @staticmethod
    def forward(ctx, x, dy, stride=1, padding=1):
        ctx.save_for_backward(x, dy)
        ctx.stride, ctx.padding = stride, padding
        return conv3x3_wgrad(x, dy, stride, padding)

    @staticmethod
    def backward(ctx, g_dw, g_db):
        x, dy = ctx.saved_tensors
        need_x, need_dy = ctx.needs_input_grad[:2]
        g_dw = g_dw.contiguous()
        g_x = (Dgrad.apply(dy, g_dw, ctx.stride, tuple(x.shape[2:4]),
                           ctx.padding) if need_x else None)
        g_dy = (Conv3x3.apply(x, g_dw, g_db.contiguous(), False, ctx.stride,
                              ctx.padding) if need_dy else None)
        return g_x, g_dy, None, None


class BnActPool(torch.autograd.Function):
    """K2 on ``(y, gamma, beta)`` with K1's ``mean`` and ``rstd`` of y as
    non-differentiable companions; returns ``(pooled, argmax)``, or with
    ``pool=False`` (K2's pool-free mode) the activation alone."""

    @staticmethod
    def forward(ctx, y, gamma, beta, mean, rstd, pool=True):
        if pool:
            out, arg = bn_act_pool_fwd(y, mean, rstd, gamma, beta)
            ctx.mark_non_differentiable(arg)
        else:
            out, arg = bn_act_fwd(y, mean, rstd, gamma, beta), None
        ctx.save_for_backward(y, gamma, beta, mean, rstd, arg)
        return (out, arg) if pool else out

    @staticmethod
    def backward(ctx, dout, *_darg):
        y, gamma, beta, mean, rstd, arg = ctx.saved_tensors
        dy, dgamma, dbeta = BnActPoolBwd.apply(dout.contiguous(), arg, y,
                                               mean, rstd, gamma, beta)
        return dy, dgamma, dbeta, None, None, None


def _bn_bwd(dout, arg, y, mean, rstd, gamma, beta):
    """K3, pooled when there is a window argmax, else pool-free."""
    if arg is None:
        return bn_act_bwd(dout, y, mean, rstd, gamma, beta)
    return bn_act_pool_bwd(dout, arg, y, mean, rstd, gamma, beta)


def _bn_bwd_bwd(a, ggamma, gbeta, dout, arg, y, mean, rstd, gamma, beta):
    """K5 (through its wrapper), pooled or pool-free as ``_bn_bwd``."""
    if arg is None:
        return bn_act_bwd_bwd(a, ggamma, gbeta, dout, y, mean, rstd, gamma,
                              beta)
    return bn_act_pool_bwd_bwd(a, ggamma, gbeta, dout, arg, y, mean, rstd,
                               gamma, beta)


class BnActPoolBwd(torch.autograd.Function):
    """K3: ``(dy, dgamma, dbeta)`` through batch norm with batch
    statistics, from the pooled gradient and the window argmax, or with
    ``arg=None`` (pool-free) from the activation's gradient; its backward
    is K5 in the same mode."""

    @staticmethod
    def forward(ctx, dout, arg, y, mean, rstd, gamma, beta):
        ctx.save_for_backward(dout, arg, y, mean, rstd, gamma, beta)
        return _bn_bwd(dout, arg, y, mean, rstd, gamma, beta)

    @staticmethod
    def backward(ctx, g_dy, g_dgamma, g_dbeta):
        dout, arg, y, mean, rstd, gamma, beta = ctx.saved_tensors
        if _on_cpu(y):
            # the twin is plain ops that autograd differentiates once more;
            # statistics recomputed from y carry their dependence on y into
            # that further derivative
            mean, _, rstd = F.bn_stats(y)
            second = _bn_bwd_bwd
        else:
            second = BnActPoolBwdBwd.apply
        g_dout, g_y, g_gamma = second(
            g_dy.contiguous(), g_dgamma.contiguous(), g_dbeta.contiguous(),
            dout, arg, y, mean, rstd, gamma, beta)
        return g_dout, None, g_y, None, None, g_gamma, None


class BnActPoolBwdBwd(torch.autograd.Function):
    """K5 (pooled or pool-free) as a graph node on the card, so that a
    further derivative (the block's third, which no path takes) raises
    instead of treating K5's outputs as constants."""

    @staticmethod
    def forward(ctx, *args):
        return _bn_bwd_bwd(*args)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "the derivative of bn_act_pool_bwd_bwd / bn_act_bwd_bwd (K5), "
            "the block's third derivative, is not written"
        )


class Gap(torch.autograd.Function):
    """The global average pool ``(T, N, H, W, C) -> (T, N, C)``; its
    backward is ``GapBwd``."""

    @staticmethod
    def forward(ctx, x):
        ctx.hw = tuple(x.shape[2:4])
        return global_avg_pool2d_fwd(x)

    @staticmethod
    def backward(ctx, g):
        return GapBwd.apply(g.contiguous(), *ctx.hw)


class GapBwd(torch.autograd.Function):
    """The GAP's backward, ``(T, N, C) -> (T, N, h, w, C)``; linear, and
    its backward is ``Gap``."""

    @staticmethod
    def forward(ctx, g, h, w):
        return global_avg_pool2d_bwd(g, h, w)

    @staticmethod
    def backward(ctx, gg):
        return Gap.apply(gg.contiguous()), None, None


def function_block(x: Tensor, w: Tensor, b: Tensor, gamma: Tensor,
                   beta: Tensor, stats_impl: str = "twopass",
                   stride: int = 1, pool: bool = True, gap: bool = False,
                   padding: int = 1
                   ) -> Tuple[Tensor, Tensor, Tensor]:
    """The block as the chain of Functions: K1 (at ``stride`` and
    ``padding``: 1, or 0 for ``conv_padding=False``) then K2
    (pooled, or pool-free with ``pool=False``) and, with ``gap``, the
    global average pool; every derivative on K3-K5, the conv kernels and
    the GAP kernels. On CPU tensors each wrapper takes its twin, which is
    how the CPU tests drive this structure; ``stats_impl`` is accepted for
    the block signature and not read (the statistics are K1's)."""
    T, cout = x.shape[0], w.shape[-1]
    # gamma and beta in the activation's dtype (JAX ``batch_norm`` :430)
    gamma = gamma.to(x.dtype).expand(T, cout).contiguous()
    beta = beta.to(x.dtype).expand(T, cout).contiguous()
    y, mean, var, rstd = Conv3x3.apply(x.contiguous(), w.contiguous(),
                                       b.contiguous(), True, stride, padding)
    out = BnActPool.apply(y, gamma, beta, mean, rstd, pool)
    if pool:
        out = out[0]
    if gap:
        out = Gap.apply(out)
    return out, mean, var


def conv_bn_act_pool(x: Tensor, w: Tensor, b: Tensor, gamma: Tensor,
                     beta: Tensor, stats_impl: str = "twopass",
                     stride: int = 1, pool: bool = True, gap: bool = False,
                     padding: int = 1
                     ) -> Tuple[Tensor, Tensor, Tensor]:
    """The block, as the model calls it: the plain PyTorch composition
    (``ops.functional.conv_bn_act_pool``, differentiable by autograd) for
    CPU tensors, ``function_block`` on the kernels for CUDA tensors.

    ``x`` (T, N, H, W, cin), ``w`` (T, 3, 3, cin, cout), ``b`` (T, cout),
    ``gamma``/``beta`` (cout,) or (T, cout); the conv at ``stride`` and
    ``padding``, then the max pool when ``pool`` and the global average
    pool when ``gap``.
    Returns ``(out, batch_mean, batch_var)``. ``stats_impl`` selects the
    plain statistics pass; the kernels' Chan merge stays within tolerance
    of both.
    """
    if _on_cpu(x):
        return F.conv_bn_act_pool(x, w, b, gamma, beta, stats_impl,
                                  stride=stride, pool=pool, gap=gap,
                                  padding=padding)
    _check_block_input("conv_bn_act_pool", x, (
        "conv3x3_fwd_stats", "bn_act_pool_fwd" if pool else "bn_act_fwd",
        "bn_act_pool_bwd" if pool else "bn_act_bwd", "conv3x3_dgrad",
        "conv3x3_wgrad", "conv3x3_fwd",
        "bn_act_pool_bwd_bwd" if pool else "bn_act_bwd_bwd"),
        stride, padding, gap)
    return function_block(x, w, b, gamma, beta, stride=stride, pool=pool,
                          gap=gap, padding=padding)


def _check_block_input(name: str, x: Tensor, kernels, stride: int,
                       padding: int, gap: bool) -> None:
    """A block's input on the card: ``(T, N, H, W, C)``, and in a dtype
    that every kernel of its forward and its first and second backward
    takes (``kernels``, the conv ones at ``stride`` and ``padding``, plus
    the global average pool with ``gap``); raises ``NotImplementedError``
    naming the kernels that are f32 only, before any launch."""
    if x.dim() != 5:
        raise ValueError(
            f"{name} on CUDA takes (T, N, H, W, C), got {tuple(x.shape)}"
        )
    names = [_conv_name(k, stride, padding) if k.startswith("conv3x3")
             else k for k in kernels]
    names += ["global_avg_pool2d_fwd", "global_avg_pool2d_bwd"] if gap else []
    ok = BF16_KERNELS if x.dtype == torch.bfloat16 else ()
    missing = [k for k in names if k not in ok]
    if x.dtype != torch.float32 and missing:
        raise NotImplementedError(
            f"{name} kernels are f32 only for compute_dtype {x.dtype}: "
            f"{', '.join(missing)} have no {x.dtype} kernel yet (bf16: "
            f"{', '.join(BF16_KERNELS)})"
        )


# -- the norm-first block ---------------------------------------------------------


class BatchNorm(torch.autograd.Function):
    """Batch norm of the block input with its batch statistics:
    ``bn_input_stats`` then ``batch_norm_fwd``. Returns ``(z, mean, var,
    rstd)``; the statistics are not differentiable (batch norm's dependence
    on them is inside ``batch_norm_bwd`` and ``batch_norm_bwd_bwd``, and
    the running stats take no gradient)."""

    @staticmethod
    def forward(ctx, x, gamma, beta):
        mean, var, rstd = bn_input_stats(x)
        z = batch_norm_fwd(x, mean, rstd, gamma, beta)
        ctx.mark_non_differentiable(mean, var, rstd)
        ctx.save_for_backward(x, gamma, beta, mean, rstd)
        return z, mean, var, rstd

    @staticmethod
    def backward(ctx, dz, *_stats):
        x, gamma, beta, mean, rstd = ctx.saved_tensors
        return BatchNormBwd.apply(dz.contiguous(), x, mean, rstd, gamma,
                                  beta)


class BatchNormBwd(torch.autograd.Function):
    """``batch_norm_bwd``: ``(dx, dgamma, dbeta)`` from ``dz``; its
    backward is ``batch_norm_bwd_bwd``."""

    @staticmethod
    def forward(ctx, dz, x, mean, rstd, gamma, beta):
        ctx.save_for_backward(dz, x, mean, rstd, gamma, beta)
        return batch_norm_bwd(dz, x, mean, rstd, gamma, beta)

    @staticmethod
    def backward(ctx, g_dx, g_dgamma, g_dbeta):
        dz, x, mean, rstd, gamma, beta = ctx.saved_tensors
        if _on_cpu(x):
            # as BnActPoolBwd: statistics recomputed from x carry their
            # dependence on x into a further derivative of the twin
            mean, _, rstd = F.bn_stats(x)
            second = batch_norm_bwd_bwd
        else:
            second = BatchNormBwdBwd.apply
        g_dz, g_x, g_gamma = second(
            g_dx.contiguous(), g_dgamma.contiguous(), g_dbeta.contiguous(),
            dz, x, mean, rstd, gamma, beta)
        return g_dz, g_x, None, None, g_gamma, None


class BatchNormBwdBwd(torch.autograd.Function):
    """``batch_norm_bwd_bwd`` as a graph node on the card, so that a
    further derivative (the norm-first block's third) raises."""

    @staticmethod
    def forward(ctx, *args):
        return batch_norm_bwd_bwd(*args)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "the derivative of batch_norm_bwd_bwd (K5 at slope 1), the "
            "norm-first block's third derivative, is not written"
        )


class ActPool(torch.autograd.Function):
    """``act_pool_fwd`` on the conv output y; returns ``(pooled, argmax)``,
    or with ``pool=False`` (``act_fwd``) the activation alone."""

    @staticmethod
    def forward(ctx, y, pool=True):
        if pool:
            out, arg = act_pool_fwd(y)
            ctx.mark_non_differentiable(arg)
        else:
            out, arg = act_fwd(y), None
        ctx.save_for_backward(y, arg)
        return (out, arg) if pool else out

    @staticmethod
    def backward(ctx, dout, *_darg):
        y, arg = ctx.saved_tensors
        return ActPoolBwd.apply(dout.contiguous(), arg, y), None


class ActPoolBwd(torch.autograd.Function):
    """``act_pool_bwd`` (``act_bwd`` with ``arg=None``): dy from the pooled
    (or the activation's) gradient. Linear in it; its derivative in y is
    zero almost everywhere."""

    @staticmethod
    def forward(ctx, dout, arg, y):
        ctx.save_for_backward(arg, y)
        if arg is None:
            return act_bwd(dout, y)
        return act_pool_bwd(dout, arg, y)

    @staticmethod
    def backward(ctx, g_dy):
        arg, y = ctx.saved_tensors
        g_dy = g_dy.contiguous()
        if arg is None:
            return ActPoolBwd.apply(g_dy, None, y), None, None
        return ActPoolGather.apply(g_dy, arg, y), None, None


class ActPoolGather(torch.autograd.Function):
    """``act_pool_gather``, the adjoint of ``act_pool_bwd``; its backward
    is ``ActPoolBwd``."""

    @staticmethod
    def forward(ctx, g_dy, arg, y):
        ctx.save_for_backward(arg, y)
        return act_pool_gather(g_dy, arg, y)

    @staticmethod
    def backward(ctx, g):
        arg, y = ctx.saved_tensors
        return ActPoolBwd.apply(g.contiguous(), arg, y), None, None


def _act_pool_gap(y: Tensor, pool: bool, gap: bool) -> Tensor:
    """``ActPool`` (pooled, or pool-free with ``pool=False``) and, with
    ``gap``, the global average pool."""
    out = ActPool.apply(y, pool)
    if pool:
        out = out[0]
    if gap:
        out = Gap.apply(out)
    return out


def norm_function_block(x: Tensor, w: Tensor, b: Tensor, gamma: Tensor,
                        beta: Tensor, stats_impl: str = "twopass",
                        stride: int = 1, pool: bool = True, gap: bool = False,
                        padding: int = 1
                        ) -> Tuple[Tensor, Tensor, Tensor]:
    """The norm-first block as the chain of Functions: ``BatchNorm`` of the
    input, K1's stats-free mode with bias (at ``stride``), ``ActPool``
    (pooled, or pool-free with ``pool=False``) and, with ``gap``, the
    global average pool. On CPU tensors each wrapper takes its twin;
    ``stats_impl`` is accepted for the block signature and not read (the
    statistics are ``bn_input_stats``')."""
    T, cin = x.shape[0], x.shape[-1]
    gamma = gamma.to(x.dtype).expand(T, cin).contiguous()
    beta = beta.to(x.dtype).expand(T, cin).contiguous()
    z, mean, var, _ = BatchNorm.apply(x.contiguous(), gamma, beta)
    y = Conv3x3.apply(z, w.contiguous(), b.contiguous(), False, stride,
                      padding)
    return _act_pool_gap(y, pool, gap), mean, var


def norm_conv_act_pool(x: Tensor, w: Tensor, b: Tensor, gamma: Tensor,
                       beta: Tensor, stats_impl: str = "twopass",
                       stride: int = 1, pool: bool = True, gap: bool = False,
                       padding: int = 1
                       ) -> Tuple[Tensor, Tensor, Tensor]:
    """The norm-first block as the model calls it: the plain composition
    (``ops.functional.norm_conv_act_pool``) for CPU tensors,
    ``norm_function_block`` on the kernels for CUDA tensors. ``gamma`` and
    ``beta`` are sized to the input's channels; returns ``(out,
    batch_mean, batch_var)`` of the block input."""
    if _on_cpu(x):
        return F.norm_conv_act_pool(x, w, b, gamma, beta, stats_impl,
                                    stride=stride, pool=pool, gap=gap,
                                    padding=padding)
    _check_block_input("norm_conv_act_pool", x, (
        "bn_input_stats", "batch_norm_fwd", "batch_norm_bwd", "conv3x3_fwd",
        "act_pool_fwd" if pool else "act_fwd",
        "act_pool_bwd" if pool else "act_bwd", "conv3x3_dgrad",
        "conv3x3_wgrad", "batch_norm_bwd_bwd",
        "act_pool_gather" if pool else "act_bwd"), stride, padding, gap)
    return norm_function_block(x, w, b, gamma, beta, stride=stride,
                               pool=pool, gap=gap, padding=padding)


# -- the layer-norm blocks ----------------------------------------------------------


class LayerNorm(torch.autograd.Function):
    """Layer norm over each image's (H, W, C): ``layer_norm_stats`` then
    ``layer_norm_fwd``, gamma and beta ``(T, H, W, C)``. Returns ``z``; its
    backward is ``LayerNormBwd`` (the statistics' dependence on x is
    inside ``layer_norm_bwd`` and ``layer_norm_bwd_bwd``)."""

    @staticmethod
    def forward(ctx, x, gamma, beta):
        mean, _, rstd = layer_norm_stats(x)
        ctx.save_for_backward(x, gamma, mean, rstd)
        return layer_norm_fwd(x, mean, rstd, gamma, beta)

    @staticmethod
    def backward(ctx, dz):
        x, gamma, mean, rstd = ctx.saved_tensors
        return LayerNormBwd.apply(dz.contiguous(), x, mean, rstd, gamma)


class LayerNormBwd(torch.autograd.Function):
    """``layer_norm_bwd``: ``(dx, dgamma, dbeta)`` from ``dz``; its backward
    is ``layer_norm_bwd_bwd``."""

    @staticmethod
    def forward(ctx, dz, x, mean, rstd, gamma):
        ctx.save_for_backward(dz, x, mean, rstd, gamma)
        return layer_norm_bwd(dz, x, mean, rstd, gamma)

    @staticmethod
    def backward(ctx, g_dx, g_dgamma, g_dbeta):
        dz, x, mean, rstd, gamma = ctx.saved_tensors
        if _on_cpu(x):
            # as BnActPoolBwd: statistics recomputed from x carry their
            # dependence on x into a further derivative of the twin
            mean, _, rstd = F.image_stats(x)
            second = layer_norm_bwd_bwd
        else:
            second = LayerNormBwdBwd.apply
        g_dz, g_x, g_gamma = second(
            g_dx.contiguous(), g_dgamma.contiguous(), g_dbeta.contiguous(),
            dz, x, mean, rstd, gamma)
        return g_dz, g_x, None, None, g_gamma


class LayerNormBwdBwd(torch.autograd.Function):
    """``layer_norm_bwd_bwd`` as a graph node on the card, so that a
    further derivative (the layer-norm block's third) raises."""

    @staticmethod
    def forward(ctx, *args):
        return layer_norm_bwd_bwd(*args)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "the derivative of layer_norm_bwd_bwd, the layer-norm block's "
            "third derivative, is not written"
        )


def _ln_params(gamma: Tensor, beta: Tensor, x: Tensor
               ) -> Tuple[Tensor, Tensor]:
    """gamma and beta (``(H, W, C)`` shared, or ``(T, H, W, C)``) as the
    kernels' contiguous ``(T, H, W, C)``, in x's dtype."""
    shape = (x.shape[0], *x.shape[2:])
    return (gamma.to(x.dtype).expand(shape).contiguous(),
            beta.to(x.dtype).expand(shape).contiguous())


def conv_ln_function_block(x: Tensor, w: Tensor, b: Tensor, gamma: Tensor,
                           beta: Tensor, stats_impl: str = "twopass",
                           stride: int = 1, pool: bool = True,
                           gap: bool = False, padding: int = 1
                           ) -> Tuple[Tensor, None, None]:
    """The layer-norm block (conv first) as the chain of Functions: K1's
    stats-free mode with bias (at ``stride``), ``LayerNorm`` of the conv
    output (gamma and beta of its (H, W, C)), ``ActPool`` (pooled, or
    pool-free with ``pool=False``) and, with ``gap``, the global average
    pool. On CPU tensors each wrapper takes its twin. Returns ``(out,
    None, None)``: no running statistics."""
    y = Conv3x3.apply(x.contiguous(), w.contiguous(), b.contiguous(), False,
                      stride, padding)
    z = LayerNorm.apply(y, *_ln_params(gamma, beta, y))
    return _act_pool_gap(z, pool, gap), None, None


def ln_conv_function_block(x: Tensor, w: Tensor, b: Tensor, gamma: Tensor,
                           beta: Tensor, stats_impl: str = "twopass",
                           stride: int = 1, pool: bool = True,
                           gap: bool = False, padding: int = 1
                           ) -> Tuple[Tensor, None, None]:
    """The norm-first layer-norm block as the chain of Functions:
    ``LayerNorm`` of the input (gamma and beta of its (H, W, C)), K1's
    stats-free mode with bias, ``ActPool`` and, with ``gap``, the global
    average pool. Returns ``(out, None, None)``."""
    x = x.contiguous()
    z = LayerNorm.apply(x, *_ln_params(gamma, beta, x))
    y = Conv3x3.apply(z, w.contiguous(), b.contiguous(), False, stride,
                      padding)
    return _act_pool_gap(y, pool, gap), None, None


#: the kernels of a layer-norm block's forward and first and second
#: backward, pooled (True) or pool-free
_LN_BLOCK_KERNELS = {
    pool: ("conv3x3_fwd", "layer_norm_stats", "layer_norm_fwd",
           "layer_norm_bwd", "act_pool_fwd" if pool else "act_fwd",
           "act_pool_bwd" if pool else "act_bwd", "conv3x3_dgrad",
           "conv3x3_wgrad", "layer_norm_bwd_bwd",
           "act_pool_gather" if pool else "act_bwd") for pool in (True, False)}


def conv_ln_act_pool(x: Tensor, w: Tensor, b: Tensor, gamma: Tensor,
                     beta: Tensor, stats_impl: str = "twopass",
                     stride: int = 1, pool: bool = True, gap: bool = False,
                     padding: int = 1
                     ) -> Tuple[Tensor, None, None]:
    """The layer-norm block (conv first) as the model calls it: the plain
    composition (``ops.functional.conv_ln_act_pool``) for CPU tensors,
    ``conv_ln_function_block`` on the kernels for CUDA tensors."""
    if _on_cpu(x):
        return F.conv_ln_act_pool(x, w, b, gamma, beta, stats_impl,
                                  stride=stride, pool=pool, gap=gap,
                                  padding=padding)
    _check_block_input("conv_ln_act_pool", x, _LN_BLOCK_KERNELS[pool],
                       stride, padding, gap)
    return conv_ln_function_block(x, w, b, gamma, beta, stride=stride,
                                  pool=pool, gap=gap, padding=padding)


def ln_conv_act_pool(x: Tensor, w: Tensor, b: Tensor, gamma: Tensor,
                     beta: Tensor, stats_impl: str = "twopass",
                     stride: int = 1, pool: bool = True, gap: bool = False,
                     padding: int = 1
                     ) -> Tuple[Tensor, None, None]:
    """The norm-first layer-norm block as the model calls it: the plain
    composition (``ops.functional.ln_conv_act_pool``) for CPU tensors,
    ``ln_conv_function_block`` on the kernels for CUDA tensors."""
    if _on_cpu(x):
        return F.ln_conv_act_pool(x, w, b, gamma, beta, stats_impl,
                                  stride=stride, pool=pool, gap=gap,
                                  padding=padding)
    _check_block_input("ln_conv_act_pool", x, _LN_BLOCK_KERNELS[pool],
                       stride, padding, gap)
    return ln_conv_function_block(x, w, b, gamma, beta, stride=stride,
                                  pool=pool, gap=gap, padding=padding)


# the order of the layers each block computes (``MAMLConfig.block_order``)
# and its normalization (``MAMLConfig.norm_layer``)
for _blocks, _order, _norm in (
        ((function_block, conv_bn_act_pool), "conv_norm_relu", "batch_norm"),
        ((norm_function_block, norm_conv_act_pool), "norm_conv_relu",
         "batch_norm"),
        ((conv_ln_function_block, conv_ln_act_pool), "conv_norm_relu",
         "layer_norm"),
        ((ln_conv_function_block, ln_conv_act_pool), "norm_conv_relu",
         "layer_norm")):
    for _block in _blocks:
        _block.block_order, _block.norm_layer = _order, _norm
del _blocks, _block, _order, _norm
