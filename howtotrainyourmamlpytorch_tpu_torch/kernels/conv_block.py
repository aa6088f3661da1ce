"""Wrappers of the slice's kernels, their launch counters, and the
``autograd.Function`` that joins them into the conv -> batch-norm ->
leaky-ReLU -> max-pool block.

======================  ======  ==========================  ================
kernel                  route   source                      launches/call
======================  ======  ==========================  ================
``conv3x3_fwd_stats``   CUDA    csrc/conv3x3_fwd.cu (K1)    conv + merge: 2
``bn_act_pool_fwd``     Triton  bn_act_pool.py (K2)         1
``bn_act_pool_bwd``     Triton  bn_act_pool.py (K3)         reduce + dy: 2
``conv3x3_dgrad``       CUDA    csrc/conv3x3_bwd.cu (K4)    1
``conv3x3_wgrad``       CUDA    csrc/conv3x3_bwd.cu (K4)    wgrad + reduce: 2
======================  ======  ==========================  ================

Each wrapper takes its plain twin (``ops.functional``) for a tensor on the
CPU, and for a CUDA tensor launches its kernel or raises: it checks
device, dtype, shape and contiguity, launches on the current stream,
allocates outputs and scratch with ``torch.empty`` and adds one to its
counter per call that launched. The kernels work in f32 with FFMA only.

All tensors carry the tenant axis: activations ``(T, N, H, W, C)``
(NHWC), weights ``(T, 3, 3, cin, cout)`` (HWIO), per-channel tensors
``(T, C)``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch
from torch.autograd.function import once_differentiable

from ..ops import functional as F
from . import bn_act_pool, build

Tensor = torch.Tensor

KERNELS = (
    "conv3x3_fwd_stats",
    "bn_act_pool_fwd",
    "bn_act_pool_bwd",
    "conv3x3_dgrad",
    "conv3x3_wgrad",
)

#: launches per kernel since the last ``reset_launches()`` (CUDA only)
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}

#: output pixels per K1 tile (``kBM`` in csrc/conv3x3_tile.cuh)
CONV_TILE_ROWS = 256
#: K4 wgrad cuts each tenant's pixel axis into splits, each reduced by its
#: own blocks, so that about this many blocks per SM are in flight ...
WGRAD_BLOCKS_PER_SM = 16
#: ... while every split keeps at least this many pixels
WGRAD_MIN_SPLIT_PIXELS = 512

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


def _check(name: str, what: str, t: Tensor, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name}: {what} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(
            f"{name}: {what} must be float32 (the kernels are f32 only), "
            f"got {t.dtype}"
        )
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
    _check(name, "the activation", x, x.shape, x.device)
    return tuple(x.shape)


def _ptr(t: Tensor) -> int:
    return t.data_ptr()


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# -- K1 -----------------------------------------------------------------------


def conv3x3_fwd_stats(x: Tensor, w: Tensor, b: Tensor,
                      eps: float = F.BN_EPS
                      ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """``y = conv3x3(x, w) + b`` (stride 1, pad 1) and y's per-(tenant,
    channel) batch mean, biased variance and rstd."""
    if _on_cpu(x):
        return F.conv3x3_fwd_stats(x, w, b, eps)
    name = "conv3x3_fwd_stats"
    T, N, H, W, cin = _check_act(name, x)
    cout = w.shape[-1]
    _check(name, "w", w, (T, 3, 3, cin, cout), x.device)
    _check(name, "b", b, (T, cout), x.device)
    mtiles = -(-(N * H * W) // CONV_TILE_ROWS)
    y = torch.empty((T, N, H, W, cout), device=x.device)
    part = torch.empty((T, mtiles, 3, cout), device=x.device)
    mean, var, rstd = (torch.empty((T, cout), device=x.device)
                       for _ in range(3))
    fn = build.function("conv3x3_fwd", name,
                        (_P,) * 8 + (_I,) * 7 + (_F, _P))
    with torch.cuda.device(x.device):
        rc = fn(_ptr(x), _ptr(w), _ptr(b), _ptr(y), _ptr(part), _ptr(mean),
                _ptr(var), _ptr(rstd), T, N, H, W, cin, cout, mtiles, eps,
                _stream(x.device))
    build.check(rc, name)
    LAUNCHES[name] += 1
    return y, mean, var, rstd


# -- K2 / K3 ------------------------------------------------------------------


def _check_bn_args(name, y, tensors, device):
    T, _, _, _, C = _check_act(name, y)
    for what, t in tensors.items():
        _check(name, what, t, (T, C), device)


def bn_act_pool_fwd(y: Tensor, mean: Tensor, rstd: Tensor, gamma: Tensor,
                    beta: Tensor, negative_slope: float = F.LEAKY_SLOPE
                    ) -> Tuple[Tensor, Tensor]:
    """Normalize, affine, leaky-ReLU and 2x2 max pool; returns the pooled
    activation and the uint8 window argmax."""
    if _on_cpu(y):
        return F.bn_act_pool_fwd(y, mean, rstd, gamma, beta, negative_slope)
    name = "bn_act_pool_fwd"
    _check_bn_args(name, y, dict(mean=mean, rstd=rstd, gamma=gamma,
                                 beta=beta), y.device)
    T, N, H, W, C = y.shape
    out = torch.empty((T, N, H // 2, W // 2, C), device=y.device)
    arg = torch.empty((T, N, H // 2, W // 2, C), device=y.device,
                      dtype=torch.uint8)
    with torch.cuda.device(y.device):
        bn_act_pool.launch_fwd(y, mean, rstd, gamma, beta, out, arg,
                               negative_slope)
    LAUNCHES[name] += 1
    return out, arg


def bn_act_pool_bwd(dpooled: Tensor, argmax: Tensor, y: Tensor, mean: Tensor,
                    rstd: Tensor, gamma: Tensor, beta: Tensor,
                    negative_slope: float = F.LEAKY_SLOPE
                    ) -> Tuple[Tensor, Tensor, Tensor]:
    """The backward of ``bn_act_pool_fwd`` through batch norm with batch
    statistics; returns ``(dy, dgamma, dbeta)``."""
    if _on_cpu(y):
        return F.bn_act_pool_bwd(dpooled, argmax, y, mean, rstd, gamma, beta,
                                 negative_slope)
    name = "bn_act_pool_bwd"
    _check_bn_args(name, y, dict(mean=mean, rstd=rstd, gamma=gamma,
                                 beta=beta), y.device)
    T, N, H, W, C = y.shape
    pooled_shape = (T, N, H // 2, W // 2, C)
    _check(name, "dpooled", dpooled, pooled_shape, y.device)
    if argmax.dtype != torch.uint8 or tuple(argmax.shape) != pooled_shape \
            or not argmax.is_contiguous() or argmax.device != y.device:
        raise ValueError(
            f"{name}: argmax must be a contiguous uint8 {pooled_shape} "
            f"tensor on {y.device}"
        )
    part = torch.empty((T, bn_act_pool.SPLITS, 2, C), device=y.device)
    dy = torch.empty_like(y)
    with torch.cuda.device(y.device):
        bn_act_pool.launch_bwd(dpooled, argmax, y, mean, rstd, gamma, beta,
                               part, dy, negative_slope)
    LAUNCHES[name] += 1
    sums = part.sum(dim=1)
    return dy, sums[:, 1], sums[:, 0]


# -- K4 -----------------------------------------------------------------------


def conv3x3_dgrad(dy: Tensor, w: Tensor) -> Tensor:
    """The input gradient of the 3x3 stride-1 pad-1 conv."""
    if _on_cpu(dy):
        return F.conv3x3_dgrad(dy, w)
    name = "conv3x3_dgrad"
    T, N, H, W, cout = _check_act(name, dy)
    cin = w.shape[-2]
    _check(name, "w", w, (T, 3, 3, cin, cout), dy.device)
    dx = torch.empty((T, N, H, W, cin), device=dy.device)
    fn = build.function("conv3x3_bwd", name, (_P,) * 3 + (_I,) * 6 + (_P,))
    with torch.cuda.device(dy.device):
        rc = fn(_ptr(dy), _ptr(w), _ptr(dx), T, N, H, W, cin, cout,
                _stream(dy.device))
    build.check(rc, name)
    LAUNCHES[name] += 1
    return dx


def conv3x3_wgrad(x: Tensor, dy: Tensor) -> Tuple[Tensor, Tensor]:
    """The weight (HWIO) and bias gradients of the 3x3 conv."""
    if _on_cpu(x):
        return F.conv3x3_wgrad(x, dy)
    name = "conv3x3_wgrad"
    T, N, H, W, cin = _check_act(name, x)
    cout = dy.shape[-1]
    _check(name, "dy", dy, (T, N, H, W, cout), x.device)
    M = N * H * W
    # blocks per split: (K tiles of 64) x (channel tiles of 16) x tenants
    blocks = -(-9 * cin // 64) * -(-cout // 16) * T
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits = max(1, min(-(-WGRAD_BLOCKS_PER_SM * sms // blocks),
                        M // WGRAD_MIN_SPLIT_PIXELS, 65535 // T))
    part_w = torch.empty((T, splits, 9 * cin * cout), device=x.device)
    part_b = torch.empty((T, splits, cout), device=x.device)
    dw = torch.empty((T, 3, 3, cin, cout), device=x.device)
    db = torch.empty((T, cout), device=x.device)
    fn = build.function("conv3x3_bwd", name, (_P,) * 6 + (_I,) * 7 + (_P,))
    with torch.cuda.device(x.device):
        rc = fn(_ptr(x), _ptr(dy), _ptr(part_w), _ptr(part_b), _ptr(dw),
                _ptr(db), T, N, H, W, cin, cout, splits, _stream(x.device))
    build.check(rc, name)
    LAUNCHES[name] += 1
    return dw, db


# -- the block ------------------------------------------------------------------


class ConvBnActPool(torch.autograd.Function):
    """conv3x3 + bias -> batch norm (batch statistics) -> affine ->
    leaky-ReLU -> 2x2 max pool on the kernels: forward K1 then K2, backward
    K3 then K4.

    Outputs ``(pooled, batch_mean, batch_var)``; the statistics are not
    differentiable (they feed only the running-stat update). The backward
    is first order only (``once_differentiable``): a second-order request
    raises instead of returning wrong gradients.
    """

    @staticmethod
    def forward(ctx, x, w, b, gamma, beta):
        y, mean, var, rstd = conv3x3_fwd_stats(x, w, b)
        pooled, arg = bn_act_pool_fwd(y, mean, rstd, gamma, beta)
        ctx.save_for_backward(x, w, y, mean, rstd, arg, gamma, beta)
        ctx.mark_non_differentiable(mean, var)
        return pooled, mean, var

    @staticmethod
    @once_differentiable
    def backward(ctx, dpooled, _dmean, _dvar):
        x, w, y, mean, rstd, arg, gamma, beta = ctx.saved_tensors
        need_x, need_w, need_b, need_g, need_beta = ctx.needs_input_grad
        dy, dgamma, dbeta = bn_act_pool_bwd(
            dpooled.contiguous(), arg, y, mean, rstd, gamma, beta
        )
        dx = conv3x3_dgrad(dy, w) if need_x else None
        dw = db = None
        if need_w or need_b:
            dw, db = conv3x3_wgrad(x, dy)
        return (dx, dw if need_w else None, db if need_b else None,
                dgamma if need_g else None, dbeta if need_beta else None)


def conv_bn_act_pool(x: Tensor, w: Tensor, b: Tensor, gamma: Tensor,
                     beta: Tensor, stats_impl: str = "twopass"
                     ) -> Tuple[Tensor, Tensor, Tensor]:
    """The slice's block, as the model calls it: the plain PyTorch
    composition (``ops.functional.conv_bn_act_pool``, differentiable by
    autograd) for CPU tensors, the kernels for CUDA tensors.

    ``x`` (T, N, H, W, cin), ``w`` (T, 3, 3, cin, cout), ``b`` (T, cout),
    ``gamma``/``beta`` (cout,) or (T, cout). Returns ``(pooled,
    batch_mean, batch_var)``. ``stats_impl`` selects the plain statistics
    pass; the kernels' Chan merge stays within tolerance of both.
    """
    if _on_cpu(x):
        return F.conv_bn_act_pool(x, w, b, gamma, beta, stats_impl)
    if x.dtype != torch.float32:
        raise NotImplementedError(
            f"conv_bn_act_pool kernels are f32 only; compute_dtype "
            f"{x.dtype} (the bf16 kernels) is not ported yet"
        )
    if x.dim() != 5:
        raise ValueError(
            f"conv_bn_act_pool on CUDA takes (T, N, H, W, C), got "
            f"{tuple(x.shape)}"
        )
    T, cout = x.shape[0], w.shape[-1]
    gamma = gamma.expand(T, cout).contiguous()
    beta = beta.expand(T, cout).contiguous()
    return ConvBnActPool.apply(x.contiguous(), w.contiguous(), b.contiguous(),
                               gamma, beta)
