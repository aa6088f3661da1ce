"""Plain PyTorch versions of the JAX package's ops (``ops/functional.py``).

Layouts are the JAX package's: NHWC activations, HWIO conv weights,
``(in, out)`` linear weights. Every op takes an optional leading TENANT
axis — the JAX package's ``vmap`` over tasks written out as a batch
dimension: a 5-D activation ``(T, N, H, W, C)`` goes with tenant-batched
weights ``(T, 3, 3, cin, cout)`` and per-channel vectors ``(C,)`` (shared)
or ``(T, C)`` (per tenant). Statistics reduce over ``(N, H, W)`` of one
tenant only, never across tenants.

The second half of the module holds the plain twins of the hand-written
kernels (``kernels/conv_block.py``): the same functions, the same
arguments, in plain tensor code. The kernel wrappers use them for CPU
tensors, and the card run compares each kernel with its twin.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as tF

Tensor = torch.Tensor

BN_EPS = 1e-5
LN_EPS = 1e-5
LEAKY_SLOPE = 0.01


def bcast(v: Tensor, x: Tensor) -> Tensor:
    """``v``, an operand that a differentiated op broadcasts against ``x``
    (a bias, gamma, beta, a batch or layer mean or rstd): returned as it
    is, so its gradient is PyTorch's f32-accumulated sum over the broadcast
    axes, on every device, as XLA sums it on an accelerator and as the
    kernels do. The one seam where such a sum is taken: the CPU parity
    tests against the JAX package swap in XLA:CPU's bf16 sum here."""
    del x
    return v


def _per_channel(v: Tensor, x: Tensor) -> Tensor:
    """Broadcast a per-channel vector against an NHWC activation: ``(C,)``
    as is, a per-tenant ``(T, C)`` against a 5-D ``x`` as
    ``(T, 1, 1, 1, C)`` (``bcast``)."""
    if v.dim() == 2:
        v = v.reshape(v.shape[0], *([1] * (x.dim() - 2)), v.shape[1])
    return bcast(v, x)


def _stat_dims(x: Tensor) -> Tuple[int, ...]:
    """The (N, H, W) axes of an NHWC activation, with or without the
    tenant axis in front."""
    return (1, 2, 3) if x.dim() == 5 else (0, 1, 2)


def at_least_f32(x: Tensor) -> Tensor:
    """``x`` in f32, or as it is when it is wider: an f64 reference run
    stays f64 end to end."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


@functools.lru_cache(maxsize=None)
def _rounded(v: float, dtype: torch.dtype) -> float:
    return torch.tensor(v, dtype=dtype).item()


def scalar_like(v: float, x: Tensor) -> float:
    """The Python scalar ``v`` rounded to ``x``'s dtype, as a weakly typed
    scalar meets an array in JAX: ``0.01 * x`` on a bf16 ``x`` multiplies by
    bf16(0.01) = 0.010009765625, and ``var + 1e-5`` adds bf16(1e-5). PyTorch
    would carry the scalar in f32 into a bf16 op; in f32 and f64 the value
    is what PyTorch uses anyway."""
    return _rounded(float(v), x.dtype)


class _Bf16Div(torch.autograd.Function):
    """``x / y`` of bf16 tensors whose gradient is JAX's in bf16 ops, the
    transpose of its ``div`` rule: ``g / y`` for x and ``-((g * (1 / (y *
    y))) * x)`` for y (``integer_pow(y, -2)``, each op rounded). PyTorch's
    own rule for y, ``-g * ((x / y) / y)``, rounds otherwise, and
    second-order MAML differentiates the quotient in ``_Bf16Rsqrt``'s
    derivative."""

    @staticmethod
    def forward(ctx, x, y):
        ctx.save_for_backward(x, y)
        return x / y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return g / y, -((g * (1 / (y * y))) * x)


class _Bf16Rsqrt(torch.autograd.Function):
    """``lax.rsqrt`` of a bf16 tensor: the f32 rsqrt, rounded once
    (PyTorch's own bf16 rsqrt on the CPU is off by an ulp at times); its
    derivative JAX's, in bf16 ops: ``g * (-0.5 * (r / v))``, the quotient
    differentiated by JAX's rule too (``_Bf16Div``)."""

    @staticmethod
    def forward(ctx, v):
        r = torch.rsqrt(v.float()).to(v.dtype)
        ctx.save_for_backward(v, r)
        return r

    @staticmethod
    def backward(ctx, g):
        v, r = ctx.saved_tensors
        return g * (-0.5 * _Bf16Div.apply(r, v))


def rsqrt_eps(var: Tensor, eps: float, kernel_form: bool = False
              ) -> Tensor:
    """``rsqrt(var + eps)`` in var's dtype. In bf16 ``lax.rsqrt`` of the
    bf16 sum (``eps`` rounded to bf16, ``_Bf16Rsqrt``). In f32 and f64
    ``torch.rsqrt``, or with ``kernel_form`` ``1 / sqrt``, the kernels'
    form."""
    v = var + scalar_like(eps, var)
    if var.dtype == torch.bfloat16:
        return _Bf16Rsqrt.apply(v)
    return 1.0 / torch.sqrt(v) if kernel_form else torch.rsqrt(v)


def im2col(x: Tensor, kh: int, kw: int, stride: int, padding: int) -> Tensor:
    """Conv patches ``(..., H, W, C) -> (..., Ho, Wo, kh*kw*C)``, the K
    order (kh, kw, cin) of the JAX package's ``_im2col``."""
    if padding:
        x = tF.pad(x, (0, 0, padding, padding, padding, padding))
    hp, wp = x.shape[-3], x.shape[-2]
    ho = (hp - kh) // stride + 1
    wo = (wp - kw) // stride + 1
    cols = [
        x[..., i:i + (ho - 1) * stride + 1:stride,
          j:j + (wo - 1) * stride + 1:stride, :]
        for i in range(kh) for j in range(kw)
    ]
    return torch.cat(cols, dim=-1)


def conv2d(x: Tensor, w: Tensor, b: Optional[Tensor], stride: int = 1,
           padding: int = 1) -> Tensor:
    """2-D convolution NHWC x HWIO -> NHWC as patches @ weights (the JAX
    package's ``im2col`` lowering)."""
    kh, kw, cin, cout = w.shape[-4:]
    patches = im2col(x, kh, kw, stride, padding)
    if x.dim() == 5:
        t = x.shape[0]
        out = torch.matmul(
            patches.reshape(t, -1, kh * kw * cin),
            w.to(x.dtype).reshape(t, kh * kw * cin, cout),
        ).reshape(*patches.shape[:-1], cout)
    else:
        out = patches @ w.to(x.dtype).reshape(kh * kw * cin, cout)
    if b is not None:
        out = out + _per_channel(b.to(out.dtype), out)
    return out


def batch_stats(x: Tensor, stats_impl: str = "twopass"
                ) -> Tuple[Tensor, Tensor]:
    """Batch mean and biased variance over (N, H, W) per channel.

    ``'twopass'``: mean, then the mean of squared deviations from it, as
    ``jnp.mean`` and ``jnp.var``: in f32 (f64 stays f64) about the f32
    mean, each rounded once to x's dtype (a bf16 ``x``'s variance is not
    the bf16-centred one). ``'fused'``: sum and sum of squares in f32,
    ``var = E[x^2] - E[x]^2`` clamped at 0.
    """
    dims = _stat_dims(x)
    if stats_impl == "fused":
        x32 = at_least_f32(x)
        n = 1
        for d in dims:
            n *= x.shape[d]
        mean32 = x32.sum(dims) / n
        var32 = torch.clamp((x32 * x32).sum(dims) / n - mean32 * mean32,
                            min=0.0)
        return mean32.to(x.dtype), var32.to(x.dtype)
    if stats_impl != "twopass":
        raise ValueError(
            f"stats_impl must be 'twopass' or 'fused', got {stats_impl!r}"
        )
    # each statistic converts x itself, and the variance centres on its
    # own f32 mean, as jnp.mean and jnp.var do: in bf16 their gradients
    # reach x as two bf16 cotangents
    mean = at_least_f32(x).mean(dims).to(x.dtype)
    x32 = at_least_f32(x)
    var = ((x32 - x32.mean(dims, keepdim=True)) ** 2).mean(dims)
    return mean, var.to(x.dtype)


def running_update(running_mean: Tensor, running_var: Tensor, mean: Tensor,
                   var: Tensor, n: int, momentum: float = 0.1
                   ) -> Tuple[Tensor, Tensor]:
    """torch's running-stat rule: ``new = (1 - m) * old + m * batch``, with
    the UNBIASED batch variance feeding the running variance (the factor
    rounded to var's dtype: 1.0 in bf16 for n above ~256, as in JAX)."""
    unbiased = var * scalar_like(n / max(n - 1, 1), var)
    new_mean = (1.0 - momentum) * running_mean + momentum * mean.to(
        running_mean.dtype)
    new_var = (1.0 - momentum) * running_var + momentum * unbiased.to(
        running_var.dtype)
    return new_mean, new_var


def batch_norm(x: Tensor, gamma: Tensor, beta: Tensor,
               running_mean: Optional[Tensor], running_var: Optional[Tensor],
               momentum: float = 0.1, eps: float = BN_EPS,
               stats_impl: str = "twopass"
               ) -> Tuple[Tensor, Optional[Tensor], Optional[Tensor]]:
    """Batch norm with batch statistics (always — the reference's
    ``training=True`` call); the running stats are updated but never
    normalize anything. Returns ``(y, new_mean, new_var)``."""
    mean, var = batch_stats(x, stats_impl)
    inv = rsqrt_eps(var, eps)
    y = (x - _per_channel(mean, x)) * _per_channel(inv, x)
    y = y * _per_channel(gamma.to(x.dtype), x) + _per_channel(
        beta.to(x.dtype), x)
    new_mean = new_var = None
    if running_mean is not None:
        n = 1
        for d in _stat_dims(x):
            n *= x.shape[d]
        new_mean, new_var = running_update(
            running_mean, running_var, mean, var, n, momentum
        )
    return y, new_mean, new_var


def _ln_param(v: Tensor, x: Tensor) -> Tensor:
    """Broadcast a layer-norm parameter against an NHWC activation: ``(H, W,
    C)`` as is, a per-tenant ``(T, H, W, C)`` against a 5-D ``x`` as
    ``(T, 1, H, W, C)``."""
    if v.dim() == 4 and x.dim() == 5:
        return v.unsqueeze(1)
    return v


def layer_norm(x: Tensor, gamma: Tensor, beta: Tensor, eps: float = LN_EPS
               ) -> Tensor:
    """Layer norm over each image's (H, W, C), the JAX package's
    ``layer_norm``: the mean and the population variance (two passes, as
    ``jnp.mean`` and ``jnp.var``: in f32, each rounded once to x's dtype)
    per sample, ``(x - mean) * rsqrt(var + eps)``, times ``gamma`` plus
    ``beta``, both elementwise ``(H, W, C)`` (or per tenant ``(T, H, W,
    C)``)."""
    dims = (-3, -2, -1)
    mean = at_least_f32(x).mean(dims, keepdim=True).to(x.dtype)
    x32 = at_least_f32(x)
    var = ((x32 - x32.mean(dims, keepdim=True)) ** 2).mean(
        dims, keepdim=True).to(x.dtype)
    y = (x - bcast(mean, x)) * bcast(rsqrt_eps(var, eps), x)
    return (y * bcast(_ln_param(gamma.to(x.dtype), x), x)
            + bcast(_ln_param(beta.to(x.dtype), x), x))


def leaky_relu(x: Tensor, negative_slope: float = LEAKY_SLOPE) -> Tensor:
    """``where(x >= 0, x, slope * x)``, as ``jax.nn.leaky_relu`` (the slope
    rounded to x's dtype)."""
    return torch.where(x >= 0, x, scalar_like(negative_slope, x) * x)


def conv_bn_act(x: Tensor, w: Tensor, b: Optional[Tensor], gamma: Tensor,
                beta: Tensor, running_mean: Optional[Tensor],
                running_var: Optional[Tensor], stride: int = 1,
                padding: int = 1, negative_slope: float = LEAKY_SLOPE,
                bn_stats_impl: str = "twopass"
                ) -> Tuple[Tensor, Optional[Tensor], Optional[Tensor]]:
    """conv -> bias -> batch norm -> leaky-ReLU; returns
    ``(activation, new_running_mean, new_running_var)``."""
    out = conv2d(x, w, b, stride, padding)
    out, new_mean, new_var = batch_norm(
        out, gamma, beta, running_mean, running_var,
        stats_impl=bn_stats_impl,
    )
    return leaky_relu(out, negative_slope), new_mean, new_var


def max_pool2d(x: Tensor, window: int = 2, stride: int = 2) -> Tensor:
    """2x2/2 max pool, NHWC, VALID: a trailing odd row or column is
    dropped (the JAX package's ``reshape`` lowering)."""
    if window != stride:
        raise NotImplementedError("only window == stride pooling is ported")
    h, w, c = x.shape[-3:]
    ho, wo = h // window, w // window
    x = x[..., :ho * window, :wo * window, :]
    x = x.reshape(*x.shape[:-3], ho, window, wo, window, c)
    return x.amax(dim=-2).amax(dim=-3)


def linear(x: Tensor, w: Tensor, b: Optional[Tensor]) -> Tensor:
    """``x @ w + b`` with ``w`` of shape (in, out), or ``(T, in, out)``
    against a ``(T, batch, in)`` activation."""
    out = torch.matmul(x, w.to(x.dtype))
    if b is not None:
        b = b.to(out.dtype)
        out = out + bcast(b[:, None, :] if b.dim() == 2 else b, out)
    return out


def cross_entropy(logits: Tensor, labels: Tensor) -> Tensor:
    """Mean softmax cross-entropy over the batch axis, in f32 (f64 for f64
    logits): a scalar for ``(batch, classes)`` logits, ``(T,)`` for
    ``(T, batch, classes)``."""
    logp = torch.log_softmax(at_least_f32(logits), dim=-1)
    nll = -torch.gather(logp, -1, labels.long().unsqueeze(-1)).squeeze(-1)
    return nll.mean(dim=-1)


def accuracy(logits: Tensor, labels: Tensor) -> Tensor:
    """Per-sample correctness as float."""
    return (torch.argmax(logits, dim=-1) == labels.long()).float()


def global_avg_pool2d(x: Tensor) -> Tensor:
    """Mean over H and W of an NHWC activation: ``(..., N, H, W, C) ->
    (..., N, C)``, the JAX package's ``global_avg_pool2d`` (``(N, 1, 1,
    C)``) reshaped to its features as ``vgg.apply`` does."""
    return x.mean(dim=(-3, -2))


def _act_pool_gap(y: Tensor, negative_slope: float, pool: bool, gap: bool
                  ) -> Tensor:
    """The block's tail: leaky-ReLU, then the 2x2 max pool when ``pool``
    and the global average pool when ``gap``."""
    out = leaky_relu(y, negative_slope)
    if pool:
        out = max_pool2d(out)
    if gap:
        out = global_avg_pool2d(out)
    return out


def conv_bn_act_pool(x: Tensor, w: Tensor, b: Tensor, gamma: Tensor,
                     beta: Tensor, stats_impl: str = "twopass",
                     eps: float = BN_EPS,
                     negative_slope: float = LEAKY_SLOPE, stride: int = 1,
                     pool: bool = True, gap: bool = False, padding: int = 1
                     ) -> Tuple[Tensor, Tensor, Tensor]:
    """The model's block in plain ops, differentiable by autograd: 3x3 conv
    (``stride``, ``padding``: 1, or 0 for ``conv_padding=False``) + bias
    -> batch norm -> leaky-ReLU, then the 2x2 max pool when ``pool`` (the
    max-pooling model) and the global average pool when ``gap`` (the last
    block of the strided model).

    Returns ``(out, batch_mean, batch_var)``; the statistics are detached
    (they only feed the running-stat update, which no gradient reads)."""
    y = conv2d(x, w, b, stride, padding)
    mean, var = batch_stats(y, stats_impl)
    inv = rsqrt_eps(var, eps)
    z = (y - _per_channel(mean, y)) * _per_channel(inv, y)
    z = z * _per_channel(gamma.to(y.dtype), y) + _per_channel(
        beta.to(y.dtype), y)
    out = _act_pool_gap(z, negative_slope, pool, gap)
    return out, mean.detach(), var.detach()


def norm_conv_act_pool(x: Tensor, w: Tensor, b: Tensor, gamma: Tensor,
                       beta: Tensor, stats_impl: str = "twopass",
                       eps: float = BN_EPS,
                       negative_slope: float = LEAKY_SLOPE, stride: int = 1,
                       pool: bool = True, gap: bool = False, padding: int = 1
                       ) -> Tuple[Tensor, Tensor, Tensor]:
    """The norm-first block (``block_order='norm_conv_relu'``) in plain
    ops, differentiable by autograd: batch norm of the block INPUT (gamma
    and beta sized to its channels) -> 3x3 conv (``stride``, ``padding``)
    + bias
    -> leaky-ReLU, then the 2x2 max pool when ``pool`` and the global
    average pool when ``gap`` (the JAX package's ``models/vgg.py`` :271,
    :288, :300, :302, :304-305).

    Returns ``(out, batch_mean, batch_var)`` of the block input, detached,
    as ``conv_bn_act_pool`` returns the conv output's."""
    mean, var = batch_stats(x, stats_impl)
    inv = rsqrt_eps(var, eps)
    z = (x - _per_channel(mean, x)) * _per_channel(inv, x)
    z = z * _per_channel(gamma.to(x.dtype), x) + _per_channel(
        beta.to(x.dtype), x)
    out = _act_pool_gap(conv2d(z, w, b, stride, padding), negative_slope,
                        pool, gap)
    return out, mean.detach(), var.detach()


def conv_ln_act_pool(x: Tensor, w: Tensor, b: Tensor, gamma: Tensor,
                     beta: Tensor, stats_impl: str = "twopass",
                     eps: float = LN_EPS,
                     negative_slope: float = LEAKY_SLOPE, stride: int = 1,
                     pool: bool = True, gap: bool = False, padding: int = 1
                     ) -> Tuple[Tensor, None, None]:
    """The layer-norm block (``norm_layer='layer_norm'``, conv first) in
    plain ops, differentiable by autograd: 3x3 conv (``stride``,
    ``padding``) +
    bias -> layer norm over each image's (H, W, C) of the conv output
    (gamma and beta ``(H, W, C)`` of that shape) -> leaky-ReLU, then the
    2x2 max pool when ``pool`` and the global average pool when ``gap``
    (the JAX package's ``models/vgg.py`` :255-262, :300-305).

    Returns ``(out, None, None)``: layer norm keeps no running statistics
    (``stats_impl`` is accepted for the block signature and not read)."""
    y = layer_norm(conv2d(x, w, b, stride, padding), gamma, beta, eps)
    return _act_pool_gap(y, negative_slope, pool, gap), None, None


def ln_conv_act_pool(x: Tensor, w: Tensor, b: Tensor, gamma: Tensor,
                     beta: Tensor, stats_impl: str = "twopass",
                     eps: float = LN_EPS,
                     negative_slope: float = LEAKY_SLOPE, stride: int = 1,
                     pool: bool = True, gap: bool = False, padding: int = 1
                     ) -> Tuple[Tensor, None, None]:
    """The norm-first layer-norm block (``block_order='norm_conv_relu'``,
    ``norm_layer='layer_norm'``) in plain ops: layer norm of the block
    INPUT (gamma and beta of its (H, W, C)) -> 3x3 conv (``stride``,
    ``padding``) + bias ->
    leaky-ReLU -> (2x2 max pool) -> (global average pool) (JAX
    ``models/vgg.py`` :271, :288, :300-305). Returns ``(out, None,
    None)``."""
    y = conv2d(layer_norm(x, gamma, beta, eps), w, b, stride, padding)
    return _act_pool_gap(y, negative_slope, pool, gap), None, None


# the order of the layers each block computes (``MAMLConfig.block_order``)
# and its normalization (``MAMLConfig.norm_layer``)
for _block, _order, _norm in (
        (conv_bn_act_pool, "conv_norm_relu", "batch_norm"),
        (norm_conv_act_pool, "norm_conv_relu", "batch_norm"),
        (conv_ln_act_pool, "conv_norm_relu", "layer_norm"),
        (ln_conv_act_pool, "norm_conv_relu", "layer_norm")):
    _block.block_order, _block.norm_layer = _order, _norm
del _block, _order, _norm


# -- plain twins of the hand-written kernels ----------------------------------
#
# All take the tenant axis: x/y (T, N, H, W, C) f32 or bf16, w (T, 3, 3,
# cin, cout), per-channel tensors (T, C). In bf16 (``compute_dtype=
# 'bfloat16'``) the forwards round to bf16 after every op, as the JAX
# package's bf16 graph does (gamma and beta cast to the activation's dtype,
# the statistics ``batch_stats``', the slope and eps rounded to bf16); the
# backwards compute in f32 from the bf16 inputs, the masks taken from the
# bf16 forward's values, and round each output once.


def bn_stats(y: Tensor, eps: float = BN_EPS) -> Tuple[Tensor, Tensor, Tensor]:
    """y's per-(tenant, channel) batch mean, biased variance (two passes)
    and ``rstd = rsqrt(var + eps)`` (``rsqrt_eps``)."""
    mean, var = batch_stats(y, "twopass")
    return mean, var, rsqrt_eps(var, eps, kernel_form=True)


def conv3x3_fwd_stats(x: Tensor, w: Tensor, b: Tensor, eps: float = BN_EPS,
                      stride: int = 1, padding: int = 1
                      ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Twin of K1: ``y = conv3x3(x, w) + b`` (``stride``, ``padding``) and
    y's per-(tenant, channel) batch mean, biased variance and
    ``rstd = 1 / sqrt(var + eps)``."""
    y = conv2d(x, w, b, stride, padding)
    return (y, *bn_stats(y, eps))


def conv3x3(x: Tensor, w: Tensor, b: Optional[Tensor] = None,
            stride: int = 1, padding: int = 1) -> Tensor:
    """Twin of K1's stats-free mode: ``y = conv3x3(x, w) (+ b)``."""
    return conv2d(x, w, b, stride, padding)


def _windows(a: Tensor) -> Tensor:
    """``(T, N, H, W, C) -> (T, N, H//2, W//2, C, 4)``: each 2x2 window's
    elements in the order ``2 * dh + dw`` (odd trailing row/col dropped)."""
    t, n, h, w, c = a.shape
    ho, wo = h // 2, w // 2
    a = a[:, :, :2 * ho, :2 * wo, :].reshape(t, n, ho, 2, wo, 2, c)
    return a.permute(0, 1, 2, 4, 6, 3, 5).reshape(t, n, ho, wo, c, 4)


def _affine_act(y: Tensor, mean: Tensor, rstd: Tensor, gamma: Tensor,
                beta: Tensor) -> Tuple[Tensor, Tensor]:
    """``(xhat, z)`` with ``xhat = (y - mean) * rstd`` and
    ``z = xhat * gamma + beta``, every operand in y's dtype."""

    def pc(v):
        return _per_channel(v.to(y.dtype), y)

    xhat = (y - pc(mean)) * pc(rstd)
    return xhat, xhat * pc(gamma) + pc(beta)


def _f32(*tensors: Tensor) -> Tuple[Tensor, ...]:
    return tuple(at_least_f32(t) for t in tensors)


def bn_act_fwd(y: Tensor, mean: Tensor, rstd: Tensor, gamma: Tensor,
               beta: Tensor, negative_slope: float = LEAKY_SLOPE) -> Tensor:
    """Twin of K2's pool-free mode: normalize, affine and leaky-ReLU."""
    _, z = _affine_act(y, mean, rstd, gamma, beta)
    return leaky_relu(z, negative_slope)


def bn_act_pool_fwd(y: Tensor, mean: Tensor, rstd: Tensor, gamma: Tensor,
                    beta: Tensor, negative_slope: float = LEAKY_SLOPE
                    ) -> Tuple[Tensor, Tensor]:
    """Twin of K2: normalize, affine, leaky-ReLU and 2x2 max pool; returns
    the pooled activation and each pooled element's window argmax (uint8,
    ``2 * dh + dw``, the first maximum on ties)."""
    win = _windows(bn_act_fwd(y, mean, rstd, gamma, beta, negative_slope))
    arg = torch.argmax(win, dim=-1, keepdim=True)
    pooled = torch.gather(win, -1, arg).squeeze(-1)
    return pooled, arg.squeeze(-1).to(torch.uint8)


def _unpool(pooled: Tensor, argmax: Tensor, h: int, w: int) -> Tensor:
    """Each pooled value at its window's argmax of an ``(T, N, h, w, C)``
    grid, zero elsewhere (a dropped odd row or column stays zero)."""
    t, n, ho, wo, c = pooled.shape
    onehot = tF.one_hot(argmax.long(), 4).to(pooled.dtype)
    dense = (onehot * pooled.unsqueeze(-1)).reshape(t, n, ho, wo, c, 2, 2)
    dense = dense.permute(0, 1, 2, 5, 3, 6, 4).reshape(t, n, 2 * ho, 2 * wo,
                                                      c)
    return tF.pad(dense, (0, 0, 0, w - 2 * wo, 0, h - 2 * ho))


def bn_act_bwd(da: Tensor, y: Tensor, mean: Tensor, rstd: Tensor,
               gamma: Tensor, beta: Tensor,
               negative_slope: float = LEAKY_SLOPE
               ) -> Tuple[Tensor, Tensor, Tensor]:
    """Twin of K3's pool-free mode: the backward of ``bn_act_fwd`` through
    batch norm with batch statistics. dL/da through the leaky slope gives
    dz, then, over the m = N*H*W positions of each (tenant, channel),

        dy = gamma * rstd * (dz - mean(dz) - xhat * mean(dz * xhat)).

    Returns ``(dy, dgamma, dbeta)`` with ``dgamma = sum(dz * xhat)`` and
    ``dbeta = sum(dz)`` per (tenant, channel)."""
    _, n, h, w, _ = y.shape
    _, z = _affine_act(y, mean, rstd, gamma, beta)
    y32, mean32, rstd32, gamma32, da32 = _f32(y, mean, rstd, gamma, da)
    xhat = (y32 - _per_channel(mean32, y)) * _per_channel(rstd32, y)
    dz = _leaky_masked(da32, z, scalar_like(negative_slope, y))
    dbeta = dz.sum((1, 2, 3))
    dgamma = (dz * xhat).sum((1, 2, 3))
    inv_m = 1.0 / (n * h * w)
    dy = _per_channel(gamma32 * rstd32, y) * (
        dz - _per_channel(dbeta * inv_m, y)
        - xhat * _per_channel(dgamma * inv_m, y)
    )
    return dy.to(y.dtype), dgamma.to(y.dtype), dbeta.to(y.dtype)


def bn_act_pool_bwd(dpooled: Tensor, argmax: Tensor, y: Tensor, mean: Tensor,
                    rstd: Tensor, gamma: Tensor, beta: Tensor,
                    negative_slope: float = LEAKY_SLOPE
                    ) -> Tuple[Tensor, Tensor, Tensor]:
    """Twin of K3: the backward of ``bn_act_pool_fwd``. Routes dL/dpooled
    to each window's argmax (a dropped odd row or column receives no dz),
    then ``bn_act_bwd``."""
    _, _, h, w, _ = y.shape
    return bn_act_bwd(_unpool(dpooled, argmax, h, w), y, mean, rstd, gamma,
                      beta, negative_slope)


def bn_act_bwd_bwd(a: Tensor, ggamma: Tensor, gbeta: Tensor, da: Tensor,
                   y: Tensor, mean: Tensor, rstd: Tensor, gamma: Tensor,
                   beta: Tensor, negative_slope: float = LEAKY_SLOPE
                   ) -> Tuple[Tensor, Tensor, Tensor]:
    """Twin of K5's pool-free mode: the backward of ``bn_act_bwd``, written
    out as formulas.

    ``a``, ``ggamma``, ``gbeta`` are the cotangents of K3's ``dy``,
    ``dgamma`` and ``dbeta``. Returns the gradients with respect to
    ``da``, ``y`` (through the statistics too: ``mean`` and ``rstd`` are
    functions of y) and ``gamma``; beta's is zero (it enters only through
    the masks). With ``P(v) = v - mean(v) - xhat * mean(v * xhat)`` (K3's
    projection), r = rstd and dz the slope-masked da, per (tenant,
    channel) over m = N*H*W positions::

        g_dz    = gamma * r * P(a) + ggamma * xhat + gbeta
        g_da    = g_dz, slope-masked
        cross   = S_adz - m * mean(a) * mean(dz)
                  - m * mean(a xhat) * mean(dz xhat)
        g_gamma = r * cross
        G       = -gamma * r * (mean(dz xhat) * a + mean(a xhat) * dz)
                  + ggamma * dz
        g_y     = r * (G - mean(G) - xhat * mean(G xhat))
                  - r^2 * gamma * xhat * cross / m

    (``mean(G)`` and ``mean(G xhat)`` follow from the five sums Σa, Σa·xhat,
    Σdz, Σdz·xhat and Σa·dz, which the kernel,
    ``kernels/csrc/bn_act_bwd.cu``, reduces)."""
    _, n, h, w, _ = y.shape
    m = n * h * w
    dims = (1, 2, 3)
    out_dtype = y.dtype
    slope = scalar_like(negative_slope, y)

    def pc(v):
        return _per_channel(v, y)

    def masked(v):
        return _leaky_masked(v, z, slope)

    _, z = _affine_act(y, mean, rstd, gamma, beta)
    a, ggamma, gbeta, da, y, mean, rstd, gamma = _f32(
        a, ggamma, gbeta, da, y, mean, rstd, gamma)
    xhat = (y - pc(mean)) * pc(rstd)
    dz = masked(da)
    m_a, m_ax = a.mean(dims), (a * xhat).mean(dims)
    m_dz, m_dzx = dz.mean(dims), (dz * xhat).mean(dims)
    cross = (a * dz).sum(dims) - m * (m_a * m_dz + m_ax * m_dzx)
    grs = gamma * rstd
    g_da = masked(pc(grs) * (a - pc(m_a) - xhat * pc(m_ax))
                  + pc(ggamma) * xhat + pc(gbeta))
    big_g = -pc(grs) * (pc(m_dzx) * a + pc(m_ax) * dz) + pc(ggamma) * dz
    mean_g = -grs * (m_dzx * m_a + m_ax * m_dz) + ggamma * m_dz
    mean_gx = -2.0 * grs * m_ax * m_dzx + ggamma * m_dzx
    g_y = (pc(rstd) * (big_g - pc(mean_g) - xhat * pc(mean_gx))
           - xhat * pc(rstd * rstd * gamma * cross / m))
    return (g_da.to(out_dtype), g_y.to(out_dtype),
            (rstd * cross).to(out_dtype))


def bn_act_pool_bwd_bwd(a: Tensor, ggamma: Tensor, gbeta: Tensor,
                        dpooled: Tensor, argmax: Tensor, y: Tensor,
                        mean: Tensor, rstd: Tensor, gamma: Tensor,
                        beta: Tensor, negative_slope: float = LEAKY_SLOPE
                        ) -> Tuple[Tensor, Tensor, Tensor]:
    """Twin of K5: the backward of ``bn_act_pool_bwd`` — ``bn_act_bwd_bwd``
    on the unpooled gradient, its ``da`` gradient gathered at each
    window's argmax. Returns the gradients with respect to ``dpooled``,
    ``y`` and ``gamma``."""
    _, _, h, w, _ = y.shape
    g_da, g_y, g_gamma = bn_act_bwd_bwd(
        a, ggamma, gbeta, _unpool(dpooled, argmax, h, w), y, mean, rstd,
        gamma, beta, negative_slope)
    g_dpooled = torch.gather(_windows(g_da), -1,
                             argmax.long().unsqueeze(-1)).squeeze(-1)
    return g_dpooled, g_y, g_gamma


def conv_out_hw(h: int, w: int, stride: int, padding: int = 1
                ) -> Tuple[int, int]:
    """The output size of a 3x3 conv at ``stride`` and ``padding``."""
    return ((h + 2 * padding - 3) // stride + 1,
            (w + 2 * padding - 3) // stride + 1)


def conv3x3_dgrad(dy: Tensor, w: Tensor, stride: int = 1,
                  in_hw: Optional[Tuple[int, int]] = None,
                  padding: int = 1) -> Tensor:
    """Twin of K4's dgrad: the input gradient of a 3x3 conv at ``stride``
    and ``padding``, the transposed conv. At stride 1 the conv of ``dy``
    with each tenant's weights flipped in space and transposed in channels
    at pad ``2 - padding`` (pad 0: the "full" correlation, 82 -> 84); at
    stride 2 the same conv of ``dy`` dilated by 2 (zeros between its
    pixels), cut to the input size ``in_hw`` (which ``dy`` does not
    determine: 7 and 8 rows both give 4). ``in_hw`` is required at stride
    2 and at pad 0, and is dy's own at stride 1, pad 1."""
    t, n, ho, wo, c = dy.shape
    if in_hw is None:
        if stride != 1 or padding != 1:
            raise ValueError("conv3x3_dgrad: in_hw is required at stride "
                             f"{stride}, pad {padding}")
        in_hw = (ho, wo)
    h, wd = in_hw
    if conv_out_hw(h, wd, stride, padding) != (ho, wo):
        raise ValueError(f"conv3x3_dgrad: dy {ho}x{wo} is not the stride-"
                         f"{stride} output of a {h}x{wd} input at pad "
                         f"{padding}")
    w_t = w.flip(1, 2).transpose(-1, -2)
    if stride == 1:
        return conv2d(dy, w_t, None, 1, 2 - padding)
    # input pixel i reads dy at (i + padding - k) / stride: the dilated dy,
    # padded so that position i + padding - k of it sits at i + (2 - k)
    off = 2 - padding
    dil = dy.new_zeros(t, n, h + 2, wd + 2, c)
    dil[:, :, off:off + stride * ho:stride, off:off + stride * wo:stride] = dy
    return conv2d(dil, w_t, None, 1, 0)


def conv3x3_wgrad(x: Tensor, dy: Tensor, stride: int = 1, padding: int = 1
                  ) -> Tuple[Tensor, Tensor]:
    """Twin of K4's wgrad: ``dW[t] = patches(x[t])^T @ dy[t]`` in HWIO
    (the patches of the ``stride``, ``padding`` conv) and ``db[t] =
    sum(dy[t])`` over (N, Ho, Wo)."""
    t, _, _, _, cin = x.shape
    cout = dy.shape[-1]
    patches = im2col(x, 3, 3, stride, padding).reshape(t, -1, 9 * cin)
    dw = torch.matmul(patches.transpose(1, 2), dy.reshape(t, -1, cout))
    return dw.reshape(t, 3, 3, cin, cout), dy.sum((1, 2, 3))


def global_avg_pool2d_bwd(dpool: Tensor, h: int, w: int) -> Tensor:
    """Twin of the GAP backward: ``(T, N, C) -> (T, N, h, w, C)``, each
    pixel ``dpool / (h * w)``."""
    t, n, c = dpool.shape
    return (dpool / (h * w))[:, :, None, None, :].expand(
        t, n, h, w, c).contiguous()


# -- the norm-first block's kernels: standalone batch norm (B5b) and
# leaky-ReLU + max pool (B2) --------------------------------------------------


def bn_input_stats(x: Tensor, eps: float = BN_EPS
                   ) -> Tuple[Tensor, Tensor, Tensor]:
    """Twin of ``bn_input_stats``: the block input's per-(tenant, channel)
    batch mean, biased variance (two passes) and
    ``rstd = 1 / sqrt(var + eps)``."""
    return bn_stats(x, eps)


def batch_norm_fwd(x: Tensor, mean: Tensor, rstd: Tensor, gamma: Tensor,
                   beta: Tensor) -> Tensor:
    """Twin of ``batch_norm_fwd``: ``(x - mean) * rstd * gamma + beta``,
    K2's pool-free mode at slope 1 (leaky-ReLU the identity)."""
    return bn_act_fwd(x, mean, rstd, gamma, beta, 1.0)


def batch_norm_bwd(dz: Tensor, x: Tensor, mean: Tensor, rstd: Tensor,
                   gamma: Tensor, beta: Tensor
                   ) -> Tuple[Tensor, Tensor, Tensor]:
    """Twin of ``batch_norm_bwd``: the backward of batch norm with batch
    statistics, ``(dx, dgamma, dbeta)`` from ``dz`` (K3's pool-free mode
    at slope 1)."""
    return bn_act_bwd(dz, x, mean, rstd, gamma, beta, 1.0)


def batch_norm_bwd_bwd(a: Tensor, ggamma: Tensor, gbeta: Tensor, dz: Tensor,
                       x: Tensor, mean: Tensor, rstd: Tensor, gamma: Tensor,
                       beta: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Twin of ``batch_norm_bwd_bwd``: the backward of ``batch_norm_bwd``,
    the gradients with respect to ``dz``, ``x`` and ``gamma`` (K5's
    pool-free mode at slope 1; beta's is zero)."""
    return bn_act_bwd_bwd(a, ggamma, gbeta, dz, x, mean, rstd, gamma, beta,
                          1.0)


def _leaky_masked(v: Tensor, y: Tensor, negative_slope: float) -> Tensor:
    """``v * leaky_relu'(y)``: ``v`` where ``y >= 0``, else
    ``negative_slope * v`` (the slope rounded to v's dtype)."""
    return torch.where(y >= 0, v, scalar_like(negative_slope, v) * v)


def act_fwd(y: Tensor, negative_slope: float = LEAKY_SLOPE) -> Tensor:
    """Twin of ``act_fwd``: the leaky-ReLU."""
    return leaky_relu(y, negative_slope)


def act_bwd(da: Tensor, y: Tensor, negative_slope: float = LEAKY_SLOPE
            ) -> Tensor:
    """Twin of ``act_bwd``: ``da * leaky_relu'(y)``; linear in ``da`` and
    its own adjoint."""
    return _leaky_masked(da, y, negative_slope)


def act_pool_fwd(y: Tensor, negative_slope: float = LEAKY_SLOPE
                 ) -> Tuple[Tensor, Tensor]:
    """Twin of ``act_pool_fwd``: leaky-ReLU then the 2x2 max pool; returns
    the pooled activation and each pooled element's window argmax over the
    ACTIVATED values (uint8, ``2 * dh + dw``, the first maximum on ties:
    the JAX package's ``reduce_window`` lowering)."""
    win = _windows(leaky_relu(y, negative_slope))
    arg = torch.argmax(win, dim=-1, keepdim=True)
    return (torch.gather(win, -1, arg).squeeze(-1),
            arg.squeeze(-1).to(torch.uint8))


def act_pool_bwd(dpooled: Tensor, argmax: Tensor, y: Tensor,
                 negative_slope: float = LEAKY_SLOPE) -> Tensor:
    """Twin of ``act_pool_bwd``: each pooled gradient at its window's
    argmax times ``leaky_relu'(y)`` there, zero elsewhere (a dropped odd
    row or column too)."""
    _, _, h, w, _ = y.shape
    return _leaky_masked(_unpool(dpooled, argmax, h, w), y, negative_slope)


def act_pool_gather(g_dy: Tensor, argmax: Tensor, y: Tensor,
                    negative_slope: float = LEAKY_SLOPE) -> Tensor:
    """Twin of ``act_pool_gather``: the adjoint of ``act_pool_bwd`` in its
    gradient, ``g_dy * leaky_relu'(y)`` gathered at each window's
    argmax."""
    g = _windows(_leaky_masked(g_dy, y, negative_slope))
    return torch.gather(g, -1, argmax.long().unsqueeze(-1)).squeeze(-1)


# -- the layer norm's kernels (B5c) ----------------------------------------------
#
# x (T, N, H, W, C) f32; the per-image statistics (T, N); gamma and beta per
# tenant (T, H, W, C). Per image the reduction runs over its M = H*W*C
# values; xhat = (x - mean) * rstd.


def _rows(v: Tensor) -> Tensor:
    """A per-image ``(T, N)`` tensor against ``(T, N, H, W, C)``."""
    return v[:, :, None, None, None]


def _row_mean(v: Tensor) -> Tensor:
    return v.mean((2, 3, 4))


def image_stats(x: Tensor, eps: float = LN_EPS
                ) -> Tuple[Tensor, Tensor, Tensor]:
    """Each image's mean, population variance (two passes, in f32, each
    rounded once to x's dtype, as ``jnp.mean`` / ``jnp.var``) and ``rstd =
    rsqrt(var + eps)`` (``rsqrt_eps``) over its (H, W, C), ``(T, N)``
    each."""
    x32 = at_least_f32(x)
    mean = _row_mean(x32)
    var = _row_mean((x32 - _rows(mean)) ** 2).to(x.dtype)
    return mean.to(x.dtype), var, rsqrt_eps(var, eps, kernel_form=True)


def layer_norm_stats(x: Tensor, eps: float = LN_EPS
                     ) -> Tuple[Tensor, Tensor, Tensor]:
    """Twin of ``layer_norm_stats``: ``image_stats``."""
    return image_stats(x, eps)


def layer_norm_fwd(x: Tensor, mean: Tensor, rstd: Tensor, gamma: Tensor,
                   beta: Tensor) -> Tensor:
    """Twin of ``layer_norm_fwd``: ``(x - mean) * rstd * gamma + beta``,
    the statistics per image, gamma and beta per (tenant, h, w, c), every
    operand in x's dtype."""
    mean, rstd, gamma, beta = (v.to(x.dtype) for v in (mean, rstd, gamma,
                                                      beta))
    return ((x - _rows(mean)) * _rows(rstd) * gamma.unsqueeze(1)
            + beta.unsqueeze(1))


def layer_norm_bwd(dz: Tensor, x: Tensor, mean: Tensor, rstd: Tensor,
                   gamma: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Twin of ``layer_norm_bwd``: the backward of layer norm through its
    statistics. With ``g = dz * gamma``, per image over its M values,

        dx = rstd * (g - mean(g) - xhat * mean(g * xhat)),

    and per (tenant, h, w, c), summed over the N images, ``dgamma =
    sum(dz * xhat)`` and ``dbeta = sum(dz)``. Returns ``(dx, dgamma,
    dbeta)``, computed in f32 (f64 stays f64) and rounded to x's dtype."""
    out_dtype = x.dtype
    dz, x, mean, rstd, gamma = _f32(dz, x, mean, rstd, gamma)
    xhat = (x - _rows(mean)) * _rows(rstd)
    g = dz * gamma.unsqueeze(1)
    dx = _rows(rstd) * (g - _rows(_row_mean(g))
                        - xhat * _rows(_row_mean(g * xhat)))
    return tuple(v.to(out_dtype) for v in (dx, (dz * xhat).sum(1),
                                           dz.sum(1)))


def layer_norm_bwd_bwd(a: Tensor, ggamma: Tensor, gbeta: Tensor, dz: Tensor,
                       x: Tensor, mean: Tensor, rstd: Tensor, gamma: Tensor
                       ) -> Tuple[Tensor, Tensor, Tensor]:
    """Twin of ``layer_norm_bwd_bwd``: the backward of ``layer_norm_bwd``.

    ``a``, ``ggamma``, ``gbeta`` are the cotangents of its ``dx``,
    ``dgamma`` and ``dbeta``. With ``r = rstd``, ``g = dz * gamma`` and
    the self-adjoint projection ``P(u) = u - mean(u) - xhat * mean(u *
    xhat)`` per image (so ``dx = r * P(g)``):

        g_dz    = gamma * r * P(a) + ggamma * xhat + gbeta
        g_gamma = sum over the images of dz * r * P(a)
        G       = -r * (a * mean(g xhat) + g * mean(a xhat)) + ggamma * dz
        g_x     = r * (G - mean(G) - xhat * mean(G xhat))
                  - xhat * r^2 * (mean(a g) - mean(a) mean(g)
                                  - mean(a xhat) mean(g xhat))

    ``G`` is the gradient with respect to xhat at fixed r; the last term
    is the one through r (``sum(a * P(g))`` times ``dr/dx``). Returns
    ``(g_dz, g_x, g_gamma)``, computed in f32 (f64 stays f64) and rounded
    to x's dtype."""
    out_dtype = x.dtype
    a, ggamma, gbeta, dz, x, mean, rstd, gamma = _f32(
        a, ggamma, gbeta, dz, x, mean, rstd, gamma)
    r = _rows(rstd)
    gam = gamma.unsqueeze(1)
    xhat = (x - _rows(mean)) * r
    g = dz * gam
    m_a, m_ax = _row_mean(a), _row_mean(a * xhat)
    m_g, m_gx = _row_mean(g), _row_mean(g * xhat)
    p_a = a - _rows(m_a) - xhat * _rows(m_ax)
    g_dz = gam * r * p_a + ggamma.unsqueeze(1) * xhat + gbeta.unsqueeze(1)
    big_g = (-r * (a * _rows(m_gx) + g * _rows(m_ax))
             + ggamma.unsqueeze(1) * dz)
    cross = _row_mean(a * g) - m_a * m_g - m_ax * m_gx
    g_x = (r * (big_g - _rows(_row_mean(big_g))
                - xhat * _rows(_row_mean(big_g * xhat)))
           - xhat * _rows(rstd * rstd * cross))
    return tuple(v.to(out_dtype) for v in (g_dz, g_x, (dz * r * p_a).sum(1)))
