"""The few-shot backbone: ``num_stages`` conv blocks + linear head.

The port of the JAX package's ``models/vgg.py``, with its flat parameter
keys and shapes (``conv{i}.conv.weight`` HWIO, ``conv{i}.norm.gamma``
``(steps, f)`` under per-step BN, ``linear.weight`` ``(in, out)``) and its
semantics: batch norm always normalizes with batch statistics, per-step
gamma/beta/running statistics are indexed by the clamped inner step, and
the running statistics are returned, never used.

The tenant axis: ``apply`` takes images ``(batch, h, w, c)`` or
``(T, batch, h, w, c)``. In the tenant form every INNER-ADAPTED parameter
carries a leading ``T`` axis (each tenant adapts its own copy) while frozen
parameters are shared, and the returned BN state is per tenant
``(T, steps, f)``.

The port covers padded and unpadded convs (``conv_padding``: pad 1, or a
valid 3x3 window, 84 -> 82 at mini-ImageNet's stage 0), both norm
layers, both block orders and both geometries.
``block_order='conv_norm_relu'`` (the reference's block) normalizes the
conv output; ``'norm_conv_relu'`` normalizes the block
INPUT (gamma, beta and the running statistics sized to its channels, JAX
``models/vgg.py`` :110, :271), then conv + bias and leaky-ReLU. With
``norm_layer='layer_norm'`` the norm is a layer norm over each image's
(H, W, C): its gamma and beta are ``(H, W, C)`` of the normalized tensor
(the conv output's, or the block input's), never per step, and there are
no running statistics (an empty BN state; JAX ``models/vgg.py``
:124-130). With ``max_pooling=True`` each stage is a stride-1 conv
followed by a 2x2 max pool; with ``max_pooling=False`` (the strided model,
the JAX package's default) each stage is a stride-2 conv with no pool, and
the features are the global average pool of the last stage (JAX
``models/vgg.py`` :200, :301, :304-305). Each stage is one call of a block
that computes the config's order (``blocks_for``: plain ops on the CPU,
the hand-written kernels on the card, differentiable twice); in the
strided model the last block also takes the global average pool, so that
the block given to ``apply`` decides how it is computed. A block of the
other order or the other norm raises. A strided unpadded geometry whose
conv output vanishes (Omniglot's 28 -> 13 -> 6 -> 2 -> 0) raises
``ValueError`` naming the stage; the config already refuses a pooled
one.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch

from ..config import MAMLConfig
from ..core import partition
from ..kernels import conv_block
from ..ops import functional as F

Params = Dict[str, torch.Tensor]
BNState = Dict[str, torch.Tensor]
#: ``block(x, w, b, gamma, beta, stats_impl, stride=, pool=, gap=,
#: padding=) ->
#: (out, mean, var)`` (``(out, None, None)`` for a layer norm), with a
#: ``block_order`` attribute naming the order of the layers it computes
#: (``conv_norm_relu`` or ``norm_conv_relu``) and a ``norm_layer``
#: attribute naming its norm (``batch_norm`` or ``layer_norm``)
BlockFn = Callable[..., Tuple[torch.Tensor, Optional[torch.Tensor],
                              Optional[torch.Tensor]]]

_BLOCKS = {
    ("conv_norm_relu", "batch_norm"): (conv_block.conv_bn_act_pool,
                                       F.conv_bn_act_pool),
    ("norm_conv_relu", "batch_norm"): (conv_block.norm_conv_act_pool,
                                       F.norm_conv_act_pool),
    ("conv_norm_relu", "layer_norm"): (conv_block.conv_ln_act_pool,
                                       F.conv_ln_act_pool),
    ("norm_conv_relu", "layer_norm"): (conv_block.ln_conv_act_pool,
                                       F.ln_conv_act_pool),
}


def blocks_for(cfg: MAMLConfig) -> Tuple[BlockFn, BlockFn]:
    """``(kernel_block, plain_block)`` of the config's block order and norm
    layer: the block that takes the kernels for CUDA tensors (and its twin
    for CPU ones), and the plain composition differentiable by autograd
    (the reference on the card)."""
    return _BLOCKS[(cfg.block_order, cfg.norm_layer)]


def check_supported(cfg: MAMLConfig) -> None:
    """Raise ``ValueError`` for a geometry with no conv output: an unpadded
    strided stage whose input is under 3 pixels (the JAX package fails on
    it at trace time; ``MAMLConfig`` refuses the pooled case itself)."""
    for stage, (h, w, ch, cw, _, _) in enumerate(_stage_dims(cfg)):
        if ch < 1 or cw < 1:
            raise ValueError(
                f"the strided unpadded geometry vanishes at stage {stage}: "
                f"the 3x3 conv of its {h}x{w} input has no output "
                f"({cfg.image_height}x{cfg.image_width}, "
                f"num_stages={cfg.num_stages})")


def _stage_dims(cfg: MAMLConfig):
    """Per-stage (h_in, w_in, h_conv, w_conv, h_out, w_out)."""
    h, w = cfg.image_height, cfg.image_width
    pad = 1 if cfg.conv_padding else 0
    for _ in range(cfg.num_stages):
        if cfg.max_pooling:
            ch, cw = h + 2 * pad - 2, w + 2 * pad - 2
            oh, ow = ch // 2, cw // 2
        else:
            ch = (h + 2 * pad - 3) // 2 + 1
            cw = (w + 2 * pad - 3) // 2 + 1
            oh, ow = ch, cw
        yield h, w, ch, cw, oh, ow
        h, w = oh, ow


def _feature_hw(cfg: MAMLConfig) -> Tuple[int, int]:
    oh, ow = cfg.image_height, cfg.image_width
    for _, _, _, _, oh, ow in _stage_dims(cfg):
        pass
    return oh, ow


def feature_dim(cfg: MAMLConfig) -> int:
    """Flattened feature dim entering the linear head."""
    if cfg.max_pooling:
        h, w = _feature_hw(cfg)
        return h * w * cfg.cnn_num_filters
    return cfg.cnn_num_filters


def _xavier_uniform(gen: torch.Generator, shape, fan_in: int, fan_out: int,
                    device) -> torch.Tensor:
    a = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(shape, generator=gen, dtype=torch.float32)
    return (u * (2 * a) - a).to(device)


def init(cfg: MAMLConfig, gen: torch.Generator,
         device: Optional[torch.device] = None) -> Tuple[Params, BNState]:
    """Parameters and BN state with the JAX package's keys and shapes,
    drawn from ``gen`` (xavier-uniform conv/linear weights, zero biases,
    unit gamma, zero beta; running mean 0 and variance 1)."""
    check_supported(cfg)
    params: Params = {}
    bn_state: BNState = {}
    steps = cfg.bn_num_steps
    c_in = cfg.image_channels
    f = cfg.cnn_num_filters
    conv_first = cfg.block_order == "conv_norm_relu"
    for i, (h, w, ch, cw, _, _) in enumerate(_stage_dims(cfg)):
        params[f"conv{i}.conv.weight"] = _xavier_uniform(
            gen, (3, 3, c_in, f), c_in * 9, f * 9, device
        )
        params[f"conv{i}.conv.bias"] = torch.zeros(f, device=device)
        # the norm's features: the conv output's, or the block input's
        # when the block normalizes its input first
        nf = f if conv_first else c_in
        if cfg.norm_layer == "layer_norm":
            # over the normalized tensor's whole (H, W, C); no running
            # statistics
            shape = (ch, cw, nf) if conv_first else (h, w, nf)
            params[f"conv{i}.norm.gamma"] = torch.ones(shape, device=device)
            params[f"conv{i}.norm.beta"] = torch.zeros(shape, device=device)
        elif (cfg.per_step_bn_statistics
                and not cfg.enable_inner_loop_optimizable_bn_params):
            params[f"conv{i}.norm.gamma"] = torch.ones(steps, nf,
                                                       device=device)
            params[f"conv{i}.norm.beta"] = torch.zeros(steps, nf,
                                                       device=device)
        else:
            params[f"conv{i}.norm.gamma"] = torch.ones(nf, device=device)
            params[f"conv{i}.norm.beta"] = torch.zeros(nf, device=device)
        if cfg.per_step_bn_statistics and cfg.norm_layer == "batch_norm":
            bn_state[f"conv{i}.norm.mean"] = torch.zeros(steps, nf,
                                                         device=device)
            bn_state[f"conv{i}.norm.var"] = torch.ones(steps, nf,
                                                       device=device)
        c_in = f
    feat = feature_dim(cfg)
    params["linear.weight"] = _xavier_uniform(
        gen, (feat, cfg.num_classes_per_set), feat, cfg.num_classes_per_set,
        device,
    )
    params["linear.bias"] = torch.zeros(cfg.num_classes_per_set,
                                        device=device)
    return params, bn_state


def apply(cfg: MAMLConfig, params: Params, bn_state: BNState,
          x: torch.Tensor, num_step: int, training: bool = True,
          block: Optional[BlockFn] = None) -> Tuple[torch.Tensor, BNState]:
    """Forward pass.

    :param x: images ``(batch, h, w, c)`` or ``(T, batch, h, w, c)``, NHWC.
    :param num_step: the inner step; indexes the per-step BN parameters and
        statistics, clamped to the stored step count.
    :param training: whether the updated running statistics are returned
        (normalization always uses batch statistics).
    :param block: the block implementation, of the config's
        ``block_order`` and ``norm_layer`` (another raises
        ``ValueError``); default the kernel
        block of ``blocks_for(cfg)`` (plain ops for CPU tensors, the
        kernels for CUDA tensors). A caller that wants the plain ops on the
        card passes ``blocks_for(cfg)[1]``.
    :return: ``(logits, new_bn_state)``; logits f32 (f64 for f64 images)
        ``(batch, way)`` or
        ``(T, batch, way)``.
    """
    check_supported(cfg)
    block = blocks_for(cfg)[0] if block is None else block
    for field in ("block_order", "norm_layer"):
        got, want = getattr(block, field, None), getattr(cfg, field)
        if got != want:
            raise ValueError(f"the block computes {field}={got!r}; the "
                             f"config's is {want!r}")
    norm_first = cfg.block_order == "norm_conv_relu"
    tenant = x.dim() == 5
    if not tenant:
        x = x.unsqueeze(0)
        params = {
            k: v.unsqueeze(0) if partition.is_inner_adapted(cfg, k) else v
            for k, v in params.items()
        }
    # f32 compute keeps f64 images in f64 (a reference run)
    dtype = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
             else torch.promote_types(x.dtype, torch.float32))
    step = min(max(int(num_step), 0), cfg.bn_num_steps - 1)
    # per-step (steps, f) batch-norm gamma/beta; a layer norm's are never
    # per step (JAX ``models/vgg.py`` :216 decides by ``gamma.ndim == 2``)
    per_step_affine = (cfg.norm_layer == "batch_norm"
                       and cfg.per_step_bn_statistics
                       and not cfg.enable_inner_loop_optimizable_bn_params)
    stats_impl = cfg.resolved_bn_stats_impl(x.device)
    stride = 1 if cfg.max_pooling else 2
    pad = 1 if cfg.conv_padding else 0
    n_tenants = x.shape[0]
    out = x.to(dtype)
    new_bn: BNState = {}
    for i in range(cfg.num_stages):
        gamma = params[f"conv{i}.norm.gamma"]
        beta = params[f"conv{i}.norm.beta"]
        if per_step_affine:
            gamma, beta = gamma[step], beta[step]
        # the batch statistics' count: the pixels of the normalized
        # tensor, the block input or the conv output (at the conv's pad)
        hw = out.shape[2:4] if norm_first else F.conv_out_hw(
            out.shape[2], out.shape[3], stride, pad)
        stats_n = out.shape[1] * math.prod(hw)
        out, mean, var = block(
            out, params[f"conv{i}.conv.weight"].to(dtype),
            params[f"conv{i}.conv.bias"].to(dtype), gamma, beta, stats_impl,
            stride=stride, pool=cfg.max_pooling,
            gap=not cfg.max_pooling and i == cfg.num_stages - 1, padding=pad,
        )
        mean_key, var_key = f"conv{i}.norm.mean", f"conv{i}.norm.var"
        if mean_key not in bn_state:
            continue
        rm, rv = bn_state[mean_key], bn_state[var_key]
        if not training:
            new_bn[mean_key], new_bn[var_key] = rm, rv
            continue
        nm, nv = F.running_update(rm[..., step, :], rv[..., step, :],
                                  mean, var, stats_n)
        for key, old, new in ((mean_key, rm, nm), (var_key, rv, nv)):
            full = old.expand(n_tenants, *old.shape[-2:]).clone()
            full[:, step] = new
            new_bn[key] = full
    feats = out.reshape(out.shape[0], out.shape[1], -1)
    logits = F.linear(feats, params["linear.weight"], params["linear.bias"])
    logits = F.at_least_f32(logits)
    if not tenant:
        logits = logits[0]
        new_bn = {k: v[0] if v.dim() == 3 else v for k, v in new_bn.items()}
    return logits, new_bn

