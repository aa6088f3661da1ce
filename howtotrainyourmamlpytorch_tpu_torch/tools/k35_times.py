"""Time K3 and K5 pooled (``bn_act_pool_bwd`` and ``bn_act_pool_bwd_bwd``)
in f32 and bf16 at every shape the shipped configs give them, beside their bound: the check that one build's K3 and K5 are faster than
another's, compared in one process run after the other on one card
(parent, change, change, parent).

    PYTHONPATH=<checkout> python3 <this file> [--label NAME] [--out FILE]
                                              [--e2e]

Run by path, so that ``PYTHONPATH`` picks the package whose kernels are
built and launched (each checkout builds its own into its own
``_build/``); the script uses only the wrappers ``bn_act_pool_bwd`` and
``bn_act_pool_bwd_bwd`` of ``kernels/conv_block.py``, which every build
has. Inputs come from a seeded CUDA generator: y, its batch statistics,
gamma and beta, the twin K2's window argmax, a pooled gradient and K5's
cotangents, at the mini-ImageNet conv outputs (84/42/21/10, 48 channels)
and the unpadded model's (82/39/17/6) at N = 25, T = 2 and 8, the
large-batch config's T = 256 at mini stage 1, and Omniglot's (28/14/7/3,
64 channels) at N = 20, T = 8; K3 and K5 in bf16 at the same shapes on
the same values rounded to bf16 (their argmax K2's of them). Per row: the
wrapper's time by CUDA events (host time included:
``card_timing.time_ms``, every row timed before the first profile), the
device time of every kernel the call launches and their count by
``torch.profiler`` (a Triton K3's two kernels and its sum of the
partials, a Triton K5's two; one CUDA kernel), the error against the plain twin (f32 within
1e-5 + 1e-4 of scale, bf16 within one bf16 ulp or 1e-4 of scale), and the
bound: max(bytes / 3.35 TB/s, FLOPs / 67 TFLOP/s) on an H100 SXM, each
input read once and each output written once. ``--e2e`` then profiles
one warm second-order batch-2 train step of the mini-ImageNet MAML++
config in bf16 and in f32 (the conv-first batch-norm model): the device's
busy time and K3's and K5's device time and launches (every kernel whose
name holds ``bn_act_pool_bwd``; a Triton K3's sum of its partials is a
PyTorch reduction, counted in the busy time only). Prints one line per
row, the card's ``nvidia-smi`` line, and (with ``--out``) writes every
row as JSON. Needs one card.
"""

from __future__ import annotations

import sys

import torch

import card_timing
from card_timing import device_ms, fmt_ms, time_ms

MINI = (("stage0", 84), ("stage1", 42), ("stage2", 21), ("stage3", 10))
UNPADDED = (("stage0", 82), ("stage1", 39), ("stage2", 17), ("stage3", 6))
OMNIGLOT = (("L1", 28), ("L2", 14), ("L3", 7), ("L4", 3))
# (model, C, images, tasks, layers)
CASES = (("mini", 48, 25, (2, 8), MINI),
         ("mini", 48, 25, (256,), MINI[1:2]),
         ("omniglot", 64, 20, (8,), OMNIGLOT),
         ("unpadded", 48, 25, (2, 8), UNPADDED))
ATOL, RTOL = 1e-5, 1e-4  # the twin gate


def inputs(T, N, hw, C, seed):
    from howtotrainyourmamlpytorch_tpu_torch.ops import functional as F

    g = torch.Generator(device="cuda").manual_seed(seed)

    def r(*s, scale=1.0):
        return torch.randn(*s, device="cuda", generator=g) * scale

    y = 2.0 * r(T, N, hw, hw, C) + 0.3
    mean, _, rstd = F.bn_stats(y)
    gamma, beta = 1.0 + r(T, C, scale=0.1), r(T, C, scale=0.1)
    pooled, arg = F.bn_act_pool_fwd(y, mean, rstd, gamma, beta)
    dp = r(*pooled.shape, scale=pooled.numel() ** -0.5)
    k3 = (dp, arg, y, mean, rstd, gamma, beta)
    return k3, (r(*y.shape), r(T, C), r(T, C)) + k3


def max_err(got, want):
    err = max((g.double() - w.double()).abs().max().item()
              for g, w in zip(got, want))
    for g, w in zip(got, want):
        scale = w.double().abs().max().item()
        diff = (g.double() - w.double()).abs()
        if w.dtype == torch.bfloat16:
            # one bf16 ulp of the twin, or 1e-4 of its scale
            _, e = torch.frexp(w.double().abs().clamp_min(2.0 ** -126))
            tol = torch.clamp_min(torch.ldexp(torch.ones_like(diff), e - 8),
                                  1e-4 * scale)
            bad = bool((diff > tol).any())
        else:
            bad = diff.max().item() > ATOL + RTOL * scale
        if bad:
            raise AssertionError(f"max |kernel - twin| {err:.3e} exceeds the "
                                 f"gate at scale {scale:.3e}")
    return err


def cases():
    """(model, layer, T, N, C, H = W) of every row."""
    for model, C, n, tasks, layers in CASES:
        for T in tasks:
            for layer, hw in layers:
                yield model, layer, T, n, C, hw


def calls(cb, F, T, n, C, hw):
    """K3's and K5's (name, wrapper call, twin call, FLOPs, bytes) at one
    shape in f32 and bf16, on inputs from its seed: each input read once,
    each output written once."""
    k3, k5 = inputs(T, n, hw, C, hw + C + n + T)
    dp, arg, y = k3[:3]
    TC = T * C
    dp16, _, y16, mean16, rstd16, gamma16, beta16 = (
        v.bfloat16() for v in (dp, arg, y) + k3[3:])
    arg16 = F.bn_act_pool_fwd(y16, mean16, rstd16, gamma16, beta16)[1]
    k3_16 = (dp16, arg16, y16, mean16, rstd16, gamma16, beta16)
    k5_16 = tuple(v.bfloat16() for v in k5[:3]) + k3_16
    return (
        ("K3", lambda: cb.bn_act_pool_bwd(*k3),
         lambda: F.bn_act_pool_bwd(*k3), 10 * y.numel() + 6 * dp.numel(),
         4 * (dp.numel() + 2 * y.numel() + 6 * TC) + arg.numel()),
        ("K5", lambda: cb.bn_act_pool_bwd_bwd(*k5),
         lambda: F.bn_act_pool_bwd_bwd(*k5), 42 * y.numel(),
         4 * (3 * y.numel() + 2 * dp.numel() + 7 * TC) + arg.numel()),
        ("K3 bf16", lambda: cb.bn_act_pool_bwd(*k3_16),
         lambda: F.bn_act_pool_bwd(*k3_16), 10 * y.numel() + 6 * dp.numel(),
         2 * (dp.numel() + 2 * y.numel() + 6 * TC) + arg.numel()),
        ("K5 bf16", lambda: cb.bn_act_pool_bwd_bwd(*k5_16),
         lambda: F.bn_act_pool_bwd_bwd(*k5_16), 42 * y.numel(),
         2 * (3 * y.numel() + 2 * dp.numel() + 7 * TC) + arg.numel()))


def rows(label):
    from howtotrainyourmamlpytorch_tpu_torch.kernels import conv_block as cb
    from howtotrainyourmamlpytorch_tpu_torch.ops import functional as F

    flops_peak, bw_peak = 67e12, 3.35e12
    out = []
    # every row's event times first, then the profiles
    for model, layer, T, n, C, hw in cases():
        for kernel, call, twin, flops, nbytes in calls(cb, F, T, n, C, hw):
            t_ops, t_bytes = flops / flops_peak, nbytes / bw_peak
            out.append({
                "build": label, "kernel": kernel, "model": model,
                "layer": layer, "hw": hw, "C": C, "N": n, "T": T,
                "max_abs_err": max_err(call(), twin()), "ms": time_ms(call),
                "bound_ms": max(t_ops, t_bytes) * 1e3,
                "bound_by": "operations" if t_ops > t_bytes else "bytes",
            })
        torch.cuda.empty_cache()
    rows_in_order = iter(out)
    for model, layer, T, n, C, hw in cases():
        for kernel, call, *_ in calls(cb, F, T, n, C, hw):
            r = next(rows_in_order)
            r["device_ms"], r["activities"] = device_ms(call)
            print(f"[{kernel} {label}] {model} {layer} T={T} N={n} C={C}: "
                  f"{r['ms']:.4f} ms (device {fmt_ms(r['device_ms'])}, "
                  f"{r['activities']:g} activities a call), bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']}, "
                  f"{100 * r['bound_ms'] / r['ms']:.1f}%), err "
                  f"{r['max_abs_err']:.2e}", flush=True)
        torch.cuda.empty_cache()
    return out


MINI_CONFIG = ("experiment_config/"
               "mini-imagenet_maml++-mini-imagenet_5_5_2_0.01_48_0.json")


def _is_k5(key):
    return "bn_act_pool_bwd_bwd" in key


PARTS = (("K3", lambda key: "bn_act_pool_bwd" in key and not _is_k5(key)),
         ("K5", _is_k5))


def e2e(label):
    from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig

    cfg = MAMLConfig.from_json_file(MINI_CONFIG)
    out = []
    for dtype in ("bfloat16", "float32"):
        out.append(card_timing.train_step(
            "K35", label, cfg.replace(compute_dtype=dtype),
            f"conv-first {dtype}", PARTS))
        torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    sys.exit(card_timing.main(sys.argv[1:], "K35", __doc__.split("\n")[0],
                              rows, e2e))
