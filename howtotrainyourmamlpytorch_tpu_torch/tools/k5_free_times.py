"""Time the pool-free K5 (``bn_act_bwd_bwd``, and at slope 1
``batch_norm_bwd_bwd``), in f32 and bf16, at every shape the port's models
give it, beside its bound (no PyTorch call computes the function); with
``--e2e``, the strided Omniglot batch-8 and the norm-first mini-ImageNet
batch-2 second-order train steps in f32 and bf16: the check that one
build's kernels are faster than another's, compared in one process run
after the other on one card (parent, change, change, parent).

    PYTHONPATH=<checkout> python3 <this file> [--label NAME] [--out FILE]
                                              [--e2e] [--no-stage]

Run by path, so that ``PYTHONPATH`` picks the package whose kernels are
built and launched (each checkout builds its own into its own
``_build/``); the script uses only the wrappers ``bn_act_bwd_bwd`` and
``batch_norm_bwd_bwd`` of ``kernels/conv_block.py``, their twins and the
train entry point, which every build has. Inputs come from a numpy seed,
T = 8 tenants: ``bn_act_bwd_bwd`` at the strided Omniglot model's conv
outputs (14/7/4/2 x 64, N = 20) and the unpadded strided mini-ImageNet
model's (41/20/9/4 x 48, N = 25); ``batch_norm_bwd_bwd`` at every
norm-first block input on the support (N = 25: the 84 x 84 x 3 image,
42/21/10 x 48, the unpadded model's 41/19/8 x 48) and the strided
norm-first Omniglot model's (N = 20: the 28 x 28 x 1 image, 14/7/4 x 64).
Per row: the wrapper's time by CUDA events (host time included:
``card_timing.time_ms``, every row timed before the first profile), the
device time of every kernel the call launches and their count a call by
``torch.profiler``, the host time a call (events ms less device ms), the
error against the twin (f32 within 1e-5 + 1e-4 * scale, bf16 within one
bf16 ulp or 1e-4 of scale), and the bound: max(bytes / 3.35 TB/s, FLOPs
/ 67 TFLOP/s) on an H100 SXM, each input read once (a, da, y and six
(T, C) tables) and each output written once (g_da, g_y, g_gamma), and
the share of it that a design reading a, da and y twice from device
memory can reach (its cap: 5/8 at the large maps).

``--e2e`` then profiles one warm second-order train step of the Omniglot
20-way 1-shot config
(``experiment_config/omniglot_maml++-omniglot_1_20_8_0.1_64_0.json``) with
``max_pooling=False`` at batch 8, and of the mini-ImageNet MAML++ config
(``experiment_config/mini-imagenet_maml++-mini-imagenet_5_5_2_0.01_48_0.json``)
with ``block_order='norm_conv_relu'`` at batch 2, in f32 and bf16: the
device's busy time, its activities, and the device time and launches of
the pool-free K5 and of ``act_pool_gather`` (the CUDA kernels, or the
Triton kernels they replace). Prints one line per row with the card's
``nvidia-smi`` line first and (with ``--out``) writes every row as JSON.
``--no-stage`` times the pool-free K5 of a build that has the stage
(``conv_block.BN_ACT_BWD_BWD_STAGE_BYTES``) with it set to 0: every apply
reads a, da and y again from L2, the design's other half. Needs one card.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

import card_timing
from card_timing import device_ms, fmt_ms, time_ms

T = 8
SLOPE = 0.01
# (kernel, layer, H = W, C, N) of every row
ROWS = (
    [("bn_act_bwd_bwd", f"strided L{i + 1}", hw, 64, 20)
     for i, hw in enumerate((14, 7, 4, 2))]
    + [("bn_act_bwd_bwd", f"unpadded strided stage{i}", hw, 48, 25)
       for i, hw in enumerate((41, 20, 9, 4))]
    + [("batch_norm_bwd_bwd", f"norm-first stage{i}", hw, c, 25)
       for i, (hw, c) in enumerate(((84, 3), (42, 48), (21, 48), (10, 48)))]
    + [("batch_norm_bwd_bwd", f"unpadded stage{i + 1}", hw, 48, 25)
       for i, hw in enumerate((41, 19, 8))]
    + [("batch_norm_bwd_bwd", f"strided norm-first L{i + 1}", hw, c, 20)
       for i, (hw, c) in enumerate(((28, 1), (14, 64), (7, 64), (4, 64)))]
)
DTYPES = ((torch.float32, "f32"), (torch.bfloat16, "bf16"))
FLOPS, BW = 67e12, 3.35e12
ATOL, RTOL = 1e-5, 1e-4
MINI = ("experiment_config/"
        "mini-imagenet_maml++-mini-imagenet_5_5_2_0.01_48_0.json")
OMNIGLOT = "experiment_config/omniglot_maml++-omniglot_1_20_8_0.1_64_0.json"


def cases():
    """(dtype, tag, kernel, layer, H = W, C, N) of every row."""
    for dtype, tag in DTYPES:
        for kernel, layer, hw, c, n in ROWS:
            yield dtype, tag, kernel, layer, hw, c, n


def _gate(got, want):
    """The largest error over the outputs, within the twin gate."""
    err = 0.0
    for g, w in zip(got, want):
        diff = (g.double() - w.double()).abs()
        scale = w.double().abs().max().item()
        if w.dtype == torch.bfloat16:
            _, e = torch.frexp(w.double().abs().clamp_min(2.0 ** -126))
            tol = torch.ldexp(torch.ones_like(diff), e - 8).clamp_min(
                1e-4 * scale)
            bad = bool((diff > tol).any())
        else:
            bad = diff.max().item() > ATOL + RTOL * scale
        if bad or not torch.isfinite(g).all():
            raise AssertionError(f"max |kernel - twin| "
                                 f"{diff.max().item():.3e} at scale "
                                 f"{scale:.3e}")
        err = max(err, diff.max().item())
    return err


def calls(cb, F, dtype, kernel, hw, c, n):
    """(wrapper call, twin call, FLOPs, bytes) at one shape, on inputs from
    a numpy seed."""
    rng = np.random.RandomState(hw + c + n)
    shape = (T, n, hw, hw, c)

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).cuda().to(dtype)

    y = t(rng.rand(*shape) if c <= 3 else 0.5 + 2.0 * rng.randn(*shape))
    da, a = t(rng.randn(*shape)), t(rng.randn(*shape))
    mean, _, rstd = F.bn_input_stats(y)
    gamma = t(1.0 + 0.1 * rng.randn(T, c))
    beta = t(0.1 * rng.randn(T, c))
    args = (a, t(rng.randn(T, c)), t(rng.randn(T, c)), da, y, mean, rstd,
            gamma, beta)
    numel, esize = y.numel(), y.element_size()
    nbytes = esize * (5 * numel + 7 * T * c)
    if kernel == "bn_act_bwd_bwd":
        return (lambda: cb.bn_act_bwd_bwd(*args, SLOPE),
                lambda: F.bn_act_bwd_bwd(*args, SLOPE), 42 * numel, nbytes)
    return (lambda: cb.batch_norm_bwd_bwd(*args),
            lambda: F.batch_norm_bwd_bwd(*args), 42 * numel, nbytes)


def rows(label):
    from howtotrainyourmamlpytorch_tpu_torch.kernels import conv_block as cb
    from howtotrainyourmamlpytorch_tpu_torch.ops import functional as F

    out = []
    # every row's event times first, then the profiles
    for dtype, tag, kernel, layer, hw, c, n in cases():
        call, twin, flops, nbytes = calls(cb, F, dtype, kernel, hw, c, n)
        t_ops, t_bytes = flops / FLOPS, nbytes / BW
        out.append({
            "build": label, "dtype": tag, "kernel": kernel, "layer": layer,
            "hw": hw, "C": c, "N": n, "T": T,
            "max_abs_err": _gate(call(), twin()),
            "ms": time_ms(call),
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops > t_bytes else "bytes",
            # a, da and y read twice from device memory: 8 of the bound's
            # 5 tensor passes
            "two_pass_cap": 5 / 8,
        })
        del call, twin
        torch.cuda.empty_cache()
    for r, (dtype, tag, kernel, layer, hw, c, n) in zip(out, cases()):
        call, *_ = calls(cb, F, dtype, kernel, hw, c, n)
        r["device_ms"], r["kernels_a_call"] = device_ms(call)
        dev = r["device_ms"]
        extra = ("" if dev is None else
                 f", host {r['ms'] - dev:.4f} ms, "
                 f"{100 * r['bound_ms'] / dev:.1f}% of the bound by device "
                 "time")
        print(f"[k5f {label}] {tag} {kernel} {layer} N={n}: {r['ms']:.4f} "
              f"ms (device {fmt_ms(dev)}, {r['kernels_a_call']:g} kernels "
              f"a call{extra}), no library call, bound {r['bound_ms']:.4f} "
              f"ms ({r['bound_by']}), err {r['max_abs_err']:.2e}",
              flush=True)
        del call
        torch.cuda.empty_cache()
    return out


def _part(key):
    """Which of the pool-free K5 and ``act_pool_gather`` a device kernel
    is: the CUDA kernels, or the Triton kernels they replace (the pooled
    K5, ``bn_act_pool_bwd_bwd``, is neither); None for the rest."""
    if "bn_act_bwd_bwd" in key:
        return "k5 free"
    if "act_pool_gather_kernel" in key:
        return "act pool gather"
    return None


PARTS = card_timing.by_part(_part, ("k5 free", "act pool gather"))


def e2e(label):
    from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig

    models = (
        ("strided", MAMLConfig.from_json_file(OMNIGLOT).replace(
            max_pooling=False, batch_size=8)),
        ("norm-first", MAMLConfig.from_json_file(MINI).replace(
            block_order="norm_conv_relu", batch_size=2)),
    )
    out = []
    for tag, base in models:
        for dtype, dt in (("float32", "f32"), ("bfloat16", "bf16")):
            cfg = base.replace(compute_dtype=dtype)
            out.append(card_timing.train_step("k5f", label, cfg,
                                              f"{tag} {dt}", PARTS))
            torch.cuda.empty_cache()
    return out


def main(argv) -> int:
    if "--no-stage" in argv:
        from howtotrainyourmamlpytorch_tpu_torch.kernels import conv_block

        argv = [a for a in argv if a != "--no-stage"]
        if hasattr(conv_block, "BN_ACT_BWD_BWD_STAGE_BYTES"):
            conv_block.BN_ACT_BWD_BWD_STAGE_BYTES = 0
    return card_timing.main(argv, "k5f", __doc__.split("\n")[0], rows, e2e)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
