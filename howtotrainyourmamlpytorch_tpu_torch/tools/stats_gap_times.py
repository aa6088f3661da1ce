"""Time ``bn_input_stats`` and the global average pool (forward and
backward), in f32 and bf16, at every shape the port's models give them,
beside their bound and one PyTorch call that computes the same function
(``torch.var_mean``, ``mean``, ``aten._adaptive_avg_pool2d_backward``);
with ``--e2e``, the norm-first and the strided models' batch-2 train
steps and bucket-8 serve dispatches in f32 and bf16 as well: the check that
one build's kernels are faster than another's, compared in one process run
after the other on one card (parent, change, change, parent).

    PYTHONPATH=<checkout> python3 <this file> [--label NAME] [--out FILE]
                                              [--e2e]

Run by path, so that ``PYTHONPATH`` picks the package whose kernels are
built and launched (each checkout builds its own into its own
``_build/``); the script uses only the wrappers ``bn_input_stats``,
``global_avg_pool2d_fwd`` and ``global_avg_pool2d_bwd`` of
``kernels/conv_block.py``, their twins and the train and serve entry
points, which every build has. Inputs come from a numpy seed, T = 8
tenants: the statistics at every block input of the norm-first models at
N = 75 images — the mini-ImageNet stages (84 x 84 x 3, then 42/21/10 x
48), the unpadded model's (41/19/8 x 48) — and at N = 20 the strided
Omniglot norm-first model's (the 28 x 28 x 1 image, then 14/7/4 x 64);
pixels in [0, 1] at the images, activations elsewhere. The GAP at the
strided models' last maps: Omniglot 2 x 2 x 64 at N = 20 and the unpadded
mini-ImageNet 4 x 4 x 48 at N = 75. Per row: the wrapper's time by CUDA
events (host time included: ``card_timing.time_ms``, every row timed
before the first profile), the device time of every kernel the call
launches and their count a call by ``torch.profiler``, the host time a
call (events ms less device ms), the library call's event time, the error
against the twin (f32 within 1e-5 + 1e-4 * scale, the bf16 statistics
within one bf16 ulp or 1e-4 of scale, the bf16 GAP bit for bit), and the
bound: max(bytes / 3.35 TB/s, FLOPs / 67 TFLOP/s) on an H100 SXM, each
input read once and each output written once.

``--e2e`` then profiles one warm second-order train step at batch 2 and
one warm bucket-8 serve dispatch of the mini-ImageNet MAML++ config
(``experiment_config/mini-imagenet_maml++-mini-imagenet_5_5_2_0.01_48_0.json``)
with ``block_order='norm_conv_relu'``, and of the Omniglot 20-way 1-shot
config (``experiment_config/omniglot_maml++-omniglot_1_20_8_0.1_64_0.json``)
with ``max_pooling=False``, in f32 and bf16: the device's busy time, its
activities, and the device time and launches of ``bn_input_stats`` and of
the GAP (the CUDA kernels, or the Triton kernels they replace). Prints one
line per row with the card's ``nvidia-smi`` line first and (with
``--out``) writes every row as JSON. Needs one card.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

import card_timing
from card_timing import device_ms, fmt_ms, time_ms

T = 8
# (layer, H = W, C, N) of every bn_input_stats row
STATS = (("norm-first stage0", 84, 3, 75), ("norm-first stage1", 42, 48, 75),
         ("norm-first stage2", 21, 48, 75), ("norm-first stage3", 10, 48, 75),
         ("unpadded stage1", 41, 48, 75), ("unpadded stage2", 19, 48, 75),
         ("unpadded stage3", 8, 48, 75),
         ("strided L1", 28, 1, 20), ("strided L2", 14, 64, 20),
         ("strided L3", 7, 64, 20), ("strided L4", 4, 64, 20))
# (layer, H = W, C, N) of every GAP row
GAP = (("strided L4", 2, 64, 20), ("unpadded strided stage3", 4, 48, 75))
KERNELS = ("bn_input_stats", "global_avg_pool2d_fwd", "global_avg_pool2d_bwd")
DTYPES = ((torch.float32, "f32"), (torch.bfloat16, "bf16"))
FLOPS, BW = 67e12, 3.35e12
ATOL, RTOL = 1e-5, 1e-4
MINI = ("experiment_config/"
        "mini-imagenet_maml++-mini-imagenet_5_5_2_0.01_48_0.json")
OMNIGLOT = "experiment_config/omniglot_maml++-omniglot_1_20_8_0.1_64_0.json"


def cases():
    """(dtype, tag, kernel, layer, H = W, C, N) of every row."""
    for dtype, tag in DTYPES:
        for layer, hw, c, n in STATS:
            yield dtype, tag, KERNELS[0], layer, hw, c, n
        for kernel in KERNELS[1:]:
            for layer, hw, c, n in GAP:
                yield dtype, tag, kernel, layer, hw, c, n


def _gate(got, want, exact):
    """The largest error over the outputs, within the twin gate."""
    err = 0.0
    for g, w in zip(got, want):
        diff = (g.double() - w.double()).abs()
        scale = w.double().abs().max().item()
        if exact:
            bad = not torch.equal(g, w)
        elif w.dtype == torch.bfloat16:
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
    """(wrapper call, twin call, library call, FLOPs, bytes) at one shape,
    on inputs from a numpy seed."""
    rng = np.random.RandomState(hw + c + n)
    shape = (T, n, hw, hw, c)
    x = torch.from_numpy((rng.rand(*shape) if c <= 3 else
                          rng.randn(*shape)).astype(np.float32)).cuda()
    x = x.to(dtype)
    numel, esize = x.numel(), x.element_size()
    if kernel == "bn_input_stats":
        return (lambda: cb.bn_input_stats(x), lambda: F.bn_input_stats(x),
                lambda: torch.var_mean(x, dim=(1, 2, 3), correction=0),
                4 * numel, esize * (numel + 3 * T * c))
    if kernel == "global_avg_pool2d_fwd":
        return (lambda: cb.global_avg_pool2d_fwd(x),
                lambda: F.global_avg_pool2d(x),
                lambda: x.mean(dim=(-3, -2)), numel,
                esize * (numel + T * n * c))
    g = torch.from_numpy(rng.randn(T, n, c).astype(np.float32)).cuda().to(
        dtype)
    # the library's backward on the tenants' images as a channels-last
    # (T * N, C, h, w) batch (views, no copy)
    view = x.reshape(T * n, hw, hw, c).permute(0, 3, 1, 2)
    grad = g.reshape(T * n, c, 1, 1)
    return (lambda: cb.global_avg_pool2d_bwd(g, hw, hw),
            lambda: F.global_avg_pool2d_bwd(g, hw, hw),
            lambda: torch.ops.aten._adaptive_avg_pool2d_backward(grad, view),
            numel, esize * (numel + g.numel()))


def rows(label):
    from howtotrainyourmamlpytorch_tpu_torch.kernels import conv_block as cb
    from howtotrainyourmamlpytorch_tpu_torch.ops import functional as F

    out = []
    # every row's event times first, then the profiles
    for dtype, tag, kernel, layer, hw, c, n in cases():
        call, twin, lib, flops, nbytes = calls(cb, F, dtype, kernel, hw, c,
                                               n)
        got, want = call(), twin()
        if kernel != "bn_input_stats":
            got, want = (got,), (want,)
        t_ops, t_bytes = flops / FLOPS, nbytes / BW
        out.append({
            "build": label, "dtype": tag, "kernel": kernel, "layer": layer,
            "hw": hw, "C": c, "N": n, "T": T,
            "max_abs_err": _gate(got, want, kernel != "bn_input_stats"
                                 and dtype == torch.bfloat16),
            "ms": time_ms(call), "library_ms": time_ms(lib),
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops > t_bytes else "bytes",
        })
        del call, twin, lib, got, want
        torch.cuda.empty_cache()
    for r, (dtype, tag, kernel, layer, hw, c, n) in zip(out, cases()):
        call, *_ = calls(cb, F, dtype, kernel, hw, c, n)
        r["device_ms"], r["kernels_a_call"] = device_ms(call)
        dev = r["device_ms"]
        extra = ("" if dev is None else
                 f", host {r['ms'] - dev:.4f} ms, "
                 f"{100 * r['bound_ms'] / dev:.1f}% of the bound by device "
                 "time")
        print(f"[sg {label}] {tag} {kernel} {layer} N={n}: {r['ms']:.4f} ms "
              f"(device {fmt_ms(dev)}, {r['kernels_a_call']:g} kernels a "
              f"call{extra}), library {r['library_ms']:.4f} ms "
              f"({r['ms'] / r['library_ms']:.2f}x), bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), err "
              f"{r['max_abs_err']:.2e}", flush=True)
        del call
        torch.cuda.empty_cache()
    return out


def _part(key):
    """Which of the statistics and the GAP a device kernel is: the CUDA
    kernels, or the Triton kernels they replace; None for the rest."""
    if "bn_input_stats" in key or key.startswith(
            ("_stats_partial_kernel", "_stats_merge_kernel")):
        return "bn stats"
    if "global_avg_pool" in key or key.startswith(
            ("_gap_fwd_kernel", "_gap_bwd_kernel")):
        return "gap"
    return None


PARTS = card_timing.by_part(_part, ("bn stats", "gap"))


def e2e(label):
    from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig

    models = (
        ("norm-first", MAMLConfig.from_json_file(MINI).replace(
            block_order="norm_conv_relu", batch_size=2)),
        ("strided", MAMLConfig.from_json_file(OMNIGLOT).replace(
            max_pooling=False, batch_size=2)),
    )
    out = []
    for tag, base in models:
        for dtype, dt in (("float32", "f32"), ("bfloat16", "bf16")):
            cfg = base.replace(compute_dtype=dtype)
            what = f"{tag} {dt}"
            out.append(card_timing.train_step("sg", label, cfg, what,
                                              PARTS))
            torch.cuda.empty_cache()
            out.append(card_timing.dispatch("sg", label, cfg, what, PARTS))
            torch.cuda.empty_cache()
    return out


def main(argv) -> int:
    return card_timing.main(argv, "sg", __doc__.split("\n")[0], rows, e2e)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
