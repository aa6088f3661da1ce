"""Time K1 in f32 at stride 1 (with statistics and stats-free) at every
shape the shipped configs give it, beside one PyTorch call that computes
the same conv (grouped ``F.conv2d``) and the bound: the check that one
build's K1 is faster than another's, compared in one process run after
the other on one card.

    PYTHONPATH=<checkout> python3 <this file> [--label NAME] [--out FILE]

Run by path, so that ``PYTHONPATH`` picks the package whose kernels are
built and launched (each checkout builds its own into its own
``_build/``); the script uses only the wrappers ``conv3x3_fwd_stats`` and
``conv3x3_fwd``, which every build has. Inputs come from a numpy seed, T
= 8 tenants: the mini-ImageNet stages 0-3 (84/42/21/10, cin 3 then 48,
cout 48) at N = 25 and 75, the Omniglot layers 1-4 (28/14/7/3, cin 1
then 64, cout 64) at N = 20, the unpadded stages (84/41/19/8) at N = 25
and 75, in both modes (stats-free with the bias, as Wgrad's backward
passes it). Per row: the wrapper's time by CUDA events (host time
included, 20 calls after a warmup), its kernels' device time by
``torch.profiler`` (the conv and, with statistics, the merge), the
library call's event time, and the bound: max(bytes / 3.35 TB/s, FLOPs /
67 TFLOP/s) on an H100 SXM, each input read once and each output written
once. Prints one line per row, the card's ``nvidia-smi`` line, and (with
``--out``) writes every row as JSON. Needs one card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

T = 8
MINI = (("stage0", 84, 3), ("stage1", 42, 48), ("stage2", 21, 48),
        ("stage3", 10, 48))
MINI_P0 = (("stage0", 84, 3), ("stage1", 41, 48), ("stage2", 19, 48),
           ("stage3", 8, 48))
OMNIGLOT = (("L1", 28, 1), ("L2", 14, 64), ("L3", 7, 64), ("L4", 3, 64))
# (model, pad, cout, images, layers)
CASES = (("mini", 1, 48, (25, 75), MINI),
         ("omniglot", 1, 64, (20,), OMNIGLOT),
         ("unpadded", 0, 48, (25, 75), MINI_P0))
REPS = 20


def time_ms(fn, reps=REPS):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps=REPS):
    """The device time per call of ``fn``'s K1 kernels (the conv, the
    statistics' merge), from ``torch.profiler``; None where it shows none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.device_time_total for e in prof.key_averages()
                if "conv3x3_fwd" in e.key or "bn_stats_merge" in e.key)
    return total / 1e3 / reps if total else None


def rows(label):
    from howtotrainyourmamlpytorch_tpu_torch.kernels import conv_block as cb

    flops_peak, bw_peak = 67e12, 3.35e12
    out = []
    for model, pad, cout, images, layers in CASES:
        for layer, hw, cin in layers:
            for n in images:
                rng = np.random.RandomState(hw + cin + n)
                x = torch.from_numpy(
                    rng.randn(T, n, hw, hw, cin).astype(np.float32)).cuda()
                w = torch.from_numpy(
                    (rng.randn(T, 3, 3, cin, cout) * (2.0 / (9 * cin)) ** 0.5
                     ).astype(np.float32)).cuda()
                b = torch.from_numpy(
                    (rng.randn(T, cout) * 0.1).astype(np.float32)).cuda()
                ho = hw + 2 * pad - 2
                xl = x.permute(1, 0, 4, 2, 3).reshape(n, T * cin, hw, hw)
                xl = xl.contiguous()
                wl = w.permute(0, 4, 3, 1, 2).reshape(T * cout, cin, 3, 3)
                wl = wl.contiguous()
                bl = b.reshape(-1).contiguous()
                M = n * ho * ho
                flops = 2 * T * M * 9 * cin * cout + T * M * cout
                library = time_ms(lambda: torch.nn.functional.conv2d(
                    xl, wl, bl, padding=pad, groups=T))
                for mode, fn in (
                        ("stats", lambda: cb.conv3x3_fwd_stats(
                            x, w, b, padding=pad)),
                        ("stats-free", lambda: cb.conv3x3_fwd(
                            x, w, b, padding=pad))):
                    # x, w, b read once, y (and the statistics) written once
                    nbytes = 4 * (x.numel() + w.numel() + b.numel()
                                  + T * M * cout
                                  + (3 * T * cout if mode == "stats" else 0))
                    t_ops, t_bytes = flops / flops_peak, nbytes / bw_peak
                    r = {
                        "build": label, "model": model, "layer": layer,
                        "hw": hw, "cin": cin, "cout": cout, "pad": pad,
                        "N": n, "T": T, "mode": mode, "ms": time_ms(fn),
                        "device_ms": device_ms(fn), "library_ms": library,
                        "bound_ms": max(t_ops, t_bytes) * 1e3,
                        "bound_by": ("operations" if t_ops > t_bytes
                                     else "bytes"),
                    }
                    out.append(r)
                    dev = ("not measured" if r["device_ms"] is None
                           else f"{r['device_ms']:.4f}")
                    print(f"[K1 {label}] {model} {layer} pad {pad} N={n} "
                          f"{mode}: {r['ms']:.4f} ms (device {dev}), "
                          f"library {library:.4f} ms "
                          f"({r['ms'] / library:.2f}x), bound "
                          f"{r['bound_ms']:.4f} ms ({r['bound_by']}, "
                          f"{100 * r['bound_ms'] / r['ms']:.1f}%)",
                          flush=True)
                del x, xl
                torch.cuda.empty_cache()
    return out


def main(argv) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--label", default="this build")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k1_times: needs a CUDA card")
    from howtotrainyourmamlpytorch_tpu_torch.device import resolve_device

    resolve_device("cuda:0")  # TF32 off for the library call
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"[K1 {args.label}] {card}", flush=True)
    out = rows(args.label)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "rows": out}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
