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
included: ``card_timing.time_ms``, every row timed before the first
profile), its kernels' device time by ``torch.profiler`` (the conv and,
with statistics, the merge), the library call's event time, and the
bound: max(bytes / 3.35 TB/s, FLOPs / 67 TFLOP/s) on an H100 SXM, each
input read once and each output written once. Prints one line per row,
the card's ``nvidia-smi`` line, and (with ``--out``) writes every row as
JSON. Needs one card.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from card_timing import device_ms, fmt_ms, main, time_ms

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
MODES = ("stats", "stats-free")


def _is_k1(key):
    return "conv3x3_fwd" in key or "bn_stats_merge" in key


def cases():
    """(model, pad, cout, layer, H = W, cin, N) of every shape."""
    for model, pad, cout, images, layers in CASES:
        for layer, hw, cin in layers:
            for n in images:
                yield model, pad, cout, layer, hw, cin, n


def calls(cb, pad, cout, hw, cin, n):
    """The library call, the two modes' wrapper calls, and the conv's
    (FLOPs, M = output pixels a tenant) at one shape, on inputs from a
    numpy seed."""
    rng = np.random.RandomState(hw + cin + n)
    x = torch.from_numpy(
        rng.randn(T, n, hw, hw, cin).astype(np.float32)).cuda()
    w = torch.from_numpy(
        (rng.randn(T, 3, 3, cin, cout) * (2.0 / (9 * cin)) ** 0.5
         ).astype(np.float32)).cuda()
    b = torch.from_numpy(
        (rng.randn(T, cout) * 0.1).astype(np.float32)).cuda()
    ho = hw + 2 * pad - 2
    xl = x.permute(1, 0, 4, 2, 3).reshape(n, T * cin, hw, hw).contiguous()
    wl = w.permute(0, 4, 3, 1, 2).reshape(T * cout, cin, 3, 3).contiguous()
    bl = b.reshape(-1).contiguous()
    M = n * ho * ho
    flops = 2 * T * M * 9 * cin * cout + T * M * cout
    # x, w, b read once, y (and the statistics) written once
    nbytes = 4 * (x.numel() + w.numel() + b.numel() + T * M * cout)
    return (lambda: torch.nn.functional.conv2d(xl, wl, bl, padding=pad,
                                               groups=T),
            {"stats": lambda: cb.conv3x3_fwd_stats(x, w, b, padding=pad),
             "stats-free": lambda: cb.conv3x3_fwd(x, w, b, padding=pad)},
            flops, {"stats": nbytes + 4 * 3 * T * cout, "stats-free": nbytes})


def rows(label):
    from howtotrainyourmamlpytorch_tpu_torch.kernels import conv_block as cb

    flops_peak, bw_peak = 67e12, 3.35e12
    out = []
    # every row's event times first, then the profiles
    for model, pad, cout, layer, hw, cin, n in cases():
        library, fns, flops, nbytes = calls(cb, pad, cout, hw, cin, n)
        library_ms = time_ms(library)
        for mode in MODES:
            t_ops, t_bytes = flops / flops_peak, nbytes[mode] / bw_peak
            out.append({
                "build": label, "model": model, "layer": layer, "hw": hw,
                "cin": cin, "cout": cout, "pad": pad, "N": n, "T": T,
                "mode": mode, "ms": time_ms(fns[mode]),
                "library_ms": library_ms,
                "bound_ms": max(t_ops, t_bytes) * 1e3,
                "bound_by": "operations" if t_ops > t_bytes else "bytes",
            })
        del library, fns
        torch.cuda.empty_cache()
    rows_in_order = iter(out)
    for model, pad, cout, layer, hw, cin, n in cases():
        _, fns, _, _ = calls(cb, pad, cout, hw, cin, n)
        for mode in MODES:
            r = next(rows_in_order)
            r["device_ms"] = device_ms(fns[mode], keep=_is_k1)[0]
            print(f"[K1 {label}] {model} {layer} pad {pad} N={n} {mode}: "
                  f"{r['ms']:.4f} ms (device {fmt_ms(r['device_ms'])}), "
                  f"library {r['library_ms']:.4f} ms "
                  f"({r['ms'] / r['library_ms']:.2f}x), bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']}, "
                  f"{100 * r['bound_ms'] / r['ms']:.1f}%)", flush=True)
        del fns
        torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], "K1", __doc__.split("\n")[0], rows))
