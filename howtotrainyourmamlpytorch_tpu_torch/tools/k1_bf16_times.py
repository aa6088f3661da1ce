"""Time K1 (with statistics and stats-free) and K4 dgrad in bf16 at stride 1,
pad 1 and 0, at every shape the shipped configs give them, beside one
PyTorch call that computes the same conv in bf16 (grouped ``F.conv2d``,
``conv2d_input``) and the bound at the bf16 tensor-core rate: the check
that one build's bf16 convs are faster than another's, compared in one
process run after the other on one card.

    PYTHONPATH=<checkout> python3 <this file> [--label NAME] [--out FILE]

Run by path, so that ``PYTHONPATH`` picks the package whose kernels are
built and launched (each checkout builds its own into its own
``_build/``); the script uses only the wrappers ``conv3x3_fwd_stats``,
``conv3x3_fwd`` and ``conv3x3_dgrad``, which every build has. Inputs come
from a numpy seed, T = 8 tenants, bf16: K1 at the mini-ImageNet stages 0-3
(84/42/21/10, cin 3 then 48, cout 48) at N = 25 and 75, the Omniglot
layers 1-4 (28/14/7/3, cin 1 then 64, cout 64) at N = 20, the unpadded
stages (84/41/19/8) at N = 25 and 75, in both modes (stats-free with the
bias, as Wgrad's backward passes it); dgrad at N = 25 (Omniglot N = 20)
at the same stages, back to cin 3 at stage 0 (the norm-first models),
Omniglot's layers 2-4. Per row: the wrapper's time by CUDA events (host
time included: ``card_timing.time_ms``, every row timed before the first
profile), its kernels' device time by ``torch.profiler`` (the conv and,
with statistics, the merge), the library call's event time, and the
bound: max(bytes / 3.35 TB/s, FLOPs / 989 TFLOP/s) on an H100 SXM, each
input read once and each output written once in 2-byte elements. Prints
one line per row, the card's ``nvidia-smi`` line, and (with ``--out``)
writes every row as JSON. Needs one card.
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
# (model, pad, cout, K1's images, dgrad's images, layers)
CASES = (("mini", 1, 48, (25, 75), 25, MINI),
         ("omniglot", 1, 64, (20,), 20, OMNIGLOT),
         ("unpadded", 0, 48, (25, 75), 25, MINI_P0))
MODES = ("stats", "stats-free", "dgrad")
BF = torch.bfloat16


def _is_conv(key):
    return "conv3x3" in key or "bn_stats_merge" in key


def cases():
    """(model, pad, cout, layer, H = W, cin, N, mode) of every row: K1 in
    both modes, dgrad where a loss reads dx (not Omniglot's layer 1)."""
    for model, pad, cout, images, dgrad_n, layers in CASES:
        for layer, hw, cin in layers:
            for n in images:
                for mode in MODES[:2]:
                    yield model, pad, cout, layer, hw, cin, n, mode
            if not (model == "omniglot" and cin == 1):
                yield model, pad, cout, layer, hw, cin, dgrad_n, "dgrad"


def calls(cb, pad, cout, hw, cin, n, mode):
    """The library call, the wrapper's call, and the row's (FLOPs,
    bytes), on bf16 inputs from a numpy seed."""
    rng = np.random.RandomState(hw + cin + n)

    def r(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.randn(*shape) * scale).astype(np.float32)).cuda().to(BF)

    x = r(T, n, hw, hw, cin)
    w = r(T, 3, 3, cin, cout, scale=(2.0 / (9 * cin)) ** 0.5)
    b = r(T, cout, scale=0.1)
    ho = hw + 2 * pad - 2
    xl = x.permute(1, 0, 4, 2, 3).reshape(n, T * cin, hw, hw).contiguous()
    wl = w.permute(0, 4, 3, 1, 2).reshape(T * cout, cin, 3, 3).contiguous()
    M = n * ho * ho  # output (dy) pixels a tenant
    flops = 2 * T * M * 9 * cin * cout
    if mode == "dgrad":
        dy = r(T, n, ho, ho, cout)
        dyl = dy.permute(1, 0, 4, 2, 3).reshape(
            n, T * cout, ho, ho).contiguous()
        return (lambda: torch.nn.grad.conv2d_input(
                    xl.shape, wl, dyl, padding=pad, groups=T),
                lambda: cb.conv3x3_dgrad(dy, w, 1, (hw, hw), pad),
                flops, 2 * (dy.numel() + w.numel() + x.numel()))
    bl = b.reshape(-1).contiguous()
    nbytes = 2 * (x.numel() + w.numel() + b.numel() + T * M * cout)
    library = (lambda: torch.nn.functional.conv2d(xl, wl, bl, padding=pad,
                                                  groups=T))
    if mode == "stats":
        return (library, lambda: cb.conv3x3_fwd_stats(x, w, b, padding=pad),
                flops + T * M * cout, nbytes + 2 * 3 * T * cout)
    return (library, lambda: cb.conv3x3_fwd(x, w, b, padding=pad),
            flops + T * M * cout, nbytes)


def rows(label):
    from howtotrainyourmamlpytorch_tpu_torch.kernels import conv_block as cb

    flops_peak, bw_peak = 989e12, 3.35e12
    out = []
    # every row's event times first, then the profiles
    for model, pad, cout, layer, hw, cin, n, mode in cases():
        library, fn, flops, nbytes = calls(cb, pad, cout, hw, cin, n, mode)
        t_ops, t_bytes = flops / flops_peak, nbytes / bw_peak
        out.append({
            "build": label, "model": model, "layer": layer, "hw": hw,
            "cin": cin, "cout": cout, "pad": pad, "N": n, "T": T,
            "mode": mode, "ms": time_ms(fn), "library_ms": time_ms(library),
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops > t_bytes else "bytes",
        })
        del library, fn
        torch.cuda.empty_cache()
    for r, case in zip(out, cases()):
        model, pad, cout, layer, hw, cin, n, mode = case
        _, fn, _, _ = calls(cb, pad, cout, hw, cin, n, mode)
        r["device_ms"] = device_ms(fn, keep=_is_conv)[0]
        dev = r["device_ms"]
        share = ("" if dev is None else
                 f", {100 * r['bound_ms'] / dev:.1f}% by device time")
        print(f"[K1 bf16 {label}] {model} {layer} pad {pad} N={n} {mode}: "
              f"{r['ms']:.4f} ms (device {fmt_ms(dev)}), library "
              f"{r['library_ms']:.4f} ms ({r['ms'] / r['library_ms']:.2f}x),"
              f" bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
              f"{100 * r['bound_ms'] / r['ms']:.1f}%{share})", flush=True)
        del fn
        torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], "K1 bf16", __doc__.split("\n")[0], rows))
