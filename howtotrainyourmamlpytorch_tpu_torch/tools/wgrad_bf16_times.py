"""Time K4 wgrad in bf16 at stride 1, pad 1 and 0, at every shape the
shipped configs give it, beside one PyTorch call that computes the same
gradient in bf16 (``torch.nn.grad.conv2d_weight`` on the tenants as conv
groups) and the bound: the check that one build's bf16 wgrad is faster
than another's, compared in one process run after the other on one card.

    PYTHONPATH=<checkout> python3 <this file> [--label NAME] [--out FILE]

Run by path, so that ``PYTHONPATH`` picks the package whose kernels are
built and launched (each checkout builds its own into its own
``_build/``); the script uses only the wrapper ``conv3x3_wgrad``, which
every build has. Inputs come from a numpy seed, T = 8 tenants, bf16: the
mini-ImageNet stages 0-3 (84/42/21/10, cin 3 then 48, cout 48; stage 0 is
also the norm-first models', whose x is the normalized image) and the
unpadded stages (84/41/19/8) at N = 25, the Omniglot layers 1-4 (28/14/7/3,
cin 1 then 64, cout 64) at N = 20. Per row: the wrapper's time by CUDA
events (host time included: ``card_timing.time_ms``, every row timed
before the first profile), its kernels' device time by ``torch.profiler``
(every kernel whose name holds ``wgrad``: the products and the reduce of
the split partials) and their launches a call, the library call's event
time, and the bound: max(bytes / 3.35 TB/s, FLOPs / 989 TFLOP/s) on an
H100 SXM, x and dy read once and dw and db written once in 2-byte
elements. Prints one line per row, the card's ``nvidia-smi`` line, and
(with ``--out``) writes every row as JSON. Needs one card.
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
CASES = (("mini", 1, 48, 25, MINI),
         ("unpadded", 0, 48, 25, MINI_P0),
         ("omniglot", 1, 64, 20, OMNIGLOT))
BF = torch.bfloat16


def cases():
    """(model, pad, cout, layer, H = W, cin, N) of every row."""
    for model, pad, cout, n, layers in CASES:
        for layer, hw, cin in layers:
            yield model, pad, cout, layer, hw, cin, n


def calls(cb, pad, cout, hw, cin, n):
    """The library call, the wrapper's call, and the row's (FLOPs, bytes),
    on bf16 inputs from a numpy seed."""
    rng = np.random.RandomState(hw + cin + n + pad)
    ho = hw + 2 * pad - 2

    def r(*shape):
        return torch.from_numpy(
            rng.randn(*shape).astype(np.float32)).cuda().to(BF)

    x = r(T, n, hw, hw, cin)
    dy = r(T, n, ho, ho, cout)
    xl = x.permute(1, 0, 4, 2, 3).reshape(n, T * cin, hw, hw).contiguous()
    dyl = dy.permute(1, 0, 4, 2, 3).reshape(n, T * cout, ho, ho).contiguous()
    M = n * ho * ho  # output (dy) pixels a tenant
    return (lambda: torch.nn.grad.conv2d_weight(
                xl, (T * cout, cin, 3, 3), dyl, padding=pad, groups=T),
            lambda: cb.conv3x3_wgrad(x, dy, padding=pad),
            2 * T * M * 9 * cin * cout + T * M * cout,
            2 * (x.numel() + dy.numel() + T * 9 * cin * cout + T * cout))


def rows(label):
    from howtotrainyourmamlpytorch_tpu_torch.kernels import conv_block as cb

    flops_peak, bw_peak = 989e12, 3.35e12
    out = []
    # every row's event times first, then the profiles
    for model, pad, cout, layer, hw, cin, n in cases():
        library, fn, flops, nbytes = calls(cb, pad, cout, hw, cin, n)
        t_ops, t_bytes = flops / flops_peak, nbytes / bw_peak
        out.append({
            "build": label, "model": model, "layer": layer, "hw": hw,
            "cin": cin, "cout": cout, "pad": pad, "N": n, "T": T,
            "ms": time_ms(fn), "library_ms": time_ms(library),
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops > t_bytes else "bytes",
        })
        del library, fn
        torch.cuda.empty_cache()
    for r, case in zip(out, cases()):
        model, pad, cout, layer, hw, cin, n = case
        _, fn, _, _ = calls(cb, pad, cout, hw, cin, n)
        r["device_ms"], r["launches"] = device_ms(
            fn, keep=lambda key: "wgrad" in key)
        dev = r["device_ms"]
        share = ("" if dev is None else
                 f", {100 * r['bound_ms'] / dev:.1f}% by device time")
        print(f"[K4 wgrad bf16 {label}] {model} {layer} pad {pad} N={n}: "
              f"{r['ms']:.4f} ms (device {fmt_ms(dev)}, "
              f"{r['launches']:g} launches), library "
              f"{r['library_ms']:.4f} ms ({r['ms'] / r['library_ms']:.2f}x),"
              f" bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
              f"{100 * r['bound_ms'] / r['ms']:.1f}%{share})", flush=True)
        del fn
        torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], "K4 wgrad bf16", __doc__.split("\n")[0],
                  rows))
