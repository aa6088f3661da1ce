"""Time K1 (with statistics and stats-free) and K4 dgrad and wgrad at stride
2, in f32 and bf16, pad 1 and 0, at every stride-2 shape the shipped configs
give them, beside one PyTorch call that computes the same conv (grouped
``F.conv2d(stride=2)``, ``conv2d_input``, ``conv2d_weight``) and the bound;
with ``--e2e``,
the stride-2 models' steps and dispatches as well: the check that one
build's stride-2 convs are faster than another's, compared in one process
run after the other on one card.

    PYTHONPATH=<checkout> python3 <this file> [--label NAME] [--out FILE]
                                              [--e2e]

Run by path, so that ``PYTHONPATH`` picks the package whose kernels are
built and launched (each checkout builds its own into its own
``_build/``); the script uses only the wrappers ``conv3x3_fwd_stats``,
``conv3x3_fwd``, ``conv3x3_dgrad`` and ``conv3x3_wgrad`` and the train and
serve entry points, which every build has. Inputs come from a numpy seed, T = 8 tenants: the
strided Omniglot model's layers 1-4 (28/14/7/4, cin 1 then 64, cout 64,
pad 1) at N = 20, the unpadded strided mini-ImageNet model's stages 0-3
(84/41/20/9, cin 3 then 48, cout 48, pad 0) with statistics at N = 75 and
stats-free (with the bias, as Wgrad's backward passes it) and dgrad at N =
25; dgrad at layers 2-4 and, for the norm-first models, back to the image
(cin 1 and 3); wgrad (with the bias) at every layer at N = 20 and 25. Per row: the wrapper's time by CUDA events (host time
included: ``card_timing.time_ms``, every row timed before the first
profile), its kernels' device time by ``torch.profiler`` (every kernel
whose name holds ``conv3x3`` and the statistics' merge), the library
call's event time, and the bound: max(bytes / 3.35 TB/s, useful FLOPs /
peak) on an H100 SXM — 67 TFLOP/s f32 (FFMA), 989 bf16 (tensor cores) —
each input read once and each output written once.

``--e2e`` then profiles one warm second-order train step (batch 8) of the
strided Omniglot model (``experiment_config/omniglot_maml++-omniglot_1_20_8
_0.1_64_0.json`` with ``max_pooling=False``) in f32 and bf16 and, in bf16,
of the unpadded strided mini-ImageNet model (the mini-ImageNet MAML++
config with ``conv_padding=False, max_pooling=False``, batch 2) and one
warm bucket-8 serve dispatch of it: the device's busy time and the
stride-2 K1, dgrad and wgrad kernels' device time and launches (in these
models every wgrad is at stride 2). Prints one line
per row with the card's ``nvidia-smi`` line first and (with ``--out``)
writes every row as JSON. Needs one card.
"""

from __future__ import annotations

import re
import sys

import numpy as np
import torch

import card_timing
from card_timing import device_ms, fmt_ms, time_ms

T = 8
OMNIGLOT = (("L1", 28, 1), ("L2", 14, 64), ("L3", 7, 64), ("L4", 4, 64))
UNPADDED = (("stage0", 84, 3), ("stage1", 41, 48), ("stage2", 20, 48),
            ("stage3", 9, 48))
# (model, pad, cout, K1 with statistics' images, the rest's, layers)
CASES = (("strided omniglot", 1, 64, 20, 20, OMNIGLOT),
         ("unpadded strided", 0, 48, 75, 25, UNPADDED))
DTYPES = ((torch.float32, "f32", 67e12), (torch.bfloat16, "bf16", 989e12))
BW = 3.35e12
OMNIGLOT_CONFIG = "experiment_config/omniglot_maml++-omniglot_1_20_8_0.1_64_0.json"
MINI_CONFIG = ("experiment_config/"
               "mini-imagenet_maml++-mini-imagenet_5_5_2_0.01_48_0.json")
# the stride-2 mma kernel's dgrad instantiations, demangled or not
S2_MMA = "conv3x3_s2_mma_kernel"
S2_MMA_DGRAD = re.compile(S2_MMA + r"(<\d+, \w+, true>|ILi\d+ELb\dELb1E)")


def _is_conv(key):
    return "conv3x3" in key or "bn_stats_merge" in key


def _is_dgrad(key):
    return "dgrad" in key or bool(S2_MMA_DGRAD.search(key))


def _is_k1(key):
    return ("conv3x3_fwd" in key or "conv3x3_s2_fwd" in key
            or "bn_stats_merge" in key
            or S2_MMA in key and not _is_dgrad(key))


def _is_wgrad(key):
    return "wgrad" in key


def cases():
    """(model, pad, cout, layer, H = W, cin, N, mode) of every row: K1 in
    both modes, dgrad at every layer (back to the image at the first: the
    norm-first models), wgrad at every layer."""
    for model, pad, cout, n_stats, n, layers in CASES:
        for layer, hw, cin in layers:
            yield model, pad, cout, layer, hw, cin, n_stats, "stats"
            yield model, pad, cout, layer, hw, cin, n, "stats-free"
            yield model, pad, cout, layer, hw, cin, n, "dgrad"
            yield model, pad, cout, layer, hw, cin, n, "wgrad"


def calls(cb, dtype, pad, cout, hw, cin, n, mode):
    """The library call, the wrapper's call, and the row's (useful FLOPs,
    elements moved), on inputs from a numpy seed."""
    rng = np.random.RandomState(hw + cin + n)

    def r(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.randn(*shape) * scale).astype(np.float32)).cuda().to(dtype)

    x = r(T, n, hw, hw, cin)
    w = r(T, 3, 3, cin, cout, scale=(2.0 / (9 * cin)) ** 0.5)
    b = r(T, cout, scale=0.1)
    ho = (hw + 2 * pad - 3) // 2 + 1
    xl = x.permute(1, 0, 4, 2, 3).reshape(n, T * cin, hw, hw).contiguous()
    wl = w.permute(0, 4, 3, 1, 2).reshape(T * cout, cin, 3, 3).contiguous()
    M = n * ho * ho  # output (dy) pixels a tenant
    flops = 2 * T * M * 9 * cin * cout
    if mode in ("dgrad", "wgrad"):
        dy = r(T, n, ho, ho, cout)
        dyl = dy.permute(1, 0, 4, 2, 3).reshape(
            n, T * cout, ho, ho).contiguous()
        if mode == "wgrad":  # dw and db: each output written once
            return (lambda: torch.nn.grad.conv2d_weight(
                        xl, wl.shape, dyl, stride=2, padding=pad, groups=T),
                    lambda: cb.conv3x3_wgrad(x, dy, 2, pad),
                    flops + T * M * cout,
                    x.numel() + dy.numel() + w.numel() + T * cout)
        return (lambda: torch.nn.grad.conv2d_input(
                    xl.shape, wl, dyl, stride=2, padding=pad, groups=T),
                lambda: cb.conv3x3_dgrad(dy, w, 2, (hw, hw), pad),
                flops, dy.numel() + w.numel() + x.numel())
    bl = b.reshape(-1).contiguous()
    elems = x.numel() + w.numel() + b.numel() + T * M * cout
    library = (lambda: torch.nn.functional.conv2d(
        xl, wl, bl, stride=2, padding=pad, groups=T))
    if mode == "stats":
        return (library,
                lambda: cb.conv3x3_fwd_stats(x, w, b, stride=2, padding=pad),
                flops + T * M * cout, elems + 3 * T * cout)
    return (library, lambda: cb.conv3x3_fwd(x, w, b, 2, pad),
            flops + T * M * cout, elems)


def rows(label):
    from howtotrainyourmamlpytorch_tpu_torch.kernels import conv_block as cb

    out, fns = [], []
    # every row's event times first, then the profiles
    for dtype, tag, peak in DTYPES:
        for case in cases():
            model, pad, cout, layer, hw, cin, n, mode = case
            library, fn, flops, elems = calls(cb, dtype, pad, cout, hw, cin,
                                              n, mode)
            nbytes = elems * (2 if dtype == torch.bfloat16 else 4)
            t_ops, t_bytes = flops / peak, nbytes / BW
            out.append({
                "build": label, "dtype": tag, "model": model, "layer": layer,
                "hw": hw, "cin": cin, "cout": cout, "pad": pad, "N": n,
                "T": T, "mode": mode, "ms": time_ms(fn),
                "library_ms": time_ms(library),
                "bound_ms": max(t_ops, t_bytes) * 1e3,
                "bound_by": "operations" if t_ops > t_bytes else "bytes",
            })
            fns.append((dtype, case))
            del library, fn
            torch.cuda.empty_cache()
    for r, (dtype, case) in zip(out, fns):
        model, pad, cout, layer, hw, cin, n, mode = case
        _, fn, _, _ = calls(cb, dtype, pad, cout, hw, cin, n, mode)
        r["device_ms"], r["device_launches"] = device_ms(fn, keep=_is_conv)
        dev = r["device_ms"]
        share = ("" if dev is None else
                 f", {100 * r['bound_ms'] / dev:.1f}% by device time")
        print(f"[s2 {label}] {r['dtype']} {model} {layer} pad {pad} N={n} "
              f"{mode}: {r['ms']:.4f} ms (device {fmt_ms(dev)}), library "
              f"{r['library_ms']:.4f} ms ({r['ms'] / r['library_ms']:.2f}x),"
              f" bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
              f"{100 * r['bound_ms'] / r['ms']:.1f}%{share})", flush=True)
        del fn
        torch.cuda.empty_cache()
    return out


PARTS = (("K1 s2", _is_k1), ("dgrad s2", _is_dgrad),
         ("wgrad s2", _is_wgrad))


def e2e(label):
    from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig

    omniglot = MAMLConfig.from_json_file(OMNIGLOT_CONFIG).replace(
        max_pooling=False, batch_size=8)
    mini = MAMLConfig.from_json_file(MINI_CONFIG).replace(
        max_pooling=False, conv_padding=False)
    out = []
    for cfg, what in (
            (omniglot, "strided Omniglot f32"),
            (omniglot.replace(compute_dtype="bfloat16"),
             "strided Omniglot bf16"),
            (mini.replace(compute_dtype="bfloat16"),
             "unpadded strided bf16")):
        out.append(card_timing.train_step("s2", label, cfg, what, PARTS))
        torch.cuda.empty_cache()
    out.append(card_timing.dispatch("s2", label,
                                    mini.replace(compute_dtype="bfloat16"),
                                    "unpadded strided bf16", PARTS))
    torch.cuda.empty_cache()
    return out


def main(argv) -> int:
    return card_timing.main(argv, "s2", __doc__.split("\n")[0], rows, e2e)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
