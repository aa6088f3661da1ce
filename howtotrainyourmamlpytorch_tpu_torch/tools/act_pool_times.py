"""Time ``act_pool_fwd``, ``act_pool_bwd`` and ``act_pool_gather``, in f32
and bf16, at every shape the norm-first and layer-norm models give them,
beside their bound;
with ``--e2e``, the norm-first model's batch-2 train step and bucket-8
serve dispatch, in f32 and bf16: the check that one build's kernels are
faster than another's, compared in one process run after the other on one
card (parent, change, change, parent).

    PYTHONPATH=<checkout> python3 <this file> [--label NAME] [--out FILE]
                                              [--e2e]

Run by path, so that ``PYTHONPATH`` picks the package whose kernels are
built and launched (each checkout builds its own into its own
``_build/``); the script uses only the wrappers ``act_pool_fwd``,
``act_pool_bwd`` and ``act_pool_gather`` of ``kernels/conv_block.py``,
their twins and the train and serve entry points, which every build has.
Inputs come from a numpy seed, T = 8 tenants, 48 channels: the
mini-ImageNet conv outputs of the padded models (84/42/21/10) and of the
unpadded ones (82/39/17/6), the forward at N = 75 images and the backward
and the gather at N = 25, on y with exact ties in many windows and the
twin's argmax. Per row: the wrapper's time by
CUDA events (host time included: ``card_timing.time_ms``, every row timed
before the first profile), the device time of every kernel the call
launches and their count a call by ``torch.profiler``, the host time a
call (events ms less device ms), whether the outputs equal the twin's
(values; an earlier build's backward wrote +0 where the twin's zero has
d's sign) and whether they are its bits, and the bound: bytes over 3.35
TB/s on an H100 SXM, each input read once and each output written once
(the backward reads y at the argmax only, the gather g_dy and y there).
No PyTorch call computes any of them. The backward's and the gather's
rows also give the bytes they move from device memory, which reads y
(and g_dy) in whole 32-byte sectors wherever a channel selects a tap
(counted on this row's argmax), and the share of the bound that caps
them at.

``--e2e`` then profiles one warm second-order train step at batch 2 and
one warm bucket-8 serve dispatch of the mini-ImageNet MAML++ config
(``experiment_config/mini-imagenet_maml++-mini-imagenet_5_5_2_0.01_48_0.json``)
with ``block_order='norm_conv_relu'``, in f32 and bf16: the device's busy
time, its activities, and the device time and launches of the act-pool
forward, backward and gather (the CUDA kernels, or the Triton kernels
they replace). Prints one line per row with the card's ``nvidia-smi``
line first and (with ``--out``) writes every row as JSON. Needs one card.
"""

from __future__ import annotations

import functools
import sys

import numpy as np
import torch

import card_timing
from card_timing import device_ms, fmt_ms, time_ms

T, C = 8, 48
STAGES = (("stage0", 84), ("stage1", 42), ("stage2", 21), ("stage3", 10),
          ("unpadded stage0", 82), ("unpadded stage1", 39),
          ("unpadded stage2", 17), ("unpadded stage3", 6))
# the images each kernel sees: the forward at serving's 75 targets, the
# backward at the 25 support images
IMAGES = {"act_pool_fwd": 75, "act_pool_bwd": 25, "act_pool_gather": 25}
DTYPES = ((torch.float32, "f32"), (torch.bfloat16, "bf16"))
BW = 3.35e12
CONFIG = ("experiment_config/"
          "mini-imagenet_maml++-mini-imagenet_5_5_2_0.01_48_0.json")


def cases():
    """(dtype, tag, kernel, stage, H = W, N) of every row."""
    for dtype, tag in DTYPES:
        for kernel, n in IMAGES.items():
            for stage, hw in STAGES:
                yield dtype, tag, kernel, stage, hw, n


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _gate(got, want):
    """Whether the outputs equal the twin's bits; raises where their
    values differ."""
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    for g, w in zip(got, want):
        if g.dtype != w.dtype or not torch.equal(g, w):
            raise AssertionError("the kernel's outputs are not its twin's")
    return all(torch.equal(_bits(g), _bits(w)) if g.is_floating_point()
               else True for g, w in zip(got, want))


def _moved(kernel, arg, y):
    """The bytes the backward or the gather moves from device memory,
    which reads y (and the gather g_dy) in whole 32-byte sectors: the
    argmax and, at each tap, every sector of y (and g_dy) in which some
    channel selects the tap; the backward's pooled gradient and dy, the
    gather's pooled output."""
    esize = y.element_size()
    P = arg.numel()
    lanes = arg.reshape(-1, 32 // esize).long()
    sectors = sum(int((lanes == k).any(1).sum()) for k in range(4))
    if kernel == "act_pool_gather":
        return P + 2 * 32 * sectors + esize * P
    return esize * P + P + 32 * sectors + esize * y.numel()


@functools.lru_cache(maxsize=None)
def inputs(F, dtype, hw, n):
    """y (T, n, hw, hw, C) on a grid of 0.25 (exact ties in many windows)
    plus a continuous part on half its elements, its twin's argmax and a
    pooled gradient, on the card in ``dtype``, from a numpy seed."""
    rng = np.random.default_rng(hw + n)
    shape = (T, n, hw, hw, C)
    y = rng.integers(-4, 4, size=shape, dtype=np.int8) * np.float32(0.25)
    y += rng.standard_normal(shape, dtype=np.float32) * (
        rng.random(shape, dtype=np.float32) < 0.5)
    y = torch.from_numpy(y).cuda().to(dtype)
    _, arg = F.act_pool_fwd(y)
    dp = torch.from_numpy(rng.standard_normal(
        tuple(arg.shape), dtype=np.float32)).cuda().to(dtype)
    return y, arg, dp


@functools.lru_cache(maxsize=None)
def gather_input(dtype, hw, n):
    """The gather's g_dy (y's shape), from a numpy seed."""
    rng = np.random.default_rng(hw + n + 1)
    return torch.from_numpy(rng.standard_normal(
        (T, n, hw, hw, C), dtype=np.float32)).cuda().to(dtype)


def calls(cb, F, dtype, kernel, hw, n):
    """(wrapper call, twin call, bytes) at one shape."""
    y, arg, dp = inputs(F, dtype, hw, n)
    esize, P = y.element_size(), arg.numel()
    if kernel == "act_pool_fwd":
        return (lambda: cb.act_pool_fwd(y), lambda: F.act_pool_fwd(y),
                esize * (y.numel() + P) + P)
    if kernel == "act_pool_gather":
        g = gather_input(dtype, hw, n)
        return (lambda: cb.act_pool_gather(g, arg, y),
                lambda: F.act_pool_gather(g, arg, y), esize * 3 * P + P)
    return (lambda: cb.act_pool_bwd(dp, arg, y),
            lambda: F.act_pool_bwd(dp, arg, y),
            esize * (2 * P + y.numel()) + P)


def rows(label):
    from howtotrainyourmamlpytorch_tpu_torch.kernels import conv_block as cb
    from howtotrainyourmamlpytorch_tpu_torch.ops import functional as F

    out = []
    # every row's event times first, then the profiles
    for dtype, tag, kernel, stage, hw, n in cases():
        call, twin, nbytes = calls(cb, F, dtype, kernel, hw, n)
        bits = _gate(call(), twin())
        y, arg, _ = inputs(F, dtype, hw, n)
        moved = None if kernel == "act_pool_fwd" else _moved(kernel, arg, y)
        bound = nbytes / BW * 1e3
        out.append({
            "build": label, "dtype": tag, "kernel": kernel, "stage": stage,
            "hw": hw, "C": C, "N": n, "T": T, "bit_for_bit": bits,
            "ms": time_ms(call), "bound_ms": bound, "bound_by": "bytes",
            "moved_bytes": moved,
            "cap": None if moved is None else nbytes / moved,
        })
        del call, twin
        torch.cuda.empty_cache()
    for r, (dtype, tag, kernel, stage, hw, n) in zip(out, cases()):
        call = calls(cb, F, dtype, kernel, hw, n)[0]
        r["device_ms"], r["kernels_a_call"] = device_ms(call)
        dev = r["device_ms"]
        extra = ("" if dev is None else
                 f", host {r['ms'] - dev:.4f} ms, "
                 f"{100 * r['bound_ms'] / dev:.1f}% of the bound by device "
                 "time")
        cap = ("" if r["cap"] is None else
               f", the sectors read at the argmax taps cap it at "
               f"{100 * r['cap']:.1f}%")
        print(f"[act_pool {label}] {tag} {kernel} {stage} N={n}: "
              f"{r['ms']:.4f} ms (device {fmt_ms(dev)}, "
              f"{r['kernels_a_call']:g} kernels a call{extra}), bound "
              f"{r['bound_ms']:.4f} ms (bytes){cap}"
              f"{', bit for bit' if r['bit_for_bit'] else ', equal values'}",
              flush=True)
        del call
    inputs.cache_clear()
    gather_input.cache_clear()
    torch.cuda.empty_cache()
    return out


def _part(key):
    """Which act-pool kernel a device kernel is: the CUDA kernels, or the
    Triton kernels they replace (K2's and K3's pooled kernels, whose names
    hold the same words, are not); None for the rest."""
    if "bn_act" in key:
        return None
    for name in ("fwd", "bwd", "gather"):
        if f"act_pool_{name}_kernel" in key:
            return f"act pool {name}"
    return None


PARTS = card_timing.by_part(_part, ("act pool fwd", "act pool bwd",
                                    "act pool gather"))


def e2e(label):
    from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig

    nf = MAMLConfig.from_json_file(CONFIG).replace(
        block_order="norm_conv_relu", batch_size=2)
    out = []
    for dtype, dt in (("float32", "f32"), ("bfloat16", "bf16")):
        cfg = nf.replace(compute_dtype=dtype)
        what = f"norm-first {dt}"
        out.append(card_timing.train_step("act_pool", label, cfg, what,
                                          PARTS))
        torch.cuda.empty_cache()
        out.append(card_timing.dispatch("act_pool", label, cfg, what, PARTS))
        torch.cuda.empty_cache()
    return out


def main(argv) -> int:
    return card_timing.main(argv, "act_pool", __doc__.split("\n")[0], rows,
                            e2e)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
