"""Time ``layer_norm_stats``, ``layer_norm_fwd``, ``layer_norm_bwd``,
``layer_norm_bwd_bwd`` and ``act_fwd``, in f32 and bf16, at every shape
``chip_smoke.py``'s layer-norm and strided norm-first phases give them,
beside their bound and one PyTorch call that computes the same function
where there is one (``torch.var_mean``, ``F.layer_norm`` with its
statistics, ``aten.native_layer_norm_backward``, ``F.leaky_relu``; none
for the double backward); with ``--e2e``, the layer-norm models' batch-2 train
step and bucket-8 serve dispatch, the strided layer-norm and the strided
norm-first Omniglot models' batch-8 train steps, in f32 and bf16 as well:
the check that one build's kernels are faster than another's, compared
in one process run after the other on one card (parent, change, change,
parent).

    PYTHONPATH=<checkout> python3 <this file> [--label NAME] [--out FILE]
                                              [--e2e]

Run by path, so that ``PYTHONPATH`` picks the package whose kernels are
built and launched (each checkout builds its own into its own
``_build/``); the script uses only the wrappers ``layer_norm_stats``,
``layer_norm_fwd``, ``layer_norm_bwd``, ``layer_norm_bwd_bwd`` and
``act_fwd`` of
``kernels/conv_block.py``, their twins and the train and serve entry
points, which every build has. Inputs come from a numpy seed, T = 8
tenants: the layer-norm models' normalized tensors — the mini-ImageNet
conv outputs of the conv-first model (84/42/21/10 x 48) and the
norm-first model's stage-0 image (84 x 84 x 3), the statistics and the
forward at N = 75 images and the backward and double backward at N = 25
(the double backward on random cotangents); the strided Omniglot
model's conv outputs (14/7/4/2 x 64) and its norm-first 28 x 28 x 1 image
at N = 20 — with gamma and beta shared over the tenants, expanded to
``(T, H, W, C)`` as the blocks give them; ``act_fwd`` at the strided
norm-first model's conv outputs (14/7/4/2 x 64, N = 20). Per row: the
wrapper's time by CUDA events (host time included:
``card_timing.time_ms``, every row timed before the first profile), the
device time of every kernel the call launches and their count a call by
``torch.profiler``, the host time a call (events ms less device ms), the
library call's event time, the error against the twin (f32 within 1e-5 +
1e-4 * scale, bf16 within one bf16 ulp or 1e-4 of scale; the bf16
forwards bit for bit) and whether it is the twin's bits, and the bound:
max(bytes / 3.35 TB/s, FLOPs / 67 TFLOP/s) on an H100 SXM, each input
read once and each output written once.

``--e2e`` then profiles one warm second-order train step at batch 2 and
one warm bucket-8 serve dispatch of the mini-ImageNet MAML++ config
(``experiment_config/mini-imagenet_maml++-mini-imagenet_5_5_2_0.01_48_0.json``)
with ``norm_layer='layer_norm'``, conv first and norm first, and one warm
train step at batch 8 of the Omniglot 20-way 1-shot config
(``experiment_config/omniglot_maml++-omniglot_1_20_8_0.1_64_0.json``)
with ``max_pooling=False`` and ``norm_layer='layer_norm'`` and with
``max_pooling=False`` and ``block_order='norm_conv_relu'``, in f32 and
bf16: the device's busy time, its activities, and the device time and
launches of the layer norm's statistics, forward, backward and double
backward and of ``act_fwd`` (the CUDA kernels, or the Triton passes they
replace). Prints one
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
STAGES = (("conv-first stage0", 84, 48), ("norm-first stage0", 84, 3),
          ("stage1", 42, 48), ("stage2", 21, 48), ("stage3", 10, 48))
STRIDED = (("strided layer1", 14, 64), ("strided layer2", 7, 64),
           ("strided layer3", 4, 64), ("strided layer4", 2, 64),
           ("strided norm-first layer1", 28, 1))
# the images each kernel sees: the statistics and the forward at serving's
# 75 targets, the backward at the 25 support images; 20 at Omniglot
IMAGES = {"layer_norm_stats": 75, "layer_norm_fwd": 75, "layer_norm_bwd": 25,
          "layer_norm_bwd_bwd": 25}
# act_fwd at the strided norm-first model's conv outputs, N = 20
ACT_OUTPUTS = (("strided norm-first layer1", 14, 64),
               ("strided norm-first layer2", 7, 64),
               ("strided norm-first layer3", 4, 64),
               ("strided norm-first layer4", 2, 64))
DTYPES = ((torch.float32, "f32"), (torch.bfloat16, "bf16"))
FLOPS, BW = 67e12, 3.35e12
ATOL, RTOL = 1e-5, 1e-4
CONFIG = ("experiment_config/"
          "mini-imagenet_maml++-mini-imagenet_5_5_2_0.01_48_0.json")
OMNIGLOT = "experiment_config/omniglot_maml++-omniglot_1_20_8_0.1_64_0.json"


def cases():
    """(dtype, tag, kernel, layer, H = W, C, N) of every row."""
    for dtype, tag in DTYPES:
        for kernel, n in IMAGES.items():
            for layer, hw, c in STAGES:
                yield dtype, tag, kernel, layer, hw, c, n
            for layer, hw, c in STRIDED:
                yield dtype, tag, kernel, layer, hw, c, 20
        for layer, hw, c in ACT_OUTPUTS:
            yield dtype, tag, "act_fwd", layer, hw, c, 20


def _gate(got, want, kernel):
    """The largest error over the outputs, within the twin gate, and
    whether they equal the twin's bit for bit; the bf16 forwards must (the
    f32 forwards of this build must too, but an earlier build's Triton
    ``layer_norm_fwd`` is held to the f32 gate alone)."""
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
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
    equal = all(g.dtype == w.dtype and torch.equal(g, w)
                for g, w in zip(got, want))
    if (kernel.endswith("fwd") and got[0].dtype == torch.bfloat16
            and not equal):
        raise AssertionError(f"{kernel}: not bit for bit the twin")
    return err, equal


def calls(cb, F, dtype, kernel, hw, c, n):
    """(wrapper call, twin call, library call or None, FLOPs, bytes) at one
    shape, on inputs from a numpy seed."""
    rng = np.random.RandomState(hw + c + n)

    def r(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.randn(*shape) * scale).astype(np.float32)).cuda()

    shape = (hw, hw, c)
    x = (torch.from_numpy(rng.rand(T, n, *shape).astype(np.float32)).cuda()
         if c <= 3 else r(T, n, *shape)).to(dtype)
    numel, rows, esize = x.numel(), T * n, x.element_size()
    if kernel == "act_fwd":
        return (lambda: cb.act_fwd(x), lambda: F.act_fwd(x),
                lambda: torch.nn.functional.leaky_relu(x, F.LEAKY_SLOPE),
                2 * numel, esize * 2 * numel)
    if kernel == "layer_norm_stats":
        return (lambda: cb.layer_norm_stats(x),
                lambda: F.layer_norm_stats(x),
                lambda: torch.var_mean(x, dim=(2, 3, 4), correction=0),
                4 * numel, esize * (numel + 3 * rows))
    mean, _, rstd = F.layer_norm_stats(x)
    gamma_s = (1.0 + r(*shape, scale=0.1)).to(dtype)
    beta_s = r(*shape, scale=0.1).to(dtype)
    gamma = gamma_s.expand(T, *shape).contiguous()
    if kernel == "layer_norm_fwd":
        ln = (x, mean, rstd, gamma, beta_s.expand(T, *shape).contiguous())
        return (lambda: cb.layer_norm_fwd(*ln),
                lambda: F.layer_norm_fwd(*ln),
                lambda: torch.nn.functional.layer_norm(x, shape, gamma_s,
                                                       beta_s, F.LN_EPS),
                4 * numel,
                esize * (2 * numel + 2 * gamma.numel() + 2 * rows))
    dz = r(T, n, *shape, scale=1.0 / numel ** 0.5).to(dtype)
    ln = (x, mean, rstd, gamma)
    if kernel == "layer_norm_bwd_bwd":
        args = (r(T, n, *shape).to(dtype), r(T, *shape).to(dtype),
                r(T, *shape).to(dtype), dz) + ln
        return (lambda: cb.layer_norm_bwd_bwd(*args),
                lambda: F.layer_norm_bwd_bwd(*args), None, 40 * numel,
                esize * (5 * numel + 4 * gamma.numel() + 2 * rows))
    saved = (mean.float().reshape(T, n, 1, 1, 1),
             rstd.float().reshape(T, n, 1, 1, 1), gamma_s, beta_s,
             [True] * 3)
    return (lambda: cb.layer_norm_bwd(dz, *ln),
            lambda: F.layer_norm_bwd(dz, *ln),
            lambda: torch.ops.aten.native_layer_norm_backward(
                dz, x, list(shape), *saved),
            12 * numel, esize * (3 * numel + 3 * gamma.numel() + 2 * rows))


def rows(label):
    from howtotrainyourmamlpytorch_tpu_torch.kernels import conv_block as cb
    from howtotrainyourmamlpytorch_tpu_torch.ops import functional as F

    out = []
    # every row's event times first, then the profiles
    for dtype, tag, kernel, layer, hw, c, n in cases():
        call, twin, lib, flops, nbytes = calls(cb, F, dtype, kernel, hw, c,
                                               n)
        t_ops, t_bytes = flops / FLOPS, nbytes / BW
        err, equal = _gate(call(), twin(), kernel)
        out.append({
            "build": label, "dtype": tag, "kernel": kernel, "layer": layer,
            "hw": hw, "C": c, "N": n, "T": T,
            "max_abs_err": err, "bit_for_bit": equal,
            "ms": time_ms(call),
            "library_ms": time_ms(lib) if lib is not None else None,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops > t_bytes else "bytes",
        })
        del call, twin, lib
        torch.cuda.empty_cache()
    for r, (dtype, tag, kernel, layer, hw, c, n) in zip(out, cases()):
        call, *_ = calls(cb, F, dtype, kernel, hw, c, n)
        r["device_ms"], r["kernels_a_call"] = device_ms(call)
        dev = r["device_ms"]
        extra = ("" if dev is None else
                 f", host {r['ms'] - dev:.4f} ms, "
                 f"{100 * r['bound_ms'] / dev:.1f}% of the bound by device "
                 "time")
        lib = r["library_ms"]
        lib = ("no library call" if lib is None else
               f"library {lib:.4f} ms ({r['ms'] / lib:.2f}x)")
        print(f"[ln {label}] {tag} {kernel} {layer} N={n}: {r['ms']:.4f} ms "
              f"(device {fmt_ms(dev)}, {r['kernels_a_call']:g} kernels a "
              f"call{extra}), {lib}, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), err "
              f"{r['max_abs_err']:.2e}"
              f"{', bit for bit' if r['bit_for_bit'] else ''}", flush=True)
        del call
        torch.cuda.empty_cache()
    return out


def _part(key):
    """Which of the layer norm's statistics, forward, backward and double
    backward and ``act_fwd`` a device kernel is: the CUDA kernels, or the
    Triton passes they replace; None for the rest."""
    if "layer_norm_bwd_bwd" in key or key.startswith(
            ("_bwd_bwd_reduce_kernel", "_bwd_bwd_out_kernel",
             "_row_sums_kernel")):
        return "ln bwd bwd"
    if "layer_norm_stats" in key or key.startswith(
            ("_stats_partial_kernel", "_stats_merge_kernel")):
        return "ln stats"
    if "layer_norm_fwd" in key or key.startswith("_fwd_kernel"):
        return "ln fwd"
    if "layer_norm_bwd" in key or key.startswith(
            ("_bwd_reduce_kernel", "_bwd_dx_kernel")):
        return "ln bwd"
    if "act_fwd_kernel" in key and "bn_act_fwd" not in key:
        return "act fwd"
    return None


PARTS = card_timing.by_part(_part, ("ln stats", "ln fwd", "ln bwd",
                                    "ln bwd bwd", "act fwd"))


def e2e(label):
    from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig

    ln = MAMLConfig.from_json_file(CONFIG).replace(norm_layer="layer_norm",
                                                   batch_size=2)
    strided = MAMLConfig.from_json_file(OMNIGLOT).replace(max_pooling=False,
                                                          batch_size=8)
    models = (("layer-norm conv-first", ln, True),
              ("layer-norm norm-first",
               ln.replace(block_order="norm_conv_relu"), True),
              ("strided layer-norm", strided.replace(norm_layer="layer_norm"),
               False),
              ("strided norm-first",
               strided.replace(block_order="norm_conv_relu"), False))
    out = []
    for tag, base, serve in models:
        for dtype, dt in (("float32", "f32"), ("bfloat16", "bf16")):
            cfg = base.replace(compute_dtype=dtype)
            what = f"{tag} {dt}"
            out.append(card_timing.train_step("ln", label, cfg, what,
                                              PARTS))
            torch.cuda.empty_cache()
            if serve:
                out.append(card_timing.dispatch("ln", label, cfg, what,
                                                PARTS))
                torch.cuda.empty_cache()
    return out


def main(argv) -> int:
    return card_timing.main(argv, "ln", __doc__.split("\n")[0], rows, e2e)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
