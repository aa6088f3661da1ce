"""Time K2, pooled (``bn_act_pool_fwd``) and pool-free (``bn_act_fwd``,
and at slope 1 ``batch_norm_fwd``), in f32 and bf16, at every shape the
shipped configs and the port's other models give it, beside its bound and,
for ``batch_norm_fwd``, one ``F.batch_norm`` call given the statistics:
the check that one build's K2 is faster than another's, compared in one
process run after the other on one card (parent, change, change, parent).

    PYTHONPATH=<checkout> python3 <this file> [--label NAME] [--out FILE]

Run by path, so that ``PYTHONPATH`` picks the package whose kernels are
built and launched (each checkout builds its own into its own
``_build/``); the script uses only the wrappers ``bn_act_pool_fwd``,
``bn_act_fwd`` and ``batch_norm_fwd`` of ``kernels/conv_block.py`` and
their twins, which every build has. Inputs come from a seeded CUDA
generator: y, its batch statistics, gamma and beta, at

* pooled: the mini-ImageNet conv outputs (84/42/21/10, 48 channels) at T
  = 8, N = 75 and 25 (serving's target and support), T = 2, N = 25 (the
  config's training batch) and the large-batch config's T = 256 at stage
  1, the unpadded model's (82/39/17/6) at T = 8, N = 75, Omniglot's
  (28/14/7/3, 64 channels) at T = 8, N = 20, and the bf16 model's mini
  stages at T = 8, N = 75;
* pool-free: the strided Omniglot model's conv outputs (14/7/4/2, 64
  channels; ``bn_act_fwd``), the norm-first model's block inputs (84x84x3,
  then 42/21/10 x 48; ``batch_norm_fwd``) at T = 8, N = 75 and the
  strided norm-first model's image (28x28x1, N = 20), each in f32 and
  bf16.

Per row: the wrapper's time by CUDA events (host time included:
``card_timing.time_ms``, the median of 15 batches of 20 calls, as most
rows are host-bound; every row timed before the first profile), the
device time of every kernel the call launches and their count by
``torch.profiler``, the error against the plain twin (f32 within 1e-5 +
1e-4 * scale with the argmax differing at no more than 1e-6 of the pooled
elements; bf16 equal), ``F.batch_norm``'s time where it computes the
same function, and the bound: max(bytes / 3.35 TB/s, FLOPs / 67 TFLOP/s)
on an H100 SXM, each input read once and each output written once.
Prints one line per row, the card's ``nvidia-smi`` line, and (with
``--out``) writes every row as JSON. Needs one card.
"""

from __future__ import annotations

import sys

import torch

from card_timing import device_ms, fmt_ms, main, time_ms

MINI = (("stage0", 84), ("stage1", 42), ("stage2", 21), ("stage3", 10))
UNPADDED = (("stage0", 82), ("stage1", 39), ("stage2", 17), ("stage3", 6))
OMNIGLOT = (("L1", 28), ("L2", 14), ("L3", 7), ("L4", 3))
STRIDED = (("L1", 14), ("L2", 7), ("L3", 4), ("L4", 2))
F32, BF16 = torch.float32, torch.bfloat16
# (kernel, model, dtype, C, images, tasks, layers)
CASES = (
    ("bn_act_pool_fwd", "mini", F32, 48, 75, 8, MINI),
    ("bn_act_pool_fwd", "mini", F32, 48, 25, 8, MINI[:2]),
    ("bn_act_pool_fwd", "mini", F32, 48, 25, 2, MINI),
    ("bn_act_pool_fwd", "mini", F32, 48, 25, 256, MINI[1:2]),
    ("bn_act_pool_fwd", "unpadded", F32, 48, 75, 8, UNPADDED),
    ("bn_act_pool_fwd", "omniglot", F32, 64, 20, 8, OMNIGLOT),
    ("bn_act_pool_fwd", "mini", BF16, 48, 75, 8, MINI),
    ("bn_act_fwd", "strided", F32, 64, 20, 8, STRIDED),
    ("bn_act_fwd", "strided", BF16, 64, 20, 8, STRIDED),
    ("batch_norm_fwd", "norm-first", F32, 3, 75, 8, MINI[:1]),
    ("batch_norm_fwd", "norm-first", F32, 48, 75, 8, MINI[1:]),
    ("batch_norm_fwd", "strided norm-first", F32, 1, 20, 8, OMNIGLOT[:1]),
    ("batch_norm_fwd", "norm-first", BF16, 3, 75, 8, MINI[:1]),
    ("batch_norm_fwd", "norm-first", BF16, 48, 75, 8, MINI[1:]),
    ("batch_norm_fwd", "strided norm-first", BF16, 1, 20, 8, OMNIGLOT[:1]),
)
ATOL, RTOL = 1e-5, 1e-4  # the twin gate
BATCHES = 15  # of card_timing.REPS calls, the median taken


def cases():
    """(kernel, model, layer, dtype, T, N, C, H = W) of every row."""
    for kernel, model, dtype, C, n, T, layers in CASES:
        for layer, hw in layers:
            yield kernel, model, layer, dtype, T, n, C, hw


def inputs(T, N, hw, C, dtype, seed):
    from howtotrainyourmamlpytorch_tpu_torch.ops import functional as F

    g = torch.Generator(device="cuda").manual_seed(seed)

    def r(*s, scale=1.0):
        return torch.randn(*s, device="cuda", generator=g) * scale

    y = (2.0 * r(T, N, hw, hw, C) + 0.3).to(dtype)
    mean, var, rstd = F.bn_stats(y)
    gamma = (1.0 + r(T, C, scale=0.1)).to(dtype)
    return y, mean, var, rstd, gamma, r(T, C, scale=0.1).to(dtype)


def max_err(got, want):
    """The largest error over the outputs; f32 within the twin gate (the
    argmax differing at no more than 1e-6 of the pooled elements), bf16
    equal."""
    err = 0.0
    for g, w in zip(got, want):
        if g.dtype == torch.uint8:
            wrong = (g != w).float().mean().item()
            if wrong > 1e-6:
                raise AssertionError(f"argmax differs at {wrong:.2e} of the "
                                     "pooled elements")
            continue
        e = (g.double() - w.double()).abs().max().item()
        scale = w.double().abs().max().item()
        bad = (not torch.equal(g, w) if g.dtype == BF16
               else e > ATOL + RTOL * scale)
        if bad:
            raise AssertionError(f"max |kernel - twin| {e:.3e} at scale "
                                 f"{scale:.3e}")
        err = max(err, e)
    return err


def calls(cb, F, kernel, T, n, C, hw, dtype):
    """(wrapper call, twin call, library call or None, FLOPs, bytes) at one
    shape, on inputs from its seed: each input read once, each output
    written once, ~6 FLOPs an element of y and 3 a pooled one."""
    y, mean, var, rstd, gamma, beta = inputs(T, n, hw, C, dtype,
                                             hw + C + n + T)
    bn = (y, mean, rstd, gamma, beta)
    esize, tables = y.element_size(), 4 * T * C
    if kernel == "bn_act_pool_fwd":
        pooled = T * n * (hw // 2) ** 2 * C
        return (lambda: cb.bn_act_pool_fwd(*bn),
                lambda: F.bn_act_pool_fwd(*bn), None,
                6 * y.numel() + 3 * pooled,
                esize * (y.numel() + pooled + tables) + pooled)
    nbytes = esize * (2 * y.numel() + tables)
    if kernel == "bn_act_fwd":
        return (lambda: (cb.bn_act_fwd(*bn),), lambda: (F.bn_act_fwd(*bn),),
                None, 6 * y.numel(), nbytes)
    # F.batch_norm given the statistics, tenants as channels (NCHW)
    yl = y.permute(1, 0, 4, 2, 3).reshape(n, T * C, hw, hw).contiguous()
    flat = [v.reshape(-1).float() for v in (mean, var, gamma, beta)]
    return (lambda: (cb.batch_norm_fwd(*bn),),
            lambda: (F.batch_norm_fwd(*bn),),
            lambda: torch.nn.functional.batch_norm(
                yl, *flat, training=False, eps=F.BN_EPS),
            4 * y.numel(), nbytes)


def rows(label):
    from howtotrainyourmamlpytorch_tpu_torch.kernels import conv_block as cb
    from howtotrainyourmamlpytorch_tpu_torch.ops import functional as F

    flops_peak, bw_peak = 67e12, 3.35e12
    out = []
    # every row's event times first, then the profiles
    for kernel, model, layer, dtype, T, n, C, hw in cases():
        call, twin, lib, flops, nbytes = calls(cb, F, kernel, T, n, C, hw,
                                               dtype)
        t_ops, t_bytes = flops / flops_peak, nbytes / bw_peak
        out.append({
            "build": label, "kernel": kernel + ("_bf16" if dtype == BF16
                                                else ""),
            "model": model, "layer": layer, "hw": hw, "C": C, "N": n,
            "T": T, "max_abs_err": max_err(call(), twin()),
            "ms": time_ms(call, batches=BATCHES),
            "library_ms": (None if lib is None
                           else time_ms(lib, batches=BATCHES)),
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops > t_bytes else "bytes",
        })
        del call, twin, lib
        torch.cuda.empty_cache()
    rows_in_order = iter(out)
    for kernel, model, layer, dtype, T, n, C, hw in cases():
        call, *_ = calls(cb, F, kernel, T, n, C, hw, dtype)
        r = next(rows_in_order)
        r["device_ms"], r["activities"] = device_ms(call)
        lib = ("" if r["library_ms"] is None else
               f", F.batch_norm {r['library_ms']:.4f} ms "
               f"({r['ms'] / r['library_ms']:.2f}x)")
        print(f"[K2 {label}] {r['kernel']} {model} {layer} T={T} N={n} "
              f"C={C}: {r['ms']:.4f} ms (device {fmt_ms(r['device_ms'])}, "
              f"{r['activities']:g} activities a call){lib}, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}, "
              f"{100 * r['bound_ms'] / r['ms']:.1f}%), err "
              f"{r['max_abs_err']:.2e}", flush=True)
        del call
        torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], "K2", __doc__.split("\n")[0], rows))
