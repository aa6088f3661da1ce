#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card (H100).

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is non-zero:

1. Print the card's name and power limit (``nvidia-smi``); fail when
   ``torch.cuda.is_available()`` is false.
2. Build the CUDA kernels from ``howtotrainyourmamlpytorch_tpu_torch/
   kernels/csrc`` (and print ptxas' resource usage).
3. Hold each kernel against its plain PyTorch twin on the card, forward
   and backward, at the slice's shapes (T = 8 tenants, N = 25 and 75
   images, layer-1 and layer-2 geometry of the mini-ImageNet model), and
   time the kernel, the twin and — where one PyTorch call computes the
   same function — that library call (CUDA events, after a warmup).
4. Drive the main path: the port's ``serve-bench`` at the full
   mini-ImageNet 5-way 5-shot configuration, 32 requests, through
   ``ServingEngine``. Every kernel's launch counter is zeroed just before
   and read just after, and must have moved by the per-dispatch counts of
   the model (5 inner steps x 4 blocks) for every dispatch.
5. Hold the serve step against the same step run with the plain versions
   on the card: on a small input at the CPU parity tests' tolerances, and
   one bucket-8 dispatch at full width, beside the spread between the
   plain versions on the CPU and on the card. Then profile one bucket-8
   and one bucket-1 dispatch (device time by kernel, device busy share).
6. Print one ``{"kernels": [...]}`` line, then the result line
   ``{"ok": true, "device": {...}}`` last.

Needs one card. Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import torch

FLAGSHIP = ("experiment_config/"
            "mini-imagenet_maml++-mini-imagenet_5_5_2_0.01_48_0.json")
T_TENANTS = 8
COUT = 48
# (label, H = W, cin) of the layers whose shapes the kernels are held at
LAYERS = (("layer1", 84, 3), ("layer2", 42, 48))
IMAGES = (25, 75)  # 5-shot support, 15-target query (5-way)

# Tolerances, as max |kernel - twin| <= ATOL + RTOL * max |twin|. The
# kernels sum in another order than the twin (f32 FFMA throughout, no
# TF32); a 432-deep f32 dot product and the batch statistics over up to
# 529,200 pixels stay far inside 1e-4 of their scale.
RTOL = 1e-4
ATOL = 1e-5
# serve step vs the plain serve step after 5 inner steps at full width:
# preds atol, loss rtol; accuracy equal where the argmax margin exceeds
# PREDS_ATOL. Wider than the per-kernel tolerances because the adapted
# model is ill-conditioned at this width: the batch-norm backward
# (dz - mean(dz) - xhat * mean(dz * xhat)) cancels, so summation order
# alone moves the inner gradients, and two f32 runs of the SAME plain code
# on the CPU and on the card already differ by ~5e-3 in preds. This phase
# measures that CPU-vs-card spread in the same run and prints it beside
# the kernel-vs-plain error.
PREDS_ATOL = 1e-2
LOSS_RTOL = 2e-3

REPLACES = {
    "conv3x3_fwd_stats": "howtotrainyourmamlpytorch_tpu/ops/functional.py:249",
    "bn_act_pool_fwd": "howtotrainyourmamlpytorch_tpu/ops/functional.py:325",
    "bn_act_pool_bwd": "howtotrainyourmamlpytorch_tpu/ops/functional.py:368",
    "conv3x3_dgrad": "howtotrainyourmamlpytorch_tpu/ops/functional.py:199",
    "conv3x3_wgrad": "howtotrainyourmamlpytorch_tpu/ops/functional.py:199",
}
SOURCES = {
    "conv3x3_fwd_stats": (
        "cuda", "howtotrainyourmamlpytorch_tpu_torch/kernels/csrc/"
                "conv3x3_fwd.cu"),
    "bn_act_pool_fwd": (
        "triton", "howtotrainyourmamlpytorch_tpu_torch/kernels/"
                  "bn_act_pool.py"),
    "bn_act_pool_bwd": (
        "triton", "howtotrainyourmamlpytorch_tpu_torch/kernels/"
                  "bn_act_pool.py"),
    "conv3x3_dgrad": (
        "cuda", "howtotrainyourmamlpytorch_tpu_torch/kernels/csrc/"
                "conv3x3_bwd.cu"),
    "conv3x3_wgrad": (
        "cuda", "howtotrainyourmamlpytorch_tpu_torch/kernels/csrc/"
                "conv3x3_bwd.cu"),
}
# the shape each kernel's line reports: (layer label, N)
REPORT_AT = {
    "conv3x3_fwd_stats": ("layer1", 75),
    "bn_act_pool_fwd": ("layer1", 75),
    "bn_act_pool_bwd": ("layer1", 25),
    "conv3x3_dgrad": ("layer2", 25),
    "conv3x3_wgrad": ("layer1", 25),
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def peak_rates(name: str):
    """(f32 FLOP/s outside the tensor cores, memory bytes/s) from NVIDIA's
    data sheets: the PCIe H100 at 51.2 TFLOP/s and 2.0 TB/s, the NVL at
    60 TFLOP/s and 3.9 TB/s, the SXM part (default) at 67 TFLOP/s and
    3.35 TB/s."""
    if "PCIe" in name:
        return 51.2e12, 2.0e12
    if "NVL" in name:
        return 60e12, 3.9e12
    return 67e12, 3.35e12


def time_ms(fn, reps: int = 10) -> float:
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


def max_err(name: str, got, want) -> float:
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    if err > ATOL + RTOL * scale:
        raise AssertionError(
            f"{name}: max |kernel - plain| = {err:.3e} exceeds "
            f"{ATOL:g} + {RTOL:g} * {scale:.3e}"
        )
    return err


def _nchw_tenants(a):
    """(T, N, H, W, C) -> (N, T*C, H, W): tenants as conv groups."""
    t, n, h, w, c = a.shape
    return a.permute(1, 0, 4, 2, 3).reshape(n, t * c, h, w).contiguous()


def check_kernels(cb, F, peaks):
    """Phase 3; returns {kernel: {shape label: record}}."""
    peak_flops, peak_bw = peaks
    gen = torch.Generator(device="cuda").manual_seed(0)
    records = {k: {} for k in cb.KERNELS}

    def bound(flops, nbytes):
        t_ops = flops / peak_flops * 1e3
        t_bytes = nbytes / peak_bw * 1e3
        return (max(t_ops, t_bytes),
                "operations" if t_ops > t_bytes else "bytes")

    def rec(kernel, label, err, kernel_fn, plain_fn, library_fn, flops,
            nbytes):
        b_ms, by = bound(flops, nbytes)
        r = {
            "max_abs_err": err,
            "ms": time_ms(kernel_fn),
            "plain_ms": time_ms(plain_fn),
            "library_ms": (time_ms(library_fn) if library_fn is not None
                           else None),
            "bound_ms": b_ms, "bound_by": by,
            "flops": flops, "bytes": nbytes,
        }
        records[kernel][label] = r
        print(f"  {kernel} @ {label}: err {err:.3e}  kernel "
              f"{r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  library "
              f"{r['library_ms']} ms  bound {b_ms:.4f} ms ({by})",
              flush=True)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, device="cuda", generator=gen) * scale

    T, C = T_TENANTS, COUT
    for layer, hw, cin in LAYERS:
        for n in IMAGES:
            label = f"{layer} N={n}"
            H = W = hw
            M = n * H * W
            x = randn(T, n, H, W, cin)
            w = randn(T, 3, 3, cin, C, scale=math.sqrt(2.0 / (9 * cin)))
            b = randn(T, C, scale=0.1)
            gamma = 1.0 + randn(T, C, scale=0.1)
            beta = randn(T, C, scale=0.1)
            # K1
            y, mean, var, rstd = cb.conv3x3_fwd_stats(x, w, b)
            y_p, mean_p, var_p, rstd_p = F.conv3x3_fwd_stats(x, w, b)
            err = max(max_err("conv3x3_fwd_stats y", y, y_p),
                      max_err("conv3x3_fwd_stats mean", mean, mean_p),
                      max_err("conv3x3_fwd_stats var", var, var_p),
                      max_err("conv3x3_fwd_stats rstd", rstd, rstd_p))
            xl = _nchw_tenants(x)
            wl = w.permute(0, 4, 3, 1, 2).reshape(T * C, cin, 3, 3)
            wl = wl.contiguous()
            bl = b.reshape(-1).contiguous()
            rec("conv3x3_fwd_stats", label, err,
                lambda: cb.conv3x3_fwd_stats(x, w, b),
                lambda: F.conv3x3_fwd_stats(x, w, b),
                lambda: torch.nn.functional.conv2d(xl, wl, bl, padding=1,
                                                   groups=T),
                2 * T * M * 9 * cin * C + T * M * C,
                4 * (x.numel() + w.numel() + b.numel() + y.numel()
                     + 3 * T * C))
            # K2 on K1's outputs
            pooled, arg = cb.bn_act_pool_fwd(y, mean, rstd, gamma, beta)
            pooled_p, arg_p = F.bn_act_pool_fwd(y, mean, rstd, gamma, beta)
            err = max_err("bn_act_pool_fwd pooled", pooled, pooled_p)
            mismatch = (arg != arg_p).float().mean().item()
            if mismatch > 1e-6:
                raise AssertionError(
                    f"bn_act_pool_fwd argmax differs at {mismatch:.2e} of "
                    "the pooled elements"
                )
            rec("bn_act_pool_fwd", label, err,
                lambda: cb.bn_act_pool_fwd(y, mean, rstd, gamma, beta),
                lambda: F.bn_act_pool_fwd(y, mean, rstd, gamma, beta),
                None,
                6 * y.numel() + 3 * pooled.numel(),
                4 * (y.numel() + 4 * T * C) + 5 * pooled.numel())
            # K3
            dp = randn(*pooled.shape, scale=1.0 / math.sqrt(pooled.numel()))
            dy, dg, dbeta = cb.bn_act_pool_bwd(dp, arg, y, mean, rstd, gamma,
                                               beta)
            dy_p, dg_p, dbeta_p = F.bn_act_pool_bwd(dp, arg, y, mean, rstd,
                                                    gamma, beta)
            err = max(max_err("bn_act_pool_bwd dy", dy, dy_p),
                      max_err("bn_act_pool_bwd dgamma", dg, dg_p),
                      max_err("bn_act_pool_bwd dbeta", dbeta, dbeta_p))
            rec("bn_act_pool_bwd", label, err,
                lambda: cb.bn_act_pool_bwd(dp, arg, y, mean, rstd, gamma,
                                           beta),
                lambda: F.bn_act_pool_bwd(dp, arg, y, mean, rstd, gamma,
                                          beta),
                None,
                10 * y.numel() + 6 * pooled.numel(),
                4 * (dp.numel() + y.numel() + dy.numel() + 4 * T * C)
                + arg.numel())
            dyl = _nchw_tenants(dy)
            # K4 dgrad: layers 2-4 only (layer 1's input is the images)
            if cin == C:
                dx = cb.conv3x3_dgrad(dy, w)
                err = max_err("conv3x3_dgrad", dx, F.conv3x3_dgrad(dy, w))
                rec("conv3x3_dgrad", label, err,
                    lambda: cb.conv3x3_dgrad(dy, w),
                    lambda: F.conv3x3_dgrad(dy, w),
                    lambda: torch.nn.grad.conv2d_input(
                        xl.shape, wl, dyl, padding=1, groups=T),
                    2 * T * M * 9 * cin * C,
                    4 * (dy.numel() + w.numel() + dx.numel()))
            # K4 wgrad
            dw, db = cb.conv3x3_wgrad(x, dy)
            dw_p, db_p = F.conv3x3_wgrad(x, dy)
            err = max(max_err("conv3x3_wgrad dw", dw, dw_p),
                      max_err("conv3x3_wgrad db", db, db_p))
            rec("conv3x3_wgrad", label, err,
                lambda: cb.conv3x3_wgrad(x, dy),
                lambda: F.conv3x3_wgrad(x, dy),
                lambda: torch.nn.grad.conv2d_weight(
                    xl, wl.shape, dyl, padding=1, groups=T),
                2 * T * M * 9 * cin * C + T * M * C,
                4 * (x.numel() + dy.numel() + dw.numel() + db.numel()))
            del x, y, y_p, pooled, pooled_p, dy, dy_p, dyl, xl
            torch.cuda.empty_cache()
    return records


def check_block_autograd(cb, F):
    """The autograd.Function end to end against autograd of the plain
    block, at layer-2 shapes (5-shot support)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    shape = (T_TENANTS, 25, 42, 42, COUT)
    x = torch.randn(*shape, device="cuda", generator=gen)
    w = torch.randn(T_TENANTS, 3, 3, COUT, COUT, device="cuda",
                    generator=gen) * math.sqrt(2.0 / (9 * COUT))
    b = torch.zeros(T_TENANTS, COUT, device="cuda")
    gamma = torch.ones(COUT, device="cuda")
    beta = torch.zeros(COUT, device="cuda")
    grads = []
    for fn in (cb.conv_bn_act_pool, F.conv_bn_act_pool):
        xs, ws, bs = (t.clone().requires_grad_(True) for t in (x, w, b))
        pooled, _, _ = fn(xs, ws, bs, gamma, beta)
        ct = torch.ones_like(pooled) / pooled.numel()
        grads.append(torch.autograd.grad((pooled * ct).sum(), [xs, ws, bs]))
    err = max(max_err(f"block grad {n}", g, gp) for n, g, gp in
              zip(("x", "w", "b"), *grads))
    print(f"  block autograd vs plain autograd: max err {err:.3e}",
          flush=True)


def expected_launches(cfg):
    steps, stages = cfg.number_of_evaluation_steps_per_iter, cfg.num_stages
    return {
        "conv3x3_fwd_stats": 2 * steps * stages,  # support + target forward
        "bn_act_pool_fwd": 2 * steps * stages,
        "bn_act_pool_bwd": steps * stages,        # support backward only
        "conv3x3_dgrad": steps * (stages - 1),    # not for the images
        "conv3x3_wgrad": steps * stages,
    }


def check_small_against_plain(cfg, F):
    """Phase 5a: the serve step on a SMALL input — 2 stages, 8 filters,
    20x20 images, 2 inner steps — kernels vs plain ops on the card, at
    the CPU parity tests' tolerances (preds atol 1e-4, loss rtol 1e-4)."""
    import numpy as np

    from howtotrainyourmamlpytorch_tpu_torch.serving import bench
    from howtotrainyourmamlpytorch_tpu_torch.serving.engine import (
        ServingEngine,
    )
    from howtotrainyourmamlpytorch_tpu_torch.state import init_state

    small = cfg.replace(image_height=20, image_width=20, cnn_num_filters=8,
                        num_stages=2, number_of_training_steps_per_iter=2,
                        number_of_evaluation_steps_per_iter=2)
    group = bench._synth_groups(small, [5], 6, 3, 1)[-1]  # 3 tenants
    state = init_state(small, device="cuda:0")
    out = [
        ServingEngine(small, state, [5], device="cuda:0",
                      block=block).serve_group(group)
        for block in (None, F.conv_bn_act_pool)
    ]
    preds = max(float(np.abs(a.preds - b.preds).max())
                for a, b in zip(out[0].results, out[1].results))
    loss = max(abs(a.loss - b.loss) / abs(b.loss)
               for a, b in zip(out[0].results, out[1].results))
    print(f"  small serve step ({len(group)} tenants, bucket "
          f"{out[0].bucket}), kernels vs plain on the card: preds max err "
          f"{preds:.3e}, loss max rel err {loss:.3e}", flush=True)
    if preds > 1e-4 or loss > 1e-4:
        raise AssertionError("small serve step: kernels disagree with plain")


def check_against_plain(cfg, F):
    """Phase 5b: one bucket-8 dispatch at full width, kernels vs plain ops
    on the card, beside the CPU-vs-card spread of the plain ops."""
    import numpy as np

    from howtotrainyourmamlpytorch_tpu_torch.serving import bench
    from howtotrainyourmamlpytorch_tpu_torch.serving.engine import (
        ServingEngine,
    )
    from howtotrainyourmamlpytorch_tpu_torch.state import init_state

    # twopass statistics everywhere, so the CPU run computes what the card's
    # plain run computes ('auto' would pick 'fused' on the CPU)
    cfg = cfg.replace(bn_stats_impl="twopass")
    shots_buckets = bench.bench_shots_buckets(cfg)
    groups = bench._synth_groups(cfg, shots_buckets, 32, 8, 0)
    group = max(groups, key=len)  # 7 tenants -> bucket 8, 1 pad tenant
    state = init_state(cfg, device="cuda:0")
    engines = (
        ("kernels", ServingEngine(cfg, state, shots_buckets,
                                  device="cuda:0"), 3),
        ("plain", ServingEngine(cfg, state, shots_buckets, device="cuda:0",
                                block=F.conv_bn_act_pool), 3),
        ("plain on the CPU", ServingEngine(cfg, state, shots_buckets,
                                           device="cpu"), 1),
    )
    results = {}
    for name, engine, reps in engines:
        drs = [engine.serve_group(group) for _ in range(reps)]
        results[name] = drs[-1]
        print(f"  bucket-{drs[-1].bucket} dispatch ({len(group)} tenants, "
              f"{drs[-1].shots} shots) with {name}: adapt_ms "
              f"{[round(d.adapt_ms, 3) for d in drs]}", flush=True)

    def spread(a, b):
        preds = loss = 0.0
        for ra, rb in zip(results[a].results, results[b].results):
            preds = max(preds, float(np.abs(ra.preds - rb.preds).max()))
            loss = max(loss, abs(ra.loss - rb.loss) / abs(rb.loss))
        return preds, loss

    way_t = cfg.num_classes_per_set * cfg.num_target_samples
    for rk, rp in zip(results["kernels"].results, results["plain"].results):
        if rk.preds.shape != (way_t, cfg.num_classes_per_set):
            raise AssertionError(f"preds shape {rk.preds.shape}")
        if not np.isfinite(rk.preds).all() or not np.allclose(
                rk.preds.sum(-1), 1.0, atol=1e-5):
            raise AssertionError("preds are not finite probabilities")
        top2 = np.sort(rp.preds, axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > PREDS_ATOL
        agree = rk.preds.argmax(-1) == rp.preds.argmax(-1)
        if not agree[clear].all():
            raise AssertionError(
                f"accuracy differs where the margin > {PREDS_ATOL}")
    worst_p, worst_l = spread("kernels", "plain")
    base_p, base_l = spread("plain on the CPU", "plain")
    print(f"  serve step, kernels vs plain on the card: preds max err "
          f"{worst_p:.3e}, loss max rel err {worst_l:.3e}", flush=True)
    print(f"  serve step, plain on the CPU vs plain on the card (the f32 "
          f"summation-order spread): preds {base_p:.3e}, loss {base_l:.3e}",
          flush=True)
    if worst_p > PREDS_ATOL or worst_l > LOSS_RTOL:
        raise AssertionError(
            f"serve step vs plain: preds max err {worst_p:.3e} (atol "
            f"{PREDS_ATOL}), loss max rel err {worst_l:.3e} (rtol "
            f"{LOSS_RTOL})"
        )


def profile_dispatch(cfg):
    """Phase 5c: where a dispatch spends its time — ``torch.profiler``
    over one warm bucket-8 and one warm bucket-1 dispatch: device time by
    kernel and the device's busy share of the dispatch's wall time."""
    from torch.profiler import ProfilerActivity, profile

    from howtotrainyourmamlpytorch_tpu_torch.serving import bench
    from howtotrainyourmamlpytorch_tpu_torch.serving.engine import (
        ServingEngine,
    )
    from howtotrainyourmamlpytorch_tpu_torch.state import init_state

    shots_buckets = bench.bench_shots_buckets(cfg)
    groups = bench._synth_groups(cfg, shots_buckets, 36, 8, 0)
    engine = ServingEngine(cfg, init_state(cfg, device="cuda:0"),
                           shots_buckets, device="cuda:0")
    for group in (groups[-1], groups[0]):  # 8 tenants x 6 shots; 1 x 5
        engine.serve_group(group)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            dr = engine.serve_group(group)
        events = [e for e in prof.key_averages()
                  if getattr(e, "device_time_total", 0) > 0
                  and e.device_type.name == "CUDA"]
        busy_ms = sum(e.device_time_total for e in events) / 1e3
        print(f"  profiled bucket-{dr.bucket} dispatch ({dr.tenants} "
              f"tenants, {dr.shots} shots): adapt_ms {dr.adapt_ms:.3f}",
              flush=True)
        if not events:
            print("  device time by kernel: not measured (the profiler saw "
                  "no device activity)", flush=True)
            continue
        print(f"  device busy {busy_ms:.3f} ms = "
              f"{100 * busy_ms / dr.adapt_ms:.1f}% of the dispatch, "
              f"{sum(e.count for e in events)} device activities",
              flush=True)
        for e in sorted(events, key=lambda e: -e.device_time_total)[:10]:
            print(f"    {e.device_time_total / 1e3:9.3f} ms  x{e.count:<4d} "
                  f"{e.key[:90]}", flush=True)


def main() -> int:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args()
    card = card_line()
    print(card, flush=True)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device {kind}", flush=True)

    from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
    from howtotrainyourmamlpytorch_tpu_torch.device import resolve_device
    from howtotrainyourmamlpytorch_tpu_torch.kernels import build
    from howtotrainyourmamlpytorch_tpu_torch.kernels import conv_block as cb
    from howtotrainyourmamlpytorch_tpu_torch.ops import functional as F
    from howtotrainyourmamlpytorch_tpu_torch.serving import bench

    resolve_device("cuda:0")  # TF32 off for the plain versions too
    print(f"[build] {build.timed_build():.2f} s into {build.build_dir()}",
          flush=True)
    for stem, log in build.build_logs().items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas {stem}] {line.strip()}", flush=True)

    print("[kernels] each kernel vs its plain twin on the card", flush=True)
    t0 = time.perf_counter()
    records = check_kernels(cb, F, peak_rates(kind))
    check_block_autograd(cb, F)
    print(f"[kernels] {time.perf_counter() - t0:.1f} s", flush=True)

    cfg = MAMLConfig.from_json_file(FLAGSHIP)
    print("[serve] serve-bench --config mini-ImageNet 5-way 5-shot "
          "--requests 32 --seed 0", flush=True)
    cb.reset_launches()
    line = bench.run(["--config", FLAGSHIP, "--requests", "32",
                      "--seed", "0", "--device", "cuda:0"])
    counts = cb.launches()
    print(json.dumps(line), flush=True)
    expected = expected_launches(cfg)
    for i, got in enumerate(line["kernel_launches_per_dispatch"]):
        if got != expected:
            raise AssertionError(
                f"dispatch {i}: launches {got}, expected {expected}"
            )
    dispatches = line["dispatches"] + line["warmup_dispatches"]
    for k in cb.KERNELS:
        if counts[k] == 0 or counts[k] != expected[k] * dispatches:
            raise AssertionError(
                f"{k}: {counts[k]} launches over the main path, expected "
                f"{expected[k]} x {dispatches} dispatches"
            )
    tps = line["tenants_per_sec"]
    if not (line["tenants"] == 32 and tps and math.isfinite(tps)):
        raise AssertionError(f"serve-bench line is incomplete: {line}")
    print(f"[serve] tenants_per_sec {tps}  adapt_ms p50 "
          f"{line['adaptation_latency_ms_p50']}  p95 "
          f"{line['adaptation_latency_ms_p95']}  launches {counts}",
          flush=True)

    print("[serve] the serve step vs the plain serve step", flush=True)
    check_small_against_plain(cfg, F)
    check_against_plain(cfg, F)
    print("[profile] one bucket-8 and one bucket-1 dispatch", flush=True)
    profile_dispatch(cfg)

    kernels = []
    for k in cb.KERNELS:
        at = REPORT_AT[k]
        r = records[k][f"{at[0]} N={at[1]}"]
        route, source = SOURCES[k]
        kernels.append({
            "name": k, "route": route, "source": source,
            "replaces": REPLACES[k], "launches": counts[k],
            "max_abs_err": max(v["max_abs_err"]
                               for v in records[k].values()),
            "ms": r["ms"], "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "shape": f"T={T_TENANTS} {at[0]} N={at[1]}",
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
