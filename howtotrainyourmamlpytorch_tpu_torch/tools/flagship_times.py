"""The flagship's end-to-end times on one build, in f32 and bf16: the check
that a change to some kernels moved the whole path, compared in one
process run after another on one card.

    PYTHONPATH=<checkout> python3 <this file> [--label NAME]

Run by path, so that ``PYTHONPATH`` picks the package whose kernels are
built and launched; it uses only entry points every build has. At the
mini-ImageNet MAML++ 5-way 5-shot configuration
(``experiment_config/mini-imagenet_maml++-mini-imagenet_5_5_2_0.01_48_0.json``,
read from the checkout it runs in), weights from the config's seed:

* ``train-bench`` second order at batch 2 (the config's) and 8, one fixed
  batch, 2 warmup and 5 timed steps: step_ms p50 and p95; and at batch 2
  in bf16 (``compute_dtype='bfloat16'``);
* ``torch.profiler`` over one warm train step at batch 2 and 8 (and at
  batch 2 in bf16), and over one warm bucket-8 f32 serve dispatch (8
  tenants, 6 shots), of the config in f32 and bf16 and of its norm-first
  model (``block_order='norm_conv_relu'``) in f32 and bf16: the device's
  busy time against the wall time, the K1 kernels' device time (every
  kernel whose name holds ``conv3x3_fwd``, the statistics' merge, and the
  bf16 stride-1 tensor-core kernel's forward instantiations), K4 dgrad's
  (every kernel whose name holds ``dgrad``, and that kernel's dgrad
  instantiations), K4 wgrad's (every kernel whose name holds ``wgrad``:
  the f32 band kernels, the bf16 tensor-core kernels, and the reduce of
  their split partials), K2's (``bn_act_pool_fwd``; pool-free, the
  norm-first block's ``batch_norm_fwd``, every kernel whose name holds
  ``bn_act_fwd``), K3's and K5's (every kernel whose name holds
  ``bn_act_pool_bwd``, and ``bn_act_pool_bwd_bwd`` for K5: the one CUDA
  kernel, or the bf16 K5's Triton passes) and the largest kernels by
  device time.

Prints one line per measurement with the card's ``nvidia-smi`` line first.
Needs one card.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
import time

import torch

CONFIG = ("experiment_config/"
          "mini-imagenet_maml++-mini-imagenet_5_5_2_0.01_48_0.json")
K1_NAMES = ("conv3x3_fwd", "bn_stats_merge")
# the bf16 stride-1 tensor-core kernel (csrc/conv3x3_s1_bf16.cu), by its
# template's last argument (dgrad), demangled or not
MMA = "conv3x3_s1_mma_kernel"
MMA_DGRAD = re.compile(MMA + r"(<\d+, \w+, true>|ILi\d+ELb\dELb1E)")


def _is_dgrad(key):
    return "dgrad" in key or bool(MMA_DGRAD.search(key))


def _is_k1(key):
    return (any(n in key for n in K1_NAMES)
            or MMA in key and not _is_dgrad(key))


def _is_k5(key):
    return "bn_act_pool_bwd_bwd" in key


def _is_k3(key):
    return "bn_act_pool_bwd" in key and not _is_k5(key)


def report(label, what, prof, wall_ms):
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0
              and e.device_type.name == "CUDA"]
    busy = sum(e.device_time_total for e in events) / 1e3
    parts = []
    for name, match in (
            ("K1", _is_k1), ("K4 dgrad", _is_dgrad),
            ("K4 wgrad", lambda k: "wgrad" in k),
            ("K2", lambda k: "bn_act_pool_fwd" in k),
            ("K2 pool-free", lambda k: "bn_act_fwd" in k),
            ("K3", _is_k3), ("K5", _is_k5)):
        mine = [e for e in events if match(e.key)]
        ms = sum(e.device_time_total for e in mine) / 1e3
        parts.append(f"{name} {ms:.3f} ms over "
                     f"{sum(e.count for e in mine)} launches")
    print(f"[e2e {label}] {what}: device busy {busy:.3f} ms of "
          f"{wall_ms:.3f} ms wall, {sum(e.count for e in events)} device "
          f"activities; " + "; ".join(parts), flush=True)
    for e in sorted(events, key=lambda e: -e.device_time_total)[:8]:
        print(f"[e2e {label}]     {e.device_time_total / 1e3:9.3f} ms  "
              f"x{e.count:<4d} {e.key[:80]}", flush=True)


def train_steps(label, cfg, batch_size, dtype="float32"):
    from torch.profiler import ProfilerActivity, profile

    from howtotrainyourmamlpytorch_tpu_torch import bench as train_bench
    from howtotrainyourmamlpytorch_tpu_torch.core import maml
    from howtotrainyourmamlpytorch_tpu_torch.state import init_state

    line = train_bench.run([
        "--config", CONFIG, "--batch-size", str(batch_size), "--epoch", "0",
        "--warmup", "2", "--steps", "5", "--seed", "0", "--device",
        "cuda:0", "--compute_dtype", dtype])
    what = f"batch {batch_size}" + (" bf16" if dtype == "bfloat16" else "")
    print(f"[e2e {label}] train-bench {what}: step_ms p50 "
          f"{line['step_ms_p50']}  p95 {line['step_ms_p95']}", flush=True)
    cfg = cfg.replace(batch_size=batch_size, compute_dtype=dtype)
    device = torch.device("cuda:0")
    state = init_state(cfg, device=device, with_opt=True)
    lr, weights, _ = maml.epoch_schedule(cfg, 0)
    batch = train_bench.synth_batch(cfg, 0, device)
    step = maml.make_train_step(cfg, True)
    state, _ = step(state, *batch, weights, lr)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        state, _ = step(state, *batch, weights, lr)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    report(label, f"profiled {what} train step", prof, wall_ms)


def serve_dispatch(label, cfg, what="f32"):
    from torch.profiler import ProfilerActivity, profile

    from howtotrainyourmamlpytorch_tpu_torch.serving import bench
    from howtotrainyourmamlpytorch_tpu_torch.serving.engine import (
        ServingEngine,
    )
    from howtotrainyourmamlpytorch_tpu_torch.state import init_state

    shots_buckets = bench.bench_shots_buckets(cfg)
    groups = bench._synth_groups(cfg, shots_buckets, 36, 8, 0, "f32", 0)
    engine = ServingEngine(cfg, init_state(cfg, device="cuda:0"),
                           shots_buckets, device="cuda:0", ingest="f32")
    engine.serve_group(groups[-1])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        dr = engine.serve_group(groups[-1])
    report(label, f"profiled {what} bucket-{dr.bucket} dispatch "
           f"({dr.tenants} tenants, {dr.shots} shots)", prof, dr.adapt_ms)


def main(argv) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--label", default="this build")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flagship_times: needs a CUDA card")
    from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
    from howtotrainyourmamlpytorch_tpu_torch.device import resolve_device

    resolve_device("cuda:0")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"[e2e {args.label}] {card}", flush=True)
    cfg = MAMLConfig.from_json_file(CONFIG)
    for batch_size in (2, 8):
        train_steps(args.label, cfg, batch_size)
        torch.cuda.empty_cache()
    train_steps(args.label, cfg, 2, "bfloat16")
    torch.cuda.empty_cache()
    serve_dispatch(args.label, cfg)
    torch.cuda.empty_cache()
    serve_dispatch(args.label, cfg.replace(compute_dtype="bfloat16"), "bf16")
    norm_first = cfg.replace(block_order="norm_conv_relu")
    torch.cuda.empty_cache()
    serve_dispatch(args.label, norm_first, "norm-first f32")
    torch.cuda.empty_cache()
    serve_dispatch(args.label, norm_first.replace(compute_dtype="bfloat16"),
                   "norm-first bf16")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
