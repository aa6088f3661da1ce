"""What the kernel A/B tools (``k1_times.py``, ``k35_times.py``, ...) share:
a call's time by CUDA events, the device time of the kernels it launches by
``torch.profiler``, the profiled train step and serve dispatch of their
``--e2e`` rows, and their command line (``--label``, ``--out``, ``--e2e``),
which prints the card's ``nvidia-smi`` line and writes the rows as JSON.

The tools are run by path with ``PYTHONPATH`` naming the checkout whose
package they time, and import this module from their own directory
(``import card_timing``), so both builds of an A/B are timed the same way.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

REPS = 20
BATCHES = 7


def time_ms(fn, reps=REPS, batches=BATCHES):
    """The median over ``batches`` of a call's time by CUDA events over
    ``reps`` back-to-back calls, after a warmup: at the small maps a call
    is host-bound, and one stall of the shared host would move a single
    batch's mean. Time every row before the first profile: a call timed
    after ``torch.profiler`` has run in the process reads slower."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return sorted(times)[batches // 2]


def device_ms(fn, reps=REPS, keep=lambda key: True):
    """The device time per call of the kernels ``fn`` launches whose name
    ``keep`` takes, and their count per call, from ``torch.profiler`` over
    ``reps`` calls after a profiled warmup of as many (a profile's first
    launches can go unrecorded); (None, 0) where it shows none."""
    from torch.profiler import ProfilerActivity, profile, schedule

    active = []
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: active.append(p.key_averages())
                 ) as prof:
        for _ in range(2):
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            prof.step()
    events = [e for e in (active[0] if active else [])
              if e.device_type.name == "CUDA" and e.device_time_total > 0
              and keep(e.key)]
    total = sum(e.device_time_total for e in events)
    count = sum(e.count for e in events) / reps
    return (total / 1e3 / reps if total else None), count


def fmt_ms(v):
    return "not measured" if v is None else f"{v:.4f}"


def by_part(part, names):
    """``(name, match)`` pairs of the parts ``names`` of a classifier
    ``part(key)`` that names a device kernel's part (None for the rest)."""
    return tuple((name, lambda key, name=name: part(key) == name)
                 for name in names)


def e2e_report(tag, label, what, prof, wall_ms, parts):
    """One profiled run's row: the device's busy time and activities, and
    the device time and launches of each ``(name, match)`` of ``parts``
    (the kernels whose name ``match`` takes); printed as ``[tag e2e
    label]``."""
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0
              and e.device_type.name == "CUDA"]
    busy = sum(e.device_time_total for e in events) / 1e3
    count = sum(e.count for e in events)
    row = {"build": label, "what": what, "busy_ms": busy,
           "activities": count, "wall_ms": wall_ms}
    said = []
    for name, match in parts:
        mine = [e for e in events if match(e.key)]
        row[name] = sum(e.device_time_total for e in mine) / 1e3
        row[name + " launches"] = sum(e.count for e in mine)
        said.append(f"{name} {row[name]:.3f} ms over "
                    f"{row[name + ' launches']} launches")
    print(f"[{tag} e2e {label}] {what}: device busy {busy:.3f} ms of "
          f"{wall_ms:.3f} ms wall, {count} device activities; "
          + "; ".join(said), flush=True)
    return row


def train_step(tag, label, cfg, what, parts):
    """``e2e_report`` of one warm second-order train step of ``cfg`` (at
    its batch size), profiled after two."""
    from torch.profiler import ProfilerActivity, profile

    from howtotrainyourmamlpytorch_tpu_torch import bench as train_bench
    from howtotrainyourmamlpytorch_tpu_torch.core import maml
    from howtotrainyourmamlpytorch_tpu_torch.state import init_state

    device = torch.device("cuda:0")
    state = init_state(cfg, device=device, with_opt=True)
    lr, weights, _ = maml.epoch_schedule(cfg, 0)
    batch = train_bench.synth_batch(cfg, 0, device)
    step = maml.make_train_step(cfg, True)
    for _ in range(2):
        state, _ = step(state, *batch, weights, lr)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        state, _ = step(state, *batch, weights, lr)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    return e2e_report(tag, label, f"profiled {what} batch-{cfg.batch_size} "
                      "train step", prof, wall_ms, parts)


def dispatch(tag, label, cfg, what, parts):
    """``e2e_report`` of one warm serve dispatch of ``cfg``'s largest
    bucket (8 tenants of the 36 synthetic groups' last), profiled after
    one."""
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
    return e2e_report(tag, label, f"profiled {what} bucket-{dr.bucket} "
                      f"dispatch ({dr.tenants} tenants, {dr.shots} shots)",
                      prof, dr.adapt_ms, parts)


def main(argv, tag, description, rows, e2e=None) -> int:
    """Parse ``--label``, ``--out`` and (where the tool has ``e2e``)
    ``--e2e``, print the card as ``[tag label] name, power limit``, run
    ``rows(label)`` (then ``e2e(label)`` with ``--e2e``) and write the rows
    as JSON to ``--out``. Needs a CUDA card."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--label", default="this build")
    parser.add_argument("--out", default=None)
    if e2e is not None:
        parser.add_argument("--e2e", action="store_true")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit(f"{tag}: needs a CUDA card")
    from howtotrainyourmamlpytorch_tpu_torch.device import resolve_device

    resolve_device("cuda:0")  # TF32 off for the library calls
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"[{tag} {args.label}] {card}", flush=True)
    out = rows(args.label)
    if e2e is not None and args.e2e:
        out += e2e(args.label)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "rows": out}, f, indent=1)
    return 0
