"""What the kernel A/B tools (``k1_times.py``, ``k35_times.py``) share: a
call's time by CUDA events, the device time of the kernels it launches by
``torch.profiler``, and their command line (``--label``, ``--out``), which
prints the card's ``nvidia-smi`` line and writes the rows as JSON.

The tools are run by path with ``PYTHONPATH`` naming the checkout whose
package they time, and import this module from their own directory
(``import card_timing``), so both builds of an A/B are timed the same way.
"""

from __future__ import annotations

import argparse
import json
import subprocess

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


def main(argv, tag, description, rows) -> int:
    """Parse ``--label`` and ``--out``, print the card as ``[tag label]
    name, power limit``, run ``rows(label)`` and write its rows as JSON
    to ``--out``. Needs a CUDA card."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--label", default="this build")
    parser.add_argument("--out", default=None)
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
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "rows": out}, f, indent=1)
    return 0
