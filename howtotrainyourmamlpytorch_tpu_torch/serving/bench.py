"""``serve-bench`` — closed-loop load generator for the port's serving path.

The port of the JAX package's ``serving/bench.py`` closed loop: synthetic
adapt-on-request traffic whose group sizes cycle 1..max_tenants (every
tenant bucket sees traffic) and whose shots cycle two buckets, served
through ``ServingEngine`` after a warmup over every (bucket, shots) shape.
Each group waits for the previous one. ``--ingest`` picks what a request
carries: float32 pixels (``f32``), raw uint8 pixels decoded on the card
(``uint8``), or rows of a synthetic uint8 store of ``--store-rows`` rows
registered with the engine and uploaded once (``index``; by default the
size of the dataset's test split: Omniglot ``int(split[2] * 1623)``
classes x 20 images of {0, 1} pixels, 422 x 20 = 8,440 rows at the
shipped split; otherwise the mini-ImageNet test split, 20 classes x 600
= 12,000 rows of any byte). ``--max_pooling true|false`` overrides the
config's field, as the JAX package's command line overrides any field
(``false`` serves the strided model); ``--block_order
conv_norm_relu|norm_conv_relu`` likewise (``norm_conv_relu``: the
norm-first block), and ``--norm_layer batch_norm|layer_norm``
(``layer_norm``: a layer norm over each image's (H, W, C) in place of the
batch norm, in either block order), and ``--conv_padding true|false``
(``false``: the unpadded model, every 3x3 conv a valid window), and
``--compute_dtype float32|bfloat16`` (``bfloat16``: activations, the conv
and the head in bf16 with f32 accumulation, the JAX package's bf16 cast
points; on the card every model, batch norm or layer norm, conv first
or norm first, pooled or strided, at pad 1 or 0, on the ``*_bf16``
kernels).

Prints ONE JSON line: adapt latency p50/p95, ``tenants_per_sec``,
dispatches, tenants, the ``ingest`` and ``h2d_bytes_per_dispatch`` (the
mean bytes a dispatch uploads), warmup seconds, the ``device`` and its
name, the ``dtype``, each dispatch's (tenants, bucket, shots, adapt_ms,
ingest_bytes), and each kernel's launches over the traffic (warmup
excluded) in total and per dispatch.

Runs on ``cuda:0`` unless ``--device`` names another device; without CUDA
it raises unless ``--device cpu`` is given (the plain PyTorch ops, for
tests). The open-loop arrivals, replicas, fleet and telemetry are not
ported yet.

    python -m howtotrainyourmamlpytorch_tpu_torch.cli serve-bench \\
        --config experiment_config/mini-imagenet_maml++-mini-imagenet_5_5_2_0.01_48_0.json \\
        --requests 32 --seed 0 --ingest index
    python -m howtotrainyourmamlpytorch_tpu_torch.cli serve-bench \\
        --config "experiment_config/omniglot_maml++-omniglot_1_20_8_0.1_64_0.json" \\
        --max_pooling false --requests 16 --ingest index
    python -m howtotrainyourmamlpytorch_tpu_torch.cli serve-bench \\
        --config experiment_config/mini-imagenet_maml++-mini-imagenet_5_5_2_0.01_48_0.json \\
        --block_order norm_conv_relu --requests 16
    python -m howtotrainyourmamlpytorch_tpu_torch.cli serve-bench \\
        --config experiment_config/mini-imagenet_maml++-mini-imagenet_5_5_2_0.01_48_0.json \\
        --norm_layer layer_norm --requests 16 --ingest index
    python -m howtotrainyourmamlpytorch_tpu_torch.cli serve-bench \\
        --config experiment_config/mini-imagenet_maml++-mini-imagenet_5_5_2_0.01_48_0.json \\
        --conv_padding false --requests 16 --ingest index
    python -m howtotrainyourmamlpytorch_tpu_torch.cli serve-bench \\
        --config experiment_config/mini-imagenet_maml++-mini-imagenet_5_5_2_0.01_48_0.json \\
        --compute_dtype bfloat16 --requests 16 --ingest index
    python -m howtotrainyourmamlpytorch_tpu_torch.cli serve-bench \\
        --config "experiment_config/omniglot_maml++-omniglot_1_20_8_0.1_64_0.json" \\
        --max_pooling false --compute_dtype bfloat16 --requests 16
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional

import numpy as np

from .. import kernels
from ..config import _CHOICES, MAMLConfig, _coerce_bool
from ..device import device_name, resolve_device
from ..state import init_state
from .batcher import AdaptRequest, IndexRequest, serve_requests
from .engine import ServingEngine

INGESTS = ("f32", "uint8", "index")
#: the mini-ImageNet test split: 20 classes x 600 images
STORE_ROWS = 12000
#: Omniglot's character count and images per character
OMNIGLOT_CLASSES, OMNIGLOT_PER_CLASS = 1623, 20


#: the block orders ``--block_order`` takes
BLOCK_ORDERS = _CHOICES["block_order"]
#: the norm layers ``--norm_layer`` takes
NORM_LAYERS = _CHOICES["norm_layer"]
#: the compute dtypes ``--compute_dtype`` takes
COMPUTE_DTYPES = _CHOICES["compute_dtype"]


def bool_arg(value: str) -> bool:
    """A command-line boolean as the JAX package's config overrides take
    it: ``true`` / ``false`` (any case)."""
    coerced = _coerce_bool(value)
    if not isinstance(coerced, bool):
        raise argparse.ArgumentTypeError(
            f"expects 'true' or 'false', got {value!r}")
    return coerced


def serving_store_rows(cfg: MAMLConfig) -> int:
    """Rows of the dataset's test split: Omniglot ``int(split[2] * 1623)``
    classes (the JAX package's ``split_classes`` arithmetic) x 20 images;
    otherwise the mini-ImageNet test split's 12,000."""
    if "omniglot" in cfg.dataset_name:
        return (int(cfg.train_val_test_split[2] * OMNIGLOT_CLASSES)
                * OMNIGLOT_PER_CLASS)
    return STORE_ROWS


def _bench_cfg(args) -> MAMLConfig:
    """The generator's config: the user's JSON when given, else a small
    deterministic serving config (``--fast`` shrinks it further)."""
    if args.config:
        cfg = MAMLConfig.from_json_file(args.config)
    elif args.fast:
        cfg = MAMLConfig(
            dataset_name="omniglot_dataset",
            image_height=10, image_width=10, image_channels=1,
            num_classes_per_set=3, num_samples_per_class=1,
            num_target_samples=2, batch_size=2, cnn_num_filters=4,
            num_stages=2, max_pooling=True, per_step_bn_statistics=True,
            number_of_training_steps_per_iter=2,
            number_of_evaluation_steps_per_iter=2,
            serving_bucket_ladder=[1, 2],
            serving_max_tenants_per_dispatch=2,
        )
    else:
        cfg = MAMLConfig(
            dataset_name="omniglot_dataset",
            image_height=28, image_width=28, image_channels=1,
            num_classes_per_set=5, num_samples_per_class=1,
            num_target_samples=5, batch_size=8, cnn_num_filters=32,
            num_stages=4, max_pooling=True, per_step_bn_statistics=True,
            number_of_training_steps_per_iter=3,
            number_of_evaluation_steps_per_iter=3,
        )
    if args.max_pooling is not None:
        cfg = cfg.replace(max_pooling=args.max_pooling)
    if args.block_order is not None:
        cfg = cfg.replace(block_order=args.block_order)
    if args.norm_layer is not None:
        cfg = cfg.replace(norm_layer=args.norm_layer)
    if args.conv_padding is not None:
        cfg = cfg.replace(conv_padding=args.conv_padding)
    if args.compute_dtype is not None:
        cfg = cfg.replace(compute_dtype=args.compute_dtype)
    return cfg


def bench_shots_buckets(cfg: MAMLConfig) -> List[int]:
    """Two shots buckets, so every run exercises both."""
    return sorted({cfg.num_samples_per_class, cfg.num_samples_per_class + 1})


def _synth_store(cfg: MAMLConfig, rows: int = STORE_ROWS,
                 seed: int = 7) -> np.ndarray:
    """A deterministic (rows, h, w, c) uint8 store for the index ingest,
    made from ``seed`` with numpy (raw bytes: no int64 temporary at
    store size); Omniglot's pixels in {0, 1}, as its 1-bit sources
    decode."""
    rng = np.random.RandomState(seed)
    h, w, c = cfg.im_shape
    data = np.frombuffer(rng.bytes(rows * h * w * c), np.uint8).reshape(
        rows, h, w, c)
    return data & 1 if "omniglot" in cfg.dataset_name else data.copy()


def _synth_request(cfg: MAMLConfig, rng, shots: int, tenant_id: str,
                   ingest: str = "f32", store_rows: int = 0):
    n, t = cfg.num_classes_per_set, cfg.num_target_samples
    h, w, c = cfg.im_shape
    if ingest == "index":
        return IndexRequest(
            support_idx=rng.randint(0, store_rows, (n, shots)).astype(
                np.int32),
            query_idx=rng.randint(0, store_rows, (n, t)).astype(np.int32),
            labeled=True,
            tenant_id=tenant_id,
        )
    if ingest == "uint8":
        sx = rng.randint(0, 256, (n, shots, h, w, c)).astype(np.uint8)
        qx = rng.randint(0, 256, (n, t, h, w, c)).astype(np.uint8)
    else:
        sx = rng.randn(n, shots, h, w, c).astype(np.float32)
        qx = rng.randn(n, t, h, w, c).astype(np.float32)
    return AdaptRequest(
        support_x=sx,
        support_y=np.tile(np.arange(n, dtype=np.int32)[:, None], (1, shots)),
        query_x=qx,
        query_y=np.tile(np.arange(n, dtype=np.int32)[:, None], (1, t)),
        tenant_id=tenant_id,
    )


def _synth_groups(cfg: MAMLConfig, shots_buckets, n_requests: int, cap: int,
                  seed: int, ingest: str = "f32", store_rows: int = 0
                  ) -> List[List]:
    """Deterministic traffic as DISPATCH GROUPS: sizes cycle 1..cap and
    each group's shots cycle the configured buckets."""
    rng = np.random.RandomState(seed)
    groups: List[List] = []
    size, total, g = 1, 0, 0
    while total < n_requests:
        take = min(size, n_requests - total)
        s = shots_buckets[g % len(shots_buckets)]
        groups.append([
            _synth_request(cfg, rng, s, f"tenant-{total + i}", ingest,
                           store_rows)
            for i in range(take)
        ])
        total += take
        g += 1
        size = size + 1 if size < cap else 1
    return groups


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="serve-bench",
        description="Closed-loop load generator for the PyTorch port's "
                    "adapt-on-request serving engine",
    )
    parser.add_argument("--fast", action="store_true",
                        help="seconds-scale smoke workload")
    parser.add_argument("--config", default=None,
                        help="experiment JSON supplying the geometry and "
                             "serving_* knobs")
    parser.add_argument("--requests", type=int, default=None,
                        help="synthetic requests to serve (default: 8 "
                             "fast, 64 otherwise)")
    parser.add_argument("--seed", type=int, default=0,
                        help="traffic seed (the snapshot uses the config's "
                             "seed)")
    parser.add_argument("--ingest", choices=INGESTS, default="f32",
                        help="what a request carries: f32 pixels, uint8 "
                             "pixels, or rows of a registered store")
    parser.add_argument("--store-rows", type=int, default=None,
                        help="rows of the synthetic store of --ingest index "
                             "(default: the dataset's test split)")
    parser.add_argument("--max_pooling", type=bool_arg, default=None,
                        help="override the config's max_pooling (true or "
                             "false), as the JAX command line does")
    parser.add_argument("--block_order", choices=BLOCK_ORDERS, default=None,
                        help="override the config's block_order, as the "
                             "JAX command line does")
    parser.add_argument("--norm_layer", choices=NORM_LAYERS, default=None,
                        help="override the config's norm_layer, as the JAX "
                             "command line does")
    parser.add_argument("--conv_padding", type=bool_arg, default=None,
                        help="override the config's conv_padding (true or "
                             "false), as the JAX command line does")
    parser.add_argument("--compute_dtype", choices=COMPUTE_DTYPES,
                        default=None,
                        help="override the config's compute_dtype, as the "
                             "JAX command line does")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda:0; 'cpu' runs the "
                             "plain PyTorch ops)")
    return parser


def run(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Drive the bench; returns the JSON line as a dict."""
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = _bench_cfg(args)
    n_requests = args.requests or (8 if args.fast else 64)
    shots_buckets = bench_shots_buckets(cfg)
    state = init_state(cfg, device=device)
    store_rows = 0
    if args.ingest == "index":
        store_rows = args.store_rows or serving_store_rows(cfg)
    engine = ServingEngine(
        cfg, state, shots_buckets=shots_buckets, device=device,
        ingest=args.ingest,
        store=(_synth_store(cfg, store_rows, args.seed + 7)
               if args.ingest == "index" else None))
    warmup_s = engine.warmup()
    groups = _synth_groups(cfg, shots_buckets, n_requests,
                           engine.max_tenants, args.seed, args.ingest,
                           store_rows)
    per_dispatch = []
    dispatches = []
    before = kernels.launches()
    for group in groups:
        at = kernels.launches()
        for dr in serve_requests(engine, group)[1]:
            dispatches.append({"tenants": dr.tenants, "bucket": dr.bucket,
                               "shots": dr.shots, "adapt_ms": dr.adapt_ms,
                               "ingest_bytes": dr.ingest_bytes})
        now = kernels.launches()
        per_dispatch.append({k: now[k] - at[k] for k in now})
    after = kernels.launches()
    rollup = engine.rollup()
    return {
        "metric": "serving_adaptation_latency_ms",
        "value": rollup["adapt_ms_p50"],
        "unit": "ms",
        "adaptation_latency_ms_p50": rollup["adapt_ms_p50"],
        "adaptation_latency_ms_p95": rollup["adapt_ms_p95"],
        "tenants_per_sec": rollup["tenants_per_sec"],
        "dispatches": rollup["dispatches"],
        "tenants": rollup["tenants"],
        "ingest": rollup["ingest"],
        "h2d_bytes_per_dispatch": rollup["h2d_bytes_per_dispatch"],
        "store_rows": store_rows,
        "warmup_seconds": warmup_s,
        "warmup_dispatches": engine.warmup_stats["dispatches"],
        "device": str(device),
        "device_name": device_name(device),
        "dtype": cfg.compute_dtype,
        "max_pooling": cfg.max_pooling,
        "block_order": cfg.block_order,
        "norm_layer": cfg.norm_layer,
        "conv_padding": cfg.conv_padding,
        "kernel_launches": {k: after[k] - before[k] for k in after},
        "kernel_launches_per_dispatch": per_dispatch,
        "per_dispatch": dispatches,
        "bucket_ladder": list(engine.buckets),
        "shots_buckets": list(engine.shots_buckets),
        "max_tenants_per_dispatch": engine.max_tenants,
        "requests": n_requests,
        "fast": bool(args.fast),
    }


def main(argv: Optional[List[str]] = None) -> int:
    print(json.dumps(run(argv)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
