"""``train-bench`` — the port's meta-training step under a timer.

The port of the root ``bench.py``'s measurement (:106-142, :708-...): the
MAML++ outer step (``core/maml.py::make_train_step``) on synthetic batches
made from ``--seed`` with numpy and uploaded once, ``--warmup`` steps, then
``--steps`` timed steps, each timed on the host clock around the step and
a device synchronise. The defaults are the root bench's flagship
(mini-ImageNet 5-way 5-shot, 84x84x3, 48 filters, 4 stages, 5 inner steps,
15 targets per class, second order from epoch 0) at the config's batch;
``--fast`` is a seconds-scale toy.

``--data-placement host|uint8_stream|device`` measures a data tier
instead of the fixed batch: every step draws new tasks (task seeds
``seed * 1_000_003 + step * batch + t``, train-time augmentation) from
one synthetic uint8 ``FlatStore`` made from ``--seed`` with numpy at the
real train-split size (``synth_train_store``), through the port's sampler,
so the three tiers draw the same tasks:

* ``host``: float32 pixels decoded and rotated on the host, uploaded;
* ``uint8_stream``: uint8 pixels gathered and rotated on the host,
  uploaded, decoded on the card (two ``episode_expand`` launches);
* ``device``: the store goes to the card once; per step the host ships the
  (batch, way, shots + targets) int32 rows and (batch, way) rot90 draws,
  and one ``episode_expand`` launch expands them.

``--max_pooling true|false`` overrides the config's field, as the JAX
package's command line overrides any field (``false``: the strided
model); ``--block_order conv_norm_relu|norm_conv_relu`` likewise
(``norm_conv_relu``: the norm-first block), and ``--norm_layer
batch_norm|layer_norm`` (``layer_norm``: a layer norm over each image's
(H, W, C), gamma frozen at 1 and beta meta-trained, no running
statistics), and ``--conv_padding true|false`` (``false``: the unpadded
model, every 3x3 conv a valid window, 84 -> 82 at stage 0), and
``--compute_dtype float32|bfloat16``. In bf16 the card trains every
model second order — batch norm or layer norm (``--norm_layer
layer_norm``), conv first or norm first (``--block_order
norm_conv_relu``), pooled or strided (``--max_pooling false``), padded or
not (``--conv_padding false``) — on the ``*_bf16`` kernels, with f32
master parameters and Adam moments.

The config's ``use_mmap_cache`` and ``data_placement`` are set to match
(the port's config requires the first for any tier but host). A tier's
step time covers the host assembly, the upload, the step and a device
synchronise; the line adds ``data_placement``, ``h2d_bytes_per_step``
(the bytes of the arrays uploaded), ``host_assembly_ms_per_step`` and
``expand_launches_per_step``, the port's counterparts of the root bench's
``_measure_input_pipeline``.

Prints ONE JSON line: ``tasks_per_sec``, ``step_ms`` p50/p95 and each
step's time, ``second_order``, ``batch_size``, ``peak_mem_gb``
(``torch.cuda.max_memory_allocated``), each step's ``loss`` and
``accuracy``, ``model_flops_per_task`` (the root bench's analytic count),
the achieved f32 model FLOP rate and its share of the card's FFMA peak,
and each kernel's launches in every timed step.

Runs on ``cuda:0`` unless ``--device`` names another device; without CUDA
it raises unless ``--device cpu`` is given (the plain PyTorch ops, for
tests).

    python -m howtotrainyourmamlpytorch_tpu_torch.cli train-bench
    python -m howtotrainyourmamlpytorch_tpu_torch.cli train-bench --fast --device cpu
    python -m howtotrainyourmamlpytorch_tpu_torch.cli train-bench \\
        --config "experiment_config/omniglot_maml++-omniglot_1_20_8_0.1_64_0.json" \\
        --data-placement device
    python -m howtotrainyourmamlpytorch_tpu_torch.cli train-bench \\
        --config "experiment_config/omniglot_maml++-omniglot_1_20_8_0.1_64_0.json" \\
        --max_pooling false --data-placement device
    python -m howtotrainyourmamlpytorch_tpu_torch.cli train-bench \\
        --block_order norm_conv_relu
    python -m howtotrainyourmamlpytorch_tpu_torch.cli train-bench \\
        --norm_layer layer_norm
    python -m howtotrainyourmamlpytorch_tpu_torch.cli train-bench \\
        --conv_padding false
    python -m howtotrainyourmamlpytorch_tpu_torch.cli train-bench \\
        --config "experiment_config/omniglot_maml++-omniglot_1_20_8_0.1_64_0.json" \\
        --max_pooling false --compute_dtype bfloat16 --data-placement device
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from . import kernels
from .config import MAMLConfig
from .core import maml
from .data import loader
from .data.preprocess import FlatStore
from .device import device_name, peak_rates, resolve_device, synchronize
from .serving.bench import (
    BLOCK_ORDERS,
    COMPUTE_DTYPES,
    NORM_LAYERS,
    OMNIGLOT_CLASSES,
    OMNIGLOT_PER_CLASS,
    bool_arg,
)
from .state import init_state

PLACEMENTS = ("host", "uint8_stream", "device")
#: the mini-ImageNet train split: 64 classes x 600 images
IMAGENET_TRAIN_CLASSES, IMAGENET_PER_CLASS = 64, 600

FLAGSHIP = (Path(__file__).resolve().parent.parent / "experiment_config"
            / "mini-imagenet_maml++-mini-imagenet_5_5_2_0.01_48_0.json")


def forward_flops_per_image(cfg: MAMLConfig) -> float:
    """Analytic forward FLOPs (2 x MACs) of one image through the backbone:
    ``num_stages`` 3x3 convs (stride 1 and a 2x2 pool with max pooling,
    else stride 2; pad 1, or 0 with ``conv_padding=False``), then the
    linear head. The root bench's count, which takes pad 1."""
    h, w = cfg.image_height, cfg.image_width
    cin = cfg.image_channels
    stride = 1 if cfg.max_pooling else 2
    pad = 1 if cfg.conv_padding else 0
    flops = 0.0
    for _ in range(cfg.num_stages):
        h = (h + 2 * pad - 3) // stride + 1
        w = (w + 2 * pad - 3) // stride + 1
        flops += 2.0 * h * w * 9 * cin * cfg.cnn_num_filters
        if cfg.max_pooling:
            h, w = h // 2, w // 2
        cin = cfg.cnn_num_filters
    feat = (h * w * cfg.cnn_num_filters if cfg.max_pooling
            else cfg.cnn_num_filters)
    return flops + 2.0 * feat * cfg.num_classes_per_set


def train_flops_per_task(cfg: MAMLConfig, second_order: bool = True) -> float:
    """Analytic FLOPs of one task in the train step, the root bench's model:
    per inner step a support forward, a support gradient (~2 forwards) and
    a target forward, ``steps * (3 F_s + F_t)``, times 3 for the outer
    backward of second order (1.5 for first order)."""
    f_img = forward_flops_per_image(cfg)
    f_s = f_img * cfg.num_classes_per_set * cfg.num_samples_per_class
    f_t = f_img * cfg.num_classes_per_set * cfg.num_target_samples
    inner = cfg.number_of_training_steps_per_iter * (3.0 * f_s + f_t)
    return inner * (3.0 if second_order else 1.5)


def _bench_cfg(args) -> MAMLConfig:
    if args.fast:
        cfg = MAMLConfig(
            dataset_name="omniglot_dataset",
            image_height=10, image_width=10, image_channels=1,
            num_classes_per_set=3, num_samples_per_class=1,
            num_target_samples=2, batch_size=2, cnn_num_filters=4,
            num_stages=2, max_pooling=True, per_step_bn_statistics=True,
            learnable_per_layer_per_step_inner_loop_learning_rate=True,
            number_of_training_steps_per_iter=2,
            number_of_evaluation_steps_per_iter=2,
            second_order=True, use_multi_step_loss_optimization=True,
        )
    else:
        cfg = MAMLConfig.from_json_file(args.config or str(FLAGSHIP))
    if args.batch_size is not None:
        cfg = cfg.replace(batch_size=args.batch_size)
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


def synth_batch(cfg: MAMLConfig, seed: int, device: torch.device):
    """One task batch ``(x_s, y_s, x_t, y_t)`` on ``device``: NHWC images
    drawn with numpy from ``seed`` around a per-(task, class) mean (so the
    classes can be told apart), labels 0..way-1 per class."""
    rng = np.random.RandomState(seed)
    b, n = cfg.batch_size, cfg.num_classes_per_set
    s, t = cfg.num_samples_per_class, cfg.num_target_samples
    h, w, c = cfg.im_shape
    means = rng.randn(b, n, 1, 1, 1, 1).astype(np.float32)
    x_s = (rng.randn(b, n, s, h, w, c) * 0.5 + means).astype(np.float32)
    x_t = (rng.randn(b, n, t, h, w, c) * 0.5 + means).astype(np.float32)
    y_s = np.tile(np.arange(n, dtype=np.int32)[None, :, None], (b, 1, s))
    y_t = np.tile(np.arange(n, dtype=np.int32)[None, :, None], (b, 1, t))
    return tuple(torch.from_numpy(a).to(device) for a in (x_s, y_s, x_t, y_t))


def synth_train_store(cfg: MAMLConfig, seed: int) -> FlatStore:
    """A synthetic uint8 train store at the real split size, made from
    ``seed`` with numpy. Omniglot: ``int(split[0] * 1623)`` classes (the
    JAX package's ``split_classes`` arithmetic; 1,150 at the shipped split)
    x 20 images, pixels in {0, 1} as the 1-bit sources decode; other
    datasets: the mini-ImageNet train split, 64 classes x 600 images, any
    byte."""
    if "omniglot" in cfg.dataset_name:
        classes = int(cfg.train_val_test_split[0] * OMNIGLOT_CLASSES)
        per_class = OMNIGLOT_PER_CLASS
    else:
        classes, per_class = IMAGENET_TRAIN_CLASSES, IMAGENET_PER_CLASS
    h, w, c = cfg.im_shape
    rng = np.random.RandomState(seed)
    data = np.frombuffer(rng.bytes(classes * per_class * h * w * c),
                         np.uint8).reshape(classes * per_class, h, w, c)
    data = data & 1 if "omniglot" in cfg.dataset_name else data.copy()
    return FlatStore(
        data=data,
        offsets={str(i): i * per_class for i in range(classes)},
        sizes={str(i): per_class for i in range(classes)},
    )


class _Tier:
    """One data tier's per-step work: ``assemble(step)`` builds the host
    arrays of a step's tasks, ``run(state, arrays, weights, lr)`` uploads
    them and runs the step."""

    def __init__(self, cfg: MAMLConfig, placement: str, second_order: bool,
                 seed: int, device: torch.device):
        self.cfg, self.placement, self.device = cfg, placement, device
        self.store = synth_train_store(cfg, seed)
        self.keys = loader.class_keys_of(self.store)
        self.seed_base = seed * 1_000_003
        if placement == "device":
            self.resident = torch.from_numpy(self.store.data).to(device)
            self.step = maml.make_train_step_indexed(cfg, second_order,
                                                     augment=True)
        else:
            self.step = maml.make_train_step(
                cfg, second_order, decode_uint8=placement == "uint8_stream")

    def assemble(self, step: int):
        cfg, b = self.cfg, self.cfg.batch_size
        seeds = [self.seed_base + step * b + t for t in range(b)]
        if self.placement == "device":
            batch = loader.stack_indices(
                [loader.episode_indices(cfg, self.store, self.keys, s)
                 for s in seeds], "train", True)
            return batch.gather, batch.rot_k
        build = (loader.episode if self.placement == "host"
                 else loader.episode_uint8)
        x_s, x_t, y_s, y_t, _ = loader.stack(
            [build(cfg, self.store, self.keys, s, True) for s in seeds])
        return x_s, y_s, x_t, y_t

    def run(self, state, arrays, weights, lr):
        args = [torch.from_numpy(a).to(self.device) for a in arrays]
        if self.placement == "device":
            args.insert(0, self.resident)
        return self.step(state, *args, weights, lr)


def _percentile(values: List[float], q: float) -> float:
    return float(np.percentile(np.asarray(values), q))


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="train-bench",
        description="Time the PyTorch port's MAML++ meta-training step",
    )
    parser.add_argument("--fast", action="store_true",
                        help="seconds-scale toy configuration")
    parser.add_argument("--config", default=None,
                        help="experiment JSON (default: the mini-ImageNet "
                             "MAML++ flagship)")
    parser.add_argument("--batch-size", type=int, default=None,
                        help="tasks per step (default: the config's)")
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
    parser.add_argument("--epoch", type=int, default=0,
                        help="epoch fed to the schedule (LR, MSL weights, "
                             "order)")
    parser.add_argument("--first-order", action="store_true",
                        help="first order whatever the schedule says")
    parser.add_argument("--warmup", type=int, default=2,
                        help="untimed steps before the timed ones")
    parser.add_argument("--steps", type=int, default=5,
                        help="timed steps")
    parser.add_argument("--seed", type=int, default=0,
                        help="data seed (the weights use the config's seed)")
    parser.add_argument("--data-placement", choices=PLACEMENTS, default=None,
                        help="draw every step's tasks through this data tier "
                             "from a synthetic train store (default: one "
                             "fixed synthetic batch, uploaded once)")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda:0; 'cpu' runs the "
                             "plain PyTorch ops)")
    return parser


def run(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Drive the bench; returns the JSON line as a dict."""
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = _bench_cfg(args)
    placement = args.data_placement
    if placement is not None:
        cfg = cfg.replace(use_mmap_cache=True, data_placement=placement)
    lr, weights, second_order = maml.epoch_schedule(cfg, args.epoch)
    second_order = second_order and not args.first_order
    state = init_state(cfg, device=device, with_opt=True)
    if placement is None:
        batch = synth_batch(cfg, args.seed, device)
        train_step = maml.make_train_step(cfg, second_order)

        def assemble(step):
            return batch

        def run(state, arrays, weights, lr):
            return train_step(state, *arrays, weights, lr)
    else:
        tier = _Tier(cfg, placement, second_order, args.seed, device)
        assemble, run = tier.assemble, tier.run
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    for i in range(args.warmup):
        state, metrics = run(state, assemble(i), weights, lr)
    synchronize(device)
    step_ms, losses, accs, launches = [], [], [], []
    assembly_ms, h2d_bytes = [], []
    for i in range(args.warmup, args.warmup + args.steps):
        before = kernels.launches()
        start = time.perf_counter()
        arrays = assemble(i)
        assembled = time.perf_counter()
        state, metrics = run(state, arrays, weights, lr)
        synchronize(device)
        end = time.perf_counter()
        step_ms.append((end - start) * 1e3)
        assembly_ms.append((assembled - start) * 1e3)
        h2d_bytes.append(sum(int(a.nbytes) for a in arrays)
                         if placement is not None else 0)
        now = kernels.launches()
        launches.append({k: now[k] - before[k] for k in now})
        losses.append(float(metrics["loss"]))
        accs.append(float(metrics["accuracy"]))
    tasks_per_sec = (cfg.batch_size * len(step_ms) / (sum(step_ms) / 1e3)
                     if step_ms else None)
    flops = train_flops_per_task(cfg, second_order)
    rate = tasks_per_sec * flops if tasks_per_sec else None
    name = device_name(device)
    peak = peak_rates(name)[0] if device.type == "cuda" else None
    return {
        "metric": "meta_tasks_per_sec",
        "value": tasks_per_sec,
        "unit": "tasks/s",
        "tasks_per_sec": tasks_per_sec,
        "step_ms_p50": _percentile(step_ms, 50) if step_ms else None,
        "step_ms_p95": _percentile(step_ms, 95) if step_ms else None,
        "step_ms": step_ms,
        "second_order": second_order,
        "batch_size": cfg.batch_size,
        "max_pooling": cfg.max_pooling,
        "block_order": cfg.block_order,
        "norm_layer": cfg.norm_layer,
        "conv_padding": cfg.conv_padding,
        "meta_accum_steps": cfg.meta_accum_steps,
        "epoch": args.epoch,
        "lr": lr,
        "msl_weights": [float(w) for w in weights],
        "loss": losses,
        "accuracy": accs,
        "peak_mem_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                        if device.type == "cuda" else None),
        "model_flops_per_task": flops,
        "model_tflops_per_sec": rate / 1e12 if rate else None,
        "ffma_peak_share": rate / peak if rate and peak else None,
        "kernel_launches_per_step": launches,
        "data_placement": placement,
        "h2d_bytes_per_step": (float(np.mean(h2d_bytes)) if h2d_bytes
                               and placement is not None else None),
        "host_assembly_ms_per_step": (float(np.mean(assembly_ms))
                                      if assembly_ms and placement is not None
                                      else None),
        "expand_launches_per_step": [d["episode_expand"] for d in launches],
        "warmup_steps": args.warmup,
        "device": str(device),
        "device_name": name,
        "dtype": cfg.compute_dtype,
        "fast": bool(args.fast),
    }


def main(argv: Optional[List[str]] = None) -> int:
    print(json.dumps(run(argv)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
