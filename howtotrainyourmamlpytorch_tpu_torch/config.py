"""Typed configuration for the PyTorch port: a copy of the JAX package's
``MAMLConfig`` (``howtotrainyourmamlpytorch_tpu/config.py``).

Every field of the JAX dataclass is here under the same name and default,
so every ``experiment_config/*.json`` loads unchanged. The field comments
live in the JAX package; only what differs in the port is noted here:

* ``bn_stats_impl`` and ``compute_dtype`` change the numbers and are
  honoured. ``'auto'`` statistics resolve from the port's device
  (``resolved_bn_stats_impl``), as the JAX package resolves them from its
  backend: ``'fused'`` on the CPU, ``'twopass'`` on an accelerator.
* ``conv_impl``, ``pad_channels``, ``pool_impl``, ``im2col_hoist`` and
  ``matmul_precision`` are XLA lowering hints. They are validated and
  otherwise ignored: the port always multiplies f32 in true f32
  (``device.py``).
* ``use_remat``, ``remat_policy`` and ``task_axis_mode`` are validated
  and otherwise ignored too: none changes the numbers in the JAX package.
  ``use_remat`` (with ``remat_policy``) wraps the inner step in
  ``jax.checkpoint`` there, which only bounds memory; the port keeps every
  activation, and the card has room (the f32 conv-first mini-ImageNet
  step at batch 8 peaks at 12.36 GB of an H100's 80 GB). ``task_axis_mode``
  picks ``vmap`` or ``lax.map`` over the tasks, numerically equivalent;
  the port always carries the task axis as the tenant axis of its
  kernels. ``tests/test_torch_config_fields.py`` holds the port's
  meta-gradients to the JAX package's under each setting.
* ``compilation_cache_dir`` names XLA's persistent compilation cache; the
  port compiles nothing at run time, so it is accepted and ignored like
  the lowering hints.
* The runner (``cli train``) refuses what it has not ported yet rather
  than run without it: ``telemetry_level``, ``tracing_level``,
  ``health_level`` or ``analysis_level`` other than ``'off'``, a
  ``fault_spec``, a ``profile_trace_dir`` or a ``watchdog_timeout_s``
  raise ``NotImplementedError`` naming their ROADMAP item
  (``experiment/builder.py``).
* Nothing here imports jax; the fault-spec grammar check of the JAX
  package (its ``resilience`` module) is not repeated.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple, Union


def _coerce_bool(value: Any) -> Any:
    """Reference-compatible string->bool coercion ("true"/"false")."""
    if isinstance(value, str):
        if value.lower() == "true":
            return True
        if value.lower() == "false":
            return False
    return value


def _is_int(v: Any) -> bool:
    return isinstance(v, int) and not isinstance(v, bool)


def _int_if_integral(v: Any) -> Any:
    """JSON round-trips may turn an int into an integral float."""
    return int(v) if isinstance(v, float) and v.is_integer() else v


#: string knobs and their legal values (validated in ``__post_init__``)
_CHOICES: Dict[str, Tuple[str, ...]] = {
    "inner_loop_optimizer": ("lslr", "sgd"),
    "compute_dtype": ("float32", "bfloat16"),
    "norm_layer": ("batch_norm", "layer_norm"),
    "block_order": ("conv_norm_relu", "norm_conv_relu"),
    "task_axis_mode": ("vmap", "map"),
    "conv_impl": ("auto", "lax", "im2col", "gemm"),
    "pool_impl": ("auto", "reshape", "reduce_window"),
    "bn_stats_impl": ("auto", "twopass", "fused"),
    "im2col_hoist": ("auto", "on", "off"),
    "matmul_precision": ("auto", "default", "high", "highest"),
    "input_layout": ("auto", "nhwc", "nchw"),
    "data_placement": ("host", "uint8_stream", "device"),
    "store_sharding": ("replicated", "hosts"),
    "telemetry_level": ("off", "scalars", "dynamics"),
    "tracing_level": ("off", "on"),
    "serving_ingest": ("f32", "uint8", "index"),
    "analysis_level": ("off", "warn", "strict"),
    "health_level": ("off", "monitor", "halt"),
    "remat_policy": ("full", "save_conv"),
}


@dataclass
class MAMLConfig:
    """The union of the reference's argparse defaults and JSON-only keys."""

    # --- experiment identity / bookkeeping -------------------------------
    experiment_name: str = "maml_experiment"
    seed: int = 104
    train_seed: int = 0
    val_seed: int = 0
    continue_from_epoch: str = "latest"
    max_models_to_save: int = 5
    total_epochs_before_pause: int = 100
    evaluate_on_test_set_only: bool = False

    # --- data ------------------------------------------------------------
    dataset_name: str = "omniglot_dataset"
    dataset_path: str = "datasets/omniglot_dataset"
    batch_size: int = 32
    image_height: int = 28
    image_width: int = 28
    image_channels: int = 1
    num_classes_per_set: int = 20
    num_samples_per_class: int = 1
    num_target_samples: int = 15
    num_evaluation_tasks: int = 600
    sets_are_pre_split: bool = False
    load_into_memory: bool = False
    train_val_test_split: List[float] = field(
        default_factory=lambda: [0.73982737361, 0.26, 0.13008631319]
    )
    indexes_of_folders_indicating_class: List[int] = field(
        default_factory=lambda: [-2, -3]
    )
    reverse_channels: bool = False
    labels_as_int: bool = False
    classification_mean: Union[float, List[float]] = 0.5
    classification_std: Union[float, List[float]] = 0.5
    reset_stored_filepaths: bool = False
    num_dataprovider_workers: int = 4
    samples_per_iter: int = 1

    # --- model -----------------------------------------------------------
    num_stages: int = 4
    cnn_num_filters: int = 64
    conv_padding: bool = True
    max_pooling: bool = False
    norm_layer: str = "batch_norm"
    block_order: str = "conv_norm_relu"
    per_step_bn_statistics: bool = False
    learnable_bn_gamma: bool = True
    learnable_bn_beta: bool = True
    enable_inner_loop_optimizable_bn_params: bool = False

    # --- meta-optimization -----------------------------------------------
    total_epochs: int = 100
    total_iter_per_epoch: int = 500
    meta_learning_rate: float = 0.001
    min_learning_rate: float = 0.00001
    task_learning_rate: float = 0.1
    init_inner_loop_learning_rate: float = 0.01
    number_of_training_steps_per_iter: int = 1
    number_of_evaluation_steps_per_iter: int = 1
    second_order: bool = False
    first_order_to_second_order_epoch: int = -1
    use_multi_step_loss_optimization: bool = False
    multi_step_loss_num_epochs: int = 15
    learnable_per_layer_per_step_inner_loop_learning_rate: bool = False

    # --- compute knobs (lowering hints are accepted and ignored) ---------
    inner_loop_optimizer: str = "lslr"
    compute_dtype: str = "float32"
    matmul_precision: str = "auto"
    use_remat: bool = True
    remat_policy: str = "full"
    num_devices: int = 0
    task_axis_mode: str = "vmap"
    conv_impl: str = "auto"
    pad_channels: Union[str, int] = "auto"
    meta_accum_steps: int = 1
    pool_impl: str = "auto"
    bn_stats_impl: str = "auto"
    im2col_hoist: str = "auto"
    use_config_init_inner_lr: bool = False
    input_layout: str = "auto"
    cache_dir: str = ""
    use_mmap_cache: bool = False
    prefetch_batches: int = 2
    data_placement: str = "host"
    store_sharding: str = "replicated"
    steps_per_dispatch: int = 1
    eval_batches_per_dispatch: int = 1
    profile_trace_dir: str = ""
    profile_num_steps: int = 5
    profile_epoch: int = -1
    profile_start_step: int = 1

    # --- observability ---------------------------------------------------
    telemetry_level: str = "off"
    telemetry_tensorboard: bool = False
    tracing_level: str = "off"
    watchdog_timeout_s: float = 0.0
    health_level: str = "off"
    anomaly_loss_spike_factor: float = 10.0
    anomaly_grad_spike_factor: float = 10.0
    health_grad_norm_limit: float = 0.0
    health_patience: int = 1
    anomaly_update_ratio_max: float = 0.0
    anomaly_ema_beta: float = 0.98
    anomaly_warmup_steps: int = 20
    anomaly_cooldown_steps: int = 200
    flight_recorder_steps: int = 256
    max_state_dumps: int = 3

    # --- resilience ------------------------------------------------------
    fault_spec: str = ""
    io_retry_attempts: int = 3
    io_retry_backoff_s: float = 0.5
    io_retry_backoff_factor: float = 2.0
    handle_preemption_signals: bool = True
    drain_margin_iters: int = 4
    ckpt_follower_timeout_s: float = 600.0

    # --- serving ---------------------------------------------------------
    serving_bucket_ladder: List[int] = field(
        default_factory=lambda: [1, 2, 4, 8]
    )
    serving_max_wait_ms: float = 5.0
    serving_max_tenants_per_dispatch: int = 8
    serving_ingest: str = "f32"
    serving_adapted_cache_size: int = 0
    serving_export_dir: str = ""
    serving_replicas: int = 1
    serving_router_spill_depth: int = 8
    serving_rollover_poll_s: float = 5.0
    serving_slo_target_ms: float = 0.0
    serving_slo_availability: float = 0.99
    serving_slo_burn_windows_s: List[float] = field(
        default_factory=lambda: [60.0, 300.0, 3600.0]
    )
    serving_gateway_queue_budget: int = 64
    serving_gateway_priority_tiers: int = 3
    serving_gateway_health_interval_s: float = 0.5

    # --- static analysis -------------------------------------------------
    analysis_level: str = "off"
    hbm_budget_gb: float = 0.0
    compilation_cache_dir: str = "auto"

    # --- accepted-but-inert reference keys -------------------------------
    dropout_rate_value: float = 0.0
    weight_decay: float = 0.0
    cnn_blocks_per_stage: int = 1
    cnn_num_blocks: int = 4
    learnable_batch_norm_momentum: bool = False
    minimum_per_task_contribution: float = 0.01
    evalute_on_test_set_only: bool = False
    meta_opt_bn: bool = False
    num_of_gpus: int = 1
    gpu_to_use: int = 0
    architecture_name: Optional[str] = None
    name_of_args_json_file: str = "None"
    reset_stored_paths: bool = False

    # ---------------------------------------------------------------------

    def __post_init__(self) -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, _coerce_bool(getattr(self, f.name)))
        for knob, legal in _CHOICES.items():
            if getattr(self, knob) not in legal:
                raise ValueError(
                    f"{knob} must be one of {legal}, got "
                    f"{getattr(self, knob)!r}"
                )
        if isinstance(self.pad_channels, str) and self.pad_channels.isdigit():
            self.pad_channels = int(self.pad_channels)
        if not (
            self.pad_channels in ("auto", "off", "tile")
            or (_is_int(self.pad_channels) and self.pad_channels > 0)
        ):
            raise ValueError(
                f"pad_channels must be 'auto', 'off', 'tile' or a positive "
                f"int, got {self.pad_channels!r}"
            )
        if not (_is_int(self.meta_accum_steps) and self.meta_accum_steps >= 1):
            raise ValueError(
                f"meta_accum_steps must be an int >= 1, got "
                f"{self.meta_accum_steps!r}"
            )
        if self.batch_size % self.meta_accum_steps != 0:
            raise ValueError(
                f"meta_accum_steps={self.meta_accum_steps} must divide "
                f"batch_size={self.batch_size}"
            )
        if self.im2col_hoist == "on" and self.conv_impl == "lax":
            raise ValueError(
                "im2col_hoist='on' requires a patch-based conv lowering, got "
                f"conv_impl={self.conv_impl!r}"
            )
        if self.im2col_hoist == "on" and self.block_order != "conv_norm_relu":
            raise ValueError(
                "im2col_hoist='on' requires block_order='conv_norm_relu', "
                f"got {self.block_order!r}"
            )
        if self.max_pooling:
            # reject feature maps that vanish under the 2x2/2 VALID pool
            h, w = self.image_height, self.image_width
            pad = 1 if self.conv_padding else 0
            for stage in range(self.num_stages):
                ch, cw = h + 2 * pad - 2, w + 2 * pad - 2
                if ch < 2 or cw < 2:
                    raise ValueError(
                        f"max_pooling geometry vanishes at stage {stage}: "
                        f"the pool input is {ch}x{cw}, smaller than the 2x2 "
                        f"window ({self.image_height}x{self.image_width}, "
                        f"num_stages={self.num_stages})"
                    )
                h, w = ch // 2, cw // 2
        for knob in ("steps_per_dispatch", "eval_batches_per_dispatch",
                     "drain_margin_iters", "health_patience",
                     "io_retry_attempts"):
            if getattr(self, knob) < 1:
                raise ValueError(
                    f"{knob} must be >= 1, got {getattr(self, knob)}"
                )
        if self.data_placement != "host":
            if "cifar" in self.dataset_name:
                raise ValueError(
                    f"data_placement={self.data_placement!r} is not "
                    f"supported for dataset {self.dataset_name!r}"
                )
            if not self.use_mmap_cache:
                raise ValueError(
                    f"data_placement={self.data_placement!r} requires "
                    "use_mmap_cache=true"
                )
        if self.store_sharding == "hosts" and self.data_placement != "device":
            raise ValueError(
                "store_sharding='hosts' only applies to "
                "data_placement='device'"
            )
        if self.tracing_level == "on" and self.telemetry_level == "off":
            raise ValueError(
                "tracing_level='on' requires telemetry_level != 'off'"
            )
        self._validate_serving()
        for knob in ("anomaly_loss_spike_factor", "anomaly_grad_spike_factor",
                     "anomaly_update_ratio_max", "health_grad_norm_limit",
                     "anomaly_warmup_steps", "anomaly_cooldown_steps",
                     "flight_recorder_steps", "max_state_dumps",
                     "watchdog_timeout_s", "profile_start_step",
                     "io_retry_backoff_s", "hbm_budget_gb"):
            if getattr(self, knob) < 0:
                raise ValueError(
                    f"{knob} must be >= 0, got {getattr(self, knob)}"
                )
        if not 0.0 < self.anomaly_ema_beta < 1.0:
            raise ValueError(
                f"anomaly_ema_beta must be in (0, 1), got "
                f"{self.anomaly_ema_beta}"
            )
        if self.io_retry_backoff_factor < 1.0:
            raise ValueError(
                f"io_retry_backoff_factor must be >= 1, got "
                f"{self.io_retry_backoff_factor}"
            )
        if self.ckpt_follower_timeout_s <= 0:
            raise ValueError(
                f"ckpt_follower_timeout_s must be > 0, got "
                f"{self.ckpt_follower_timeout_s}"
            )
        if os.environ.get("DATASET_DIR") and not os.path.isabs(self.dataset_path):
            self.dataset_path = os.path.join(
                os.environ["DATASET_DIR"], self.dataset_path
            )

    def _validate_serving(self) -> None:
        ladder = self.serving_bucket_ladder
        if isinstance(ladder, list):
            self.serving_bucket_ladder = ladder = [
                _int_if_integral(v) for v in ladder
            ]
        if (
            not isinstance(ladder, list)
            or not ladder
            or not all(_is_int(v) and v >= 1 for v in ladder)
            or any(a >= b for a, b in zip(ladder, ladder[1:]))
        ):
            raise ValueError(
                "serving_bucket_ladder must be a non-empty strictly "
                f"increasing list of positive ints, got {ladder!r}"
            )
        if self.serving_max_wait_ms < 0:
            raise ValueError(
                f"serving_max_wait_ms must be >= 0, got "
                f"{self.serving_max_wait_ms}"
            )
        for knob in ("serving_max_tenants_per_dispatch",
                     "serving_adapted_cache_size", "serving_replicas",
                     "serving_router_spill_depth",
                     "serving_gateway_queue_budget",
                     "serving_gateway_priority_tiers"):
            setattr(self, knob, _int_if_integral(getattr(self, knob)))
        cap = self.serving_max_tenants_per_dispatch
        if not (_is_int(cap) and 1 <= cap <= ladder[-1]):
            raise ValueError(
                "serving_max_tenants_per_dispatch must be an int in "
                f"[1, max(serving_bucket_ladder)={ladder[-1]}], got {cap!r}"
            )
        if self.serving_ingest != "f32" and "cifar" in self.dataset_name:
            raise ValueError(
                f"serving_ingest={self.serving_ingest!r} is not supported "
                f"for dataset {self.dataset_name!r}"
            )
        if not (_is_int(self.serving_adapted_cache_size)
                and self.serving_adapted_cache_size >= 0):
            raise ValueError(
                "serving_adapted_cache_size must be an int >= 0, got "
                f"{self.serving_adapted_cache_size!r}"
            )
        for knob in ("serving_replicas", "serving_router_spill_depth",
                     "serving_gateway_queue_budget",
                     "serving_gateway_priority_tiers"):
            v = getattr(self, knob)
            if not (_is_int(v) and v >= 1):
                raise ValueError(f"{knob} must be an int >= 1, got {v!r}")
        for knob in ("serving_rollover_poll_s",
                     "serving_gateway_health_interval_s"):
            if not getattr(self, knob) > 0:
                raise ValueError(
                    f"{knob} must be > 0, got {getattr(self, knob)!r}"
                )
        self.serving_gateway_health_interval_s = float(
            self.serving_gateway_health_interval_s
        )
        if not (isinstance(self.serving_slo_target_ms, (int, float))
                and not isinstance(self.serving_slo_target_ms, bool)
                and self.serving_slo_target_ms >= 0):
            raise ValueError(
                "serving_slo_target_ms must be a number >= 0, got "
                f"{self.serving_slo_target_ms!r}"
            )
        self.serving_slo_target_ms = float(self.serving_slo_target_ms)
        if not (isinstance(self.serving_slo_availability, float)
                and 0.0 < self.serving_slo_availability < 1.0):
            raise ValueError(
                "serving_slo_availability must be a float in (0, 1), got "
                f"{self.serving_slo_availability!r}"
            )
        windows = self.serving_slo_burn_windows_s
        if isinstance(windows, list):
            self.serving_slo_burn_windows_s = windows = [
                float(w) if _is_int(w) else w for w in windows
            ]
        if (
            not isinstance(windows, list)
            or not windows
            or not all(isinstance(w, float) and w > 0 for w in windows)
            or any(a >= b for a, b in zip(windows, windows[1:]))
        ):
            raise ValueError(
                "serving_slo_burn_windows_s must be a non-empty strictly "
                f"increasing list of positive seconds, got {windows!r}"
            )

    # -- derived quantities ------------------------------------------------

    @property
    def im_shape(self) -> Tuple[int, int, int]:
        """(h, w, c) — NHWC."""
        return (self.image_height, self.image_width, self.image_channels)

    @property
    def global_tasks_per_batch(self) -> int:
        """Tasks the loader stacks per global batch: ``num_of_gpus *
        batch_size * samples_per_iter``."""
        return (max(1, self.num_of_gpus) * self.batch_size
                * max(1, self.samples_per_iter))

    @property
    def inner_lr_init(self) -> float:
        """The inner-loop LR used at init: the reference reads
        ``task_learning_rate`` unless ``use_config_init_inner_lr``."""
        if self.use_config_init_inner_lr:
            return self.init_inner_loop_learning_rate
        return self.task_learning_rate

    @property
    def clip_grads(self) -> bool:
        """The outer gradients of the net are clamped to +-10 for imagenet
        datasets (the reference's few_shot_learning_system.py:332-335)."""
        return "imagenet" in self.dataset_name

    @property
    def bn_num_steps(self) -> int:
        """Size of the per-step BN arrays: the max of the train and eval
        step counts (indexing is clamped at apply time)."""
        return max(
            self.number_of_training_steps_per_iter,
            self.number_of_evaluation_steps_per_iter,
        )

    def resolved_bn_stats_impl(self, device) -> str:
        """``bn_stats_impl`` with 'auto' resolved from the port's device:
        'fused' on the CPU (what the JAX package picks on its CPU
        backend), 'twopass' on an accelerator."""
        if self.bn_stats_impl != "auto":
            return self.bn_stats_impl
        kind = device if isinstance(device, str) else device.type
        return "fused" if str(kind).startswith("cpu") else "twopass"

    # -- construction ------------------------------------------------------

    @classmethod
    def known_keys(cls) -> set:
        return {f.name for f in dataclasses.fields(cls)}

    @classmethod
    def from_json_file(cls, path: str, **overrides: Any) -> "MAMLConfig":
        """Load a reference-style experiment JSON, with keyword overrides.
        ``continue_from*`` and ``gpu_to_use`` keys are skipped; unknown keys
        are ignored with a warning."""
        with open(path) as f:
            raw = json.load(f)
        kwargs: Dict[str, Any] = {}
        known = cls.known_keys()
        for key, value in raw.items():
            if "continue_from" in key or "gpu_to_use" in key:
                continue
            if key not in known:
                print(f"[config] ignoring unknown key {key!r} from {path}")
                continue
            kwargs[key] = value
        kwargs.update(overrides)
        return cls(**kwargs)

    def replace(self, **changes: Any) -> "MAMLConfig":
        return dataclasses.replace(self, **changes)
