"""Import a checkpoint of the original PyTorch repo into the port.

The port's copy of the JAX package's ``tools/import_torch_checkpoint.py``:
it converts the ``torch.save`` payload of the original repo (the system
``state_dict`` plus the experiment-state scalars) into a port
``MetaState`` and writes a checkpoint the port's runner resumes from. The
JAX package's ``tools/export_torch_checkpoint.py`` writes that payload
from a JAX checkpoint, so the two tools move a JAX-trained model to the
port.

Layout conversions (reference NCHW/OIHW -> the port's NHWC/HWIO, the JAX
package's layouts):

* conv weights ``(out, in, kh, kw)`` -> ``(kh, kw, in, out)``;
* the linear head ``(way, c*h*w)`` -> ``(h*w*c, way)``: the reference
  flattens channel-major feature maps, the port row-major;
* layer-norm affine parameters ``(c, h, w)`` -> ``(h, w, c)``;
* per-step BN parameters and statistics unchanged, padded to
  ``bn_num_steps`` by repeating the last step;
* LSLR keys ``layer_dict-conv0-conv-weight`` -> ``conv0.conv.weight``.

The Adam moments restart (a fresh Adam state): torch's optimizer state
does not carry over, as the export tool's docstring says. The
experiment-state scalars (current_iter, best_val_acc, ...) carry over, so
the resume arithmetic holds.

    python -m howtotrainyourmamlpytorch_tpu_torch.tools.import_torch_checkpoint \\
        --config experiment_config/<config>.json \\
        --torch_checkpoint <file torch.save wrote> \\
        --output_dir <experiment>/saved_models --model_idx latest
"""

from __future__ import annotations

import argparse
import pickle
import sys
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..config import MAMLConfig
from ..device import DeviceLike, resolve_device
from ..models import vgg
from ..state import MetaState, init_state

_NET_PREFIXES = ("classifier.layer_dict.", "layer_dict.")
_LSLR_PREFIXES = (
    "inner_loop_optimizer.names_learning_rates_dict.",
    "names_learning_rates_dict.",
)


def _strip_prefix(key: str, prefixes) -> str:
    for p in prefixes:
        if key.startswith(p):
            return key[len(p):]
    return ""


def convert_network_state(
    cfg: MAMLConfig, state_dict: Dict[str, np.ndarray]
) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """Map the reference system/classifier ``state_dict`` (as numpy arrays)
    to (net params, bn state, lslr params) in the port's naming and layout.
    """
    params: Dict[str, np.ndarray] = {}
    bn_state: Dict[str, np.ndarray] = {}
    lslr: Dict[str, np.ndarray] = {}
    fh, fw = vgg._feature_hw(cfg)

    for key, value in state_dict.items():
        v = np.asarray(value, np.float32)
        net_key = _strip_prefix(key, _NET_PREFIXES)
        lslr_key = _strip_prefix(key, _LSLR_PREFIXES)
        if lslr_key:
            # layer_dict-conv0-conv-weight -> conv0.conv.weight
            # (inner_loop_optimizers.py:89 replaces '.' with '-')
            name = lslr_key.replace("-", ".")
            if name.startswith("layer_dict."):
                name = name[len("layer_dict."):]
            if name == "linear.weights":  # reference's plural quirk
                name = "linear.weight"
            # inner-adaptable norm params (enable_inner_loop_optimizable_bn_
            # params=True): norm_layer.weight/bias -> norm.gamma/beta
            name = name.replace(".norm_layer.weight", ".norm.gamma")
            name = name.replace(".norm_layer.bias", ".norm.beta")
            lslr[name] = v
            continue
        if not net_key:
            continue
        if net_key.endswith(".conv.weight"):
            # OIHW -> HWIO
            params[net_key] = np.transpose(v, (2, 3, 1, 0))
        elif net_key.endswith(".conv.bias"):
            params[net_key] = v
        elif ".norm_layer." in net_key:
            stage, leaf = net_key.split(".norm_layer.")
            if cfg.norm_layer == "layer_norm" and v.ndim == 3:
                v = np.transpose(v, (1, 2, 0))  # (c,h,w) -> (h,w,c)
            if leaf == "weight":
                params[f"{stage}.norm.gamma"] = v
            elif leaf == "bias":
                params[f"{stage}.norm.beta"] = v
            elif leaf == "running_mean":
                if cfg.per_step_bn_statistics:
                    bn_state[f"{stage}.norm.mean"] = v
            elif leaf == "running_var":
                if cfg.per_step_bn_statistics:
                    bn_state[f"{stage}.norm.var"] = v
        elif net_key == "linear.weights":
            way = v.shape[0]
            if cfg.max_pooling and fh * fw > 1:
                # (way, c*h*w) channel-major -> (h*w*c, way) row-major NHWC
                v = v.reshape(way, cfg.cnn_num_filters, fh, fw)
                v = np.transpose(v, (2, 3, 1, 0)).reshape(fh * fw * cfg.cnn_num_filters, way)
            else:
                v = v.T
            params["linear.weight"] = v
        elif net_key == "linear.bias":
            params["linear.bias"] = v

    # this framework sizes per-step BN arrays by max(train, eval) steps
    # (config.bn_num_steps, the SURVEY §7 out-of-bounds fix); reference
    # checkpoints size them by the training step count — pad by repeating
    # the final step's values (what step-clamping would have used)
    def _pad_steps(v: np.ndarray) -> np.ndarray:
        if v.ndim == 2 and v.shape[0] < cfg.bn_num_steps:
            pad = np.repeat(v[-1:], cfg.bn_num_steps - v.shape[0], axis=0)
            return np.concatenate([v, pad], axis=0)
        return v

    if cfg.per_step_bn_statistics:
        for key in list(params):
            if ".norm." in key:
                params[key] = _pad_steps(params[key])
        for key in list(bn_state):
            bn_state[key] = _pad_steps(bn_state[key])
    return params, bn_state, lslr


def import_torch_checkpoint(cfg: MAMLConfig, torch_ckpt_path: str,
                            device: DeviceLike = None):
    """A reference checkpoint file as a port ``MetaState`` on ``device``
    (``cuda:0`` unless named) with a fresh Adam state, and the carried
    experiment-state scalars."""
    device = resolve_device(device)
    try:
        # tensors only: no code in the file runs
        payload = torch.load(torch_ckpt_path, map_location="cpu",
                             weights_only=True)
    except (pickle.UnpicklingError, RuntimeError, TypeError):
        # the reference stores the experiment-state scalars beside the
        # tensors, which may need the full unpickler: only for files the
        # user chose to import, and said so
        print(f"import_torch_checkpoint: weights_only load failed for "
              f"{torch_ckpt_path!r}; falling back to the UNSAFE full "
              f"unpickler (only do this for files you trust)",
              file=sys.stderr)
        payload = torch.load(torch_ckpt_path, map_location="cpu",
                             weights_only=False)
    network = payload["network"] if "network" in payload else payload
    state_dict = {k: v.detach().cpu().numpy() for k, v in network.items()}
    params, bn_state, lslr = convert_network_state(cfg, state_dict)
    ref_state = init_state(cfg, device=device, with_opt=True)
    _check_tree("net", ref_state.net, params)
    _check_tree("bn", ref_state.bn, bn_state)
    _check_tree("lslr", ref_state.lslr, lslr)

    def to(leaves):
        return {k: torch.from_numpy(np.array(v, copy=True)).to(device)
                for k, v in leaves.items()}

    state = MetaState(net=to(params), lslr=to(lslr), bn=to(bn_state),
                      opt=ref_state.opt)
    experiment_state = {
        k: v for k, v in payload.items()
        if k not in ("network", "optimizer")
        and isinstance(v, (int, float, str, bool, list, dict))
    }
    return state, experiment_state


def _check_tree(name: str, expected: Dict[str, Any], got: Dict[str, Any]):
    missing = set(expected) - set(got)
    extra = set(got) - set(expected)
    if missing or extra:
        raise ValueError(
            f"{name} keys mismatch: missing {sorted(missing)}, "
            f"unexpected {sorted(extra)} — does the --config match the "
            f"checkpoint's architecture?"
        )
    for k in expected:
        if tuple(expected[k].shape) != tuple(np.shape(got[k])):
            raise ValueError(
                f"{name}[{k}]: shape {np.shape(got[k])} != expected "
                f"{tuple(expected[k].shape)}"
            )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", required=True, help="experiment config JSON")
    ap.add_argument("--torch_checkpoint", required=True)
    ap.add_argument("--output_dir", required=True,
                    help="saved_models dir to write into")
    ap.add_argument("--model_idx", default="latest",
                    help="checkpoint index to write (epoch int or 'latest')")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda:0)")
    args = ap.parse_args(argv)

    from ..experiment import checkpoint as ckpt

    cfg = MAMLConfig.from_json_file(args.config)
    state, experiment_state = import_torch_checkpoint(
        cfg, args.torch_checkpoint, args.device)
    idx = args.model_idx if args.model_idx == "latest" else int(args.model_idx)
    path = ckpt.save_checkpoint(args.output_dir, "train_model", idx, state,
                                experiment_state)
    print(f"imported {args.torch_checkpoint} -> {path}")


if __name__ == "__main__":
    main()
