"""Device resolution for the port's entry points.

Entry points run on ``cuda:0`` unless the caller names a device. With no
CUDA device present and none named, they raise: a run meant for the card
never carries on silently on the CPU. The CPU is chosen only by asking for
it (``device="cpu"``, ``--device cpu``), as the tests do.

Resolving a CUDA device also turns TF32 off for matrix products and cuDNN
convolutions: the JAX package multiplies f32 in true f32 because
second-order MAML++ stalls when f32 products lose mantissa bits
(RESULTS.md, the matmul-precision finding). It also turns off cuBLAS's
reduced-precision reductions of bf16 products, which may round partial
sums to bf16 where XLA accumulates a bf16 product in f32 and rounds once
(the bf16 head, ``compute_dtype='bfloat16'``).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: the named one, else ``cuda:0``.

    Raises ``RuntimeError`` naming ``--device cpu`` when no device was
    named and CUDA is absent, or when a CUDA device was named and CUDA is
    absent.
    """
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"no CUDA device is available for {dev}; this entry point "
                "runs on the card unless asked otherwise — pass "
                "--device cpu (device='cpu') to run the plain PyTorch "
                "versions on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = (
            False)
    return dev


def device_name(device: torch.device) -> str:
    """The card's name for a CUDA device, ``'cpu'`` otherwise."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def peak_rates(name: str, bf16_tensor_cores: bool = False
               ) -> Tuple[float, float]:
    """(FLOP/s, memory bytes/s) of an H100 by its name, from NVIDIA's data
    sheets: f32 outside the tensor cores — the PCIe part at 51.2 TFLOP/s
    and 2.0 TB/s, the NVL at 60 TFLOP/s and 3.9 TB/s, the SXM part
    (default) at 67 TFLOP/s and 3.35 TB/s; with ``bf16_tensor_cores`` the
    dense bf16 tensor-core rate instead (756, 835 and 989 TFLOP/s), the
    peak for a bf16 product whatever units its kernel multiplies on (the
    bound of the bf16 convs)."""
    if "PCIe" in name:
        flops, bw = (756e12 if bf16_tensor_cores else 51.2e12), 2.0e12
    elif "NVL" in name:
        flops, bw = (835e12 if bf16_tensor_cores else 60e12), 3.9e12
    else:
        flops, bw = (989e12 if bf16_tensor_cores else 67e12), 3.35e12
    return flops, bw


def synchronize(device: Optional[torch.device]) -> None:
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)
