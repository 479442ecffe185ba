"""Device selection for the port's entry points.

Entry points run on the card unless the caller passes ``device="cpu"``;
with no card and no such request they raise — they never drop to the CPU
on their own. On a CUDA device the port turns TF32 off for cuBLAS and
cuDNN (cuDNN runs fp32 convolutions in TF32 by default), so the fp32
flex path and the calibration trace compute in full float32, and turns
off cuBLAS's reduced-precision reductions in bf16 GEMMs, so a bf16
product sums in fp32 and rounds once, as on the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain "
                "PyTorch versions of the kernels on the CPU")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
