"""Public kernel API and the launch counters.

Each wrapper takes its kernel's plain PyTorch version for CPU tensors and
launches the hand-written CUDA kernel for CUDA tensors (raising if it
cannot). The counters count CUDA launches only: a run reads them to show
that its path went through the kernels.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels import conv2d as _conv2d
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import int8_matmul as _int8mm
from repro_torch.kernels import quantize as _quant
from repro_torch.kernels import ssd as _ssd

KERNEL_MODULES = {
    "int8_matmul": _int8mm,
    "conv2d_int8": _conv2d,
    "quantize_apply": _quant,
    "flash_attention": _flash,
    "ssd": _ssd,
}

int8_matmul = _int8mm.int8_matmul
conv2d_int8 = _conv2d.conv2d_int8
quantize_apply = _quant.quantize_apply
quantize = _quant.quantize


def flash_attention(q, k, v, *, causal=True, bq=256, bk=256):
    return _flash.flash_attention(q, k, v, causal=causal, bq=bq, bk=bk)


def ssd(x, B_, C_, dt, A, init_state=None, *, chunk: int = 256):
    return _ssd.ssd(x, B_, C_, dt, A, init_state, chunk=chunk)


def launch_counts() -> Dict[str, int]:
    return {name: mod.launches for name, mod in KERNEL_MODULES.items()}


def reset_launch_counts() -> None:
    for mod in KERNEL_MODULES.values():
        mod.launches = 0
