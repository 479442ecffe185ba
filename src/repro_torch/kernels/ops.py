"""Public kernel API and the launch counters.

Each wrapper takes its kernel's plain PyTorch version for CPU tensors and
launches the hand-written CUDA kernel for CUDA tensors (raising if it
cannot). The counters count CUDA launches only: a run reads them to show
that its path went through the kernels. ``conv2d_int8`` and
``conv2d_int8_cout_blocks`` count the int8 conv's two grids apart (the
whole-Cout grid and the autotuner's channel-blocked one); ``conv2d`` is
the fp32 conv; a whole-Cout call whose filter does not fit one block runs
the channel-blocked grid and still counts as ``conv2d_int8``.
``sample_normal`` is the VAE's sampler, which replaces XLA's RNG rather
than a Pallas kernel. ``int8_matmul`` counts both of its kernels;
:func:`route_counts` says which of them served (``kernels/int8_matmul.py``).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels import conv2d as _conv2d
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import int8_matmul as _int8mm
from repro_torch.kernels import quantize as _quant
from repro_torch.kernels import sample as _sample
from repro_torch.kernels import ssd as _ssd

# counter name -> (module, attribute holding its count)
COUNTERS = {
    "int8_matmul": (_int8mm, "launches"),
    "conv2d_int8": (_conv2d, "launches"),
    "conv2d_int8_cout_blocks": (_conv2d, "launches_cout_blocks"),
    "conv2d": (_conv2d, "launches_f32"),
    "quantize_apply": (_quant, "launches"),
    "flash_attention": (_flash, "launches"),
    "ssd": (_ssd, "launches"),
    "sample_normal": (_sample, "launches"),
}

int8_matmul = _int8mm.int8_matmul
conv2d_int8 = _conv2d.conv2d_int8
conv2d = _conv2d.conv2d
conv2d_plain = _conv2d.conv2d_plain
quantize_apply = _quant.quantize_apply
quantize = _quant.quantize
sample_normal = _sample.sample_normal


def flash_attention(q, k, v, *, causal=True, bq=256, bk=256):
    return _flash.flash_attention(q, k, v, causal=causal, bq=bq, bk=bk)


def ssd(x, B_, C_, dt, A, init_state=None, *, chunk: int = 256):
    return _ssd.ssd(x, B_, C_, dt, A, init_state, chunk=chunk)


def launch_counts() -> Dict[str, int]:
    return {name: getattr(mod, attr)
            for name, (mod, attr) in COUNTERS.items()}


def route_counts() -> Dict[str, int]:
    """``int8_matmul``'s launches by kernel: ``tile`` and ``splitk``."""
    return {"tile": _int8mm.launches_tile,
            "splitk": _int8mm.launches_splitk}


def reset_launch_counts() -> None:
    for mod, attr in COUNTERS.values():
        setattr(mod, attr, 0)
    _int8mm.launches_tile = _int8mm.launches_splitk = 0
