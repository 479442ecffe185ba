"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface and loaded with ``ctypes``: a library is
built at first use into ``build/`` at the repository root, named by a hash
of its sources and flags, so a checkout builds everything it runs from its
own files and a rebuild happens only when a source changes. ``build_all``
starts one ``nvcc`` per source at once.

``-fmad=false`` keeps nvcc from contracting a multiply and an add into an
FMA on its own: the kernels spell out every rounding step with intrinsics
(``csrc/common.cuh``). Fast math is never used.

Wrappers call :func:`on_cpu` to choose the path: a CPU tensor takes the
kernel's plain PyTorch version, a CUDA tensor launches the kernel or
raises; nothing falls back from one to the other.

No kernel here has a backward, and a wrapper's output, written through
``ctypes``, carries no ``grad_fn``: under autograd the gradient through
the kernel would vanish without a word. Each wrapper therefore calls
:func:`refuse_grad` first and raises instead, as ``jax.grad`` through the
reference's ``pallas_call`` fails (none of its Pallas kernels has a
``custom_vjp``).
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
SOURCES = {
    "quantize_apply": "quantize.cu",
    "int8_matmul": "int8_matmul.cu",
    "int8_matmul_tile": "int8_matmul_tile.cu",
    "conv2d_int8": "conv2d_int8.cu",
    "conv2d_f32": "conv2d_f32.cu",
    "flash_attention": "flash_attention.cu",
    "ssd": "ssd.cu",
    "sample_normal": "sample_normal.cu",
}
HEADERS = ("common.cuh", "igemm.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-fmad=false", "-Xptxas", "-v")


@dataclasses.dataclass
class Built:
    name: str
    path: Path
    seconds: float          # 0.0 when the library was already built
    ptxas: str              # nvcc's -Xptxas -v report


_LIBS: Dict[str, ctypes.CDLL] = {}
_BUILT: Dict[str, Built] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (SOURCES[name],) + HEADERS:
        h.update((CSRC / f).read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, Built]:
    """Build the named kernels' libraries (all by default), one ``nvcc``
    process per source, all started together. Raises with nvcc's output
    if any build fails."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        if name in _BUILT:
            continue
        target = _target(name)
        log = target.with_suffix(".log")
        if target.exists():
            _BUILT[name] = Built(name, target, 0.0,
                                 log.read_text() if log.exists() else "")
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target, time.perf_counter())
    failed = []
    for name, (proc, tmp, target, t0) in procs.items():
        out, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
            continue
        os.replace(tmp, target)
        target.with_suffix(".log").write_text(out)
        _BUILT[name] = Built(name, target, seconds, out)
    if failed:
        raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    return {n: _BUILT[n] for n in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (built on first use)."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all([name])[name].path))
        lib.error_string.restype = ctypes.c_char_p
        lib.error_string.argtypes = [ctypes.c_int]
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if rc != 0:
        msg = lib.error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def on_cpu(*tensors: Optional[torch.Tensor]) -> bool:
    """True when the operands lie on the CPU (take the plain version),
    False when they lie on one CUDA device (launch the kernel). Mixed or
    other devices raise."""
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"operands must share one device, got {devices}")
    dev = devices.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return False


def refuse_grad(what: str, *tensors: Optional[torch.Tensor],
                cpu_too: bool = False) -> None:
    """Raise if autograd is on and a floating operand ``requires_grad``:
    the kernel would return a result with no gradient. Card operands
    only, unless ``cpu_too`` (the wrappers whose reference kernel sits on
    the reference's CPU path too: ``ssd`` and ``flash_attention``)."""
    if not torch.is_grad_enabled():
        return
    for t in tensors:
        if (t is not None and t.requires_grad and t.is_floating_point()
                and (cpu_too or t.device.type == "cuda")):
            raise RuntimeError(
                f"{what}: the kernel has no gradient, as the reference's "
                f"Pallas kernel has none (jax.grad through its pallas_call "
                f"fails); train through attn_impl='chunked' and "
                f"ssd_chunked, or call it under torch.no_grad()")


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
