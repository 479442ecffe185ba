"""The card's energy over a window, read from the card itself.

First choice: NVML's cumulative energy counter
(``nvmlDeviceGetTotalEnergyConsumption``, millijoules since the driver
loaded), read at the window's two ends through ``ctypes`` on the driver's
``libnvidia-ml.so.1``, so no package is needed. Where the counter cannot
be read, one ``nvidia-smi --query-gpu=power.draw -lms 100`` process is
sampled across the window and its readings integrated. Where neither
works, :func:`open_source` raises: a run never falls back to a modelled
energy.
"""
from __future__ import annotations

import ctypes
import shutil
import subprocess
import threading
import time
from typing import List, Optional, Tuple


class EnergyUnavailable(RuntimeError):
    pass


class NvmlCounter:
    """NVML's total-energy counter of one card."""

    name = "nvml_total_energy_counter"

    def __init__(self, uuid: Optional[str] = None, index: int = 0):
        try:
            lib = ctypes.CDLL("libnvidia-ml.so.1")
        except OSError as ex:
            raise EnergyUnavailable(f"libnvidia-ml.so.1: {ex}") from ex
        self._lib = lib
        for fn, args in (
                ("nvmlInit_v2", []),
                ("nvmlShutdown", []),
                ("nvmlDeviceGetHandleByIndex_v2",
                 [ctypes.c_uint, ctypes.POINTER(ctypes.c_void_p)]),
                ("nvmlDeviceGetHandleByUUID",
                 [ctypes.c_char_p, ctypes.POINTER(ctypes.c_void_p)]),
                ("nvmlDeviceGetTotalEnergyConsumption",
                 [ctypes.c_void_p, ctypes.POINTER(ctypes.c_ulonglong)]),
                ("nvmlDeviceGetEnforcedPowerLimit",
                 [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint)])):
            f = getattr(lib, fn)
            f.argtypes, f.restype = args, ctypes.c_int
        self._check(lib.nvmlInit_v2(), "nvmlInit_v2")
        self._handle = ctypes.c_void_p()
        rc = -1
        if uuid:
            rc = lib.nvmlDeviceGetHandleByUUID(uuid.encode(),
                                               ctypes.byref(self._handle))
        if rc != 0:
            self._check(lib.nvmlDeviceGetHandleByIndex_v2(
                index, ctypes.byref(self._handle)),
                "nvmlDeviceGetHandleByIndex_v2")
        self.read_mj()          # raises where the counter is not supported

    def _check(self, rc: int, what: str) -> None:
        if rc != 0:
            raise EnergyUnavailable(f"{what} returned NVML error {rc}")

    def read_mj(self) -> int:
        v = ctypes.c_ulonglong()
        self._check(self._lib.nvmlDeviceGetTotalEnergyConsumption(
            self._handle, ctypes.byref(v)),
            "nvmlDeviceGetTotalEnergyConsumption")
        return int(v.value)

    def power_limit_w(self) -> Optional[float]:
        v = ctypes.c_uint()
        if self._lib.nvmlDeviceGetEnforcedPowerLimit(
                self._handle, ctypes.byref(v)) != 0:
            return None
        return v.value / 1000.0

    def begin(self) -> None:
        self._start = self.read_mj()

    def end(self) -> float:
        """Joules since :meth:`begin`."""
        return (self.read_mj() - self._start) / 1000.0

    def close(self) -> None:
        self._lib.nvmlShutdown()


class SmiPowerSampler:
    """One ``nvidia-smi`` process printing the card's power draw every
    100 ms; the window's energy is the trapezoid integral of its
    readings over the window."""

    name = "nvidia_smi_power_draw_100ms"

    def __init__(self, index: int = 0):
        exe = shutil.which("nvidia-smi")
        if exe is None:
            raise EnergyUnavailable("nvidia-smi not found")
        self._proc = subprocess.Popen(
            [exe, "--query-gpu=power.draw", "--format=csv,noheader,nounits",
             "-lms", "100", "-i", str(index)],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        self._samples: List[Tuple[float, float]] = []
        self._lock = threading.Lock()
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()
        deadline = time.monotonic() + 5.0
        while not self._samples and time.monotonic() < deadline:
            time.sleep(0.05)
        if not self._samples:
            self.close()
            raise EnergyUnavailable("nvidia-smi printed no power reading")

    def _read(self) -> None:
        for line in self._proc.stdout:
            try:
                w = float(line.strip())
            except ValueError:
                continue
            with self._lock:
                self._samples.append((time.monotonic(), w))

    def power_limit_w(self) -> Optional[float]:
        return None

    def begin(self) -> None:
        self._t0 = time.monotonic()

    def end(self) -> float:
        t1 = time.monotonic()
        time.sleep(0.25)        # let the reading that spans t1 arrive
        with self._lock:
            pts = list(self._samples)
        return integrate(pts, self._t0, t1)

    def close(self) -> None:
        if self._proc.poll() is None:
            self._proc.terminate()
            try:
                self._proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self._proc.kill()
                self._proc.wait()
        self._reader.join(timeout=5)


def integrate(samples: List[Tuple[float, float]], t0: float, t1: float
              ) -> float:
    """Joules over [t0, t1] from (time, watts) samples: the trapezoid rule,
    each end held at its nearest reading."""
    if not samples:
        raise EnergyUnavailable("no power samples in the window")
    ts = [t for t, _ in samples]
    ws = [w for _, w in samples]

    def at(t):
        if t <= ts[0]:
            return ws[0]
        if t >= ts[-1]:
            return ws[-1]
        i = next(k for k in range(1, len(ts)) if ts[k] >= t)
        f = (t - ts[i - 1]) / max(ts[i] - ts[i - 1], 1e-12)
        return ws[i - 1] + f * (ws[i] - ws[i - 1])

    pts = [(t0, at(t0))] + [(t, w) for t, w in samples if t0 < t < t1] \
        + [(t1, at(t1))]
    return sum(0.5 * (pts[k][1] + pts[k + 1][1]) * (pts[k + 1][0] - pts[k][0])
               for k in range(len(pts) - 1))


def open_source(uuid: Optional[str] = None, index: int = 0):
    """The NVML counter, else the ``nvidia-smi`` sampler; raises
    :class:`EnergyUnavailable` naming both failures."""
    try:
        return NvmlCounter(uuid, index)
    except EnergyUnavailable as first:
        try:
            return SmiPowerSampler(index)
        except EnergyUnavailable as second:
            raise EnergyUnavailable(
                f"no card energy source: {first}; {second}") from second
