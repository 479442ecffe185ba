"""What the plain references share: NHWC and NDHWC helpers, post-training
quantization written out from its definition, and the served key chain.

Quantization, as the configurations state it: per-output-channel
symmetric weight codes at ``max|w| / qmax``, per-tensor activation codes
at ``absmax / qmax`` of the calibration frames' fp32 values, sums of the
integer codes formed exactly in float64, then ``acc * (s_x * s_w) + b``.
A layer whose fake-quantized output strays from its fp32 output by more
than the demotion threshold (of the output's absmax, on a calibration
frame) runs in fp32. ``bits=8`` is the configuration; ``bits=4`` is the
control, the next precision below.

Nothing here imports the program: the threefry below is written from the
Threefry-2x32 definition (20 rounds) and ``jax.random``'s documented
key split and normal draw.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

QMAX = {8: 127, 4: 7}


def same_pads(h: int, w: int, k: int, stride: int):
    """``F.pad`` widths (W first) of SAME padding, the odd row and column
    at the end."""
    pads = []
    for size in (w, h):
        out = -(-size // stride)
        total = max((out - 1) * stride + k - size, 0)
        pads += [total // 2, total - total // 2]
    return pads


def conv(x: torch.Tensor, w_hwio: torch.Tensor, stride: int) -> torch.Tensor:
    """SAME convolution of NHWC ``x`` with HWIO weights, no bias; NHWC
    out."""
    k = w_hwio.shape[0]
    x = F.pad(x, [0, 0] + same_pads(x.shape[1], x.shape[2], k, stride))
    y = F.conv2d(x.permute(0, 3, 1, 2), w_hwio.permute(3, 2, 0, 1),
                 stride=stride)
    return y.permute(0, 2, 3, 1)


def conv3d(x: torch.Tensor, w_dhwio: torch.Tensor, stride: int
           ) -> torch.Tensor:
    """SAME convolution of NDHWC ``x`` with DHWIO weights, no bias; NDHWC
    out, the odd plane, row and column of padding at the end."""
    pads = []
    for size, k in zip(reversed(x.shape[1:4]), reversed(w_dhwio.shape[:3])):
        out = -(-size // stride)
        total = max((out - 1) * stride + k - size, 0)
        pads += [total // 2, total - total // 2]
    y = F.conv3d(F.pad(x, [0, 0] + pads).permute(0, 4, 1, 2, 3),
                 w_dhwio.permute(4, 3, 0, 1, 2), stride=stride)
    return y.permute(0, 2, 3, 4, 1)


def maxpool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 max-pool, stride 2, of NHWC ``x``."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


def _apply(w: torch.Tensor, x: torch.Tensor, stride: int) -> torch.Tensor:
    """The layer's linear part: a conv for 4-D (HWIO) weights, a 3-D conv
    for 5-D (DHWIO) weights, else x @ w."""
    if w.ndim == 4:
        return conv(x, w, stride)
    if w.ndim == 5:
        return conv3d(x, w, stride)
    return x @ w


def weight_codes(w: torch.Tensor, bits: int):
    """Per-output-channel codes and scales of ``w`` (last axis out)."""
    q = QMAX[bits]
    w2 = w.float().reshape(-1, w.shape[-1])
    scale = w2.abs().amax(dim=0) / q + 1e-12
    codes = torch.clamp(torch.round(w2 / scale), -q, q)
    return codes.reshape(w.shape), scale


def act_codes(x: torch.Tensor, s: float, bits: int) -> torch.Tensor:
    q = QMAX[bits]
    return torch.clamp(torch.round(x.double() / s), -q, q)


class Quantized:
    """The calibrated state of one network: activation scales, weight
    codes and the set of layers the demotion gate keeps in fp32."""

    def __init__(self, params, bits: int = 8, demote_threshold: float = 0.2):
        self.params = params
        self.bits = bits
        self.threshold = demote_threshold
        self.absmax: Dict[str, float] = {}
        self.ratio: Dict[str, float] = {}
        self.demoted: set = set()
        self.codes = {n: weight_codes(p["w"], bits) for n, p in params.items()}
        self.seen: Dict[str, list] = {}

    def scale(self, name: str) -> float:
        return self.absmax[name] / QMAX[self.bits] + 1e-12

    def recording(self, name: str, x: torch.Tensor, stride: int = 1
                  ) -> torch.Tensor:
        """The fp32 layer, keeping its input and output for the gate."""
        p = self.params[name]
        x = x.float()
        y = _apply(p["w"].float(), x, stride) + p["b"].float()
        self.seen.setdefault(name, []).append((x, y, stride))
        self.absmax[name] = max(self.absmax.get(name, 0.0),
                                float(x.abs().max()))
        return y

    def gate(self) -> None:
        """Each layer's worst fake-quant error over the calibration frames,
        as a share of its fp32 output's absmax; above the threshold the
        layer stays fp32."""
        q = QMAX[self.bits]
        for name, seen in self.seen.items():
            s = self.scale(name)
            codes, wscale = self.codes[name]
            w_hat = (codes.reshape(-1, codes.shape[-1]) * wscale
                     ).reshape(codes.shape)
            worst = 0.0
            for x, y, stride in seen:
                x_hat = torch.clamp(torch.round(x / s), -q, q) * s
                out_q = _apply(w_hat, x_hat, stride) + self.params[name]["b"]
                err = float((out_q - y).abs().max())
                worst = max(worst, err / (float(y.abs().max()) + 1e-12))
            self.ratio[name] = worst
            if worst > self.threshold:
                self.demoted.add(name)
        self.seen = {}

    def serving(self, name: str, x: torch.Tensor, stride: int = 1
                ) -> torch.Tensor:
        """The served layer: integer codes summed exactly in float64,
        dequantized and biased in float64, handed on as float32."""
        p = self.params[name]
        if name in self.demoted:
            return _apply(p["w"].float(), x.float(), stride) + p["b"].float()
        s = self.scale(name)
        codes, wscale = self.codes[name]
        acc = _apply(codes.double(), act_codes(x, s, self.bits), stride)
        return (acc * (s * wscale.double()) + p["b"].double()).float()


def calibrate(forward: Callable, params, calib: Dict[str, torch.Tensor],
              bits: int = 8, demote_threshold: float = 0.2,
              demoted: Optional[set] = None) -> Quantized:
    """Run each calibration frame through the fp32 network, then the
    demotion gate. ``demoted`` fixes the fp32 set instead of the gate
    (the control keeps the int8 run's)."""
    qs = Quantized(params, bits, demote_threshold)
    n = next(iter(calib.values())).shape[0]
    with torch.no_grad():
        for i in range(n):
            forward(params, {k: v[i:i + 1] for k, v in calib.items()},
                    qs.recording, None)
        qs.gate()
    if demoted is not None:
        qs.demoted = set(demoted)
    return qs


# ---------------------------------------------------------------------------
# Keys: Threefry-2x32, jax.random's split and normal, the served chain
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds, on uint64 numpy arrays holding uint32."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) & _M32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def split(key, num: int) -> np.ndarray:
    """``jax.random.split`` of one raw key [2] into [num, 2]."""
    k = np.asarray(key, np.uint64)
    j = np.arange(num, dtype=np.uint64)
    y0, y1 = threefry2x32(k[0], k[1], np.zeros_like(j), j)
    return np.stack([y0, y1], axis=-1)


def normal(key, n: int) -> np.ndarray:
    """``jax.random.normal(key, (n,))`` computed in float64 from the exact
    bits: u in (-1, 1) as float32, then sqrt(2) erfinv(u)."""
    k = np.asarray(key, np.uint64)
    i = np.arange(n, dtype=np.uint64)
    y0, y1 = threefry2x32(k[0], k[1], np.zeros_like(i), i)
    bits = (y0 ^ y1).astype(np.uint32)
    f = ((bits >> 9) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = np.maximum(f * np.float32(2.0) + lo, lo).astype(np.float32)
    return math.sqrt(2.0) * torch.special.erfinv(
        torch.from_numpy(u.astype(np.float64))).numpy()


class ServedKeys:
    """The per-request keys of a served model: the model's chain starts at
    the raw key ``[0, u32(name[:4])]``; dispatch ``j`` takes the second
    half of the chain's ``j``-th split, splits it into ``rung + 1`` keys
    and gives row ``i`` key ``i + 1``; a random layer splits a row's key
    and draws from the second half."""

    def __init__(self, model: str):
        word = np.frombuffer(model.encode()[:4].ljust(4, b"\0"), np.uint32)
        self._state = np.array([0, word[0]], np.uint64)
        self._subs = []

    def dispatch_key(self, j: int) -> np.ndarray:
        while len(self._subs) <= j:
            both = split(self._state, 2)
            self._state, sub = both[0], both[1]
            self._subs.append(sub)
        return self._subs[j]

    def layer_key(self, j: int, rung: int, row: int) -> np.ndarray:
        row_key = split(self.dispatch_key(j), rung + 1)[row + 1]
        return split(row_key, 2)[1]
