"""Mamba2 (SSD — state-space duality) sequence mixer (src/repro/nn/ssm.py).

Train/prefill use the chunked SSD algorithm (arXiv:2405.21060): intra-chunk
terms are dense matmuls, inter-chunk terms carry the chunk states. On a
card tensor the scan is the CUDA kernel ``repro_torch.kernels.ssd``; on a
CPU one its plain version, which is :func:`ssd_chunked` (the reference
chooses alike: its Pallas kernel on the TPU, ``ssd_chunked`` elsewhere).
Neither kernel has a gradient, so the SSM families train on the CPU only,
as the reference's train only off the TPU. Decode is the O(1)-state
recurrence.

Per head h (H heads, head_dim P, state N):
    state_t = exp(dt_t * A_h) * state_{t-1} + dt_t * B_t (x) x_t
    y_t     = C_t . state_t + D_h * x_t
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ssd as ssd_kernel
from repro_torch.nn.dims import Dims
from repro_torch.nn.layers import dot_f32
from repro_torch.nn.params import ParamSpec, build_params, tree_map

# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def ssm_spec(cfg: ArchConfig, dims: Dims) -> dict:
    s = cfg.ssm
    d, di, h, n = dims.d_model, dims.d_inner, dims.ssm_heads, s.state_dim
    w = s.conv_width
    return {
        "w_z": ParamSpec((d, di), ("fsdp", "ffn")),
        "w_x": ParamSpec((d, di), ("fsdp", "ffn")),
        "w_B": ParamSpec((d, n), ("fsdp", None)),
        "w_C": ParamSpec((d, n), ("fsdp", None)),
        "w_dt": ParamSpec((d, h), ("fsdp", "ssm_heads")),
        "conv_x": ParamSpec((w, di), (None, "ffn"), scale=0.5),
        "conv_B": ParamSpec((w, n), (None, None), scale=0.5),
        "conv_C": ParamSpec((w, n), (None, None), scale=0.5),
        "A_log": ParamSpec((h,), ("ssm_heads",), init="zeros", dtype=torch.float32),
        "dt_bias": ParamSpec((h,), ("ssm_heads",), init="zeros", dtype=torch.float32),
        "D": ParamSpec((h,), ("ssm_heads",), init="ones", dtype=torch.float32),
        "gate_norm": ParamSpec((di,), ("ffn",), init="ones"),
        "w_out": ParamSpec((di, d), ("ffn", "fsdp")),
    }


def ssm_cache_spec(batch: int, cfg: ArchConfig, dims: Dims,
                   dtype=torch.bfloat16) -> dict:
    s = cfg.ssm
    return {
        # last (conv_width - 1) pre-activation inputs of x / B / C streams
        "conv_x": ParamSpec((batch, s.conv_width - 1, dims.d_inner),
                            ("batch", None, "ffn"), dtype=dtype),
        "conv_B": ParamSpec((batch, s.conv_width - 1, s.state_dim),
                            ("batch", None, None), dtype=dtype),
        "conv_C": ParamSpec((batch, s.conv_width - 1, s.state_dim),
                            ("batch", None, None), dtype=dtype),
        "state": ParamSpec((batch, dims.ssm_heads, s.head_dim, s.state_dim),
                           ("batch", "ssm_heads", None, None), dtype=torch.float32),
    }


def init_ssm_cache(batch: int, cfg: ArchConfig, dims: Dims,
                   dtype=torch.bfloat16, device=None):
    spec = tree_map(lambda p: ParamSpec(p.shape, p.logical, init="zeros",
                                        dtype=p.dtype),
                    ssm_cache_spec(batch, cfg, dims, dtype))
    return build_params(spec, torch.Generator(), device)


# ---------------------------------------------------------------------------
# Shared pieces
# ---------------------------------------------------------------------------


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: x [B, S, C], w [W, C] -> [B, S, C] fp32. The
    reference widens the result to fp32 at once, so its last sum is fp32
    (the earlier sums and the products round to ``x``'s dtype)."""
    width = w.shape[0]
    pad = F.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros_like(x)
    for i in range(width - 1):  # width is 4: unrolled shifts beat a gather
        out = out + pad[:, i: i + x.shape[1], :] * w[i]
    last = pad[:, width - 1:, :] * w[width - 1]
    return out.float() + last.float()


def _conv_step(cache: torch.Tensor, x_t: torch.Tensor, w: torch.Tensor):
    """One-token causal conv. cache [B, W-1, C], x_t [B, C]."""
    win = torch.cat([cache, x_t[:, None, :]], dim=1)           # [B, W, C]
    y = torch.einsum("bwc,wc->bc", win, w)
    return y, win[:, 1:, :]


def _dt_activation(dt_raw: torch.Tensor, dt_bias: torch.Tensor) -> torch.Tensor:
    return F.softplus(dt_raw.float() + dt_bias)


# ---------------------------------------------------------------------------
# Chunked SSD forward (train / prefill)
# ---------------------------------------------------------------------------


def ssd_chunked(
    x: torch.Tensor,        # [B, S, H, P]   (any float dtype)
    B_: torch.Tensor,       # [B, S, N]
    C_: torch.Tensor,       # [B, S, N]
    dt: torch.Tensor,       # [B, S, H]      (already softplus'd, fp32)
    A: torch.Tensor,        # [H]            (negative, fp32)
    chunk: int,
    init_state: Optional[torch.Tensor] = None,   # [B, H, P, N]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y [B, S, H, P], final_state [B, H, P, N]): the reference's
    function under its name, which is the kernel's plain version
    (``kernels/ssd.py: ssd_plain``; same chunking, same fallback chunk)."""
    return ssd_kernel.ssd_plain(x, B_, C_, dt, A, init_state, chunk)


# ---------------------------------------------------------------------------
# Layer forward
# ---------------------------------------------------------------------------


def ssm_mixer(
    params: dict,
    x: torch.Tensor,            # [B, S, D]
    cfg: ArchConfig,
    dims: Dims,
    return_cache: bool = False,
):
    """Full-sequence Mamba2 block core (no residual/norm — block adds those)."""
    s_cfg = cfg.ssm
    b, s, _ = x.shape
    h, p = dims.ssm_heads, s_cfg.head_dim

    z = x @ params["w_z"]
    xs = x @ params["w_x"]
    Bs = x @ params["w_B"]
    Cs = x @ params["w_C"]
    dt_raw = x @ params["w_dt"]

    xs_pre, Bs_pre, Cs_pre = xs, Bs, Cs       # pre-conv streams (cache tail)
    xs = F.silu(_causal_conv(xs, params["conv_x"]))
    Bs = F.silu(_causal_conv(Bs, params["conv_B"]))
    Cs = F.silu(_causal_conv(Cs, params["conv_C"]))

    dt = _dt_activation(dt_raw, params["dt_bias"])
    A = -torch.exp(params["A_log"])

    xh = xs.reshape(b, s, h, p)
    # the CUDA kernel on a card tensor, ssd_chunked on a CPU one, as the
    # reference takes its Pallas kernel on the TPU only; the kernel has no
    # gradient (it refuses one), so on the card this trains nothing
    scan = ssd_kernel.ssd if xh.is_cuda else ssd_chunked
    y, final_state = scan(xh, Bs, Cs, dt, A, chunk=min(s_cfg.chunk_size, s))
    y = y + params["D"][None, None, :, None] * xh
    y = y.reshape(b, s, dims.d_inner).to(x.dtype)

    # gated RMSNorm (mamba2's norm-before-out-proj)
    yf = y.float()
    var = yf.square().mean(-1, keepdim=True)
    y = (yf * torch.rsqrt(var + cfg.norm_eps)).to(x.dtype)
    y = y * params["gate_norm"] * F.silu(z.float()).to(x.dtype)

    out = y @ params["w_out"]
    if not return_cache:
        return out
    w = s_cfg.conv_width
    cache = {
        "conv_x": xs_pre[:, s - (w - 1):, :],
        "conv_B": Bs_pre[:, s - (w - 1):, :],
        "conv_C": Cs_pre[:, s - (w - 1):, :],
        "state": final_state,
    }
    return out, cache


def ssm_decode_step(
    params: dict,
    x: torch.Tensor,            # [B, 1, D]
    cache: dict,
    cfg: ArchConfig,
    dims: Dims,
):
    """O(1) recurrent step; returns (y [B,1,D], new cache)."""
    s_cfg = cfg.ssm
    b = x.shape[0]
    h, p = dims.ssm_heads, s_cfg.head_dim
    xt = x[:, 0, :]

    # z and dt_raw are widened to fp32 at once: dot_f32, see nn/layers.py
    z = dot_f32(xt, params["w_z"])
    xs = xt @ params["w_x"]
    Bs = xt @ params["w_B"]
    Cs = xt @ params["w_C"]
    dt_raw = dot_f32(xt, params["w_dt"])

    xs, conv_x = _conv_step(cache["conv_x"], xs, params["conv_x"])
    Bs, conv_B = _conv_step(cache["conv_B"], Bs, params["conv_B"])
    Cs, conv_C = _conv_step(cache["conv_C"], Cs, params["conv_C"])
    xs = F.silu(xs.float())
    Bs = F.silu(Bs.float())
    Cs = F.silu(Cs.float())

    dt = _dt_activation(dt_raw, params["dt_bias"])              # [B, H]
    A = -torch.exp(params["A_log"])
    decay = torch.exp(dt * A)                                   # [B, H]

    xh = xs.reshape(b, h, p)
    state = cache["state"] * decay[:, :, None, None] + torch.einsum(
        "bh,bn,bhp->bhpn", dt, Bs, xh)
    y = torch.einsum("bn,bhpn->bhp", Cs, state) + params["D"][None, :, None] * xh
    y = y.reshape(b, dims.d_inner)

    var = y.square().mean(-1, keepdim=True)
    y = y * torch.rsqrt(var + cfg.norm_eps)
    y = y * params["gate_norm"].float()
    y = y * F.silu(z.float())
    y = y.to(x.dtype)

    out = (y @ params["w_out"])[:, None, :]
    new_cache = {"conv_x": conv_x, "conv_B": conv_B, "conv_C": conv_C,
                 "state": state}
    return out, new_cache
