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
from repro_torch.parallel.sharding import (current_mesh, current_rules,
                                           shard_map, sp_gather_seq, spec_for,
                                           tp_proj_scatter)

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
    """Full-sequence Mamba2 block core (no residual/norm — block adds those).
    On a mesh the sequence is gathered once, the projections, convs and
    scan run on each rank's rows and heads (``d_inner`` and the heads split
    alike over 'model'), the gated norm reduces across them, and the
    output projection reduce-scatters onto the sequence."""
    s_cfg = cfg.ssm
    w = s_cfg.conv_width
    x = sp_gather_seq(x)

    def core(x, w_z, w_x, w_B, w_C, w_dt, conv_x, conv_B, conv_C, dt_bias,
             A_log, D):
        b, s, _ = x.shape
        z = x @ w_z
        xs = x @ w_x
        Bs = x @ w_B
        Cs = x @ w_C
        dt_raw = x @ w_dt
        # pre-conv streams' tails: the decode cache
        tails = (xs[:, s - (w - 1):, :], Bs[:, s - (w - 1):, :],
                 Cs[:, s - (w - 1):, :])
        xs = F.silu(_causal_conv(xs, conv_x))
        Bs = F.silu(_causal_conv(Bs, conv_B))
        Cs = F.silu(_causal_conv(Cs, conv_C))
        dt = _dt_activation(dt_raw, dt_bias)
        A = -torch.exp(A_log)
        h = dt.shape[-1]
        # xh [B, S, H, P]: laid out (batch, None, ssm_heads, None), the
        # reference's constraint here
        xh = xs.reshape(b, s, h, xs.shape[-1] // h)
        y, final_state = _scan(xh, Bs, Cs, dt, A, min(s_cfg.chunk_size, s))
        y = y + D[None, None, :, None] * xh
        return (y.reshape(b, s, xs.shape[-1]).to(x.dtype), z, *tails,
                final_state)

    y, z, conv_x, conv_B, conv_C, final_state = _on_heads(
        core, params, x, ("batch", None, None), dims)

    # gated RMSNorm (mamba2's norm-before-out-proj)
    yf = y.float()
    var = yf.square().mean(-1, keepdim=True)
    y = (yf * torch.rsqrt(var + cfg.norm_eps)).to(x.dtype)
    y = y * params["gate_norm"] * F.silu(z.float()).to(x.dtype)

    out = tp_proj_scatter(y, params["w_out"], torch.matmul,
                          ("batch", None, "ffn"), w_sharded_dim=0)
    if not return_cache:
        return out
    cache = {"conv_x": conv_x, "conv_B": conv_B, "conv_C": conv_C,
             "state": final_state}
    return out, cache


_CORE_PARAMS = ("w_z", "w_x", "w_B", "w_C", "w_dt", "conv_x", "conv_B",
                "conv_C", "dt_bias", "A_log", "D")


def _on_heads(core, params, x, x_logical, dims, *cache):
    """``core(x, *params, *cache)`` -> (y, z, conv_x, conv_B, conv_C,
    state), on each rank's rows and heads on a mesh: ``d_inner`` ('ffn')
    and the heads ('ssm_heads') split over 'model' together, or neither."""
    mesh = current_mesh()
    args = (x, *(params[k] for k in _CORE_PARAMS), *cache)
    if mesh is None:
        return core(*args)
    rules = current_rules()
    heads = spec_for((dims.ssm_heads,), ("ssm_heads",), mesh, rules)[0]
    ffn = "ffn" if heads is not None else None
    hd = "ssm_heads" if heads is not None else None
    lead = x_logical[:-1]                          # (batch,) or (batch, None)
    logical = {"w_z": (None, ffn), "w_x": (None, ffn), "w_B": (None, None),
               "w_C": (None, None), "w_dt": (None, hd),
               "conv_x": (None, ffn), "conv_B": (None, None),
               "conv_C": (None, None), "dt_bias": (hd,), "A_log": (hd,),
               "D": (hd,)}
    conv = [("batch", None, ffn), ("batch", None, None), ("batch", None, None)]
    state = ("batch", hd, None, None)
    in_logical = [x_logical] + [logical[k] for k in _CORE_PARAMS]
    if cache:
        in_logical += conv + [state]
    outs = [(*lead, ffn), (*lead, ffn), *conv, state]

    def spec(shape, lg):
        return spec_for(shape, lg, mesh, rules)
    b = x.shape[0]
    w, di = params["conv_x"].shape[0], params["w_x"].shape[1]
    n, p = params["w_B"].shape[1], di // dims.ssm_heads
    out_shapes = [(*x.shape[:-1], di), (*x.shape[:-1], di), (b, w - 1, di),
                  (b, w - 1, n), (b, w - 1, n), (b, dims.ssm_heads, p, n)]
    return shard_map(core, mesh,
                     [spec(a.shape, lg) for a, lg in zip(args, in_logical)],
                     [spec(sh_, lg) for sh_, lg in zip(out_shapes, outs)]
                     )(*args)


def _scan(xh, Bs, Cs, dt, A, chunk: int):
    """The SSD scan: the CUDA kernel on a card tensor, ssd_chunked on a CPU
    one, as the reference takes its Pallas kernel on the TPU only; the
    kernel has no gradient (it refuses one), so on the card this trains
    nothing. A shape-only (``meta``) run outside autograd, the dry-run's,
    takes the kernel too: it is what the card runs."""
    kernel = xh.is_cuda or (xh.is_meta and not torch.is_grad_enabled())
    scan = ssd_kernel.ssd if kernel else ssd_chunked
    return scan(xh, Bs, Cs, dt, A, chunk=chunk)


def ssm_decode_step(
    params: dict,
    x: torch.Tensor,            # [B, 1, D]
    cache: dict,
    cfg: ArchConfig,
    dims: Dims,
):
    """O(1) recurrent step; returns (y [B,1,D], new cache). On a mesh the
    recurrence runs on each rank's rows and heads, as in
    :func:`ssm_mixer`."""

    def core(xt, w_z, w_x, w_B, w_C, w_dt, conv_x, conv_B, conv_C, dt_bias,
             A_log, D, c_x, c_B, c_C, state):
        b = xt.shape[0]
        # z and dt_raw are widened to fp32 at once: dot_f32, see
        # nn/layers.py
        z = dot_f32(xt, w_z)
        xs = xt @ w_x
        Bs = xt @ w_B
        Cs = xt @ w_C
        dt_raw = dot_f32(xt, w_dt)

        xs, c_x = _conv_step(c_x, xs, conv_x)
        Bs, c_B = _conv_step(c_B, Bs, conv_B)
        Cs, c_C = _conv_step(c_C, Cs, conv_C)
        xs = F.silu(xs.float())
        Bs = F.silu(Bs.float())
        Cs = F.silu(Cs.float())

        dt = _dt_activation(dt_raw, dt_bias)                    # [B, H]
        A = -torch.exp(A_log)
        decay = torch.exp(dt * A)                               # [B, H]

        h = dt.shape[-1]
        xh = xs.reshape(b, h, xs.shape[-1] // h)
        state = state * decay[:, :, None, None] + torch.einsum(
            "bh,bn,bhp->bhpn", dt, Bs, xh)
        y = torch.einsum("bn,bhpn->bhp", Cs, state) + D[None, :, None] * xh
        return y.reshape(b, xs.shape[-1]), z, c_x, c_B, c_C, state

    y, z, conv_x, conv_B, conv_C, state = _on_heads(
        core, params, x[:, 0, :], ("batch", None), dims, cache["conv_x"],
        cache["conv_B"], cache["conv_C"], cache["state"])

    var = y.square().mean(-1, keepdim=True)
    y = y * torch.rsqrt(var + cfg.norm_eps)
    y = y * params["gate_norm"].float()
    y = y * F.silu(z.float())
    y = y.to(x.dtype)

    out = (y @ params["w_out"])[:, None, :]
    new_cache = {"conv_x": conv_x, "conv_B": conv_B, "conv_C": conv_C,
                 "state": state}
    return out, new_cache
