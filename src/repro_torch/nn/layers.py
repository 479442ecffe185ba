"""Basic transformer layers: RMSNorm, SwiGLU MLP, embeddings, RoPE
(src/repro/nn/layers.py).

The reference's sharding hints (``constrain``, the sequence gather and
the reduce-scatter down-projection, ``parallel/sharding.py``) sit where
the reference puts them; without a mesh each is the identity and each
projection is its product.

Rounding follows what the reference's compiled program computes. Where
the reference widens a bf16 product or sum straight to fp32
(``(x @ w).astype(float32)``, ``silu(h.astype(float32))``), its compiler
folds the widening into the operation and the bf16 rounding never
happens: :func:`dot_f32`, :func:`residual` and the fp32 sums in the
layers keep those results in fp32 too. Every other bf16 result is rounded where the reference's source
rounds it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.nn.dims import Dims
from repro_torch.nn.params import ParamSpec
from repro_torch.parallel.sharding import (constrain, is_dtensor, local_op,
                                           sp_gather_seq, tp_proj_scatter,
                                           vocab_lookup)

def dot_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with an fp32 result and no bf16 rounding: the products of
    bf16 values are exact in fp32, the sums fp32. On the card the bf16
    GEMM writes fp32 (``out_dtype``), which has no derivative and no
    sharding rule: under autograd, on a mesh, and on the CPU, the operands
    widen."""
    if x.dtype == w.dtype == torch.float32:
        return x @ w
    card = x.is_cuda and not (torch.is_grad_enabled()
                              and (x.requires_grad or w.requires_grad)) \
        and not (is_dtensor(x) or is_dtensor(w))
    if card and w.ndim == 2:
        out = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return out.reshape(*x.shape[:-1], w.shape[-1])
    if card and x.ndim == w.ndim == 3:
        return torch.bmm(x, w, out_dtype=torch.float32)
    return x.float() @ w.float()


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5,
            xf: torch.Tensor = None) -> torch.Tensor:
    """``xf``: ``x``'s unrounded fp32 value where the caller has it (a
    residual sum; see :func:`residual`)."""
    xf = x.float() if xf is None else xf
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


def residual(x: torch.Tensor, a: torch.Tensor):
    """``x + a`` in ``x``'s dtype, and the same sum unrounded in fp32 for
    the RMSNorm that reads it next: the reference's compiled program
    widens that sum straight into the norm. One fp32 sum: its rounding
    is the bf16 add's."""
    xf = x.float() + a.float()
    return xf.to(x.dtype), xf


def norm_spec(d: int) -> ParamSpec:
    return ParamSpec((d,), ("embed",), init="ones")


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------


def mlp_spec(dims: Dims) -> dict:
    d, f = dims.d_model, dims.d_ff
    return {
        "w_gate": ParamSpec((d, f), ("fsdp", "ffn")),
        "w_up": ParamSpec((d, f), ("fsdp", "ffn")),
        "w_down": ParamSpec((f, d), ("ffn", "fsdp")),
    }


def swiglu_hidden(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                  gate_f32: bool = False) -> torch.Tensor:
    """``silu(x @ w_gate) * (x @ w_up)``, the silu in fp32. ``gate_f32``:
    the gate product is not rounded to ``x``'s dtype (the MoE experts'
    batched product, which the reference's compiled program keeps in
    fp32)."""
    h = dot_f32(x, w_gate) if gate_f32 else x @ w_gate
    u = x @ w_up
    return F.silu(h.float()).to(x.dtype) * u


def mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    # SP gather once, TP-sharded gate/up, explicit reduce-scatter
    # down-projection
    x = sp_gather_seq(x)
    h = local_op(swiglu_hidden, ("batch", None, "ffn"),
                 (x, ("batch", None, None)), (params["w_gate"], (None, "ffn")),
                 (params["w_up"], (None, "ffn")))
    h = constrain(h, "batch", None, "ffn")
    return tp_proj_scatter(h, params["w_down"], torch.matmul,
                           ("batch", None, "ffn"), w_sharded_dim=0)


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------


def embed_spec(dims: Dims, tie: bool) -> dict:
    out = {"embedding": ParamSpec((dims.vocab, dims.d_model), ("vocab", "fsdp"))}
    if not tie:
        out["lm_head"] = ParamSpec((dims.d_model, dims.vocab), ("fsdp", "vocab"))
    return out


def embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """On a mesh, vocab-parallel (``vocab_lookup``): DTensor's indexing
    rules fail on a vocab-sharded table in torch 2.11."""
    return vocab_lookup(params["embedding"], tokens)


def lm_logits(params: dict, x: torch.Tensor) -> torch.Tensor:
    """On a mesh, vocab-parallel: the gathered sequence against each rank's
    vocab columns."""
    head = params.get("lm_head")
    if head is None:
        head = params["embedding"].T
    x = sp_gather_seq(x)
    return local_op(torch.matmul, ("batch", None, "vocab"),
                    (x, ("batch", None, None)), (head, (None, "vocab")))


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)  # [head_dim//2]


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, S, H, hd]; positions: [B, S] (absolute token positions)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                    # [hd/2]
    angles = positions[..., None].float() * freqs              # [B, S, hd/2]
    cos = torch.cos(angles)[..., None, :]                      # [B, S, 1, hd/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Cross entropy (fp32, label-gather formulation — never materializes
# a one-hot over the padded vocab)
# ---------------------------------------------------------------------------


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  valid: torch.Tensor = None) -> torch.Tensor:
    """Mean next-token NLL in fp32; with ``valid``, the mean over the
    valid positions (``sum(valid)`` floored at 1)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    picked = torch.take_along_dim(lf, labels.long()[..., None], dim=-1)[..., 0]
    nll = lse - picked
    if valid is None:
        return nll.mean()
    valid = valid.float()
    return (nll * valid).sum() / torch.clamp_min(valid.sum(), 1.0)
