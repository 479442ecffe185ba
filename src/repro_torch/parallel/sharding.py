"""Logical-axis sharding: model code names axes, the mesh maps them
(src/repro/parallel/sharding.py).

Model code never mentions mesh axes directly. Every tensor dimension gets a
*logical* name ('batch', 'seq', 'heads', 'ffn', ...); a rule table maps
logical names to mesh axes; and :func:`spec_for` resolves the mapping with
a divisibility fallback (a dim that cannot be evenly split over the mapped
mesh axes is replicated instead — this is what makes decode shapes with
seq=1 or batch=1 'just work' on the production mesh).

The mesh is a ``torch.distributed`` ``DeviceMesh`` (wrapped by :class:`Mesh`,
which reads like ``jax.sharding.Mesh``), and a sharded array is a DTensor:
a spec becomes a list of placements (:func:`placements_for`), a sharding
constraint a ``redistribute`` (:func:`constrain`), and the reference's
``shard_map`` regions :func:`shard_map`, which runs a function on each
rank's local blocks. The active (mesh, rules) pair is installed with
:func:`use_mesh`; when no context is active, :func:`constrain` and the
sequence-parallel helpers are the identity, so the model code runs
unchanged on one device.
"""
from __future__ import annotations

import contextlib
import math
import types
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._python_dispatch import _disable_current_modes

# The functional collectives' autograd forms (torch renamed the first two;
# the same functions under either name)
all_gather_autograd = getattr(funcol, "all_gather_single_autograd", None) \
    or funcol.all_gather_tensor_autograd
reduce_scatter_autograd = getattr(
    funcol, "reduce_scatter_single_autograd", None) \
    or funcol.reduce_scatter_tensor_autograd
all_to_all_autograd = funcol.all_to_all_single_autograd

# ---------------------------------------------------------------------------
# Rule tables
# ---------------------------------------------------------------------------

# Logical axis -> tuple of mesh axes (tried in order, greedily).
# 'data' doubles as the FSDP axis for weights; 'model' is the TP axis;
# 'pod' is the cross-pod DP axis.
SINGLE_POD_RULES = {
    # activations
    "batch": ("data",),
    "seq": ("model",),            # sequence parallelism between blocks
    "embed": (),                  # residual feature dim stays unsharded
    # attention
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": (),
    # mlp / experts
    "ffn": ("model",),
    "expert": ("model",),
    "expert_ffn": ("data",),      # second-level expert sharding (256-way EP)
    "expert_cap": ("data",),      # dispatch-buffer capacity dim
    # embeddings / head
    "vocab": ("model",),
    "fsdp": ("data",),            # ZeRO-style weight/optimizer sharding
    # ssm
    "ssm_heads": ("model",),
    "ssm_state": (),
    "conv_dim": ("model",),
}

MULTI_POD_RULES = dict(SINGLE_POD_RULES)
MULTI_POD_RULES.update({
    "batch": ("pod", "data"),
    "fsdp": ("data",),            # keep FSDP intra-pod; pods replicate weights
})


def rules_for(mesh) -> dict:
    return MULTI_POD_RULES if "pod" in mesh.axis_names else SINGLE_POD_RULES


def serving_rules(mesh) -> dict:
    """Inference sharding: ZeRO/FSDP weight sharding re-gathers every
    weight every decode step, so serving replicates weights over the data
    axis and keeps TP/EP over 'model' (the same on the experts'
    second-level 'expert_ffn' axis). Only where the replicated weights fit
    a device's memory: llama4-maverick's routed experts do not."""
    rules = dict(rules_for(mesh))
    rules["fsdp"] = ()
    rules["expert_ffn"] = ()
    return rules


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------


class Mesh:
    """A ``DeviceMesh`` read as ``jax.sharding.Mesh``: ``.shape`` is a dict
    of axis sizes and ``.axis_names`` a tuple, so :func:`spec_for` reads
    either."""

    def __init__(self, device_mesh):
        self.device_mesh = device_mesh
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.shape = dict(zip(self.axis_names, device_mesh.mesh.shape))

    @property
    def device_type(self) -> str:
        return self.device_mesh.device_type

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def local_index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self.device_mesh.get_local_rank(axis)

    def __repr__(self):
        return f"Mesh({self.shape}, {self.device_type})"


# ---------------------------------------------------------------------------
# Resolution
# ---------------------------------------------------------------------------

Spec = Tuple[Optional[object], ...]   # per dim: None, an axis, or a tuple


def _axis_size(mesh, names: Sequence[str]) -> int:
    size = 1
    for n in names:
        size *= mesh.shape[n]
    return size


def spec_for(
    shape: Sequence[int],
    logical: Sequence[Optional[str]],
    mesh,
    rules: Optional[dict] = None,
) -> Spec:
    """Resolve logical names to a per-dim spec with divisibility fallback.

    For each dim, the mapped mesh-axis tuple is trimmed from the right until
    the dim size divides the product of the remaining axes (so 'batch' ->
    ('pod','data') falls back to ('pod',) and then to replication). Mesh
    axes already consumed by an earlier dim are skipped — no axis is used
    twice. Each entry is ``None``, an axis name, or a tuple of names, as in
    the reference's ``PartitionSpec``.
    """
    rules = rules or rules_for(mesh)
    if len(shape) != len(logical):
        raise ValueError(f"shape {shape} vs logical {logical} rank mismatch")
    used: set = set()
    out = []
    for dim, name in zip(shape, logical):
        if name is None:
            out.append(None)
            continue
        axes = tuple(a for a in rules.get(name, ()) if a not in used)
        while axes and (dim % _axis_size(mesh, axes) != 0):
            axes = axes[:-1]
        if not axes:
            out.append(None)
        elif len(axes) == 1:
            out.append(axes[0])
            used.add(axes[0])
        else:
            out.append(axes)
            used.update(axes)
    return tuple(out)


def spec_axes(part) -> Tuple[str, ...]:
    """The mesh axes one spec entry names."""
    if part is None:
        return ()
    return part if isinstance(part, tuple) else (part,)


def placements_for(spec: Spec, mesh) -> list:
    """A spec as DTensor placements, one per mesh axis: ``Shard(d)`` on each
    axis that splits dim ``d``, ``Replicate()`` elsewhere. A dim split over
    several axes (``('pod', 'data')``) is split major to minor in mesh
    order, as the reference's tuple entry is."""
    out = [Replicate()] * len(mesh.axis_names)
    for d, part in enumerate(spec):
        for a in spec_axes(part):
            out[mesh.axis_names.index(a)] = Shard(d)
    return out


def local_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """The shape of one rank's block of an array laid out by ``spec``."""
    return tuple(n // _axis_size(mesh, spec_axes(p))
                 for n, p in zip(shape, spec))


# ---------------------------------------------------------------------------
# Context
# ---------------------------------------------------------------------------

# Process-wide, not per thread (the reference keeps it thread-local): on a
# CUDA device autograd runs the backward, and with it a checkpointed
# group's recompute, on its own worker thread, which must see the mesh.
_state = types.SimpleNamespace(mesh=None, rules=None)


def current_mesh() -> Optional[Mesh]:
    return _state.mesh


def current_rules() -> Optional[dict]:
    return _state.rules


@contextlib.contextmanager
def use_mesh(mesh: Mesh, rules: Optional[dict] = None):
    """Install (mesh, rules) so :func:`constrain` becomes active. Plain
    tensors the model makes inside (positions, masks, buffers) meet the
    DTensors as replicated values."""
    prev = (current_mesh(), current_rules())
    _state.mesh = mesh
    _state.rules = rules or rules_for(mesh)
    try:
        with implicit_replication():
            yield mesh
    finally:
        _state.mesh, _state.rules = prev


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def as_dtensor(x: torch.Tensor, mesh: Mesh) -> DTensor:
    """``x`` itself when it is a DTensor, else the same value replicated."""
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh.device_mesh,
                              [Replicate()] * len(mesh.axis_names),
                              run_check=False)


def layout(x: torch.Tensor, spec: Spec, mesh: Mesh) -> DTensor:
    """``x`` redistributed to ``spec`` (``jax.lax.with_sharding_constraint``)."""
    x = as_dtensor(x, mesh)
    want = placements_for(spec, mesh)
    if tuple(x.placements) == tuple(want):
        return x
    return x.redistribute(mesh.device_mesh, want)


def constrain(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """Apply a sharding constraint by logical axis names (no-op w/o mesh)."""
    mesh = current_mesh()
    if mesh is None:
        return x
    return layout(x, spec_for(x.shape, logical, mesh, current_rules()), mesh)


class _ScaleGrad(torch.autograd.Function):
    """Identity forward; the gradient times ``scale`` backward."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def shard_map(f: Callable, mesh: Mesh, in_specs: Sequence[Spec],
              out_specs) -> Callable:
    """``f`` run on each rank's local blocks (the reference's
    ``shard_map``): every input is laid out by its spec and handed over as
    its local tensor; ``f``'s local result is the block of an array laid
    out by ``out_specs`` (a list of specs: ``f`` returns that many).

    Gradients cross both ways with shard_map's transpose: the cotangent of
    an input every rank along an axis reads whole is summed over that axis
    (a ``Partial`` gradient), and the cotangent of a result every rank
    along an axis holds whole is split evenly among them (times 1/n, exact
    for the power-of-two axes here), so collectives inside ``f`` take the
    functional collectives' autograd forms and the sums come out right."""
    def local(x, spec):
        pl = placements_for(spec, mesh)
        return layout(x, spec, mesh).to_local(grad_placements=[
            Partial() if isinstance(p, Replicate) else p for p in pl])

    def wrap(y, spec):
        used = {a for part in spec for a in spec_axes(part)}
        n = math.prod(size for a, size in mesh.shape.items() if a not in used)
        if n > 1 and y.requires_grad:
            y = _ScaleGrad.apply(y, 1.0 / n)
        return DTensor.from_local(y, mesh.device_mesh,
                                  placements_for(spec, mesh), run_check=False)

    def run(*xs):
        y = f(*(local(x, s) for x, s in zip(xs, in_specs)))
        if isinstance(out_specs, list):
            return tuple(wrap(a, s) for a, s in zip(y, out_specs))
        return wrap(y, out_specs)
    return run


def local_op(f: Callable, out_logical: Tuple, *operands) -> torch.Tensor:
    """``f(*tensors)`` on each rank's blocks, ``operands`` being ``(tensor,
    logical axes)`` pairs and ``out_logical`` the result's axes (the
    identity of layouts without a mesh). The remedy for a product whose
    DTensor rule fails or replicates where the reference shards: e.g. a
    projection of the gathered activation by a weight laid out
    ``(None, 'heads', None)`` — its FSDP dim gathered first, as the
    reference's partitioner gathers it."""
    mesh = current_mesh()
    xs = [x for x, _ in operands]
    if mesh is None:
        return f(*xs)
    rules = current_rules()
    with _disable_current_modes():          # shape inference, not work
        meta = f(*(torch.empty(x.shape, dtype=x.dtype, device="meta")
                   for x in xs))
    specs = [spec_for(x.shape, lg, mesh, rules) for x, lg in operands]
    out = spec_for(meta.shape, out_logical, mesh, rules)
    return shard_map(f, mesh, specs, out)(*xs)


def full_on_ranks(f: Callable, *xs: torch.Tensor) -> torch.Tensor:
    """``f`` on whole values: on a mesh every input is gathered to every
    rank and ``f``'s result is a replicated DTensor. The remedy for an op
    DTensor has no sharding rule for (an indexed scatter or gather whose
    indices span the whole array); it costs each rank the whole array."""
    mesh = current_mesh()
    if mesh is None:
        return f(*xs)
    return shard_map(f, mesh, [(None,) * x.ndim for x in xs], ())(*xs)


def write_at(dst: torch.Tensor, pos: int, val: torch.Tensor) -> None:
    """``dst[:, pos:pos + 1] = val`` in place (a decode step's cache
    write); on a mesh ``val`` takes ``dst``'s layout and each rank writes
    its own block."""
    if isinstance(dst, DTensor):
        val = as_dtensor(val, current_mesh())
        if tuple(val.placements) != tuple(dst.placements):
            val = val.redistribute(dst.device_mesh, dst.placements)
        dst.to_local()[:, pos:pos + 1] = val.to_local()
        return
    dst[:, pos:pos + 1] = val


def like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``g`` laid out as ``p`` is (a gradient as its parameter: the data
    axis's reduction); a plain tensor as it is."""
    if isinstance(p, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def full(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's whole value as a plain tensor on every rank; a plain
    tensor as it is."""
    return x.full_tensor() if isinstance(x, DTensor) else x


# ---------------------------------------------------------------------------
# Explicit sequence-parallel collectives
#
# Relying on DTensor's propagation for the SP<->TP transitions would leave
# the TP output projections as an all-reduce; these helpers pin both ends:
# one all-gather of the sequence dim on the way in, the local product and a
# reduce-scatter onto the sequence dim on the way out — Megatron-SP,
# explicitly. They fall back to plain constraints whenever the mesh/shape
# cannot support them (decode s=1, one device, tp=1). torch sends bf16 as it
# is, so the reference's bf16 -> u16 bitcast around the gather (which stops
# XLA's CPU backend widening the wire) has no counterpart here.
# ---------------------------------------------------------------------------


def _sp_ready(mesh, seq: int, *dims_mod_model: int) -> bool:
    if mesh is None or "model" not in mesh.axis_names:
        return False
    tp = mesh.shape["model"]
    if tp == 1 or seq % tp:
        return False
    return all(d % tp == 0 for d in dims_mod_model)


def sp_gather_seq(x: torch.Tensor, batch_logical: str = "batch") -> torch.Tensor:
    """[B, s/tp, D] seq-sharded -> [B, S, D] gathered (all-gather over
    'model')."""
    mesh = current_mesh()
    if not _sp_ready(mesh, x.shape[1]):
        return constrain(x, batch_logical, None, None) if mesh is not None else x
    rules = current_rules()
    in_spec = spec_for(x.shape, (batch_logical, "seq", None), mesh, rules)
    out_spec = spec_for(x.shape, (batch_logical, None, None), mesh, rules)
    if "model" not in spec_axes(in_spec[1]):
        return constrain(x, batch_logical, None, None)
    group = mesh.group("model")

    def f(xb):
        return all_gather_autograd(xb.contiguous(), 1, group)

    return shard_map(f, mesh, (in_spec,), out_spec)(x)


def tp_proj_scatter(inp: torch.Tensor, w: torch.Tensor,
                    proj: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                    inp_logical: Tuple, w_sharded_dim: int = 0) -> torch.Tensor:
    """``proj(inp, w)`` whose contraction runs over the model-sharded dim
    of ``w``; the partial result is reduce-scattered onto the seq dim
    (axis 1) in ONE local region. ``proj`` is the caller's own product
    (the reference passes einsum subscripts), so without a mesh this is
    exactly the unsharded code.

    inp: [B, S, ...] with the contracted dim model-sharded; w's
    ``w_sharded_dim`` is laid out over 'model' (other dims replicated)."""
    mesh = current_mesh()
    contracted = inp.shape[-1] if inp.ndim == 3 else inp.shape[2]
    if not _sp_ready(mesh, inp.shape[1], contracted):
        y = proj(inp, w)
        return constrain(y, "batch", "seq", None) if mesh is not None else y
    rules = current_rules()
    in_spec = spec_for(inp.shape, inp_logical, mesh, rules)
    w_spec = tuple("model" if i == w_sharded_dim else None
                   for i in range(w.ndim))
    out_shape = (inp.shape[0], inp.shape[1], w.shape[-1])
    y_spec = spec_for(out_shape, ("batch", "seq", None), mesh, rules)
    group = mesh.group("model")

    def f(i_blk, w_blk):
        y = proj(i_blk, w_blk)
        return reduce_scatter_autograd(y.contiguous(), "sum", 1, group)

    return shard_map(f, mesh, (in_spec, w_spec), y_spec)(inp, w)


class _AllReduceSum(torch.autograd.Function):
    """A sum over ``group``; its transpose under :func:`shard_map`'s
    convention (a replicated result's cotangent split evenly) is the same
    sum."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return funcol.wait_tensor(funcol.all_reduce(x, "sum", group))

    @staticmethod
    def backward(ctx, g):
        return funcol.wait_tensor(funcol.all_reduce(
            g.contiguous(), "sum", ctx.group)), None


def vocab_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]`` ([V, D] rows for [B] or [B, S] ids). On a mesh
    whose rules split the vocab over 'model', vocab-parallel: each rank
    looks the tokens up in its own rows (the fsdp dim gathered, as the MLP
    gathers its weights) with zeros for ids outside them, and the partial
    rows are summed over 'model' — reduce-scattered onto the sequence when
    it is split there, else all-reduced. One rank holds each row, so the
    sum is exact, and the table is never gathered whole."""
    mesh = current_mesh()
    if mesh is None:
        return table[tokens]
    rules = current_rules()
    t_spec = spec_for(table.shape, ("vocab", None), mesh, rules)
    tok_logical = ("batch",) if tokens.ndim == 1 else ("batch", None)
    tok_spec = spec_for(tokens.shape, tok_logical, mesh, rules)
    if "model" not in spec_axes(t_spec[0]):
        return shard_map(lambda t, i: t[i], mesh, (t_spec, tok_spec),
                         (*tok_spec, None))(table, tokens)
    shape = (*tokens.shape, table.shape[1])
    out_spec = spec_for(shape, (*tok_logical, None), mesh, rules)
    scatter = False
    if tokens.ndim == 2 and _sp_ready(mesh, tokens.shape[1]):
        seq_spec = spec_for(shape, ("batch", "seq", None), mesh, rules)
        scatter = "model" in spec_axes(seq_spec[1])
        if scatter:
            out_spec = seq_spec
    group = mesh.group("model")

    def f(t_blk, i_blk):
        v = t_blk.shape[0]
        j = i_blk - mesh.local_index("model") * v
        hit = (j >= 0) & (j < v)
        rows = torch.where(hit[..., None], t_blk[j.clamp(0, v - 1)],
                           torch.zeros((), dtype=t_blk.dtype,
                                       device=t_blk.device))
        if scatter:
            return reduce_scatter_autograd(rows.contiguous(), "sum", 1, group)
        return _AllReduceSum.apply(rows.contiguous(), group)

    return shard_map(f, mesh, (t_spec, tok_spec), out_spec)(table, tokens)


# ---------------------------------------------------------------------------
# Trees (params <-> shardings)
# ---------------------------------------------------------------------------


def is_logical_leaf(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None))) for e in x)


def tree_specs(tree, tree_logical, mesh, rules=None):
    """Matching trees of arrays (anything with ``.shape``) and logical-axis
    tuples -> a tree of specs (the reference's ``tree_shardings``)."""
    rules = rules or rules_for(mesh)
    if isinstance(tree, dict):
        return {k: tree_specs(v, tree_logical[k], mesh, rules)
                for k, v in tree.items()}
    return spec_for(tuple(tree.shape), tree_logical, mesh, rules)


def shard_tree(tree, tree_logical, mesh: Mesh, rules=None):
    """Place a full tree (every rank holds the same values, e.g. the output
    of ``convert.tree_from_numpy``) on the mesh as DTensors laid out by the
    rules: each rank keeps its own block, no collective runs. This is how
    the reference's weights reach a mesh (its ``device_put`` with
    ``tree_shardings``)."""
    return place_tree(tree, tree_specs(tree, tree_logical, mesh, rules), mesh)


def coordinate(part, mesh) -> Tuple[int, int]:
    """(index, count): which of the ``count`` blocks of a dim split over
    ``part``'s axes this rank holds."""
    i, n = 0, 1
    for a in spec_axes(part):
        i = i * mesh.shape[a] + mesh.local_index(a)
        n *= mesh.shape[a]
    return i, n


def block(x: torch.Tensor, spec: Spec, mesh: Mesh, first: int = 0
          ) -> torch.Tensor:
    """This rank's block of ``x`` (laid out by ``spec``) along its dims from
    ``first`` on."""
    idx = [slice(None)] * first
    for d in range(first, len(spec)):
        i, n = coordinate(spec[d], mesh)
        size = x.shape[d] // n
        idx.append(slice(i * size, (i + 1) * size))
    return x[tuple(idx)].contiguous() if idx else x.clone()


def from_blocks(local: torch.Tensor, spec: Spec, mesh: Mesh,
                shape: Sequence[int]) -> DTensor:
    """The array of ``shape`` laid out by ``spec`` whose block on this rank
    is ``local``."""
    return DTensor.from_local(local, mesh.device_mesh,
                              placements_for(spec, mesh), run_check=False,
                              shape=torch.Size(shape),
                              stride=_contiguous(shape))


def place(x: torch.Tensor, spec: Spec, mesh: Mesh) -> DTensor:
    """A full tensor (the same on every rank) as a DTensor laid out by
    ``spec``: this rank's block, sliced locally."""
    x = x.to(mesh.device_type)
    return from_blocks(block(x, spec, mesh), spec, mesh, x.shape)


def place_tree(tree, specs, mesh: Mesh):
    """:func:`place` over matching trees of full tensors and specs."""
    if isinstance(tree, dict):
        return {k: place_tree(v, specs[k], mesh) for k, v in tree.items()}
    return place(tree, specs, mesh)


def spec_of(x: DTensor) -> Spec:
    """The spec a DTensor is laid out by (the inverse of
    :func:`placements_for`)."""
    names = x.device_mesh.mesh_dim_names
    parts = [[] for _ in range(x.ndim)]
    for a, pl in zip(names, x.placements):
        if isinstance(pl, Shard):
            parts[pl.dim].append(a)
    return tuple(None if not p else p[0] if len(p) == 1 else tuple(p)
                 for p in parts)


def _contiguous(shape) -> Tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))
