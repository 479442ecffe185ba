"""Declarative parameter specs (src/repro/nn/params.py).

Each module describes its parameters once as a nested dict whose leaves are
:class:`ParamSpec` (shape, logical axes, init style). From that single
source of truth we derive:

* concrete initialized params            (:func:`build_params`)
* the logical-axes tree                   (:func:`build_axes`)
* shape-only params on the ``meta`` device (:func:`abstract_params`)

Trees are nested dicts, walked in sorted-key order (the order
``jax.tree`` flattens a dict in), so leaf ``i`` here is leaf ``i`` there.
The values cannot equal the reference's (PyTorch has no threefry
generator for them); a caller that needs the reference's values carries
them over (``repro_torch.convert.tree_from_numpy``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    init: str = "normal"          # normal | zeros | ones
    scale: float = 0.02
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"ParamSpec rank mismatch: {self.shape} vs {self.logical}")


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts (anything not a dict is a
    leaf), with ``rest`` trees of the same structure walked alongside."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves in sorted-key order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(tree, leaves):
    """``leaves`` (sorted-key order, as :func:`tree_leaves` gives them) in
    ``tree``'s structure."""
    it = iter(leaves)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        return next(it)
    return walk(tree)


def tree_index(tree, i: int):
    """Entry ``i`` of every stacked leaf (views, no copy)."""
    return tree_map(lambda a: a[i], tree)


def tree_stack(trees: list):
    """The trees' leaves stacked on a new leading dim."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def stack(spec_tree, n: int):
    """Prefix every spec in the tree with a stacked 'layers' dim of size n."""
    def one(s: ParamSpec) -> ParamSpec:
        return ParamSpec((n, *s.shape), (None, *s.logical), s.init, s.scale, s.dtype)
    return tree_map(one, spec_tree)


def build_params(spec_tree, generator: torch.Generator,
                 device: DeviceLike = None):
    """Initialize a params tree from a spec tree on ``device``. Each leaf
    draws from its own stream, seeded in sorted-key order from
    ``generator`` (a CPU generator), so a leaf's values do not depend on
    the shapes of the leaves before it. ``normal`` is a truncated normal
    on [-2, 2] times the spec's scale, drawn in fp32, then cast."""
    dev = resolve_device(device)
    seeds = iter(torch.randint(0, 2 ** 62, (len(tree_leaves(spec_tree)),),
                               generator=generator).tolist())

    def one(s: ParamSpec) -> torch.Tensor:
        seed = next(seeds)
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=s.dtype, device=dev)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=s.dtype, device=dev)
        if s.init == "normal":
            g = torch.Generator(dev).manual_seed(seed)
            w = torch.empty(s.shape, dtype=torch.float32, device=dev)
            torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=g)
            return (w * s.scale).to(s.dtype)
        raise ValueError(f"unknown init {s.init!r}")

    def walk(tree):                 # sorted keys: the seeds' order
        if isinstance(tree, dict):
            return {k: walk(tree[k]) for k in sorted(tree)}
        return one(tree)

    return walk(spec_tree)


def build_axes(spec_tree):
    """The logical-axes tree matching :func:`build_params` output."""
    return tree_map(lambda s: s.logical, spec_tree)


def abstract_params(spec_tree):
    """Shape/dtype-only params on the ``meta`` device: no allocation."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device="meta"), spec_tree)


def count_params(spec_tree) -> int:
    return int(sum(math.prod(s.shape) for s in tree_leaves(spec_tree)))
