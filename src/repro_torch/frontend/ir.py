"""Trace-time value and node representations shared by the jaxpr walker
(trace.py) and the per-primitive translators (translators.py).

Two value kinds flow through the walk:

* ``Ref`` — a tensor produced by an emitted graph node; ``sid`` indexes
  the ``NodeSpec`` list. Ref avals are *batched* (trace batch leading).
* ``ConstVal`` — a trace-time constant (jaxpr constvar or literal),
  stored **unbatched**. A const that passed through ``broadcast_in_dim``
  keeps its original value plus the broadcast target
  (``bdims``/``bshape``) so the bias-fold peephole can still see the
  per-channel vector instead of a materialized full-size array.

``NodeSpec`` is the mutable staging form of a graph node: peepholes
(bias fold, sum-pool -> avgpool) rewrite specs in place; the final
``Graph`` is only built once the whole jaxpr has been walked.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple


class UnsupportedPrimitiveError(NotImplementedError):
    """A jaxpr primitive (or a parameterization of one) has no graph
    translation. The message always names the offending eqn."""


@dataclasses.dataclass(frozen=True)
class Ref:
    sid: int


@dataclasses.dataclass
class ConstVal:
    value: Any                                   # np/jnp array, unbatched
    bdims: Optional[Tuple[int, ...]] = None      # broadcast_dimensions
    bshape: Optional[Tuple[int, ...]] = None     # broadcast target (batched)


@dataclasses.dataclass
class NodeSpec:
    sid: int
    op: str
    inputs: List[int]                            # producer sids
    attrs: Dict[str, Any]
    batched_shape: Tuple[int, ...]               # traced aval, batch leading
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    hint: Optional[str] = None                   # naming hint (best-effort)
    bias_folded: bool = False
