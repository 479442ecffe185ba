"""``torch.fx`` front-end: trace plain batched PyTorch functions into the
op graph.

Public surface:

* ``trace(fn, example_inputs, name=...)`` -> ``TracedModel`` whose
  ``.graph``/``.params`` flow through ``Engine`` unchanged.
* ``sample_normal(mu, logvar)`` — the reparameterisation op for use
  inside traced functions (maps to the graph's key-threaded op).
* ``register(target)`` — extend the translator registry.
* ``UnsupportedPrimitiveError`` — raised, naming the fx node, for
  anything the graph can't express.
"""
from repro_torch.frontend.ir import UnsupportedPrimitiveError
from repro_torch.frontend.ops import sample_normal
from repro_torch.frontend.trace import TRACE_BATCH, TracedModel, trace
from repro_torch.frontend.translators import TRANSLATORS, register

__all__ = ["trace", "TracedModel", "TRACE_BATCH", "sample_normal",
           "register", "TRANSLATORS", "UnsupportedPrimitiveError"]
