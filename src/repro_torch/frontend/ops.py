"""Graph-level custom ops usable inside traced PyTorch functions.

The op graph has one op with no PyTorch equivalent: ``sample_normal``,
the VAE reparameterisation ``z = mu + exp(0.5 * logvar) * eps`` whose
eps comes from the execution plan's per-sample key stream (RANDOM_OPS in
core/opgraph.py), not from anything the user function can close over.

So the front-end exposes ``sample_normal(mu, logvar)`` as a leaf of the
``torch.fx`` trace: inside a trace it is one ``call_function`` node that
the translator registry maps 1:1 onto the graph op, however the caller
imported it; outside a trace it still runs, with eps drawn from the fixed
key (0, 0) as ``jax.random.normal(PRNGKey(0), mu.shape)`` draws it (the
port's threefry, ``kernels/sample.py``), so users can check their
function before tracing. That is not the plan's key stream, which the
engine and scheduler own.
"""
from __future__ import annotations

import math

import torch
import torch.fx

from repro_torch.kernels.sample import normal_plain


def sample_normal(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """Reparameterised Gaussian sample: traces to the graph's
    ``sample_normal`` op (plan-threaded keys); eager calls draw eps from
    key (0, 0) over the whole of ``mu``'s shape."""
    proxies = [a for a in (mu, logvar) if isinstance(a, torch.fx.Proxy)]
    if proxies:
        return proxies[0].tracer.create_proxy(
            "call_function", SAMPLE_NORMAL, (mu, logvar), {})
    if mu.shape != logvar.shape:
        raise ValueError(f"sample_normal: mu shape {tuple(mu.shape)} != "
                         f"logvar shape {tuple(logvar.shape)}")
    key = torch.zeros((1, 2), dtype=torch.int64)
    eps = normal_plain(key, math.prod(mu.shape)).reshape(mu.shape)
    return mu + torch.exp(0.5 * logvar) * eps.to(mu.device, mu.dtype)


# the fx target of the leaf (the tracer may patch the module global)
SAMPLE_NORMAL = sample_normal
torch.fx.wrap("sample_normal")
