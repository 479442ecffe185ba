"""Pipeline parallelism: GPipe-style microbatched schedule over a 'stage'
mesh axis (src/repro/parallel/pipeline_parallel.py).

Each stage holds a contiguous slice of the layer stack; activations flow
stage-to-stage around a ring of point-to-point sends (the reference's
``ppermute``): one [mb, S, D] tensor per microbatch per boundary.

Schedule: the classic GPipe fill-drain loop — T = n_micro + n_stages - 1
ticks; at tick t, stage s computes microbatch (t - s) when
0 <= t - s < n_micro, else it computes on garbage and the result is
masked (the bubble). Efficiency = n_micro / T, reported by
:func:`bubble_fraction`.

The layer slice per stage is the SAME stacked-params layout the model
uses (params sharded over the stage axis on the layer dim), so a dense
model's ``groups`` tree drops in unchanged.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol

from repro_torch.nn.params import tree_index, tree_leaves, tree_unflatten
from repro_torch.parallel import transport
from repro_torch.parallel.sharding import Spec, shard_map


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)


def ring_shift(h: torch.Tensor, group) -> torch.Tensor:
    """Each stage's ``h`` to the next stage of ``group``'s ring (the last
    to the first): one send and one receive per stage (through the host
    where the shared-card transport stages point-to-point)."""
    if h.is_cuda and transport.P2P in transport.staged_collectives():
        return ring_shift(h.cpu(), group).to(h.device)
    ranks = dist.get_process_group_ranks(group)
    i, n = ranks.index(dist.get_rank()), len(ranks)
    h = h.contiguous()
    out = torch.empty_like(h)
    ops = [dist.P2POp(dist.isend, h, ranks[(i + 1) % n], group),
           dist.P2POp(dist.irecv, out, ranks[(i - 1) % n], group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


def pipeline_forward(
    stacked_params: Any,          # tree, leaves [L, ...] — L % n_stages == 0
    x: torch.Tensor,              # [n_micro, mb, S, D] microbatched input
    block_fn: Callable,           # (layer_params, x) -> x  (one layer)
    mesh,
    *,
    stage_axis: str = "stage",
    extra_specs: Spec = (),       # layout of non-stage dims of x (e.g. data)
) -> torch.Tensor:
    """Run the layer stack as a pipeline; returns [n_micro, mb, S, D]
    (forward only). ``stacked_params`` leaves are laid out over
    ``stage_axis`` on dim 0 — each stage sees its [L/n_stages, ...] slice
    and runs it locally per tick."""
    n_stages = mesh.shape[stage_axis]
    n_micro = x.shape[0]
    n_ticks = n_micro + n_stages - 1
    group = mesh.group(stage_axis)

    leaves = tree_leaves(stacked_params)
    p_specs = [(stage_axis,) + (None,) * (a.ndim - 1) for a in leaves]
    x_spec = (None, *extra_specs)   # microbatch dim replicated per stage

    def staged(x_all, *blk_leaves):
        params_blk = tree_unflatten(stacked_params, blk_leaves)
        stage = mesh.local_index(stage_axis)
        n_local = blk_leaves[0].shape[0]

        def local_stack(h):
            for j in range(n_local):
                h = block_fn(tree_index(params_blk, j), h)
            return h

        outputs = torch.zeros_like(x_all)
        cur = torch.zeros_like(x_all[0])
        for t in range(n_ticks):
            # stage 0 injects microbatch t; others take the shifted input
            h_in = x_all[min(t, n_micro - 1)] if stage == 0 else cur
            h_out = local_stack(h_in)
            # emit: the LAST stage finished microbatch (t - n_stages + 1)
            mb_idx = t - (n_stages - 1)
            if stage == n_stages - 1 and mb_idx >= 0:
                outputs[mb_idx] = h_out
            # pass activations down the ring for the next tick
            cur = ring_shift(h_out, group)
        # only the last stage holds non-zero outputs; the sum over stages
        # replicates them on every stage
        return funcol.wait_tensor(funcol.all_reduce(outputs, "sum", group))

    return shard_map(staged, mesh, (x_spec, *p_specs), x_spec)(x, *leaves)
