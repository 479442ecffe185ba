"""Data pipeline: deterministic synthetic streams (src/repro/data/pipeline.py).

For training/benchmarks we generate deterministic synthetic batches
(seeded per step, so a restarted job resumes on *identical* data —
important for checkpoint/restart tests). The batches are numpy, equal to
the reference's bit for bit; the launcher moves them to the device.

``host_shard`` mimics the multi-host layout: each rank holds only its
rows of the global batch (:func:`local_slice`), and the global array is
assembled from those local blocks as a DTensor (``DTensor.from_local``, the
counterpart of ``jax.make_array_from_process_local_data``); no rank moves
another's rows. Rank and world size take the place of
``jax.process_index()`` and ``process_count()``. As in the reference, the
host draws the step's whole batch (the stream is seeded per step, not per
row) and keeps its slice.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.nn.dims import Dims
from repro_torch.parallel import sharding


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    # synthetic LM stream: a noisy copy task so loss actually decreases —
    # next token = (current + stride) mod vocab with flip noise
    stride: int = 7
    noise: float = 0.05


def _tokens_for_step(step: int, batch: int, seq: int, vocab: int,
                     dc: DataConfig) -> np.ndarray:
    rng = np.random.default_rng(dc.seed * 1_000_003 + step)
    start = rng.integers(0, vocab, size=(batch, 1))
    ramp = (start + dc.stride * np.arange(seq + 1)[None, :]) % vocab
    flips = rng.random((batch, seq + 1)) < dc.noise
    noise = rng.integers(0, vocab, size=(batch, seq + 1))
    return np.where(flips, noise, ramp).astype(np.int32)


def synthetic_batch(step: int, cfg: ArchConfig, dims: Dims, shape: ShapeSpec,
                    dc: DataConfig = DataConfig(),
                    batch_override: Optional[int] = None,
                    seq_override: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Host-side numpy batch for one step (tokens shifted into labels)."""
    b = batch_override or shape.global_batch
    s = seq_override or shape.seq_len
    seqs = _tokens_for_step(step, b, s, cfg.vocab_size, dc)
    batch: Dict[str, np.ndarray] = {"labels": seqs[:, 1:]}
    if cfg.frontend == "text":
        batch["tokens"] = seqs[:, :-1]
    else:
        # stub modality frontend: deterministic pseudo-embeddings derived
        # from the token stream (same shape contract as a real encoder)
        rng = np.random.default_rng(dc.seed * 7_000_003 + step)
        proj = rng.standard_normal((cfg.vocab_size, 1)).astype(np.float32)
        base = proj[seqs[:, :-1], 0]
        phases = np.arange(dims.d_model, dtype=np.float32)[None, None, :]
        emb = np.sin(base[..., None] * 0.1 + phases * 0.01).astype(np.float32)
        batch["embeds"] = emb
    return batch


def data_iterator(cfg: ArchConfig, dims: Dims, shape: ShapeSpec,
                  dc: DataConfig = DataConfig(), start_step: int = 0,
                  batch_override: Optional[int] = None,
                  seq_override: Optional[int] = None) -> Iterator[dict]:
    step = start_step
    while True:
        yield synthetic_batch(step, cfg, dims, shape, dc,
                              batch_override, seq_override)
        step += 1


# ---------------------------------------------------------------------------
# Host sharding
# ---------------------------------------------------------------------------


def host_shard(batch: Dict[str, np.ndarray], mesh, specs,
               device=None) -> Dict[str, torch.Tensor]:
    """Assemble global arrays from (this rank's rows of) a batch.

    ``specs[k]`` lays array ``k`` out on ``mesh`` (``launch/specs.py:
    input_specs``). With one rank ``batch`` is the whole batch and is
    placed by the specs. With several, ``batch`` holds the rows of this
    rank's block of the batch dim (:func:`local_slice` with
    ``sharding.coordinate(specs[k][0], mesh)``); each array is cut to
    this rank's block of its other dims and the global array assembled
    from the local blocks — no rank materializes another's rows."""
    dev = device or mesh.device_type
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v)).to(dev)
        spec = specs[k]
        if not dist.is_initialized() or dist.get_world_size() == 1:
            out[k] = sharding.layout(t, spec, mesh)
            continue
        rows = t.shape[0] * sharding.coordinate(spec[0], mesh)[1]
        out[k] = sharding.from_blocks(sharding.block(t, spec, mesh, first=1),
                                      spec, mesh, (rows, *t.shape[1:]))
    return out


def local_slice(step: int, cfg: ArchConfig, dims: Dims, shape: ShapeSpec,
                dc: DataConfig = DataConfig(), index: Optional[int] = None,
                count: Optional[int] = None,
                batch_override: Optional[int] = None,
                seq_override: Optional[int] = None) -> Dict[str, np.ndarray]:
    """The rows process ``index`` of ``count`` is responsible for
    (default: this rank of the running process group, the reference's
    ``jax.process_index()`` of ``process_count()``; one process holds the
    whole batch)."""
    if index is None or count is None:
        live = dist.is_initialized()
        index = dist.get_rank() if live else 0
        count = dist.get_world_size() if live else 1
    full = synthetic_batch(step, cfg, dims, shape, dc, batch_override,
                           seq_override)
    b_global = next(iter(full.values())).shape[0]
    b_local = max(b_global // count, 1)
    lo = (index * b_local) % b_global
    return {k: v[lo: lo + b_local] for k, v in full.items()}
