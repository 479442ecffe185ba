"""Data pipeline: deterministic synthetic streams (src/repro/data/pipeline.py).

For training/benchmarks we generate deterministic synthetic batches
(seeded per step, so a restarted job resumes on *identical* data —
important for checkpoint/restart tests). The batches are numpy, equal to
the reference's bit for bit; the launcher moves them to the device.

The reference's ``host_shard`` assembles global arrays over a device mesh;
it comes with the multi-device slice. :func:`local_slice` is the single
process's view: the whole batch.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.nn.dims import Dims


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


def local_slice(step: int, cfg: ArchConfig, dims: Dims, shape: ShapeSpec,
                dc: DataConfig = DataConfig()) -> Dict[str, np.ndarray]:
    """The rows this process is responsible for: one process holds the
    whole global batch (the reference with ``jax.process_count() == 1``)."""
    return synthetic_batch(step, cfg, dims, shape, dc)
