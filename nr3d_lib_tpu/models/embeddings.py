"""Latent embeddings: per-instance / per-frame / per-sequence codes.

Reference: nr3d_lib/models/embeddings/ — `Embedding` (embedding.py:18),
`SeqEmbedding`, `MultiSeqEmbeddingShared/Individual` (sequential.py:22-216).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
from nr3d_lib_tpu import nn

__all__ = ["Embedding", "SeqEmbedding", "MultiSeqEmbeddingShared",
           "MultiSeqEmbeddingIndividual"]

Array = jax.Array


class Embedding(nn.Module):
    """Learnable code table [n, dim] (reference embedding.py:18)."""

    def __init__(self, num_embeddings: int, dim: int, *, std: float = 0.01,
                 seed: int = 0, dtype=jnp.float32):
        self.num_embeddings = num_embeddings
        self.dim = dim
        self.weight = nn.Param(
            std * jax.random.normal(jax.random.key(seed), (num_embeddings, dim),
                                    dtype))

    def __call__(self, idx: Array) -> Array:
        return self.weight[...][idx]

    def mean_latent(self) -> Array:
        return jnp.mean(self.weight[...], axis=0)

    def state_dict(self):
        return {"weight": self.weight[...]}

    def load_state_dict(self, sd):
        self.weight[...] = jnp.asarray(sd["weight"])


class SeqEmbedding(Embedding):
    """Per-timestep codes with fractional-time interpolation
    (reference sequential.py:22 SeqEmbedding)."""

    def __call__(self, ts: Array) -> Array:
        """ts: float in [0, n-1] → linearly interpolated code."""
        w = self.weight[...]
        t0 = jnp.clip(jnp.floor(ts).astype(jnp.int32), 0, self.num_embeddings - 1)
        t1 = jnp.clip(t0 + 1, 0, self.num_embeddings - 1)
        frac = (ts - t0.astype(ts.dtype))[..., None]
        return w[t0] * (1 - frac) + w[t1] * frac


class MultiSeqEmbeddingShared(nn.Module):
    """Multiple sequences sharing one per-frame table
    (reference sequential.py:104)."""

    def __init__(self, n_frames: int, dim: int, **kw):
        self.frame_embedding = SeqEmbedding(n_frames, dim, **kw)

    def __call__(self, seq_idx: Array, ts: Array) -> Array:
        del seq_idx
        return self.frame_embedding(ts)


class MultiSeqEmbeddingIndividual(nn.Module):
    """Per-sequence AND per-frame codes concatenated
    (reference sequential.py:216)."""

    def __init__(self, n_seqs: int, n_frames: int, seq_dim: int, frame_dim: int,
                 *, seed: int = 0, **kw):
        self.seq_embedding = Embedding(n_seqs, seq_dim, seed=seed, **kw)
        self.frame_embedding = SeqEmbedding(n_frames, frame_dim, seed=seed + 1, **kw)

    def __call__(self, seq_idx: Array, ts: Array) -> Array:
        return jnp.concatenate([self.seq_embedding(seq_idx),
                                self.frame_embedding(ts)], -1)
