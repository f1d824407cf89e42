"""Auto-decoder scaffold: latent table + conditioned decoder.

Reference: nr3d_lib/models/autodecoder.py:17 (AutoDecoderMixin) — the
categorical-scene pattern: each object instance owns a latent code; the
shared decoder conditions on it (DeepSDF-style).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from nr3d_lib_tpu import nn

from nr3d_lib_tpu.models.embeddings import Embedding

__all__ = ["AutoDecoderMixin"]

Array = jax.Array


class AutoDecoderMixin(nn.Module):
    """Compose with a conditional field: owns the per-instance latents.

    Usage: subclass/compose, call `get_latent(ins_inds)` and feed the result
    to the conditional field's z input.
    """

    def __init__(self, n_instances: int, latent_dim: int, *,
                 latent_std: float = 0.01, seed: int = 0):
        self.latents = Embedding(n_instances, latent_dim, std=latent_std,
                                 seed=seed)
        self.latent_dim = latent_dim
        self.n_instances = n_instances

    def get_latent(self, ins_inds: Array) -> Array:
        return self.latents(ins_inds)

    def mean_latent(self) -> Array:
        return self.latents.mean_latent()

    def infer_latent_init(self, key) -> Array:
        """Fresh latent for test-time optimization of an unseen instance."""
        return 0.01 * jax.random.normal(key, (self.latent_dim,))

    def state_dict(self):
        return {"latents": self.latents.state_dict()}

    def load_state_dict(self, sd):
        self.latents.load_state_dict(sd["latents"])
