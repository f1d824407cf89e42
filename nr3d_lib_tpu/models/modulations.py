"""FiLM-SIREN modulation layers + mapping networks.

Reference: nr3d_lib/models/modulations/ (modulations.py:20-147
ModulatedLayer/Block, filmsiren.py:11-61) — latent z → per-layer
(frequency, phase) FiLM parameters modulating SIREN layers; used by the
generative/style fields.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
from nr3d_lib_tpu import nn

from nr3d_lib_tpu.models.blocks import MLP

__all__ = ["FiLMLayer", "FiLMSiren", "MappingNetwork"]

Array = jax.Array


class FiLMLayer(nn.Module):
    """sin(γ·(Wx+b) + β) (reference filmsiren.py:11 FiLM-SIREN layer)."""

    def __init__(self, in_features: int, out_features: int, *,
                 is_first: bool = False, w0: float = 30.0, seed: int = 0,
                 param_dtype=jnp.float32):
        key = jax.random.key(seed)
        bound = 1.0 / in_features if is_first else math.sqrt(6.0 / in_features) / w0
        self.w = nn.Param(jax.random.uniform(key, (in_features, out_features),
                                              param_dtype, -bound, bound))
        self.b = nn.Param(jnp.zeros((out_features,), param_dtype))
        self.w0 = w0
        self.is_first = is_first

    def __call__(self, x: Array, freq: Array, phase: Array) -> Array:
        h = x @ self.w[...] + self.b[...]
        scale = self.w0 if self.is_first else 1.0
        return jnp.sin(scale * freq * h + phase)


class MappingNetwork(nn.Module):
    """z → per-layer (freq, phase) (reference modulations.py mapping net)."""

    def __init__(self, z_dim: int, n_layers: int, hidden: int, *,
                 map_layers: int = 3, map_hidden: int = 256, seed: int = 0):
        self.n_layers = n_layers
        self.hidden = hidden
        self.mlp = MLP(z_dim, n_layers * hidden * 2, D=map_layers, W=map_hidden,
                       activation="relu", seed=seed)

    def __call__(self, z: Array):
        out = self.mlp(z).reshape(*z.shape[:-1], self.n_layers, 2, self.hidden)
        freq = out[..., 0, :] * 15.0 + 30.0   # pi-GAN-style freq scaling
        phase = out[..., 1, :]
        return freq, phase


class FiLMSiren(nn.Module):
    """Latent-modulated SIREN network (reference modulations.py:20-147)."""

    def __init__(self, in_features: int, out_features: int, z_dim: int, *,
                 D: int = 4, W: int = 128, w0: float = 30.0, seed: int = 0):
        self.layers = nn.List([
            FiLMLayer(in_features if i == 0 else W, W, is_first=(i == 0),
                      w0=w0, seed=seed + i)
            for i in range(D)])
        self.mapping = MappingNetwork(z_dim, D, W, seed=seed + 100)
        self.out = MLP(W, out_features, D=0, W=W, seed=seed + 200)

    def __call__(self, x: Array, z: Array) -> Array:
        freq, phase = self.mapping(z)
        h = x
        for i, layer in enumerate(self.layers):
            f = freq[..., i, :]
            p = phase[..., i, :]
            if f.ndim < h.ndim:
                f = f[..., None, :]
                p = p[..., None, :]
            h = layer(h, f, p)
        return self.out(h)
