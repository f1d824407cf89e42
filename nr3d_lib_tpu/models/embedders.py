"""Direction / position embedders: identity, spherical harmonics, sinusoidal.

Reference: nr3d_lib/models/embedders/__init__.py:8-40 (get_embedder factory),
externals/shencoder (N7: SH fwd/bwd CUDA), externals/freqencoder (N8),
embedders/sinusoidal_pytorch.py:21-87 (SinusoidalEmbedder + Annealed).
These are pure closed-form math — XLA fuses them into the consuming
matmul, so no custom kernels are needed at all.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

__all__ = ["sh_encode", "freq_encode", "annealed_freq_encode", "get_embedder",
           "SHEncoder", "FreqEncoder"]

Array = jax.Array


def sh_encode(dirs: Array, degree: int = 4) -> Array:
    """Real spherical-harmonics basis of unit directions, NGP component order
    (reference: externals/shencoder kernels). degree ∈ [1,4] → 1/4/9/16 dims."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    out = [jnp.full_like(x, 0.28209479177387814)]  # l=0
    if degree > 1:
        out += [-0.48860251190291987 * y,
                0.48860251190291987 * z,
                -0.48860251190291987 * x]
    if degree > 2:
        xy, yz, xz = x * y, y * z, x * z
        x2, y2, z2 = x * x, y * y, z * z
        out += [1.0925484305920792 * xy,
                -1.0925484305920792 * yz,
                0.94617469575755997 * z2 - 0.31539156525251999,
                -1.0925484305920792 * xz,
                0.54627421529603959 * (x2 - y2)]
    if degree > 3:
        out += [0.59004358992664352 * y * (-3.0 * x2 + y2),
                2.8906114426405538 * xy * z,
                0.45704579946446572 * y * (1.0 - 5.0 * z2),
                0.3731763325901154 * z * (5.0 * z2 - 3.0),
                0.45704579946446572 * x * (1.0 - 5.0 * z2),
                1.4453057213202769 * z * (x2 - y2),
                0.59004358992664352 * x * (-x2 + 3.0 * y2)]
    return jnp.stack(out, -1)


def freq_encode(x: Array, n_frequencies: int = 6, include_input: bool = True
                ) -> Array:
    """[sin, cos](2^i·x) fused encoding (reference: externals/freqencoder)."""
    freqs = 2.0 ** jnp.arange(n_frequencies, dtype=x.dtype)       # [F]
    xb = x[..., None] * freqs                                     # [..., D, F]
    enc = jnp.concatenate([jnp.sin(xb), jnp.cos(xb)], -1)         # [..., D, 2F]
    enc = enc.reshape(*x.shape[:-1], -1)
    if include_input:
        enc = jnp.concatenate([x, enc], -1)
    return enc


def annealed_freq_encode(x: Array, n_frequencies: int, alpha: Array,
                         include_input: bool = True) -> Array:
    """Coarse-to-fine windowed frequencies (BARF/Nerfies window; reference:
    sinusoidal_pytorch.py:87 AnnealedSinusoidalEmbedder). alpha ∈ [0, F]."""
    enc = freq_encode(x, n_frequencies, include_input=False)
    d = x.shape[-1]
    bands = jnp.arange(n_frequencies, dtype=x.dtype)
    w = jnp.clip(alpha - bands, 0.0, 1.0)
    w = 0.5 * (1.0 - jnp.cos(math.pi * w))                        # [F]
    # per-dim feature block is [sin(f0..fF) | cos(f0..fF)] → window = [w | w]
    w_full = jnp.tile(jnp.concatenate([w, w]), (d,))
    enc = enc * w_full
    if include_input:
        enc = jnp.concatenate([x, enc], -1)
    return enc


class SHEncoder:
    """Module-style wrapper (reference: sphere_harmonics.py:92 SHEncoder)."""

    def __init__(self, degree: int = 4, input_dim: int = 3):
        assert input_dim == 3
        self.degree = degree
        self.in_features = 3
        self.out_features = degree ** 2

    def __call__(self, dirs: Array) -> Array:
        return sh_encode(dirs, self.degree)


class FreqEncoder:
    """Module-style wrapper (reference: sinusoidal_cuda/freq.py:91 FreqEncoder)."""

    def __init__(self, input_dim: int = 3, n_frequencies: int = 6,
                 include_input: bool = True, annealed: bool = False):
        self.input_dim = input_dim
        self.n_frequencies = n_frequencies
        self.include_input = include_input
        self.annealed = annealed
        self.in_features = input_dim
        self.out_features = input_dim * 2 * n_frequencies + (input_dim if include_input else 0)

    def __call__(self, x: Array, alpha: Optional[Array] = None) -> Array:
        if self.annealed and alpha is not None:
            return annealed_freq_encode(x, self.n_frequencies, alpha, self.include_input)
        return freq_encode(x, self.n_frequencies, self.include_input)


def get_embedder(embed_cfg: Optional[dict] = None, input_dim: int = 3):
    """Embedder factory → (fn, out_features)
    (reference: embedders/__init__.py:8-40 get_embedder)."""
    cfg = dict(embed_cfg or {})
    etype = cfg.pop("type", "identity").lower()
    if etype in ("identity", "none"):
        return (lambda x: x), input_dim
    if etype in ("spherical", "sh", "spherical_harmonics"):
        enc = SHEncoder(degree=cfg.get("degree", 4), input_dim=input_dim)
        return enc, enc.out_features
    if etype in ("sinusoidal", "freq", "frequency"):
        enc = FreqEncoder(input_dim=input_dim,
                          n_frequencies=cfg.get("n_frequencies", 6),
                          include_input=cfg.get("include_input", True),
                          annealed=cfg.get("annealed", False))
        return enc, enc.out_features
    raise ValueError(f"Unknown embedder type: {etype}")
