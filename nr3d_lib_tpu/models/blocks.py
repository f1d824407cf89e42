"""MLP blocks (reference: nr3d_lib/models/blocks/mlp.py:27-168, models/layers.py).

nn modules with bf16-friendly compute: params live in fp32, the forward
optionally casts to a compute dtype (bf16 replaces the reference's fp16 +
loss-scaling; SURVEY.md §7 table).

Includes the init schemes the fields depend on:
  * geometric (sphere) init for SDF MLPs (reference fields/sdf/utils.py)
  * SIREN init for Sine activations (reference layers.py Sine)
  * Lipshitz-bounded MLP (reference mlp.py:168 LipshitzMLP)
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np
from nr3d_lib_tpu import nn

__all__ = ["get_nonlinearity", "MLP", "LipshitzMLP", "get_blocks"]

Array = jax.Array


def get_nonlinearity(name: Optional[Union[str, Callable]]):
    """Name → activation fn (reference: layers.py:340 get_nonlinearity)."""
    if name is None or callable(name):
        return name
    table = {
        "relu": jax.nn.relu,
        # beta=100 ≈ smooth ReLU — the SDF-decoder standard (reference layers.py:410)
        "softplus": lambda x: jax.nn.softplus(100.0 * x) / 100.0,
        "softplus_raw": jax.nn.softplus,
        "sigmoid": jax.nn.sigmoid, "tanh": jnp.tanh, "elu": jax.nn.elu,
        "gelu": jax.nn.gelu, "silu": jax.nn.silu, "swish": jax.nn.silu,
        "sine": jnp.sin, "identity": None, "none": None, "linear": None,
        "squareplus": lambda x: 0.5 * (x + jnp.sqrt(x * x + 4.0)),
    }
    return table[str(name).lower()]


def _init_linear(key, n_in: int, n_out: int, *, activation: str, is_first: bool,
                 is_last: bool, geometric_init: bool, radius_init: float,
                 sine_w0: float, dtype) -> Tuple[Array, Array]:
    """Weight+bias init covering standard / geometric(SDF-sphere) / SIREN."""
    wk, bk = jax.random.split(key)
    if geometric_init:
        # SAL/IGR geometric init → network ≈ ||x|| - r at start
        # (reference: fields/sdf/utils.py geometric init)
        if is_last:
            mean = math.sqrt(math.pi) / math.sqrt(n_in)
            w = mean + 1e-4 * jax.random.normal(wk, (n_in, n_out), dtype)
            b = jnp.full((n_out,), -radius_init, dtype)
        else:
            std = math.sqrt(2.0) / math.sqrt(n_out)
            w = std * jax.random.normal(wk, (n_in, n_out), dtype)
            b = jnp.zeros((n_out,), dtype)
            if is_first:
                # zero the weights of inputs beyond xyz (latent/extra dims)
                w = w.at[3:, :].set(0.0) if n_in > 3 else w
        return w, b
    if activation == "sine":
        # SIREN init (reference layers.py Sine init)
        bound = (1.0 / n_in) if is_first else (math.sqrt(6.0 / n_in) / sine_w0)
        w = jax.random.uniform(wk, (n_in, n_out), dtype, -bound, bound)
        b = jax.random.uniform(bk, (n_out,), dtype, -1.0, 1.0) / math.sqrt(n_in)
        return w, b
    # lecun-normal default (flax convention)
    std = 1.0 / math.sqrt(n_in)
    w = jax.random.truncated_normal(wk, -2, 2, (n_in, n_out), dtype) * std
    b = jnp.zeros((n_out,), dtype)
    return w, b


class MLP(nn.Module):
    """Plain MLP with optional skip connections.

    reference: blocks/mlp.py:27 (MLP) / :130 (MLPNet with skips).
    """

    def __init__(self, in_features: int, out_features: int, *,
                 D: int = 4, W: int = 128,
                 skips: Sequence[int] = (),
                 activation: str = "relu",
                 output_activation: Optional[str] = None,
                 geometric_init: bool = False, radius_init: float = 0.5,
                 sine_w0: float = 30.0,
                 compute_dtype=None, param_dtype=jnp.float32,
                 rngs: Optional[nn.Rngs] = None, seed: int = 0):
        key = (rngs.params() if rngs is not None else jax.random.key(seed))
        self.in_features = in_features
        self.out_features = out_features
        self.D, self.W = D, W
        self.skips = tuple(skips)
        self.activation_name = activation
        self.activation = get_nonlinearity(activation)
        self.output_activation = get_nonlinearity(output_activation)
        self.sine_w0 = sine_w0
        self.compute_dtype = compute_dtype

        dims = [in_features] + [W] * D + [out_features]
        ws, bs = [], []
        for i in range(len(dims) - 1):
            n_in = dims[i] + (in_features if i in self.skips else 0)
            key, sub = jax.random.split(key)
            w, b = _init_linear(sub, n_in, dims[i + 1], activation=activation,
                                is_first=(i == 0), is_last=(i == len(dims) - 2),
                                geometric_init=geometric_init,
                                radius_init=radius_init, sine_w0=sine_w0,
                                dtype=param_dtype)
            ws.append(nn.Param(w))
            bs.append(nn.Param(b))
        self.ws = nn.List(ws)
        self.bs = nn.List(bs)

    def __call__(self, x: Array) -> Array:
        cdt = self.compute_dtype or x.dtype
        h = x.astype(cdt)
        inp = h
        n = len(self.ws)
        for i in range(n):
            if i in self.skips:
                h = jnp.concatenate([h, inp], -1)
            w = self.ws[i][...].astype(cdt)
            b = self.bs[i][...].astype(cdt)
            h = h @ w + b
            if i < n - 1:
                if self.activation_name == "sine":
                    h = jnp.sin(self.sine_w0 * h) if i == 0 else jnp.sin(h)
                elif self.activation is not None:
                    h = self.activation(h)
        if self.output_activation is not None:
            h = self.output_activation(h)
        return h

    def get_weight_reg(self, norm_type: float = 2.0) -> Array:
        """Per-layer weight norms, stacked (reference blocks/mlp.py
        get_weight_reg) — downstream trainers sum these as a decay loss."""
        return jnp.stack([
            jnp.sum(jnp.abs(w[...]) ** norm_type) ** (1.0 / norm_type)
            for w in self.ws])


class LipshitzMLP(nn.Module):
    """MLP with learnable per-layer Lipschitz bound c_i; weights are row-wise
    rescaled so ‖W‖∞ ≤ softplus(c_i) (reference: blocks/mlp.py:168)."""

    def __init__(self, in_features: int, out_features: int, *,
                 D: int = 4, W: int = 128, activation: str = "relu",
                 output_activation: Optional[str] = None,
                 param_dtype=jnp.float32, rngs: Optional[nn.Rngs] = None,
                 seed: int = 0):
        key = (rngs.params() if rngs is not None else jax.random.key(seed))
        self.activation = get_nonlinearity(activation)
        self.output_activation = get_nonlinearity(output_activation)
        dims = [in_features] + [W] * D + [out_features]
        ws, bs, cs = [], [], []
        for i in range(len(dims) - 1):
            key, sub = jax.random.split(key)
            w, b = _init_linear(sub, dims[i], dims[i + 1], activation=activation,
                                is_first=(i == 0), is_last=(i == len(dims) - 2),
                                geometric_init=False, radius_init=0.0,
                                sine_w0=30.0, dtype=param_dtype)
            ws.append(nn.Param(w))
            bs.append(nn.Param(b))
            ci = jnp.max(jnp.sum(jnp.abs(w), axis=0))
            cs.append(nn.Param(jnp.log(jnp.exp(ci) - 1.0 + 1e-6)[None]))
        self.ws, self.bs, self.cs = nn.List(ws), nn.List(bs), nn.List(cs)

    def lipshitz_bound_full(self) -> Array:
        out = 1.0
        for c in self.cs:
            out = out * jax.nn.softplus(c[...][0])
        return out

    def __call__(self, x: Array) -> Array:
        h = x
        n = len(self.ws)
        for i in range(n):
            w, b = self.ws[i][...], self.bs[i][...]
            bound = jax.nn.softplus(self.cs[i][...][0])
            scale = jnp.minimum(1.0, bound / jnp.maximum(
                jnp.max(jnp.sum(jnp.abs(w), axis=0)), 1e-12))
            h = h @ (w * scale) + b
            if i < n - 1 and self.activation is not None:
                h = self.activation(h)
        if self.output_activation is not None:
            h = self.output_activation(h)
        return h


def get_blocks(in_features: int, out_features: int, *, type: str = "mlp", **kwargs):
    """Block factory (reference: blocks/__init__.py:3-16 get_blocks; every
    block lowers to XLA matmuls, so there is no tcnn variant)."""
    t = type.lower()
    if t in ("mlp", "fcblock"):
        return MLP(in_features, out_features, **kwargs)
    if t == "lipshitz":
        return LipshitzMLP(in_features, out_features, **kwargs)
    raise ValueError(f"Unknown block type: {type}")
