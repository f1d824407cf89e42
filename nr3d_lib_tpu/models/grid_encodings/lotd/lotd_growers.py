"""LoTD grower family: hypernetworks z → per-instance flattened LoTD params.

Reference: nr3d_lib/models/grid_encodings/lotd/lotd_batched_growers.py:52-753
(Mixed/Dense/Triplane/VMSplit/CP × Flatten/FMM/Conv/Concat). The reference
needs one class per decomposition because torch growers emit tensors shaped
like each factorization; here `LoDMeta` already defines the flattened layout
for every decomposition type, so each grower below works for ANY meta
(Flatten/SharedMod) or derives its per-entry coordinates FROM the meta
layout (FMM), collapsing the reference's per-type class matrix.

Notes: all growers are pure batched matmuls / resizes;
the FMM coordinate network evaluates a FiLM-modulated MLP over the level's
pseudo-coordinate grid with einsum over [B, size, W] activations.

Growers produce params [B, n_params] consumed by `lotd_encode(..., bidx=)`
(the style/batched path, reference style_lotd_sdf.py:229).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np
from nr3d_lib_tpu import nn

from nr3d_lib_tpu.models.blocks import MLP, get_nonlinearity
from nr3d_lib_tpu.ops.lotd import LoDMeta, LoDType

__all__ = ["LoTDFlattenGrower", "LoTDFMMGrower", "LoTDConvGrower",
           "LoTDSharedModGrower", "LoTDMixedGrower", "get_lotd_grower"]

Array = jax.Array


import functools


@functools.lru_cache(maxsize=256)
def _level_entry_coords(meta: LoDMeta, level: int) -> np.ndarray:
    """Pseudo-coordinate in [-1,1]^D for every grid entry of one level,
    following the exact flattened-entry ordering `lotd_encode` indexes
    (ops/lotd.py:_encode_level layout comments). Dropped axes (planes/lines)
    sit at 0. Hash levels have no spatial layout → None (caller substitutes
    a learnable pseudo-input)."""
    t = meta.level_types[level]
    res = meta.level_res[level]
    d = len(res)

    def lin(r):
        return np.linspace(-1.0, 1.0, r, dtype=np.float32) if r > 1 \
            else np.zeros((r,), np.float32)

    def grid(dims):
        axes = np.meshgrid(*[lin(res[j]) for j in dims], indexing="ij")
        flat = np.stack([a.reshape(-1) for a in axes], -1)
        out = np.zeros((flat.shape[0], d), np.float32)
        for k, j in enumerate(dims):
            out[:, j] = flat[:, k]
        return out

    if t == LoDType.Dense or (t == LoDType.Hash and
                              int(np.prod(res)) <= meta.level_sizes[level]):
        return grid(list(range(d)))
    if t == LoDType.Hash:
        return None
    if t in (LoDType.CP, LoDType.CPfast):
        return np.concatenate([grid([a]) for a in range(d)], 0)
    if t in (LoDType.NPlaneSum, LoDType.NPlaneMul):
        return np.concatenate(
            [grid([j for j in range(d) if j != a]) for a in range(d)], 0)
    if t == LoDType.VectorMatrix:
        lines = np.concatenate([grid([a]) for a in range(d)], 0)
        planes = np.concatenate(
            [grid([j for j in range(d) if j != a]) for a in range(d)], 0)
        return np.concatenate([lines, planes], 0)
    if t == LoDType.VecZMatXoY:
        return np.concatenate([grid([2]), grid([0, 1])], 0)
    raise ValueError(t)


class LoTDFlattenGrower(nn.Module):
    """One MLP emitting every level's parameters at once (reference:
    DenseLoTDGrowerFlatten / Triplane…/VMSplit…/CP…Flatten — the meta's
    layout subsumes the per-decomposition variants)."""

    def __init__(self, z_dim: int, meta: LoDMeta, *, D: int = 2, W: int = 256,
                 out_scale: float = 1e-2, seed: int = 0, **_):
        self.meta = meta
        self.out_scale = out_scale
        self.mlp = MLP(z_dim, meta.n_params, D=D, W=W, seed=seed)

    def __call__(self, z: Array, max_level: Optional[int] = None) -> Array:
        p = self.mlp(z) * self.out_scale
        if max_level is not None and max_level < self.meta.n_levels - 1:
            keep = np.zeros((self.meta.n_params,), np.float32)
            keep[:self.meta.level_offsets[max_level + 1]] = 1.0
            p = p * jnp.asarray(keep)
        return p


class _FiLMLayer(nn.Module):
    """Linear layer whose activation is feature-wise modulated by z
    (the reference's ModulatedLayer role, lotd_batched_growers.py:274 FMM)."""

    def __init__(self, in_f: int, out_f: int, z_dim: int, *,
                 activation: str = "relu", seed: int = 0):
        k1, k2, k3 = jax.random.split(jax.random.key(seed), 3)
        s = 1.0 / np.sqrt(in_f)
        self.w = nn.Param(jax.random.uniform(k1, (in_f, out_f),
                                              jnp.float32, -s, s))
        self.b = nn.Param(jnp.zeros((out_f,)))
        sz = 1.0 / np.sqrt(z_dim)
        self.wz = nn.Param(jax.random.uniform(k2, (z_dim, 2 * out_f),
                                               jnp.float32, -sz, sz))
        self.bz = nn.Param(jnp.zeros((2 * out_f,)))
        self.act = get_nonlinearity(activation) or (lambda x: x)
        del k3

    def __call__(self, h: Array, z: Array) -> Array:
        """h [B, S, in_f], z [B, z_dim] → [B, S, out_f]."""
        gb = z @ self.wz[...] + self.bz[...]
        gamma, beta = jnp.split(gb, 2, axis=-1)
        y = h @ self.w[...] + self.b[...]
        y = y * (1.0 + gamma[:, None, :]) + beta[:, None, :]
        return self.act(y)


class LoTDFMMGrower(nn.Module):
    """Feature-wise-modulated coordinate network grower (reference: LoTDFMM,
    lotd_batched_growers.py:274): a shared MLP evaluated on each level's
    pseudo-coordinate grid, FiLM-modulated by z, with a per-level head —
    plus an optional learnable shared base encoding added to every instance
    (`use_shared_encoding`). Hash levels (no spatial layout) get a learnable
    pseudo-input table instead of coordinates."""

    def __init__(self, z_dim: int, meta: LoDMeta, *, D: int = 2, W: int = 64,
                 out_scale: float = 1e-2, use_shared_encoding: bool = True,
                 activation: str = "relu", seed: int = 0, **_):
        self.meta = meta
        self.out_scale = out_scale
        d = meta.n_dims
        self.trunk = nn.List([
            _FiLMLayer(d, W, z_dim, activation=activation, seed=seed),
            *[_FiLMLayer(W, W, z_dim, activation=activation, seed=seed + 1 + i)
              for i in range(D - 1)]])
        self.heads = nn.List([
            _FiLMLayer(W, meta.level_n_feats[l], z_dim, activation="none",
                       seed=seed + 100 + l) for l in range(meta.n_levels)])
        pseudo = {}
        for l in range(meta.n_levels):
            if _level_entry_coords(meta, l) is None:
                pseudo[str(l)] = nn.Param(jax.random.normal(
                    jax.random.key(seed + 200 + l),
                    (meta.level_sizes[l], d)) * 0.5)
        self.pseudo = nn.Dict(pseudo)
        self.shared = nn.Param(jnp.zeros((meta.n_params,))) \
            if use_shared_encoding else None

    def __call__(self, z: Array, max_level: Optional[int] = None) -> Array:
        outs: List[Array] = []
        B = z.shape[0]
        for l in range(self.meta.n_levels):
            if max_level is not None and l > max_level:
                outs.append(jnp.zeros((B, self.meta.level_n_params[l]),
                                      z.dtype))
                continue
            c = _level_entry_coords(self.meta, l)
            x = jnp.asarray(c) if c is not None else self.pseudo[str(l)][...]
            h = jnp.broadcast_to(x[None], (B,) + x.shape)
            for layer in self.trunk:
                h = layer(h, z)
            h = self.heads[l](h, z)                       # [B, size, F]
            outs.append(h.reshape(B, -1) * self.out_scale)
        p = jnp.concatenate(outs, -1)
        if self.shared is not None:
            p = p + self.shared[...]
        return p


class _ModConv(nn.Module):
    """Pointwise (1×1×1) channel map with z modulation — the matmul-friendly
    stand-in for the reference's modulated 3D convs (DenseLoTDGrowerConv):
    spatial mixing comes from the trilinear upsample between blocks, channel
    mixing from this matmul."""

    def __init__(self, in_c: int, out_c: int, z_dim: int, *,
                 activation: str = "lrelu", seed: int = 0):
        k1, k2 = jax.random.split(jax.random.key(seed))
        s = 1.0 / np.sqrt(in_c)
        self.w = nn.Param(jax.random.uniform(k1, (in_c, out_c),
                                              jnp.float32, -s, s))
        self.b = nn.Param(jnp.zeros((out_c,)))
        sz = 1.0 / np.sqrt(z_dim)
        self.wz = nn.Param(jax.random.uniform(k2, (z_dim, in_c),
                                               jnp.float32, -sz, sz))
        self.act = get_nonlinearity(
            "relu" if activation == "lrelu" else activation) or (lambda x: x)

    def __call__(self, h: Array, z: Array) -> Array:
        """h [B, X, Y, Z, C]; style-modulate input channels then mix."""
        style = 1.0 + z @ self.wz[...]                    # [B, in_c]
        y = (h * style[:, None, None, None, :]) @ self.w[...] + self.b[...]
        return self.act(y)


class LoTDConvGrower(nn.Module):
    """Progressive-growing generator (reference: DenseLoTDGrowerConv,
    lotd_batched_growers.py:577): learnable 4³ const → repeated ×2 trilinear
    upsample + modulated channel maps; a per-level head emits that level's
    features, resized to the level's exact resolution. Dense 3D metas only."""

    def __init__(self, z_dim: int, meta: LoDMeta, *, base_channels: int = 32,
                 out_scale: float = 1e-1, seed: int = 0, **_):
        assert meta.n_dims == 3 and all(
            t == LoDType.Dense or (t == LoDType.Hash and
                                   int(np.prod(r)) <= s)
            for t, r, s in zip(meta.level_types, meta.level_res,
                               meta.level_sizes)), \
            "LoTDConvGrower needs dense(ly-stored) 3D levels"
        self.meta = meta
        self.out_scale = out_scale
        C = base_channels
        self.const = nn.Param(jax.random.normal(
            jax.random.key(seed), (4, 4, 4, C)) * 0.1)
        # one upsample block per level beyond the first
        self.blocks = nn.List([_ModConv(C, C, z_dim, seed=seed + 1 + l)
                                for l in range(meta.n_levels)])
        self.heads = nn.List([_ModConv(C, meta.level_n_feats[l], z_dim,
                                        activation="none",
                                        seed=seed + 100 + l)
                               for l in range(meta.n_levels)])

    def __call__(self, z: Array, max_level: Optional[int] = None) -> Array:
        B = z.shape[0]
        h = jnp.broadcast_to(self.const[...][None],
                             (B,) + self.const[...].shape)
        outs: List[Array] = []
        for l in range(self.meta.n_levels):
            if l > 0:  # grow ×2 then refine
                _, X, Y, Z, C = h.shape
                h = jax.image.resize(h, (B, 2 * X, 2 * Y, 2 * Z, C),
                                     "trilinear")
            h = self.blocks[l](h, z)
            if max_level is not None and l > max_level:
                outs.append(jnp.zeros((B, self.meta.level_n_params[l]),
                                      z.dtype))
                continue
            f = self.heads[l](h, z)                       # [B, x, y, z, F]
            res = self.meta.level_res[l]
            f = jax.image.resize(f, (B,) + tuple(res) + (f.shape[-1],),
                                 "trilinear")
            outs.append(f.reshape(B, -1) * self.out_scale)
        return jnp.concatenate(outs, -1)


class LoTDSharedModGrower(nn.Module):
    """Shared base table + per-instance feature-wise modulation (the
    low-parameter end of the reference family — LoTDFMMShared's
    shared-encoding idea, lotd_batched_growers.py:369): every instance reads
    the SAME learnable LoTD table, scaled/shifted per (level, feature) by z.
    O(z_dim·ΣF) grown parameters instead of O(n_params) — the cheapest grower
    that still differentiates instances."""

    def __init__(self, z_dim: int, meta: LoDMeta, *, init_scale: float = 1e-2,
                 seed: int = 0, **_):
        self.meta = meta
        k1, k2 = jax.random.split(jax.random.key(seed))
        self.base = nn.Param(jax.random.uniform(
            k1, (meta.n_params,), jnp.float32, -init_scale, init_scale))
        F = meta.out_features
        sz = 1.0 / np.sqrt(z_dim)
        self.wz = nn.Param(jax.random.uniform(k2, (z_dim, 2 * F),
                                               jnp.float32, -sz, sz))
        self.bz = nn.Param(jnp.zeros((2 * F,)))

    def __call__(self, z: Array, max_level: Optional[int] = None) -> Array:
        gb = z @ self.wz[...] + self.bz[...]
        gamma, beta = jnp.split(gb, 2, axis=-1)           # [B, ΣF]
        outs = []
        for l in range(self.meta.n_levels):
            sl = slice(self.meta.level_offsets[l],
                       self.meta.level_offsets[l + 1])
            fs = slice(self.meta.out_feat_offsets[l],
                       self.meta.out_feat_offsets[l + 1])
            base = self.base[...][sl].reshape(
                self.meta.level_sizes[l], self.meta.level_n_feats[l])
            if max_level is not None and l > max_level:
                outs.append(jnp.zeros(
                    (z.shape[0], self.meta.level_n_params[l]), z.dtype))
                continue
            p = base[None] * (1.0 + gamma[:, None, fs]) + beta[:, None, fs]
            outs.append(p.reshape(z.shape[0], -1))
        return jnp.concatenate(outs, -1)


class LoTDMixedGrower(nn.Module):
    """Different growers over consecutive level ranges (reference:
    MixedLoTDGrower, lotd_batched_growers.py:87): sub-metas are sliced from
    the full meta and each sub-grower's output is concatenated in level
    order — offsets line up because the flattened layout is per-level."""

    def __init__(self, z_dim: int, meta: LoDMeta, *,
                 splits: Sequence[Tuple[int, str, dict]], seed: int = 0, **_):
        """splits: list of (n_levels, grower_type, kwargs) covering meta's
        levels in order."""
        assert sum(s[0] for s in splits) == meta.n_levels
        self.meta = meta
        self.growers = nn.List([])
        self._n_levels = [s[0] for s in splits]
        start = 0
        for i, (n, gtype, kw) in enumerate(splits):
            sub = LoDMeta(meta.n_dims, meta.level_res[start:start + n],
                          meta.level_n_feats[start:start + n],
                          meta.level_types[start:start + n],
                          meta.hashmap_sizes[start:start + n],
                          meta.interpolation)
            self.growers.append(get_lotd_grower(
                gtype, z_dim, sub, seed=seed + 17 * i, **kw))
            start += n

    def __call__(self, z: Array, max_level: Optional[int] = None) -> Array:
        outs, start = [], 0
        for n, g in zip(self._n_levels, self.growers):
            ml = None if max_level is None else max_level - start
            outs.append(g(z, max_level=None if ml is None else max(ml, -1)))
            start += n
        return jnp.concatenate(outs, -1)


_GROWERS = {
    "flatten": LoTDFlattenGrower, "dense": LoTDFlattenGrower,
    "fmm": LoTDFMMGrower,
    "conv": LoTDConvGrower,
    "shared_mod": LoTDSharedModGrower, "concat": LoTDSharedModGrower,
    "mixed": LoTDMixedGrower,
}


def get_lotd_grower(type: str, z_dim: int, meta: LoDMeta, **kwargs):
    """Registry (reference: the import_str-driven grower configs)."""
    t = type.lower()
    if t not in _GROWERS:
        raise ValueError(f"Unknown grower type {type!r}; "
                         f"have {sorted(_GROWERS)}")
    return _GROWERS[t](z_dim, meta, **kwargs)
