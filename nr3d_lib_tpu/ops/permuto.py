"""Permutohedral-lattice hash encoding (functional core).

Re-design of the reference's CUDA permuto encoding
(reference: csrc/permuto/ — permuto_enc_fwd/bwd/bwd_bwd_input,
PermutoEncMeta csrc/permuto/src/permuto.cpp:46-73; python wrappers
nr3d_lib/models/grid_encodings/permuto/permuto.py:90-293). The lattice
needs only d+1 simplex-corner gathers per level instead of 2^d — the
reference ships it for high-dim inputs (3D+time, latent-conditioned).

Math follows the classic permutohedral lattice construction (Adams et al.
"Fast High-Dimensional Filtering Using the Permutohedral Lattice", as used
by permuto-sdf): elevate to the sum-zero hyperplane, round to the nearest
remainder-0 point, rank the differential to find the enclosing simplex,
barycentric-weight the d+1 vertices, hash each vertex. Pure XLA: derivative
of any order via autodiff (the reference hand-writes 1st+2nd-order kernels).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import cached_property
from typing import Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from nr3d_lib_tpu.ops.lotd import HASH_PRIMES

__all__ = ["PermutoEncMeta", "make_permuto_meta", "permuto_encode",
           "permuto_enc_fwd_dydx", "permuto_enc_bwd_dydx"]

Array = jax.Array


@dataclass(frozen=True)
class PermutoEncMeta:
    """Static metadata (reference: PermutoEncMeta — level scales, feats,
    hashmap sizes; csrc/permuto/src/permuto.cpp:46-73)."""

    n_dims: int
    level_scales: Tuple[Tuple[float, ...], ...]   # [L][D] per-axis scales
    level_n_feats: Tuple[int, ...]
    hashmap_sizes: Tuple[int, ...]

    @cached_property
    def n_levels(self) -> int:
        return len(self.level_scales)

    @cached_property
    def level_n_params(self) -> Tuple[int, ...]:
        return tuple(s * f for s, f in zip(self.hashmap_sizes, self.level_n_feats))

    @cached_property
    def level_offsets(self) -> Tuple[int, ...]:
        out = [0]
        for p in self.level_n_params:
            out.append(out[-1] + p)
        return tuple(out)

    @cached_property
    def n_params(self) -> int:
        return self.level_offsets[-1]

    @cached_property
    def out_features(self) -> int:
        return int(sum(self.level_n_feats))


def make_permuto_meta(n_dims: int,
                      res_list: Sequence[Union[float, Sequence[float]]],
                      n_feats: Union[int, Sequence[int]] = 2,
                      log2_hashmap_size: int = 18) -> PermutoEncMeta:
    """res_list: per-level lattice scale (≈ resolution), scalar or per-dim
    ("multidim", reference level_scales_multidim)."""
    n_levels = len(res_list)
    if isinstance(n_feats, int):
        n_feats = [n_feats] * n_levels
    scales = tuple(
        tuple([float(s)] * n_dims) if np.isscalar(s) else tuple(float(v) for v in s)
        for s in res_list)
    hsize = 2 ** log2_hashmap_size
    return PermutoEncMeta(n_dims, scales, tuple(int(f) for f in n_feats),
                          tuple([hsize] * n_levels))


# ---------------------------------------------------------------- lattice math
def _simplex_parts(x: Array, d: int):
    """x: [N, d] (already scaled) → (rem0 [N,d+1] float, rank [N,d+1] int32,
    bary [N,d+1]).

    The enclosing simplex's remainder-0 base point, the rank permutation
    selecting which of the (d+1)! simplices of the rem0 cell contains x,
    and the barycentric weights of its d+1 vertices. Shared by the direct
    XLA encode (`permuto_encode`) and the cell-packed fast path
    (`ops/permuto_cell.py`)."""
    n = x.shape[0]
    # elevate onto the sum-zero hyperplane H_d ⊂ R^{d+1}
    inv_std = (d + 1) * math.sqrt(2.0 / 3.0)
    sf = jnp.asarray([1.0 / math.sqrt((i + 1) * (i + 2)) for i in range(d)],
                     x.dtype) * inv_std
    cf = x * sf                                              # [N, d]
    # elevated[i] = sum_{j>=i} cf[j] - i*cf[i-1]  (classic recurrence)
    rev_cumsum = jnp.cumsum(cf[:, ::-1], axis=-1)[:, ::-1]   # Σ_{j>=i} cf_j
    elevated = jnp.zeros((n, d + 1), x.dtype)
    elevated = elevated.at[:, 0].set(rev_cumsum[:, 0])
    for i in range(1, d + 1):
        tail = rev_cumsum[:, i] if i < d else jnp.zeros((n,), x.dtype)
        elevated = elevated.at[:, i].set(tail - i * cf[:, i - 1])

    # nearest remainder-0 point: round each coord to a multiple of d+1
    dp1 = d + 1
    v = elevated / dp1
    up = jnp.ceil(v) * dp1
    down = jnp.floor(v) * dp1
    rem0 = jnp.where(up - elevated < elevated - down, up, down)
    rem0 = jax.lax.stop_gradient(rem0)
    sum_ = jnp.round(jnp.sum(rem0, -1) / dp1).astype(jnp.int32)   # [N]

    # rank the differential
    diff = elevated - rem0                                        # [N, d+1]
    gt = (diff[:, :, None] < diff[:, None, :])                    # [N,d+1,d+1]
    ii = np.arange(dp1)
    upper = jnp.asarray((ii[:, None] < ii[None, :]).astype(np.int32))
    # rank[i] = #{j : diff[i] < diff[j]} with index tie-break
    tie = (diff[:, :, None] == diff[:, None, :]) & jnp.asarray(
        ii[:, None] > ii[None, :])
    rank = jnp.sum((gt | tie).astype(jnp.int32), axis=-1)         # [N, d+1]

    # fix points whose remainder sum ≠ 0
    rank = rank + sum_[:, None]
    low = rank < 0
    high = rank > d
    rank = jnp.where(low, rank + dp1, jnp.where(high, rank - dp1, rank))
    rem0 = rem0 + jnp.where(low, dp1, 0.0) - jnp.where(high, dp1, 0.0)

    # barycentric coordinates from the sorted differential, by one-hot
    # arithmetic instead of per-point scatter-adds.
    vdiff = (elevated - rem0) / dp1                               # [N, d+1]
    j = jnp.arange(dp1 + 1, dtype=jnp.int32)                      # [d+2]
    oh1 = ((d - rank)[..., None] == j).astype(x.dtype)            # [N,d+1,d+2]
    oh2 = ((dp1 - rank)[..., None] == j).astype(x.dtype)
    bary_full = jnp.sum((oh1 - oh2) * vdiff[..., None], axis=1)   # [N, d+2]
    b0 = bary_full[:, 0] + 1.0 + bary_full[:, dp1]
    bary = jnp.concatenate([b0[:, None], bary_full[:, 1:dp1]], -1)
    return rem0, rank, bary


def _simplex(x: Array, d: int):
    """x: [N, d] (already scaled) → (keys [N, d+1, d] int32, bary [N, d+1]).

    The d+1 enclosing lattice vertices (their first d coordinates) and
    barycentric weights.
    """
    rem0, rank, bary = _simplex_parts(x, d)
    dp1 = d + 1
    # the d+1 simplex vertices: vertex k has key[i] = rem0[i] + canonical
    # offset: +k where rank[i] < d+1-k else k-(d+1)
    ks = jnp.arange(dp1)[None, :, None]                           # [1,d+1,1]
    cond = rank[:, None, :] >= (dp1 - ks)                         # [N,d+1,d+1]
    keys = rem0[:, None, :] + ks - jnp.where(cond, dp1, 0)
    return keys[:, :, :d].astype(jnp.int32), bary


def _hash_keys(keys: Array, hashmap_size: int) -> Array:
    """keys: [..., d] lattice coords → hash indices."""
    h = keys[..., 0].astype(jnp.uint32) * jnp.uint32(HASH_PRIMES[0])
    for i in range(1, keys.shape[-1]):
        h = h ^ (keys[..., i].astype(jnp.uint32) * jnp.uint32(HASH_PRIMES[i % 7]))
    return (h % jnp.uint32(hashmap_size)).astype(jnp.int32)


def permuto_encode(x: Array, params: Array, meta: PermutoEncMeta,
                   level_weights: Optional[Array] = None,
                   max_level: Optional[Union[int, Array]] = None) -> Array:
    """x: [N, D] in [0,1]-ish input space; params: [n_params] flat.

    Returns [N, Σ n_feats]. Fully differentiable (all orders).
    """
    d = meta.n_dims
    assert x.shape[-1] == d
    outs = []
    for l in range(meta.n_levels):
        scale = jnp.asarray(meta.level_scales[l], x.dtype)
        keys, bary = _simplex(x * scale, d)                      # [N,d+1,d],[N,d+1]
        idx = _hash_keys(keys, meta.hashmap_sizes[l])            # [N, d+1]
        nf = meta.level_n_feats[l]
        off = meta.level_offsets[l]
        table = jax.lax.dynamic_slice_in_dim(
            params, off, meta.level_n_params[l]).reshape(meta.hashmap_sizes[l], nf)
        feats = jnp.take(table, idx, axis=0, mode="clip")        # [N, d+1, nf]
        y = jnp.sum(bary[..., None].astype(feats.dtype) * feats, axis=1)
        if max_level is not None:
            y = y * (jnp.asarray(l) <= max_level).astype(y.dtype)
        if level_weights is not None:
            y = y * level_weights[l].astype(y.dtype)
        outs.append(y)
    return jnp.concatenate(outs, axis=-1)


def permuto_enc_fwd_dydx(x: Array, params: Array, meta: PermutoEncMeta, **kw
                         ) -> Tuple[Array, Array]:
    """Forward + dy/dx (API parity: PermutoEncFunction fwd with grads,
    reference permuto.py:90)."""
    def f(xx):
        return permuto_encode(xx, params, meta, **kw)

    y = f(x)
    tangents = []
    for dim in range(meta.n_dims):
        seed = jnp.zeros_like(x).at[..., dim].set(1.0)
        _, dy = jax.jvp(f, (x,), (seed,))
        tangents.append(dy)
    return y, jnp.stack(tangents, -1)


def permuto_enc_bwd_dydx(dL_dy: Array, dy_dx: Array) -> Array:
    """nablas (API parity: PermutoEncBwdInputFunction, reference
    permuto.py:168); backward through this is plain autodiff."""
    return jnp.einsum("...f,...fd->...d", dL_dy, dy_dx)
