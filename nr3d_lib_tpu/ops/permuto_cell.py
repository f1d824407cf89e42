"""Cell-packed permutohedral encoding.

The plain permuto encode (`ops/permuto.py`, reference csrc/permuto/
permuto_enc_fwd) gathers d+1 narrow rows per (point, level). This module
reads one wide row per (point, level) instead. It applies the brick trick to the simplex lattice: hash the
simplex's **remainder-0 base point** (the cell) to a table row, and give
every one of the cell's 2^(d+1) possible vertex slots its own lane pair in
that row. Any of the (d+1)! simplices of the cell reads its d+1 vertices
from ONE gathered row — vertex k of the simplex selected by rank r sits at
slot bitmask Σ_i [rank_i ≥ d+1−k]·2^i (a popcount-k subset of the d+1
elevated coordinates). Vertices shared between neighboring cells become
independent copies, the same capacity/speed trade the brick hash levels
make (hash features are already collision-discontinuous).

Row layout: 128 lanes = C cells × 2^(d+1) slots × 2 feats, C = 128/(2^{d+2})
(3D: 4 cells/row, 4D: 2, 2D: 8) — no lane is wasted.

Reference for behavior being replaced: csrc/permuto/src/permuto.cpp:46-73 +
permuto_kernels; this is a from-scratch design, not a translation. The
encode is plain XLA (`permuto_cell_encode_xla`), differentiable to any
order by autodiff.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import cached_property
from typing import List, Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from nr3d_lib_tpu.ops.lotd import HASH_PRIMES
from nr3d_lib_tpu.ops.permuto import _simplex_parts

__all__ = ["PermutoCellMeta", "make_permuto_cell_meta",
           "permuto_cell_encode_xla"]

Array = jax.Array


LANES = 128
N_FEAT = 2


@dataclass(frozen=True)
class PermutoCellLevel:
    scale: Tuple[float, ...]          # per-axis lattice scale
    n_rows: int
    row_offset: int
    # dense (collision-free) levels: bijective index over the reachable
    # k-coordinate box instead of a hash — None ⇒ hashed level
    box_lo: Optional[Tuple[int, ...]] = None
    box_dims: Optional[Tuple[int, ...]] = None

    @property
    def kind(self) -> str:
        return "hash" if self.box_dims is None else "dense"


@dataclass(frozen=True)
class PermutoCellMeta:
    n_dims: int
    levels: Tuple[PermutoCellLevel, ...]

    @cached_property
    def n_slots(self) -> int:                      # vertex slots per cell
        return 1 << (self.n_dims + 1)

    @cached_property
    def cells_per_row(self) -> int:
        return LANES // (self.n_slots * N_FEAT)

    @cached_property
    def stride(self) -> int:
        """Lane stride per level: (d+1+pad) vertices × 2 feats, rounded up
        to a power of two."""
        return 1 << math.ceil(math.log2((self.n_dims + 1) * N_FEAT))

    @cached_property
    def vp(self) -> int:                           # padded vertices/level
        return self.stride // N_FEAT

    @cached_property
    def n_levels(self) -> int:
        return len(self.levels)

    @cached_property
    def total_rows(self) -> int:
        return sum(l.n_rows for l in self.levels)

    @cached_property
    def n_params(self) -> int:
        return self.total_rows * LANES

    @cached_property
    def out_features(self) -> int:
        return N_FEAT * self.n_levels


def _k_ranges(n_dims: int, scale: Tuple[float, ...]
              ) -> Tuple[List[int], List[int]]:
    """Per-coordinate integer range [lo_i, hi_i] of rem0_i/(d+1) over
    x ∈ [0,1]^d at this lattice scale.

    The elevation (`ops/permuto.py:_simplex_parts`) is linear with
    nonnegative inputs cf_j ∈ [0, scale_j·sf_j], so each elevated
    coordinate's extrema come from its coefficient signs
    (elevated_i = Σ_{j≥i} cf_j − i·cf_{i−1}); rem0_i/(d+1) then lies in
    the rounded range ±1 (the ±(d+1) sum fix-up moves one k unit)."""
    d = n_dims
    dp1 = d + 1
    inv_std = dp1 * math.sqrt(2.0 / 3.0)
    sf = [inv_std / math.sqrt((i + 1) * (i + 2)) for i in range(d)]
    cfmax = [scale[i] * sf[i] for i in range(d)]
    los, his = [], []
    for i in range(dp1):
        mx = sum(cfmax[i:])
        mn = -i * cfmax[i - 1] if i > 0 else 0.0
        los.append(math.floor(mn / dp1 + 0.5) - 1)
        his.append(math.ceil(mx / dp1 - 0.5) + 1)
    return los, his


def make_permuto_cell_meta(n_dims: int,
                           res_list: Sequence[Union[float, Sequence[float]]],
                           hashmap_rows: int = 4096,
                           auto_dense: bool = True) -> PermutoCellMeta:
    """hashmap_rows: rows per level (capacity = rows · cells_per_row cells,
    each holding 2^(d+1) vertex-feature pairs).

    With auto_dense (default), a coarse level whose reachable k-coordinate
    box (`_k_ranges`, first d coords — the hashed ones) fits within the
    hashmap capacity becomes a **dense** level: cell → row is a bijective
    box index instead of a hash. Strictly better than hashing on both
    axes — zero collisions (the all-hash reference permuto collides even
    at coarse levels) and ≤ as many rows. Mirrors the LoTD brick
    Dense/Hash split (`ops/lotd_brick.py`)."""
    if not 2 <= n_dims <= 5:
        raise ValueError(f"n_dims must be in [2, 5], got {n_dims}")
    levels: List[PermutoCellLevel] = []
    off = 0
    for s in res_list:
        scale = (float(s),) * n_dims if np.isscalar(s) \
            else tuple(float(v) for v in s)
        rows = int(hashmap_rows)
        box_lo = box_dims = None
        if auto_dense:
            meta_tmp = PermutoCellMeta(n_dims, ())
            c = meta_tmp.cells_per_row
            los, his = _k_ranges(n_dims, scale)
            dims = [hi - lo + 1 for lo, hi in zip(los[:-1], his[:-1])]
            n_cells = 1
            for w in dims:
                n_cells *= w
                if n_cells > int(hashmap_rows) * c:
                    break
            if n_cells <= int(hashmap_rows) * c:
                box_lo = tuple(los[:-1])
                box_dims = tuple(dims)
                rows = max(1, -(-n_cells // c))
        levels.append(PermutoCellLevel(scale, rows, off, box_lo, box_dims))
        off += rows
    return PermutoCellMeta(n_dims, tuple(levels))


# ------------------------------------------------------------------ indexing
def _level_rows_lanes_bary(x: Array, level: PermutoCellLevel,
                           meta: PermutoCellMeta):
    """Per-point (row [N] i32, lane of vertex-k feat-0 [N, Vp] i32,
    bary [N, Vp]) for one level; k ≥ d+1 slots get bary 0."""
    d = meta.n_dims
    scaled = x * jnp.asarray(level.scale, x.dtype)
    rem0, rank, bary = _simplex_parts(scaled, d)          # [N,d+1] each
    rem0_i = jax.lax.stop_gradient(rem0).astype(jnp.int32)
    c = meta.cells_per_row
    if level.box_dims is not None:
        # dense level: bijective index over the reachable k-coordinate box
        # (zero collisions; rem0 coords are exact multiples of d+1)
        k = rem0_i // (d + 1)                              # [N, d+1]
        idx = jnp.zeros(k.shape[:-1], jnp.int32)
        for i in range(d):                                 # first d coords
            ki = jnp.clip(k[..., i] - level.box_lo[i], 0,
                          level.box_dims[i] - 1)
            idx = idx * level.box_dims[i] + ki
    else:
        h = rem0_i[..., 0].astype(jnp.uint32) * jnp.uint32(HASH_PRIMES[0])
        for i in range(1, d):                              # first d coords
            h = h ^ (rem0_i[..., i].astype(jnp.uint32)
                     * jnp.uint32(HASH_PRIMES[i % 7]))
        idx = (h % jnp.uint32(level.n_rows * c)).astype(jnp.int32)
    row = idx // c + level.row_offset
    lane_base = (idx % c) * (meta.n_slots * N_FEAT)        # [N]

    dp1 = d + 1
    ks = jnp.arange(dp1, dtype=jnp.int32)                  # vertex index k
    cond = rank[:, None, :] >= (dp1 - ks[None, :, None])   # [N,d+1,d+1]
    slot = jnp.sum(cond.astype(jnp.int32)
                   * (1 << jnp.arange(dp1, dtype=jnp.int32))[None, None, :],
                   axis=-1)                                # [N, d+1]
    lane = lane_base[:, None] + slot * N_FEAT              # [N, d+1]
    vp = meta.vp
    if vp > dp1:
        lane = jnp.pad(lane, ((0, 0), (0, vp - dp1)))
        bary = jnp.pad(bary, ((0, 0), (0, vp - dp1)))
    return row.astype(jnp.int32), lane.astype(jnp.int32), bary, rank


# -------------------------------------------------------------------- encode
def permuto_cell_encode_xla(x: Array, table: Array, meta: PermutoCellMeta,
                            level_weights: Optional[Array] = None) -> Array:
    """Cell-layout encode: x [N,d] in [0,1] × table [total_rows, 128] →
    [N, 2L]."""
    outs = []
    for li, level in enumerate(meta.levels):
        row, lane, bary, _ = _level_rows_lanes_bary(x, level, meta)
        rows = jnp.take(table, row, axis=0, mode="clip")   # [N,128]
        f0 = jnp.take_along_axis(rows, lane, axis=1)       # [N,Vp]
        f1 = jnp.take_along_axis(rows, lane + 1, axis=1)
        w = bary.astype(rows.dtype)
        y0 = jnp.sum(w * f0, -1)
        y1 = jnp.sum(w * f1, -1)
        if level_weights is not None:
            y0 = y0 * level_weights[li].astype(y0.dtype)
            y1 = y1 * level_weights[li].astype(y1.dtype)
        outs.append(y0)
        outs.append(y1)
    return jnp.stack(outs, axis=-1)
