"""Brick-layout LoTD encoding.

Layout: a 4×4×4-vertex **brick** (64 vertices × 2 feats) is one 128-wide
table row, so one row gather per (point, level) fetches all eight
interpolation corners. Bricks cover 3×3×3 cells and overlap by one vertex
plane so every cell's corners live in a single brick.

  * Dense levels: bricks laid out in C order; canonical parameters remain
    the vertex grid — the brick table is materialized by a (cheap,
    table-sized) gather, so shared boundary vertices stay tied and the
    encoding is exactly the reference Dense function.
  * Hash levels: the spatial hash operates on **bricks** (NGP XOR-primes on
    brick coords). Parameters ARE brick rows; boundary vertices between
    bricks are independent copies (a deliberate capacity/speed trade — NGP
    hash features are already collision-discontinuous; PSNR parity is
    validated in tests).

The encode is plain XLA (`brick_encode_xla`), differentiable to any order
by autodiff. Reference for the behavior: csrc/lotd (kernel_lod Dense/Hash
paths); this file is a from-scratch design, not a translation.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import cached_property
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from nr3d_lib_tpu.ops.lotd import HASH_PRIMES

__all__ = ["BrickMeta", "make_brick_meta", "brick_encode_xla",
           "materialize_dense_brick_table",
           "vertex_grid_to_brick_rows", "BRICK_W", "LANES"]

Array = jax.Array

BRICK_W = 4           # vertices per axis in a brick
BRICK_CELLS = 3       # cells per axis covered (stride)
LANES = 128
N_FEAT = 2            # features per vertex (lane pairs)


@dataclass(frozen=True)
class BrickLevel:
    res: Tuple[int, int, int]        # vertex resolution per axis
    kind: str                        # 'dense' | 'hash'
    n_rows: int                      # brick rows in the table
    bricks_per_axis: Tuple[int, int, int]
    row_offset: int                  # into the concatenated table


@dataclass(frozen=True)
class BrickMeta:
    levels: Tuple[BrickLevel, ...]

    @cached_property
    def total_rows(self) -> int:
        return sum(l.n_rows for l in self.levels)

    @cached_property
    def n_params(self) -> int:
        return self.total_rows * LANES

    @cached_property
    def n_levels(self) -> int:
        return len(self.levels)

    @cached_property
    def out_features(self) -> int:
        return N_FEAT * len(self.levels)


def _bricks_per_axis(res: Sequence[int]) -> Tuple[int, ...]:
    # cells 0..res-2 → brick index cell//3 ∈ [0, ceil((res-1)/3))
    return tuple(int(math.ceil((r - 1) / BRICK_CELLS)) for r in res)


def make_brick_meta(lod_res: Sequence, lod_types: Sequence[str],
                    hashmap_rows: int = 4096) -> BrickMeta:
    """hashmap_rows: rows per hash level (capacity = rows·64 vertices)."""
    levels: List[BrickLevel] = []
    offset = 0
    for res, t in zip(lod_res, lod_types):
        if np.isscalar(res):
            res = (int(res),) * 3
        res = tuple(int(v) for v in res)
        bpa = _bricks_per_axis(res)
        t = t.lower()
        if t == "dense":
            n_rows = int(np.prod(bpa))
        elif t == "hash":
            n_rows = min(int(hashmap_rows), int(np.prod(bpa)))
            if n_rows == int(np.prod(bpa)):
                t = "dense"  # small enough: collision-free
        else:
            raise ValueError(f"brick backend supports Dense/Hash, got {t}")
        levels.append(BrickLevel(res, t, n_rows, bpa, offset))
        offset += n_rows
    return BrickMeta(tuple(levels))


# ------------------------------------------------------------------ indexing
def _level_rows_and_lanes(x: Array, level: BrickLevel):
    """Per-point brick row index, base corner lane, and fractional coords.

    x: [N, 3] in [0,1] (reference kernel convention, scale = res-2).
    Returns (row [N] int32, lane0 [N] int32, frac [N,3]).
    """
    res = jnp.asarray(level.res, x.dtype)
    v = x * (res - 2) + 0.5
    cell = jnp.floor(v)
    frac = v - jax.lax.stop_gradient(cell)
    cell = jnp.clip(cell.astype(jnp.int32), 0,
                    jnp.asarray([r - 2 for r in level.res]))
    brick = cell // BRICK_CELLS
    local = cell - brick * BRICK_CELLS            # ∈ [0, 2]
    bpa = level.bricks_per_axis
    brick = jnp.minimum(brick, jnp.asarray([b - 1 for b in bpa]))
    if level.kind == "dense":
        row = (brick[..., 0] * bpa[1] + brick[..., 1]) * bpa[2] + brick[..., 2]
    else:
        h = brick[..., 0].astype(jnp.uint32) * jnp.uint32(HASH_PRIMES[0])
        h = h ^ (brick[..., 1].astype(jnp.uint32) * jnp.uint32(HASH_PRIMES[1]))
        h = h ^ (brick[..., 2].astype(jnp.uint32) * jnp.uint32(HASH_PRIMES[2]))
        row = (h % jnp.uint32(level.n_rows)).astype(jnp.int32)
    lane0 = ((local[..., 0] * BRICK_W + local[..., 1]) * BRICK_W
             + local[..., 2]) * N_FEAT
    return row.astype(jnp.int32) + level.row_offset, lane0.astype(jnp.int32), frac


# corner lane offsets: corner (dx,dy,dz) → lane delta
_CORNER_OFF = np.asarray(
    [((dx * BRICK_W + dy) * BRICK_W + dz) * N_FEAT
     for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)], np.int32)  # [8]
_CORNER_BITS = np.asarray([(dx, dy, dz) for dx in (0, 1) for dy in (0, 1)
                           for dz in (0, 1)], np.float32)            # [8,3]


def _corner_weights(frac: Array) -> Array:
    """[N,3] → [N,8] trilinear weights."""
    cb = jnp.asarray(_CORNER_BITS, frac.dtype)                       # [8,3]
    w = frac[..., None, :] * cb + (1.0 - frac[..., None, :]) * (1.0 - cb)
    return jnp.prod(w, axis=-1)


# -------------------------------------------------------------------- encode
def brick_encode_xla(x: Array, table: Array, meta: BrickMeta,
                     bidx: Optional[Array] = None) -> Array:
    """Brick LoTD encode: x [N,3] in [0,1] × table [total_rows, 128] →
    [N, 2·L].

    With `bidx` (forest / batched scenes) the table is [B·total_rows, 128]
    and block b owns rows [b·total_rows, (b+1)·total_rows); bidx < 0 clamps
    to block 0 — callers mask those points."""
    outs = []
    for level in meta.levels:
        row, lane0, frac = _level_rows_and_lanes(x, level)
        if bidx is not None:
            row = row + jnp.maximum(bidx, 0).astype(jnp.int32) * meta.total_rows
        rows = jnp.take(table, row, axis=0, mode="clip")             # [N,128]
        lanes = lane0[:, None] + jnp.asarray(_CORNER_OFF)[None, :]   # [N,8]
        f0 = jnp.take_along_axis(rows, lanes, axis=1)                # [N,8]
        f1 = jnp.take_along_axis(rows, lanes + 1, axis=1)
        w = _corner_weights(frac).astype(rows.dtype)                 # [N,8]
        outs.append(jnp.sum(w * f0, -1))
        outs.append(jnp.sum(w * f1, -1))
    return jnp.stack(outs, axis=-1)


# ----------------------------------------------------- dense materialization
def vertex_grid_to_brick_rows(level: BrickLevel) -> np.ndarray:
    """For a dense level: flat vertex index for every (row, lane) slot →
    [n_rows, 128] int32 (clamped at borders). Used to materialize the brick
    table from canonical vertex parameters so boundary vertices stay tied."""
    bx, by, bz = level.bricks_per_axis
    rx, ry, rz = level.res
    bxs, bys, bzs = np.meshgrid(np.arange(bx), np.arange(by), np.arange(bz),
                                indexing="ij")
    base = np.stack([bxs, bys, bzs], -1).reshape(-1, 1, 3) * BRICK_CELLS
    lx, ly, lz = np.meshgrid(np.arange(BRICK_W), np.arange(BRICK_W),
                             np.arange(BRICK_W), indexing="ij")
    local = np.stack([lx, ly, lz], -1).reshape(1, -1, 3)
    v = base + local                                                  # [R,64,3]
    v = np.minimum(v, np.asarray([rx - 1, ry - 1, rz - 1]))
    flat = (v[..., 0] * ry + v[..., 1]) * rz + v[..., 2]              # [R,64]
    lanes = np.zeros((flat.shape[0], LANES), np.int32)
    lanes[:, 0::2] = flat * N_FEAT
    lanes[:, 1::2] = flat * N_FEAT + 1
    return lanes


def materialize_dense_brick_table(vertex_params: Array, level: BrickLevel
                                  ) -> Array:
    """Canonical vertex params [res³·2] → brick rows [n_rows, 128].

    Differentiable: gradients flow back and ACCUMULATE onto shared vertices,
    keeping the encoding C0 like the reference Dense type."""
    idx = jnp.asarray(vertex_grid_to_brick_rows(level))
    return vertex_params[idx]
