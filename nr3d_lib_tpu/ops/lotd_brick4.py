"""Brick LoTD encoding with 4 bf16-quantized feats/vertex.

Same brick geometry as `ops/lotd_brick.py` (4³ vertices / 3³ cells / same
hashing); each brick row carries 4 features per vertex, so an encoding
with the same total feature count needs half the levels.

Layouts
  * unpacked (param space): f32 [rows, 256], lane u = vertex·4 + f.
    Parameters live and receive gradients here; values are quantized to
    bf16 in the encode (straight-through), cf. the reference's fp16 tables.
  * packed (`pack_table4`): f32 [rows, 128], lane p = vertex·2 + f2 holding
    bits bf16(f=2·f2) | bf16(f=2·f2+1) << 16 — a storage format.

Reference for behavior: csrc/lotd fp16 hash path (lotd_encoding.h); this
is a from-scratch design sharing the brick layout of lotd_brick.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from nr3d_lib_tpu.ops.lotd_brick import (BRICK_W, LANES, BrickMeta,
                                         _corner_weights,
                                         _level_rows_and_lanes,
                                         make_brick_meta,
                                         vertex_grid_to_brick_rows)

__all__ = ["make_brick4_meta", "brick4_encode_xla", "pack_table4",
           "materialize_dense_brick4"]

Array = jax.Array

N_FEAT4 = 4


def make_brick4_meta(lod_res, lod_types, hashmap_rows: int = 4096
                     ) -> BrickMeta:
    """Same brick geometry as the F=2 path (4³ vertices / 3³ cells / same
    hashing — rows just carry 4 feats); ≤4 levels (32 lanes each)."""
    meta = make_brick_meta(lod_res, lod_types, hashmap_rows)
    assert meta.n_levels <= 4, "brick4 packs 32 lanes/level: max 4 levels"
    return meta


# ---------------------------------------------------------------- packing
def pack_table4(t: Array) -> Array:
    """unpacked f32 [rows, 256] → packed f32 [rows, 128] (bf16 pairs)."""
    r = t.shape[0]
    quad = t.reshape(r, 64, 2, 2)                      # [r, vert, f2, half]
    bits = jax.lax.bitcast_convert_type(
        quad.astype(jnp.bfloat16), jnp.uint16).astype(jnp.uint32)
    u32 = bits[..., 0] | (bits[..., 1] << 16)          # [r, 64, 2]
    return jax.lax.bitcast_convert_type(u32, jnp.float32).reshape(r, LANES)


def _quantize4(t: Array) -> Array:
    """Params quantized to bf16, straight-through for gradients (a vjp
    through the cast would round the cotangents to bf16 too)."""
    q = t.astype(jnp.bfloat16).astype(jnp.float32)
    return t + jax.lax.stop_gradient(q - t)


def materialize_dense_brick4(vertex_params: Array, level) -> Array:
    """Canonical vertex params [res³·4] → unpacked brick rows [rows, 256].
    Differentiable; shared boundary vertices stay tied (exact Dense
    semantics, as in lotd_brick.materialize_dense_brick_table)."""
    lanes2 = vertex_grid_to_brick_rows(level)          # [rows,128], F=2 lanes
    flat = lanes2[:, 0::2] // 2                        # [rows, 64] vertex ids
    idx = flat[:, :, None] * 4 + np.arange(4)[None, None, :]
    return vertex_params[jnp.asarray(idx.reshape(-1, 256))]


# -------------------------------------------------------------------- encode
def brick4_encode_xla(x: Array, table: Array, meta: BrickMeta) -> Array:
    """x [N,3] in [0,1] × UNPACKED table [rows, 256] → [N, 4L], with the
    table values bf16-quantized (straight-through)."""
    tq = _quantize4(table)
    outs = []
    for level in meta.levels:
        row, lane0, frac = _level_rows_and_lanes(x, level)
        rows = jnp.take(tq, row, axis=0, mode="clip")            # [N,256]
        vert0 = lane0 // 2
        corner_v = np.asarray(
            [(dx * BRICK_W + dy) * BRICK_W + dz
             for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)], np.int32)
        lanes = (vert0[:, None] + corner_v[None, :]) * 4          # [N,8]
        w = _corner_weights(frac).astype(rows.dtype)              # [N,8]
        for f in range(N_FEAT4):
            vals = jnp.take_along_axis(rows, lanes + f, axis=1)
            outs.append(jnp.sum(w * vals, -1))
    return jnp.stack(outs, axis=-1)
