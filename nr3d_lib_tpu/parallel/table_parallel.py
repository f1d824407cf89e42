"""Table-parallel (model-sharded) grid encodings.

Street-scale scenes want hash tables larger than one chip's HBM — the
reference scales by splitting the FOREST over blocks; the mesh-native axis
is the device mesh: shard the encoding TABLE's rows over a mesh axis and
let the compiler ride ICI.

Key property that makes this cheap: every (point, level) lookup in the
brick / cell-packed layouts touches exactly ONE table row (ops/
lotd_brick.py, ops/permuto_cell.py), so each contribution is owned by
exactly one shard — a shard computes its owned contributions (zeros
elsewhere) and one `psum` over the model axis reconstructs the full
feature vector. Gradients flow through `shard_map` untouched: the `take`
vjp scatters dL/dtable onto the owning shard and the psum vjp is a
broadcast, so dtable stays sharded end to end — no all_gather of the
table, ever.

Points may simultaneously be sharded over a `data` axis (2D mesh DP × TP);
the psum runs over the model axis only.

Reference scale anchor: nr3d_lib forest LoTD shares one params blob across
blocks on one GPU (lotd_forest.py); this module is the multi-chip
replacement, not a translation.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from nr3d_lib_tpu.ops.lotd_brick import (BrickMeta, LANES,
                                         _corner_weights, _CORNER_OFF,
                                         _level_rows_and_lanes)

__all__ = ["pad_table_for_sharding", "brick_encode_table_sharded"]

Array = jax.Array


def pad_table_for_sharding(table: Array, n_shards: int) -> Array:
    """Pad rows up to a multiple of n_shards (padding rows are never
    addressed: row indices stay < meta.total_rows)."""
    rows = table.shape[0]
    target = -(-rows // n_shards) * n_shards
    if target != rows:
        table = jnp.pad(table, ((0, target - rows), (0, 0)))
    return table


def _local_contribution(x: Array, tshard: Array, meta: BrickMeta,
                        shard_idx: Array) -> Array:
    """Features using only rows owned by this shard ([N, 2L]); rows owned
    elsewhere contribute exact zeros."""
    rows_local = tshard.shape[0]
    base = shard_idx * rows_local
    outs = []
    for level in meta.levels:
        row, lane0, frac = _level_rows_and_lanes(x, level)
        local = row - base
        ok = (local >= 0) & (local < rows_local)
        rows = jnp.take(tshard, jnp.clip(local, 0, rows_local - 1),
                        axis=0, mode="clip")
        rows = jnp.where(ok[:, None], rows, 0.0)
        lanes = lane0[:, None] + jnp.asarray(_CORNER_OFF)[None, :]
        f0 = jnp.take_along_axis(rows, lanes, axis=1)
        f1 = jnp.take_along_axis(rows, lanes + 1, axis=1)
        w = _corner_weights(frac).astype(rows.dtype)
        outs.append(jnp.sum(w * f0, -1))
        outs.append(jnp.sum(w * f1, -1))
    return jnp.stack(outs, axis=-1)


def brick_encode_table_sharded(x: Array, table_sharded: Array,
                               meta: BrickMeta, mesh: jax.sharding.Mesh,
                               model_axis: str = "model",
                               data_axis: Optional[str] = None) -> Array:
    """Brick LoTD encode with the TABLE row-sharded over `model_axis`.

    x:             [N, 3] — replicated over the model axis; optionally
                   sharded over `data_axis` (N must divide by its size).
    table_sharded: [total_rows_padded, 128] logically; pass the padded
                   full table (use `pad_table_for_sharding`) — shard_map
                   slices it. Already-sharded arrays work via jit donation.
    Returns [N, 2L] sharded like x. Differentiable in both args.
    """
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    x_spec = P(data_axis) if data_axis else P()
    t_spec = P(model_axis)

    def local_fn(xl, tl):
        idx = jax.lax.axis_index(model_axis)
        part = _local_contribution(xl, tl, meta, idx)
        return jax.lax.psum(part, model_axis)

    return shard_map(local_fn, mesh=mesh,
                     in_specs=(x_spec, t_spec),
                     out_specs=x_spec)(x, table_sharded)
