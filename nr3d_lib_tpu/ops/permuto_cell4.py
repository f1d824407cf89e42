"""Cell permuto encoding with 4 bf16-quantized feats/vertex slot.

Applies the 4-feature rows of `ops/lotd_brick4.py` to the simplex lattice
of `ops/permuto_cell.py`: an encoding with the same total feature count
needs half the levels. The dynamic/conditional field families encode 4D
(x,t) permuto lattices with it.

Row layout is identical to the F=2 cell layout (cells_per_row, hashing,
and the per-point lane indices from `_level_rows_lanes_bary` are reused
verbatim). Param space: f32 [rows, 256], lane u = 2·(F=2 lane) + half.
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp

from nr3d_lib_tpu.ops.lotd_brick4 import _quantize4
from nr3d_lib_tpu.ops.permuto_cell import (PermutoCellMeta,
                                           _level_rows_lanes_bary,
                                           make_permuto_cell_meta)

__all__ = ["make_permuto_cell4_meta", "permuto_cell4_encode_xla"]

Array = jax.Array


def make_permuto_cell4_meta(n_dims: int, res_list: Sequence,
                            hashmap_rows: int = 4096,
                            auto_dense: bool = True) -> PermutoCellMeta:
    """Same meta as the F=2 cell path — rows just carry 4 feats/slot."""
    return make_permuto_cell_meta(n_dims, res_list, hashmap_rows,
                                  auto_dense)


# -------------------------------------------------------------------- encode
def permuto_cell4_encode_xla(x: Array, table: Array, meta: PermutoCellMeta
                             ) -> Array:
    """x [N,d] in [0,1] × table [total_rows, 256] (lane u = 2·(F=2 lane) +
    half) → [N, 4L]; values bf16-quantized (straight-through)."""
    tq = _quantize4(table)
    outs = []
    for level in meta.levels:
        row, lane, bary, _ = _level_rows_lanes_bary(x, level, meta)
        rows = jnp.take(tq, row, axis=0, mode="clip")      # [N, 256]
        w = bary.astype(rows.dtype)
        for f in range(4):
            vals = jnp.take_along_axis(rows, 2 * lane + f, axis=1)
            outs.append(jnp.sum(w * vals, -1))
    return jnp.stack(outs, axis=-1)
