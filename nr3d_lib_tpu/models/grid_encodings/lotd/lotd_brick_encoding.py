"""LoTDBrickEncoding — module wrapper over the brick-layout encode.

Alternative to `LoTDEncoding` for Dense/Hash configurations: same [-1,1]
input convention and feature layout, backed by `ops/lotd_brick.py` (one
row-gather per point per level).

Parameters:
  * dense levels: canonical vertex grids (C0-tied, exactly reference Dense);
  * hash levels: brick rows directly.
Stored as one flattened vector for checkpoint/optimizer parity with
`LoTDEncoding.flattened_params`.
"""

from __future__ import annotations

from typing import List, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from nr3d_lib_tpu import nn

from nr3d_lib_tpu.ops import lotd_brick as B

__all__ = ["LoTDBrickEncoding"]

Array = jax.Array


class LoTDBrickEncoding(nn.Module):
    def __init__(self, input_ch: int = 3, *,
                 lod_res: Sequence, lod_types: Sequence[str],
                 hashmap_rows: int = 4096,
                 n_feats: int = 2,
                 param_init_std: float = 1e-4,
                 seed: int = 42, param_dtype=jnp.float32):
        """n_feats=4 selects the bf16 variant (`ops/lotd_brick4.py`):
        4 feats/vertex per brick row — half the levels, and half the
        gathers, per output feature. ≤4 levels."""
        assert input_ch == 3, "brick backend is 3D"
        assert n_feats in (2, 4)
        self.n_feats = n_feats
        if n_feats == 4:
            from nr3d_lib_tpu.ops import lotd_brick4 as B4

            self.meta = B4.make_brick4_meta(lod_res, lod_types, hashmap_rows)
        else:
            self.meta = B.make_brick_meta(lod_res, lod_types, hashmap_rows)
        self.in_features = 3
        self.out_features = self.meta.out_features * (n_feats // 2)
        row_width = B.LANES * (n_feats // 2)

        # canonical parameter layout: [dense vertex grids..., hash rows...]
        sizes: List[int] = []
        self._dense_levels: List[int] = []
        for i, lv in enumerate(self.meta.levels):
            if lv.kind == "dense":
                sizes.append(int(np.prod(lv.res)) * n_feats)
                self._dense_levels.append(i)
            else:
                sizes.append(lv.n_rows * row_width)
        offsets = [0]
        for sz in sizes:
            offsets.append(offsets[-1] + sz)
        self._param_offsets = tuple(offsets)  # static ints, not state
        n_params = int(self._param_offsets[-1])
        key = jax.random.key(seed)
        self.flattened_params = nn.Param(
            jax.random.uniform(key, (n_params,), param_dtype,
                               -param_init_std, param_init_std))

    @property
    def n_params(self) -> int:
        return int(self._param_offsets[-1])

    def level_params(self, i: int) -> Array:
        o = self._param_offsets
        return self.flattened_params[...][o[i]:o[i + 1]]

    def _build_table(self) -> Array:
        """Materialize the [total_rows, 128·(n_feats//2)] brick table
        (differentiable — dense boundary vertices stay tied)."""
        if self.n_feats == 4:
            from nr3d_lib_tpu.ops import lotd_brick4 as B4

            rows = []
            for i, lv in enumerate(self.meta.levels):
                p = self.level_params(i)
                if lv.kind == "dense":
                    rows.append(B4.materialize_dense_brick4(p, lv))
                else:
                    rows.append(p.reshape(lv.n_rows, 2 * B.LANES))
            return jnp.concatenate(rows, axis=0)
        rows = []
        for i, lv in enumerate(self.meta.levels):
            p = self.level_params(i)
            if lv.kind == "dense":
                rows.append(B.materialize_dense_brick_table(p, lv))
            else:
                rows.append(p.reshape(lv.n_rows, B.LANES))
        return jnp.concatenate(rows, axis=0)

    def __call__(self, x: Array) -> Array:
        """x in [-1,1] → [N, n_feats·L] (encode space is [0,1] like the
        reference); differentiable to any order."""
        table = self._build_table()
        if self.n_feats == 4:
            from nr3d_lib_tpu.ops import lotd_brick4 as B4

            return B4.brick4_encode_xla(x * 0.5 + 0.5, table, self.meta)
        return B.brick_encode_xla(x * 0.5 + 0.5, table, self.meta)

    forward = __call__

    def state_dict(self):
        return {"flattened_params": self.flattened_params[...]}

    def load_state_dict(self, sd):
        self.flattened_params[...] = jnp.asarray(sd["flattened_params"])
