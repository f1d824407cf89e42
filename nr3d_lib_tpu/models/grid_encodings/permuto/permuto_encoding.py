"""PermutoEncoding module (reference: permuto_encoding.py:27 PermutoEncoding).

Input in [-1,1]^D (mapped to the lattice's [0,1] space); owns flat params;
supports anneal window / max_level like LoTDEncoding.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np
from nr3d_lib_tpu import nn

from nr3d_lib_tpu.models.annealers import MultiresAnnealer
from nr3d_lib_tpu.ops import permuto as _permuto
from nr3d_lib_tpu.ops import permuto_cell as _pcell

__all__ = ["PermutoEncoding", "PermutoParams"]

Array = jax.Array


class PermutoParams(nn.Module):
    """Meta + flat parameters + encode() for a permuto table — the shared
    backbone of every permuto-based field (reference PermutoEncImpl,
    permuto.py:293). backend:
      * 'xla'  — classic lattice, d+1 gathers/(pt,level) (`ops/permuto.py`)
      * 'cell' — cell-packed rows, 1 gather/(pt,level)
        (`ops/permuto_cell.py`). Collision structure differs (cell-local
        vertex copies); quality parity is tested in
        tests/test_permuto_cell.py.
    Inputs to encode() are in the lattice's [0,1] space."""

    def __init__(self, n_dims: int, res_list: Sequence, *,
                 n_feats: int = 2, log2_hashmap_size: int = 18,
                 backend: str = "xla", hashmap_rows: int = 4096,
                 auto_dense: bool = True,
                 param_init_std: float = 1e-4, seed: int = 0):
        self.backend = backend
        self.n_feats = n_feats
        if backend == "cell":
            assert n_feats in (2, 4), "cell backend packs 2 or 4 feats"
            # auto_dense: coarse levels get collision-free box indexing and
            # only as many rows as they have reachable cells.
            # n_feats=4 selects the bf16 variant (permuto_cell4.py):
            # same rows, double features per gather — halve the levels.
            self.meta = _pcell.make_permuto_cell_meta(
                n_dims, res_list, hashmap_rows=hashmap_rows,
                auto_dense=auto_dense)
            shape = (self.meta.total_rows, _pcell.LANES * (n_feats // 2))
        else:
            self.meta = _permuto.make_permuto_meta(
                n_dims, res_list, n_feats, log2_hashmap_size)
            shape = (self.meta.n_params,)
        self.flattened_params = nn.Param(
            jax.random.uniform(jax.random.key(seed), shape, jnp.float32,
                               -param_init_std, param_init_std))
        self.out_features = self.meta.out_features
        if backend == "cell" and n_feats == 4:
            self.out_features = 4 * self.meta.n_levels

    def encode(self, inp: Array, **kw) -> Array:
        """Every backend differentiates to any order (eikonal losses)."""
        p = self.flattened_params[...]
        batch = inp.shape[:-1]
        flat = inp.reshape(-1, inp.shape[-1])
        if self.backend == "cell" and self.n_feats == 4:
            from nr3d_lib_tpu.ops import permuto_cell4 as _pc4

            y = _pc4.permuto_cell4_encode_xla(flat, p, self.meta)
        elif self.backend == "cell":
            y = _pcell.permuto_cell_encode_xla(flat, p, self.meta)
        else:
            y = _permuto.permuto_encode(flat, p, self.meta, **kw)
        return y.reshape(*batch, y.shape[-1])

    def state_dict(self):
        return {"flattened_params": self.flattened_params[...]}

    def load_state_dict(self, sd):
        self.flattened_params[...] = jnp.asarray(sd["flattened_params"])


class PermutoEncoding(nn.Module):
    def __init__(self, input_ch: int = 3, *,
                 coarsest_res: float = 16.0, finest_res: float = 2048.0,
                 n_levels: int = 16, n_feats: int = 2,
                 log2_hashmap_size: int = 18,
                 res_list: Optional[Sequence] = None,
                 anneal_cfg: Optional[dict] = None,
                 param_init_std: float = 1e-4,
                 seed: int = 42, param_dtype=jnp.float32):
        if res_list is None:
            growth = (finest_res / coarsest_res) ** (1.0 / max(n_levels - 1, 1))
            res_list = [coarsest_res * growth ** l for l in range(n_levels)]
        self.meta = _permuto.make_permuto_meta(
            input_ch, res_list, n_feats, log2_hashmap_size)
        self.in_features = input_ch
        self.out_features = self.meta.out_features
        key = jax.random.key(seed)
        self.flattened_params = nn.Param(
            jax.random.uniform(key, (self.meta.n_params,), param_dtype,
                               -param_init_std, param_init_std))
        self.annealer = MultiresAnnealer(self.meta.n_levels, **anneal_cfg) \
            if anneal_cfg else None
        self.max_level: Optional[int] = None
        self.level_weights = None

    def set_anneal_iter(self, it: int):
        if self.annealer is not None:
            self.max_level, w = self.annealer(it)
            self.level_weights = None if w is None else jnp.asarray(w)

    def __call__(self, x: Array, max_level: Optional[int] = None) -> Array:
        ml = max_level if max_level is not None else self.max_level
        return _permuto.permuto_encode(x * 0.5 + 0.5, self.flattened_params[...],
                                       self.meta, level_weights=self.level_weights,
                                       max_level=ml)

    forward = __call__

    def forward_dydx(self, x: Array) -> Tuple[Array, Array]:
        y, dydx = _permuto.permuto_enc_fwd_dydx(
            x * 0.5 + 0.5, self.flattened_params[...], self.meta,
            level_weights=self.level_weights, max_level=self.max_level)
        return y, dydx * 0.5

    def backward_dydx(self, dL_dy: Array, dy_dx: Array, x: Array = None) -> Array:
        return _permuto.permuto_enc_bwd_dydx(dL_dy, dy_dx)

    def state_dict(self):
        return {"flattened_params": self.flattened_params[...]}

    def load_state_dict(self, sd):
        self.flattened_params[...] = jnp.asarray(sd["flattened_params"])
