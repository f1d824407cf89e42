"""LoTDEncoding — stateful module over the functional LoTD core.

Reference: nr3d_lib/models/grid_encodings/lotd/lotd_encoding.py:38-120:
owns the flattened parameter vector (fp32 master — compute may cast to
bf16 without loss-scaling), input in [-1,1] mapped to the kernel's [0,1],
progressive `max_level` masking + windowed anneal, per-level param access.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np
from nr3d_lib_tpu import nn

from nr3d_lib_tpu.models.annealers import MultiresAnnealer
from nr3d_lib_tpu.ops import lotd as _lotd

__all__ = ["LoTDEncoding"]

Array = jax.Array


class LoTDEncoding(nn.Module):
    def __init__(self, input_ch: int = 3, *,
                 lotd_cfg: Optional[dict] = None,
                 lotd_auto_compute_cfg: Optional[dict] = None,
                 anneal_cfg: Optional[dict] = None,
                 param_init_cfg: Optional[dict] = None,
                 compute_dtype=jnp.float32, param_dtype=jnp.float32,
                 seed: int = 42, aabb=None):
        if lotd_auto_compute_cfg is not None:
            from nr3d_lib_tpu.models.grid_encodings.lotd.lotd_cfg import get_lotd_cfg

            stretch = (np.asarray(aabb[1]) - np.asarray(aabb[0])) if aabb is not None \
                else np.ones(input_ch) * 2.0
            lotd_cfg = get_lotd_cfg(input_ch=input_ch, stretch=stretch,
                                    **lotd_auto_compute_cfg)
        assert lotd_cfg is not None, "need lotd_cfg or lotd_auto_compute_cfg"
        lotd_cfg = dict(lotd_cfg)
        self.meta = _lotd.generate_meta(
            input_ch,
            lotd_cfg["lod_res"],
            lotd_cfg.get("lod_n_feats", 2),
            lotd_cfg.get("lod_types", "Dense"),
            hashmap_size=lotd_cfg.get("hashmap_size"),
            use_smooth_step=lotd_cfg.get("use_smooth_step", False))
        self.in_features = input_ch
        self.out_features = self.meta.out_features
        self.compute_dtype = compute_dtype

        # param init (reference lotd_encoding.py: uniform small random)
        cfg = dict(param_init_cfg or {})
        method = cfg.get("method", "uniform")
        scale = float(cfg.get("bound", cfg.get("std", 1e-4)))
        key = jax.random.key(seed)
        if method == "normal":
            p0 = scale * jax.random.normal(key, (self.meta.n_params,), param_dtype)
        else:
            p0 = jax.random.uniform(key, (self.meta.n_params,), param_dtype,
                                    -scale, scale)
        self.flattened_params = nn.Param(p0)

        # progressive anneal
        self.annealer = MultiresAnnealer(self.meta.n_levels, **anneal_cfg) \
            if anneal_cfg else None
        self.max_level: Optional[int] = None     # static python-side override
        self.level_weights = None                # [L] window from annealer

    # ----------------------------------------------------------- lifecycle
    def set_anneal_iter(self, it: int):
        """Update max_level/window from the annealer (host-side; called
        outside jit each iteration — reference training_before_per_step)."""
        if self.annealer is not None:
            self.max_level, w = self.annealer(it)
            self.level_weights = None if w is None else jnp.asarray(w)

    # ------------------------------------------------------------- forward
    def __call__(self, x: Array, max_level: Optional[int] = None) -> Array:
        """x in [-1,1] → features (reference lotd_encoding.py:150-163)."""
        p = self.flattened_params[...].astype(self.compute_dtype)
        ml = max_level if max_level is not None else self.max_level
        return _lotd.lotd_encode(x * 0.5 + 0.5, p, self.meta,
                                 max_level=ml, level_weights=self.level_weights)

    forward = __call__

    def forward_dydx(self, x: Array, max_level: Optional[int] = None
                     ) -> Tuple[Array, Array]:
        """(features, dy/dx in the [-1,1] input frame)
        (reference lotd_encoding.py:165-181 forward_dydx)."""
        p = self.flattened_params[...].astype(self.compute_dtype)
        ml = max_level if max_level is not None else self.max_level
        y, dydx = _lotd.lotd_fwd_dydx(x * 0.5 + 0.5, p, self.meta,
                                      max_level=ml, level_weights=self.level_weights)
        return y, dydx * 0.5  # chain rule for x/2+0.5

    def backward_dydx(self, dL_dy: Array, dy_dx: Array, x: Array = None) -> Array:
        """nablas in the [-1,1] frame (reference lotd_encoding.py:183-213)."""
        return _lotd.lotd_bwd_dydx(dL_dy, dy_dx)

    # ------------------------------------------------------- level access
    def get_level_param(self, level: int) -> Array:
        """(reference lotd_helpers.py get_level_param)"""
        return self.flattened_params[...][
            _lotd.level_param_slice(self.meta, level)]

    def set_level_param(self, level: int, value: Array):
        sl = _lotd.level_param_slice(self.meta, level)
        self.flattened_params[...] = self.flattened_params[...].at[sl].set(
            value.reshape(-1))

    def state_dict(self):
        return {"flattened_params": self.flattened_params[...]}

    def load_state_dict(self, sd):
        self.flattened_params[...] = jnp.asarray(sd["flattened_params"])
