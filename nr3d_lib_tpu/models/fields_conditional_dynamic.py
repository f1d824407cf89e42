"""Conditional + dynamic fields: latent- AND time-conditioned surfaces.

Reference: nr3d_lib/models/fields_conditional_dynamic/neus/ (431 LoC) —
DynamicGenerativePermutoConcatSDF/NeuS concat both the instance latent z and
the timestamp t into the permutohedral encoding input
(fields_conditional_dynamic/neus/renderer_mixin.py:25
NeusRendererMixinBatchedDynamic drives the batched+dynamic query).
"""

from __future__ import annotations

from typing import Dict, Optional

import jax
import jax.numpy as jnp
from nr3d_lib_tpu import nn

from nr3d_lib_tpu.models.blocks import MLP
from nr3d_lib_tpu.models.fields.nerf import RadianceNet
from nr3d_lib_tpu.models.fields.neus import get_neus_var_ctrl
from nr3d_lib_tpu.models.grid_encodings.permuto.permuto_encoding import (
    PermutoParams)

__all__ = ["DynamicGenerativePermutoConcatSDF",
           "DynamicGenerativePermutoConcatNeuS"]

Array = jax.Array


class DynamicGenerativePermutoConcatSDF(nn.Module):
    """SDF over (x, z, t): a (3+z_dim+1)-dim permuto encoding
    (reference: fields_conditional_dynamic — the z-and-t concat variant of
    generative_permuto_sdf.py:530)."""

    def __init__(self, z_dim: int = 4, *, permuto_cfg: Optional[dict] = None,
                 decoder_cfg: Optional[dict] = None,
                 n_geo_feat: int = 15, z_scale: float = 1.0,
                 radius_init: float = 0.5, seed: int = 0):
        self.radius_init = float(radius_init)
        cfg = dict(permuto_cfg or {})
        cfg.setdefault("res_list", [8.0, 16.0, 32.0, 64.0])
        cfg.setdefault("n_feats", 2)
        cfg.setdefault("log2_hashmap_size", 16)
        # backend="cell" needs 3+z_dim+1 <= 5
        self.bank = PermutoParams(
            3 + z_dim + 1, cfg["res_list"], n_feats=cfg["n_feats"],
            log2_hashmap_size=cfg["log2_hashmap_size"],
            backend=cfg.get("backend", "xla"),
            hashmap_rows=cfg.get("hashmap_rows", 4096), seed=seed)
        self.meta = self.bank.meta
        self.z_dim = z_dim
        self.z_scale = z_scale
        dec = dict(decoder_cfg or {})
        dec.setdefault("D", 1)
        dec.setdefault("W", 64)
        self.decoder = MLP(self.bank.out_features + 3, 1 + n_geo_feat,
                           **dec, seed=seed + 1)
        self.n_geo_feat = n_geo_feat

    @property
    def flattened_params(self):
        """Back-compat alias for the bank's table (pre-bank field API)."""
        return self.bank.flattened_params

    def _sdf_h(self, x: Array, z: Array, ts: Array) -> Array:
        z = jnp.broadcast_to(z, x.shape[:-1] + (self.z_dim,))
        ts = jnp.broadcast_to(jnp.asarray(ts).reshape(-1, 1)
                              if jnp.ndim(ts) <= 1 else ts,
                              x.shape[:-1] + (1,))
        inp = jnp.concatenate([x * 0.5 + 0.5,
                               jnp.tanh(z * self.z_scale) * 0.5 + 0.5,
                               ts * 0.5 + 0.5], -1)
        h = self.bank.encode(inp)
        out = self.decoder(jnp.concatenate([x, h], -1))
        if self.radius_init > 0:
            # geometric init (sphere residual) — see fields_conditional.py
            out = out.at[..., 0].add(jnp.linalg.norm(x, axis=-1)
                                     - self.radius_init)
        return out

    def forward_sdf(self, x: Array, z: Array, ts: Array) -> Dict[str, Array]:
        out = self._sdf_h(x, z, ts)
        return {"sdf": out[..., 0], "h": out[..., 1:]}

    def forward_sdf_nablas(self, x: Array, z: Array, ts: Array
                           ) -> Dict[str, Array]:
        def f(xx):
            out = self._sdf_h(xx, z, ts)
            return out[..., 0], out[..., 1:]

        (sdf, h), vjp_fn = jax.vjp(f, x)
        nablas = vjp_fn((jnp.ones_like(sdf), jnp.zeros_like(h)))[0]
        return {"sdf": sdf, "h": h, "nablas": nablas}


class DynamicGenerativePermutoConcatNeuS(nn.Module):
    """(reference: fields_conditional_dynamic/neus/
    DynamicGenerativePermutoConcatNeuS)"""

    def __init__(self, z_dim: int = 4, *, surface_cfg: Optional[dict] = None,
                 radiance_cfg: Optional[dict] = None,
                 var_ctrl_cfg: Optional[dict] = None, seed: int = 0):
        self.implicit_surface = DynamicGenerativePermutoConcatSDF(
            z_dim, **(surface_cfg or {}), seed=seed)
        self.radiance = RadianceNet(
            n_extra_feat=self.implicit_surface.n_geo_feat, use_nablas=True,
            use_pos=True, **(radiance_cfg or {}), seed=seed + 1)
        self.var_ctrl = get_neus_var_ctrl(**(var_ctrl_cfg
                                             or {"type": "learned"}))

    def forward_inv_s(self):
        return self.var_ctrl.inv_s()

    def __call__(self, x: Array, v: Array, z: Array, ts: Array,
                 with_rgb: bool = True) -> Dict[str, Array]:
        out = self.implicit_surface.forward_sdf_nablas(x, z, ts)
        if with_rgb:
            out["rgb"] = self.radiance(x, v, out["nablas"], out["h"])
        return out
