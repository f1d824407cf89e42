"""Conditional (generative / categorical) fields.

Reference: nr3d_lib/models/fields_conditional/ —
GenerativePermutoConcatSDF/NeuS (z concatenated into the permuto input,
generative_permuto_sdf.py:530 / generative_permuto_neus.py:254),
StyleLoTDSDF/NeuS (grower-produced per-instance LoTD params,
style_lotd_neus.py:322, lotd_batched_growers.py:52-753), batched renderer
mixin (fields_conditional/neus/renderer_mixin.py:25).

Notes: the "concat" family feeds [x, z] into a high-dim permutohedral
encoding (its d+1-gather cost grows linearly in dim — the reason the
reference uses permuto here). The "style" family runs a hypernetwork
("grower") z → flattened LoTD params and uses batched LoTD (`bidx`).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
from nr3d_lib_tpu import nn

from nr3d_lib_tpu.models.blocks import MLP
from nr3d_lib_tpu.models.fields.nerf import RadianceNet
from nr3d_lib_tpu.models.fields.neus import get_neus_var_ctrl
from nr3d_lib_tpu.models.grid_encodings.permuto.permuto_encoding import (
    PermutoParams)
from nr3d_lib_tpu.ops import lotd as _lotd

__all__ = ["GenerativePermutoConcatSDF", "GenerativePermutoConcatNeuS",
           "LoTDDenseGrower", "StyleLoTDSDF", "StyleLoTDNeuS"]

Array = jax.Array


class GenerativePermutoConcatSDF(nn.Module):
    """SDF conditioned by concatenating z into the permuto input
    (reference: generative_permuto_sdf.py GenerativePermutoConcatSDF)."""

    def __init__(self, z_dim: int = 4, *,
                 permuto_cfg: Optional[dict] = None,
                 decoder_cfg: Optional[dict] = None,
                 n_geo_feat: int = 15, z_scale: float = 1.0,
                 radius_init: float = 0.5, seed: int = 0):
        cfg = dict(permuto_cfg or {})
        cfg.setdefault("res_list", [8.0, 16.0, 32.0, 64.0])
        cfg.setdefault("n_feats", 2)
        cfg.setdefault("log2_hashmap_size", 16)
        # backend="cell" needs 3+z_dim ≤ 5 — the cell row layout packs
        # 2^(d+1) vertex slots into 128 lanes
        self.bank = PermutoParams(
            3 + z_dim, cfg["res_list"], n_feats=cfg["n_feats"],
            log2_hashmap_size=cfg["log2_hashmap_size"],
            backend=cfg.get("backend", "xla"),
            hashmap_rows=cfg.get("hashmap_rows", 4096), seed=seed)
        self.meta = self.bank.meta
        self.z_dim = z_dim
        self.z_scale = z_scale
        # geometric init: analytic sphere residual so every instance starts
        # as a valid surface (reference: generative_permuto_sdf geo_init)
        self.radius_init = float(radius_init)
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

    def _sdf_h(self, x: Array, z: Array) -> Array:
        """x [-1,1]^3; z [..., z_dim] broadcastable to x's batch."""
        z = jnp.broadcast_to(z, x.shape[:-1] + (self.z_dim,))
        inp = jnp.concatenate([x * 0.5 + 0.5,
                               jnp.tanh(z * self.z_scale) * 0.5 + 0.5], -1)
        h = self.bank.encode(inp)
        out = self.decoder(jnp.concatenate([x, h], -1))
        if self.radius_init > 0:
            sphere = jnp.linalg.norm(x, axis=-1) - self.radius_init
            out = out.at[..., 0].add(sphere)
        return out

    def forward_sdf(self, x: Array, z: Array) -> Dict[str, Array]:
        out = self._sdf_h(x, z)
        return {"sdf": out[..., 0], "h": out[..., 1:]}

    def forward_sdf_nablas(self, x: Array, z: Array) -> Dict[str, Array]:
        def f(xx):
            out = self._sdf_h(xx, z)
            return out[..., 0], out[..., 1:]

        (sdf, h), vjp_fn = jax.vjp(f, x)
        nablas = vjp_fn((jnp.ones_like(sdf), jnp.zeros_like(h)))[0]
        return {"sdf": sdf, "h": h, "nablas": nablas}


class GenerativePermutoConcatNeuS(nn.Module):
    """(reference: generative_permuto_neus.py GenerativePermutoConcatNeuS)"""

    def __init__(self, z_dim: int = 4, *, surface_cfg: Optional[dict] = None,
                 radiance_cfg: Optional[dict] = None,
                 var_ctrl_cfg: Optional[dict] = None, seed: int = 0):
        self.implicit_surface = GenerativePermutoConcatSDF(
            z_dim, **(surface_cfg or {}), seed=seed)
        self.radiance = RadianceNet(
            n_extra_feat=self.implicit_surface.n_geo_feat, use_nablas=True,
            use_pos=True, **(radiance_cfg or {}), seed=seed + 1)
        self.var_ctrl = get_neus_var_ctrl(**(var_ctrl_cfg or {"type": "learned"}))

    def forward_inv_s(self):
        return self.var_ctrl.inv_s()

    def __call__(self, x: Array, v: Array, z: Array,
                 with_rgb: bool = True) -> Dict[str, Array]:
        out = self.implicit_surface.forward_sdf_nablas(x, z)
        if with_rgb:
            out["rgb"] = self.radiance(x, v, out["nablas"], out["h"])
        return out


# the full decomposition-aware grower family lives in lotd_growers; the
# dense-flatten grower is re-exported here for backward compatibility
from nr3d_lib_tpu.models.grid_encodings.lotd.lotd_growers import (  # noqa: E402
    LoTDFlattenGrower as LoTDDenseGrower, get_lotd_grower)


class StyleLoTDSDF(nn.Module):
    """Per-instance LoTD params from a grower + shared decoder
    (reference: style_lotd_sdf.py:229 StyleLoTDSDF)."""

    def __init__(self, z_dim: int = 64, *, lotd_cfg: Optional[dict] = None,
                 grower_cfg: Optional[dict] = None,
                 decoder_cfg: Optional[dict] = None,
                 n_geo_feat: int = 15, seed: int = 0):
        cfg = dict(lotd_cfg or {})
        cfg.setdefault("lod_res", [8, 16, 32])
        cfg.setdefault("lod_n_feats", 2)
        cfg.setdefault("lod_types", "Dense")
        self.meta = _lotd.generate_meta(3, cfg["lod_res"], cfg["lod_n_feats"],
                                        cfg["lod_types"],
                                        hashmap_size=cfg.get("hashmap_size"))
        gcfg = dict(grower_cfg or {})
        gtype = gcfg.pop("type", "flatten")
        gcfg.setdefault("seed", seed)
        self.grower = get_lotd_grower(gtype, z_dim, self.meta, **gcfg)
        dec = dict(decoder_cfg or {})
        dec.setdefault("D", 1)
        dec.setdefault("W", 64)
        self.decoder = MLP(self.meta.out_features + 3, 1 + n_geo_feat, **dec,
                           seed=seed + 1)
        self.n_geo_feat = n_geo_feat

    def _sdf_h(self, x: Array, z: Array, bidx: Optional[Array]) -> Array:
        """x [N,3] in [-1,1]; z [B, z_dim]; bidx [N] selects instance."""
        params = self.grower(z)                       # [B, n_params]
        if bidx is None:
            bidx = jnp.zeros(x.shape[:-1], jnp.int32)
        h = _lotd.lotd_encode(x * 0.5 + 0.5, params, self.meta, bidx=bidx)
        return self.decoder(jnp.concatenate([x, h], -1))

    def forward_sdf(self, x: Array, z: Array, bidx: Optional[Array] = None
                    ) -> Dict[str, Array]:
        out = self._sdf_h(x, z, bidx)
        return {"sdf": out[..., 0], "h": out[..., 1:]}

    def forward_sdf_nablas(self, x: Array, z: Array,
                           bidx: Optional[Array] = None) -> Dict[str, Array]:
        def f(xx):
            out = self._sdf_h(xx, z, bidx)
            return out[..., 0], out[..., 1:]

        (sdf, h), vjp_fn = jax.vjp(f, x)
        nablas = vjp_fn((jnp.ones_like(sdf), jnp.zeros_like(h)))[0]
        return {"sdf": sdf, "h": h, "nablas": nablas}


class StyleLoTDNeuS(nn.Module):
    """(reference: style_lotd_neus.py:322 StyleLoTDNeuS)"""

    def __init__(self, z_dim: int = 64, *, surface_cfg: Optional[dict] = None,
                 radiance_cfg: Optional[dict] = None,
                 var_ctrl_cfg: Optional[dict] = None, seed: int = 0):
        self.implicit_surface = StyleLoTDSDF(z_dim, **(surface_cfg or {}),
                                             seed=seed)
        self.radiance = RadianceNet(
            n_extra_feat=self.implicit_surface.n_geo_feat, use_nablas=True,
            use_pos=True, **(radiance_cfg or {}), seed=seed + 1)
        self.var_ctrl = get_neus_var_ctrl(**(var_ctrl_cfg or {"type": "learned"}))

    def forward_inv_s(self):
        return self.var_ctrl.inv_s()

    def __call__(self, x: Array, v: Array, z: Array,
                 bidx: Optional[Array] = None,
                 with_rgb: bool = True) -> Dict[str, Array]:
        """z is the per-INSTANCE latent table [B, z_dim]; bidx [N] selects
        each point's instance (grower runs once per instance, not per point)."""
        out = self.implicit_surface.forward_sdf_nablas(x, z, bidx)
        if with_rgb:
            out["rgb"] = self.radiance(x, v, out["nablas"], out["h"])
        return out
