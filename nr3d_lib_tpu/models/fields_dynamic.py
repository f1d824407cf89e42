"""Dynamic (time-varying) fields.

Reference: nr3d_lib/models/fields_dynamic/ —
DynamicPermutoConcatSDF/NeuS (t concatenated into the permuto input,
dynamic_permuto_sdf.py:546 / dynamic_permuto_neus.py:248) and
EmerNeRF (emernerf.py:62-1375: static branch + dynamic branch + optional
flow field + shadow head, time embeddings).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
from nr3d_lib_tpu import nn

from nr3d_lib_tpu.models.blocks import MLP
from nr3d_lib_tpu.models.fields.nerf import RadianceNet, trunc_exp
from nr3d_lib_tpu.models.fields.neus import get_neus_var_ctrl
from nr3d_lib_tpu.models.grid_encodings.lotd import LoTDEncoding
from nr3d_lib_tpu.models.grid_encodings.permuto.permuto_encoding import (
    PermutoParams)

__all__ = ["DynamicPermutoConcatSDF", "DynamicPermutoConcatNeuS", "EmerNeRF",
           "EmerNeRFOnlyDynamic", "emernerf_cycle_loss"]

Array = jax.Array


class DynamicPermutoConcatSDF(nn.Module):
    """SDF over (x, t) via 4D permuto (reference: dynamic_permuto_sdf.py:546)."""

    def __init__(self, *, permuto_cfg: Optional[dict] = None,
                 decoder_cfg: Optional[dict] = None,
                 n_geo_feat: int = 15, radius_init: float = 0.5,
                 seed: int = 0):
        self.radius_init = float(radius_init)
        cfg = dict(permuto_cfg or {})
        cfg.setdefault("res_list", [8.0, 16.0, 32.0, 64.0, 128.0])
        cfg.setdefault("n_feats", 2)
        cfg.setdefault("log2_hashmap_size", 17)
        self.bank = PermutoParams(
            4, cfg["res_list"], n_feats=cfg["n_feats"],
            log2_hashmap_size=cfg["log2_hashmap_size"],
            backend=cfg.get("backend", "xla"),
            hashmap_rows=cfg.get("hashmap_rows", 4096), seed=seed)
        self.meta = self.bank.meta
        dec = dict(decoder_cfg or {})
        dec.setdefault("D", 1)
        dec.setdefault("W", 64)
        self.decoder = MLP(self.bank.out_features + 3, 1 + n_geo_feat, **dec,
                           seed=seed + 1)
        self.n_geo_feat = n_geo_feat

    @property
    def flattened_params(self):
        """Back-compat alias for the bank's table (pre-bank field API)."""
        return self.bank.flattened_params

    def _sdf_h(self, x: Array, ts: Array) -> Array:
        ts = jnp.broadcast_to(jnp.asarray(ts).reshape(-1, 1)
                              if jnp.ndim(ts) <= 1 else ts,
                              x.shape[:-1] + (1,))
        inp = jnp.concatenate([x * 0.5 + 0.5, ts * 0.5 + 0.5], -1)
        h = self.bank.encode(inp)
        out = self.decoder(jnp.concatenate([x, h], -1))
        if self.radius_init > 0:
            # geometric init (sphere residual) — see fields_conditional.py
            out = out.at[..., 0].add(jnp.linalg.norm(x, axis=-1)
                                     - self.radius_init)
        return out

    def forward_sdf(self, x: Array, ts: Array) -> Dict[str, Array]:
        out = self._sdf_h(x, ts)
        return {"sdf": out[..., 0], "h": out[..., 1:]}

    def forward_sdf_nablas(self, x: Array, ts: Array) -> Dict[str, Array]:
        def f(xx):
            out = self._sdf_h(xx, ts)
            return out[..., 0], out[..., 1:]

        (sdf, h), vjp_fn = jax.vjp(f, x)
        nablas = vjp_fn((jnp.ones_like(sdf), jnp.zeros_like(h)))[0]
        return {"sdf": sdf, "h": h, "nablas": nablas}


class DynamicPermutoConcatNeuS(nn.Module):
    """(reference: dynamic_permuto_neus.py:248 + NeusRendererMixinDynamic)"""

    def __init__(self, *, surface_cfg: Optional[dict] = None,
                 radiance_cfg: Optional[dict] = None,
                 var_ctrl_cfg: Optional[dict] = None, seed: int = 0):
        self.implicit_surface = DynamicPermutoConcatSDF(**(surface_cfg or {}),
                                                        seed=seed)
        self.radiance = RadianceNet(
            n_extra_feat=self.implicit_surface.n_geo_feat, use_nablas=True,
            use_pos=True, **(radiance_cfg or {}), seed=seed + 1)
        self.var_ctrl = get_neus_var_ctrl(**(var_ctrl_cfg or {"type": "learned"}))

    def forward_inv_s(self):
        return self.var_ctrl.inv_s()

    def __call__(self, x: Array, v: Array, ts: Array,
                 with_rgb: bool = True) -> Dict[str, Array]:
        out = self.implicit_surface.forward_sdf_nablas(x, ts)
        if with_rgb:
            out["rgb"] = self.radiance(x, v, out["nablas"], out["h"])
        return out


class EmerNeRF(nn.Module):
    """Static + dynamic + flow decomposition (reference: emernerf.py:62-1375
    EmerNeRF — static branch, time-conditioned dynamic branch, optional
    scene-flow field for temporal aggregation, shadow head).

    Heads: static (σ_s, rgb_s), dynamic (σ_d, rgb_d) over (x, t) permuto,
    flow (forward/backward scene flow), shadow (scalar factor on static rgb).
    Densities compose additively; rgb blends by density ratio
    (emernerf.py:528,974 composition).
    """

    def __init__(self, *, static_cfg: Optional[dict] = None,
                 dynamic_permuto_cfg: Optional[dict] = None,
                 use_flow: bool = True, use_shadow: bool = True,
                 temporal_aggregation: bool = True, dt: float = 0.02,
                 agg_weights: Tuple[float, float, float] = (0.25, 0.5, 0.25),
                 n_geo_feat: int = 15, seed: int = 0):
        scfg = dict(static_cfg or {})
        scfg.setdefault("lotd_cfg", {
            "lod_res": [16, 32, 64, 128], "lod_n_feats": 2,
            "lod_types": ["Dense", "Dense", "Hash", "Hash"],
            "hashmap_size": 2 ** 15})
        self.static_encoding = LoTDEncoding(3, lotd_cfg=scfg["lotd_cfg"],
                                            seed=seed)
        self.static_decoder = MLP(self.static_encoding.out_features,
                                  1 + n_geo_feat, D=1, W=64, seed=seed + 1)

        dcfg = dict(dynamic_permuto_cfg or {})
        dcfg.setdefault("res_list", [8.0, 16.0, 32.0, 64.0])
        dcfg.setdefault("n_feats", 2)
        dcfg.setdefault("log2_hashmap_size", 16)
        self.dyn_bank = PermutoParams(
            4, dcfg["res_list"], n_feats=dcfg["n_feats"],
            log2_hashmap_size=dcfg["log2_hashmap_size"],
            backend=dcfg.get("backend", "xla"),
            hashmap_rows=dcfg.get("hashmap_rows", 4096), seed=seed + 2)
        self.dyn_meta = self.dyn_bank.meta
        self.dyn_decoder = MLP(self.dyn_bank.out_features, 1 + n_geo_feat,
                               D=1, W=64, seed=seed + 3)

        self.static_radiance = RadianceNet(n_extra_feat=n_geo_feat,
                                           seed=seed + 4)
        self.dyn_radiance = RadianceNet(n_extra_feat=n_geo_feat, seed=seed + 5)
        self.use_flow = use_flow
        self.use_shadow = use_shadow
        self.temporal_aggregation = bool(temporal_aggregation and use_flow)
        self.dt = float(dt)
        self.agg_weights = tuple(float(w) for w in agg_weights)
        if use_flow:
            # (x, t) → forward+backward scene flow (emernerf.py flow field)
            self.flow_mlp = MLP(self.dyn_bank.out_features, 6, D=2, W=64,
                                seed=seed + 6)
        if use_shadow:
            self.shadow_mlp = MLP(n_geo_feat, 1, D=1, W=32,
                                  output_activation="sigmoid", seed=seed + 7)

    def _dyn_feats(self, x: Array, ts: Array) -> Array:
        ts = jnp.broadcast_to(jnp.asarray(ts).reshape(-1, 1)
                              if jnp.ndim(ts) <= 1 else ts,
                              x.shape[:-1] + (1,))
        inp = jnp.concatenate([x * 0.5 + 0.5, ts * 0.5 + 0.5], -1)
        return self.dyn_bank.encode(inp)

    def get_weight_reg(self, norm_type: float = 2.0) -> Array:
        """Concatenated decoder weight norms (reference emernerf.py:456)."""
        items = [self.static_decoder.get_weight_reg(norm_type),
                 self.dyn_decoder.get_weight_reg(norm_type)]
        if self.use_flow:
            items.append(self.flow_mlp.get_weight_reg(norm_type))
        if self.use_shadow:
            items.append(self.shadow_mlp.get_weight_reg(norm_type))
        return jnp.concatenate(items)

    def query_flow(self, x: Array, ts: Array) -> Dict[str, Array]:
        h = self._dyn_feats(x, ts)
        fl = self.flow_mlp(h)
        return {"flow_fwd": fl[..., :3], "flow_bwd": fl[..., 3:]}

    def __call__(self, x: Array, v: Optional[Array], ts: Array,
                 with_rgb: bool = True,
                 key: Optional[Array] = None) -> Dict[str, Array]:
        """key: training-mode PRNG for the flow-warp noise ratio (reference
        emernerf.py:284-301 samples noise∈[0,1.5); eval warps by exactly
        ±dt). With temporal aggregation the dynamic features are the
        agg_weights blend of (t−dt, t, t+dt) features at flow-warped
        positions, and the warped-point flow re-predictions are returned
        for the cycle-consistency loss (`emernerf_cycle_loss`)."""
        hs = self.static_decoder(self.static_encoding(x))
        sigma_s = trunc_exp(hs[..., 0])
        hd_feat = self._dyn_feats(x, ts)
        out = {}
        if self.temporal_aggregation:
            fl = self.flow_mlp(hd_feat)
            flow_fwd, flow_bwd = fl[..., :3], fl[..., 3:]
            out["flow_fwd"], out["flow_bwd"] = flow_fwd, flow_bwd
            ts_b = jnp.broadcast_to(jnp.asarray(ts, x.dtype).reshape(
                (-1,) if jnp.ndim(ts) <= 1 else jnp.shape(ts)), x.shape[:-1])
            if key is not None:
                noise = 1.5 * jax.random.uniform(key, ts_b.shape, x.dtype)
            else:
                noise = jnp.ones_like(ts_b)
            x_fwd = x + flow_fwd * noise[..., None]
            x_bwd = x + flow_bwd * noise[..., None]
            h_fwd = self._dyn_feats(x_fwd, ts_b + self.dt * noise)
            h_bwd = self._dyn_feats(x_bwd, ts_b - self.dt * noise)
            w = self.agg_weights
            hd = self.dyn_decoder(w[0] * h_bwd + w[1] * hd_feat + w[2] * h_fwd)
            # cycle consistency: the warped points' own flow predictions
            out["flow_fwd_pred_bwd"] = self.flow_mlp(h_fwd)[..., 3:]
            out["flow_bwd_pred_fwd"] = self.flow_mlp(h_bwd)[..., :3]
        else:
            hd = self.dyn_decoder(hd_feat)
        sigma_d = trunc_exp(hd[..., 0])
        sigma = sigma_s + sigma_d
        out.update({"sigma": sigma, "sigma_static": sigma_s,
                    "sigma_dynamic": sigma_d})
        if with_rgb:
            rgb_s = self.static_radiance(x, v, None, hs[..., 1:])
            if self.use_shadow:
                shadow = self.shadow_mlp(hd[..., 1:])
                rgb_s = rgb_s * (1.0 - shadow)
                out["shadow"] = shadow[..., 0]
            rgb_d = self.dyn_radiance(x, v, None, hd[..., 1:])
            ratio = (sigma_d / jnp.maximum(sigma, 1e-8))[..., None]
            out["rgb"] = rgb_s * (1 - ratio) + rgb_d * ratio
            out["rgb_static"] = rgb_s
            out["rgb_dynamic"] = rgb_d
        if self.use_flow and not self.temporal_aggregation:
            out.update(self.query_flow(x, ts))
        return out


class EmerNeRFOnlyDynamic(nn.Module):
    """EmerNeRF without the static branch (reference emernerf.py:974
    EmerNeRFOnlyDynamic) — models a fully dynamic scene (or the dynamic
    residual on top of an external static model). Same dynamic (x,t) permuto
    bank + flow field + temporal aggregation as `EmerNeRF`; exposes the same
    output dict with sigma == sigma_dynamic so renderers treat both alike."""

    def __init__(self, *, dynamic_permuto_cfg: Optional[dict] = None,
                 use_flow: bool = True,
                 temporal_aggregation: bool = True, dt: float = 0.02,
                 agg_weights: Tuple[float, float, float] = (0.25, 0.5, 0.25),
                 n_geo_feat: int = 15, seed: int = 0):
        dcfg = dict(dynamic_permuto_cfg or {})
        dcfg.setdefault("res_list", [8.0, 16.0, 32.0, 64.0])
        dcfg.setdefault("n_feats", 2)
        dcfg.setdefault("log2_hashmap_size", 16)
        self.dyn_bank = PermutoParams(
            4, dcfg["res_list"], n_feats=dcfg["n_feats"],
            log2_hashmap_size=dcfg["log2_hashmap_size"],
            backend=dcfg.get("backend", "xla"),
            hashmap_rows=dcfg.get("hashmap_rows", 4096), seed=seed + 2)
        self.dyn_meta = self.dyn_bank.meta
        self.dyn_decoder = MLP(self.dyn_bank.out_features, 1 + n_geo_feat,
                               D=1, W=64, seed=seed + 3)
        self.dyn_radiance = RadianceNet(n_extra_feat=n_geo_feat, seed=seed + 5)
        self.use_flow = use_flow
        self.use_shadow = False
        self.temporal_aggregation = bool(temporal_aggregation and use_flow)
        self.dt = float(dt)
        self.agg_weights = tuple(float(w) for w in agg_weights)
        if use_flow:
            self.flow_mlp = MLP(self.dyn_bank.out_features, 6, D=2, W=64,
                                seed=seed + 6)

    _dyn_feats = EmerNeRF._dyn_feats
    query_flow = EmerNeRF.query_flow

    def get_weight_reg(self, norm_type: float = 2.0) -> Array:
        items = [self.dyn_decoder.get_weight_reg(norm_type)]
        if self.use_flow:
            items.append(self.flow_mlp.get_weight_reg(norm_type))
        return jnp.concatenate(items)

    def __call__(self, x: Array, v: Optional[Array], ts: Array,
                 with_rgb: bool = True,
                 key: Optional[Array] = None) -> Dict[str, Array]:
        hd_feat = self._dyn_feats(x, ts)
        out: Dict[str, Array] = {}
        if self.temporal_aggregation:
            fl = self.flow_mlp(hd_feat)
            flow_fwd, flow_bwd = fl[..., :3], fl[..., 3:]
            out["flow_fwd"], out["flow_bwd"] = flow_fwd, flow_bwd
            ts_b = jnp.broadcast_to(jnp.asarray(ts, x.dtype).reshape(
                (-1,) if jnp.ndim(ts) <= 1 else jnp.shape(ts)), x.shape[:-1])
            if key is not None:
                noise = 1.5 * jax.random.uniform(key, ts_b.shape, x.dtype)
            else:
                noise = jnp.ones_like(ts_b)
            x_fwd = x + flow_fwd * noise[..., None]
            x_bwd = x + flow_bwd * noise[..., None]
            h_fwd = self._dyn_feats(x_fwd, ts_b + self.dt * noise)
            h_bwd = self._dyn_feats(x_bwd, ts_b - self.dt * noise)
            w = self.agg_weights
            hd = self.dyn_decoder(w[0] * h_bwd + w[1] * hd_feat + w[2] * h_fwd)
            out["flow_fwd_pred_bwd"] = self.flow_mlp(h_fwd)[..., 3:]
            out["flow_bwd_pred_fwd"] = self.flow_mlp(h_bwd)[..., :3]
        else:
            hd = self.dyn_decoder(hd_feat)
        sigma_d = trunc_exp(hd[..., 0])
        out.update({"sigma": sigma_d, "sigma_dynamic": sigma_d,
                    "sigma_static": jnp.zeros_like(sigma_d)})
        if with_rgb:
            rgb_d = self.dyn_radiance(x, v, None, hd[..., 1:])
            out["rgb"] = rgb_d
            out["rgb_static"] = jnp.zeros_like(rgb_d)
            out["rgb_dynamic"] = rgb_d
        if self.use_flow and not self.temporal_aggregation:
            out.update(self.query_flow(x, ts))
        return out


def emernerf_cycle_loss(out: Dict[str, Array],
                        mask: Optional[Array] = None) -> Array:
    """Flow cycle-consistency (reference emernerf.py flow_fwd_pred_bwd /
    flow_bwd_pred_fwd usage): the backward flow predicted at the
    forward-warped point must undo the forward flow, and vice versa."""
    c1 = jnp.sum((out["flow_fwd"] + out["flow_fwd_pred_bwd"]) ** 2, -1)
    c2 = jnp.sum((out["flow_bwd"] + out["flow_bwd_pred_fwd"]) ** 2, -1)
    c = c1 + c2
    if mask is not None:
        return jnp.sum(c * mask) / jnp.maximum(jnp.sum(mask), 1.0)
    return jnp.mean(c)
