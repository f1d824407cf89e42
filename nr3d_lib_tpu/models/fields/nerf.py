"""NeRF field nets: radiance net, MLP NeRF, LoTD-encoded NeRF.

Reference: nr3d_lib/models/fields/nerf/{mlp_nerf.py:38-188,lotd_nerf.py}.
Density activation uses trunc_exp (exp with clipped input) as in NGP.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
from nr3d_lib_tpu import nn

from nr3d_lib_tpu.models.blocks import MLP
from nr3d_lib_tpu.models.embedders import get_embedder
from nr3d_lib_tpu.models.grid_encodings.lotd import LoTDEncoding

__all__ = ["RadianceNet", "MlpNeRF", "LoTDNeRF", "trunc_exp"]

Array = jax.Array


@jax.custom_vjp
def trunc_exp(x):
    """exp with gradient clamp (NGP trunc_exp) — avoids fp blowups."""
    return jnp.exp(jnp.clip(x, -15.0, 15.0))


def _trunc_exp_fwd(x):
    return trunc_exp(x), x


def _trunc_exp_bwd(x, g):
    return (g * jnp.exp(jnp.clip(x, -15.0, 15.0)),)


trunc_exp.defvjp(_trunc_exp_fwd, _trunc_exp_bwd)


class RadianceNet(nn.Module):
    """View-dependent radiance head (reference: mlp_nerf.py:188 RadianceNet):
    rgb = MLP([x?, v_embed, n?, h_extra]) with sigmoid output."""

    def __init__(self, *, use_pos: bool = False, use_view_dirs: bool = True,
                 use_nablas: bool = False, n_extra_feat: int = 16,
                 dir_embed_cfg: Optional[dict] = None,
                 D: int = 2, W: int = 64, seed: int = 0):
        self.use_pos = use_pos
        self.use_view_dirs = use_view_dirs
        self.use_nablas = use_nablas
        self.dir_embed_fn, dir_dim = get_embedder(
            dir_embed_cfg or {"type": "spherical", "degree": 4}, 3)
        in_dim = (3 if use_pos else 0) + (dir_dim if use_view_dirs else 0) + \
                 (3 if use_nablas else 0) + n_extra_feat
        self.mlp = MLP(in_dim, 3, D=D, W=W, activation="relu",
                       output_activation="sigmoid", seed=seed)
        self.in_features = in_dim

    def __call__(self, x: Optional[Array], v: Optional[Array],
                 n: Optional[Array] = None, h_extra: Optional[Array] = None) -> Array:
        feats = []
        if self.use_pos:
            feats.append(x)
        if self.use_view_dirs:
            feats.append(self.dir_embed_fn(v))
        if self.use_nablas:
            feats.append(n)
        if h_extra is not None:
            feats.append(h_extra)
        return self.mlp(jnp.concatenate(feats, -1))


class MlpNeRF(nn.Module):
    """Classic embedded-MLP NeRF (reference: mlp_nerf.py:38 NeRF /
    :110 EmbededNeRF)."""

    def __init__(self, *, pos_embed_cfg: Optional[dict] = None,
                 D: int = 4, W: int = 128, skips=(2,),
                 n_geo_feat: int = 16,
                 radiance_cfg: Optional[dict] = None, seed: int = 0):
        self.embed_fn, pos_dim = get_embedder(
            pos_embed_cfg or {"type": "sinusoidal", "n_frequencies": 6}, 3)
        self.n_geo_feat = n_geo_feat
        self.sigma_mlp = MLP(pos_dim, 1 + n_geo_feat, D=D, W=W, skips=skips, seed=seed)
        self.radiance = RadianceNet(n_extra_feat=n_geo_feat,
                                    **(radiance_cfg or {}), seed=seed + 1)

    def forward_density(self, x: Array) -> Dict[str, Array]:
        h = self.sigma_mlp(self.embed_fn(x))
        return {"sigma": trunc_exp(h[..., 0]), "h": h[..., 1:]}

    def __call__(self, x: Array, v: Optional[Array] = None) -> Dict[str, Array]:
        out = self.forward_density(x)
        out["rgb"] = self.radiance(x, v, None, out["h"])
        return out


class PermutoNeRF(nn.Module):
    """Permutohedral-encoded NeRF (reference: fields/nerf/permuto_nerf.py):
    the permuto counterpart of LoTDNeRF — same decoder/radiance heads."""

    def __init__(self, *, permuto_cfg: Optional[dict] = None,
                 density_decoder_cfg: Optional[dict] = None,
                 radiance_cfg: Optional[dict] = None,
                 n_geo_feat: int = 15, seed: int = 0):
        from nr3d_lib_tpu.models.grid_encodings.permuto.permuto_encoding \
            import PermutoParams

        cfg = dict(permuto_cfg or {})
        cfg.setdefault("res_list", [8.0, 16.0, 32.0, 64.0, 128.0])
        cfg.setdefault("n_feats", 2)
        cfg.setdefault("log2_hashmap_size", 17)
        self.bank = PermutoParams(
            3, cfg["res_list"], n_feats=cfg["n_feats"],
            log2_hashmap_size=cfg["log2_hashmap_size"],
            backend=cfg.get("backend", "xla"),
            hashmap_rows=cfg.get("hashmap_rows", 4096), seed=seed)
        self.meta = self.bank.meta
        dec_cfg = dict(density_decoder_cfg or {})
        dec_cfg.setdefault("D", 1)
        dec_cfg.setdefault("W", 64)
        self.decoder = MLP(self.bank.out_features, 1 + n_geo_feat,
                           **dec_cfg, seed=seed + 1)
        self.radiance = RadianceNet(n_extra_feat=n_geo_feat,
                                    **(radiance_cfg or {}), seed=seed + 2)
        self.n_geo_feat = n_geo_feat

    def forward_density(self, x: Array) -> Dict[str, Array]:
        h = self.decoder(self.bank.encode(x * 0.5 + 0.5))
        return {"sigma": trunc_exp(h[..., 0]), "h": h[..., 1:]}

    def __call__(self, x: Array, v: Optional[Array] = None) -> Dict[str, Array]:
        out = self.forward_density(x)
        out["rgb"] = self.radiance(x, v, None, out["h"])
        return out


class LoTDNeRF(nn.Module):
    """LoTD-encoded NeRF (reference: lotd_nerf.py LoTDNeRF): hash/dense grid
    encoding → small density decoder → radiance head."""

    def __init__(self, *, encoding_cfg: Optional[dict] = None,
                 density_decoder_cfg: Optional[dict] = None,
                 radiance_cfg: Optional[dict] = None,
                 n_geo_feat: int = 15, seed: int = 0):
        enc_cfg = dict(encoding_cfg or {})
        enc_cfg.setdefault("lotd_cfg", {
            "lod_res": [16, 32, 64, 128], "lod_n_feats": 2,
            "lod_types": ["Dense", "Dense", "Hash", "Hash"],
            "hashmap_size": 2 ** 15})
        from nr3d_lib_tpu.models.grid_encodings.lotd import get_lotd_encoding

        self.encoding = get_lotd_encoding(3, **enc_cfg, seed=seed)
        self.n_geo_feat = n_geo_feat
        dec_cfg = dict(density_decoder_cfg or {})
        dec_cfg.setdefault("D", 1)
        dec_cfg.setdefault("W", 64)
        self.decoder = MLP(self.encoding.out_features, 1 + n_geo_feat,
                           **dec_cfg, seed=seed + 1)
        self.radiance = RadianceNet(n_extra_feat=n_geo_feat,
                                    **(radiance_cfg or {}), seed=seed + 2)

    def forward_density(self, x: Array) -> Dict[str, Array]:
        h = self.decoder(self.encoding(x))
        return {"sigma": trunc_exp(h[..., 0]), "h": h[..., 1:]}

    def __call__(self, x: Array, v: Optional[Array] = None) -> Dict[str, Array]:
        out = self.forward_density(x)
        out["rgb"] = self.radiance(x, v, None, out["h"])
        return out
