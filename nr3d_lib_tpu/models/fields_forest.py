"""Forest (large-scale, block-decomposed) fields.

Reference: nr3d_lib/models/fields_forest/ — LoTDForestSDF (lotd_forest_sdf.py),
LoTDForestNeuS (lotd_forest_neus.py:218), NeuSRendererMixinForest
(renderer_mixin.py:133-886), grid_encodings/lotd/lotd_forest.py (per-block
LoTD params over a shared LoDMeta + ForestMeta).

Design: per-block parameters are a batched LoTD table [n_trees,
n_params]; the sample's block slot is the batched-encode `bidx`
(ops/lotd.py supports it natively), and block-local coords come from
`ForestBlockSpace.normalize_coords`. The reference's per-segment pack
merging disappears: samples stay globally t-sorted in the dense [R,S]
layout, so compositing is the ordinary alpha chain (SURVEY.md §3.5).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from nr3d_lib_tpu import nn

from nr3d_lib_tpu.graphics.nerf import ray_alpha_to_vw
from nr3d_lib_tpu.graphics.neus import neus_ray_sdf_to_alpha
from nr3d_lib_tpu.models.blocks import MLP
from nr3d_lib_tpu.models.model_base import ModelMixin
from nr3d_lib_tpu.models.fields.nerf import RadianceNet, trunc_exp
from nr3d_lib_tpu.models.fields.neus import get_neus_var_ctrl
from nr3d_lib_tpu.models.spatial.forest import ForestBlockSpace
from nr3d_lib_tpu.ops import lotd as _lotd

__all__ = ["LoTDForestEncoding", "LoTDForestSDF", "LoTDForestNeuS",
           "LoTDForestNeuSModel", "LoTDForestNeRF"]

Array = jax.Array


class LoTDForestEncoding(nn.Module):
    """Per-block LoTD params over one shared meta
    (reference: lotd_forest.py:29-73 LoTDForestEncoding).

    backend='brick' switches to per-block BRICK tables
    (`ops/lotd_brick.brick_encode_xla` with `bidx`): one row-gather per
    (point, level) regardless of block count — the counterpart of the
    reference's lotd_forest.h CUDA kernels.
    Dense levels keep canonical per-block vertex grids (C0-tied within a
    block, like LoTDBrickEncoding)."""

    def __init__(self, n_trees: int, *, lotd_cfg: Optional[dict] = None,
                 seed: int = 0, param_dtype=jnp.float32):
        cfg = dict(lotd_cfg or {})
        cfg.setdefault("lod_res", [8, 16, 32])
        cfg.setdefault("lod_n_feats", 2)
        cfg.setdefault("lod_types", ["Dense", "Dense", "Hash"])
        cfg.setdefault("hashmap_size", 2 ** 12)
        self.backend = cfg.pop("backend", "xla")
        self.n_trees = n_trees
        if self.backend == "brick":
            from nr3d_lib_tpu.ops import lotd_brick as _B

            assert cfg["lod_n_feats"] == 2
            types = cfg["lod_types"]
            if isinstance(types, str):
                types = [types] * len(cfg["lod_res"])
            self.meta_brick = _B.make_brick_meta(
                cfg["lod_res"], types,
                hashmap_rows=max(1, int(cfg["hashmap_size"]) // 64))
            self.out_features = self.meta_brick.out_features
            sizes = []
            for lv in self.meta_brick.levels:
                sizes.append(int(np.prod(lv.res)) * 2 if lv.kind == "dense"
                             else lv.n_rows * 128)
            offs = [0]
            for sz in sizes:
                offs.append(offs[-1] + sz)
            self._param_offsets = tuple(offs)
            n_params = int(offs[-1])
        else:
            self.meta = _lotd.generate_meta(
                3, cfg["lod_res"], cfg["lod_n_feats"], cfg["lod_types"],
                hashmap_size=cfg.get("hashmap_size"))
            self.out_features = self.meta.out_features
            n_params = self.meta.n_params
        self.flattened_params = nn.Param(
            jax.random.uniform(jax.random.key(seed),
                               (n_trees, n_params), param_dtype,
                               -1e-4, 1e-4))

    def _build_tables(self) -> Array:
        """[n_trees·total_rows, 128] brick tables (differentiable)."""
        from nr3d_lib_tpu.ops import lotd_brick as _B

        o = self._param_offsets

        def one(p):
            rows = []
            for i, lv in enumerate(self.meta_brick.levels):
                pi = p[o[i]:o[i + 1]]
                if lv.kind == "dense":
                    rows.append(_B.materialize_dense_brick_table(pi, lv))
                else:
                    rows.append(pi.reshape(lv.n_rows, 128))
            return jnp.concatenate(rows, axis=0)

        tabs = jax.vmap(one)(self.flattened_params[...])
        return tabs.reshape(-1, 128)

    def __call__(self, x_local: Array, bidx: Array) -> Array:
        """x_local in [-1,1] per block; bidx < 0 → zero features."""
        if self.backend == "brick":
            from nr3d_lib_tpu.ops import lotd_brick as _B

            y = _B.brick_encode_xla(x_local * 0.5 + 0.5,
                                    self._build_tables(), self.meta_brick,
                                    bidx)
            return jnp.where(bidx[..., None] >= 0, y, 0.0)
        return _lotd.lotd_encode(x_local * 0.5 + 0.5,
                                 self.flattened_params[...], self.meta,
                                 bidx=bidx)

    def state_dict(self):
        return {"flattened_params": self.flattened_params[...]}

    def load_state_dict(self, sd):
        self.flattened_params[...] = jnp.asarray(sd["flattened_params"])


class LoTDForestSDF(nn.Module):
    """Forest SDF: shared decoder over per-block encodings
    (reference: lotd_forest_sdf.py:273)."""

    def __init__(self, space: ForestBlockSpace, *,
                 lotd_cfg: Optional[dict] = None,
                 decoder_cfg: Optional[dict] = None,
                 n_geo_feat: int = 15, seed: int = 0):
        self.space = space
        self.encoding = LoTDForestEncoding(max(space.n_trees, 1),
                                           lotd_cfg=lotd_cfg, seed=seed)
        dec = dict(decoder_cfg or {})
        dec.setdefault("D", 1)
        dec.setdefault("W", 64)
        self.decoder = MLP(self.encoding.out_features + 3, 1 + n_geo_feat,
                           **dec, seed=seed + 1)
        self.n_geo_feat = n_geo_feat

    def _sdf_h(self, x_world: Array) -> Array:
        bidx = self.space.block_of_points(x_world)
        x_local = self.space.normalize_coords(x_world, bidx)
        h = self.encoding(x_local, bidx)
        return self.decoder(jnp.concatenate([x_local, h], -1))

    def forward_sdf(self, x_world: Array) -> Dict[str, Array]:
        out = self._sdf_h(x_world)
        return {"sdf": out[..., 0], "h": out[..., 1:]}

    def forward_sdf_nablas(self, x_world: Array) -> Dict[str, Array]:
        def f(xx):
            out = self._sdf_h(xx)
            return out[..., 0], out[..., 1:]

        (sdf, h), vjp_fn = jax.vjp(f, x_world)
        nablas = vjp_fn((jnp.ones_like(sdf), jnp.zeros_like(h)))[0]
        return {"sdf": sdf, "h": h, "nablas": nablas}


class LoTDForestNeuS(nn.Module):
    """Forest NeuS (reference: lotd_forest_neus.py:218 LoTDForestNeuS)."""

    def __init__(self, space: ForestBlockSpace, *,
                 surface_cfg: Optional[dict] = None,
                 radiance_cfg: Optional[dict] = None,
                 var_ctrl_cfg: Optional[dict] = None, seed: int = 0):
        self.implicit_surface = LoTDForestSDF(space, **(surface_cfg or {}),
                                              seed=seed)
        self.radiance = RadianceNet(
            n_extra_feat=self.implicit_surface.n_geo_feat,
            use_nablas=True, use_pos=False, **(radiance_cfg or {}),
            seed=seed + 1)
        self.var_ctrl = get_neus_var_ctrl(**(var_ctrl_cfg or {"type": "learned"}))

    def forward_inv_s(self):
        return self.var_ctrl.inv_s()


class LoTDForestNeRF(nn.Module):
    """Forest NeRF (reference: lotd_forest_nerf.py:122)."""

    def __init__(self, space: ForestBlockSpace, *,
                 lotd_cfg: Optional[dict] = None,
                 decoder_cfg: Optional[dict] = None,
                 radiance_cfg: Optional[dict] = None,
                 n_geo_feat: int = 15, seed: int = 0):
        self.space = space
        self.encoding = LoTDForestEncoding(max(space.n_trees, 1),
                                           lotd_cfg=lotd_cfg, seed=seed)
        dec = dict(decoder_cfg or {})
        dec.setdefault("D", 1)
        dec.setdefault("W", 64)
        self.decoder = MLP(self.encoding.out_features, 1 + n_geo_feat,
                           **dec, seed=seed + 1)
        self.radiance = RadianceNet(n_extra_feat=n_geo_feat,
                                    **(radiance_cfg or {}), seed=seed + 2)

    def forward_density(self, x_world: Array) -> Dict[str, Array]:
        bidx = self.space.block_of_points(x_world)
        x_local = self.space.normalize_coords(x_world, bidx)
        h = self.decoder(self.encoding(x_local, bidx))
        sigma = trunc_exp(h[..., 0]) * (bidx >= 0)
        return {"sigma": sigma, "h": h[..., 1:]}


class LoTDForestNeuSModel(nn.Module, ModelMixin):
    """Renderable forest NeuS (reference: NeuSRendererMixinForest,
    fields_forest/neus/renderer_mixin.py:133/274/734).

    Round-2 upgrades over the fixed-step round-1 query:
      * per-block occupancy acceleration (OccGridAccelForest ↔ reference
        occgrid_accel/forest.py:37 + forest_marching.cu:27) — empty blocks
        AND empty cells inside occupied blocks produce no samples;
      * NeuS importance upsampling on the marched candidates (reference
        renderer_mixin.py:274 _forest_ray_query_inblock_march_occ_multi_upsample);
      * budgeted compaction before the expensive nablas+radiance query —
        masked slots never reach the network.
    """

    def __init__(self, space_cfg: Optional[dict] = None, *,
                 field_cfg: Optional[dict] = None,
                 accel_cfg: Optional[dict] = None,
                 n_march_steps: int = 256, step_size: Optional[float] = None,
                 march_mode: str = "fixed", max_segments: int = 32,
                 steps_per_segment: int = 16,
                 upsample_inv_s_factors=(1.0, 4.0), n_importance: int = 16,
                 upsample_inv_s: float = 64.0,
                 compression_factor: float = 0.25, seed: int = 0):
        from nr3d_lib_tpu.models.accelerations.occgrid_forest import (
            OccGridAccelForest)

        self.space = ForestBlockSpace(**(space_cfg or {}))
        if self.space.n_trees == 0:
            # default: fully-occupied forest until populated
            res = self.space.resolution
            corners = np.argwhere(np.ones(res, bool))
            self.space.populate_from_corners(corners)
        self.field = LoTDForestNeuS(self.space, **(field_cfg or {}), seed=seed)
        self.n_march_steps = n_march_steps
        self.step_size = step_size or (self.space.block_size / 16.0)
        # 'fixed': uniform candidate steps over [near,far] (occ-masked);
        # 'segments': block segments from the vectorized forest raytrace,
        # samples only inside them (reference SPC two-stage, SURVEY §3.5)
        assert march_mode in ("fixed", "segments")
        self.march_mode = march_mode
        self.max_segments = int(max_segments)
        self.steps_per_segment = int(steps_per_segment)
        self.accel = OccGridAccelForest(
            self.space, step_size=self.step_size,
            max_steps_per_ray=n_march_steps, **(accel_cfg or {}))
        self.upsample_inv_s_factors = tuple(upsample_inv_s_factors)
        self.n_importance = int(n_importance)
        self.upsample_inv_s = float(upsample_inv_s)
        self.compression_factor = float(compression_factor)

    # ------------------------------------------------------------ lifecycle
    def query_occ_val(self, x_world: Array) -> Array:
        sdf = self.field.implicit_surface.forward_sdf(x_world)["sdf"]
        inv_s = jax.lax.stop_gradient(self.field.forward_inv_s())
        return jax.nn.sigmoid(-jnp.abs(sdf) * inv_s) * 4.0

    def populate(self, key=None):
        self.accel.init(key if key is not None else jax.random.key(0), self.query_occ_val)

    def training_before_per_step(self, it: int, key=None):
        self.field.implicit_surface.space  # block set fixed during training
        self.field.var_ctrl.set_iter(it)
        self.accel.step(it, key if key is not None else jax.random.key(it), self.query_occ_val)

    def ray_test(self, rays_o: Array, rays_d: Array, **kw) -> Dict:
        return self.space.ray_test(rays_o, rays_d, **kw)

    def ray_query(self, ray_tested: Dict, key=None, with_rgb: bool = True
                  ) -> Tuple[Dict, Dict]:
        from nr3d_lib_tpu.graphics import pack_ops as po
        from nr3d_lib_tpu.graphics.neus import neus_packed_sdf_to_alpha
        from nr3d_lib_tpu.graphics.neus_ray_query import _upsample_rounds

        rays_o, rays_d = ray_tested["rays_o"], ray_tested["rays_d"]
        near, far, ray_mask = (ray_tested["near"], ray_tested["far"],
                               ray_tested["mask"])
        key_m = None
        if key is not None:
            key, key_m = jax.random.split(key)
        if self.march_mode == "segments":
            t, dt, bidx, smask = self.accel.ray_march_segmented(
                rays_o, rays_d, near, far, max_segments=self.max_segments,
                steps_per_segment=self.steps_per_segment,
                perturb_key=key_m)
        else:
            t, dt, bidx, smask = self.accel.ray_march(
                rays_o, rays_d, near, far, perturb_key=key_m)
        r = t.shape[0]

        def sdf_fn(x):
            return self.field.implicit_surface.forward_sdf(x)["sdf"]

        # importance upsampling on world-space rays (forest fields take world
        # coords; block-local normalization happens inside the field)
        t, valid = _upsample_rounds(sdf_fn, rays_o, rays_d, t, smask, far,
                                    self.upsample_inv_s,
                                    self.upsample_inv_s_factors,
                                    self.n_importance, key)
        s = t.shape[1]
        inv_s = self.field.forward_inv_s()

        # cheap SDF pass → keep mask → budgeted compaction (empty-block and
        # dead samples never reach the nablas/radiance query)
        x = rays_o[:, None, :] + rays_d[:, None, :] * t[..., None]
        sdf_d = jnp.where(valid, sdf_fn(x.reshape(r * s, 3)).reshape(r, s), 1e4)
        alpha_d = neus_ray_sdf_to_alpha(sdf_d, inv_s, append_cdf_1=True)
        alpha_d = jnp.where(valid & ray_mask[:, None], alpha_d, 0.0)
        trans = jnp.cumprod(jnp.concatenate(
            [jnp.ones_like(alpha_d[:, :1]), 1.0 - alpha_d[:, :-1]], -1), -1)
        keep = valid & ray_mask[:, None] & (trans > 1e-4)
        capacity = max(int(r * s * self.compression_factor), r)
        budget = max(capacity // r, 1)
        rank = jnp.cumsum(keep.astype(jnp.int32), -1) - 1
        keep = keep & (rank < budget)
        t_p, ridx = po.dense_to_packed(t, keep, capacity)
        vmask = ridx < r
        sel = jnp.minimum(ridx, r - 1)
        x_p = rays_o[sel] + rays_d[sel] * t_p[:, None]

        out = self.field.implicit_surface.forward_sdf_nablas(x_p)
        sdf_p = jnp.where(vmask, out["sdf"], 1e4)
        alpha_p = jnp.where(vmask, neus_packed_sdf_to_alpha(
            sdf_p, inv_s, ridx, append_cdf_1=True), 0.0)
        vw = po.packed_alpha_to_vw(alpha_p, ridx)
        acc = po.packed_sum(vw, ridx, r)
        depth = po.packed_sum(vw * t_p, ridx, r) / jnp.maximum(acc, 1e-10)
        rendered = {"mask_volume": jnp.where(ray_mask, acc, 0.0),
                    "depth_volume": jnp.where(ray_mask, depth, 0.0)}
        if with_rgb:
            rgb = self.field.radiance(None, rays_d[sel], out["nablas"],
                                      out["h"])
            rendered["rgb_volume"] = jnp.where(
                ray_mask[:, None], po.packed_sum(vw[:, None] * rgb, ridx, r),
                0.0)
        nrm = po.packed_sum(vw[:, None] * out["nablas"], ridx, r)
        rendered["normals_volume"] = jnp.where(ray_mask[:, None], nrm, 0.0)
        vb = {"t_packed": t_p, "ridx": ridx, "alpha_packed": alpha_p,
              "vw_packed": vw, "sdf_packed": sdf_p,
              "nablas_packed": out["nablas"], "x_packed": x_p,
              "ray_mask": ray_mask, "n_compact": jnp.sum(vmask),
              "n_marched": jnp.sum(smask)}
        return rendered, vb
