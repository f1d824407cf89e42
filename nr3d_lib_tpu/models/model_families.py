"""Renderable Model classes for the dynamic / conditional / conditional+
dynamic field families (VERDICT round-1 item #4).

Reference renderer mixins being re-designed here:
  * fields_dynamic/neus/renderer_mixin.py:76  (NeusRendererMixinDynamic)
  * fields_dynamic/nerf/renderer_mixin.py:23  (EmerNeRF model lifecycle,
    emernerf.py:62-1375 incl. flow-based temporal aggregation)
  * fields_conditional/neus/renderer_mixin.py:25 (NeuSRendererMixinBatched)
  * fields_conditional_dynamic/neus/renderer_mixin.py:25
    (NeusRendererMixinBatchedDynamic)

Each model owns (field, space, accel, latents-if-conditional) and implements
the ModelMixin lifecycle: populate / training_before_per_step / ray_test /
ray_query — so a downstream trainer can drive any family uniformly
(reference: model_base.py:18-269).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from nr3d_lib_tpu import nn

from nr3d_lib_tpu.models.accelerations.occgrid_batched import (
    OccGridAccelDynamic, OccGridAccelStaticAndDynamic)
from nr3d_lib_tpu.models.autodecoder import AutoDecoderMixin
from nr3d_lib_tpu.models.model_base import ModelMixin
from nr3d_lib_tpu.models.spatial import AABBSpace
from nr3d_lib_tpu.models.spatial.aabb import AABBDynamicSpace

__all__ = ["DynamicPermutoNeuSModel", "GenerativePermutoNeuSModelBatched",
           "StyleLoTDNeuSModelBatched", "DynamicGenerativeNeuSModel",
           "EmerNeRFModel"]

Array = jax.Array


class DynamicPermutoNeuSModel(nn.Module, ModelMixin):
    """Time-conditioned NeuS model (reference: NeusRendererMixinDynamic +
    DynamicPermutoConcatNeuS, fields_dynamic/neus/)."""

    def __init__(self, *, field_cfg: Optional[dict] = None,
                 space_cfg: Optional[dict] = None,
                 accel_cfg: Optional[dict] = None,
                 ray_query_cfg: Optional[dict] = None,
                 n_time_keys: int = 8, seed: int = 0):
        from nr3d_lib_tpu.models.fields_dynamic import DynamicPermutoConcatNeuS

        self.field = DynamicPermutoConcatNeuS(**(field_cfg or {}), seed=seed)
        self.space = AABBDynamicSpace(**(space_cfg or {}))
        self.accel = OccGridAccelDynamic(n_time_keys, **(accel_cfg or {}))
        self.ray_query_cfg = dict(ray_query_cfg or {})

    # field passthroughs used by the query variant
    @property
    def implicit_surface(self):
        return self.field.implicit_surface

    def forward_inv_s(self):
        return self.field.forward_inv_s()

    def __call__(self, x, v, ts, with_rgb=True):
        return self.field(x, v, ts, with_rgb=with_rgb)

    def query_occ_val(self, x: Array, key_idx: Array) -> Array:
        ts = self.accel.ts_keyframes[...][key_idx]
        sdf = self.field.implicit_surface.forward_sdf(x, ts)["sdf"]
        inv_s = jax.lax.stop_gradient(self.field.forward_inv_s())
        return jax.nn.sigmoid(-jnp.abs(sdf) * inv_s) * 4.0

    def _accel_query(self, x_batched: Array, bidx: Array) -> Array:
        b, n, _ = x_batched.shape
        return self.query_occ_val(x_batched.reshape(b * n, 3),
                                  bidx.reshape(b * n)).reshape(b, n)

    def populate(self, key=None):
        self.accel.occ.step_update(key if key is not None
                                   else jax.random.key(0), self._accel_query)

    def training_before_per_step(self, it: int, key=None):
        self.field.var_ctrl.set_iter(it)
        self.accel.step(it, key if key is not None else jax.random.key(it),
                        self._accel_query)

    def ray_query(self, ray_tested: Dict, key=None, with_rgb: bool = True
                  ) -> Tuple[Dict, Dict]:
        from nr3d_lib_tpu.graphics.neus_ray_query_variants import (
            neus_ray_query_dynamic)

        ts = ray_tested["ts"]
        cfg = dict(self.ray_query_cfg)
        cfg.pop("query_mode", None)
        return neus_ray_query_dynamic(self, self.space, ray_tested, ts,
                                      perturb_key=key, with_rgb=with_rgb,
                                      **cfg)


class _BatchedNeuSModelBase(nn.Module, ModelMixin):
    """Shared scaffolding for latent-conditioned batched models: autodecoder
    latents + shared AABB space + batched query (reference:
    fields_conditional/neus/renderer_mixin.py:25)."""

    def __init__(self, n_instances: int, latent_dim: int, *,
                 space_cfg: Optional[dict] = None,
                 ray_query_cfg: Optional[dict] = None,
                 latent_std: float = 0.01, seed: int = 0):
        self.autodecoder = AutoDecoderMixin(n_instances, latent_dim,
                                            latent_std=latent_std,
                                            seed=seed + 100)
        self.space = AABBSpace(**(space_cfg or {}))
        self.ray_query_cfg = dict(ray_query_cfg or {})
        self.n_instances = n_instances

    @property
    def implicit_surface(self):
        return self.field.implicit_surface

    def forward_inv_s(self):
        return self.field.forward_inv_s()

    def __call__(self, x, v, z, with_rgb=True):
        return self.field(x, v, z, with_rgb=with_rgb)

    def ray_query(self, ray_tested: Dict, key=None, with_rgb: bool = True
                  ) -> Tuple[Dict, Dict]:
        from nr3d_lib_tpu.graphics.neus_ray_query_variants import (
            neus_ray_query_batched)

        bidx = ray_tested["bidx"]
        z = self.autodecoder.get_latent(jnp.arange(self.n_instances))
        cfg = dict(self.ray_query_cfg)
        cfg.pop("query_mode", None)
        return neus_ray_query_batched(self, self.space, ray_tested, z, bidx,
                                      perturb_key=key, with_rgb=with_rgb,
                                      **cfg)

    def training_before_per_step(self, it: int, key=None):
        self.field.var_ctrl.set_iter(it)


class GenerativePermutoNeuSModelBatched(_BatchedNeuSModelBase):
    """Batched generative-permuto NeuS model (reference:
    generative_permuto_neus.py + NeuSRendererMixinBatched)."""

    def __init__(self, n_instances: int, latent_dim: int = 4, *,
                 field_cfg: Optional[dict] = None, **kw):
        from nr3d_lib_tpu.models.fields_conditional import (
            GenerativePermutoConcatNeuS)

        super().__init__(n_instances, latent_dim, **kw)
        self.field = GenerativePermutoConcatNeuS(
            latent_dim, **(field_cfg or {}), seed=kw.get("seed", 0))


class StyleLoTDNeuSModelBatched(_BatchedNeuSModelBase):
    """Batched style-LoTD NeuS model: grower-produced per-instance LoTD
    params (reference: style_lotd_neus.py:322 + lotd_batched_growers)."""

    def __init__(self, n_instances: int, latent_dim: int = 8, *,
                 field_cfg: Optional[dict] = None, **kw):
        from nr3d_lib_tpu.models.fields_conditional import StyleLoTDNeuS

        super().__init__(n_instances, latent_dim, **kw)
        self.field = StyleLoTDNeuS(z_dim=latent_dim, **(field_cfg or {}),
                                   seed=kw.get("seed", 0))

    def __call__(self, x, v, z, bidx=None, with_rgb=True):
        return self.field(x, v, z, bidx, with_rgb=with_rgb)

    def ray_query(self, ray_tested: Dict, key=None, with_rgb: bool = True
                  ) -> Tuple[Dict, Dict]:
        from nr3d_lib_tpu.graphics.neus_ray_query_variants import (
            neus_ray_query_batched)

        bidx = ray_tested["bidx"]
        z = self.autodecoder.get_latent(jnp.arange(self.n_instances))
        cfg = dict(self.ray_query_cfg)
        cfg.pop("query_mode", None)
        return neus_ray_query_batched(self, self.space, ray_tested, z, bidx,
                                      per_instance_z=True, perturb_key=key,
                                      with_rgb=with_rgb, **cfg)


class DynamicGenerativeNeuSModel(_BatchedNeuSModelBase):
    """Conditional + dynamic model (reference:
    fields_conditional_dynamic/neus/renderer_mixin.py:25
    NeusRendererMixinBatchedDynamic)."""

    def __init__(self, n_instances: int, latent_dim: int = 4, *,
                 field_cfg: Optional[dict] = None, **kw):
        from nr3d_lib_tpu.models.fields_conditional_dynamic import (
            DynamicGenerativePermutoConcatNeuS)

        super().__init__(n_instances, latent_dim, **kw)
        self.field = DynamicGenerativePermutoConcatNeuS(
            latent_dim, **(field_cfg or {}), seed=kw.get("seed", 0))

    def __call__(self, x, v, z, ts, with_rgb=True):
        return self.field(x, v, z, ts, with_rgb=with_rgb)

    def ray_query(self, ray_tested: Dict, key=None, with_rgb: bool = True
                  ) -> Tuple[Dict, Dict]:
        from nr3d_lib_tpu.graphics.neus_ray_query_variants import (
            neus_ray_query_batched_dynamic)

        bidx, ts = ray_tested["bidx"], ray_tested["ts"]
        z = self.autodecoder.get_latent(jnp.arange(self.n_instances))
        cfg = dict(self.ray_query_cfg)
        cfg.pop("query_mode", None)
        return neus_ray_query_batched_dynamic(
            self, self.space, ray_tested, z, bidx, ts, perturb_key=key,
            with_rgb=with_rgb, **cfg)


class EmerNeRFModel(nn.Module, ModelMixin):
    """Renderable EmerNeRF (reference: fields_dynamic/nerf/renderer_mixin.py:23
    + emernerf.py:62-1375): static+dynamic decomposition, optional flow-based
    temporal aggregation, static∪dynamic occupancy acceleration, and the
    training regularizers the reference computes per step (flow smoothness,
    dynamic-density sparsity, shadow penalty) returned in the volume buffer.
    """

    def __init__(self, *, field_cfg: Optional[dict] = None,
                 space_cfg: Optional[dict] = None,
                 accel_cfg: Optional[dict] = None,
                 n_time_keys: int = 8,
                 temporal_aggregation: bool = True,
                 temporal_delta: float = 0.05,
                 n_march_steps: int = 96,
                 only_dynamic: bool = False,
                 ray_query_cfg: Optional[dict] = None, seed: int = 0):
        from nr3d_lib_tpu.models.fields_dynamic import (EmerNeRF,
                                                        EmerNeRFOnlyDynamic)

        cls = EmerNeRFOnlyDynamic if only_dynamic else EmerNeRF
        self.field = cls(**(field_cfg or {}), seed=seed)
        self.space = AABBDynamicSpace(**(space_cfg or {}))
        self.accel = OccGridAccelStaticAndDynamic(
            n_time_keys, **(accel_cfg or {"resolution": (32, 32, 32)}))
        self.temporal_aggregation = bool(temporal_aggregation)
        self.temporal_delta = float(temporal_delta)
        self.n_march_steps = int(n_march_steps)
        self.ray_query_cfg = dict(ray_query_cfg or {})

    def query_sigma(self, x: Array, ts: Array) -> Array:
        return self.field(x, None, ts, with_rgb=False)["sigma"]

    def sample_pts_uniform(self, key: Array, num_samples: int
                           ) -> Tuple[Array, Array]:
        """Uniform (x, ts) samples in the normalized volume (reference
        renderer_mixin.py:569 sample_pts_uniform) — for the sparsity /
        eikonal-style volume regularizers."""
        kx, kt = jax.random.split(key)
        x = jax.random.uniform(kx, (num_samples, 3), minval=-1.0, maxval=1.0)
        ts = jax.random.uniform(kt, (num_samples,), minval=-1.0, maxval=1.0)
        return x, ts

    def sample_pts_in_occupied(self, key: Array, num_samples: int
                               ) -> Tuple[Array, Array]:
        """(x, ts) samples biased to occupied cells of the static∪dynamic
        grids (reference renderer_mixin.py:577): draw uniform candidates and
        importance-resample those landing in occupied voxels (falls back to
        uniform when the grids are empty)."""
        from nr3d_lib_tpu.ops.occgrid_march import occgrid_query

        kc, kp = jax.random.split(key)
        cand = 4 * num_samples
        x, ts = self.sample_pts_uniform(kc, cand)
        occ = (occgrid_query(self.accel.static.occ(), x)
               | occgrid_query(jnp.any(self.accel.dynamic.occ.occ(), axis=0),
                               x))
        p = occ.astype(jnp.float32) + 1e-6
        idx = jax.random.choice(kp, cand, (num_samples,),
                                p=p / jnp.sum(p))
        return x[idx], ts[idx]

    def populate(self, key=None):
        key = key if key is not None else jax.random.key(0)

        def static_fn(x):
            return self.field(x, None, jnp.zeros(x.shape[0]),
                              with_rgb=False)["sigma_static"]

        self.accel.static.init_from_net(key, static_fn)

        def dyn_fn(xb, bidx):
            b, n, _ = xb.shape
            ts = self.accel.dynamic.ts_keyframes[...][bidx.reshape(-1)]
            out = self.field(xb.reshape(b * n, 3), None, ts, with_rgb=False)
            return out["sigma_dynamic"].reshape(b, n)

        self.accel.dynamic.occ.step_update(key, dyn_fn)

    def training_before_per_step(self, it: int, key=None):
        key = key if key is not None else jax.random.key(it)
        if it % self.accel.dynamic.update_every == 0:
            def dyn_fn(xb, bidx):
                b, n, _ = xb.shape
                ts = self.accel.dynamic.ts_keyframes[...][bidx.reshape(-1)]
                out = self.field(xb.reshape(b * n, 3), None, ts,
                                 with_rgb=False)
                return out["sigma_dynamic"].reshape(b, n)

            self.accel.dynamic.occ.step_update(key, dyn_fn)

    def _field_with_temporal_agg(self, x: Array, v: Optional[Array],
                                 ts: Array, with_rgb: bool) -> Dict:
        """Flow-based temporal aggregation (emernerf.py:974): warp to t±Δ by
        the predicted scene flow and average the dynamic branch over the
        three timestamps — supervises the flow field through reconstruction."""
        out = self.field(x, v, ts, with_rgb=with_rgb)
        if getattr(self.field, "temporal_aggregation", False):
            # the field already blends flow-warped (t−dt, t, t+dt) FEATURES
            # internally (reference emernerf.py:284-316); expose its cycle
            # residuals (warped-point flow must undo the warp) for the
            # flow regularizer
            if "flow_fwd_pred_bwd" in out:
                out["flow_cycle"] = jnp.concatenate(
                    [out["flow_fwd"] + out["flow_fwd_pred_bwd"],
                     out["flow_bwd"] + out["flow_bwd_pred_fwd"]], -1)
            return out
        if not (self.temporal_aggregation and self.field.use_flow):
            return out
        dt = self.temporal_delta
        x_fwd = x + out["flow_fwd"] * dt
        x_bwd = x - out["flow_bwd"] * dt
        out_fwd = self.field(x_fwd, v, ts + dt, with_rgb=with_rgb)
        out_bwd = self.field(x_bwd, v, ts - dt, with_rgb=with_rgb)
        out["sigma_dynamic"] = (out["sigma_dynamic"]
                                + out_fwd["sigma_dynamic"]
                                + out_bwd["sigma_dynamic"]) / 3.0
        out["sigma"] = out["sigma_static"] + out["sigma_dynamic"]
        if with_rgb:
            rgb_d = (out["rgb_dynamic"] + out_fwd["rgb_dynamic"]
                     + out_bwd["rgb_dynamic"]) / 3.0
            ratio = (out["sigma_dynamic"]
                     / jnp.maximum(out["sigma"], 1e-8))[..., None]
            out["rgb"] = out["rgb_static"] * (1 - ratio) + rgb_d * ratio
            out["rgb_dynamic"] = rgb_d
        # cycle consistency residual for the flow regularizer
        out["flow_cycle"] = out_fwd["flow_bwd"] - out["flow_fwd"]
        return out

    def ray_query(self, ray_tested: Dict, key=None, with_rgb: bool = True,
                  branch: str = "full") -> Tuple[Dict, Dict]:
        from nr3d_lib_tpu.graphics.nerf import ray_alpha_to_vw, tau_to_alpha
        from nr3d_lib_tpu.ops.occgrid_march import march_steps

        rays_o, rays_d = ray_tested["rays_o"], ray_tested["rays_d"]
        near, far, ray_mask = (ray_tested["near"], ray_tested["far"],
                               ray_tested["mask"])
        ts = ray_tested["ts"]
        o_n, d_n = self.space.normalize_rays(rays_o, rays_d)
        t, dt_steps, in_range = march_steps(
            near, far, self.n_march_steps, 2.0 / self.n_march_steps,
            perturb_key=key)
        r, s = t.shape
        x = o_n[:, None, :] + d_n[:, None, :] * t[..., None]
        # static ∪ dynamic occupancy mask at each candidate (any-time union
        # for the dynamic grid, as in the reference's conservative accel)
        from nr3d_lib_tpu.ops.occgrid_march import occgrid_query
        occ_s = occgrid_query(self.accel.static.occ(), x.reshape(r * s, 3))
        occ_d = occgrid_query(jnp.any(self.accel.dynamic.occ.occ(), axis=0),
                              x.reshape(r * s, 3))
        smask = in_range & (occ_s | occ_d).reshape(r, s)

        flat_x = x.reshape(r * s, 3)
        ts_rep = jnp.repeat(ts, s)
        v = jnp.broadcast_to(rays_d[:, None, :], (r, s, 3)).reshape(r * s, 3)
        out = self._field_with_temporal_agg(flat_x, v, ts_rep, with_rgb)
        # branch-isolated compositing (reference emernerf renderer_mixin
        # ray_query_static :942 / ray_query_dynamic :959): density AND color
        # come from one branch only, so occlusion by the other disappears.
        sigma_key = {"full": "sigma", "static": "sigma_static",
                     "dynamic": "sigma_dynamic"}[branch]
        sigma = jnp.where(smask, out[sigma_key].reshape(r, s), 0.0)
        alpha = tau_to_alpha(sigma * dt_steps)
        alpha = jnp.where(ray_mask[:, None], alpha, 0.0)
        vw = ray_alpha_to_vw(alpha)
        acc = jnp.sum(vw, -1)
        rendered = {"mask_volume": jnp.where(ray_mask, acc, 0.0),
                    "depth_volume": jnp.where(
                        ray_mask,
                        jnp.sum(vw * t, -1) / jnp.maximum(acc, 1e-10), 0.0)}
        if with_rgb:
            rgb_key = {"full": "rgb", "static": "rgb_static",
                       "dynamic": "rgb_dynamic"}[branch]
            rgb = out[rgb_key].reshape(r, s, 3)
            rendered["rgb_volume"] = jnp.where(
                ray_mask[:, None], jnp.sum(vw[..., None] * rgb, -2), 0.0)
            # separated static/dynamic renders (emernerf decomposition views)
            for k in ("rgb_static", "rgb_dynamic"):
                rendered[k + "_volume"] = jnp.where(
                    ray_mask[:, None],
                    jnp.sum(vw[..., None] * out[k].reshape(r, s, 3), -2), 0.0)

        vb = {"t": t, "alpha": alpha, "vw": vw, "ray_mask": ray_mask,
              "sigma_static": out["sigma_static"].reshape(r, s),
              "sigma_dynamic": out["sigma_dynamic"].reshape(r, s)}
        # the reference's per-step regularizers (emernerf training hooks)
        vb["reg_dynamic_sparsity"] = jnp.mean(
            jnp.where(smask, out["sigma_dynamic"].reshape(r, s), 0.0))
        if self.field.use_flow:
            vb["reg_flow_smooth"] = jnp.mean(
                out["flow_fwd"] ** 2 + out["flow_bwd"] ** 2)
            if "flow_cycle" in out:
                vb["reg_flow_cycle"] = jnp.mean(out["flow_cycle"] ** 2)
        if self.field.use_shadow and with_rgb:
            vb["reg_shadow"] = jnp.mean(out["shadow"] ** 2)
        return rendered, vb

    def ray_query_static(self, ray_tested: Dict, key=None,
                         with_rgb: bool = True) -> Tuple[Dict, Dict]:
        """Render the static branch alone (reference emernerf
        renderer_mixin ray_query_static :942)."""
        return self.ray_query(ray_tested, key=key, with_rgb=with_rgb,
                              branch="static")

    def ray_query_dynamic(self, ray_tested: Dict, key=None,
                          with_rgb: bool = True) -> Tuple[Dict, Dict]:
        """Render the dynamic branch alone (reference emernerf
        renderer_mixin ray_query_dynamic :959)."""
        return self.ray_query(ray_tested, key=key, with_rgb=with_rgb,
                              branch="dynamic")
