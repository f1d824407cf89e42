"""ModelMixin lifecycle API + renderable model classes.

Reference: nr3d_lib/models/model_base.py:18-269 (ModelMixin: populate /
ray_test / ray_query / training_* signatures) and the renderer-mixin pattern
(fields/neus/renderer_mixin.py:76-440, fields/nerf/renderer_mixin.py).

The reference composes models by MRO mixin inheritance; here composition is
explicit: a renderable model owns (field net, space, accel) and dispatches
`ray_query` to the L5 strategy functions (which are already free functions
in the reference too — SURVEY.md §7 design table).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
from nr3d_lib_tpu import nn

from nr3d_lib_tpu.models.accelerations import OccGridAccel
from nr3d_lib_tpu.models.spatial import AABBSpace

__all__ = ["ModelMixin", "LoTDNeRFModel", "LoTDNeuSModel"]

Array = jax.Array


class ModelMixin:
    """Lifecycle protocol (reference: model_base.py:18-269)."""

    space = None
    accel = None
    ray_query_cfg: dict = {}

    def populate(self, **kwargs):
        pass

    def model_setup(self):
        pass

    # training hooks (driven by downstream trainer; reference :45-98)
    def training_initialize(self, key, **kwargs):
        pass

    def training_before_per_step(self, it: int, key=None):
        pass

    def training_after_per_step(self, it: int, key=None):
        pass

    @property
    def lifecycle_update_every(self) -> int:
        """Interval at which the EXPENSIVE lifecycle work (occ-grid EMA
        merge/split round trip) actually does anything — the accel's own
        update interval. Trainers that gate `training_before_per_step` to
        an interval must derive it from here, never hardcode one."""
        return int(getattr(self.accel, "update_every", 1) or 1)

    def has_stepwise_schedules(self) -> bool:
        """True if any configured schedule advances per iteration (an
        encoding anneal window or a scheduled inv_s — anything carrying an
        `annealer`). When True, a trainer that gates
        `training_before_per_step` to `lifecycle_update_every` coarsens the
        schedule to interval-sized jumps; run the per-step setters every
        step instead (they are cheap python; the merge/split cost is the
        occ update's, which stays gated because `accel.step` is a no-op
        off-interval)."""
        seen, stack = set(), [self]
        while stack:
            m = stack.pop()
            if id(m) in seen:
                continue
            seen.add(id(m))
            if getattr(m, "annealer", None) is not None:
                return True
            for v in vars(m).values():
                if isinstance(v, nn.Module):
                    stack.append(v)
                elif isinstance(v, (list, tuple)):
                    stack.extend(x for x in v if isinstance(x, nn.Module))
        return False

    def ray_test(self, rays_o: Array, rays_d: Array, near=None, far=None) -> Dict:
        return self.space.ray_test(rays_o, rays_d, near=near, far=far)

    def ray_query(self, ray_tested: Dict, key=None, with_rgb: bool = True) -> Tuple[Dict, Dict]:
        raise NotImplementedError

    def stat_param(self) -> Dict[str, float]:
        from nr3d_lib_tpu.utils import tensor_statistics

        stats = {}
        state = nn.state(self, nn.Param)
        for path, leaf in jax.tree_util.tree_leaves_with_path(state):
            name = "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
            stats.update(tensor_statistics(leaf, prefix=name))
        return stats


class LoTDNeRFModel(nn.Module, ModelMixin):
    """LoTD NeRF + AABB space + occ-grid accel + marched ray query
    (reference: fields/nerf — NeRFRendererMixin + LoTDNeRF)."""

    def __init__(self, *, field_cfg: Optional[dict] = None,
                 space_cfg: Optional[dict] = None,
                 accel_cfg: Optional[dict] = None,
                 ray_query_cfg: Optional[dict] = None, seed: int = 0):
        from nr3d_lib_tpu.models.fields.nerf import LoTDNeRF

        self.field = LoTDNeRF(**(field_cfg or {}), seed=seed)
        self.space = AABBSpace(**(space_cfg or {}))
        self.accel = OccGridAccel(**(accel_cfg or {}))
        self.ray_query_cfg = dict(ray_query_cfg or {})

    # field passthroughs (normalized coords)
    def forward_density(self, x: Array):
        return self.field.forward_density(x)

    def radiance(self, x, v, n, h):
        return self.field.radiance(x, v, n, h)

    def query_density(self, x: Array) -> Array:
        return self.field.forward_density(x)["sigma"]

    def populate(self, key=None):
        self.accel.init(key if key is not None else jax.random.key(0), None)

    def training_before_per_step(self, it: int, key=None):
        self.field.encoding.set_anneal_iter(it)
        self.accel.step(it, key if key is not None else jax.random.key(it), self.query_density)

    def ray_query(self, ray_tested: Dict, key=None, with_rgb: bool = True
                  ) -> Tuple[Dict, Dict]:
        cfg = dict(self.ray_query_cfg)
        mode = cfg.pop("query_mode", "march_occ")
        if mode == "march_occ":
            from nr3d_lib_tpu.graphics.nerf_ray_query import nerf_ray_query_march_occ

            return nerf_ray_query_march_occ(self, self.accel, self.space,
                                            ray_tested, perturb_key=key,
                                            with_rgb=with_rgb, **cfg)
        if mode == "march_occ_compressed":
            from nr3d_lib_tpu.graphics.nerf_ray_query import (
                nerf_ray_query_march_occ_compressed)

            return nerf_ray_query_march_occ_compressed(
                self, self.accel, self.space, ray_tested, perturb_key=key,
                with_rgb=with_rgb, **cfg)
        if mode == "march_occ_multi_upsample_compressed":
            from nr3d_lib_tpu.graphics.nerf_ray_query import (
                nerf_ray_query_march_occ_multi_upsample_compressed)

            return nerf_ray_query_march_occ_multi_upsample_compressed(
                self, self.accel, self.space, ray_tested, perturb_key=key,
                with_rgb=with_rgb, **cfg)
        raise ValueError(f"Unknown query_mode: {mode}")


class LoTDNeuSModel(nn.Module, ModelMixin):
    """LoTD NeuS + AABB space + occ-grid accel + marched multi-upsample query
    (reference: fields/neus/lotd_neus.py:304 LoTDNeuSModel =
    NeusRendererMixin + LoTDNeuS)."""

    def __init__(self, *, field_cfg: Optional[dict] = None,
                 space_cfg: Optional[dict] = None,
                 accel_cfg: Optional[dict] = None,
                 ray_query_cfg: Optional[dict] = None, seed: int = 0):
        from nr3d_lib_tpu.models.fields.neus import LoTDNeuS

        self.field = LoTDNeuS(**(field_cfg or {}), seed=seed)
        self.space = AABBSpace(**(space_cfg or {}))
        self.accel = OccGridAccel(**(accel_cfg or {}))
        self.ray_query_cfg = dict(ray_query_cfg or {})

    def forward_sdf(self, x: Array):
        return self.field.forward_sdf(x)

    def forward_sdf_nablas(self, x: Array):
        return self.field.forward_sdf_nablas(x)

    def forward_inv_s(self):
        return self.field.forward_inv_s()

    def __call__(self, x, v=None, with_rgb=True, with_nablas=True):
        return self.field(x, v, with_rgb=with_rgb, with_nablas=with_nablas)

    def query_occ_val(self, x: Array) -> Array:
        """Occ-grid value query: exp(-|sdf|·k) style — the reference uses
        sigma-or-sdf-specific transforms; for SDF grids occupancy uses
        |sdf| < band, realized as val = band - |sdf|."""
        sdf = self.field.forward_sdf(x)["sdf"]
        inv_s = jax.lax.stop_gradient(self.field.forward_inv_s())
        return jax.nn.sigmoid(-jnp.abs(sdf) * inv_s) * 4.0

    def populate(self, key=None):
        self.accel.init(key if key is not None else jax.random.key(0), self.query_occ_val)

    def training_before_per_step(self, it: int, key=None):
        self.field.implicit_surface.encoding.set_anneal_iter(it)
        self.field.var_ctrl.set_iter(it)
        self.accel.step(it, key if key is not None else jax.random.key(it), self.query_occ_val)

    def training_after_per_step(self, it: int, key=None):
        pass

    def ray_query(self, ray_tested: Dict, key=None, with_rgb: bool = True
                  ) -> Tuple[Dict, Dict]:
        cfg = dict(self.ray_query_cfg)
        mode = cfg.pop("query_mode", "march_occ_multi_upsample")
        if mode == "march_occ_multi_upsample":
            from nr3d_lib_tpu.graphics.neus_ray_query import (
                neus_ray_query_march_occ_multi_upsample)

            return neus_ray_query_march_occ_multi_upsample(
                self, self.accel, self.space, ray_tested,
                perturb_key=key, with_rgb=with_rgb, **cfg)
        if mode == "march_occ_multi_upsample_compressed":
            from nr3d_lib_tpu.graphics.neus_ray_query_variants import (
                neus_ray_query_march_occ_multi_upsample_compressed)

            return neus_ray_query_march_occ_multi_upsample_compressed(
                self, self.accel, self.space, ray_tested, perturb_key=key,
                with_rgb=with_rgb, **cfg)
        if mode == "coarse_multi_upsample":
            from nr3d_lib_tpu.graphics.neus_ray_query import (
                neus_ray_query_coarse_multi_upsample)

            return neus_ray_query_coarse_multi_upsample(
                self, self.space, ray_tested, perturb_key=key,
                with_rgb=with_rgb, **cfg)
        if mode == "sphere_trace":
            from nr3d_lib_tpu.graphics.neus_ray_query import (
                neus_ray_query_sphere_trace)

            return neus_ray_query_sphere_trace(
                self, self.accel, self.space, ray_tested, perturb_key=key,
                with_rgb=with_rgb, **cfg)
        raise ValueError(f"Unknown query_mode: {mode}")
