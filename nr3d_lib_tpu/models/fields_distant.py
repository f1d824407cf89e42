"""Distant-background fields (NeRF++ inverted sphere).

Reference: nr3d_lib/models/fields_distant/nerf/renderer_mixin.py:87-135
(NeRFRendererMixinDistant): points beyond the scene sphere are parameterized
as (x̂·r, 1/r) and sampled uniformly in inverse radius — the NeRF++ scheme
for unbounded backgrounds.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from nr3d_lib_tpu import nn

from nr3d_lib_tpu.graphics.nerf import ray_alpha_to_vw, tau_to_alpha
from nr3d_lib_tpu.models.blocks import MLP
from nr3d_lib_tpu.models.model_base import ModelMixin
from nr3d_lib_tpu.models.embedders import get_embedder
from nr3d_lib_tpu.models.fields.nerf import RadianceNet, trunc_exp

__all__ = ["NeRFDistant", "nerf_distant_ray_query", "NeRFDistantModel",
           "composite_inner_distant", "ray_sphere_exit_t"]

Array = jax.Array


def inverted_sphere_coords(x: Array, radius: float = 1.0) -> Array:
    """World point outside the sphere → (x̂, 1/r) 4D NeRF++ coords."""
    r = jnp.linalg.norm(x, axis=-1, keepdims=True) / radius
    return jnp.concatenate([x / jnp.maximum(r * radius, 1e-8), 1.0 / jnp.maximum(r, 1.0)], -1)


class NeRFDistant(nn.Module):
    """Background NeRF over inverted-sphere coords
    (reference: fields_distant small nets + mixin)."""

    def __init__(self, *, pos_embed_cfg: Optional[dict] = None,
                 D: int = 3, W: int = 64, n_geo_feat: int = 15,
                 radiance_cfg: Optional[dict] = None,
                 radius: float = 1.0, seed: int = 0):
        self.radius = radius
        self.embed_fn, pos_dim = get_embedder(
            pos_embed_cfg or {"type": "sinusoidal", "n_frequencies": 4}, 4)
        self.sigma_mlp = MLP(pos_dim, 1 + n_geo_feat, D=D, W=W, seed=seed)
        self.radiance = RadianceNet(n_extra_feat=n_geo_feat,
                                    **(radiance_cfg or {}), seed=seed + 1)

    def forward_density(self, x_world: Array) -> Dict[str, Array]:
        x4 = inverted_sphere_coords(x_world, self.radius)
        h = self.sigma_mlp(self.embed_fn(x4))
        return {"sigma": trunc_exp(h[..., 0]), "h": h[..., 1:]}

    def __call__(self, x_world: Array, v: Optional[Array] = None
                 ) -> Dict[str, Array]:
        out = self.forward_density(x_world)
        out["rgb"] = self.radiance(x_world, v, None, out["h"])
        return out


def nerf_distant_ray_query(model: NeRFDistant, rays_o: Array, rays_d: Array,
                           far_inner: Array, *, n_samples: int = 32,
                           perturb_key=None
                           ) -> Tuple[Dict[str, Array], Dict[str, Array]]:
    """Sample the background shell uniformly in inverse radius beyond the
    inner sphere exit (reference: mixin's sphere-shell marching :87-135)."""
    r0 = rays_o.shape[0]
    # t where the ray exits the scene sphere ≈ far_inner; sample 1/s ∈ (0,1]
    if perturb_key is None:
        inv_s = jnp.linspace(1.0, 1.0 / n_samples, n_samples)
        inv_s = jnp.broadcast_to(inv_s, (r0, n_samples))
    else:
        edges = jnp.linspace(1.0, 0.0, n_samples + 1)
        u = jax.random.uniform(perturb_key, (r0, n_samples))
        inv_s = edges[:-1] - u * (edges[:-1] - edges[1:])
    t = far_inner[:, None] / jnp.maximum(inv_s, 1e-3)           # [R,S] growing
    x = rays_o[:, None, :] + rays_d[:, None, :] * t[..., None]
    flat = x.reshape(-1, 3)
    den = model.forward_density(flat)
    sigma = den["sigma"].reshape(r0, n_samples)
    dt = jnp.concatenate([t[:, 1:] - t[:, :-1], 1e8 * jnp.ones_like(t[:, :1])], -1)
    alpha = tau_to_alpha(sigma * dt)
    v = jnp.broadcast_to(rays_d[:, None, :], x.shape).reshape(-1, 3)
    rgb = model.radiance(flat, v, None, den["h"]).reshape(r0, n_samples, 3)
    vw = ray_alpha_to_vw(alpha)
    rendered = {"rgb_volume": jnp.sum(vw[..., None] * rgb, -2),
                "mask_volume": jnp.sum(vw, -1),
                "depth_volume": jnp.sum(vw * t, -1)
                / jnp.maximum(jnp.sum(vw, -1), 1e-10)}
    return rendered, {"t": t, "alpha": alpha, "vw": vw}


def ray_sphere_exit_t(rays_o: Array, rays_d: Array, r) -> Tuple[Array, Array]:
    """Far intersection t of unit-direction rays with the sphere |x| = r
    (reference: renderer_mixin.py:31 ray_sphere_intersect, far root).

    r broadcasts against rays ([R] or [R,S]). Returns (t, valid)."""
    b = jnp.sum(rays_o * rays_d, -1)                                  # [R]
    c = jnp.sum(rays_o * rays_o, -1)
    if jnp.ndim(r) > 1:
        b, c = b[:, None], c[:, None]
    disc = b * b - (c - jnp.asarray(r) ** 2)
    t = -b + jnp.sqrt(jnp.maximum(disc, 0.0))
    return t, (disc > 0) & (t > 0)


class NeRFDistantModel(nn.Module, ModelMixin):
    """Renderable distant-background model (reference:
    NeRFRendererMixinDistant renderer_mixin.py:87-383): shell-based marching
    between radius_scale_min and radius_scale_max around the inner scene
    sphere, with the reference's two interval types and two live sample
    modes, plus the ModelMixin lifecycle so downstream trainers can drive it
    exactly like the close-range models.

    interval_type: 'inverse_proportional' (shells uniform in 1/r — NeRF++)
        or 'logarithm' (shells uniform in log r; cannot reach infinity).
    sample_mode: 'spherical' (sample where the ray crosses each shell,
        renderer_mixin.py 'fixed_spherical_shells') or 'lindisp'
        (t = shell radius directly, 'moving_spherical_shells').
    """

    def __init__(self, *, field_cfg: Optional[dict] = None,
                 radius_scale_min: float = 1.0,
                 radius_scale_max: float = 1000.0,
                 include_inf_distance: bool = True,
                 interval_type: str = "inverse_proportional",
                 sample_mode: str = "spherical",
                 n_samples: int = 32, seed: int = 0):
        assert interval_type in ("inverse_proportional", "logarithm")
        assert sample_mode in ("spherical", "lindisp")
        self.field = NeRFDistant(**(field_cfg or {}), seed=seed)
        self.radius_scale_min = float(radius_scale_min)
        self.radius_scale_max = float(radius_scale_max)
        self.include_inf_distance = bool(include_inf_distance)
        self.interval_type = interval_type
        self.sample_mode = sample_mode
        self.n_samples = int(n_samples)
        self.space = None   # unbounded; ray_test passes every ray
        self.accel = None

    # lifecycle (reference :115,145-161 — distant bg has no accel to step)
    def populate(self, key=None):
        pass

    def training_before_per_step(self, it: int, key=None):
        pass

    def training_after_per_step(self, it: int, key=None):
        pass

    def ray_test(self, rays_o: Array, rays_d: Array, near=None, far=None
                 ) -> Dict[str, Array]:
        """Background covers every ray direction (reference :164): near is
        where the ray exits the inner sphere (radius_scale_min)."""
        t_exit, _ = ray_sphere_exit_t(rays_o, rays_d, self.radius_scale_min)
        r = rays_o.shape[0]
        return {"rays_o": rays_o, "rays_d": rays_d, "near": t_exit,
                "far": jnp.full((r,), jnp.inf, rays_o.dtype),
                "mask": jnp.ones((r,), bool), "num_rays": r}

    def _shell_radii(self, n: int, key=None) -> Array:
        """[S] ascending shell radii per interval_type (:182-199)."""
        if self.interval_type == "inverse_proportional":
            hi, lo = 1.0 / self.radius_scale_min, 1.0 / self.radius_scale_max
            step = (hi - lo) / n
            r_reci = hi - jnp.arange(n, dtype=jnp.float32) * step
            if key is not None:
                r_reci = jnp.maximum(
                    r_reci - jax.random.uniform(key, (n,)) * step, 1e-5)
            return 1.0 / r_reci
        lo, hi = np.log10(self.radius_scale_min), \
            np.log10(self.radius_scale_max)
        step = (hi - lo) / n
        r_log = lo + jnp.arange(n, dtype=jnp.float32) * step
        if key is not None:
            r_log = r_log + jax.random.uniform(key, (n,)) * step
        return 10.0 ** r_log

    def ray_query(self, ray_tested: Dict, key=None, with_rgb: bool = True
                  ) -> Tuple[Dict, Dict]:
        rays_o, rays_d = ray_tested["rays_o"], ray_tested["rays_d"]
        r0 = rays_o.shape[0]
        s = self.n_samples
        radii = self._shell_radii(s, key)                          # [S]
        if self.sample_mode == "spherical":
            t, valid = ray_sphere_exit_t(
                rays_o, rays_d, jnp.broadcast_to(radii, (r0, s)))
        else:  # lindisp: t IS the shell radius (origin ≈ sphere center)
            t = jnp.broadcast_to(radii, (r0, s))
            valid = jnp.ones_like(t, bool)
        t = jnp.maximum(t, ray_tested["near"][:, None])
        dt_last = (1e8 if self.include_inf_distance
                   else self.radius_scale_max)
        dt = jnp.concatenate(
            [t[:, 1:] - t[:, :-1], jnp.full_like(t[:, :1], dt_last)], -1)
        x = rays_o[:, None, :] + rays_d[:, None, :] * t[..., None]
        flat = x.reshape(-1, 3)
        den = self.field.forward_density(flat)
        sigma = jnp.where(valid, den["sigma"].reshape(r0, s), 0.0)
        alpha = tau_to_alpha(sigma * jnp.maximum(dt, 0.0))
        vw = ray_alpha_to_vw(alpha)
        acc = jnp.sum(vw, -1)
        rendered = {"mask_volume": acc,
                    "depth_volume": jnp.sum(vw * t, -1)
                    / jnp.maximum(acc, 1e-10)}
        vb = {"t": t, "alpha": alpha, "vw": vw,
              "ray_mask": ray_tested["mask"]}
        if with_rgb:
            v = jnp.broadcast_to(rays_d[:, None, :], x.shape).reshape(-1, 3)
            rgb = self.field.radiance(flat, v, None, den["h"]
                                      ).reshape(r0, s, 3)
            rendered["rgb_volume"] = jnp.sum(vw[..., None] * rgb, -2)
        return rendered, vb


def composite_inner_distant(rendered_inner: Dict[str, Array],
                            rendered_distant: Dict[str, Array]
                            ) -> Dict[str, Array]:
    """Blend a distant background BEHIND a close-range render: the
    background sees only the transmittance the foreground leaves over
    (the downstream-neuralsim composition the reference mixins feed)."""
    acc_fg = rendered_inner["mask_volume"]
    leftover = (1.0 - acc_fg)[..., None]
    out = dict(rendered_inner)
    if "rgb_volume" in rendered_inner and "rgb_volume" in rendered_distant:
        out["rgb_volume"] = (rendered_inner["rgb_volume"]
                             + leftover * rendered_distant["rgb_volume"])
    out["mask_volume"] = acc_fg + (1.0 - acc_fg) * \
        rendered_distant["mask_volume"]
    return out
