"""NeRF ray-query strategies.

Reference: nr3d_lib/graphics/nerf/nerf_ray_query.py:29 (march_occ) /
:190 (march_occ_multi_upsample_compressed). Layout: dense [R, S] sample
slabs with validity masks (padding never contributes: alpha forced to 0),
avoiding the reference's ragged packed buffers on the hot path. The
"compressed" path drops dead samples before the expensive radiance query via
pack-compaction (reference packed_volume_render_compression).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from nr3d_lib_tpu.graphics import pack_ops as po
from nr3d_lib_tpu.graphics.nerf import ray_alpha_to_vw, tau_to_alpha

__all__ = ["nerf_ray_query_march_occ", "nerf_ray_query_march_occ_compressed",
           "nerf_ray_query_march_occ_multi_upsample_compressed",
           "nerf_ray_query_fixed"]

Array = jax.Array


def _composite(t: Array, alpha: Array, rgb: Array, ray_mask: Array
               ) -> Tuple[Dict[str, Array], Dict[str, Array]]:
    vw = ray_alpha_to_vw(alpha)                              # [R,S]
    acc = jnp.sum(vw, -1)
    rgb_out = jnp.sum(vw[..., None] * rgb, -2)
    depth = jnp.sum(vw * t, -1) / jnp.maximum(acc, 1e-10)
    rendered = {
        "rgb_volume": jnp.where(ray_mask[:, None], rgb_out, 0.0),
        "depth_volume": jnp.where(ray_mask, depth, 0.0),
        "mask_volume": jnp.where(ray_mask, acc, 0.0),
    }
    volume_buffer = {"t": t, "alpha": alpha, "vw": vw, "rgb": rgb,
                     "ray_mask": ray_mask}
    return rendered, volume_buffer


def nerf_ray_query_march_occ(model, accel, space, ray_tested: Dict, *,
                             perturb_key=None,
                             with_rgb: bool = True
                             ) -> Tuple[Dict[str, Array], Dict[str, Array]]:
    """Occupancy-marched NeRF query (reference: nerf_ray_query.py:29
    nerf_ray_query_march_occ).

    model: object with forward_density(x)->{sigma,h} and
    radiance(x,v,n,h)->rgb; x in normalized [-1,1].
    """
    rays_o, rays_d = ray_tested["rays_o"], ray_tested["rays_d"]
    near, far, ray_mask = ray_tested["near"], ray_tested["far"], ray_tested["mask"]
    o_n, d_n = space.normalize_rays(rays_o, rays_d)
    t, dt, smask = accel.ray_march(o_n, d_n, near, far, perturb_key=perturb_key)
    x = o_n[:, None, :] + d_n[:, None, :] * t[..., None]      # [R,S,3]
    r, s = t.shape
    den = model.forward_density(x.reshape(r * s, 3))
    sigma = den["sigma"].reshape(r, s)
    alpha = tau_to_alpha(sigma * dt)
    alpha = jnp.where(smask & ray_mask[:, None], alpha, 0.0)
    if with_rgb:
        v = jnp.broadcast_to(rays_d[:, None, :], (r, s, 3)).reshape(r * s, 3)
        rgb = model.radiance(x.reshape(r * s, 3), v, None, den["h"]).reshape(r, s, 3)
    else:
        rgb = jnp.zeros((r, s, 3), t.dtype)
    return _composite(t, alpha, rgb, ray_mask)


def nerf_ray_query_march_occ_compressed(
        model, accel, space, ray_tested: Dict, *,
        compression_factor: float = 0.25, early_stop_eps: float = 1e-4,
        radiance_compression_factor: float = 0.5,
        perturb_key=None, with_rgb: bool = True
        ) -> Tuple[Dict[str, Array], Dict[str, Array]]:
    """Occupancy-marched NeRF query with TWO compactions on the hot path
    (reference: nerf_ray_query.py:190 march_occ_multi_upsample_compressed +
    packed_volume_render_compression, pack_ops.py:286):

      1. compact the marched slab on the occupancy mask BEFORE the density
         query — the encode+MLP only touch occupied samples (the dense-slab
         march evaluates every [R,S] slot, occupied or not);
      2. compact again on accumulated transmittance (early termination,
         `radiance_compression_factor` of the first budget) before the
         radiance query.

    Compaction is ROW-LOCAL (`pack_ops.budget_indices`), not a global
    sort/scatter over all samples.
    Each ray drops its own tail beyond the budget rather than whole rays.

    Truncation semantics (vs the reference's dynamically-sized packed
    buffers, which keep ALL occupied samples): a ray whose occupied count
    exceeds ``compression_factor × S`` is truncated FAR-FIRST — its nearest
    budget samples survive. Size ``compression_factor`` to the scene's
    per-ray occupancy; with a fresh fully-occupied grid this mode
    under-samples the far field (use plain ``march_occ`` until the grid has
    pruned, as the examples do).
    """
    rays_o, rays_d = ray_tested["rays_o"], ray_tested["rays_d"]
    near, far, ray_mask = ray_tested["near"], ray_tested["far"], ray_tested["mask"]
    o_n, d_n = space.normalize_rays(rays_o, rays_d)
    t, dt, smask = accel.ray_march(o_n, d_n, near, far, perturb_key=perturb_key)
    r, s = t.shape
    smask = smask & ray_mask[:, None]

    # --- compaction 1: occupancy (per-ray budget)
    b1 = max(int(s * compression_factor), 1)
    (t1, dt1), valid1 = po.dense_to_budgeted([t, dt], smask, b1)
    x1 = o_n[:, None, :] + d_n[:, None, :] * t1[..., None]    # [R,B1,3]

    den = model.forward_density(x1.reshape(r * b1, 3))
    sigma = den["sigma"].reshape(r, b1)
    alpha1 = jnp.where(valid1, tau_to_alpha(sigma * dt1), 0.0)

    # --- compaction 2: early termination before the radiance net
    trans = jnp.cumprod(jnp.concatenate(
        [jnp.ones_like(alpha1[:, :1]), 1.0 - alpha1[:, :-1]], -1), -1)
    keep2 = valid1 & (alpha1 > 0) & (trans > early_stop_eps)
    b2 = max(int(b1 * radiance_compression_factor), 1)
    (t2, alpha2, h2), valid2 = po.dense_to_budgeted(
        [t1, alpha1, den["h"].reshape(r, b1, -1)], keep2, b2)
    alpha2 = jnp.where(valid2, alpha2, 0.0)

    vw = ray_alpha_to_vw(alpha2)
    acc = jnp.sum(vw, -1)
    depth = jnp.sum(vw * t2, -1) / jnp.maximum(acc, 1e-10)
    rendered = {"mask_volume": jnp.where(ray_mask, acc, 0.0),
                "depth_volume": jnp.where(ray_mask, depth, 0.0)}
    if with_rgb:
        x2 = o_n[:, None, :] + d_n[:, None, :] * t2[..., None]
        v2 = jnp.broadcast_to(rays_d[:, None, :], (r, b2, 3))
        rgb = model.radiance(x2.reshape(r * b2, 3), v2.reshape(r * b2, 3),
                             None, h2.reshape(r * b2, -1)).reshape(r, b2, 3)
        rendered["rgb_volume"] = jnp.where(
            ray_mask[:, None], jnp.sum(vw[..., None] * rgb, -2), 0.0)
    # packed view for downstream pack_ops consumers
    ridx2 = jnp.where(valid2, jnp.arange(r, dtype=jnp.int32)[:, None], r)
    volume_buffer = {"t_packed": t2.reshape(-1), "ridx": ridx2.reshape(-1),
                     "alpha_packed": alpha2.reshape(-1),
                     "vw_packed": vw.reshape(-1), "ray_mask": ray_mask,
                     "t": t2, "alpha": alpha2, "vw": vw, "valid": valid2,
                     "n_compact": jnp.sum(valid2)}
    return rendered, volume_buffer


def nerf_ray_query_march_occ_multi_upsample_compressed(
        model, accel, space, ray_tested: Dict, *,
        compression_factor: float = 0.25, n_fine: int = 32,
        n_coarse: int = 0, early_stop_eps: float = 1e-4,
        radiance_compression_factor: float = 0.5,
        perturb_key=None, with_rgb: bool = True
        ) -> Tuple[Dict[str, Array], Dict[str, Array]]:
    """Occupancy-marched NeRF query with a PDF upsample round between the
    march and the compression (reference: nerf_ray_query.py:190
    nerf_ray_query_march_occ_multi_upsample_compressed).

    Pipeline (dense-slab form of the reference's packed pipeline):
      1. occ-march → budget-compact to B1 = compression_factor·S samples
         (optionally union'd with `n_coarse` uniform coarse samples — the
         reference's combine_marched_and_coarse);
      2. density at the B1 candidates under stop_gradient (the reference's
         `with torch.no_grad()` upsample block — XLA dead-code-eliminates
         the encode backward for this round);
      3. per-ray CDF from the candidate alphas → inverse-CDF sample
         `n_fine` fine depths (reference packed_sample_cdf) — this is
         what recovers thin structures the march's fixed step misses;
      4. merge-sort fine+candidate depths, re-difference dt, query density
         once more, then early-termination compact before the radiance
         net (packed_volume_render_compression analogue).
    """
    rays_o, rays_d = ray_tested["rays_o"], ray_tested["rays_d"]
    near, far, ray_mask = (ray_tested["near"], ray_tested["far"],
                           ray_tested["mask"])
    o_n, d_n = space.normalize_rays(rays_o, rays_d)
    key_m = key_u = None
    if perturb_key is not None:
        key_m, key_u = jax.random.split(perturb_key)
    t, dt, smask = accel.ray_march(o_n, d_n, near, far, perturb_key=key_m)
    r, s = t.shape
    smask = smask & ray_mask[:, None]

    # --- compaction 1: occupancy (per-ray budget), + optional coarse union
    b1 = max(int(s * compression_factor), 1)
    (t1,), valid1 = po.dense_to_budgeted([t], smask, b1)
    if n_coarse > 0:
        from nr3d_lib_tpu.graphics.raysample import batch_sample_step_linear

        t_c, _ = batch_sample_step_linear(near, far, n_coarse, key_m)
        t1 = jnp.concatenate([t1, t_c], -1)
        valid1 = jnp.concatenate(
            [valid1, jnp.broadcast_to(ray_mask[:, None], t_c.shape)], -1)
        b1 = b1 + n_coarse

    def sort_tv(t_, valid_):
        key = jnp.where(valid_, t_, jnp.inf)
        key_s, v_s = jax.lax.sort((key, valid_.astype(jnp.int32)),
                                  num_keys=1, is_stable=True)
        v_s = v_s.astype(bool)
        return jnp.where(v_s, key_s, far[:, None]), v_s

    t1, valid1 = sort_tv(t1, valid1)

    # --- upsample round under stop_gradient (reference :320-341)
    def density_at(tq, n):
        x = o_n[:, None, :] + d_n[:, None, :] * tq[..., None]
        return model.forward_density(
            x.reshape(r * n, 3))["sigma"].reshape(r, n)

    sigma_u = jax.lax.stop_gradient(density_at(t1, b1))
    dt_u = jnp.diff(t1, axis=-1, append=far[:, None])
    alpha_u = jnp.where(valid1, tau_to_alpha(sigma_u * jnp.maximum(dt_u, 0.0)),
                        0.0)
    from nr3d_lib_tpu.graphics.raysample import batch_sample_cdf

    cdf = jnp.cumsum(alpha_u, -1)
    cdf = cdf / jnp.maximum(cdf[:, -1:], 1e-5)
    t_fine = batch_sample_cdf(t1, cdf, n_fine, key_u)          # [R, F]
    t_fine = jax.lax.stop_gradient(
        jnp.clip(t_fine, near[:, None], far[:, None]))

    # --- merge fine + candidates, re-difference, final density
    t_all = jnp.concatenate([t1, t_fine], -1)
    valid_all = jnp.concatenate(
        [valid1, jnp.broadcast_to(ray_mask[:, None], t_fine.shape)], -1)
    t_all, valid_all = sort_tv(t_all, valid_all)
    n_all = b1 + n_fine
    dt_all = jnp.maximum(jnp.diff(t_all, axis=-1, append=far[:, None]), 0.0)
    den = model.forward_density(
        (o_n[:, None, :] + d_n[:, None, :] * t_all[..., None]
         ).reshape(r * n_all, 3))
    sigma = den["sigma"].reshape(r, n_all)
    alpha1 = jnp.where(valid_all, tau_to_alpha(sigma * dt_all), 0.0)

    # --- compaction 2: early termination before the radiance net
    trans = jnp.cumprod(jnp.concatenate(
        [jnp.ones_like(alpha1[:, :1]), 1.0 - alpha1[:, :-1]], -1), -1)
    keep2 = valid_all & (alpha1 > 0) & (trans > early_stop_eps)
    b2 = max(int(n_all * radiance_compression_factor), 1)
    (t2, alpha2, h2), valid2 = po.dense_to_budgeted(
        [t_all, alpha1, den["h"].reshape(r, n_all, -1)], keep2, b2)
    alpha2 = jnp.where(valid2, alpha2, 0.0)

    vw = ray_alpha_to_vw(alpha2)
    acc = jnp.sum(vw, -1)
    depth = jnp.sum(vw * t2, -1) / jnp.maximum(acc, 1e-10)
    rendered = {"mask_volume": jnp.where(ray_mask, acc, 0.0),
                "depth_volume": jnp.where(ray_mask, depth, 0.0)}
    if with_rgb:
        x2 = o_n[:, None, :] + d_n[:, None, :] * t2[..., None]
        v2 = jnp.broadcast_to(rays_d[:, None, :], (r, b2, 3))
        rgb = model.radiance(x2.reshape(r * b2, 3), v2.reshape(r * b2, 3),
                             None, h2.reshape(r * b2, -1)).reshape(r, b2, 3)
        rendered["rgb_volume"] = jnp.where(
            ray_mask[:, None], jnp.sum(vw[..., None] * rgb, -2), 0.0)
    ridx2 = jnp.where(valid2, jnp.arange(r, dtype=jnp.int32)[:, None], r)
    volume_buffer = {"t_packed": t2.reshape(-1), "ridx": ridx2.reshape(-1),
                     "alpha_packed": alpha2.reshape(-1),
                     "vw_packed": vw.reshape(-1), "ray_mask": ray_mask,
                     "t": t2, "alpha": alpha2, "vw": vw, "valid": valid2,
                     "n_compact": jnp.sum(valid2)}
    return rendered, volume_buffer


def nerf_ray_query_fixed(model, space, ray_tested: Dict, *, n_samples: int = 128,
                         perturb_key=None
                         ) -> Tuple[Dict[str, Array], Dict[str, Array]]:
    """Fixed-count stratified sampling without acceleration — the minimum
    end-to-end slice (SURVEY.md §7 build step 3)."""
    from nr3d_lib_tpu.graphics.raysample import batch_sample_step_linear

    rays_o, rays_d = ray_tested["rays_o"], ray_tested["rays_d"]
    near, far, ray_mask = ray_tested["near"], ray_tested["far"], ray_tested["mask"]
    o_n, d_n = space.normalize_rays(rays_o, rays_d)
    t, dt = batch_sample_step_linear(near, far, n_samples, perturb_key)
    x = o_n[:, None, :] + d_n[:, None, :] * t[..., None]
    r, s = t.shape
    den = model.forward_density(x.reshape(r * s, 3))
    sigma = den["sigma"].reshape(r, s)
    alpha = tau_to_alpha(sigma * dt)
    alpha = jnp.where(ray_mask[:, None], alpha, 0.0)
    v = jnp.broadcast_to(rays_d[:, None, :], (r, s, 3)).reshape(r * s, 3)
    rgb = model.radiance(x.reshape(r * s, 3), v, None, den["h"]).reshape(r, s, 3)
    return _composite(t, alpha, rgb, ray_mask)
