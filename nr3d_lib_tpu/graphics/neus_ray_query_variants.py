"""NeuS ray-query variants: compressed, dynamic (time), batched (latent).

Reference: neus_ray_query.py:732 (march_occ_multi_upsample_compressed),
fields_dynamic/neus/renderer_mixin.py:76 (NeusRendererMixinDynamic query),
fields_conditional/neus/renderer_mixin.py:25 (NeuSRendererMixinBatched).

The compressed variant drops samples whose accumulated transmittance is
below threshold *before* the expensive radiance/nablas query — here this
is pack-compaction into a smaller static-capacity buffer rather than the
reference's `packed_volume_render_compression` resize.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from nr3d_lib_tpu.graphics import pack_ops as po
from nr3d_lib_tpu.graphics.nerf import ray_alpha_to_vw
from nr3d_lib_tpu.graphics.neus import neus_packed_sdf_to_alpha, neus_ray_sdf_to_alpha
from nr3d_lib_tpu.graphics.neus_ray_query import _upsample_rounds
from nr3d_lib_tpu.graphics.raysample import batch_sample_step_linear

__all__ = ["neus_ray_query_march_occ_multi_upsample_compressed",
           "neus_ray_query_dynamic", "neus_ray_query_batched",
           "neus_ray_query_batched_dynamic"]

Array = jax.Array

_BIG_SDF = 1e4


def neus_ray_query_march_occ_multi_upsample_compressed(
        model, accel, space, ray_tested: Dict, *,
        upsample_inv_s_factors: Sequence[float] = (1.0, 4.0, 16.0),
        n_importance: int = 32, upsample_inv_s: float = 64.0,
        compression_factor: float = 0.25, early_stop_eps: float = 1e-4,
        march_budget_factor: float = 1.0,
        perturb_key=None, with_rgb: bool = True
        ) -> Tuple[Dict[str, Array], Dict[str, Array]]:
    """March + upsample, then COMPACT to the surviving samples before the
    RGB/nablas query (reference :732). The packed radiance query touches
    ~compression_factor × fewer samples.

    ``march_budget_factor`` (OPT-IN, default 1.0 = off) additionally
    budget-compacts the marched slab to ``factor × S_max`` slots per ray
    BEFORE the upsample loop, shrinking every upsample round's SDF query
    and merge-sort. Unlike the reference's packed marcher (which keeps ALL
    occupied samples, dynamically sized), a ray whose occupied-sample count
    exceeds the budget is truncated FAR-FIRST: the nearest ``budget``
    occupied samples survive, everything beyond gets no samples and no
    gradient. Only set < 1.0 when the occupancy grid is known to be sparse
    enough (e.g. converged object scenes; per-ray occupancy ≲ factor) —
    with a freshly-initialized (fully-occupied) grid this would silently
    drop the far half of every ray and bias early training."""
    rays_o, rays_d = ray_tested["rays_o"], ray_tested["rays_d"]
    near, far, ray_mask = ray_tested["near"], ray_tested["far"], ray_tested["mask"]
    o_n, d_n = space.normalize_rays(rays_o, rays_d)
    key_m = None
    if perturb_key is not None:
        perturb_key, key_m = jax.random.split(perturb_key)
    t, dt, smask = accel.ray_march(o_n, d_n, near, far, perturb_key=key_m)

    def sdf_fn(x):
        return model.forward_sdf(x)["sdf"]

    if march_budget_factor < 1.0:
        b0 = max(int(t.shape[1] * march_budget_factor), 1)
        (t,), smask = po.dense_to_budgeted([t], smask, b0)

    t, valid = _upsample_rounds(sdf_fn, o_n, d_n, t, smask, far,
                                upsample_inv_s, upsample_inv_s_factors,
                                n_importance, perturb_key)
    r, s = t.shape
    # cheap SDF-only pass → alphas → keep-mask (early termination)
    x = o_n[:, None, :] + d_n[:, None, :] * t[..., None]
    sdf = jnp.where(valid, sdf_fn(x.reshape(r * s, 3)).reshape(r, s), _BIG_SDF)
    inv_s = model.forward_inv_s()
    alpha = neus_ray_sdf_to_alpha(sdf, inv_s, append_cdf_1=True)
    alpha = jnp.where(valid & ray_mask[:, None], alpha, 0.0)
    trans_excl = jnp.cumprod(
        jnp.concatenate([jnp.ones_like(alpha[:, :1]), 1.0 - alpha[:, :-1]], -1),
        axis=-1)
    keep = valid & (trans_excl > early_stop_eps) & (alpha > 0)

    # ROW-LOCAL budgeted compaction (pack_ops.budget_indices, not a global
    # sort/scatter over all samples). The samples dropped
    # beyond each ray's budget are its lowest-transmittance tail; a
    # saturated buffer can never drop whole far rays.
    b1 = max(int(s * compression_factor), 1)
    (t_b,), valid_b = po.dense_to_budgeted([t], keep, b1)
    x_b = o_n[:, None, :] + d_n[:, None, :] * t_b[..., None]   # [R,B,3]
    v_b = jnp.broadcast_to(rays_d[:, None, :], (r, b1, 3))

    out = model(x_b.reshape(r * b1, 3), v_b.reshape(r * b1, 3),
                with_rgb=with_rgb, with_nablas=True)
    sdf_b = jnp.where(valid_b, out["sdf"].reshape(r, b1), _BIG_SDF)
    alpha_b = jnp.where(valid_b,
                        neus_ray_sdf_to_alpha(sdf_b, inv_s,
                                              append_cdf_1=True), 0.0)
    vw = ray_alpha_to_vw(alpha_b)
    acc = jnp.sum(vw, -1)
    depth = jnp.sum(vw * t_b, -1) / jnp.maximum(acc, 1e-10)
    rendered = {"mask_volume": jnp.where(ray_mask, acc, 0.0),
                "depth_volume": jnp.where(ray_mask, depth, 0.0)}
    if with_rgb:
        rgb = out["rgb"].reshape(r, b1, 3)
        rendered["rgb_volume"] = jnp.where(
            ray_mask[:, None], jnp.sum(vw[..., None] * rgb, -2), 0.0)
    nablas = out.get("nablas")
    if nablas is not None:
        nrm = jnp.sum(vw[..., None] * nablas.reshape(r, b1, 3), -2)
        rendered["normals_volume"] = jnp.where(ray_mask[:, None], nrm, 0.0)
    ridx = jnp.where(valid_b, jnp.arange(r, dtype=jnp.int32)[:, None],
                     r).reshape(-1)
    vb = {"t_packed": t_b.reshape(-1), "ridx": ridx,
          "alpha_packed": alpha_b.reshape(-1), "vw_packed": vw.reshape(-1),
          "nablas_packed": nablas.reshape(-1, 3) if nablas is not None
          else None,
          "t": t_b, "alpha": alpha_b, "vw": vw, "valid": valid_b,
          "ray_mask": ray_mask, "n_compact": jnp.sum(valid_b)}
    return rendered, vb


def neus_ray_query_dynamic(model, space, ray_tested: Dict, ts: Array, *,
                           n_coarse: int = 64,
                           upsample_inv_s_factors: Sequence[float] = (1.0, 4.0),
                           n_importance: int = 16,
                           upsample_inv_s: float = 64.0,
                           perturb_key=None, with_rgb: bool = True
                           ) -> Tuple[Dict, Dict]:
    """Time-conditioned NeuS query (reference: NeusRendererMixinDynamic):
    every SDF/radiance query carries the per-ray timestamp."""
    rays_o, rays_d = ray_tested["rays_o"], ray_tested["rays_d"]
    near, far, ray_mask = ray_tested["near"], ray_tested["far"], ray_tested["mask"]
    o_n, d_n = space.normalize_rays(rays_o, rays_d)
    key_c = None
    if perturb_key is not None:
        perturb_key, key_c = jax.random.split(perturb_key)
    t, _ = batch_sample_step_linear(near, far, n_coarse, key_c)
    valid = jnp.ones_like(t, bool)
    r = t.shape[0]

    def sdf_fn_flat(x):
        s = x.shape[0] // r
        ts_rep = jnp.repeat(ts, s)
        return model.implicit_surface.forward_sdf(x, ts_rep)["sdf"]

    t, valid = _upsample_rounds(sdf_fn_flat, o_n, d_n, t, valid, far,
                                upsample_inv_s, upsample_inv_s_factors,
                                n_importance, perturb_key)
    r, s = t.shape
    x = (o_n[:, None, :] + d_n[:, None, :] * t[..., None]).reshape(r * s, 3)
    ts_rep = jnp.repeat(ts, s)
    v = jnp.broadcast_to(rays_d[:, None, :], (r, s, 3)).reshape(r * s, 3)
    out = model(x, v, ts_rep, with_rgb=with_rgb)
    sdf = jnp.where(valid, out["sdf"].reshape(r, s), _BIG_SDF)
    alpha = neus_ray_sdf_to_alpha(sdf, model.forward_inv_s(), append_cdf_1=True)
    alpha = jnp.where(valid & ray_mask[:, None], alpha, 0.0)
    vw = ray_alpha_to_vw(alpha)
    acc = jnp.sum(vw, -1)
    rendered = {"mask_volume": jnp.where(ray_mask, acc, 0.0),
                "depth_volume": jnp.where(
                    ray_mask, jnp.sum(vw * t, -1) / jnp.maximum(acc, 1e-10), 0.0)}
    if with_rgb:
        rgb = out["rgb"].reshape(r, s, 3)
        rendered["rgb_volume"] = jnp.where(
            ray_mask[:, None], jnp.sum(vw[..., None] * rgb, -2), 0.0)
    return rendered, {"t": t, "alpha": alpha, "vw": vw,
                      "nablas": out["nablas"].reshape(r, s, 3)}


def neus_ray_query_batched(model, space, ray_tested: Dict, z: Array,
                           bidx: Array, *, n_coarse: int = 64,
                           upsample_inv_s_factors: Sequence[float] = (1.0, 4.0),
                           n_importance: int = 16, upsample_inv_s: float = 64.0,
                           per_instance_z: bool = False,
                           perturb_key=None, with_rgb: bool = True
                           ) -> Tuple[Dict, Dict]:
    """Latent-conditioned batched query (reference: NeuSRendererMixinBatched):
    z [B, z_dim]; bidx [R] instance per ray; rays of several instances render
    in one launch.

    per_instance_z=True: the field's API is (x, z_table, bidx) — the
    style/grower family, where growing params per POINT would be ruinous
    (reference: style_lotd_sdf.py takes the per-instance table)."""
    rays_o, rays_d = ray_tested["rays_o"], ray_tested["rays_d"]
    near, far, ray_mask = ray_tested["near"], ray_tested["far"], ray_tested["mask"]
    o_n, d_n = space.normalize_rays(rays_o, rays_d, bidx) \
        if getattr(space, "n_batch", None) else \
        space.normalize_rays(rays_o, rays_d)
    key_c = None
    if perturb_key is not None:
        perturb_key, key_c = jax.random.split(perturb_key)
    t, _ = batch_sample_step_linear(near, far, n_coarse, key_c)
    valid = jnp.ones_like(t, bool)
    r = t.shape[0]
    z_per_ray = z[jnp.maximum(bidx, 0)]                       # [R, z_dim]

    def sdf_fn_flat(x):
        s = x.shape[0] // r
        if per_instance_z:
            bidx_rep = jnp.repeat(jnp.maximum(bidx, 0), s)
            return model.implicit_surface.forward_sdf(x, z, bidx_rep)["sdf"]
        z_rep = jnp.repeat(z_per_ray, s, axis=0)
        return model.implicit_surface.forward_sdf(x, z_rep)["sdf"]

    t, valid = _upsample_rounds(sdf_fn_flat, o_n, d_n, t, valid, far,
                                upsample_inv_s, upsample_inv_s_factors,
                                n_importance, perturb_key)
    r, s = t.shape
    x = (o_n[:, None, :] + d_n[:, None, :] * t[..., None]).reshape(r * s, 3)
    v = jnp.broadcast_to(rays_d[:, None, :], (r, s, 3)).reshape(r * s, 3)
    if per_instance_z:
        bidx_rep = jnp.repeat(jnp.maximum(bidx, 0), s)
        out = model(x, v, z, bidx_rep, with_rgb=with_rgb)
    else:
        z_rep = jnp.repeat(z_per_ray, s, axis=0)
        out = model(x, v, z_rep, with_rgb=with_rgb)
    sdf = jnp.where(valid, out["sdf"].reshape(r, s), _BIG_SDF)
    alpha = neus_ray_sdf_to_alpha(sdf, model.forward_inv_s(), append_cdf_1=True)
    alpha = jnp.where(valid & ray_mask[:, None] & (bidx >= 0)[:, None],
                      alpha, 0.0)
    vw = ray_alpha_to_vw(alpha)
    acc = jnp.sum(vw, -1)
    rendered = {"mask_volume": jnp.where(ray_mask, acc, 0.0),
                "depth_volume": jnp.where(
                    ray_mask, jnp.sum(vw * t, -1) / jnp.maximum(acc, 1e-10), 0.0)}
    if with_rgb:
        rgb = out["rgb"].reshape(r, s, 3)
        rendered["rgb_volume"] = jnp.where(
            ray_mask[:, None], jnp.sum(vw[..., None] * rgb, -2), 0.0)
    vb = {"t": t, "alpha": alpha, "vw": vw}
    if out.get("nablas") is not None:   # eikonal training (batched mixin)
        vb["nablas"] = out["nablas"].reshape(r, s, 3)
    return rendered, vb


def neus_ray_query_batched_dynamic(model, space, ray_tested: Dict, z: Array,
                                   bidx: Array, ts: Array, *,
                                   n_coarse: int = 64,
                                   upsample_inv_s_factors: Sequence[float] = (1.0, 4.0),
                                   n_importance: int = 16,
                                   upsample_inv_s: float = 64.0,
                                   perturb_key=None, with_rgb: bool = True
                                   ) -> Tuple[Dict, Dict]:
    """Latent- AND time-conditioned batched query (reference:
    fields_conditional_dynamic/neus/renderer_mixin.py:25
    NeusRendererMixinBatchedDynamic): z [B, z_dim], bidx [R] instance per
    ray, ts [R] timestamp per ray."""
    rays_o, rays_d = ray_tested["rays_o"], ray_tested["rays_d"]
    near, far, ray_mask = ray_tested["near"], ray_tested["far"], ray_tested["mask"]
    if getattr(space, "n_batch", None):
        o_n, d_n = space.normalize_rays(rays_o, rays_d, bidx)
    else:
        o_n, d_n = space.normalize_rays(rays_o, rays_d)
    key_c = None
    if perturb_key is not None:
        perturb_key, key_c = jax.random.split(perturb_key)
    t, _ = batch_sample_step_linear(near, far, n_coarse, key_c)
    valid = jnp.ones_like(t, bool)
    r = t.shape[0]
    z_per_ray = z[jnp.maximum(bidx, 0)]

    def sdf_fn_flat(x):
        s = x.shape[0] // r
        z_rep = jnp.repeat(z_per_ray, s, axis=0)
        ts_rep = jnp.repeat(ts, s)
        return model.implicit_surface.forward_sdf(x, z_rep, ts_rep)["sdf"]

    t, valid = _upsample_rounds(sdf_fn_flat, o_n, d_n, t, valid, far,
                                upsample_inv_s, upsample_inv_s_factors,
                                n_importance, perturb_key)
    r, s = t.shape
    x = (o_n[:, None, :] + d_n[:, None, :] * t[..., None]).reshape(r * s, 3)
    z_rep = jnp.repeat(z_per_ray, s, axis=0)
    ts_rep = jnp.repeat(ts, s)
    v = jnp.broadcast_to(rays_d[:, None, :], (r, s, 3)).reshape(r * s, 3)
    out = model(x, v, z_rep, ts_rep, with_rgb=with_rgb)
    sdf = jnp.where(valid, out["sdf"].reshape(r, s), _BIG_SDF)
    alpha = neus_ray_sdf_to_alpha(sdf, model.forward_inv_s(), append_cdf_1=True)
    alpha = jnp.where(valid & ray_mask[:, None] & (bidx >= 0)[:, None],
                      alpha, 0.0)
    vw = ray_alpha_to_vw(alpha)
    acc = jnp.sum(vw, -1)
    rendered = {"mask_volume": jnp.where(ray_mask, acc, 0.0),
                "depth_volume": jnp.where(
                    ray_mask, jnp.sum(vw * t, -1) / jnp.maximum(acc, 1e-10),
                    0.0)}
    if with_rgb:
        rgb = out["rgb"].reshape(r, s, 3)
        rendered["rgb_volume"] = jnp.where(
            ray_mask[:, None], jnp.sum(vw[..., None] * rgb, -2), 0.0)
    return rendered, {"t": t, "alpha": alpha, "vw": vw,
                      "nablas": out["nablas"].reshape(r, s, 3)}
