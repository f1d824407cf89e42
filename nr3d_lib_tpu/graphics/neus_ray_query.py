"""NeuS ray-query strategies: marched + multi-stage upsampled SDF rendering.

Reference: nr3d_lib/graphics/neus/neus_ray_query.py:132 (coarse_multi_upsample)
/ :358 (march_occ_multi_upsample, StreetSurf §4.1) / :732 (compressed).

Layout: dense [R, S] slabs. Invalid slots carry t=far and sdf=+BIG so
their alphas vanish; merging upsample rounds is a per-ray sort (the
reference's merge_two_packs_sorted_aligned becomes `jnp.sort` on the slab).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from nr3d_lib_tpu.graphics.nerf import ray_alpha_to_vw
from nr3d_lib_tpu.graphics.neus import neus_ray_sdf_to_alpha
from nr3d_lib_tpu.graphics.raysample import batch_sample_pdf, batch_sample_step_linear

__all__ = ["neus_ray_query_march_occ_multi_upsample",
           "neus_ray_query_coarse_multi_upsample",
           "neus_ray_query_sphere_trace"]

Array = jax.Array

_BIG_SDF = 1e4


def _upsample_rounds(sdf_fn, o_n, d_n, t, valid, far, inv_s_base,
                     upsample_inv_s_factors, n_importance, perturb_key):
    """Iterative NeuS importance sampling (reference neus_ray_query.py:495-530
    upsample loop). Each round: alphas at growing sharpness → CDF sample →
    merge-sort into the slab.

    Sample PLACEMENT carries no gradient (the returned t is
    stop_gradient'ed), exactly like the reference's no-grad upsampling
    (`with torch.no_grad()` around the upsample loop): the per-round SDF
    queries then run forward-only — XLA dead-code-eliminates their
    backward, which would otherwise re-run the encode backward over every
    upsample round's samples inside each train step.

    SDF values are CACHED across rounds like the reference
    (`sdf_iter[pidx1] = forward_sdf(x_fine)` — neus_ray_query.py:533:
    only the round's NEW importance samples hit the network; cached
    values ride the merge sort as a payload). Previously every round
    re-evaluated the whole slab: Σ(S + i·I) evals instead of S + R·I —
    at S=48, I=16, 2 rounds that is 160 → 80 network evals per ray in
    the sampling phase."""
    r = t.shape[0]

    def sort_tvs(t_, valid_, sdf_):
        # lax.sort with payloads (one sort instead of argsort + gathers)
        key = jnp.where(valid_, t_, jnp.inf)
        key_s, v_s, sdf_s = jax.lax.sort(
            (key, valid_.astype(jnp.int32), sdf_), num_keys=1,
            is_stable=True)
        v_s = v_s.astype(bool)
        return jnp.where(v_s, key_s, far[:, None]), v_s, sdf_s

    def eval_sdf(t_):
        x = o_n[:, None, :] + d_n[:, None, :] * t_[..., None]
        s = t_.shape[1]
        return sdf_fn(x.reshape(r * s, 3)).reshape(r, s)

    sdf = eval_sdf(t)                       # the one full-slab evaluation
    for round_i, factor in enumerate(upsample_inv_s_factors):
        t, valid, sdf = sort_tvs(t, valid, sdf)
        sdf_m = jnp.where(valid, sdf, _BIG_SDF)
        alpha = neus_ray_sdf_to_alpha(sdf_m, inv_s_base * factor,
                                      append_cdf_1=False)          # [R,S-1]
        w = ray_alpha_to_vw(alpha)
        key_i = None
        if perturb_key is not None:
            perturb_key, key_i = jax.random.split(perturb_key)
        t_new = batch_sample_pdf(t, w, n_importance, key_i)  # [R,n_imp]
        sdf_new = eval_sdf(t_new)           # only the new samples
        t = jnp.concatenate([t, t_new], -1)
        valid = jnp.concatenate([valid, jnp.ones_like(t_new, bool)], -1)
        sdf = jnp.concatenate([sdf, sdf_new], -1)
    t, valid, _ = sort_tvs(t, valid, sdf)
    return jax.lax.stop_gradient(t), valid


def _final_composite(model, o_n, d_n, rays_d, t, valid, ray_mask, inv_s,
                     with_rgb: bool = True):
    r, s = t.shape
    x = o_n[:, None, :] + d_n[:, None, :] * t[..., None]
    flat_x = x.reshape(r * s, 3)
    v = jnp.broadcast_to(rays_d[:, None, :], (r, s, 3)).reshape(r * s, 3)
    out = model(flat_x, v, with_rgb=with_rgb, with_nablas=True)
    sdf = jnp.where(valid, out["sdf"].reshape(r, s), _BIG_SDF)
    alpha = neus_ray_sdf_to_alpha(sdf, inv_s, append_cdf_1=True)   # [R,S]
    alpha = jnp.where(valid & ray_mask[:, None], alpha, 0.0)
    vw = ray_alpha_to_vw(alpha)
    acc = jnp.sum(vw, -1)
    nablas = out.get("nablas")
    rendered = {"mask_volume": jnp.where(ray_mask, acc, 0.0)}
    if with_rgb:
        rgb = out["rgb"].reshape(r, s, 3)
        rendered["rgb_volume"] = jnp.where(
            ray_mask[:, None], jnp.sum(vw[..., None] * rgb, -2), 0.0)
    depth = jnp.sum(vw * t, -1) / jnp.maximum(acc, 1e-10)
    rendered["depth_volume"] = jnp.where(ray_mask, depth, 0.0)
    if nablas is not None:
        n_img = jnp.sum(vw[..., None] * nablas.reshape(r, s, 3), -2)
        rendered["normals_volume"] = jnp.where(ray_mask[:, None], n_img, 0.0)
    volume_buffer = {"t": t, "alpha": alpha, "vw": vw, "sdf": sdf,
                     "ray_mask": ray_mask, "valid": valid,
                     "nablas": None if nablas is None else nablas.reshape(r, s, 3),
                     "x": x}
    return rendered, volume_buffer


def neus_ray_query_coarse_multi_upsample(
        model, space, ray_tested: Dict, *,
        n_coarse: int = 64,
        upsample_inv_s_factors: Sequence[float] = (1.0, 4.0, 16.0),
        n_importance: int = 32,
        upsample_inv_s: float = 64.0,
        perturb_key=None, with_rgb: bool = True
        ) -> Tuple[Dict[str, Array], Dict[str, Array]]:
    """Coarse stratified + iterative upsample (reference:
    neus_ray_query.py:132 coarse_multi_upsample)."""
    rays_o, rays_d = ray_tested["rays_o"], ray_tested["rays_d"]
    near, far, ray_mask = ray_tested["near"], ray_tested["far"], ray_tested["mask"]
    o_n, d_n = space.normalize_rays(rays_o, rays_d)
    key_c = None
    if perturb_key is not None:
        perturb_key, key_c = jax.random.split(perturb_key)
    t, _ = batch_sample_step_linear(near, far, n_coarse, key_c)
    valid = jnp.ones_like(t, bool)

    def sdf_fn(x):
        return model.forward_sdf(x)["sdf"]

    t, valid = _upsample_rounds(sdf_fn, o_n, d_n, t, valid, far,
                                upsample_inv_s, upsample_inv_s_factors,
                                n_importance, perturb_key)
    return _final_composite(model, o_n, d_n, rays_d, t, valid, ray_mask,
                            model.forward_inv_s(), with_rgb)


def neus_ray_query_sphere_trace(
        model, accel, space, ray_tested: Dict, *,
        n_band: int = 16, band_sigma: float = 3.0,
        n_tail: int = 8, tail_span: float = 0.1,
        hit_threshold: float = 5e-4, max_iters: int = 64,
        distance_scale: float = 1.0,
        perturb_key=None, with_rgb: bool = True
        ) -> Tuple[Dict[str, Array], Dict[str, Array]]:
    """Sphere-trace query strategy (reference: neus_ray_query.py:41
    neus_ray_query_sphere_trace + sphere_tracer.cu:300 sample_on_segments):

      1. sphere-trace each ray to the SDF zero crossing, occ-grid seeded;
      2. place `n_band` samples in a logistic band around the hit (width
         band_sigma / inv_s — where the NeuS kernel has mass) plus `n_tail`
         coarse samples behind it (the reference's tail sampling for rays
         whose band doesn't absorb all transmittance);
      3. volume-render those samples with the standard NeuS estimator —
         miss rays keep zero alpha and composite to background.
    """
    from nr3d_lib_tpu.graphics.sphere_trace import sphere_trace

    rays_o, rays_d = ray_tested["rays_o"], ray_tested["rays_d"]
    near, far, ray_mask = ray_tested["near"], ray_tested["far"], ray_tested["mask"]
    o_n, d_n = space.normalize_rays(rays_o, rays_d)

    def sdf_fn(x):
        return model.forward_sdf(x)["sdf"]

    occ = accel.occ.occ() if accel is not None else None
    tr = sphere_trace(o_n, d_n, near, far, sdf_fn,
                      distance_scale=distance_scale,
                      hit_threshold=hit_threshold, max_iters=max_iters,
                      occ_grid=occ)
    inv_s = model.forward_inv_s()
    half_band = band_sigma / jnp.maximum(inv_s, 1e-6)

    # band samples centered at the hit; miss rays park their band past far
    # (alpha masked to 0 below) so shapes stay static.
    t_hit = jnp.where(tr["hit"], tr["t"], far)
    u = jnp.linspace(-1.0, 1.0, n_band)
    t_band = t_hit[:, None] + half_band * u[None, :]
    t_tail = t_hit[:, None] + half_band + (tail_span * (far - t_hit))[:, None] \
        * jnp.linspace(0.1, 1.0, n_tail)[None, :]
    if perturb_key is not None:
        kb, kt = jax.random.split(perturb_key)
        t_band = t_band + jax.random.uniform(
            kb, t_band.shape, t_band.dtype, -0.5, 0.5) * (2 * half_band / n_band)
        t_tail = t_tail + jax.random.uniform(
            kt, t_tail.shape, t_tail.dtype, -0.5, 0.5) \
            * (tail_span * (far - t_hit))[:, None] / n_tail
    t = jnp.sort(jnp.concatenate([t_band, t_tail], -1), axis=-1)
    t = jnp.clip(t, near[:, None], far[:, None])
    valid = jnp.broadcast_to(tr["hit"][:, None], t.shape)
    rendered, vb = _final_composite(model, o_n, d_n, rays_d, t, valid,
                                    ray_mask, inv_s, with_rgb)
    vb.update(t_hit=t_hit, hit=tr["hit"], trace_sdf=tr["sdf"],
              trace_status=tr["status"])
    rendered["depth_surface"] = jnp.where(ray_mask & tr["hit"], t_hit, 0.0)
    return rendered, vb


def neus_ray_query_march_occ_multi_upsample(
        model, accel, space, ray_tested: Dict, *,
        upsample_inv_s_factors: Sequence[float] = (1.0, 4.0, 16.0),
        n_importance: int = 32,
        upsample_inv_s: float = 64.0,
        perturb_key=None, with_rgb: bool = True
        ) -> Tuple[Dict[str, Array], Dict[str, Array]]:
    """Occ-marched + multi-upsample (reference: neus_ray_query.py:358
    march_occ_multi_upsample — the StreetSurf §4.1 strategy)."""
    rays_o, rays_d = ray_tested["rays_o"], ray_tested["rays_d"]
    near, far, ray_mask = ray_tested["near"], ray_tested["far"], ray_tested["mask"]
    o_n, d_n = space.normalize_rays(rays_o, rays_d)
    key_m = None
    if perturb_key is not None:
        perturb_key, key_m = jax.random.split(perturb_key)
    t, dt, smask = accel.ray_march(o_n, d_n, near, far, perturb_key=key_m)

    def sdf_fn(x):
        return model.forward_sdf(x)["sdf"]

    t, valid = _upsample_rounds(sdf_fn, o_n, d_n, t, smask, far,
                                upsample_inv_s, upsample_inv_s_factors,
                                n_importance, perturb_key)
    return _final_composite(model, o_n, d_n, rays_d, t, valid, ray_mask,
                            model.forward_inv_s(), with_rgb)
