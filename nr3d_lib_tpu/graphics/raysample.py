"""Ray sampling: stratified step samplers + inverse-CDF importance sampling.

Reference: nr3d_lib/graphics/raysample.py (batch_sample_pdf:262,
packed_sample_cdf:38, step samplers :285-364). Dense [R, S] layouts are the
Dense slabs primary; packed variants delegate to pack_ops.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from nr3d_lib_tpu.graphics import pack_ops as po

__all__ = [
    "batch_sample_step_linear",
    "batch_sample_step_wrt_depth",
    "batch_sample_step_wrt_sqrt_depth",
    "batch_sample_cdf",
    "batch_sample_pdf",
    "packed_sample_cdf",
]

Array = jax.Array


def _maybe_perturb(t_edges: Array, perturb_key) -> Array:
    """Stratified jitter within each bin; None → bin midpoints."""
    lo = t_edges[..., :-1]
    hi = t_edges[..., 1:]
    if perturb_key is None:
        return 0.5 * (lo + hi)
    u = jax.random.uniform(perturb_key, lo.shape, lo.dtype)
    return lo + (hi - lo) * u


def batch_sample_step_linear(near: Array, far: Array, n_samples: int,
                             perturb_key=None) -> Tuple[Array, Array]:
    """Uniform-in-depth samples → (t [R,S], dt [R,S]) (reference :285)."""
    s = jnp.linspace(0.0, 1.0, n_samples + 1, dtype=near.dtype)
    edges = near[..., None] + (far - near)[..., None] * s
    t = _maybe_perturb(edges, perturb_key)
    dt = edges[..., 1:] - edges[..., :-1]
    return t, dt


def batch_sample_step_wrt_depth(near: Array, far: Array, n_samples: int,
                                dt_gamma: float = 0.01, perturb_key=None
                                ) -> Tuple[Array, Array]:
    """Depth-proportional steps dt ≈ γ·t, i.e. log-spaced edges
    (reference :342: 'dt=γ·t clamped')."""
    near_c = jnp.maximum(near, 1e-6)
    s = jnp.linspace(0.0, 1.0, n_samples + 1, dtype=near.dtype)
    log_edges = jnp.log(near_c)[..., None] + \
        (jnp.log(jnp.maximum(far, near_c + 1e-6)) - jnp.log(near_c))[..., None] * s
    edges = jnp.exp(log_edges)
    t = _maybe_perturb(edges, perturb_key)
    dt = edges[..., 1:] - edges[..., :-1]
    return t, dt


def batch_sample_step_wrt_sqrt_depth(near: Array, far: Array, n_samples: int,
                                     perturb_key=None) -> Tuple[Array, Array]:
    """Uniform in sqrt-depth (reference :364)."""
    sq0 = jnp.sqrt(jnp.maximum(near, 0.0))
    sq1 = jnp.sqrt(jnp.maximum(far, 0.0))
    s = jnp.linspace(0.0, 1.0, n_samples + 1, dtype=near.dtype)
    edges = (sq0[..., None] + (sq1 - sq0)[..., None] * s) ** 2
    t = _maybe_perturb(edges, perturb_key)
    dt = edges[..., 1:] - edges[..., :-1]
    return t, dt


def batch_sample_cdf(bins: Array, cdfs: Array, n_samples: int,
                     perturb_key=None, eps: float = 1e-8) -> Array:
    """Inverse-transform sampling from per-ray CDFs.

    bins: [R, B] sorted positions; cdfs: [R, B] monotone in [0,1].
    Returns t [R, n_samples] (reference: batch_sample_cdf).
    """
    r = bins.shape[0]
    if perturb_key is None:
        u = jnp.linspace(0.5 / n_samples, 1.0 - 0.5 / n_samples, n_samples,
                         dtype=bins.dtype)
        u = jnp.broadcast_to(u, (r, n_samples))
    else:
        u = jax.random.uniform(perturb_key, (r, n_samples), bins.dtype,
                               minval=eps, maxval=1.0 - eps)
    # searchsorted(right) is a count of cdf <= u, and the bracketing
    # (cdf, bin) pairs come out of one-hot einsums instead of a vmapped
    # binary search + take_along_axis (this runs every NeuS upsample
    # round; which form is faster on the GPU is not measured yet).
    nb = bins.shape[-1]
    cnt = jnp.sum((cdfs[:, None, :] <= u[:, :, None]).astype(jnp.int32),
                  axis=-1)                                    # [R, I]
    hi = jnp.clip(cnt, 1, nb - 1)
    lo = hi - 1
    b_iota = jnp.arange(nb, dtype=jnp.int32)[None, None, :]
    oh_lo = (b_iota == lo[:, :, None]).astype(jnp.float32)    # [R, I, B]
    oh_hi = (b_iota == hi[:, :, None]).astype(jnp.float32)
    stacked = jnp.stack([cdfs, bins], axis=-1).astype(jnp.float32)  # [R,B,2]
    v0 = jnp.einsum("rib,rbk->rik", oh_lo, stacked,
                    precision=jax.lax.Precision.HIGHEST)
    v1 = jnp.einsum("rib,rbk->rik", oh_hi, stacked,
                    precision=jax.lax.Precision.HIGHEST)
    c0, b0 = v0[..., 0].astype(bins.dtype), v0[..., 1].astype(bins.dtype)
    c1, b1 = v1[..., 0].astype(bins.dtype), v1[..., 1].astype(bins.dtype)
    denom = jnp.where(c1 - c0 < eps, 1.0, c1 - c0)
    frac = jnp.clip((u - c0) / denom, 0.0, 1.0)
    return b0 + frac * (b1 - b0)


def batch_sample_pdf(bins: Array, weights: Array, n_samples: int,
                     perturb_key=None, eps: float = 1e-5) -> Array:
    """Hierarchical sampling from per-bin weights (reference: batch_sample_pdf:262).

    bins: [R, B+1] edges; weights: [R, B] ≥ 0.
    """
    w = weights + eps
    pdf = w / jnp.sum(w, -1, keepdims=True)
    cdf = jnp.concatenate([jnp.zeros_like(pdf[..., :1]), jnp.cumsum(pdf, -1)], -1)
    return batch_sample_cdf(bins, cdf, n_samples, perturb_key)


def packed_sample_cdf(bins: Array, cdfs: Array, ridx: Array, n_packs: int,
                      n_per_pack: int, perturb_key=None, eps: float = 1e-8
                      ) -> Tuple[Array, Array]:
    """Packed inverse-CDF sampling: n_per_pack samples per pack
    (reference: packed_sample_cdf, raysample.py:38).

    Returns (t [n_packs*n_per_pack], sample_ridx).
    """
    if perturb_key is None:
        u1 = jnp.linspace(0.5 / n_per_pack, 1.0 - 0.5 / n_per_pack, n_per_pack,
                          dtype=bins.dtype)
        u = jnp.tile(u1, n_packs)
    else:
        u = jax.random.uniform(perturb_key, (n_packs * n_per_pack,), bins.dtype,
                               minval=eps, maxval=1.0 - eps)
    u_ridx = jnp.repeat(jnp.arange(n_packs, dtype=jnp.int32), n_per_pack)
    t = po.packed_invert_cdf(bins, cdfs, ridx, u, u_ridx, n_packs, eps=eps)
    return t, u_ridx
