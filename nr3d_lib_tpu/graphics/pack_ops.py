"""pack_ops — segment ("pack") operators over ragged per-ray sample buffers.

Re-design of the reference's CUDA pack_ops
(reference: nr3d_lib/graphics/pack_ops/pack_ops.py:16-744 and
csrc/pack_ops/pack_ops_cuda.cu). The reference stores ragged per-ray samples
as one flat buffer + ``pack_infos [N_packs, 2] = (first_idx, length)``. Here
raggedness maps onto **static-capacity** flat buffers:

  * every packed buffer has a fixed capacity ``N`` (compile-time constant);
  * ``ridx[i] ∈ [0, n_packs)`` gives the pack of sample ``i``; **padding**
    slots carry ``ridx == n_packs`` (one sentinel segment that reductions
    drop);
  * samples of a pack are contiguous and packs are ascending — after any
    `compactify`/`packed_sort` this invariant holds with padding at the end.

Reductions lower to `jax.ops.segment_*` (XLA scatter-add);
cumulative ops lower to segmented `associative_scan`; per-pack broadcasting
is a gather. Everything is differentiable by construction — the reference's
hand-written backward kernels (e.g. cumprod backward via the reverse-cumsum
trick, pack_ops.py:121-160) are unnecessary under JAX autodiff.
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    # pack_infos constructors (reference: pack_ops.py:731-744)
    "get_pack_infos_from_boundary",
    "get_pack_infos_from_first",
    "get_pack_infos_from_n",
    "get_pack_infos_from_batch",
    "mark_pack_boundaries",
    "budget_indices",
    "dense_to_budgeted",
    "counts_from_ridx",
    "ridx_from_counts",
    "offsets_from_counts",
    # interleave constructors
    "interleave_arange_simple",
    "interleave_linstep",
    # broadcast arithmetic / compare (reference: csrc/pack_ops/pack_ops.cpp:20-58)
    "packed_add",
    "packed_sub",
    "packed_mul",
    "packed_div",
    "packed_gt",
    "packed_geq",
    "packed_lt",
    "packed_leq",
    "packed_eq",
    "packed_neq",
    # reductions
    "packed_sum",
    "packed_mean",
    "packed_max",
    "packed_min",
    # cumulative / neighbor ops
    "packed_cumsum",
    "packed_cumprod",
    "packed_diff",
    "packed_backward_diff",
    # sort / search / sample
    "packed_sort",
    "packed_searchsorted",
    "packed_invert_cdf",
    # volume rendering
    "packed_alpha_to_vw",
    "packed_tau_to_vw",
    "packed_volume_render_compression",
    # structural
    "compactify",
    "packed_to_dense",
    "dense_to_packed",
    "merge_two_packs_sorted_aligned",
    "try_merge_two_packs_sorted_aligned",
    "merge_two_batch",
    "packed_matmul",
    "segmented_scan",
    # round-5 reference-parity tail (pack_ops.py:16-71 names)
    "packed_sort_inplace",
    "packed_searchsorted_packed_vals",
    "interleave_arange",
    "interleave_linspace",
    "interleave_sample_step_wrt_depth_clamped",
    "interleave_sample_step_wrt_depth_in_packed_segments",
    "merge_two_packs_sorted",
    "merge_two_packs_sorted_a_includes_b",
    "merge_two_batch_a_includes_b",
    "expand_pack_boundary",
    "octree_mark_consecutive_segments",
    "intersect1d_unique",
]

Array = jax.Array


# =============================================================== pack_infos
def counts_from_ridx(ridx: Array, n_packs: int) -> Array:
    """Per-pack sample counts from ridx (padding ridx==n_packs is dropped)."""
    return jax.ops.segment_sum(jnp.ones_like(ridx), ridx, num_segments=n_packs + 1)[:n_packs]


def offsets_from_counts(counts: Array) -> Array:
    """Exclusive cumsum: first index of each pack."""
    return jnp.cumsum(counts) - counts


def get_pack_infos_from_n(counts: Array) -> Array:
    """[N_packs,2] (first, count) from per-pack counts (reference: pack_ops.py:744)."""
    return jnp.stack([offsets_from_counts(counts), counts], axis=-1)


def get_pack_infos_from_first(first: Array, total: Union[int, Array]) -> Array:
    nxt = jnp.concatenate([first[1:], jnp.asarray([total], first.dtype)])
    return jnp.stack([first, nxt - first], axis=-1)


def get_pack_infos_from_boundary(boundary: Array) -> Array:
    """boundary: [N] bool marks at pack starts → pack_infos (fixed n_packs =
    total marks is data-dependent; here callers use ridx-based APIs instead;
    provided for parity on host-side/static use)."""
    first = jnp.nonzero(boundary, size=boundary.shape[0], fill_value=boundary.shape[0])[0]
    return get_pack_infos_from_first(first, boundary.shape[0])


def get_pack_infos_from_batch(n_batches: int, n_per_batch: int, dtype=jnp.int32) -> Array:
    first = jnp.arange(n_batches, dtype=dtype) * n_per_batch
    return jnp.stack([first, jnp.full_like(first, n_per_batch)], axis=-1)


def mark_pack_boundaries(ridx: Array) -> Array:
    """True at the first sample of each pack (reference: mark_pack_boundaries_cuda)."""
    return jnp.concatenate([jnp.ones((1,), bool), ridx[1:] != ridx[:-1]])


def ridx_from_counts(counts: Array, capacity: int, n_packs: Optional[int] = None) -> Array:
    """Expand per-pack counts to a flat ridx buffer of static capacity.

    Samples of pack i occupy slots [first_i, first_i+count_i); remaining slots
    are padding (ridx == n_packs).
    """
    if n_packs is None:
        n_packs = counts.shape[0]
    first = offsets_from_counts(counts)
    # ridx[j] = number of packs whose first <= j, minus 1 — via searchsorted
    pos = jnp.arange(capacity)
    ridx = jnp.searchsorted(first, pos, side="right") - 1
    total = first[-1] + counts[-1] if counts.shape[0] > 0 else 0
    return jnp.where(pos < total, ridx.astype(jnp.int32), jnp.int32(n_packs))


# ============================================================== interleave
def interleave_arange_simple(counts: Array, capacity: int) -> Tuple[Array, Array]:
    """Packed [0..count_i) aranges → (vals, ridx). Reference: interleave_arange."""
    n_packs = counts.shape[0]
    ridx = ridx_from_counts(counts, capacity, n_packs)
    first = offsets_from_counts(counts)
    first_pad = jnp.concatenate([first, jnp.zeros((1,), first.dtype)])
    pos_in_pack = jnp.arange(capacity) - first_pad[jnp.minimum(ridx, n_packs)]
    pos_in_pack = jnp.where(ridx < n_packs, pos_in_pack, 0)
    return pos_in_pack.astype(jnp.int32), ridx


def interleave_linstep(start: Array, counts: Array, step: Array, capacity: int
                       ) -> Tuple[Array, Array]:
    """Packed ``start_i + k*step_i`` sequences (reference: interleave_linstep)."""
    k, ridx = interleave_arange_simple(counts, capacity)
    n_packs = counts.shape[0]
    sp = jnp.concatenate([start, jnp.zeros((1,), start.dtype)])
    st = jnp.concatenate([step, jnp.zeros((1,), step.dtype)])
    i = jnp.minimum(ridx, n_packs)
    return sp[i] + k.astype(start.dtype) * st[i], ridx


# ===================================================== broadcast arithmetic
def _broadcast_pack(pack_vals: Array, ridx: Array, n_packs: int) -> Array:
    """Gather per-pack values to per-sample; padding gathers zeros."""
    pad_shape = (1,) + pack_vals.shape[1:]
    padded = jnp.concatenate([pack_vals, jnp.zeros(pad_shape, pack_vals.dtype)], axis=0)
    return padded[jnp.minimum(ridx, n_packs)]


def _packed_binop(op):
    def fn(feats: Array, pack_vals: Array, ridx: Array, n_packs: Optional[int] = None) -> Array:
        if n_packs is None:
            n_packs = pack_vals.shape[0]
        other = _broadcast_pack(pack_vals, ridx, n_packs)
        if feats.ndim > other.ndim:
            other = other.reshape(other.shape + (1,) * (feats.ndim - other.ndim))
        return op(feats, other)

    return fn


packed_add = _packed_binop(jnp.add)
packed_sub = _packed_binop(jnp.subtract)
packed_mul = _packed_binop(jnp.multiply)
packed_div = _packed_binop(lambda a, b: a / jnp.where(b == 0, 1, b))
packed_gt = _packed_binop(jnp.greater)
packed_geq = _packed_binop(jnp.greater_equal)
packed_lt = _packed_binop(jnp.less)
packed_leq = _packed_binop(jnp.less_equal)
packed_eq = _packed_binop(jnp.equal)
packed_neq = _packed_binop(jnp.not_equal)


# ================================================================ reductions
def packed_sum(feats: Array, ridx: Array, n_packs: int) -> Array:
    """Per-pack sum; trailing feature dims preserved (reference: packed_sum)."""
    return jax.ops.segment_sum(feats, ridx, num_segments=n_packs + 1)[:n_packs]


def packed_mean(feats: Array, ridx: Array, n_packs: int) -> Array:
    s = packed_sum(feats, ridx, n_packs)
    n = counts_from_ridx(ridx, n_packs).astype(s.dtype)
    n = jnp.maximum(n, 1).reshape((n_packs,) + (1,) * (feats.ndim - 1))
    return s / n


def packed_max(feats: Array, ridx: Array, n_packs: int) -> Array:
    return jax.ops.segment_max(feats, ridx, num_segments=n_packs + 1)[:n_packs]


def packed_min(feats: Array, ridx: Array, n_packs: int) -> Array:
    return jax.ops.segment_min(feats, ridx, num_segments=n_packs + 1)[:n_packs]


# ======================================================== cumulative / diff
def segmented_scan(vals: Array, is_start: Array, op=jnp.add, identity=None,
                   reverse: bool = False) -> Array:
    """Inclusive segmented scan with any associative op.

    Combine rule: ((fa,va) ⊕ (fb,vb)) = (fa|fb, vb if fb else op(va,vb)) —
    associative, so `lax.associative_scan` applies (O(N log N), VPU-friendly).
    """
    flags = is_start
    if reverse:
        # reverse scan: segment "starts" become segment *ends* shifted
        vals = vals[::-1]
        flags = jnp.concatenate([jnp.ones((1,), bool), is_start[::-1][:-1]])

    def combine(a, b):
        fa, va = a
        fb, vb = b
        f = jnp.logical_or(fa, fb)
        v = jnp.where(_bshape(fb, vb), vb, op(va, vb))
        return f, v

    _, out = jax.lax.associative_scan(combine, (flags, vals))
    if reverse:
        out = out[::-1]
    return out


def _bshape(flag: Array, ref: Array) -> Array:
    return flag.reshape(flag.shape + (1,) * (ref.ndim - flag.ndim))


def packed_cumsum(feats: Array, ridx: Array, exclusive: bool = False) -> Array:
    """Per-pack cumulative sum (reference: packed_cumsum).

    Uses the global-cumsum-minus-offset trick: O(N) instead of a scan.
    """
    start = mark_pack_boundaries(ridx)
    csum = jnp.cumsum(feats, axis=0)
    excl = csum - feats  # exclusive global cumsum
    # offset for each sample = exclusive cumsum at its pack's first element,
    # propagated with a segmented max-scan over (start ? excl : -inf) — but
    # simpler: propagate the value at starts forward with a segmented "keep
    # first" scan implemented as segmented sum of (start ? excl : 0).
    offset = segmented_scan(jnp.where(_bshape(start, excl), excl, jnp.zeros_like(excl)),
                            start, op=jnp.add)
    out = (excl if exclusive else csum) - offset
    return out


def packed_cumprod(feats: Array, ridx: Array, exclusive: bool = False) -> Array:
    """Per-pack cumulative product via segmented scan (reference: packed_cumprod)."""
    start = mark_pack_boundaries(ridx)
    if exclusive:
        shifted = jnp.concatenate([jnp.ones_like(feats[:1]), feats[:-1]], axis=0)
        vals = jnp.where(_bshape(start, feats), jnp.ones_like(feats), shifted)
    else:
        vals = feats
    return segmented_scan(vals, start, op=jnp.multiply)


def packed_diff(feats: Array, ridx: Array, pad_value: float = 0.0,
                pack_last_fill: Optional[Array] = None, n_packs: Optional[int] = None) -> Array:
    """out[i] = feats[i+1] - feats[i] within a pack; last element of each pack
    gets ``pad_value`` or ``pack_last_fill[pack] - feats[i]``
    (reference: packed_diff with appending options)."""
    nxt = jnp.concatenate([feats[1:], feats[-1:]], axis=0)
    same = jnp.concatenate([ridx[1:] == ridx[:-1], jnp.zeros((1,), bool)])
    diff = nxt - feats
    if pack_last_fill is not None:
        if n_packs is None:
            n_packs = pack_last_fill.shape[0]
        fill = _broadcast_pack(pack_last_fill, ridx, n_packs) - feats
    else:
        fill = jnp.full_like(feats, pad_value)
    return jnp.where(_bshape(same, diff), diff, fill)


def packed_backward_diff(feats: Array, ridx: Array, pad_value: float = 0.0,
                         pack_first_fill: Optional[Array] = None,
                         n_packs: Optional[int] = None) -> Array:
    """out[i] = feats[i] - feats[i-1] within a pack (reference: packed_backward_diff)."""
    prev = jnp.concatenate([feats[:1], feats[:-1]], axis=0)
    start = mark_pack_boundaries(ridx)
    diff = feats - prev
    if pack_first_fill is not None:
        if n_packs is None:
            n_packs = pack_first_fill.shape[0]
        fill = feats - _broadcast_pack(pack_first_fill, ridx, n_packs)
    else:
        fill = jnp.full_like(feats, pad_value)
    return jnp.where(_bshape(start, diff), fill, diff)


# ============================================================ sort / search
def packed_sort(key: Array, ridx: Array, *payload: Array) -> Tuple[Array, ...]:
    """Sort each pack by key (stable). Padding (ridx==n_packs) stays at the end.

    Reference: packed_sort_qsort / packed_sort_thrust.
    """
    operands = (ridx, key) + payload
    out = jax.lax.sort(operands, num_keys=2, is_stable=True)
    return (out[1], out[0]) + tuple(out[2:])


def packed_searchsorted(bins: Array, bins_ridx: Array, vals: Array, vals_ridx: Array,
                        n_packs: int, side: str = "right") -> Array:
    """For each val, insertion index into its own pack's sorted bins, as an
    absolute index into the flat ``bins`` buffer (reference: packed_searchsorted).

    Implemented by merging bins+vals with one stable multi-key sort.
    """
    nb, nv = bins.shape[0], vals.shape[0]
    # tag: bins sort before equal vals for side='right'? searchsorted right:
    # insertion after equal bins → bins with value == v come BEFORE v.
    tag_bins = jnp.zeros((nb,), jnp.int32) if side == "right" \
        else jnp.ones((nb,), jnp.int32)
    tag_vals = jnp.ones((nv,), jnp.int32) if side == "right" \
        else jnp.zeros((nv,), jnp.int32)
    all_ridx = jnp.concatenate([bins_ridx, vals_ridx])
    all_val = jnp.concatenate([bins, vals])
    all_tag = jnp.concatenate([tag_bins, tag_vals])
    is_val = jnp.concatenate([jnp.zeros((nb,), jnp.int32), jnp.ones((nv,), jnp.int32)])
    orig = jnp.concatenate([jnp.arange(nb, dtype=jnp.int32),
                            jnp.arange(nv, dtype=jnp.int32)])
    s_ridx, s_val, s_tag, s_isval, s_orig = jax.lax.sort(
        (all_ridx, all_val, all_tag, is_val, orig), num_keys=3, is_stable=True)
    # number of bins at-or-before each merged position (global)
    bins_before = jnp.cumsum(1 - s_isval)
    # for each val (in merged order) its insertion index = global count of bins
    # before it (bins are globally contiguous per pack in `bins`)
    ins = jnp.where(s_isval == 1, bins_before, 0)
    out = jnp.zeros((nv,), jnp.int32)
    out = out.at[jnp.where(s_isval == 1, s_orig, nv)].set(ins.astype(jnp.int32), mode="drop")
    return out


def packed_invert_cdf(bins: Array, cdfs: Array, bins_ridx: Array,
                      u: Array, u_ridx: Array, n_packs: int,
                      eps: float = 1e-8) -> Array:
    """Inverse-CDF sample: for each u in its pack, find t s.t. CDF(t)=u by
    linear interpolation of (bins, cdfs) (reference: packed_invert_cdf /
    graphics/raysample.py:38 packed_sample_cdf)."""
    hi = packed_searchsorted(cdfs, bins_ridx, u, u_ridx, n_packs, side="right")
    nb = bins.shape[0]
    # clamp within each pack handled by global clamp + same-pack guarantee of
    # searchsorted (insertion stays inside the pack's span when u in [0,1))
    hi = jnp.clip(hi, 1, nb - 1)
    lo = hi - 1
    c0, c1 = cdfs[lo], cdfs[hi]
    b0, b1 = bins[lo], bins[hi]
    denom = jnp.where(jnp.abs(c1 - c0) < eps, 1.0, c1 - c0)
    t = (u - c0) / denom
    return b0 + jnp.clip(t, 0.0, 1.0) * (b1 - b0)


# =========================================================== volume render
def packed_alpha_to_vw(alpha: Array, ridx: Array) -> Array:
    """Visibility weights: vw_i = α_i · Π_{j<i in pack} (1-α_j)
    (reference: packed_alpha_to_vw, csrc alpha_to_vw_forward/backward —
    autodiff supplies the backward here)."""
    trans = packed_cumprod(jnp.clip(1.0 - alpha, 0.0, 1.0), ridx, exclusive=True)
    return alpha * trans


def packed_tau_to_vw(tau: Array, ridx: Array) -> Array:
    """From optical depth τ per sample: vw = (1-exp(-τ))·exp(-cumsum_excl τ)."""
    alpha = 1.0 - jnp.exp(-tau)
    t_excl = packed_cumsum(tau, ridx, exclusive=True)
    return alpha * jnp.exp(-t_excl)


def packed_volume_render_compression(alpha: Array, ridx: Array, n_packs: int,
                                     early_stop_eps: float = 1e-4
                                     ) -> Tuple[Array, Array]:
    """Mark samples whose accumulated transmittance has dropped below eps —
    they contribute nothing and can be compacted away before the expensive
    radiance query (reference: packed_volume_render_compression,
    pack_ops.py:286). Returns (keep_mask, vw)."""
    trans = packed_cumprod(jnp.clip(1.0 - alpha, 0.0, 1.0), ridx, exclusive=True)
    keep = (trans > early_stop_eps) & (ridx < n_packs)
    return keep, alpha * trans


# ================================================================ structural
def compactify(keep: Array, arrays: Sequence[Array], ridx: Array, n_packs: int,
               capacity: Optional[int] = None) -> Tuple[Tuple[Array, ...], Array]:
    """Order-preserving compaction of packed buffers.

    Drops samples where ``keep`` is False; result keeps the pack-contiguous
    invariant with padding (ridx==n_packs) at the end. This is the
    replacement for every CUDA "two-round count+fill" pattern.
    """
    n = keep.shape[0]
    if capacity is None:
        capacity = n
    keep = keep & (ridx < n_packs)
    pos = jnp.cumsum(keep) - 1  # target slot for kept samples
    tgt = jnp.where(keep, pos, capacity)  # dropped → scatter index `capacity` → dropped
    outs = []
    for a in arrays:
        out = jnp.zeros((capacity,) + a.shape[1:], a.dtype)
        outs.append(out.at[tgt].set(a, mode="drop"))
    new_ridx = jnp.full((capacity,), n_packs, ridx.dtype).at[tgt].set(ridx, mode="drop")
    return tuple(outs), new_ridx


def packed_to_dense(feats: Array, ridx: Array, n_packs: int, max_per_pack: int,
                    pad_value: float = 0.0) -> Tuple[Array, Array]:
    """Packed flat buffer → dense [n_packs, max_per_pack] + validity mask."""
    start = mark_pack_boundaries(ridx)
    pos = packed_cumsum(jnp.ones_like(ridx), ridx) - 1  # position within pack
    valid = (ridx < n_packs) & (pos < max_per_pack)
    r = jnp.where(valid, ridx, n_packs)
    p = jnp.where(valid, pos, 0)
    dense = jnp.full((n_packs + 1, max_per_pack) + feats.shape[1:], pad_value, feats.dtype)
    dense = dense.at[r, p].set(feats, mode="drop")
    mask = jnp.zeros((n_packs + 1, max_per_pack), bool).at[r, p].set(valid, mode="drop")
    del start
    return dense[:n_packs], mask[:n_packs]


def dense_to_packed(dense: Array, mask: Array, capacity: Optional[int] = None
                    ) -> Tuple[Array, Array]:
    """Dense [R, S] (+mask) → packed flat buffer (+ridx), compacted."""
    r_count, s_count = mask.shape
    flat = dense.reshape((r_count * s_count,) + dense.shape[2:])
    ridx = jnp.repeat(jnp.arange(r_count, dtype=jnp.int32), s_count)
    keep = mask.reshape(-1)
    (out,), new_ridx = compactify(keep, [flat], ridx, r_count, capacity=capacity)
    return out, new_ridx


def budget_indices(mask: Array, budget: int) -> Tuple[Array, Array]:
    """Per-row compaction indices: for each row, the positions of its first
    `budget` True entries (in order). Slots past a row's population count
    come back as idx 0 with valid=False (the all-zero one-hot row sums to
    0) — callers MUST mask on `valid`, never consume idx where it is False.

    mask [R, S] → (idx [R, B] int32, valid [R, B] bool). The
    compaction primitive, fully vectorized and branch-free: per-row rank =
    cumsum, then idx[r, j] = Σ_k k·1[rank(r,k) == j+1] — a compare+reduce
    over [R, S, B] that XLA fuses. Use with
    `take_along_axis` to budget-compact any per-sample array while keeping
    [R, B] shape (order within a row is preserved)."""
    hit, valid = _budget_onehot(mask, budget)
    k = jnp.arange(mask.shape[1], dtype=jnp.int32)
    idx = jnp.sum(k[None, None, :] * hit, axis=-1, dtype=jnp.int32)
    return idx, valid


def _budget_onehot(mask: Array, budget: int) -> Tuple[Array, Array]:
    """[R, B, S] one-hot selection tensor + [R, B] valid for row-local
    budget compaction: hit[r, j, k] = 1 iff column k holds row r's (j+1)-th
    True entry."""
    rank = jnp.cumsum(mask.astype(jnp.int32), axis=-1)           # [R, S]
    target = jnp.arange(1, budget + 1, dtype=jnp.int32)          # [B]
    # [R, B, S] — S stays in the 128-lane dimension (B is typically ~S/4,
    # so the [R, S, B] orientation ran the compare/reduce at a fraction
    # of lane width)
    hit = (jnp.where(mask, rank, 0)[:, None, :] == target[None, :, None])
    valid = rank[:, -1:] >= target[None, :]
    return hit, valid


def dense_to_budgeted(arrays: Sequence[Array], mask: Array, budget: int
                      ) -> Tuple[Tuple[Array, ...], Array]:
    """Budget-compact several [R, S, ...] arrays row-locally → [R, B, ...]
    (+ valid [R, B]). See `budget_indices`.

    The extraction itself is a one-hot contraction, not take_along_axis
    (a plain gather is the candidate to measure against it on the GPU).
    Exactness: each f32 output is a
    dot with a single 1.0 coefficient; HIGHEST precision keeps f32 values
    bit-clean through the matmul units. Integer arrays are contracted as two 16-bit
    halves of their 32-bit pattern (each half < 2^16, exactly representable
    in f32) and recombined — exact for the FULL int32 range, signed
    included, not just |v| < 2^24. Slots past a row's population count come
    back 0 (not a trailing-position copy) with valid=False — all callers
    mask on `valid`."""
    hit, valid = _budget_onehot(mask, budget)
    h = hit.astype(jnp.float32)

    def contract(flt):                       # [R,S(,F)] f32 → [R,B(,F)]
        if flt.ndim == 2:
            return jnp.einsum("rbs,rs->rb", h, flt,
                              precision=jax.lax.Precision.HIGHEST)
        f = int(np.prod(flt.shape[2:]))
        o = jnp.einsum("rbs,rsf->rbf", h,
                       flt.reshape(flt.shape[0], flt.shape[1], f),
                       precision=jax.lax.Precision.HIGHEST)
        return o.reshape(flt.shape[0], budget, *flt.shape[2:])

    outs = []
    for a in arrays:
        if a.dtype == jnp.bool_:
            outs.append(contract(a.astype(jnp.float32)) > 0.5)
        elif jnp.issubdtype(a.dtype, jnp.integer):
            # two exact 16-bit-half contractions over the uint32 pattern
            # (a single f32 contraction corrupts |v| >= 2^24)
            u = a.astype(jnp.uint32)
            lo = contract((u & jnp.uint32(0xFFFF)).astype(jnp.float32))
            hi = contract((u >> jnp.uint32(16)).astype(jnp.float32))
            v = (jnp.round(hi).astype(jnp.uint32) << jnp.uint32(16)) \
                | jnp.round(lo).astype(jnp.uint32)
            outs.append(v.astype(a.dtype))
        else:
            outs.append(contract(a.astype(jnp.float32)).astype(a.dtype))
    return tuple(outs), valid


def merge_two_packs_sorted_aligned(valsA: Array, keyA: Array, ridxA: Array,
                                   valsB: Array, keyB: Array, ridxB: Array,
                                   n_packs: int) -> Tuple[Array, Array, Array, Array]:
    """Merge two packed sorted buffers over the SAME set of packs into one
    sorted packed buffer (reference: merge_two_packs_sorted_aligned,
    pack_ops.py:529). Returns (vals, key, ridx, came_from_B flag)."""
    key = jnp.concatenate([keyA, keyB])
    ridx = jnp.concatenate([ridxA, ridxB])
    vals = jnp.concatenate([valsA, valsB], axis=0)
    is_b = jnp.concatenate([jnp.zeros(keyA.shape[0], jnp.int32),
                            jnp.ones(keyB.shape[0], jnp.int32)])
    if vals.ndim == 1:
        s_ridx, s_key, s_vals, s_b = jax.lax.sort((ridx, key, vals, is_b),
                                                  num_keys=2, is_stable=True)
    else:
        # sort index payload, then gather nd vals
        idx = jnp.arange(key.shape[0], dtype=jnp.int32)
        s_ridx, s_key, s_idx, s_b = jax.lax.sort((ridx, key, idx, is_b),
                                                 num_keys=2, is_stable=True)
        s_vals = vals[s_idx]
    return s_vals, s_key, s_ridx, s_b


def packed_matmul(feats: Array, mats: Array, ridx: Array,
                  n_packs: Optional[int] = None) -> Array:
    """Per-sample matmul with its pack's matrix: out[i] = mats[ridx[i]] @ feats[i]
    (reference: packed_matmul). feats [N,D]; mats [P,O,D] → [N,O]."""
    if n_packs is None:
        n_packs = mats.shape[0]
    m = mats[jnp.minimum(ridx, n_packs - 1)]
    out = jnp.einsum("nod,nd->no", m, feats)
    return jnp.where((ridx < n_packs)[:, None], out, 0.0)


def merge_two_batch(valsA: Array, keyA: Array, valsB: Array, keyB: Array
                    ) -> Tuple[Array, Array, Array]:
    """Merge two dense per-ray sorted sample sets [R,Sa]/[R,Sb] → sorted
    [R,Sa+Sb] (reference: merge_two_batch). Returns (vals, key, from_B)."""
    key = jnp.concatenate([keyA, keyB], -1)
    is_b = jnp.concatenate([jnp.zeros_like(keyA, jnp.int32),
                            jnp.ones_like(keyB, jnp.int32)], -1)
    vals = jnp.concatenate([valsA, valsB], axis=-2 if valsA.ndim > 2 else -1)
    # payload sort, not argsort + take_along_axis; feature channels ride
    # as extra payload operands
    if vals.ndim == key.ndim:
        key_s, is_b_s, vals_s = jax.lax.sort((key, is_b, vals), num_keys=1,
                                             is_stable=True)
        return vals_s, key_s, is_b_s
    chans = tuple(vals[..., f] for f in range(vals.shape[-1]))
    out = jax.lax.sort((key, is_b) + chans, num_keys=1, is_stable=True)
    key_s, is_b_s = out[0], out[1]
    vals_s = jnp.stack(out[2:], axis=-1)
    return vals_s, key_s, is_b_s


def try_merge_two_packs_sorted_aligned(valsA, keyA, ridxA, valsB, keyB, ridxB,
                                       n_packs: int):
    """Alias of merge_two_packs_sorted_aligned (the reference's 'try_' variant
    falls back to unaligned merging; packed sort handles both here)."""
    return merge_two_packs_sorted_aligned(valsA, keyA, ridxA, valsB, keyB,
                                          ridxB, n_packs)


# ============================================== round-5 parity tail (VERDICT #7)
# Reference names from graphics/pack_ops/pack_ops.py:16-71 not yet covered.
# Design notes per name live in docs/pack_ops.md §"reference parity".

packed_searchsorted_packed_vals = packed_searchsorted
"""In the ridx design `packed_searchsorted` already takes PACKED vals
(vals, vals_ridx) — the reference needs a second entry point only because
its batched variant takes [n_packs, M] vals (pack_ops.py:88). Alias kept
for name parity."""


def packed_sort_inplace(key: Array, ridx: Array, *payload: Array):
    """Functional stand-in for the reference's in-place qsort
    (pack_ops.py:74): JAX arrays are immutable, so this IS `packed_sort`
    (same returns); kept for name parity."""
    return packed_sort(key, ridx, *payload)


def interleave_arange(start: Array, stop: Array, step: Array, capacity: int
                      ) -> Tuple[Array, Array]:
    """Packed [start_i, stop_i) aranges with per-pack step (reference:
    interleave_arange, pack_ops.py:438): counts = ceil((stop−start)/step)."""
    step = jnp.broadcast_to(jnp.asarray(step, start.dtype), start.shape)
    counts = jnp.ceil((stop - start) / step).astype(jnp.int32)
    counts = jnp.maximum(counts, 0)
    return interleave_linstep(start, counts, step, capacity)


def interleave_linspace(start: Array, stop: Array, num_steps, capacity: int
                        ) -> Tuple[Array, Array]:
    """Packed linspace(start_i, stop_i, n_i) (reference: interleave_linspace,
    pack_ops.py:448): step = (stop−start)/(n−1)."""
    if jnp.ndim(num_steps) == 0:
        num_steps = jnp.full(start.shape, int(num_steps), jnp.int32)
    denom = jnp.maximum(num_steps - 1, 1).astype(start.dtype)
    step = (stop - start) / denom
    return interleave_linstep(start, num_steps.astype(jnp.int32), step,
                              capacity)


def _depth_clamped_steps(t0: Array, n_steps: int, dt_gamma: float,
                         min_step_size: float, max_step_size: float
                         ) -> Tuple[Array, Array]:
    """t_{k+1} = t_k + clamp(γ·t_k, min, max) from t0 [R] → (t [R,S], dt
    [R,S]) (reference: ray_marching.cu calc_dt — dt proportional to the
    CURRENT depth, clamped both ways)."""
    def body(t, _):
        dt = jnp.clip(t * dt_gamma, min_step_size, max_step_size)
        return t + dt, (t, dt)

    _, (t, dt) = jax.lax.scan(body, t0, None, length=n_steps)
    return jnp.moveaxis(t, 0, -1), jnp.moveaxis(dt, 0, -1)


def interleave_sample_step_wrt_depth_clamped(
        near: Array, far: Array, max_steps: int = 512,
        dt_gamma: float = 0.01, min_step_size: float = 0.01,
        max_step_size: float = 1.0, step_size_factor: float = 1.0,
        perturb_key=None) -> Tuple[Array, Array, Array]:
    """Depth-proportional packed step sampler (reference:
    interleave_sample_step_wrt_depth_clamped, pack_ops.py:454): steps grow
    ∝ depth (clamped to [min,max]·factor) from near to far. Static-capacity
    form: returns flat (t [R·S], dt [R·S], ridx [R·S]) with padding
    ridx == R past each ray's far."""
    dt_gamma = dt_gamma * step_size_factor
    min_step_size = min_step_size * step_size_factor
    max_step_size = max_step_size * step_size_factor
    r = near.shape[0]
    t, dt = _depth_clamped_steps(near, max_steps, dt_gamma, min_step_size,
                                 max_step_size)
    if perturb_key is not None:
        t = t + jax.random.uniform(perturb_key, t.shape, t.dtype) * dt
    in_range = t < far[:, None]
    ridx = jnp.where(in_range, jnp.arange(r, dtype=jnp.int32)[:, None], r)
    return t.reshape(-1), dt.reshape(-1), ridx.reshape(-1)


def interleave_sample_step_wrt_depth_in_packed_segments(
        near: Array, far: Array, entry: Array, exit_: Array,
        seg_ridx: Array, n_rays: int, steps_per_segment: int = 32,
        dt_gamma: float = 0.01, min_step_size: float = 0.01,
        max_step_size: float = 1e10, step_size_factor: float = 1.0,
        perturb_key=None) -> Tuple[Array, Array, Array, Array]:
    """Depth-proportional stepping INSIDE ray segments (reference:
    interleave_sample_step_wrt_depth_in_packed_segments, pack_ops.py:476 —
    the forest/octree sampler: segments come from a block raytrace).

    entry/exit_ [M] packed per-segment ranges, seg_ridx [M] their ray ids
    (sentinel n_rays for padding). Static-capacity form: each segment gets
    ≤ steps_per_segment samples → (t [M·S], dt [M·S], ridx [M·S] ray ids,
    sidx [M·S] segment ids), padding ridx == n_rays / sidx == M."""
    dt_gamma = dt_gamma * step_size_factor
    min_step_size = min_step_size * step_size_factor
    max_step_size = max_step_size * step_size_factor
    m = entry.shape[0]
    t0 = jnp.maximum(entry, _broadcast_pack(near, seg_ridx, n_rays))
    t, dt = _depth_clamped_steps(t0, steps_per_segment, dt_gamma,
                                 min_step_size, max_step_size)
    if perturb_key is not None:
        t = t + jax.random.uniform(perturb_key, t.shape, t.dtype) * dt
    t_hi = jnp.minimum(exit_, _broadcast_pack(far, seg_ridx, n_rays))
    in_range = (t < t_hi[:, None]) & (seg_ridx < n_rays)[:, None]
    ridx = jnp.where(in_range,
                     jnp.minimum(seg_ridx, n_rays)[:, None], n_rays)
    sidx = jnp.where(in_range, jnp.arange(m, dtype=jnp.int32)[:, None], m)
    return t.reshape(-1), dt.reshape(-1), ridx.reshape(-1), sidx.reshape(-1)


def merge_two_packs_sorted(valsA: Array, keyA: Array, ridxA: Array,
                           valsB: Array, keyB: Array, ridxB: Array,
                           n_packs: int) -> Tuple[Array, Array, Array, Array]:
    """General sorted-pack merge (reference: merge_two_packs_sorted,
    pack_ops.py:603). The reference needs intersect/exclusive index
    bookkeeping because its packs are dense lists per DISTINCT nidx set;
    the ridx/sentinel design indexes packs globally, so non-aligned pack
    sets merge with the SAME one stable sort as the aligned case —
    alignment was never assumed."""
    return merge_two_packs_sorted_aligned(valsA, keyA, ridxA, valsB, keyB,
                                          ridxB, n_packs)


def merge_two_packs_sorted_a_includes_b(valsA: Array, keyA: Array,
                                        ridxA: Array, valsB: Array,
                                        keyB: Array, ridxB: Array,
                                        n_packs: int
                                        ) -> Tuple[Array, Array, Array, Array]:
    """Reference pack_ops.py:547 — the 'b's packs are a subset of a's'
    special case; subsumed by the general merge here (see
    merge_two_packs_sorted)."""
    return merge_two_packs_sorted_aligned(valsA, keyA, ridxA, valsB, keyB,
                                          ridxB, n_packs)


def merge_two_batch_a_includes_b(valsA: Array, nidxA: Array,
                                 valsB: Array, nidxB: Array,
                                 n_packs: int
                                 ) -> Tuple[Array, Array, Array, Array]:
    """Merge batched rows valsB [Nb,Sb] into the rows of valsA [Na,Sa]
    selected by nidxB (reference: merge_two_batch_a_includes_b,
    pack_ops.py:670; every nidxB must appear in nidxA). Returns the packed
    merged buffer (vals, key=vals, ridx over n_packs, from_B) — rows of A
    not in nidxB keep only their own samples."""
    na, sa = valsA.shape
    nb, sb = valsB.shape
    # scatter B rows onto A's pack ids, then one aligned packed merge
    ridxA_flat = jnp.broadcast_to(
        jnp.minimum(nidxA, n_packs)[:, None], (na, sa)).reshape(-1)
    ridxB_flat = jnp.broadcast_to(
        jnp.minimum(nidxB, n_packs)[:, None], (nb, sb)).reshape(-1)
    return merge_two_packs_sorted_aligned(
        valsA.reshape(-1), valsA.reshape(-1), ridxA_flat.astype(jnp.int32),
        valsB.reshape(-1), valsB.reshape(-1), ridxB_flat.astype(jnp.int32),
        n_packs)


def expand_pack_boundary(pack_boundary: Array, num_samples: int) -> Array:
    """Expand per-pack boundary marks to num_samples-per-entry granularity
    (reference: expand_pack_boundary, pack_ops.py:725): mark j ⇒ mark at
    j·num_samples in the expanded buffer."""
    out = jnp.zeros((pack_boundary.shape[0] * num_samples,), bool)
    idx = jnp.where(pack_boundary, jnp.arange(pack_boundary.shape[0]) * num_samples,
                    out.shape[0])
    return out.at[idx].set(True, mode="drop")


def octree_mark_consecutive_segments(pidx: Array, ridx: Array
                                     ) -> Array:
    """Mark the first sample of each run of consecutive equal (ray, node)
    pairs (reference: octree_mark_consecutive_segments, pack_ops.py:506 —
    there tied to kaolin SPC point_hierarchies; here the node id `pidx` is
    any per-sample cell/block id, e.g. the forest block index)."""
    new_ray = mark_pack_boundaries(ridx)
    new_node = jnp.concatenate([jnp.ones((1,), bool), pidx[1:] != pidx[:-1]])
    return new_ray | new_node


def intersect1d_unique(a: Array, b: Array, n_max: int
                       ) -> Tuple[Array, Array, Array]:
    """Static-shape analogue of the reference's torch_intersect1d_unique
    (pack_ops.py:512): a, b sorted unique id lists (sentinel-padded to
    static length). Returns (in_both_a [len(a)] bool, in_both_b [len(b)]
    bool, union_sorted [n_max] sentinel-padded). The reference returns
    dynamic index lists; masks are the static-shape equivalent."""
    in_b = jnp.isin(a, b)
    in_a = jnp.isin(b, a)
    sentinel = jnp.iinfo(a.dtype).max if jnp.issubdtype(a.dtype, jnp.integer) \
        else jnp.inf
    cat = jnp.concatenate([a, jnp.where(in_a, sentinel, b)])
    union = jnp.sort(cat)[:n_max]
    return in_b, in_a, union
