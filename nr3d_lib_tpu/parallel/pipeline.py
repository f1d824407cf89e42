"""Pipeline parallelism over a 'stage' mesh axis.

Neural-field models are encode→decode chains; when the decoder stack is
deep enough to matter (style/generative variants, big radiance heads), the
mesh-native scaling axis is a pipeline: put stage s's params on mesh slice
s, stream microbatches through, and hand activations to the next stage
with `ppermute` over ICI — no host involvement, fully inside one jit.

`pipeline_apply` implements the classic schedule for S stages and M
microbatches (M ≥ S): at tick t ∈ [0, S+M−1), stage s processes microbatch
t−s. Every device runs every tick (SPMD); devices outside the active
diagonal compute on garbage and their output is masked — the standard
zero-bubble-free schedule (bubble fraction (S−1)/(S+M−1)).

All stage callables take/return activations of one fixed shape (pad your
stage boundaries); stage params live sharded over the stage axis and are
selected per-device with `jax.lax.switch`-free arithmetic: each device
holds ONLY its stage's params (shard_map slices them), so there is no
parameter broadcast at all.

This is framework infrastructure the CUDA reference has no analogue for
(single-GPU); cited scale anchor: SURVEY.md §5 parallelism plan.
"""

from __future__ import annotations

from typing import Callable, Sequence

import jax
import jax.numpy as jnp

__all__ = ["pipeline_apply"]

Array = jax.Array


def pipeline_apply(stage_fn: Callable[[Array, Array], Array],
                   stage_params: Array, x_microbatches: Array,
                   mesh: jax.sharding.Mesh, stage_axis: str = "stage"
                   ) -> Array:
    """Run `stage_fn(params_s, h)` for stages s = 0..S−1 over microbatches.

    stage_params:    [S, ...] — leaf axis 0 sharded over `stage_axis`
                     (each device sees its own [1, ...] slice).
    x_microbatches:  [M, B, F] — replicated over the stage axis.
    Returns [M, B, F_out] where F_out = F (fixed activation shape).

    The rotation: each tick, every device applies its stage to its current
    activation, then ppermutes the result to the next stage's device. The
    first stage feeds itself microbatch t; the last stage's outputs are
    collected. M must be ≥ 1; S+M−1 ticks total.
    """
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    n_stages = mesh.shape[stage_axis]
    n_micro = x_microbatches.shape[0]
    perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]

    def local(params_slice, xs):
        # params_slice: [1, ...] (this device's stage); xs: [M, B, F]
        sidx = jax.lax.axis_index(stage_axis)
        p = params_slice[0]
        b, f = xs.shape[1], xs.shape[2]
        # mark the carries as stage-varying up front (they become varying
        # inside the loop via sidx/ppermute; scan carries must not change
        # their varying-manual-axes type)
        h = jax.lax.pcast(jnp.zeros((b, f), xs.dtype), (stage_axis,),
                          to="varying")
        outs = jax.lax.pcast(jnp.zeros_like(xs), (stage_axis,),
                             to="varying")

        def tick(t, carry):
            h, outs = carry
            # stage 0 ingests microbatch t (if any remain)
            m_in = jnp.clip(t, 0, n_micro - 1)
            h = jnp.where(sidx == 0,
                          jnp.where(t < n_micro, xs[m_in], 0.0), h)
            h2 = stage_fn(p, h)
            # last stage emits microbatch t−(S−1) (if valid)
            m_out = t - (n_stages - 1)
            valid = (sidx == n_stages - 1) & (m_out >= 0) & (m_out < n_micro)
            # each slot is written exactly once (tick t = m_out + S−1), so
            # a masked add avoids a cond (invalid ticks contribute zeros)
            outs = outs.at[jnp.clip(m_out, 0, n_micro - 1)].add(
                jnp.where(valid, h2, 0.0))
            # rotate activations one stage forward over ICI
            h_next = jax.lax.ppermute(h2, stage_axis, perm)
            return h_next, outs

        _, outs = jax.lax.fori_loop(0, n_stages + n_micro - 1, tick,
                                    (h, outs))
        # only the last stage holds real outputs; psum broadcasts them
        # (every other device contributes zeros)
        outs = jnp.where(sidx == n_stages - 1, outs, 0.0)
        return jax.lax.psum(outs, stage_axis)

    return shard_map(local, mesh=mesh,
                     in_specs=(P(stage_axis), P()),
                     out_specs=P())(stage_params, x_microbatches)
