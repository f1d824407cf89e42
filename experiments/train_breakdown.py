"""Phase breakdown of the compressed NeuS TRAIN step on the GPU.

Where do the ms go?  Times nested prefixes:

  sample   march + upsample rounds, forward only (stop_gradient placement)
  fwd      + final compressed composite, loss VALUE only
  bwd1     value_and_grad of (rgb loss) — 1st-order backward, adam applied
  bwd2     + eikonal term — adds the nablas 2nd-order backward

Deltas attribute: sampling cost / final forward / 1st-order backward /
2nd-order surcharge.  Run: timeout 3600 python experiments/train_breakdown.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build(n_rays=4096, w4=False):
    import jax
    import jax.numpy as jnp
    import optax
    from nr3d_lib_tpu import nn

    from nr3d_lib_tpu.models.model_base import LoTDNeuSModel

    enc_cfg = {"lotd_cfg": {
        "lod_res": [16, 32, 64, 128], "lod_n_feats": 2,
        "lod_types": ["Dense", "Dense", "Hash", "Hash"],
        "hashmap_size": 2 ** 16}, "backend": "brick"}
    if w4:
        enc_cfg = {"lotd_cfg": {
            "lod_res": [16, 64], "lod_n_feats": 4,
            "lod_types": ["Dense", "Hash"], "hashmap_size": 2 ** 16},
            "backend": "brick"}
    model = LoTDNeuSModel(
        field_cfg={"surface_cfg": {"encoding_cfg": enc_cfg,
                                   "decoder_cfg": {"D": 1, "W": 64}},
                   "radiance_cfg": {"D": 2, "W": 64}},
        accel_cfg={"resolution": 64, "max_steps_per_ray": 96,
                   "step_size": 2.0 / 96},
        ray_query_cfg={"query_mode": "march_occ_multi_upsample_compressed",
                       "compression_factor": 0.25,
                       # safe: 15% occupancy seeded below (library default
                       # is 1.0; budgeting truncates far-first past budget)
                       "march_budget_factor": 0.5})
    model.populate()
    occ = jax.random.uniform(jax.random.key(5),
                             model.accel.occ.val_grid[...].shape) < 0.15
    model.accel.occ.val_grid[...] = occ.astype(jnp.float32)
    graphdef, params, rest = nn.split(model, nn.Param, ...)
    opt = optax.adam(5e-3)
    opt_state = opt.init(params)

    k1, k2 = jax.random.split(jax.random.key(0))
    o = jax.random.normal(k1, (n_rays, 3))
    o = o / jnp.linalg.norm(o, axis=-1, keepdims=True) * 2.0
    d = -o / 2.0 + jax.random.normal(k2, (n_rays, 3)) * 0.1
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    rgb_gt = jnp.abs(d)

    from nr3d_lib_tpu.graphics import pack_ops as po
    from nr3d_lib_tpu.graphics.neus_ray_query import _upsample_rounds

    def sample_only(p, oo, dd, key):
        m = nn.merge(graphdef, p, rest)
        rt = m.space.ray_test(oo, dd)
        o_n, d_n = m.space.normalize_rays(rt["rays_o"], rt["rays_d"])
        t, dt, smask = m.accel.ray_march(o_n, d_n, rt["near"], rt["far"],
                                         perturb_key=key)
        b0 = t.shape[1] // 2
        (t,), smask = po.dense_to_budgeted([t], smask, b0)
        t, valid = _upsample_rounds(
            lambda x: m.forward_sdf(x)["sdf"], o_n, d_n, t, smask,
            rt["far"], 64.0, (1.0, 4.0, 16.0), 32, key)
        return jnp.sum(t * valid)

    def loss_of(p, oo, dd, key, with_eik):
        m = nn.merge(graphdef, p, rest)
        rt = m.space.ray_test(oo, dd)
        rendered, vb = m.ray_query(rt, key=key)
        loss = jnp.mean((rendered["rgb_volume"] - rgb_gt) ** 2)
        if with_eik:
            w = (vb["ridx"] < oo.shape[0]).astype(jnp.float32)
            err = (jnp.linalg.norm(vb["nablas_packed"], axis=-1) - 1.0) ** 2
            loss = loss + 0.1 * jnp.sum(err * w) / jnp.maximum(jnp.sum(w), 1.0)
        return loss

    def make(phase):
        import jax

        def step(p, os_, oo, dd, key):
            if phase == "sample":
                return p, os_, sample_only(p, oo, dd, key)
            if phase == "fwd":
                return p, os_, loss_of(p, oo, dd, key, False)
            l, g = jax.value_and_grad(loss_of)(p, oo, dd, key,
                                               phase == "bwd2")
            up, os2 = opt.update(g, os_)
            return optax.apply_updates(p, up), os2, l

        return step

    return make, params, opt_state, o, d


def timeit(step, params, opt_state, o, d, n_hi=5):
    import jax
    import jax.numpy as jnp

    def chain(n):
        def chained(c, p, os_, oo, dd):
            def body(i, carry):
                cc, pp, ss = carry
                pp, ss, l = step(pp, ss, oo * (1.0 + cc * 1e-30), dd,
                                 jax.random.key(0))
                return l * 1e-30, pp, ss

            out = jax.lax.fori_loop(0, n, body, (c, p, os_))
            return out[0] + jax.tree.leaves(out[1])[0].ravel()[0] * 1e-30

        return jax.jit(chained)

    f_lo, f_hi = chain(1), chain(n_hi)

    def t(f):
        t0 = time.perf_counter()
        float(f(0.0, params, opt_state, o, d))
        return time.perf_counter() - t0

    float(f_lo(0.0, params, opt_state, o, d))
    float(f_hi(0.0, params, opt_state, o, d))
    return (min(t(f_hi) for _ in range(3)) - min(t(f_lo) for _ in range(3))) \
        / (n_hi - 1)


def main():
    import jax

    from nr3d_lib_tpu.utils import enable_compile_cache

    enable_compile_cache()
    w4 = "--w4" in sys.argv
    n_rays = 4096
    make, params, opt_state, o, d = build(n_rays, w4)
    prev = 0.0
    for phase in ["sample", "fwd", "bwd1", "bwd2"]:
        dt = timeit(make(phase), params, opt_state, o, d)
        print(f"{'w4 ' if w4 else ''}{phase:7s}: {dt*1e3:7.2f} ms "
              f"(+{(dt-prev)*1e3:6.2f}) -> {n_rays/dt/1e3:6.1f} Krays/s",
              flush=True)
        prev = dt


if __name__ == "__main__":
    main()
