"""Phase breakdown of the compressed NeRF render on the GPU.

Answers: where do the ms go?  Times successive prefixes of
the pipeline (march → compaction → density → radiance → full composite)
with the chained-timing harness, plus a ray-batch scaling sweep — if
rays/s climbs with the batch, the residual is per-call overhead, not
per-sample compute.

    python experiments/render_breakdown.py [n_rays ...]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build(n_rays):
    import jax
    import jax.numpy as jnp
    from nr3d_lib_tpu import nn

    from nr3d_lib_tpu.graphics import pack_ops as po
    from nr3d_lib_tpu.graphics.nerf import ray_alpha_to_vw, tau_to_alpha
    from nr3d_lib_tpu.models.model_base import LoTDNeRFModel

    model = LoTDNeRFModel(
        field_cfg={"encoding_cfg": {"lotd_cfg": {
            "lod_res": [16, 32, 64, 128, 256, 512], "lod_n_feats": 2,
            "lod_types": ["Dense", "Dense", "Dense", "Hash", "Hash", "Hash"],
            "hashmap_size": 2 ** 17}, "backend": "brick"},
            "density_decoder_cfg": {"D": 1, "W": 64},
            "radiance_cfg": {"D": 2, "W": 64}},
        accel_cfg={"resolution": 64, "max_steps_per_ray": 96,
                   "step_size": 2.0 / 96},
        ray_query_cfg={"query_mode": "march_occ_compressed",
                       "compression_factor": 0.25})
    model.populate()
    occ = jax.random.uniform(jax.random.key(5),
                             model.accel.occ.val_grid[...].shape) < 0.15
    model.accel.occ.val_grid[...] = occ.astype(jnp.float32)
    graphdef, state = nn.split(model)

    k1, k2 = jax.random.split(jax.random.key(0))
    o = jax.random.normal(k1, (n_rays, 3))
    o = o / jnp.linalg.norm(o, axis=-1, keepdims=True) * 2.0
    d = -o / 2.0 + jax.random.normal(k2, (n_rays, 3)) * 0.1
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)

    def phase(stop):
        def run(st, oo, dd):
            m = nn.merge(graphdef, st)
            rt = m.ray_test(oo, dd)
            o_n, d_n = m.space.normalize_rays(rt["rays_o"], rt["rays_d"])
            t, dt, smask = m.accel.ray_march(o_n, d_n, rt["near"], rt["far"])
            smask = smask & rt["mask"][:, None]
            if stop == "march":
                return jnp.sum(t * smask) * 1e-6
            r, s = t.shape
            b1 = max(int(s * 0.25), 1)
            (t1, dt1), valid1 = po.dense_to_budgeted([t, dt], smask, b1)
            if stop == "compact1":
                return jnp.sum(t1 * valid1) * 1e-6
            x1 = o_n[:, None, :] + d_n[:, None, :] * t1[..., None]
            den = m.forward_density(x1.reshape(r * b1, 3))
            sigma = den["sigma"].reshape(r, b1)
            alpha1 = jnp.where(valid1, tau_to_alpha(sigma * dt1), 0.0)
            if stop == "density":
                return jnp.sum(alpha1) * 1e-6
            trans = jnp.cumprod(jnp.concatenate(
                [jnp.ones_like(alpha1[:, :1]), 1.0 - alpha1[:, :-1]], -1), -1)
            keep2 = valid1 & (alpha1 > 0) & (trans > 1e-4)
            b2 = max(int(b1 * 0.5), 1)
            (t2, alpha2, h2), valid2 = po.dense_to_budgeted(
                [t1, alpha1, den["h"].reshape(r, b1, -1)], keep2, b2)
            alpha2 = jnp.where(valid2, alpha2, 0.0)
            if stop == "compact2":
                return jnp.sum(alpha2) * 1e-6
            x2 = o_n[:, None, :] + d_n[:, None, :] * t2[..., None]
            v2 = jnp.broadcast_to(rt["rays_d"][:, None, :], (r, b2, 3))
            rgb = m.radiance(x2.reshape(r * b2, 3), v2.reshape(r * b2, 3),
                             None, h2.reshape(r * b2, -1)).reshape(r, b2, 3)
            vw = ray_alpha_to_vw(alpha2)
            return jnp.sum(vw[..., None] * rgb) * 1e-6

        return run

    return phase, state, o, d


def timeit(run, state, o, d, n_rays):
    import jax
    import jax.numpy as jnp

    def chained(n, c, st, oo, dd):
        def body(i, carry):
            cc, acc = carry
            y = run(st, oo * (1.0 + cc * 1e-30), dd)
            return y * 1e-30, acc + y

        return jax.lax.fori_loop(0, n, body, (c, jnp.zeros(())))[1]

    f = jax.jit(chained)
    float(f(1, 0.0, state, o, d))
    t_lo = min(_t(f, 1, state, o, d) for _ in range(3))
    t_hi = min(_t(f, 9, state, o, d) for _ in range(3))
    dt = (t_hi - t_lo) / 8
    return dt


def _t(f, n, state, o, d):
    t0 = time.perf_counter()
    float(f(n, 0.0, state, o, d))
    return time.perf_counter() - t0


def main():
    import jax

    from nr3d_lib_tpu.utils import enable_compile_cache

    enable_compile_cache()

    batches = [int(a) for a in sys.argv[1:]] or [8192, 32768]
    for n_rays in batches:
        phase, state, o, d = build(n_rays)
        prev = 0.0
        for stop in ["march", "compact1", "density", "compact2", "full"]:
            dt = timeit(phase(stop), state, o, d, n_rays)
            print(f"rays={n_rays:6d} {stop:9s}: {dt*1e3:7.2f} ms "
                  f"(+{(dt-prev)*1e3:6.2f}) -> {n_rays/dt/1e3:7.1f} Krays/s",
                  flush=True)
            prev = dt


if __name__ == "__main__":
    main()
