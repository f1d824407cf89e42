"""Secondary benchmark: end-to-end NeRF render throughput (rays/s) on the GPU.

Not the driver's headline metric (bench.py is) — run manually:
    python experiments/bench_render.py [--brick] [--mode march_occ|march_occ_compressed]

Measures the full march→encode→MLP→composite forward on the GPU with the
chained-timing harness. All arrays are jit ARGUMENTS (closed-over device
arrays become jaxpr constants). Run one process per card.
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(use_brick: bool = False, mode: str = "march_occ",
         n_rays: int = 8192, compression_factor: float = 0.25,
         w4: bool = False):
    import jax

    from nr3d_lib_tpu.utils import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp
    from nr3d_lib_tpu import nn

    from nr3d_lib_tpu.models.model_base import LoTDNeRFModel

    enc_cfg = {"lotd_cfg": {
        "lod_res": [16, 32, 64, 128, 256, 512], "lod_n_feats": 2,
        "lod_types": ["Dense", "Dense", "Dense", "Hash", "Hash", "Hash"],
        "hashmap_size": 2 ** 17}}
    if w4:
        # bf16-packed F=4 (ops/lotd_brick4.py): half the levels carry the
        # same 12 output features at half the gather issues per point
        enc_cfg = {"lotd_cfg": {
            "lod_res": [16, 64, 512], "lod_n_feats": 4,
            "lod_types": ["Dense", "Hash", "Hash"],
            "hashmap_size": 2 ** 17}}
    if use_brick:
        enc_cfg["backend"] = "brick"
    qcfg = {"query_mode": mode}
    if mode == "march_occ_compressed":
        qcfg["compression_factor"] = compression_factor
    model = LoTDNeRFModel(
        field_cfg={"encoding_cfg": enc_cfg,
                   "density_decoder_cfg": {"D": 1, "W": 64},
                   "radiance_cfg": {"D": 2, "W": 64}},
        accel_cfg={"resolution": 64, "max_steps_per_ray": 96,
                   "step_size": 2.0 / 96},
        ray_query_cfg=qcfg)
    model.populate()
    # realistic occupancy: ~15% of cells on (a sphere-ish shell), so the
    # compressed path has real sparsity to exploit, as in a trained scene
    occ = jax.random.uniform(jax.random.key(5),
                             model.accel.occ.val_grid[...].shape) < 0.15
    model.accel.occ.val_grid[...] = occ.astype(jnp.float32)
    graphdef, state = nn.split(model)

    k1, k2 = jax.random.split(jax.random.key(0))
    o = jax.random.normal(k1, (n_rays, 3))
    o = o / jnp.linalg.norm(o, axis=-1, keepdims=True) * 2.0
    d = -o / 2.0 + jax.random.normal(k2, (n_rays, 3)) * 0.1
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)

    def render(st, oo, dd):
        m = nn.merge(graphdef, st)
        rt = m.ray_test(oo, dd)
        rendered, _ = m.ray_query(rt)
        return rendered["rgb_volume"]

    def chain(n):
        def chained(c, st, oo, dd):
            def body(i, carry):
                cc, acc = carry
                y = render(st, oo * (1.0 + cc * 1e-30), dd)
                s = jnp.sum(y.astype(jnp.float32))
                return s * 1e-30, acc + s

            return jax.lax.fori_loop(0, n, body, (c, 0.0))[1]

        return jax.jit(chained)

    f_lo, f_hi = chain(1), chain(5)
    float(f_lo(0.0, state, o, d))
    float(f_hi(0.0, state, o, d))

    def t(f):
        t0 = time.perf_counter()
        float(f(0.0, state, o, d))
        return time.perf_counter() - t0

    dt = (min(t(f_hi) for _ in range(3)) - min(t(f_lo) for _ in range(3))) / 4
    rays_s = n_rays / dt
    samples = n_rays * 96
    print(f"render fwd ({'brick4' if w4 else 'brick' if use_brick else 'xla'}"
          f" encode, {mode}): "
          f"{dt*1e3:.2f} ms / {n_rays} rays -> {rays_s/1e3:.1f} Krays/s "
          f"({samples/dt/1e6:.1f} Msamples/s incl. masked)",
          file=sys.stderr)
    return rays_s


def main_train(use_brick: bool = False, kind: str = "nerf",
               n_rays: int = 4096, n_samples: int = 64):
    """Training-step throughput: full fwd+bwd+adam through the renderer.

    kind='nerf': brick/XLA LoTD NeRF, fixed sampling, frozen-x backward on
    the brick path. kind='neus': LoTD NeuS with nablas + eikonal — the
    2nd-order path (reference math_test.py exercises; StreetSurf workload).
    """
    import jax

    from nr3d_lib_tpu.utils import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp
    import optax
    from nr3d_lib_tpu import nn

    if kind == "nerf":
        from nr3d_lib_tpu.graphics.nerf_ray_query import nerf_ray_query_fixed
        from nr3d_lib_tpu.models.model_base import LoTDNeRFModel

        enc_cfg = {"lotd_cfg": {
            "lod_res": [16, 32, 64, 128, 256, 512], "lod_n_feats": 2,
            "lod_types": ["Dense", "Dense", "Dense", "Hash", "Hash", "Hash"],
            "hashmap_size": 2 ** 17}}
        if use_brick:
            enc_cfg["backend"] = "brick"
        model = LoTDNeRFModel(field_cfg={
            "encoding_cfg": enc_cfg,
            "density_decoder_cfg": {"D": 1, "W": 64},
            "radiance_cfg": {"D": 2, "W": 64}})
    else:
        from nr3d_lib_tpu.graphics.neus_ray_query import (
            neus_ray_query_coarse_multi_upsample)
        from nr3d_lib_tpu.models.model_base import LoTDNeuSModel

        enc_cfg = {"lotd_cfg": {
            "lod_res": [16, 32, 64, 128], "lod_n_feats": 2,
            "lod_types": ["Dense", "Dense", "Hash", "Hash"],
            "hashmap_size": 2 ** 16}}
        if "w4" in kind:
            # bf16-packed F=4: 2 levels carry the same 8 features
            enc_cfg = {"lotd_cfg": {
                "lod_res": [16, 64], "lod_n_feats": 4,
                "lod_types": ["Dense", "Hash"], "hashmap_size": 2 ** 16}}
        if use_brick or "w4" in kind:
            enc_cfg["backend"] = "brick"
        field_cfg = {"surface_cfg": {
            "encoding_cfg": enc_cfg,
            "decoder_cfg": {"D": 1, "W": 64}},
            "radiance_cfg": {"D": 2, "W": 64}}
        if "compressed" in kind:
            # the production StreetSurf training strategy (reference
            # neus_ray_query.py:732): occ-grid march + upsample, then
            # budget-compact BEFORE the expensive nablas/radiance query —
            # the fwd+bwd+2nd-order path touches compression_factor×S
            # samples instead of S + 3×n_importance.
            model = LoTDNeuSModel(
                field_cfg=field_cfg,
                accel_cfg={"resolution": 64, "max_steps_per_ray": 96,
                           "step_size": 2.0 / 96},
                ray_query_cfg={
                    "query_mode": "march_occ_multi_upsample_compressed",
                    "compression_factor": 0.25,
                    # safe HERE because the bench seeds 15% occupancy below
                    # (per-ray occupied count ≪ 0.5×S); the library default
                    # is 1.0 — budgeting truncates far-first when a ray's
                    # occupancy exceeds the budget
                    "march_budget_factor": 0.5})
        else:
            model = LoTDNeuSModel(field_cfg=field_cfg)
    model.populate()
    if "compressed" in kind:
        import jax.numpy as _jnp

        occ = jax.random.uniform(
            jax.random.key(5), model.accel.occ.val_grid[...].shape) < 0.15
        model.accel.occ.val_grid[...] = occ.astype(_jnp.float32)
    graphdef, params, rest = nn.split(model, nn.Param, ...)
    opt = optax.adam(5e-3)
    opt_state = opt.init(params)

    k1, k2 = jax.random.split(jax.random.key(0))
    o = jax.random.normal(k1, (n_rays, 3))
    o = o / jnp.linalg.norm(o, axis=-1, keepdims=True) * 2.0
    d = -o / 2.0 + jax.random.normal(k2, (n_rays, 3)) * 0.1
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    rgb_gt = jnp.abs(d)

    def step(params, opt_state, oo, dd, key):
        def loss_fn(p):
            m = nn.merge(graphdef, p, rest)
            rt = m.space.ray_test(oo, dd)
            if kind == "nerf":
                rendered, _ = nerf_ray_query_fixed(
                    m, m.space, rt, n_samples=n_samples, perturb_key=key)
                return jnp.mean((rendered["rgb_volume"] - rgb_gt) ** 2)
            if "compressed" in kind:
                rendered, vb = m.ray_query(rt, key=key)
            else:
                rendered, vb = neus_ray_query_coarse_multi_upsample(
                    m, m.space, rt, n_coarse=n_samples, perturb_key=key)
            loss = jnp.mean((rendered["rgb_volume"] - rgb_gt) ** 2)
            # eikonal on the queried nablas → 2nd-order backward
            if vb.get("nablas") is not None:
                nab, w = vb["nablas"], None
            elif vb.get("nablas_packed") is not None:
                nab = vb["nablas_packed"]
                w = (vb["ridx"] < rt["rays_o"].shape[0]).astype(nab.dtype)
            else:
                nab, w = rendered["normals_volume"], None
            err = (jnp.linalg.norm(nab, axis=-1) - 1.0) ** 2
            eik = (jnp.mean(err) if w is None
                   else jnp.sum(err * w) / jnp.maximum(jnp.sum(w), 1.0))
            return loss + 0.1 * eik

        loss, g = jax.value_and_grad(loss_fn)(params)
        updates, opt_state2 = opt.update(g, opt_state)
        return optax.apply_updates(params, updates), opt_state2, loss

    def chain(n):
        def chained(c, p, os_, oo, dd):
            def body(i, carry):
                cc, pp, ss = carry
                pp, ss, loss = step(pp, ss, oo * (1.0 + cc * 1e-30), dd,
                                    jax.random.key(0))
                return loss * 1e-30, pp, ss

            out = jax.lax.fori_loop(0, n, body, (c, p, os_))
            return out[0] + jax.tree.leaves(out[1])[0].ravel()[0] * 1e-30

        return jax.jit(chained)

    f_lo, f_hi = chain(1), chain(5)
    float(f_lo(0.0, params, opt_state, o, d))
    float(f_hi(0.0, params, opt_state, o, d))

    def t(f):
        t0 = time.perf_counter()
        float(f(0.0, params, opt_state, o, d))
        return time.perf_counter() - t0

    dt = (min(t(f_hi) for _ in range(3)) - min(t(f_lo) for _ in range(3))) / 4
    print(f"train step ({kind}, {'brick' if use_brick else 'xla'}): "
          f"{dt*1e3:.2f} ms / {n_rays} rays x {n_samples} -> "
          f"{n_rays/dt/1e3:.1f} Krays/s trained, {1.0/dt:.1f} steps/s",
          file=sys.stderr)
    return n_rays / dt


def main_forest(n_rays: int = 8192):
    """Forest (large-scale block-decomposed) render throughput: 64-block
    forest, brick-backend per-block LoTD, segmented occ marching +
    importance upsampling + budget compaction (reference
    fields_forest/neus/renderer_mixin.py:274)."""
    import jax

    from nr3d_lib_tpu.utils import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp
    from nr3d_lib_tpu import nn

    from nr3d_lib_tpu.models.fields_forest import LoTDForestNeuSModel

    m = LoTDForestNeuSModel(
        space_cfg={"resolution": (4, 4, 4), "origin": (-1.0, -1.0, -1.0),
                   "block_size": 0.5},
        field_cfg={"surface_cfg": {
            "lotd_cfg": {"lod_res": [8, 16, 32], "lod_n_feats": 2,
                         "lod_types": ["Dense", "Dense", "Hash"],
                         "hashmap_size": 2 ** 12, "backend": "brick"},
            "decoder_cfg": {"D": 1, "W": 64}},
            "radiance_cfg": {"D": 2, "W": 64}},
        n_march_steps=128, march_mode="segments",
        max_segments=8, steps_per_segment=16)
    m.populate()
    graphdef, state = nn.split(m)

    k1, k2 = jax.random.split(jax.random.key(0))
    o = jax.random.normal(k1, (n_rays, 3))
    o = o / jnp.linalg.norm(o, axis=-1, keepdims=True) * 2.5
    d = -o / 2.5 + jax.random.normal(k2, (n_rays, 3)) * 0.1
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)

    def render(st, oo, dd):
        mm = nn.merge(graphdef, st)
        r, _ = mm.ray_query(mm.ray_test(oo, dd))
        return r["rgb_volume"]

    def chain(n):
        def chained(c, st, oo, dd):
            def body(i, carry):
                cc, acc = carry
                y = render(st, oo * (1.0 + cc * 1e-30), dd)
                s = jnp.sum(y.astype(jnp.float32))
                return s * 1e-30, acc + s

            return jax.lax.fori_loop(0, n, body, (c, 0.0))[1]

        return jax.jit(chained)

    f_lo, f_hi = chain(1), chain(5)
    float(f_lo(0.0, state, o, d))
    float(f_hi(0.0, state, o, d))

    def t(f):
        t0 = time.perf_counter()
        float(f(0.0, state, o, d))
        return time.perf_counter() - t0

    dt = (min(t(f_hi) for _ in range(3)) - min(t(f_lo) for _ in range(3))) / 4
    print(f"render fwd (forest 64 blocks, segments): "
          f"{dt*1e3:.2f} ms / {n_rays} rays -> {n_rays/dt/1e3:.1f} Krays/s",
          file=sys.stderr)
    return n_rays / dt


def main_train_gaussian(n_gauss: int = 500_000, hw=(512, 512)):
    """3DGS training-step time (fwd+bwd+adam on all gaussian params)
    through the tiled rasterizer — reference r3dg rasterize_gaussians_backward
    (cuda_rasterizer/backward.cu). Returns ms/step."""
    import jax

    from nr3d_lib_tpu.utils import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp
    import optax

    from nr3d_lib_tpu.graphics import gaussian_splatting as GS

    kg = jax.random.split(jax.random.key(21), 5)
    params = {
        "means": jax.random.uniform(kg[0], (n_gauss, 3), jnp.float32,
                                    -1.0, 1.0),
        "scales": jax.random.uniform(kg[1], (n_gauss, 3), jnp.float32,
                                     0.002, 0.02),
        "quats": jax.random.normal(kg[2], (n_gauss, 4), jnp.float32),
        "opac": jax.random.uniform(kg[3], (n_gauss, 1), jnp.float32,
                                   0.3, 0.9),
        "cols": jax.random.uniform(kg[4], (n_gauss, 3), jnp.float32),
    }
    w2c = jnp.eye(4).at[2, 3].set(3.0)
    intr = jnp.asarray([[500.0, 0, 256], [0, 500.0, 256], [0, 0, 1]])
    gt = jax.random.uniform(jax.random.key(3), (hw[0], hw[1], 3))
    opt = optax.adam(1e-3)
    opt_state = opt.init(params)

    def step(p, os_, gt_):
        def loss_fn(pp):
            out = GS.rasterize_gaussians_tiled(
                pp["means"], pp["scales"],
                pp["quats"] / jnp.linalg.norm(pp["quats"], axis=-1,
                                              keepdims=True),
                pp["opac"], pp["cols"], w2c, intr, hw,
                blend_backend="pallas")
            return jnp.mean((out["rgb"] - gt_) ** 2)

        loss, g = jax.value_and_grad(loss_fn)(p)
        upd, os2 = opt.update(g, os_)
        return optax.apply_updates(p, upd), os2, loss

    def chain(n):
        def chained(c, p, os_, gt_):
            def body(i, carry):
                cc, pp, ss = carry
                pp, ss, loss = step(pp, ss, gt_ * (1.0 + cc * 1e-30))
                return loss * 1e-30, pp, ss

            out = jax.lax.fori_loop(0, n, body, (c, p, os_))
            return out[0] + jax.tree.leaves(out[1])[0].ravel()[0] * 1e-30

        return jax.jit(chained)

    f_lo, f_hi = chain(1), chain(3)
    float(f_lo(0.0, params, opt_state, gt))
    float(f_hi(0.0, params, opt_state, gt))

    def t(f):
        t0 = time.perf_counter()
        float(f(0.0, params, opt_state, gt))
        return time.perf_counter() - t0

    dt = (min(t(f_hi) for _ in range(3)) - min(t(f_lo) for _ in range(3))) / 2
    print(f"3DGS train step ({n_gauss} gaussians @ {hw[0]}x{hw[1]}): "
          f"{dt*1e3:.1f} ms/step", file=sys.stderr)
    return dt * 1e3


if __name__ == "__main__":
    mode = "march_occ"
    if "--mode" in sys.argv:
        mode = sys.argv[sys.argv.index("--mode") + 1]
    if "--compressed" in sys.argv:
        mode = "march_occ_compressed"
    if "--train" in sys.argv:
        kind = "nerf"
        if "--neus_w4" in sys.argv:
            kind = "neus_w4"
        elif "--neus" in sys.argv:
            kind = "neus"
        main_train(use_brick="--brick" in sys.argv, kind=kind)
    else:
        main(use_brick="--brick" in sys.argv, mode=mode,
             w4="--w4" in sys.argv)
