"""Example: NeuS surface reconstruction of an analytic object, end to end.

The reference library's flagship downstream workflow (neuralsim / StreetSurf
object recon) is: NeuS training with an eikonal loss through the encoding's
second-order backward → occupancy-accelerated ray query → mesh extraction. This
example runs that whole pipeline self-contained — the "dataset" is an
analytic SDF (sphere ∪ rounded box) ray-traced on the fly:

    python examples/train_neus_object.py --iters 800 --out /tmp/neus_run

Works on CPU (add --cpu) or one GPU (one process per card). Outputs: checkpoint, extracted
OBJ mesh, vertex PLY, chamfer-to-ground-truth, turntable PNGs.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=800)
    ap.add_argument("--rays", type=int, default=2048)
    ap.add_argument("--out", type=str, default="/tmp/neus_run")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--brick", action="store_true",
                    help="use the brick-layout encoding backend")
    ap.add_argument("--w4", action="store_true",
                    help="bf16-packed F=4 levels (implies --brick)")
    ap.add_argument("--mesh_res", type=int, default=128)
    ap.add_argument("--eikonal", type=float, default=0.03)
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from nr3d_lib_tpu.utils import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp
    import optax
    from nr3d_lib_tpu import nn

    from nr3d_lib_tpu.checkpoint import CheckpointIO
    from nr3d_lib_tpu.graphics.metrics import psnr
    from nr3d_lib_tpu.graphics.pointcloud import save_ply
    from nr3d_lib_tpu.graphics.trianglemesh import extract_mesh
    from nr3d_lib_tpu.gui import render_turntable
    from nr3d_lib_tpu.logger import Logger
    from nr3d_lib_tpu.maths.knn import chamfer_distance
    from nr3d_lib_tpu.models.fields.sdf import pretrain_sdf_sphere
    from nr3d_lib_tpu.models.model_base import LoTDNeuSModel

    # ------------------------------------------------------ analytic scene
    def sdf_gt(p):
        # sphere ∪ rounded box, both inside the unit cube
        d_sph = jnp.linalg.norm(p - jnp.asarray([0.22, 0.0, 0.0]), axis=-1) - 0.34
        q = jnp.abs(p - jnp.asarray([-0.22, 0.0, 0.0])) - 0.26
        d_box = (jnp.linalg.norm(jnp.maximum(q, 0.0), axis=-1)
                 + jnp.minimum(jnp.max(q, axis=-1), 0.0) - 0.04)
        return jnp.minimum(d_sph, d_box)

    normal_gt = jax.vmap(jax.grad(lambda p: sdf_gt(p[None])[0]))

    def trace_gt(o, d, n_steps: int = 96):
        """Sphere-trace the analytic SDF → normal-colored GT image."""
        t = jnp.full(o.shape[:1], 1.0)
        for _ in range(n_steps):
            t = t + sdf_gt(o + t[:, None] * d)
        t = jnp.clip(t, 0.0, 4.0)
        p = o + t[:, None] * d
        hit = jnp.abs(sdf_gt(p)) < 1e-3
        n = normal_gt(p)
        n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-9)
        return jnp.where(hit[:, None], n * 0.5 + 0.5, 0.0)

    def sample_rays(n, key):
        k1, k2 = jax.random.split(key)
        o = jax.random.normal(k1, (n, 3))
        o = o / jnp.linalg.norm(o, axis=-1, keepdims=True) * 2.0
        tgt = jax.random.uniform(k2, (n, 3), minval=-0.25, maxval=0.25)
        d = tgt - o
        return o, d / jnp.linalg.norm(d, axis=-1, keepdims=True)

    # ------------------------------------------------------------- model
    enc_cfg = {"lotd_cfg": {"lod_res": [16, 32, 64, 128], "lod_n_feats": 2,
                            "lod_types": ["Dense", "Dense", "Hash", "Hash"],
                            "hashmap_size": 2 ** 16}}
    if args.w4:
        enc_cfg = {"lotd_cfg": {"lod_res": [16, 64], "lod_n_feats": 4,
                                "lod_types": ["Dense", "Hash"],
                                "hashmap_size": 2 ** 16},
                   "backend": "brick"}
    elif args.brick:
        enc_cfg["backend"] = "brick"
    model = LoTDNeuSModel(
        field_cfg={"surface_cfg": {"encoding_cfg": enc_cfg,
                                   "decoder_cfg": {"D": 1, "W": 64}},
                   "radiance_cfg": {"D": 2, "W": 64},
                   "var_ctrl_cfg": {"type": "learned", "init_val": 64.0}},
        accel_cfg={"resolution": 32, "max_steps_per_ray": 96,
                   "step_size": 2 / 48},
        ray_query_cfg={"query_mode": "march_occ_multi_upsample",
                       "upsample_inv_s_factors": [1.0, 4.0],
                       "n_importance": 12})
    # geometric init: fit a sphere before scene training (reference
    # fields/sdf/utils.py pretrain) — NeuS converges far faster from it
    pre = pretrain_sdf_sphere(model.field.implicit_surface, jax.random.key(0),
                              radius=0.5, n_iters=300)
    print(f"sphere pretrain loss: {pre:.2e}")
    model.populate()
    graphdef, params, rest = nn.split(model, nn.Param, ...)
    # clip like the reference's trainers do (training_clip_grad): as inv_s
    # sharpens, occasional eikonal spikes otherwise blow the step
    opt = optax.chain(optax.clip_by_global_norm(5.0), optax.adam(3e-3))
    opt_state = opt.init(params)
    logger = Logger(args.out, use_tensorboard=False)
    ckpt = CheckpointIO(os.path.join(args.out, "ckpts"))
    ckpt.register_modules(model=model)

    @jax.jit
    def train_step(params, rest, opt_state, o, d, rgb_gt, key):
        def loss_fn(p):
            m = nn.merge(graphdef, p, rest)
            rendered, vb = m.ray_query(m.ray_test(o, d), key=key)
            nab = vb.get("nablas_packed", vb.get("nablas"))
            eik = jnp.mean((jnp.linalg.norm(nab, axis=-1) - 1.0) ** 2)
            rgb_l = jnp.mean((rendered["rgb_volume"] - rgb_gt) ** 2)
            return rgb_l + args.eikonal * eik, rgb_l

        (loss, rgb_l), g = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state2 = opt.update(g, opt_state)
        return optax.apply_updates(params, updates), opt_state2, loss, rgb_l

    key = jax.random.key(0)
    t0 = time.time()
    # derived from the model, not hardcoded; every-step when any schedule
    # (anneal / scheduled inv_s) would be coarsened by gating
    lifecycle_every = 1 if model.has_stepwise_schedules() \
        else model.lifecycle_update_every
    for it in range(args.iters):
        key, k1, k2 = jax.random.split(key, 3)
        # occupancy EMA update from the live SDF (training lifecycle).
        # Gated on the accel's own update interval: the merge/split round
        # trip is pure-python graph traversal, and accel.step is a no-op off-interval anyway; the anneal /
        # variance iters advance in steps of `lifecycle_every`, which is
        # ≪ their schedules' spans.
        if it % lifecycle_every == 0:
            m2 = nn.merge(graphdef, params, rest)
            m2.training_before_per_step(it, jax.random.key(7000 + it))
            _, _, rest = nn.split(m2, nn.Param, ...)
        o, d = sample_rays(args.rays, k1)
        params, opt_state, loss, rgb_l = train_step(
            params, rest, opt_state, o, d, trace_gt(o, d), k2)
        if it % 100 == 0 or it == args.iters - 1:
            logger.add("train", "loss", loss, it)
            print(f"it {it:5d}  loss {float(loss):.5f}  rgb {float(rgb_l):.5f}")
    print(f"trained {args.iters} iters in {time.time() - t0:.1f}s")

    # -------------------------------------------------------- evaluation
    # restore BOTH trained params and the non-Param state (the occupancy
    # grid evolved inside the merged training copies via `rest`)
    nn.update(model, params, rest)
    o, d = sample_rays(2048, jax.random.key(123))
    rendered, _ = model.ray_query(model.ray_test(o, d))
    val_psnr = float(psnr(rendered["rgb_volume"], trace_gt(o, d)))
    print(f"val PSNR: {val_psnr:.2f} dB")
    logger.add("val", "psnr", val_psnr, args.iters)
    ckpt.save("ckpt_final.npz", it=args.iters, psnr=val_psnr)

    # mesh extraction (marching cubes over the learned SDF) + chamfer
    def query_sdf(x):
        return model.forward_sdf(jnp.asarray(x))["sdf"]

    verts, faces = extract_mesh(
        query_sdf, resolution=args.mesh_res,
        filepath=os.path.join(args.out, "mesh.obj"))
    print(f"mesh: {len(verts)} verts / {len(faces)} faces → mesh.obj")
    if len(verts):
        # ground-truth surface samples from traced hits
        og, dg = sample_rays(4096, jax.random.key(77))
        tg = jnp.full((4096,), 1.0)
        for _ in range(96):
            tg = tg + sdf_gt(og + tg[:, None] * dg)
        pg = og + jnp.clip(tg, 0, 4)[:, None] * dg
        pg = pg[np.asarray(jnp.abs(sdf_gt(pg)) < 1e-3)]
        vsub = verts[np.random.default_rng(0).permutation(len(verts))[:4096]]
        c_xy, c_yx = chamfer_distance(jnp.asarray(vsub, jnp.float32),
                                      jnp.asarray(pg, jnp.float32),
                                      squared=False)
        cham = float(c_xy + c_yx) / 2
        print(f"chamfer(mesh verts, GT surface): {cham:.3e}")
        logger.add("val", "chamfer", cham, args.iters)
        save_ply(os.path.join(args.out, "verts.ply"), np.asarray(vsub),
                 colors=np.clip(np.asarray(vsub) * 0.5 + 0.5, 0, 1))

    frames = render_turntable(model, n_frames=8, radius=2.5, hw=(128, 128),
                              out_dir=os.path.join(args.out, "turntable"))
    print(f"wrote checkpoint, mesh + {len(frames)} turntable frames to "
          f"{args.out}")
    logger.close()


if __name__ == "__main__":
    main()
