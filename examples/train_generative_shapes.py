"""Example: generative/categorical shapes — one conditioned NeuS, N objects.

The reference's conditional family (fields_conditional/) trains ONE
latent-conditioned field over a category of objects (DeepSDF/autodecoder
style: per-instance latent codes + a shared generative-permuto NeuS). This
example fits 4 analytic ellipsoids with a single
`GenerativePermutoNeuSModelBatched`, then renders each instance and a
latent-space interpolation between two of them:

    python examples/train_generative_shapes.py --iters 600 --out /tmp/gen_run

Works on CPU (add --cpu) or one GPU (one process per card).
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

# the "category": per-instance ellipsoid half-axes
AXES = np.asarray([[0.45, 0.45, 0.45],
                   [0.55, 0.30, 0.30],
                   [0.30, 0.55, 0.30],
                   [0.35, 0.35, 0.60]], np.float32)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=600)
    ap.add_argument("--rays", type=int, default=2048)
    ap.add_argument("--out", type=str, default="/tmp/gen_run")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--hw", type=int, default=80, help="eval frame size")
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
    from nr3d_lib_tpu.graphics.cameras import (look_at, pinhole_get_rays,
                                               pixel_grid)
    from nr3d_lib_tpu.graphics.metrics import psnr
    from nr3d_lib_tpu.logger import Logger
    from nr3d_lib_tpu.models.model_families import (
        GenerativePermutoNeuSModelBatched)
    from nr3d_lib_tpu.utils import save_image

    axes = jnp.asarray(AXES)
    n_inst = len(AXES)

    # --------------------------------------------------- analytic GT scene
    def sdf_gt(p, bidx):
        # ellipsoid approx-SDF: (|p/a| - 1) * min(a)  (bound, good enough
        # for shading/eval; exact for spheres)
        a = axes[bidx]
        k = jnp.linalg.norm(p / a, axis=-1)
        return (k - 1.0) * jnp.min(a, axis=-1)

    def trace_gt(o, d, bidx, n_steps: int = 64):
        t = jnp.full(o.shape[:1], 1.0)
        for _ in range(n_steps):
            t = t + sdf_gt(o + t[:, None] * d, bidx)
        t = jnp.clip(t, 0.0, 4.0)
        p = o + t[:, None] * d
        hit = jnp.abs(sdf_gt(p, bidx)) < 1e-3
        n = p / (axes[bidx] ** 2)
        n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-9)
        return jnp.where(hit[:, None], n * 0.5 + 0.5, 0.0)

    def sample_rays(n, key):
        k1, k2, k3 = jax.random.split(key, 3)
        o = jax.random.normal(k1, (n, 3))
        o = o / jnp.linalg.norm(o, axis=-1, keepdims=True) * 2.0
        tgt = jax.random.uniform(k2, (n, 3), minval=-0.2, maxval=0.2)
        d = tgt - o
        d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
        bidx = jax.random.randint(k3, (n,), 0, n_inst)
        return o, d, bidx

    # -------------------------------------------------------------- model
    model = GenerativePermutoNeuSModelBatched(
        n_instances=n_inst, latent_dim=4, latent_std=0.1,
        field_cfg={"surface_cfg": {
            "permuto_cfg": {"res_list": [8.0, 16.0, 32.0, 64.0],
                            "n_feats": 2, "log2_hashmap_size": 15},
            "decoder_cfg": {"D": 1, "W": 64}},
            "radiance_cfg": {"D": 2, "W": 64},
            "var_ctrl_cfg": {"type": "learned", "init_val": 64.0}},
        ray_query_cfg={"n_coarse": 32, "upsample_inv_s_factors": [1.0, 4.0],
                       "n_importance": 8})
    graphdef, params, rest = nn.split(model, nn.Param, ...)
    # grad clipping: NeuS spikes as inv_s sharpens (reference clips too)
    opt = optax.chain(optax.clip_by_global_norm(5.0), optax.adam(3e-3))
    opt_state = opt.init(params)
    logger = Logger(args.out, use_tensorboard=False)
    ckpt = CheckpointIO(os.path.join(args.out, "ckpts"))
    ckpt.register_modules(model=model)

    @jax.jit
    def train_step(params, rest, opt_state, o, d, bidx, rgb_gt, key):
        def loss_fn(p):
            m = nn.merge(graphdef, p, rest)
            rt = m.ray_test(o, d)
            rt["bidx"] = bidx
            rendered, vb = m.ray_query(rt, key=key)
            rgb_l = jnp.mean((rendered["rgb_volume"] - rgb_gt) ** 2)
            nab = vb.get("nablas_packed", vb.get("nablas"))
            eik = jnp.mean((jnp.linalg.norm(nab, axis=-1) - 1.0) ** 2)
            # latent prior (autodecoder regularizer, DeepSDF-style)
            z = m.autodecoder.get_latent(jnp.arange(n_inst))
            return rgb_l + 0.03 * eik + 1e-4 * jnp.mean(z ** 2), rgb_l

        (loss, rgb_l), g = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state2 = opt.update(g, opt_state)
        return optax.apply_updates(params, updates), opt_state2, loss, rgb_l

    key = jax.random.key(0)
    t0 = time.time()
    # lifecycle gated on the occ-update interval: per-step
    # merge/split is pure-python graph traversal (see train_neus_object.py)
    # derived from the model, not hardcoded; every-step when any
    # schedule (anneal / scheduled inv_s) would be coarsened by gating
    lifecycle_every = 1 if model.has_stepwise_schedules() \
        else model.lifecycle_update_every
    for it in range(args.iters):
        key, k1, k2 = jax.random.split(key, 3)
        if it % lifecycle_every == 0:
            m2 = nn.merge(graphdef, params, rest)
            m2.training_before_per_step(it)
            _, _, rest = nn.split(m2, nn.Param, ...)
        o, d, bidx = sample_rays(args.rays, k1)
        params, opt_state, loss, rgb_l = train_step(
            params, rest, opt_state, o, d, bidx, trace_gt(o, d, bidx), k2)
        if it % 100 == 0 or it == args.iters - 1:
            logger.add("train", "loss", loss, it)
            print(f"it {it:5d}  loss {float(loss):.5f}  rgb {float(rgb_l):.5f}")
    print(f"trained {args.iters} iters in {time.time() - t0:.1f}s")

    # -------------------------------------------- eval + latent interpolation
    nn.update(model, params)
    o, d, bidx = sample_rays(2048, jax.random.key(123))
    rt = model.ray_test(o, d)
    rt["bidx"] = bidx
    rendered, _ = model.ray_query(rt)
    val_psnr = float(psnr(rendered["rgb_volume"], trace_gt(o, d, bidx)))
    print(f"val PSNR (random rays/instances): {val_psnr:.2f} dB")
    logger.add("val", "psnr", val_psnr, args.iters)
    ckpt.save("ckpt_final.npz", it=args.iters, psnr=val_psnr)

    h = w = args.hw
    intr = jnp.asarray([[w * 0.9, 0, w / 2], [0, w * 0.9, h / 2], [0, 0, 1]])
    c2w = look_at(eye=(1.3, 1.1, 1.3), target=(0.0, 0.0, 0.0))
    uv = pixel_grid(h, w).reshape(-1, 2)
    o_img, d_img = pinhole_get_rays(uv, intr, c2w)

    def render_frame(m, inst):
        rt = m.ray_test(o_img, d_img)
        rt["bidx"] = jnp.full((h * w,), inst, jnp.int32)
        rendered, _ = m.ray_query(rt)
        return np.asarray(rendered["rgb_volume"]).reshape(h, w, 3)

    for i in range(n_inst):
        save_image(os.path.join(args.out, f"instance_{i}.png"),
                   render_frame(model, i))
        gt = np.asarray(trace_gt(o_img, d_img,
                                 jnp.full((h * w,), i))).reshape(h, w, 3)
        save_image(os.path.join(args.out, f"gt_{i}.png"), gt)

    # interpolate latents 0→1 by writing blends into a scratch copy's table
    z_all = np.asarray(model.autodecoder.latents.weight[...])
    for j, alpha in enumerate((0.25, 0.5, 0.75)):
        z_blend = (1 - alpha) * z_all[0] + alpha * z_all[1]
        model.autodecoder.latents.weight[...] = jnp.asarray(
            z_all).at[0].set(z_blend)
        save_image(os.path.join(args.out, f"interp_{j}_a{alpha:.2f}.png"),
                   render_frame(model, 0))
    model.autodecoder.latents.weight[...] = jnp.asarray(z_all)  # restore
    print(f"wrote checkpoint, per-instance + interpolation frames to "
          f"{args.out}")
    logger.close()


if __name__ == "__main__":
    main()
