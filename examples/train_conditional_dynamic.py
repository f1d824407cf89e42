"""Example: conditional + dynamic — N pulsating shapes, one model.

The reference's fields_conditional_dynamic family conditions one NeuS on
BOTH an instance latent and time (DynamicGenerativePermutoConcatNeuS +
NeusRendererMixinBatchedDynamic). This example fits 3 ellipsoids whose
half-axes pulse over time — each with its own phase — with a single
`DynamicGenerativeNeuSModel`, then renders an (instance × time) frame
grid:

    python examples/train_conditional_dynamic.py --iters 600 --out /tmp/cd_run

Works on CPU (add --cpu) or one GPU (one process per card).
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

AXES = np.asarray([[0.45, 0.35, 0.35],
                   [0.30, 0.50, 0.30],
                   [0.38, 0.38, 0.38]], np.float32)
PHASES = np.asarray([0.0, 2.1, 4.2], np.float32)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=600)
    ap.add_argument("--rays", type=int, default=2048)
    ap.add_argument("--out", type=str, default="/tmp/cd_run")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--hw", type=int, default=64, help="eval frame size")
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
    from nr3d_lib_tpu.models.model_families import DynamicGenerativeNeuSModel
    from nr3d_lib_tpu.plot import gallery
    from nr3d_lib_tpu.utils import save_image

    axes0 = jnp.asarray(AXES)
    phases = jnp.asarray(PHASES)
    n_inst = len(AXES)

    def axes_t(bidx, ts):
        pulse = 1.0 + 0.25 * jnp.sin(np.pi * ts + phases[bidx])
        return axes0[bidx] * pulse[:, None]

    def sdf_gt(p, bidx, ts):
        a = axes_t(bidx, ts)
        return (jnp.linalg.norm(p / a, axis=-1) - 1.0) * jnp.min(a, axis=-1)

    def trace_gt(o, d, bidx, ts, n_steps: int = 64):
        t = jnp.full(o.shape[:1], 1.0)
        for _ in range(n_steps):
            t = t + sdf_gt(o + t[:, None] * d, bidx, ts)
        t = jnp.clip(t, 0.0, 4.0)
        p = o + t[:, None] * d
        hit = jnp.abs(sdf_gt(p, bidx, ts)) < 1e-3
        n = p / (axes_t(bidx, ts) ** 2)
        n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-9)
        return jnp.where(hit[:, None], n * 0.5 + 0.5, 0.0)

    def sample_rays(n, key):
        k1, k2, k3, k4 = jax.random.split(key, 4)
        o = jax.random.normal(k1, (n, 3))
        o = o / jnp.linalg.norm(o, axis=-1, keepdims=True) * 2.0
        tgt = jax.random.uniform(k2, (n, 3), minval=-0.2, maxval=0.2)
        d = tgt - o
        d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
        bidx = jax.random.randint(k3, (n,), 0, n_inst)
        ts = jax.random.uniform(k4, (n,), minval=-1.0, maxval=1.0)
        return o, d, bidx, ts

    model = DynamicGenerativeNeuSModel(
        n_instances=n_inst, latent_dim=4, latent_std=0.1,
        field_cfg={"surface_cfg": {
            "permuto_cfg": {"res_list": [8.0, 16.0, 32.0], "n_feats": 2,
                            "log2_hashmap_size": 15},
            "decoder_cfg": {"D": 1, "W": 64}},
            "radiance_cfg": {"D": 2, "W": 64},
            "var_ctrl_cfg": {"type": "learned", "init_val": 64.0}},
        ray_query_cfg={"n_coarse": 32, "upsample_inv_s_factors": [1.0, 4.0],
                       "n_importance": 8})
    graphdef, params, rest = nn.split(model, nn.Param, ...)
    opt = optax.chain(optax.clip_by_global_norm(5.0), optax.adam(3e-3))
    opt_state = opt.init(params)
    logger = Logger(args.out, use_tensorboard=False)
    ckpt = CheckpointIO(os.path.join(args.out, "ckpts"))
    ckpt.register_modules(model=model)

    @jax.jit
    def train_step(params, rest, opt_state, o, d, bidx, ts, rgb_gt, key):
        def loss_fn(p):
            m = nn.merge(graphdef, p, rest)
            rt = m.ray_test(o, d)
            rt["bidx"] = bidx
            rt["ts"] = ts
            rendered, vb = m.ray_query(rt, key=key)
            rgb_l = jnp.mean((rendered["rgb_volume"] - rgb_gt) ** 2)
            eik = jnp.mean((jnp.linalg.norm(vb["nablas"], axis=-1) - 1.0) ** 2)
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
        o, d, bidx, ts = sample_rays(args.rays, k1)
        params, opt_state, loss, rgb_l = train_step(
            params, rest, opt_state, o, d, bidx, ts,
            trace_gt(o, d, bidx, ts), k2)
        if it % 100 == 0 or it == args.iters - 1:
            logger.add("train", "loss", loss, it)
            print(f"it {it:5d}  loss {float(loss):.5f}  rgb {float(rgb_l):.5f}")
    print(f"trained {args.iters} iters in {time.time() - t0:.1f}s")

    nn.update(model, params, rest)
    o, d, bidx, ts = sample_rays(2048, jax.random.key(123))
    rt = model.ray_test(o, d)
    rt["bidx"] = bidx
    rt["ts"] = ts
    rendered, _ = model.ray_query(rt)
    val_psnr = float(psnr(rendered["rgb_volume"], trace_gt(o, d, bidx, ts)))
    print(f"val PSNR (random rays/instances/times): {val_psnr:.2f} dB")
    logger.add("val", "psnr", val_psnr, args.iters)
    ckpt.save("ckpt_final.npz", it=args.iters, psnr=val_psnr)

    # (instance × time) frame grid — both conditions scrubbed at once
    h = w = args.hw
    intr = jnp.asarray([[w * 0.9, 0, w / 2], [0, w * 0.9, h / 2], [0, 0, 1]])
    c2w = look_at(eye=(1.3, 1.1, 1.3), target=(0.0, 0.0, 0.0))
    uv = pixel_grid(h, w).reshape(-1, 2)
    o_img, d_img = pinhole_get_rays(uv, intr, c2w)
    frames = []
    for i in range(n_inst):
        for t_val in (-0.5, 0.0, 0.5):
            rt = model.ray_test(o_img, d_img)
            rt["bidx"] = jnp.full((h * w,), i, jnp.int32)
            rt["ts"] = jnp.full((h * w,), t_val)
            rendered, _ = model.ray_query(rt)
            frames.append(np.asarray(
                rendered["rgb_volume"]).reshape(h, w, 3))
    save_image(os.path.join(args.out, "instance_time_grid.png"),
               gallery(np.stack(frames), ncols=3))
    print(f"wrote checkpoint + instance x time grid to {args.out}")
    logger.close()


if __name__ == "__main__":
    main()
