"""Example: EmerNeRF-style dynamic scene — static/dynamic decomposition.

The reference's dynamic family (fields_dynamic/nerf/emernerf.py) decomposes
a time-varying scene into a static branch, a dynamic branch, and a scene
flow field. This example trains `EmerNeRFModel` on an analytic scene — a
static checkerboard floor plus a sphere oscillating along x — and renders
the learned decomposition (full / static-only / dynamic-only frames):

    python examples/train_dynamic_scene.py --iters 600 --out /tmp/dyn_run

Works on CPU (add --cpu) or one GPU (one process per card).
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=600)
    ap.add_argument("--rays", type=int, default=2048)
    ap.add_argument("--out", type=str, default="/tmp/dyn_run")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--hw", type=int, default=96, help="eval frame size")
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
    from nr3d_lib_tpu.models.model_families import EmerNeRFModel
    from nr3d_lib_tpu.utils import save_image

    # --------------------------------------------------- analytic GT scene
    # static: checkerboard floor at y=-0.4; dynamic: sphere sliding along x
    def sphere_center(ts):
        return jnp.stack([0.45 * jnp.sin(np.pi * ts),
                          jnp.zeros_like(ts), jnp.zeros_like(ts)], -1)

    def trace_gt(o, d, ts):
        c = sphere_center(ts)
        oc = o - c
        b = jnp.sum(oc * d, -1)
        disc = b * b - (jnp.sum(oc * oc, -1) - 0.3 ** 2)
        t_sph = jnp.where(disc > 0, -b - jnp.sqrt(jnp.maximum(disc, 0.0)),
                          jnp.inf)
        t_sph = jnp.where(t_sph > 1e-3, t_sph, jnp.inf)
        p_sph = o + t_sph[:, None] * d
        n = p_sph - c
        n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-9)
        rgb_sph = jnp.clip(n * 0.5 + 0.5, 0, 1) * jnp.asarray([1.0, 0.7, 0.5])

        t_pl = (-0.4 - o[:, 1]) / jnp.where(jnp.abs(d[:, 1]) < 1e-6, 1e-6,
                                            d[:, 1])
        p_pl = o + t_pl[:, None] * d
        on_pl = ((t_pl > 1e-3) & (jnp.abs(p_pl[:, 0]) < 0.9)
                 & (jnp.abs(p_pl[:, 2]) < 0.9))
        t_pl = jnp.where(on_pl, t_pl, jnp.inf)
        check = (jnp.floor(p_pl[:, 0] * 5) + jnp.floor(p_pl[:, 2] * 5)) % 2
        rgb_pl = jnp.where(check[:, None] > 0.5,
                           jnp.asarray([0.8, 0.8, 0.85]),
                           jnp.asarray([0.25, 0.3, 0.35]))

        rgb = jnp.zeros_like(o)
        rgb = jnp.where((t_pl < t_sph)[:, None], rgb_pl, rgb)
        rgb = jnp.where((t_sph <= t_pl)[:, None] & jnp.isfinite(t_sph)[:, None],
                        rgb_sph, rgb)
        return rgb

    def sample_rays(n, key):
        k1, k2, k3 = jax.random.split(key, 3)
        o = jax.random.normal(k1, (n, 3))
        o = o.at[:, 1].set(jnp.abs(o[:, 1]) * 0.5 + 0.2)  # stay above floor
        o = o / jnp.linalg.norm(o, axis=-1, keepdims=True) * 2.0
        tgt = jax.random.uniform(k2, (n, 3), minval=-0.3, maxval=0.3)
        d = tgt - o
        d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
        ts = jax.random.uniform(k3, (n,), minval=-1.0, maxval=1.0)
        return o, d, ts

    # -------------------------------------------------------------- model
    model = EmerNeRFModel(
        field_cfg={"static_cfg": {"lotd_cfg": {
            "lod_res": [16, 32, 64], "lod_n_feats": 2,
            "lod_types": ["Dense", "Dense", "Hash"],
            "hashmap_size": 2 ** 15}},
            "dynamic_permuto_cfg": {"res_list": [8.0, 16.0, 32.0],
                                    "n_feats": 2,
                                    "log2_hashmap_size": 15}},
        accel_cfg={"resolution": (16, 16, 16)}, n_time_keys=8,
        n_march_steps=64)
    model.populate()
    graphdef, params, rest = nn.split(model, nn.Param, ...)
    opt = optax.adam(4e-3)
    opt_state = opt.init(params)
    logger = Logger(args.out, use_tensorboard=False)
    ckpt = CheckpointIO(os.path.join(args.out, "ckpts"))
    ckpt.register_modules(model=model)

    @jax.jit
    def train_step(params, rest, opt_state, o, d, ts, rgb_gt, key):
        def loss_fn(p):
            m = nn.merge(graphdef, p, rest)
            rt = m.ray_test(o, d)
            rt["ts"] = ts
            rendered, vb = m.ray_query(rt, key=key)
            rgb_l = jnp.mean((rendered["rgb_volume"] - rgb_gt) ** 2)
            # the reference's per-step regularizers, from the volume buffer
            reg = (1e-3 * vb["reg_dynamic_sparsity"]
                   + 1e-4 * vb.get("reg_flow_smooth", 0.0)
                   + 1e-4 * vb.get("reg_flow_cycle", 0.0)
                   + 1e-4 * vb.get("reg_shadow", 0.0))
            return rgb_l + reg, rgb_l

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
            m2.training_before_per_step(it, jax.random.key(5000 + it))
            _, _, rest = nn.split(m2, nn.Param, ...)
        o, d, ts = sample_rays(args.rays, k1)
        params, opt_state, loss, rgb_l = train_step(
            params, rest, opt_state, o, d, ts, trace_gt(o, d, ts), k2)
        if it % 100 == 0 or it == args.iters - 1:
            logger.add("train", "loss", loss, it)
            print(f"it {it:5d}  loss {float(loss):.5f}  rgb {float(rgb_l):.5f}")
    print(f"trained {args.iters} iters in {time.time() - t0:.1f}s")

    # ------------------------------------------------- eval + decomposition
    # restore trained params AND the occ-grid state evolved in `rest`
    nn.update(model, params, rest)
    o, d, ts = sample_rays(2048, jax.random.key(123))
    rt = model.ray_test(o, d)
    rt["ts"] = ts
    rendered, _ = model.ray_query(rt)
    val_psnr = float(psnr(rendered["rgb_volume"], trace_gt(o, d, ts)))
    print(f"val PSNR (random rays/times): {val_psnr:.2f} dB")
    logger.add("val", "psnr", val_psnr, args.iters)
    ckpt.save("ckpt_final.npz", it=args.iters, psnr=val_psnr)

    # render full / static / dynamic frames at two times
    h = w = args.hw
    intr = jnp.asarray([[w * 0.9, 0, w / 2], [0, w * 0.9, h / 2], [0, 0, 1]])
    c2w = look_at(eye=(1.4, 1.0, 1.4), target=(0.0, -0.1, 0.0))
    uv = pixel_grid(h, w).reshape(-1, 2)
    o_img, d_img = pinhole_get_rays(uv, intr, c2w)
    for t_val in (-0.5, 0.5):
        rt = model.ray_test(o_img, d_img)
        rt["ts"] = jnp.full((h * w,), t_val)
        rendered, _ = model.ray_query(rt)
        for k in ("rgb_volume", "rgb_static_volume", "rgb_dynamic_volume"):
            img = np.asarray(rendered[k]).reshape(h, w, 3)
            save_image(os.path.join(
                args.out, f"{k.replace('_volume', '')}_t{t_val:+.1f}.png"),
                img)
        gt = np.asarray(trace_gt(o_img, d_img,
                                 jnp.full((h * w,), t_val))).reshape(h, w, 3)
        save_image(os.path.join(args.out, f"gt_t{t_val:+.1f}.png"), gt)
    print(f"wrote checkpoint + decomposition frames to {args.out}")
    logger.close()


if __name__ == "__main__":
    main()
