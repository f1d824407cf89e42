"""Example: train a LoTD-NeRF on a synthetic scene and render a turntable.

The reference library ships no trainer (training lives downstream); this
example shows the full downstream workflow on this framework:

    python examples/train_nerf_synthetic.py --iters 500 --out /tmp/nerf_run

Works on CPU (add --cpu) or one GPU (one process per card). The "dataset" is an analytic
normal-colored sphere so the example is self-contained.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=500)
    ap.add_argument("--rays", type=int, default=2048)
    ap.add_argument("--out", type=str, default="/tmp/nerf_run")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--brick", action="store_true",
                    help="use the brick-layout encoding backend")
    ap.add_argument("--w4", action="store_true",
                    help="bf16-packed F=4 levels (half the gathers per "
                         "feature; implies --brick)")
    ap.add_argument("--scene", choices=["sphere", "hard"], default="sphere",
                    help="'hard': the NeRF-synthetic stand-in — 5 textured "
                         "spheres + checkered ground, held-out-view PSNR "
                         "protocol (docs/PARITY.md)")
    ap.add_argument("--eval_every", type=int, default=0,
                    help="held-out-view PSNR every N iters (PSNR curve in "
                         "scalars.jsonl); default: only at the end")
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
    from nr3d_lib_tpu.graphics.nerf_ray_query import nerf_ray_query_fixed
    from nr3d_lib_tpu.gui import render_turntable
    from nr3d_lib_tpu.logger import Logger
    from nr3d_lib_tpu.models.model_base import LoTDNeRFModel

    enc_cfg = {"lotd_cfg": {"lod_res": [16, 32, 64], "lod_n_feats": 2,
                            "lod_types": ["Dense", "Dense", "Hash"],
                            "hashmap_size": 2 ** 14}}
    if args.w4:
        # same 6 output features from half the levels (bf16-packed F=4)
        enc_cfg = {"lotd_cfg": {"lod_res": [16, 48], "lod_n_feats": 4,
                                "lod_types": ["Dense", "Hash"],
                                "hashmap_size": 2 ** 14},
                   "backend": "brick"}
    elif args.brick:
        enc_cfg["backend"] = "brick"
    model = LoTDNeRFModel(field_cfg={"encoding_cfg": enc_cfg,
                                     "density_decoder_cfg": {"D": 1, "W": 64},
                                     "radiance_cfg": {"D": 2, "W": 64}})
    model.populate()
    graphdef, params, rest = nn.split(model, nn.Param, ...)
    opt = optax.adam(5e-3)
    opt_state = opt.init(params)
    logger = Logger(args.out, use_tensorboard=False)
    ckpt = CheckpointIO(os.path.join(args.out, "ckpts"))
    ckpt.register_modules(model=model)

    def scene_sphere(o, d):
        b = jnp.sum(o * d, -1)
        c = jnp.sum(o * o, -1) - 0.25
        disc = b * b - c
        hit = disc > 0
        p = o + d * (-b - jnp.sqrt(jnp.maximum(disc, 0.0)))[:, None]
        n = p / jnp.maximum(jnp.linalg.norm(p, axis=-1, keepdims=True), 1e-9)
        return jnp.where(hit[:, None], n * 0.5 + 0.5, 0.0)

    # NeRF-synthetic stand-in (docs/PARITY.md protocol): 5 textured spheres
    # at different positions/radii + a checkered ground plane — occlusions,
    # thin gaps, and high-frequency texture, analytically ray-traced so no
    # dataset is needed (zero-egress environment).
    _SPH_C = jnp.asarray([[0.0, 0.0, 0.0], [0.45, 0.3, -0.15],
                          [-0.45, -0.2, 0.1], [0.15, -0.45, -0.25],
                          [-0.2, 0.45, 0.3]])
    _SPH_R = jnp.asarray([0.28, 0.18, 0.2, 0.14, 0.12])
    _SPH_F = jnp.asarray([[9.0, 5.0, 13.0], [17.0, 11.0, 6.0],
                          [7.0, 15.0, 9.0], [21.0, 8.0, 12.0],
                          [11.0, 19.0, 7.0]])

    def scene_hard(o, d):
        oc = o[:, None, :] - _SPH_C[None]                     # [N,5,3]
        b = jnp.sum(oc * d[:, None, :], -1)
        c = jnp.sum(oc * oc, -1) - _SPH_R[None] ** 2
        disc = b * b - c
        t_sph = -b - jnp.sqrt(jnp.maximum(disc, 0.0))
        t_sph = jnp.where((disc > 0) & (t_sph > 1e-3), t_sph, jnp.inf)
        # ground plane z = -0.48 inside the unit box
        tz = (-0.48 - o[:, 2]) / jnp.where(jnp.abs(d[:, 2]) < 1e-6, 1e-6,
                                           d[:, 2])
        pz = o + d * tz[:, None]
        on_plane = (tz > 1e-3) & (jnp.abs(pz[:, 0]) < 1.0) \
            & (jnp.abs(pz[:, 1]) < 1.0)
        tz = jnp.where(on_plane, tz, jnp.inf)
        t_all = jnp.concatenate([t_sph, tz[:, None]], -1)     # [N,6]
        k = jnp.argmin(t_all, -1)
        t = jnp.min(t_all, -1)
        hit = jnp.isfinite(t)
        p = o + d * jnp.where(hit, t, 0.0)[:, None]
        # per-sphere striped texture; plane gets an 8x8 checker
        f = jnp.concatenate([_SPH_F, jnp.zeros((1, 3))], 0)[k]  # [N,3]
        tex_sph = 0.5 + 0.5 * jnp.sin(f * p + jnp.asarray([0.0, 2.1, 4.2]))
        checker = (jnp.floor(p[:, 0] * 4) + jnp.floor(p[:, 1] * 4)) % 2
        tex_pln = jnp.stack([0.15 + 0.7 * checker] * 3, -1)
        rgb = jnp.where((k == 5)[:, None], tex_pln, tex_sph)
        return jnp.where(hit[:, None], rgb, 0.0)

    scene = scene_hard if args.scene == "hard" else scene_sphere

    def heldout_views(n_views: int = 4, hw: int = 96):
        """Held-out eval cameras: fixed ring at radius 2.4, elevations the
        random training distribution never privileges (protocol step 2)."""
        from nr3d_lib_tpu.graphics.cameras import look_at, pinhole_get_rays

        intr = jnp.asarray([[hw * 1.2, 0, hw / 2],
                            [0, hw * 1.2, hw / 2], [0, 0, 1.0]])
        us, vs = jnp.meshgrid(jnp.arange(hw) + 0.5, jnp.arange(hw) + 0.5,
                              indexing="xy")
        uv = jnp.stack([us, vs], -1).reshape(-1, 2)
        views = []
        for i in range(n_views):
            az = 2 * np.pi * (i + 0.5) / n_views
            eye = np.asarray([2.4 * np.cos(az) * 0.9,
                              2.4 * np.sin(az) * 0.9, 1.0])
            c2w = look_at(eye, [0.0, 0.0, -0.1])
            o, d = pinhole_get_rays(uv, intr, jnp.asarray(c2w))
            views.append((o.reshape(-1, 3), d.reshape(-1, 3)))
        return views

    def eval_heldout(params, views):
        m = nn.merge(graphdef, params, rest)
        vals = []
        for o, d in views:
            rt = m.space.ray_test(o, d)
            rendered, _ = nerf_ray_query_fixed(m, m.space, rt, n_samples=64)
            vals.append(float(psnr(rendered["rgb_volume"], scene(o, d))))
        return sum(vals) / len(vals)

    # the hard scene fills the unit box (ground to ±1, spheres at |c|≈0.55):
    # training rays must COVER it, not just graze the center, or held-out
    # views see unsupervised regions (protocol step 1 in docs/PARITY.md)
    tgt_half = 0.7 if args.scene == "hard" else 0.3

    def sample_rays(n, key):
        k1, k2, k3 = jax.random.split(key, 3)
        o = jax.random.normal(k1, (n, 3))
        r_o = jax.random.uniform(k3, (n, 1), minval=1.8, maxval=2.6)
        o = o / jnp.linalg.norm(o, axis=-1, keepdims=True) * r_o
        tgt = jax.random.uniform(k2, (n, 3), minval=-tgt_half,
                                 maxval=tgt_half)
        d = tgt - o
        return o, d / jnp.linalg.norm(d, axis=-1, keepdims=True)

    @jax.jit
    def train_step(params, opt_state, o, d, rgb_gt, key):
        def loss_fn(p):
            m = nn.merge(graphdef, p, rest)
            rt = m.space.ray_test(o, d)
            rendered, _ = nerf_ray_query_fixed(m, m.space, rt, n_samples=64,
                                               perturb_key=key)
            return jnp.mean((rendered["rgb_volume"] - rgb_gt) ** 2)

        loss, g = jax.value_and_grad(loss_fn)(params)
        updates, opt_state2 = opt.update(g, opt_state)
        return optax.apply_updates(params, updates), opt_state2, loss

    key = jax.random.key(0)
    views = heldout_views() if args.scene == "hard" else None
    t0 = time.time()
    for it in range(args.iters):
        key, k1, k2 = jax.random.split(key, 3)
        o, d = sample_rays(args.rays, k1)
        params, opt_state, loss = train_step(params, opt_state, o, d,
                                             scene(o, d), k2)
        if it % 100 == 0 or it == args.iters - 1:
            logger.add("train", "loss", loss, it)
            print(f"it {it:5d}  loss {float(loss):.5f}")
        if views is not None and args.eval_every \
                and it % args.eval_every == 0:
            p_ho = eval_heldout(params, views)
            logger.add("val", "psnr_heldout", p_ho, it)
            print(f"it {it:5d}  held-out PSNR {p_ho:.2f} dB")
    print(f"trained {args.iters} iters in {time.time() - t0:.1f}s")

    nn.update(model, params)
    o, d = sample_rays(2048, jax.random.key(123))
    rt = model.space.ray_test(o, d)
    rendered, _ = nerf_ray_query_fixed(model, model.space, rt, n_samples=64)
    val_psnr = float(psnr(rendered["rgb_volume"], scene(o, d)))
    print(f"val PSNR: {val_psnr:.2f} dB")
    logger.add("val", "psnr", val_psnr, args.iters)
    if views is not None:
        p_ho = eval_heldout(params, views)
        logger.add("val", "psnr_heldout", p_ho, args.iters)
        print(f"held-out-view PSNR ({args.scene}): {p_ho:.2f} dB")

    ckpt.save("ckpt_final.npz", it=args.iters, psnr=val_psnr)
    # refresh the occupancy grid from the trained density so the turntable's
    # marched query skips empty space (training_before_per_step does this
    # incrementally during a real run)
    model.accel.occ.init_from_net(jax.random.key(9), model.query_density)
    model.accel.occ.occ_thre = 1.0
    frames = render_turntable(model, n_frames=8, radius=2.5, hw=(128, 128),
                              out_dir=os.path.join(args.out, "turntable"))
    print(f"wrote checkpoint + {len(frames)} turntable frames to {args.out}")
    logger.close()


if __name__ == "__main__":
    main()
