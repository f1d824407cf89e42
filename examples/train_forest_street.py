"""Street-scale forest training demo (StreetSurf-style toy).

The reference's headline use case is street reconstruction with a forest
(block-sparse) space (reference: fields_forest/neus/renderer_mixin.py +
app StreetSurf). This example trains `LoTDForestNeuSModel` — per-block
LoTD tables, per-block occupancy acceleration, segment ray marching — on
an analytic "street": a ground plane plus a row of spheres down a corridor
of 6×1×1 blocks, supervised by ray-cast RGB, then renders a fly-through
along the street.

Run (CPU ~2 min):  python examples/train_forest_street.py --cpu --iters 400
Real chip:         python examples/train_forest_street.py --iters 2000
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=400)
    ap.add_argument("--rays", type=int, default=1024)
    ap.add_argument("--out", type=str, default="/tmp/forest_run")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--march", choices=("fixed", "segments"),
                    default="segments")
    ap.add_argument("--brick", action="store_true",
                    help="per-block brick tables (one "
                         "gather per point-level; ops/lotd_brick.py "
                         "brick_encode_batched)")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from nr3d_lib_tpu.utils import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp
    import numpy as np
    import optax
    from nr3d_lib_tpu import nn

    from nr3d_lib_tpu.checkpoint import CheckpointIO
    from nr3d_lib_tpu.graphics.metrics import psnr
    from nr3d_lib_tpu.logger import Logger
    from nr3d_lib_tpu.models.fields_forest import LoTDForestNeuSModel

    # street corridor: x ∈ [-3, 3], y/z ∈ [-0.5, 0.5], 6 blocks along x
    model = LoTDForestNeuSModel(
        space_cfg={"resolution": (6, 1, 1), "origin": (-3.0, -0.5, -0.5),
                   "block_size": 1.0},
        field_cfg={"surface_cfg": {
            "lotd_cfg": {"lod_res": [8, 16, 32], "lod_n_feats": 2,
                         "lod_types": ["Dense", "Dense", "Dense"],
                         **({"backend": "brick"} if args.brick else {})},
            "decoder_cfg": {"D": 1, "W": 64}},
            "radiance_cfg": {"D": 1, "W": 64}},
        n_march_steps=128, march_mode=args.march,
        max_segments=8, steps_per_segment=24, n_importance=8)
    model.populate()
    graphdef, params, rest = nn.split(model, nn.Param, ...)
    opt = optax.adam(1e-2)
    opt_state = opt.init(params)
    logger = Logger(args.out, use_tensorboard=False)
    ckpt = CheckpointIO(os.path.join(args.out, "ckpts"))
    ckpt.register_modules(model=model)

    # ---- analytic street: ground plane y=-0.3 + spheres every other block
    centers = jnp.asarray([[x, -0.05, 0.0] for x in (-2.5, -0.5, 1.5)],
                          jnp.float32)
    R = 0.28
    GROUND_Y = -0.3

    def scene(o, d):
        """First-hit RGB of the analytic street (plane + spheres)."""
        t_best = jnp.full(o.shape[:1], 1e9)
        rgb = jnp.zeros_like(o)
        # spheres: colored by surface normal
        for i in range(centers.shape[0]):
            oc = o - centers[i]
            b = jnp.sum(oc * d, -1)
            c = jnp.sum(oc * oc, -1) - R * R
            disc = b * b - c
            t = -b - jnp.sqrt(jnp.maximum(disc, 0.0))
            hit = (disc > 0) & (t > 1e-3) & (t < t_best)
            p = o + d * t[:, None]
            n = (p - centers[i]) / R
            rgb = jnp.where(hit[:, None], n * 0.5 + 0.5, rgb)
            t_best = jnp.where(hit, t, t_best)
        # ground: smooth warm gradient along the street (low-frequency —
        # learnable by the coarse levels; spheres carry the detail)
        t_g = (GROUND_Y - o[:, 1]) / jnp.where(jnp.abs(d[:, 1]) < 1e-6,
                                               1e-6, d[:, 1])
        p_g = o + d * t_g[:, None]
        shade = 0.35 + 0.3 * jnp.sin(p_g[:, 0] * 0.9)
        g_rgb = jnp.stack([shade + 0.15, shade, shade - 0.1], -1)
        hit_g = (t_g > 1e-3) & (t_g < t_best)
        rgb = jnp.where(hit_g[:, None], jnp.clip(g_rgb, 0, 1), rgb)
        return rgb

    def sample_rays(n, key):
        """Cameras hovering over the street looking down-corridor."""
        k1, k2, k3 = jax.random.split(key, 3)
        eye_x = jax.random.uniform(k1, (n,), minval=-2.8, maxval=2.8)
        o = jnp.stack([eye_x,
                       jax.random.uniform(k2, (n,), minval=0.2, maxval=0.45),
                       jax.random.uniform(k3, (n,), minval=-0.45,
                                          maxval=0.45)], -1)
        tgt = jnp.stack([eye_x + jax.random.normal(k1, (n,)) * 1.5,
                         jnp.full((n,), -0.25),
                         jax.random.normal(k2, (n,)) * 0.3], -1)
        d = tgt - o
        return o, d / jnp.linalg.norm(d, axis=-1, keepdims=True)

    @jax.jit
    def train_step(params, rest, opt_state, o, d, rgb_gt, key):
        def loss_fn(p):
            m = nn.merge(graphdef, p, rest)
            rendered, vb = m.ray_query(m.ray_test(o, d), key=key)
            eik = jnp.mean((jnp.linalg.norm(vb["nablas_packed"], axis=-1)
                            - 1.0) ** 2)
            rgb_l = jnp.mean((rendered["rgb_volume"] - rgb_gt) ** 2)
            return rgb_l + 0.01 * eik, rgb_l

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
            m2.training_before_per_step(it, jax.random.key(7000 + it))
            _, _, rest = nn.split(m2, nn.Param, ...)
        o, d = sample_rays(args.rays, k1)
        params, opt_state, loss, rgb_l = train_step(
            params, rest, opt_state, o, d, scene(o, d), k2)
        if it % 100 == 0 or it == args.iters - 1:
            logger.add("train", "loss", loss, it)
            print(f"it {it:5d}  loss {float(loss):.5f} rgb {float(rgb_l):.5f}")
    print(f"trained {args.iters} iters in {time.time() - t0:.1f}s")

    nn.update(model, params)
    o, d = sample_rays(2048, jax.random.key(123))
    rendered, _ = model.ray_query(model.ray_test(o, d))
    val_psnr = float(psnr(rendered["rgb_volume"], scene(o, d)))
    print(f"val PSNR: {val_psnr:.2f} dB")
    logger.add("val", "psnr", val_psnr, args.iters)
    ckpt.save("ckpt_final.npz", it=args.iters, psnr=val_psnr)

    # occupancy skipping at work: occupied fraction of per-block grids
    occ = np.asarray(model.accel.occ.val_grid[...] > model.accel.occ.occ_thre)
    print(f"occupancy: {occ.mean():.1%} of cells occupied "
          f"across {occ.shape[0]} blocks")

    # fly-through along the street
    from nr3d_lib_tpu.graphics.cameras import look_at
    from nr3d_lib_tpu.gui import NeuralRenderer
    from nr3d_lib_tpu.logger import _write_png
    from nr3d_lib_tpu.utils import img_to_uint8

    renderer = NeuralRenderer(model, hw=(96, 128))
    os.makedirs(os.path.join(args.out, "flythrough"), exist_ok=True)
    for i, ex in enumerate(np.linspace(-2.6, 2.0, 6)):
        c2w = look_at(jnp.asarray([ex, 0.35, 0.0]),
                      jnp.asarray([ex + 1.2, -0.2, 0.0]))
        images = renderer.render(c2w)
        _write_png(os.path.join(args.out, "flythrough", f"{i:02d}.png"),
                   img_to_uint8(images["rgb_volume"]))
    print(f"fly-through written to {args.out}/flythrough")


if __name__ == "__main__":
    main()
