"""End-to-end: train a tiny LoTD-NeRF on a synthetic scene (PSNR must climb),
and a NeuS ray query with eikonal double-backward in one optimizer step.

This is the minimum end-to-end slice of SURVEY.md §7 step 3 (configs[0/1]).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from nr3d_lib_tpu import nn


def make_scene_rays(n: int, key, res: int = 32):
    """Synthetic scene: opaque sphere r=0.5 at origin, colored by surface
    normal; black background. Random rays from a shell looking at origin."""
    k1, k2 = jax.random.split(key)
    # camera positions on shell r=2, rays toward random target near origin
    o = jax.random.normal(k1, (n, 3))
    o = o / jnp.linalg.norm(o, axis=-1, keepdims=True) * 2.0
    target = jax.random.uniform(k2, (n, 3), minval=-0.3, maxval=0.3)
    d = target - o
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    # analytic ray-sphere for ground truth
    b = jnp.sum(o * d, -1)
    c = jnp.sum(o * o, -1) - 0.25
    disc = b * b - c
    hit = disc > 0
    t_hit = -b - jnp.sqrt(jnp.maximum(disc, 0.0))
    p = o + d * t_hit[:, None]
    normal = p / jnp.maximum(jnp.linalg.norm(p, axis=-1, keepdims=True), 1e-9)
    rgb = jnp.where(hit[:, None], normal * 0.5 + 0.5, 0.0)
    return o, d, rgb, hit, t_hit


def test_train_tiny_nerf_psnr_improves():
    from nr3d_lib_tpu.graphics.nerf_ray_query import nerf_ray_query_fixed
    from nr3d_lib_tpu.models.model_base import LoTDNeRFModel

    model = LoTDNeRFModel(
        field_cfg={"encoding_cfg": {"lotd_cfg": {
            "lod_res": [8, 16, 32], "lod_n_feats": 2,
            "lod_types": ["Dense", "Dense", "Hash"], "hashmap_size": 2 ** 12}},
            "density_decoder_cfg": {"D": 1, "W": 32},
            "radiance_cfg": {"D": 1, "W": 32}},
        space_cfg={"radius": 1.0}, accel_cfg={"resolution": 16})

    graphdef, params, rest = nn.split(model, nn.Param, ...)
    opt = optax.adam(5e-3)
    opt_state = opt.init(params)

    def render(params, rest, o, d, key):
        m = nn.merge(graphdef, params, rest)
        ray_tested = m.space.ray_test(o, d)
        rendered, _ = nerf_ray_query_fixed(m, m.space, ray_tested,
                                           n_samples=48, perturb_key=key)
        return rendered

    @jax.jit
    def train_step(params, opt_state, o, d, rgb_gt, key):
        def loss_fn(p):
            rendered = render(p, rest, o, d, key)
            return jnp.mean((rendered["rgb_volume"] - rgb_gt) ** 2)

        loss, g = jax.value_and_grad(loss_fn)(params)
        updates, opt_state2 = opt.update(g, opt_state)
        return optax.apply_updates(params, updates), opt_state2, loss

    key = jax.random.key(0)
    key, dk = jax.random.split(key)
    o_val, d_val, rgb_val, _, _ = make_scene_rays(512, jax.random.key(99))

    def psnr(params):
        rendered = render(params, rest, o_val, d_val, None)
        mse = float(jnp.mean((rendered["rgb_volume"] - rgb_val) ** 2))
        return -10 * np.log10(mse)

    psnr0 = psnr(params)
    losses = []
    for it in range(300):
        key, dk, sk = jax.random.split(key, 3)
        o, d, rgb_gt, _, _ = make_scene_rays(1024, dk)
        params, opt_state, loss = train_step(params, opt_state, o, d, rgb_gt, sk)
        losses.append(float(loss))
    psnr1 = psnr(params)
    assert np.isfinite(losses).all()
    assert psnr1 > psnr0 + 6, f"PSNR {psnr0:.2f} → {psnr1:.2f}, expected +6dB"
    assert psnr1 > 15, f"final PSNR {psnr1:.2f} too low"

    # depth sanity: rendered depth near analytic hit depth for hit rays
    m = nn.merge(graphdef, params, rest)
    o, d, rgb_gt, hit, t_hit = make_scene_rays(256, jax.random.key(7))
    ray_tested = m.space.ray_test(o, d)
    rendered, _ = nerf_ray_query_fixed(m, m.space, ray_tested, n_samples=64)
    depth_err = np.asarray(jnp.abs(rendered["depth_volume"] - t_hit))[np.asarray(hit)]
    assert np.median(depth_err) < 0.15


def test_nerf_march_occ_query_shapes():
    from nr3d_lib_tpu.models.model_base import LoTDNeRFModel

    model = LoTDNeRFModel(
        field_cfg={"encoding_cfg": {"lotd_cfg": {
            "lod_res": [8, 16], "lod_n_feats": 2, "lod_types": "Dense"}},
            "density_decoder_cfg": {"D": 1, "W": 16},
            "radiance_cfg": {"D": 1, "W": 16}},
        accel_cfg={"resolution": 16, "max_steps_per_ray": 64, "step_size": 2 / 32})
    model.populate()
    o = jnp.asarray([[-2.0, 0.0, 0.0], [0.0, -3.0, 0.5]])
    d = jnp.asarray([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    ray_tested = model.ray_test(o, d)
    rendered, vb = model.ray_query(ray_tested, key=jax.random.key(0))
    assert rendered["rgb_volume"].shape == (2, 3)
    assert rendered["depth_volume"].shape == (2,)
    assert np.isfinite(np.asarray(rendered["rgb_volume"])).all()


def test_neus_query_and_eikonal_step():
    from nr3d_lib_tpu.models.model_base import LoTDNeuSModel

    model = LoTDNeuSModel(
        field_cfg={"surface_cfg": {
            "encoding_cfg": {"lotd_cfg": {
                "lod_res": [8, 16], "lod_n_feats": 2, "lod_types": "Dense"}},
            "decoder_cfg": {"D": 1, "W": 16}},
            "radiance_cfg": {"D": 1, "W": 16}},
        accel_cfg={"resolution": 16, "max_steps_per_ray": 48, "step_size": 2 / 24},
        ray_query_cfg={"query_mode": "coarse_multi_upsample", "n_coarse": 24,
                       "upsample_inv_s_factors": [1.0, 4.0], "n_importance": 8})
    model.populate()
    graphdef, params, rest = nn.split(model, nn.Param, ...)

    o = jnp.asarray([[-2.0, 0.0, 0.0], [0.0, -2.0, 0.1], [2.0, 2.0, 2.0]])
    d = jnp.asarray([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [-0.577, -0.577, -0.577]])
    rgb_gt = jnp.asarray([[1.0, 0.0, 0.0]] * 3)

    @jax.jit
    def loss_and_grad(params):
        def loss_fn(p):
            m = nn.merge(graphdef, p, rest)
            ray_tested = m.ray_test(o, d)
            rendered, vb = m.ray_query(ray_tested, key=jax.random.key(1))
            rgb_loss = jnp.mean((rendered["rgb_volume"] - rgb_gt) ** 2)
            # eikonal on the queried nablas → exercises 2nd-order autodiff
            nablas = vb["nablas"]
            eik = jnp.mean((jnp.linalg.norm(nablas, axis=-1) - 1.0) ** 2)
            return rgb_loss + 0.1 * eik

        return jax.value_and_grad(loss_fn)(params)

    loss, g = loss_and_grad(params)
    assert np.isfinite(float(loss))
    leaves = jax.tree_util.tree_leaves(g)
    gnorm = float(jnp.sqrt(sum(jnp.sum(l ** 2) for l in leaves)))
    assert np.isfinite(gnorm) and gnorm > 0
    # inv_s (variance ctrl) must receive gradient too
    flat = jax.tree_util.tree_leaves_with_path(g)
    has_lns = any("ln_s" in "/".join(str(p) for p in path) and float(jnp.abs(leaf).max()) > 0
                  for path, leaf in flat)
    assert has_lns, "variance parameter got no gradient"


def test_neus_model_checkpoint_roundtrip(tmp_path):
    from nr3d_lib_tpu.checkpoint import CheckpointIO
    from nr3d_lib_tpu.models.model_base import LoTDNeuSModel

    def build():
        return LoTDNeuSModel(field_cfg={"surface_cfg": {
            "encoding_cfg": {"lotd_cfg": {"lod_res": [8], "lod_n_feats": 2,
                                          "lod_types": "Dense"}},
            "decoder_cfg": {"D": 1, "W": 8}},
            "radiance_cfg": {"D": 1, "W": 8}})

    m1 = build()
    io = CheckpointIO(str(tmp_path))
    io.register_modules(model=m1)
    io.save("ckpt_1.npz", it=1)

    m2 = build()
    # perturb then restore
    m2.field.implicit_surface.encoding.flattened_params[...] = \
        m2.field.implicit_surface.encoding.flattened_params[...] * 0.0
    io2 = CheckpointIO(str(tmp_path))
    io2.register_modules(model=m2)
    io2.load("ckpt_1.npz")
    np.testing.assert_allclose(
        np.asarray(m2.field.implicit_surface.encoding.flattened_params[...]),
        np.asarray(m1.field.implicit_surface.encoding.flattened_params[...]))
