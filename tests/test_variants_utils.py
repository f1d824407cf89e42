"""Tests: NeuS query variants (compressed/dynamic/batched), LoTD helpers,
grid-encoding utils, MLL, depth completion, pointcloud, GEM, pack additions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest


def _tiny_neus():
    from nr3d_lib_tpu.models.model_base import LoTDNeuSModel

    m = LoTDNeuSModel(
        field_cfg={"surface_cfg": {
            "encoding_cfg": {"lotd_cfg": {"lod_res": [8], "lod_n_feats": 2,
                                          "lod_types": "Dense"}},
            "decoder_cfg": {"D": 1, "W": 16}},
            "radiance_cfg": {"D": 1, "W": 16}},
        accel_cfg={"resolution": 8, "max_steps_per_ray": 32, "step_size": 2 / 16})
    m.populate()
    return m


def test_neus_compressed_query_matches_uncompressed():
    from nr3d_lib_tpu.graphics.neus_ray_query import (
        neus_ray_query_march_occ_multi_upsample)
    from nr3d_lib_tpu.graphics.neus_ray_query_variants import (
        neus_ray_query_march_occ_multi_upsample_compressed)

    m = _tiny_neus()
    o = jnp.asarray([[-2.0, 0.1, 0.0], [0.0, -2.0, 0.2]])
    d = jnp.asarray([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    rt = m.ray_test(o, d)
    kw = dict(upsample_inv_s_factors=[1.0], n_importance=8)
    r_full, _ = neus_ray_query_march_occ_multi_upsample(
        m, m.accel, m.space, rt, **kw)
    r_comp, vb = neus_ray_query_march_occ_multi_upsample_compressed(
        m, m.accel, m.space, rt, compression_factor=0.9, **kw)
    # compressed drops only negligible-contribution samples
    np.testing.assert_allclose(np.asarray(r_comp["rgb_volume"]),
                               np.asarray(r_full["rgb_volume"]), atol=2e-2)
    np.testing.assert_allclose(np.asarray(r_comp["mask_volume"]),
                               np.asarray(r_full["mask_volume"]), atol=2e-2)
    assert np.isfinite(np.asarray(r_comp["normals_volume"])).all()


def test_neus_dynamic_query():
    from nr3d_lib_tpu.graphics.neus_ray_query_variants import neus_ray_query_dynamic
    from nr3d_lib_tpu.models.fields_dynamic import DynamicPermutoConcatNeuS
    from nr3d_lib_tpu.models.spatial import AABBSpace

    model = DynamicPermutoConcatNeuS(
        surface_cfg={"permuto_cfg": {"res_list": [4.0, 8.0],
                                     "log2_hashmap_size": 10},
                     "decoder_cfg": {"D": 1, "W": 16}},
        radiance_cfg={"D": 1, "W": 16})
    # amplify the (tiny-init) time-conditioned features so the time effect
    # is visible at init
    model.implicit_surface.flattened_params[...] = \
        model.implicit_surface.flattened_params[...] * 500.0
    space = AABBSpace()
    o = jnp.asarray([[-2.0, 0.0, 0.0], [2.0, 0.1, 0.0]])
    d = jnp.asarray([[1.0, 0.0, 0.0], [-1.0, 0.0, 0.0]])
    rt = space.ray_test(o, d)
    ts = jnp.asarray([0.0, 0.5])
    rendered, vb = neus_ray_query_dynamic(model, space, rt, ts,
                                          n_coarse=16, n_importance=4,
                                          upsample_inv_s_factors=[1.0])
    assert rendered["rgb_volume"].shape == (2, 3)
    assert np.isfinite(np.asarray(rendered["rgb_volume"])).all()
    r2, _ = neus_ray_query_dynamic(model, space, rt, jnp.asarray([0.9, -0.9]),
                                   n_coarse=16, n_importance=4,
                                   upsample_inv_s_factors=[1.0])
    assert not np.allclose(np.asarray(rendered["depth_volume"]),
                           np.asarray(r2["depth_volume"]))


def test_neus_batched_query():
    from nr3d_lib_tpu.graphics.neus_ray_query_variants import neus_ray_query_batched
    from nr3d_lib_tpu.models.fields_conditional import GenerativePermutoConcatNeuS
    from nr3d_lib_tpu.models.spatial import AABBSpace

    model = GenerativePermutoConcatNeuS(
        z_dim=2, surface_cfg={"permuto_cfg": {"res_list": [4.0, 8.0],
                                              "log2_hashmap_size": 10},
                              "decoder_cfg": {"D": 1, "W": 16}},
        radiance_cfg={"D": 1, "W": 16})
    model.implicit_surface.flattened_params[...] = \
        model.implicit_surface.flattened_params[...] * 500.0
    space = AABBSpace()
    o = jnp.asarray([[-2.0, 0.0, 0.0], [-2.0, 0.0, 0.0]])
    d = jnp.asarray([[1.0, 0.0, 0.0], [1.0, 0.0, 0.0]])
    rt = space.ray_test(o, d)
    z = jnp.asarray([[0.0, 0.0], [2.0, -2.0]])
    bidx = jnp.asarray([0, 1])
    rendered, _ = neus_ray_query_batched(model, space, rt, z, bidx,
                                         n_coarse=16, n_importance=4,
                                         upsample_inv_s_factors=[1.0])
    assert np.isfinite(np.asarray(rendered["depth_volume"])).all()
    assert np.isfinite(np.asarray(rendered["rgb_volume"])).all()
    # latent conditioning: same point, different z → different sdf
    x = jnp.asarray([[0.1, 0.2, 0.3]])
    s0 = model.implicit_surface.forward_sdf(x, z[0])["sdf"]
    s1 = model.implicit_surface.forward_sdf(x, z[1])["sdf"]
    assert abs(float(s0[0]) - float(s1[0])) > 1e-4


def test_lotd_helpers(rng):
    from nr3d_lib_tpu.models.grid_encodings.lotd.lotd_helpers import (
        GradGuard, get_level_param, param_interpolate, set_level_param)
    from nr3d_lib_tpu.ops.lotd import generate_meta

    meta = generate_meta(3, [4, 8], 2, "Dense")
    params = jnp.asarray(rng.standard_normal(meta.n_params))
    lv0 = get_level_param(params, meta, 0)
    assert lv0.shape == (4, 4, 4, 2)
    params2 = set_level_param(params, meta, 0, jnp.zeros((4, 4, 4, 2)))
    assert float(jnp.abs(get_level_param(params2, meta, 0)).max()) == 0.0

    up = param_interpolate(lv0, (8, 8, 8))
    assert up.shape == (8, 8, 8, 2)
    # corners preserved by align-corners interp
    np.testing.assert_allclose(np.asarray(up[0, 0, 0]), np.asarray(lv0[0, 0, 0]),
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(up[-1, -1, -1]),
                               np.asarray(lv0[-1, -1, -1]), rtol=1e-5)

    guard = GradGuard(ema_factor=2.0)
    g = {"w": jnp.ones(4)}
    g1, clipped1 = guard(g)
    assert not clipped1
    g2, clipped2 = guard({"w": jnp.ones(4) * 100})
    assert clipped2
    from nr3d_lib_tpu.models.utils import calc_grad_norm

    assert float(calc_grad_norm(g2)) <= 2.0 * 2.0 + 1e-6


def test_grid_encoding_utils(rng):
    from nr3d_lib_tpu.models.grid_encodings.utils import (get_multires_decoder,
                                                          gridsample1d,
                                                          trilinear_interp)

    grid = jnp.asarray(rng.standard_normal((5, 5, 5, 2)))
    # exact at vertices
    v = trilinear_interp(grid, jnp.asarray([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]]))
    np.testing.assert_allclose(np.asarray(v[0]), np.asarray(grid[0, 0, 0]), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(v[1]), np.asarray(grid[-1, -1, -1]), rtol=1e-5)

    line = jnp.asarray(rng.standard_normal((7, 3)))
    lv = gridsample1d(line, jnp.asarray([-1.0, 1.0, 0.0]))
    np.testing.assert_allclose(np.asarray(lv[0]), np.asarray(line[0]), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(lv[1]), np.asarray(line[-1]), rtol=1e-5)

    decode, mlp = get_multires_decoder([2, 2, 2], 4, select_n_levels=2, D=0, W=8)
    out = decode(jnp.ones((3, 6)))
    assert out.shape == (3, 4)


def test_mll_net(rng):
    """Reference-depth MLL (mll.py:49/157/296): chained lattice layers
    (layer 1 encodes layer 0's OUTPUT), learned-zero residual, output head,
    forward_with_nablas vs a jax.grad oracle."""
    import jax

    from nr3d_lib_tpu.models.grid_encodings.permuto.mll import (
        MLL, MLLNet, PermutohedralLatticeLayer)

    lattice_cfg = dict(coarsest_res=4.0, finest_res=16.0,
                       log2_hashmap_size=10)
    net = MLLNet(3, 1, D=2, use_residual=True, lattice_n_levels=[3, 2],
                 lattice_n_feats=2, decoder_out_feats=8,
                 lattice_cfg=lattice_cfg)
    # layer 0: decoder to 8 feats + residual over the 3 input dims;
    # layer 1: raw 2·2-level encoding, no decoder/residual
    assert net.lattice_layers[0].out_features == 8
    assert net.lattice_layers[0].residual_in_features == 3
    assert net.lattice_layers[1].decoder is None
    assert net.lattice_layers[1].in_features == 8
    x = jnp.asarray(rng.uniform(-1, 1, (16, 3)).astype(np.float32))
    y = net(x)["output"]
    assert y.shape == (16, 1) and np.isfinite(np.asarray(y)).all()

    r = net.forward_with_nablas(x)
    assert r["nablas"].shape == (16, 3)
    g_oracle = jax.grad(lambda xx: net(xx)["output"].sum())(x)
    np.testing.assert_allclose(np.asarray(r["nablas"]),
                               np.asarray(g_oracle), rtol=1e-5, atol=1e-6)

    # anneal + weight-reg surfaces exist (reference set_anneal_iter /
    # get_weight_reg)
    net.set_anneal_iter(5)
    assert net.get_weight_reg().shape[0] >= 1
    # single layer module importable/usable standalone
    layer = PermutohedralLatticeLayer(3, n_levels=2, n_feats=2,
                                     coarsest_res=4.0, finest_res=8.0,
                                     log2_hashmap_size=8)
    assert layer(x).shape == (16, 2 * 2)
    assert isinstance(net, MLL)


def test_mll_net_trains_sdf(rng):
    """VERDICT r04 #8 'done' gate: MLLNet trains on an SDF smoke test."""
    import jax
    import optax
    from nr3d_lib_tpu import nn

    from nr3d_lib_tpu.models.grid_encodings.permuto.mll import MLLNet

    net = MLLNet(3, 1, D=2, lattice_n_levels=[4, 2], lattice_n_feats=2,
                 decoder_out_feats=8,
                 lattice_cfg=dict(coarsest_res=4.0, finest_res=32.0,
                                  log2_hashmap_size=12))
    graphdef, params, rest = nn.split(net, nn.Param, ...)
    opt = optax.adam(3e-3)
    opt_state = opt.init(params)
    x = jnp.asarray(rng.uniform(-1, 1, (512, 3)).astype(np.float32))
    sdf_gt = jnp.linalg.norm(x, axis=-1) - 0.5

    @jax.jit
    def step(p, s):
        def loss_fn(pp):
            m = nn.merge(graphdef, pp, rest)
            pred = m(x)["output"][:, 0]
            return jnp.mean((pred - sdf_gt) ** 2)

        loss, g = jax.value_and_grad(loss_fn)(p)
        upd, s2 = opt.update(g, s)
        return optax.apply_updates(p, upd), s2, loss

    losses = []
    for _ in range(60):
        params, opt_state, loss = step(params, opt_state)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < 0.3 * losses[0]


def test_depth_completion():
    from nr3d_lib_tpu.maths.depth_completion import depth_completion

    d = np.zeros((32, 32), np.float32)
    d[::4, ::4] = 5.0  # sparse constant-depth grid
    out = depth_completion(d, max_depth=50.0)
    assert (out > 0).all(), "completion must fill all holes"
    center = out[8:24, 8:24]
    np.testing.assert_allclose(center, 5.0, atol=0.5)


def test_pointcloud_roundtrip(tmp_path, rng):
    from nr3d_lib_tpu.graphics.pointcloud import load_ply, save_ply

    pts = rng.standard_normal((20, 3)).astype(np.float32)
    colors = rng.uniform(0, 1, (20, 3))
    path = str(tmp_path / "test.ply")
    save_ply(path, pts, colors)
    pts2, colors2 = load_ply(path)
    np.testing.assert_allclose(pts2, pts, rtol=1e-4)
    assert colors2 is not None and colors2.shape == (20, 3)


def test_gem_losses():
    from nr3d_lib_tpu.models.loss.gem import gem_density_reg, gem_opacity_loss

    assert float(gem_density_reg(jnp.zeros(8))) == 0.0
    assert float(gem_density_reg(jnp.ones(8))) > 0
    # entropy loss minimal at 0/1 opacity
    bimodal = gem_opacity_loss(jnp.asarray([0.001, 0.999]))
    mid = gem_opacity_loss(jnp.asarray([0.5, 0.5]))
    assert float(bimodal) < float(mid)
    with_gt = gem_opacity_loss(jnp.asarray([0.9, 0.1]), jnp.asarray([1.0, 0.0]))
    assert float(with_gt) < float(gem_opacity_loss(jnp.asarray([0.1, 0.9]),
                                                   jnp.asarray([1.0, 0.0])))


def test_packed_matmul_and_merge_batch(rng):
    from nr3d_lib_tpu.graphics import pack_ops as po

    feats = jnp.asarray(rng.standard_normal((6, 3)).astype(np.float32))
    mats = jnp.asarray(rng.standard_normal((2, 4, 3)).astype(np.float32))
    ridx = jnp.asarray([0, 0, 1, 1, 2, 2], jnp.int32)  # ridx==2 is padding
    out = po.packed_matmul(feats, mats, ridx, 2)
    np.testing.assert_allclose(np.asarray(out[0]),
                               np.asarray(mats[0] @ feats[0]), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(out[2]),
                               np.asarray(mats[1] @ feats[2]), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(out[4:]), 0.0)

    tA = jnp.asarray([[0.0, 2.0], [1.0, 3.0]])
    tB = jnp.asarray([[1.0, 3.0], [0.0, 2.0]])
    vals, key, from_b = po.merge_two_batch(tA, tA, tB, tB)
    np.testing.assert_allclose(np.asarray(key),
                               [[0, 1, 2, 3], [0, 1, 2, 3]])
    np.testing.assert_array_equal(np.asarray(from_b),
                                  [[0, 1, 0, 1], [1, 0, 1, 0]])


def test_auto_ngp4d_cfg_budget_and_axes():
    """4D auto-config (reference lotd_cfg.py:135): stays under the param
    budget (incl. far levels where a naive int64 prod overflows), grows the
    w axis from its own min_res, honors cuboid stretch."""
    import math

    from nr3d_lib_tpu.models.grid_encodings import auto_ngp4d_cfg

    cfg = auto_ngp4d_cfg(1.0, target_num_params=2 ** 20,
                         log2_hashmap_size=14)
    tot = sum((16384 if t == "Hash" else math.prod(r)) * cfg["lod_n_feats"]
              for r, t in zip(cfg["lod_res"], cfg["lod_types"]))
    assert 0 < tot <= 2 ** 20
    assert all(len(r) == 4 for r in cfg["lod_res"])
    assert cfg["lod_types"][0] == "Dense" and cfg["lod_types"][-1] == "Hash"

    cfg2 = auto_ngp4d_cfg([1.0, 2.0, 4.0], min_res_w=8,
                          target_num_params=2 ** 18, log2_hashmap_size=12)
    assert cfg2["lod_res"][0] == [4, 8, 16, 8]
