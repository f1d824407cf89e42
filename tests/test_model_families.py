"""Tests: forest, conditional (generative/style), dynamic (incl EmerNeRF),
distant-background model families."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest


def test_forest_space_population_and_mapping(rng):
    from nr3d_lib_tpu.models.spatial.forest import ForestBlockSpace

    sp = ForestBlockSpace(resolution=(4, 4, 4), origin=(-1, -1, -1),
                          block_size=0.5)
    sp.populate_from_corners([[0, 0, 0], [1, 1, 1], [3, 3, 3]])
    assert sp.n_trees == 3
    # point in block (1,1,1): world [-0.5,0)³ + ... block (1,1,1) spans
    # [-0.5, 0)^3
    slot = sp.block_of_points(jnp.asarray([[-0.25, -0.25, -0.25],
                                           [0.9, 0.9, 0.9],
                                           [0.2, 0.2, 0.2]]))
    s = np.asarray(slot)
    assert s[0] == 1 and s[1] == 2 and s[2] == -1  # block (2,2,2) not occupied
    # local coords roundtrip: center of block → 0
    x = jnp.asarray([[-0.25, -0.25, -0.25]])
    loc = sp.normalize_coords(x, jnp.asarray([1]))
    np.testing.assert_allclose(np.asarray(loc), 0.0, atol=1e-6)

    sp2 = ForestBlockSpace(resolution=(4, 4, 4), origin=(-1, -1, -1),
                           block_size=0.5)
    sp2.populate_from_points(rng.uniform(-1, 1, (100, 3)))
    assert sp2.n_trees > 10


def test_forest_ray_march_blocks():
    from nr3d_lib_tpu.models.spatial.forest import ForestBlockSpace

    sp = ForestBlockSpace(resolution=(4, 1, 1), origin=(-1, 0, 0),
                          block_size=0.5)
    sp.populate_from_corners([[0, 0, 0], [2, 0, 0]])  # x∈[-1,-.5] and [0,.5]
    o = jnp.asarray([[-2.0, 0.25, 0.25]])
    d = jnp.asarray([[1.0, 0.0, 0.0]])
    rt = sp.ray_test(o, d)
    assert bool(rt["mask"][0])
    t, dt, bidx, mask = sp.ray_march_blocks(o, d, rt["near"], rt["far"],
                                            n_steps=64, step_size=2 / 64)
    xs = np.asarray(o[0, 0] + t[0])
    m = np.asarray(mask[0])
    b = np.asarray(bidx[0])
    # samples in [-1,-0.5] → block 0; [0,0.5] → block 1; between → masked out
    in_b0 = (xs > -0.99) & (xs < -0.51)
    in_gap = (xs > -0.45) & (xs < -0.05)
    assert m[in_b0].all() and (b[in_b0] == 0).all()
    assert not m[in_gap].any()


def test_forest_neus_model_query_and_grads():
    from nr3d_lib_tpu.models.fields_forest import LoTDForestNeuSModel
    from nr3d_lib_tpu import nn

    model = LoTDForestNeuSModel(
        space_cfg={"resolution": (2, 2, 2), "origin": (-1, -1, -1),
                   "block_size": 1.0},
        field_cfg={"surface_cfg": {
            "lotd_cfg": {"lod_res": [6], "lod_n_feats": 2, "lod_types": "Dense"},
            "decoder_cfg": {"D": 1, "W": 16}},
            "radiance_cfg": {"D": 1, "W": 16}},
        n_march_steps=48)
    o = jnp.asarray([[-2.0, 0.1, 0.1], [2.0, 0.3, -0.2]])
    d = jnp.asarray([[1.0, 0.0, 0.0], [-1.0, 0.0, 0.0]])
    rt = model.ray_test(o, d)
    rendered, vb = model.ray_query(rt, key=jax.random.key(0))
    assert np.isfinite(np.asarray(rendered["rgb_volume"])).all()
    assert rendered["rgb_volume"].shape == (2, 3)

    # per-block params get gradients
    graphdef, params, rest = nn.split(model, nn.Param, ...)

    def loss(p):
        m = nn.merge(graphdef, p, rest)
        r, _ = m.ray_query(m.ray_test(o, d), key=jax.random.key(0))
        return jnp.sum(r["rgb_volume"] ** 2)

    g = jax.grad(loss)(params)
    leaves = {"/".join(str(getattr(pp, "key", getattr(pp, "idx", pp)))
                       for pp in path): leaf
              for path, leaf in jax.tree_util.tree_leaves_with_path(g)}
    enc_g = [v for k, v in leaves.items() if "flattened_params" in k][0]
    assert float(jnp.abs(enc_g).max()) > 0


def test_generative_permuto_sdf(rng):
    from nr3d_lib_tpu.models.fields_conditional import GenerativePermutoConcatNeuS

    model = GenerativePermutoConcatNeuS(
        z_dim=2, surface_cfg={"permuto_cfg": {"res_list": [4.0, 8.0],
                                              "log2_hashmap_size": 10},
                              "decoder_cfg": {"D": 1, "W": 16}},
        radiance_cfg={"D": 1, "W": 16})
    x = jnp.asarray(rng.uniform(-0.9, 0.9, (16, 3)).astype(np.float32))
    v = jnp.asarray(rng.standard_normal((16, 3)).astype(np.float32))
    z1 = jnp.zeros((2,), jnp.float32)
    z2 = jnp.ones((2,), jnp.float32)
    o1 = model(x, v, z1)
    o2 = model(x, v, z2)
    assert o1["sdf"].shape == (16,)
    assert not np.allclose(np.asarray(o1["sdf"]), np.asarray(o2["sdf"])), \
        "latent must condition the SDF"
    assert np.isfinite(np.asarray(o1["nablas"])).all()


def test_style_lotd_sdf_grower(rng):
    from nr3d_lib_tpu.models.fields_conditional import StyleLoTDSDF

    sdf = StyleLoTDSDF(z_dim=8, lotd_cfg={"lod_res": [6], "lod_n_feats": 2,
                                          "lod_types": "Dense"},
                       grower_cfg={"D": 1, "W": 32},
                       decoder_cfg={"D": 1, "W": 16})
    x = jnp.asarray(rng.uniform(-0.9, 0.9, (12, 3)).astype(np.float32))
    z = jnp.asarray(rng.standard_normal((2, 8)).astype(np.float32))
    bidx = jnp.asarray([0, 1] * 6, jnp.int32)
    out = sdf.forward_sdf(x, z, bidx)
    assert out["sdf"].shape == (12,)
    # instances differ
    out0 = sdf.forward_sdf(x, z, jnp.zeros(12, jnp.int32))
    out1 = sdf.forward_sdf(x, z, jnp.ones(12, jnp.int32))
    assert not np.allclose(np.asarray(out0["sdf"]), np.asarray(out1["sdf"]))


def test_dynamic_permuto_neus(rng):
    from nr3d_lib_tpu.models.fields_dynamic import DynamicPermutoConcatNeuS

    model = DynamicPermutoConcatNeuS(
        surface_cfg={"permuto_cfg": {"res_list": [4.0, 8.0],
                                     "log2_hashmap_size": 10},
                     "decoder_cfg": {"D": 1, "W": 16}},
        radiance_cfg={"D": 1, "W": 16})
    x = jnp.asarray(rng.uniform(-0.9, 0.9, (8, 3)).astype(np.float32))
    v = jnp.asarray(rng.standard_normal((8, 3)).astype(np.float32))
    o_t0 = model(x, v, jnp.zeros(8))
    o_t1 = model(x, v, jnp.full((8,), 0.7))
    assert not np.allclose(np.asarray(o_t0["sdf"]), np.asarray(o_t1["sdf"])), \
        "time must condition the SDF"


def test_emernerf(rng):
    from nr3d_lib_tpu.models.fields_dynamic import EmerNeRF

    model = EmerNeRF(static_cfg={"lotd_cfg": {
        "lod_res": [8], "lod_n_feats": 2, "lod_types": "Dense"}},
        dynamic_permuto_cfg={"res_list": [4.0, 8.0], "log2_hashmap_size": 10})
    x = jnp.asarray(rng.uniform(-0.9, 0.9, (8, 3)).astype(np.float32))
    v = jnp.asarray(rng.standard_normal((8, 3)).astype(np.float32))
    out = model(x, v, jnp.zeros(8))
    for k in ["sigma", "sigma_static", "sigma_dynamic", "rgb", "rgb_static",
              "rgb_dynamic", "flow_fwd", "flow_bwd", "shadow"]:
        assert k in out, f"missing {k}"
    np.testing.assert_allclose(
        np.asarray(out["sigma"]),
        np.asarray(out["sigma_static"] + out["sigma_dynamic"]), rtol=1e-6)
    out_t1 = model(x, v, jnp.full((8,), 0.9))
    assert not np.allclose(np.asarray(out["sigma_dynamic"]),
                           np.asarray(out_t1["sigma_dynamic"]))


def test_emernerf_temporal_aggregation_and_cycle(rng):
    """Flow-warped 3-frame feature aggregation (reference emernerf.py:
    284-316) + cycle-consistency outputs and loss."""
    from nr3d_lib_tpu.models.fields_dynamic import (EmerNeRF,
                                                    emernerf_cycle_loss)

    kw = dict(static_cfg={"lotd_cfg": {
        "lod_res": [8], "lod_n_feats": 2, "lod_types": "Dense"}},
        dynamic_permuto_cfg={"res_list": [4.0, 8.0], "log2_hashmap_size": 10})
    model = EmerNeRF(temporal_aggregation=True, dt=0.05, **kw)
    x = jnp.asarray(rng.uniform(-0.9, 0.9, (8, 3)).astype(np.float32))
    v = jnp.asarray(rng.standard_normal((8, 3)).astype(np.float32))
    ts = jnp.zeros(8)

    out = model(x, v, ts)                       # eval: warp by exactly ±dt
    for k in ["flow_fwd", "flow_bwd", "flow_fwd_pred_bwd",
              "flow_bwd_pred_fwd"]:
        assert k in out and np.isfinite(np.asarray(out[k])).all(), k
    c = emernerf_cycle_loss(out)
    assert np.isfinite(float(c)) and float(c) >= 0

    # training mode (key given): noise changes the warp
    out_tr = model(x, v, ts, key=jax.random.key(3))
    assert np.isfinite(np.asarray(out_tr["sigma"])).all()

    # aggregation off → plain single-frame path, flow still reported
    model0 = EmerNeRF(temporal_aggregation=False, **kw)
    out0 = model0(x, v, ts)
    assert "flow_fwd" in out0 and "flow_fwd_pred_bwd" not in out0

    # cycle loss is differentiable wrt params
    from nr3d_lib_tpu import nn

    graphdef, params, rest = nn.split(model, nn.Param, ...)

    def loss(p):
        m = nn.merge(graphdef, p, rest)
        return emernerf_cycle_loss(m(x, v, ts, with_rgb=False))

    g = jax.grad(loss)(params)
    gn = float(sum(jnp.sum(l ** 2) for l in jax.tree_util.tree_leaves(g)))
    assert np.isfinite(gn)


def test_emernerf_only_dynamic(rng):
    """No-static-branch variant (reference emernerf.py:974
    EmerNeRFOnlyDynamic): same output contract, sigma == sigma_dynamic,
    flow + temporal aggregation + weight reg all functional."""
    from nr3d_lib_tpu.models.fields_dynamic import (EmerNeRFOnlyDynamic,
                                                    emernerf_cycle_loss)

    model = EmerNeRFOnlyDynamic(
        dynamic_permuto_cfg={"res_list": [4.0, 8.0], "log2_hashmap_size": 10},
        temporal_aggregation=True, dt=0.05)
    x = jnp.asarray(rng.uniform(-0.9, 0.9, (8, 3)).astype(np.float32))
    v = jnp.asarray(rng.standard_normal((8, 3)).astype(np.float32))
    out = model(x, v, jnp.zeros(8))
    for k in ["sigma", "sigma_static", "sigma_dynamic", "rgb", "rgb_static",
              "rgb_dynamic", "flow_fwd", "flow_bwd", "flow_fwd_pred_bwd"]:
        assert k in out, f"missing {k}"
    np.testing.assert_allclose(np.asarray(out["sigma"]),
                               np.asarray(out["sigma_dynamic"]), rtol=1e-6)
    assert float(jnp.max(jnp.abs(out["sigma_static"]))) == 0.0
    assert not np.allclose(
        np.asarray(out["sigma"]),
        np.asarray(model(x, v, jnp.full((8,), 0.9))["sigma"]))
    c = emernerf_cycle_loss(out)
    assert np.isfinite(float(c)) and float(c) >= 0
    wr = model.get_weight_reg()
    assert wr.ndim == 1 and np.isfinite(np.asarray(wr)).all()


def test_mlp_weight_reg(rng):
    """MLP.get_weight_reg (reference blocks.py get_weight_reg): one norm per
    layer, matches a hand computation, and EmerNeRF concatenates its
    decoders'."""
    from nr3d_lib_tpu.models.blocks import MLP
    from nr3d_lib_tpu.models.fields_dynamic import EmerNeRF

    mlp = MLP(4, 3, D=2, W=8, seed=0)
    wr = mlp.get_weight_reg(2.0)
    assert wr.shape == (len(mlp.ws),)
    np.testing.assert_allclose(
        float(wr[0]), float(jnp.sqrt(jnp.sum(mlp.ws[0][...] ** 2))),
        rtol=1e-6)
    wr1 = mlp.get_weight_reg(1.0)
    np.testing.assert_allclose(float(wr1[0]),
                               float(jnp.sum(jnp.abs(mlp.ws[0][...]))),
                               rtol=1e-6)
    em = EmerNeRF(static_cfg={"lotd_cfg": {
        "lod_res": [8], "lod_n_feats": 2, "lod_types": "Dense"}},
        dynamic_permuto_cfg={"res_list": [4.0], "log2_hashmap_size": 10})
    assert em.get_weight_reg().ndim == 1


def test_nerf_distant(rng):
    from nr3d_lib_tpu.models.fields_distant import (NeRFDistant,
                                                    nerf_distant_ray_query)

    model = NeRFDistant(D=1, W=16, radiance_cfg={"D": 1, "W": 16})
    o = jnp.asarray(rng.standard_normal((4, 3)).astype(np.float32)) * 0.1
    d = jnp.asarray(rng.standard_normal((4, 3)).astype(np.float32))
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    far_inner = jnp.ones(4)
    rendered, vb = nerf_distant_ray_query(model, o, d, far_inner, n_samples=16)
    assert rendered["rgb_volume"].shape == (4, 3)
    assert np.isfinite(np.asarray(rendered["rgb_volume"])).all()
    t = np.asarray(vb["t"])
    assert (np.diff(t, axis=-1) >= -1e-5).all(), "samples must march outward"
    assert (t >= 0.999).all()


def test_permuto_static_field_family():
    """Static permuto variants (reference: fields/sdf/permuto_sdf.py,
    fields/nerf/permuto_nerf.py, fields/neus/permuto_neus.py)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from nr3d_lib_tpu import nn

    from nr3d_lib_tpu.models.fields import PermutoNeRF, PermutoNeuS, PermutoSDF

    x = jax.random.uniform(jax.random.key(0), (16, 3), minval=-1, maxval=1)
    v = jax.random.normal(jax.random.key(1), (16, 3))
    pcfg = {"res_list": [4.0, 8.0], "log2_hashmap_size": 10}

    f = PermutoNeRF(permuto_cfg=pcfg, density_decoder_cfg={"D": 1, "W": 16},
                    radiance_cfg={"D": 1, "W": 16})
    o = f(x, v)
    assert o["rgb"].shape == (16, 3)
    assert np.isfinite(np.asarray(o["sigma"])).all()

    s = PermutoSDF(permuto_cfg=pcfg, decoder_cfg={"D": 1, "W": 16},
                   radius_init=0.5)
    out = s.forward_sdf_nablas(x)
    assert np.isfinite(np.asarray(out["nablas"])).all()
    # sphere residual: sdf sign flips across the radius on-axis
    probe = jnp.asarray([[0.1, 0, 0], [0.9, 0, 0]])
    sd = np.asarray(s.forward_sdf(probe)["sdf"])
    assert sd[0] < 0 < sd[1]

    m = PermutoNeuS(surface_cfg={"permuto_cfg": pcfg,
                                 "decoder_cfg": {"D": 1, "W": 16},
                                 "radius_init": 0.5},
                    radiance_cfg={"D": 1, "W": 16})
    graphdef, params, rest = nn.split(m, nn.Param, ...)

    def loss(p):
        mm = nn.merge(graphdef, p, rest)
        o = mm.implicit_surface.forward_sdf_nablas(x)
        return jnp.mean((jnp.linalg.norm(o["nablas"], axis=-1) - 1.0) ** 2)

    g = jax.grad(loss)(params)   # eikonal → 2nd-order autodiff
    gn = float(jnp.sqrt(sum(jnp.sum(l ** 2)
                            for l in jax.tree_util.tree_leaves(g))))
    assert np.isfinite(gn) and gn > 0


def test_nerf_distant_model_modes():
    """NeRFDistantModel: both interval types x sample modes render finite,
    shells ascend, and fg/bg compositing conserves energy (reference:
    fields_distant/nerf/renderer_mixin.py:87-383)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from nr3d_lib_tpu.models.fields_distant import (NeRFDistantModel,
                                                    composite_inner_distant)

    o = jnp.asarray([[0.1, 0.0, 0.0]] * 3)
    d = jnp.asarray([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                     [0.0, 0.0, 1.0]])
    for interval in ("inverse_proportional", "logarithm"):
        for mode in ("spherical", "lindisp"):
            m = NeRFDistantModel(interval_type=interval, sample_mode=mode,
                                 radius_scale_max=100.0, n_samples=16,
                                 field_cfg={"D": 1, "W": 16})
            rt = m.ray_test(o, d)
            assert bool(rt["mask"].all())
            # near = inner-sphere exit ≈ 1 - small offset along x for ray 0
            rendered, vb = m.ray_query(rt, key=jax.random.key(0))
            assert np.isfinite(np.asarray(rendered["rgb_volume"])).all()
            t = np.asarray(vb["t"])
            assert (np.diff(t, axis=-1) >= -1e-4).all(), (interval, mode)
            assert (t >= np.asarray(rt["near"])[:, None] - 1e-4).all()

    # compositing: opaque foreground hides bg; transparent shows it
    fg = {"rgb_volume": jnp.asarray([[1.0, 0, 0], [0.0, 0, 0]]),
          "mask_volume": jnp.asarray([1.0, 0.0])}
    bg = {"rgb_volume": jnp.asarray([[0.0, 1.0, 0], [0.0, 1.0, 0]]),
          "mask_volume": jnp.asarray([1.0, 1.0])}
    out = composite_inner_distant(fg, bg)
    assert np.allclose(np.asarray(out["rgb_volume"]),
                       [[1, 0, 0], [0, 1, 0]])
    assert np.allclose(np.asarray(out["mask_volume"]), [1.0, 1.0])
