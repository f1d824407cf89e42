"""Model classes for dynamic / conditional / conditional+dynamic families
(VERDICT round-1 item #4): each has populate / ray_query /
training_before_per_step and supports a smoke train step.

Reference: fields_dynamic/neus/renderer_mixin.py:76,
fields_conditional/neus/renderer_mixin.py:25,
fields_conditional_dynamic/neus/renderer_mixin.py:25,
fields_dynamic/nerf/renderer_mixin.py:23 + emernerf.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from nr3d_lib_tpu import nn

O = jnp.asarray([[-2.0, 0.0, 0.0], [0.0, -2.0, 0.1]])
D = jnp.asarray([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])


def _smoke_train(model, ray_extras, n_steps=3, use_nablas=True):
    graphdef, params, rest = nn.split(model, nn.Param, ...)
    opt = optax.adam(1e-2)
    opt_state = opt.init(params)
    gt = jnp.asarray([[0.3, 0.5, 0.7], [0.7, 0.5, 0.3]])

    @jax.jit
    def step(params, opt_state, key):
        def loss_fn(p):
            m = nn.merge(graphdef, p, rest)
            rt = m.ray_test(O, D)
            rt.update(ray_extras)
            r, vb = m.ray_query(rt, key=key)
            loss = jnp.mean((r["rgb_volume"] - gt) ** 2)
            if use_nablas and vb.get("nablas") is not None:
                loss = loss + 0.01 * jnp.mean(
                    (jnp.linalg.norm(vb["nablas"], axis=-1) - 1.0) ** 2)
            for k, v in vb.items():
                if k.startswith("reg_"):
                    loss = loss + 0.001 * v
            return loss

        loss, g = jax.value_and_grad(loss_fn)(params)
        upd, opt_state2 = opt.update(g, opt_state)
        return optax.apply_updates(params, upd), opt_state2, loss

    losses = []
    for it in range(n_steps):
        m2 = nn.merge(graphdef, params, rest)
        m2.training_before_per_step(it, jax.random.key(50 + it))
        _, _, rest = nn.split(m2, nn.Param, ...)
        params, opt_state, loss = step(params, opt_state, jax.random.key(it))
        losses.append(float(loss))
    assert np.isfinite(losses).all(), losses
    return losses


def test_dynamic_permuto_neus_model():
    from nr3d_lib_tpu.models.model_families import DynamicPermutoNeuSModel

    m = DynamicPermutoNeuSModel(
        field_cfg={"surface_cfg": {
            "permuto_cfg": {"res_list": [4.0, 8.0], "n_feats": 2,
                            "log2_hashmap_size": 10},
            "decoder_cfg": {"D": 1, "W": 16}},
            "radiance_cfg": {"D": 1, "W": 16}},
        accel_cfg={"resolution": (8, 8, 8)}, n_time_keys=4,
        ray_query_cfg={"n_coarse": 16, "upsample_inv_s_factors": [1.0],
                       "n_importance": 4})
    m.populate()
    ts = jnp.asarray([-0.5, 0.5])
    rt = m.ray_test(O, D)
    rt["ts"] = ts
    rendered, vb = m.ray_query(rt, key=jax.random.key(0))
    assert np.isfinite(np.asarray(rendered["rgb_volume"])).all()
    # time conditioning is live: different ts → different render
    rt2 = dict(rt)
    rt2["ts"] = jnp.asarray([0.9, -0.9])
    r2, _ = m.ray_query(rt2, key=jax.random.key(0))
    assert not np.allclose(np.asarray(rendered["rgb_volume"]),
                           np.asarray(r2["rgb_volume"]))
    _smoke_train(m, {"ts": ts})


def test_generative_permuto_neus_model_batched():
    from nr3d_lib_tpu.models.model_families import (
        GenerativePermutoNeuSModelBatched)

    m = GenerativePermutoNeuSModelBatched(
        n_instances=3, latent_dim=2,
        field_cfg={"surface_cfg": {
            "permuto_cfg": {"res_list": [4.0, 8.0], "n_feats": 2,
                            "log2_hashmap_size": 10},
            "decoder_cfg": {"D": 1, "W": 16}},
            "radiance_cfg": {"D": 1, "W": 16}},
        ray_query_cfg={"n_coarse": 16, "upsample_inv_s_factors": [1.0],
                       "n_importance": 4})
    bidx = jnp.asarray([0, 2])
    rt = m.ray_test(O, D)
    rt["bidx"] = bidx
    rendered, vb = m.ray_query(rt, key=jax.random.key(0))
    assert np.isfinite(np.asarray(rendered["rgb_volume"])).all()
    # the batched query must expose nablas for eikonal training
    # (reference fields_conditional/neus/renderer_mixin.py)
    assert vb.get("nablas") is not None \
        and np.isfinite(np.asarray(vb["nablas"])).all()
    losses = _smoke_train(m, {"bidx": bidx})
    # instance latents receive gradient (autodecoder training)
    graphdef, params, _ = nn.split(m, nn.Param, ...)
    leaves = {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path): leaf
              for path, leaf in jax.tree_util.tree_leaves_with_path(params)}
    assert any("latents" in k for k in leaves)


def test_style_lotd_neus_model_batched():
    from nr3d_lib_tpu.models.model_families import StyleLoTDNeuSModelBatched

    m = StyleLoTDNeuSModelBatched(
        n_instances=2, latent_dim=4,
        field_cfg={"surface_cfg": {
            "lotd_cfg": {"lod_res": [6, 10], "lod_n_feats": 2,
                         "lod_types": "Dense"},
            "grower_cfg": {"D": 1, "W": 32},
            "decoder_cfg": {"D": 1, "W": 16}},
            "radiance_cfg": {"D": 1, "W": 16}},
        ray_query_cfg={"n_coarse": 12, "upsample_inv_s_factors": [1.0],
                       "n_importance": 4})
    bidx = jnp.asarray([0, 1])
    rt = m.ray_test(O, D)
    rt["bidx"] = bidx
    rendered, _ = m.ray_query(rt, key=jax.random.key(0))
    assert np.isfinite(np.asarray(rendered["rgb_volume"])).all()


def test_dynamic_generative_neus_model():
    from nr3d_lib_tpu.models.model_families import DynamicGenerativeNeuSModel

    m = DynamicGenerativeNeuSModel(
        n_instances=2, latent_dim=2, latent_std=1.0,
        field_cfg={"surface_cfg": {
            "permuto_cfg": {"res_list": [4.0, 8.0], "n_feats": 2,
                            "log2_hashmap_size": 10},
            "decoder_cfg": {"D": 1, "W": 16}},
            "radiance_cfg": {"D": 1, "W": 16}},
        ray_query_cfg={"n_coarse": 12, "upsample_inv_s_factors": [1.0],
                       "n_importance": 4})
    extras = {"bidx": jnp.asarray([0, 1]), "ts": jnp.asarray([-0.3, 0.6])}
    rt = m.ray_test(O, D)
    rt.update(extras)
    rendered, vb = m.ray_query(rt, key=jax.random.key(0))
    assert np.isfinite(np.asarray(rendered["rgb_volume"])).all()
    # both conditions are live
    rt2 = m.ray_test(O, D)
    rt2.update({"bidx": jnp.asarray([1, 0]), "ts": extras["ts"]})
    r2, _ = m.ray_query(rt2, key=jax.random.key(0))
    assert not np.allclose(np.asarray(rendered["rgb_volume"]),
                           np.asarray(r2["rgb_volume"]))
    rt3 = m.ray_test(O, D)
    rt3.update({"bidx": extras["bidx"], "ts": jnp.asarray([0.9, -0.9])})
    r3, _ = m.ray_query(rt3, key=jax.random.key(0))
    assert not np.allclose(np.asarray(rendered["rgb_volume"]),
                           np.asarray(r3["rgb_volume"]))
    _smoke_train(m, extras)


def test_emernerf_model():
    from nr3d_lib_tpu.models.model_families import EmerNeRFModel

    m = EmerNeRFModel(
        field_cfg={"static_cfg": {"lotd_cfg": {
            "lod_res": [8, 16], "lod_n_feats": 2, "lod_types": "Dense"}},
            "dynamic_permuto_cfg": {"res_list": [4.0, 8.0], "n_feats": 2,
                                    "log2_hashmap_size": 10}},
        accel_cfg={"resolution": (8, 8, 8)}, n_time_keys=4,
        n_march_steps=32)
    m.populate()
    ts = jnp.asarray([-0.5, 0.5])
    rt = m.ray_test(O, D)
    rt["ts"] = ts
    rendered, vb = m.ray_query(rt, key=jax.random.key(0))
    for k in ("rgb_volume", "rgb_static_volume", "rgb_dynamic_volume",
              "depth_volume", "mask_volume"):
        assert k in rendered and np.isfinite(np.asarray(rendered[k])).all()
    for k in ("reg_dynamic_sparsity", "reg_flow_smooth", "reg_flow_cycle",
              "reg_shadow"):
        assert k in vb, k
    losses = _smoke_train(m, {"ts": ts}, use_nablas=False)


def test_emernerf_model_only_dynamic_and_pt_sampling():
    """only_dynamic=True swaps in EmerNeRFOnlyDynamic; the uniform /
    occupied-biased point samplers (reference renderer_mixin.py:569-585)
    return in-range points and respect occupancy."""
    from nr3d_lib_tpu.models.model_families import EmerNeRFModel
    from nr3d_lib_tpu.ops.occgrid_march import occgrid_query

    m = EmerNeRFModel(
        field_cfg={"dynamic_permuto_cfg": {
            "res_list": [4.0, 8.0], "n_feats": 2, "log2_hashmap_size": 10}},
        accel_cfg={"resolution": (8, 8, 8)}, n_time_keys=4,
        n_march_steps=32, only_dynamic=True)
    m.populate()
    rt = m.ray_test(O, D)
    rt["ts"] = jnp.asarray([-0.5, 0.5])
    rendered, vb = m.ray_query(rt, key=jax.random.key(0))
    assert np.isfinite(np.asarray(rendered["rgb_volume"])).all()
    np.testing.assert_allclose(np.asarray(rendered["rgb_volume"]),
                               np.asarray(rendered["rgb_dynamic_volume"]),
                               atol=1e-6)

    x, ts = m.sample_pts_uniform(jax.random.key(1), 64)
    assert x.shape == (64, 3) and ts.shape == (64,)
    assert float(jnp.max(jnp.abs(x))) <= 1.0 and \
        float(jnp.max(jnp.abs(ts))) <= 1.0

    # carve occupancy to one octant and check the biased sampler lands there
    occ_val = np.zeros((8, 8, 8), np.float32)
    occ_val[:4] = 1.0  # x in [-1, 0)
    m.accel.static.val_grid[...] = jnp.asarray(occ_val)
    m.accel.dynamic.occ.val_grid[...] = jnp.zeros_like(
        m.accel.dynamic.occ.val_grid[...])
    xo, tso = m.sample_pts_in_occupied(jax.random.key(2), 128)
    frac_in = float(jnp.mean(occgrid_query(m.accel.static.occ(), xo)))
    assert frac_in > 0.9, frac_in


def test_emernerf_branch_isolated_renders():
    """ray_query_static / ray_query_dynamic (reference renderer_mixin
    :942/:959) composite one branch's density+color only: static+dynamic
    branch opacities each ≤ the full render's, and an only-dynamic model's
    static render is empty."""
    from nr3d_lib_tpu.models.model_families import EmerNeRFModel

    m = EmerNeRFModel(
        field_cfg={"static_cfg": {"lotd_cfg": {
            "lod_res": [8], "lod_n_feats": 2, "lod_types": "Dense"}},
            "dynamic_permuto_cfg": {
                "res_list": [4.0, 8.0], "log2_hashmap_size": 10}},
        accel_cfg={"resolution": (8, 8, 8)}, n_time_keys=4, n_march_steps=32)
    m.populate()
    rt = m.ray_test(O, D)
    rt["ts"] = jnp.asarray([-0.5, 0.5])
    full, _ = m.ray_query(rt, key=jax.random.key(0))
    stat, _ = m.ray_query_static(rt, key=jax.random.key(0))
    dyn, _ = m.ray_query_dynamic(rt, key=jax.random.key(0))
    for r in (full, stat, dyn):
        assert np.isfinite(np.asarray(r["rgb_volume"])).all()
    # one branch's occupancy can't exceed the union's
    assert np.all(np.asarray(stat["mask_volume"])
                  <= np.asarray(full["mask_volume"]) + 1e-5)
    assert np.all(np.asarray(dyn["mask_volume"])
                  <= np.asarray(full["mask_volume"]) + 1e-5)

    m2 = EmerNeRFModel(
        field_cfg={"dynamic_permuto_cfg": {
            "res_list": [4.0, 8.0], "log2_hashmap_size": 10}},
        accel_cfg={"resolution": (8, 8, 8)}, n_time_keys=4,
        n_march_steps=32, only_dynamic=True)
    m2.populate()
    stat2, _ = m2.ray_query_static(rt, key=jax.random.key(0))
    assert float(jnp.max(stat2["mask_volume"])) == 0.0


def test_lotd_neus_model_brick_backend_train_step():
    """LoTDNeuSModel with the brick encoding backend: full ray_query +
    eikonal train step (second order through the brick encode) with finite
    loss and nonzero encoding grads."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from nr3d_lib_tpu import nn

    from nr3d_lib_tpu.models.model_base import LoTDNeuSModel

    m = LoTDNeuSModel(
        field_cfg={"surface_cfg": {
            "encoding_cfg": {
                "backend": "brick",
                "lotd_cfg": {"lod_res": [8, 16], "lod_n_feats": 2,
                             "lod_types": ["Dense", "Hash"]},
                "hashmap_rows": 256},
            "decoder_cfg": {"D": 1, "W": 16}},
            "radiance_cfg": {"D": 1, "W": 16}},
        accel_cfg={"resolution": 16, "max_steps_per_ray": 24,
                   "step_size": 2 / 24},
        ray_query_cfg={"query_mode": "coarse_multi_upsample", "n_coarse": 16,
                       "upsample_inv_s_factors": [1.0], "n_importance": 8})
    m.populate()
    from nr3d_lib_tpu.models.grid_encodings.lotd import LoTDBrickEncoding

    assert isinstance(m.field.implicit_surface.encoding, LoTDBrickEncoding)

    n = 8
    k = jax.random.key(0)
    o = jax.random.normal(k, (n, 3))
    o = o / jnp.linalg.norm(o, -1, keepdims=True) * 2.0
    d = -o
    rt = m.space.ray_test(o, d)
    graphdef, params, rest = nn.split(m, nn.Param, ...)

    def loss_fn(p):
        mm = nn.merge(graphdef, p, rest)
        rendered, vb = mm.ray_query(rt, key=jax.random.key(1))
        eik = ((jnp.linalg.norm(vb["nablas"], axis=-1) - 1.0) ** 2
               * vb["vw"]).sum() / jnp.maximum(vb["vw"].sum(), 1e-6)
        return jnp.mean(rendered["rgb_volume"] ** 2) + 0.1 * eik

    l, g = jax.value_and_grad(loss_fn)(params)
    assert np.isfinite(float(l))
    leaves = {jax.tree_util.keystr(k_): v for k_, v in
              jax.tree_util.tree_leaves_with_path(g)}
    enc = [v for k_, v in leaves.items() if "flattened_params" in k_]
    assert enc and all(np.isfinite(np.asarray(v)).all() for v in enc)
    assert any(float(jnp.sum(jnp.abs(v))) > 0 for v in enc)
