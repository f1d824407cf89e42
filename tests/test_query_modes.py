"""Round-2 query-mode dispatch: compressed NeRF/NeuS and sphere-trace NeuS.

Reference behaviors: nerf_ray_query.py:190 (compressed), neus_ray_query.py:41
(sphere_trace strategy), :732 (compressed NeuS) — here validated as
parity-with-uncompressed and trace-vs-volumetric-depth agreement.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from nr3d_lib_tpu import nn


def _nerf_model(query_cfg):
    from nr3d_lib_tpu.models.model_base import LoTDNeRFModel

    return LoTDNeRFModel(
        field_cfg={"encoding_cfg": {"lotd_cfg": {
            "lod_res": [8, 16], "lod_n_feats": 2, "lod_types": "Dense"}},
            "density_decoder_cfg": {"D": 1, "W": 16},
            "radiance_cfg": {"D": 1, "W": 16}},
        accel_cfg={"resolution": 16, "max_steps_per_ray": 64,
                   "step_size": 2 / 32},
        ray_query_cfg=query_cfg, seed=3)


def test_nerf_compressed_matches_uncompressed():
    m_plain = _nerf_model({"query_mode": "march_occ"})
    m_comp = _nerf_model({"query_mode": "march_occ_compressed",
                          "compression_factor": 1.0,
                          "radiance_compression_factor": 1.0,
                          "early_stop_eps": 0.0})
    m_plain.populate()
    m_comp.populate()
    # same params by construction (same seed)
    o = jnp.asarray([[-2.0, 0.0, 0.0], [0.0, -3.0, 0.5], [0.3, 2.5, -0.2]])
    d = jnp.asarray([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [-0.1, -1.0, 0.05]])
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    rt = m_plain.ray_test(o, d)
    r0, _ = m_plain.ray_query(rt)
    r1, vb1 = m_comp.ray_query(rt)
    # with full capacity and eps=0 compression must be exact (same samples)
    np.testing.assert_allclose(np.asarray(r0["rgb_volume"]),
                               np.asarray(r1["rgb_volume"]), atol=2e-5)
    np.testing.assert_allclose(np.asarray(r0["depth_volume"]),
                               np.asarray(r1["depth_volume"]), atol=2e-4)
    np.testing.assert_allclose(np.asarray(r0["mask_volume"]),
                               np.asarray(r1["mask_volume"]), atol=2e-5)
    assert int(vb1["n_compact"]) > 0


def test_nerf_compressed_grad_flows():
    m = _nerf_model({"query_mode": "march_occ_compressed",
                     "compression_factor": 0.5})
    m.populate()
    graphdef, params, rest = nn.split(m, nn.Param, ...)
    o = jnp.asarray([[-2.0, 0.0, 0.0], [0.0, -2.0, 0.1]])
    d = jnp.asarray([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])

    def loss_fn(p):
        mm = nn.merge(graphdef, p, rest)
        rendered, _ = mm.ray_query(mm.ray_test(o, d))
        return jnp.mean(rendered["rgb_volume"] ** 2) + \
            jnp.mean(rendered["depth_volume"] ** 2)

    loss, g = jax.value_and_grad(loss_fn)(params)
    assert np.isfinite(float(loss))
    gnorm = float(jnp.sqrt(sum(jnp.sum(l ** 2)
                               for l in jax.tree_util.tree_leaves(g))))
    assert np.isfinite(gnorm) and gnorm > 0


def _neus_sphere_model(query_cfg):
    from nr3d_lib_tpu.models.fields.sdf import pretrain_sdf_sphere
    from nr3d_lib_tpu.models.model_base import LoTDNeuSModel

    model = LoTDNeuSModel(
        field_cfg={"surface_cfg": {
            "encoding_cfg": {"lotd_cfg": {
                "lod_res": [8, 16, 32], "lod_n_feats": 2,
                "lod_types": "Dense"}},
            "decoder_cfg": {"D": 1, "W": 32}},
            "radiance_cfg": {"D": 1, "W": 16},
            "var_ctrl_cfg": {"type": "learned", "init_val": 256.0}},
        accel_cfg={"resolution": 16, "max_steps_per_ray": 64,
                   "step_size": 2 / 32},
        ray_query_cfg=query_cfg)
    pretrain_sdf_sphere(model.field.implicit_surface, jax.random.key(0),
                        radius=0.5, n_iters=400)
    model.populate()
    return model


@pytest.fixture(scope="module")
def neus_sphere_models():
    m_st = _neus_sphere_model({"query_mode": "sphere_trace", "n_band": 24,
                               "n_tail": 8})
    return m_st


def test_neus_sphere_trace_query(neus_sphere_models):
    m = neus_sphere_models
    # rays that hit the r=0.5 sphere head-on, plus one miss
    o = jnp.asarray([[-2.0, 0.0, 0.0], [0.0, -2.0, 0.0], [2.0, 2.0, 2.0],
                     [-2.0, 0.9, 0.0]])
    d = jnp.asarray([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                     [-0.5774, -0.5774, -0.5774], [1.0, 0.0, 0.0]])
    rt = m.ray_test(o, d)
    rendered, vb = m.ray_query(rt)
    hit = np.asarray(vb["hit"])
    assert hit[:3].all() and not hit[3]
    # analytic hit depths: 1.5, 1.5, sqrt(12)-0.5
    t_exp = np.asarray([1.5, 1.5, np.sqrt(12.0) - 0.5])
    np.testing.assert_allclose(np.asarray(vb["t_hit"])[:3], t_exp, atol=0.06)
    # volumetric depth should agree with trace depth in the band
    d_vol = np.asarray(rendered["depth_volume"])[:3]
    np.testing.assert_allclose(d_vol, t_exp, atol=0.08)
    assert np.asarray(rendered["mask_volume"])[:3].min() > 0.5
    assert np.asarray(rendered["mask_volume"])[3] < 1e-3


def test_neus_sphere_trace_vs_march_occ(neus_sphere_models):
    m = neus_sphere_models
    o = jnp.asarray([[-2.0, 0.3, 0.1], [0.0, -2.0, -0.2]])
    d = o / jnp.linalg.norm(o, axis=-1, keepdims=True) * -1.0
    rt = m.ray_test(o, d)
    r_st, _ = m.ray_query(rt)

    # the populate-time occ band at inv_s=256 is razor-thin; give the marcher
    # full occupancy so the comparison isolates the query strategies
    m.accel.occ.val_grid[...] = jnp.ones_like(m.accel.occ.val_grid[...])
    m.ray_query_cfg = {"query_mode": "march_occ_multi_upsample",
                       "upsample_inv_s_factors": [1.0, 4.0],
                       "n_importance": 16}
    r_mo, _ = m.ray_query(rt)
    np.testing.assert_allclose(np.asarray(r_st["depth_volume"]),
                               np.asarray(r_mo["depth_volume"]), atol=0.1)
    # restore
    m.ray_query_cfg = {"query_mode": "sphere_trace", "n_band": 24, "n_tail": 8}


def test_neus_compressed_dispatch():
    from nr3d_lib_tpu.models.model_base import LoTDNeuSModel

    m = LoTDNeuSModel(
        field_cfg={"surface_cfg": {
            "encoding_cfg": {"lotd_cfg": {
                "lod_res": [8, 16], "lod_n_feats": 2, "lod_types": "Dense"}},
            "decoder_cfg": {"D": 1, "W": 16}},
            "radiance_cfg": {"D": 1, "W": 16}},
        accel_cfg={"resolution": 16, "max_steps_per_ray": 48,
                   "step_size": 2 / 24},
        ray_query_cfg={"query_mode": "march_occ_multi_upsample_compressed",
                       "upsample_inv_s_factors": [1.0, 4.0],
                       "n_importance": 8, "compression_factor": 0.5})
    m.populate()
    o = jnp.asarray([[-2.0, 0.0, 0.0], [0.0, -2.0, 0.1]])
    d = jnp.asarray([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    rendered, vb = m.ray_query(m.ray_test(o, d), key=jax.random.key(0))
    assert np.isfinite(np.asarray(rendered["rgb_volume"])).all()
    assert "t_packed" in vb


def test_neus_compressed_default_keeps_far_occupied():
    """ADVICE r3 (high): the march-budget compaction must be OPT-IN.
    A surface in the FAR half of the ray, fully-occupied fresh grid: with
    the default (march_budget_factor=1.0) it renders; with 0.5 the far half
    of the marched slab is truncated and the surface vanishes — the old
    default silently broke early training whenever occupancy > 50%."""
    from nr3d_lib_tpu.graphics.neus_ray_query_variants import (
        neus_ray_query_march_occ_multi_upsample_compressed)
    from nr3d_lib_tpu.models.model_base import LoTDNeuSModel

    m = LoTDNeuSModel(
        field_cfg={"surface_cfg": {
            "encoding_cfg": {"lotd_cfg": {
                "lod_res": [8, 16], "lod_n_feats": 2, "lod_types": "Dense"}},
            "decoder_cfg": {"D": 1, "W": 16}},
            "radiance_cfg": {"D": 1, "W": 16}},
        accel_cfg={"resolution": 16, "max_steps_per_ray": 48,
                   "step_size": 2 / 24})
    m.populate()
    # fresh grid: fully occupied (occgrid.py init) — the regime the bug bit
    assert float(jnp.min(m.accel.occ.val_grid[...])) > 0.0

    center = jnp.asarray([0.7, 0.0, 0.0])   # sphere deep in the far half

    class _Stub:
        def forward_sdf(self, x):
            return {"sdf": jnp.linalg.norm(x - center, axis=-1) - 0.15}

        def forward_inv_s(self):
            return jnp.asarray(256.0)

        def __call__(self, x, v, with_rgb=True, with_nablas=True):
            d = x - center
            n = d / jnp.maximum(jnp.linalg.norm(d, axis=-1, keepdims=True),
                                1e-9)
            out = {"sdf": jnp.linalg.norm(d, axis=-1) - 0.15, "nablas": n}
            if with_rgb:
                out["rgb"] = jnp.ones_like(x) * 0.5
            return out

    o = jnp.asarray([[-2.0, 0.0, 0.0]])
    d = jnp.asarray([[1.0, 0.0, 0.0]])
    rt = m.ray_test(o, d)
    kw = dict(upsample_inv_s_factors=[1.0], n_importance=8,
              compression_factor=0.5)
    r_def, _ = neus_ray_query_march_occ_multi_upsample_compressed(
        _Stub(), m.accel, m.space, rt, **kw)
    # this ray occupies 24 of the 48 slab slots; budget 0.25*48=12 keeps
    # only the near half of them — the surface at t=2.55 falls past it
    r_half, _ = neus_ray_query_march_occ_multi_upsample_compressed(
        _Stub(), m.accel, m.space, rt, march_budget_factor=0.25, **kw)
    acc_def = float(np.asarray(r_def["mask_volume"])[0])
    acc_half = float(np.asarray(r_half["mask_volume"])[0])
    dep_def = float(np.asarray(r_def["depth_volume"])[0])
    assert acc_def > 0.9, acc_def                      # surface rendered
    assert abs(dep_def - 2.55) < 0.1, dep_def          # at the right depth
    assert acc_half < 0.1, acc_half                    # truncation documented


class _SlabScene:
    """Duck-typed NeRF 'model': an analytic thin density slab at x=0.2
    (thickness 0.02 in normalized coords) — the structure a coarse march
    step cannot resolve without PDF upsampling."""

    def forward_density(self, x):
        # ∫σ ≈ 1 across the slab: a coarse step that lands one sample in
        # the slab integrates σ·dt ≈ 50/12 ≫ 1 (mask overestimated); only
        # clustered fine samples recover the true optical depth
        sigma = jnp.where(jnp.abs(x[:, 0] - 0.2) < 0.01, 50.0, 0.0)
        return {"sigma": sigma, "h": jnp.zeros((x.shape[0], 4))}

    def radiance(self, x, v, n, h):
        return jnp.broadcast_to(jnp.asarray([1.0, 0.5, 0.25]),
                                (x.shape[0], 3))


def test_nerf_multi_upsample_resolves_thin_structure():
    """The PDF upsample round (reference nerf_ray_query.py:190) must place
    samples ON the thin slab and estimate depth closer to the 512-sample
    oracle than the plain compressed path at an equal final budget."""
    from nr3d_lib_tpu.graphics.nerf_ray_query import (
        nerf_ray_query_fixed, nerf_ray_query_march_occ_compressed,
        nerf_ray_query_march_occ_multi_upsample_compressed)
    from nr3d_lib_tpu.models.accelerations.occgrid_accel import OccGridAccel
    from nr3d_lib_tpu.models.spatial.aabb import AABBSpace

    model = _SlabScene()
    space = AABBSpace()
    accel = OccGridAccel(resolution=8, step_size=2 / 24,
                         max_steps_per_ray=32)
    accel.occ.val_grid[...] = jnp.ones_like(accel.occ.val_grid[...])

    o = jnp.asarray([[-2.0, 0.1, 0.0], [-2.0, -0.3, 0.2],
                     [-2.0, 0.4, -0.4]])
    d = jnp.asarray([[1.0, 0.0, 0.0]] * 3)
    rt = space.ray_test(o, d)

    r_oracle, _ = nerf_ray_query_fixed(model, space, rt, n_samples=512)
    # plain compressed: budget 32 (all marched samples survive — no
    # upsample round); multi-upsample: SAME march, 16 fine samples merged
    r_comp, vb_c = nerf_ray_query_march_occ_compressed(
        model, accel, space, rt, compression_factor=1.0,
        radiance_compression_factor=1.0, early_stop_eps=0.0)
    r_mu, vb_m = nerf_ray_query_march_occ_multi_upsample_compressed(
        model, accel, space, rt, compression_factor=1.0, n_fine=16,
        radiance_compression_factor=1.0, early_stop_eps=0.0)

    # fine samples concentrate on the slab: the multi-upsample buffer has
    # strictly more samples inside |x-0.2|<0.02 than the compressed one
    def on_slab(vb):
        x = o[:, None, 0] + vb["t"] * d[:, None, 0]
        return int(jnp.sum(vb["valid"] & (jnp.abs(x - 0.2) < 0.02)))

    assert on_slab(vb_m) > on_slab(vb_c)

    # and the rendered depth lands much closer to the oracle (mask is
    # overestimated by BOTH at coarse dt — the left-Riemann tail term,
    # same as the reference's packed_diff deltas — so depth is the
    # discriminating metric: measured 9× tighter with the upsample round)
    err = {}
    for name, r in (("comp", r_comp), ("mu", r_mu)):
        err[name] = float(jnp.max(jnp.abs(r["depth_volume"]
                                          - r_oracle["depth_volume"])))
    assert err["mu"] < 0.5 * err["comp"]


def test_nerf_multi_upsample_dispatch_and_grads():
    m = _nerf_model({"query_mode": "march_occ_multi_upsample_compressed",
                     "compression_factor": 0.5, "n_fine": 8})
    m.populate()
    graphdef, params, rest = nn.split(m, nn.Param, ...)
    o = jnp.asarray([[-2.0, 0.0, 0.0], [0.0, -2.0, 0.1]])
    d = jnp.asarray([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])

    def loss_fn(p):
        mm = nn.merge(graphdef, p, rest)
        r, _ = mm.ray_query(mm.ray_test(o, d), key=jax.random.key(0))
        return jnp.mean(r["rgb_volume"] ** 2) + jnp.mean(r["depth_volume"])

    loss, g = jax.value_and_grad(loss_fn)(params)
    assert np.isfinite(float(loss))
    leaves = jax.tree.leaves(g)
    assert all(bool(jnp.isfinite(x).all()) for x in leaves)
    assert any(float(jnp.abs(x).sum()) > 0 for x in leaves)
