#!/usr/bin/env python3
"""Smoke test of nr3d_lib_tpu on NVIDIA GPUs: the quickest proof that the
system starts and trains correctly on the card.

    python chip_smoke.py               # one GPU, phases 1-5 below
    python chip_smoke.py --multi-gpu   # four GPUs: data-parallel and forest
                                       # block-parallel steps vs one GPU

One GPU:
  1. device: JAX devices, device kind, JAX version, card name and power limit;
  2. main path at full width: LoTD-NeuS training (ray_test → occupancy
     march → multi-upsample → budget compaction → rgb + eikonal loss with
     its second-order backward → adam) with a 16-level Instant-NGP-sized
     hash grid, 4096 rays per step; prints ms/step, rays/s and peak memory;
  3. correctness: the first step's loss and gradients on the GPU (matmul
     precision "highest") against the CPU, same inputs;
  4. 3DGS tile blend: the Pallas (Triton route) kernel against the XLA
     blend (forward and gradients, f32), then the 3DGS train step timed
     with each blend at 500k gaussians × 512²;
  5. last line: {"ok": true, "device": {...}}.

Every scene is generated from --seed; nothing is downloaded. The script
exits non-zero and prints no result line when JAX finds no GPU or any
phase fails. It keeps to one process per card (the nvidia-smi query is
the only child, and it does not touch JAX). The compile cache is
JAX_COMPILATION_CACHE_DIR when set, else <repo>/.jax_cache.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

# The published Instant-NGP hash grid (Müller et al. 2022, §4): 16 levels,
# resolutions growing geometrically 16 → 2048, F = 2, T = 2^19; a level is
# Dense while res³ ≤ T. Decoder / radiance / query mode / rays per step as
# in examples/configs/lotd_neus.yaml and _base_.yaml.
NEUS_FULL = dict(n_levels=16, min_res=16, max_res=2048, log2_hashmap=19,
                 n_rays=4096, n_steps=5)
GAUSS_FULL = dict(n_gauss=500_000, hw=(512, 512), n_steps=5)
EIKONAL = 0.03

# Comparison limits (reasons in CHANGES.md): GPU at matmul precision
# "highest" against the CPU, same inputs and occupancy grid; gradients
# per leaf by relative L2. The loss's gradient is not continuous at float
# resolution: occupancy lookups and budget compaction choose samples from
# float values, so a last-bit difference moves a few samples. A 1e-7 nudge
# of the ray origins moves the CPU's own gradients by ~8e-3 (hash table)
# and ~1.4e-3 (other leaves); the phase prints that floor every run. The
# limits sit a few times above it and a few times below what TF32 does
# (~8e-2 / ~1.5e-2), so a path that silently runs at TF32 still fails.
LOSS_RTOL = 1e-4
GRAD_RTOL = 6e-3
TABLE_GRAD_RTOL = 3e-2
# Kernel blend against the XLA blend, f32: forward abs, gradients max-abs
# over each leaf's largest XLA gradient.
BLEND_FWD_ATOL = 2e-4
BLEND_GRAD_ATOL = 1e-3
# Four cards against one, the step's parameter update (lr·grad, sgd): the
# DP NeuS step shares the loss's float-resolution discontinuity, so it gets
# the GPU-vs-CPU limits above; the forest encode makes no discrete choice
# and only its summation order changes.
FOREST_RTOL = 1e-4


class PhaseError(RuntimeError):
    pass


def check(ok: bool, msg: str):
    if not ok:
        raise PhaseError(msg)


# ------------------------------------------------------------------ device
def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().replace("\n", " | ")


def phase_device(jax) -> dict:
    devs = jax.devices()
    card = card_line()
    print(f"[device] devices={devs} kind={devs[0].device_kind} "
          f"jax={jax.__version__} nvidia-smi: {card}", flush=True)
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


# ------------------------------------------------------------------- scene
def scene_fns():
    """Analytic sphere ∪ rounded box (examples/train_neus_object.py):
    sdf, sphere-traced normal-coloured ground truth, random rays."""
    import jax
    import jax.numpy as jnp

    def sdf_gt(p):
        d_sph = jnp.linalg.norm(p - jnp.asarray([0.22, 0.0, 0.0]),
                                axis=-1) - 0.34
        q = jnp.abs(p - jnp.asarray([-0.22, 0.0, 0.0])) - 0.26
        d_box = (jnp.linalg.norm(jnp.maximum(q, 0.0), axis=-1)
                 + jnp.minimum(jnp.max(q, axis=-1), 0.0) - 0.04)
        return jnp.minimum(d_sph, d_box)

    normal_gt = jax.vmap(jax.grad(lambda p: sdf_gt(p[None])[0]))

    def trace_gt(o, d, n_steps: int = 96):
        t = jnp.full(o.shape[:1], 1.0)
        for _ in range(n_steps):
            t = t + sdf_gt(o + t[:, None] * d)
        p = o + jnp.clip(t, 0.0, 4.0)[:, None] * d
        hit = jnp.abs(sdf_gt(p)) < 1e-3
        n = normal_gt(p)
        n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-9)
        return jnp.where(hit[:, None], n * 0.5 + 0.5, 0.0)

    def sample_rays(n, key):
        k1, k2 = jax.random.split(key)
        o = jax.random.normal(k1, (n, 3))
        o = o / jnp.linalg.norm(o, axis=-1, keepdims=True) * 2.0
        tgt = jax.random.uniform(k2, (n, 3), minval=-0.25, maxval=0.25)
        d = tgt - o
        return o, d / jnp.linalg.norm(d, axis=-1, keepdims=True)

    return sdf_gt, trace_gt, sample_rays


def ngp_lotd_cfg(n_levels: int, min_res: int, max_res: int,
                 log2_hashmap: int) -> dict:
    b = math.exp((math.log(max_res) - math.log(min_res))
                 / max(n_levels - 1, 1))
    res = [int(math.floor(min_res * b ** l + 1e-6)) for l in range(n_levels)]
    cap = 2 ** log2_hashmap
    return {"lod_res": res, "lod_n_feats": 2,
            "lod_types": ["Dense" if r ** 3 <= cap else "Hash" for r in res],
            "hashmap_size": cap}


def build_neus(seed: int, cfg: dict):
    """LoTDNeuSModel shaped like examples/configs/lotd_neus.yaml with the
    NGP-sized encoding; the occupancy grid is pinned from the analytic
    scene (cells within two voxels of the surface)."""
    import jax.numpy as jnp

    from nr3d_lib_tpu import nn
    from nr3d_lib_tpu.models.accelerations.occgrid import cell_centers
    from nr3d_lib_tpu.models.model_base import LoTDNeuSModel

    lotd = ngp_lotd_cfg(cfg["n_levels"], cfg["min_res"], cfg["max_res"],
                        cfg["log2_hashmap"])
    model = LoTDNeuSModel(
        field_cfg={"surface_cfg": {"encoding_cfg": {"lotd_cfg": lotd},
                                   "decoder_cfg": {"D": 1, "W": 64}},
                   "radiance_cfg": {"D": 2, "W": 64},
                   "var_ctrl_cfg": {"type": "learned", "init_val": 0.3}},
        ray_query_cfg={"query_mode": "march_occ_multi_upsample_compressed"},
        seed=seed)
    sdf_gt = scene_fns()[0]
    occ = model.accel.occ
    res = occ.resolution
    band = 2.0 * 2.0 / min(res)
    vals = jnp.abs(sdf_gt(cell_centers(res))) < band
    occ.val_grid[...] = vals.reshape(res).astype(jnp.float32)
    graphdef, params, rest = nn.split(model, nn.Param, ...)
    return model, graphdef, params, rest, lotd


def neus_loss_fn(graphdef):
    import jax.numpy as jnp

    from nr3d_lib_tpu import nn

    def loss_fn(params, rest, o, d, rgb_gt, key):
        m = nn.merge(graphdef, params, rest)
        rendered, vb = m.ray_query(m.ray_test(o, d), key=key)
        nab = vb["nablas_packed"]
        eik = jnp.mean((jnp.linalg.norm(nab, axis=-1) - 1.0) ** 2)
        return jnp.mean((rendered["rgb_volume"] - rgb_gt) ** 2) + EIKONAL * eik

    return loss_fn


def neus_batch(seed: int, n_rays: int, step: int):
    import jax

    _, trace_gt, sample_rays = scene_fns()
    k_rays, k_step = jax.random.split(
        jax.random.fold_in(jax.random.key(seed), step))
    o, d = sample_rays(n_rays, k_rays)
    return o, d, trace_gt(o, d), k_step


def peak_bytes(dev) -> int:
    stats = dev.memory_stats() or {}
    return int(stats.get("peak_bytes_in_use", -1))


# ------------------------------------------------------- phase 2: main path
def phase_main_path(seed: int, cfg: dict):
    import jax
    import optax

    model, graphdef, params, rest, lotd = build_neus(seed, cfg)
    n_params = sum(x.size for x in jax.tree.leaves(params))
    print(f"[main] LoTDNeuSModel lod_res={lotd['lod_res']} "
          f"types={lotd['lod_types']} hashmap={lotd['hashmap_size']} "
          f"params={n_params} rays/step={cfg['n_rays']}", flush=True)
    loss_fn = neus_loss_fn(graphdef)
    opt = optax.adam(5e-3)

    @jax.jit
    def train_step(params, opt_state, rest, o, d, rgb_gt, key):
        loss, g = jax.value_and_grad(loss_fn)(params, rest, o, d, rgb_gt,
                                              key)
        upd, opt_state = opt.update(g, opt_state, params)
        return optax.apply_updates(params, upd), opt_state, loss

    opt_state = opt.init(params)
    batches = [jax.block_until_ready(neus_batch(seed, cfg["n_rays"], i))
               for i in range(cfg["n_steps"] + 1)]
    t0 = time.perf_counter()
    params, opt_state, loss = jax.block_until_ready(
        train_step(params, opt_state, rest, *batches[0]))
    t_compile = time.perf_counter() - t0
    losses, times = [float(loss)], []
    for b in batches[1:]:
        t0 = time.perf_counter()
        params, opt_state, loss = jax.block_until_ready(
            train_step(params, opt_state, rest, *b))
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    check(all(np.isfinite(losses)), f"non-finite NeuS loss {losses}")
    leaves = jax.tree.leaves(params)
    check(all(bool(jax.numpy.isfinite(x).all()) for x in leaves),
          "non-finite NeuS parameters after training")
    ms = sorted(t * 1e3 for t in times)
    med = ms[len(ms) // 2]
    print(f"[main] compile+first step {t_compile:.3f} s; "
          f"{len(times)} steps ms/step {[round(t, 3) for t in ms]} "
          f"median {med:.3f} ms -> {cfg['n_rays'] / med * 1e3:.1f} rays/s; "
          f"peak_bytes_in_use {peak_bytes(jax.devices()[0])}; "
          f"losses {[round(x, 6) for x in losses]}", flush=True)
    return graphdef


# ---------------------------------------------------- phase 3: correctness
def rel_l2(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    nb = np.linalg.norm(b)
    return float(np.linalg.norm(a - b) / nb) if nb > 0 \
        else float(np.linalg.norm(a))


def phase_correctness(seed: int, cfg: dict):
    """First step's loss and parameter gradients: GPU ("highest") vs CPU,
    same params, occupancy grid, rays and key. For information: how far
    TF32 moves the GPU result, and how far a 1e-7 relative nudge of the
    ray origins moves the CPU result itself (the sampler's discrete
    choices make the hash-table gradient discontinuous at that scale)."""
    import jax

    _, graphdef, params, rest, _ = build_neus(seed, cfg)
    loss_fn = neus_loss_fn(graphdef)
    args = (params, rest) + tuple(neus_batch(seed, cfg["n_rays"], 0))
    nudged = args[:2] + (args[2] * (1.0 + 1e-7),) + args[3:]
    grad_fn = jax.value_and_grad(loss_fn)

    gpu = jax.devices()[0]
    with jax.default_matmul_precision("highest"):
        l_g, g_g = jax.jit(grad_fn)(*jax.device_put(args, gpu))
    l_tf32, g_tf32 = jax.jit(grad_fn)(*jax.device_put(args, gpu))
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu), jax.default_matmul_precision("highest"):
        cpu_fn = jax.jit(grad_fn)
        l_c, g_c = cpu_fn(*jax.device_put(args, cpu))
        l_n, g_n = cpu_fn(*jax.device_put(nudged, cpu))
    l_c = float(l_c)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_leaves_with_path(g_c)]

    def leaf_rels(g):
        return [rel_l2(a, b) for a, b in zip(jax.tree.leaves(g),
                                             jax.tree.leaves(g_c))]

    def worst(rels, table: bool):
        sel = [(r, p) for r, p in zip(rels, paths)
               if ("['encoding']" in p) == table]
        return max(sel) if sel else (0.0, "-")

    rels = leaf_rels(g_g)
    loss_rel = abs(float(l_g) - l_c) / abs(l_c)
    (t_rel, t_path), (m_rel, m_path) = worst(rels, True), worst(rels, False)
    print(f"[correct] loss gpu(highest) {float(l_g):.8f} cpu {l_c:.8f} "
          f"rel {loss_rel:.3e} (limit {LOSS_RTOL}); grads rel L2: table "
          f"{t_rel:.3e} at {t_path} (limit {TABLE_GRAD_RTOL}), other leaves "
          f"max {m_rel:.3e} at {m_path} (limit {GRAD_RTOL})", flush=True)
    for name, l_x, g_x in (("TF32 (default precision) gpu", l_tf32, g_tf32),
                           ("cpu with origins nudged 1e-7", l_n, g_n)):
        r = leaf_rels(g_x)
        print(f"[correct] info: {name} vs cpu: loss rel "
              f"{abs(float(l_x) - l_c) / abs(l_c):.3e}, grads rel L2 table "
              f"{worst(r, True)[0]:.3e}, other leaves max "
              f"{worst(r, False)[0]:.3e}", flush=True)
    check(loss_rel <= LOSS_RTOL, f"loss rel {loss_rel:.3e} > {LOSS_RTOL}")
    check(t_rel <= TABLE_GRAD_RTOL,
          f"grad {t_path} rel L2 {t_rel:.3e} > {TABLE_GRAD_RTOL}")
    check(m_rel <= GRAD_RTOL, f"grad {m_path} rel L2 {m_rel:.3e} > {GRAD_RTOL}")


# ------------------------------------------------- phase 4: 3DGS blend
def gaussian_scene(seed: int, n_gauss: int, hw):
    import jax
    import jax.numpy as jnp

    kg = jax.random.split(jax.random.key(seed + 21), 6)
    params = {
        "means": jax.random.uniform(kg[0], (n_gauss, 3), jnp.float32, -1, 1),
        "scales": jax.random.uniform(kg[1], (n_gauss, 3), jnp.float32,
                                     0.002, 0.02),
        "quats": jax.random.normal(kg[2], (n_gauss, 4), jnp.float32),
        "opac": jax.random.uniform(kg[3], (n_gauss, 1), jnp.float32, 0.3, 0.9),
        "cols": jax.random.uniform(kg[4], (n_gauss, 3), jnp.float32),
    }
    w2c = jnp.eye(4).at[2, 3].set(3.0)
    f = 500.0 * hw[0] / 512
    intr = jnp.asarray([[f, 0, hw[1] / 2], [0, f, hw[0] / 2], [0, 0, 1]])
    gt = jax.random.uniform(kg[5], (hw[0], hw[1], 3))
    return params, w2c, intr, gt


def gaussian_loss(w2c, intr, hw, backend):
    import jax.numpy as jnp

    from nr3d_lib_tpu.graphics import gaussian_splatting as GS

    def loss_fn(p, gt):
        out = GS.rasterize_gaussians_tiled(
            p["means"], p["scales"],
            p["quats"] / jnp.linalg.norm(p["quats"], axis=-1, keepdims=True),
            p["opac"], p["cols"], w2c, intr, hw, blend_backend=backend)
        return jnp.mean((out["rgb"] - gt) ** 2), out

    return loss_fn


def phase_gaussian(seed: int, cfg: dict, backend: str = "pallas"):
    import jax
    import optax

    hw = tuple(cfg["hw"])
    params, w2c, intr, gt = gaussian_scene(seed, cfg["n_gauss"], hw)
    lx = gaussian_loss(w2c, intr, hw, "xla")
    lk = gaussian_loss(w2c, intr, hw, backend)

    # forward + gradients, kernel vs XLA blend, f32
    with jax.default_matmul_precision("highest"):
        (_, out_x), g_x = jax.jit(jax.value_and_grad(lx, has_aux=True))(
            params, gt)
        (_, out_k), g_k = jax.jit(jax.value_and_grad(lk, has_aux=True))(
            params, gt)
    fwd_err = max(float(jax.numpy.max(jax.numpy.abs(out_k[k] - out_x[k])))
                  for k in ("rgb", "alpha", "depth"))
    grad_err = {}
    for name in g_x:
        scale = float(jax.numpy.max(jax.numpy.abs(g_x[name])))
        grad_err[name] = float(jax.numpy.max(
            jax.numpy.abs(g_k[name] - g_x[name]))) / max(scale, 1e-30)
    print(f"[3dgs] {cfg['n_gauss']} gaussians @ {hw[0]}x{hw[1]}: kernel vs "
          f"xla forward max abs {fwd_err:.3e} (limit {BLEND_FWD_ATOL}); "
          f"grad max abs / max|g_xla| "
          f"{ {k: float(f'{v:.3e}') for k, v in grad_err.items()} } "
          f"(limit {BLEND_GRAD_ATOL}); n_dropped_pairs "
          f"{int(out_x['n_dropped_pairs'])}", flush=True)
    check(fwd_err <= BLEND_FWD_ATOL, f"blend forward err {fwd_err:.3e}")
    check(max(grad_err.values()) <= BLEND_GRAD_ATOL,
          f"blend grad err {grad_err}")
    check(int(out_k["n_dropped_pairs"]) == int(out_x["n_dropped_pairs"]),
          "n_dropped_pairs differs between blends")

    # train step timed end to end with each blend, in turns
    opt = optax.adam(1e-3)

    def make_step(loss_fn):
        @jax.jit
        def step(p, s):
            (loss, _), g = jax.value_and_grad(loss_fn, has_aux=True)(p, gt)
            upd, s = opt.update(g, s, p)
            return optax.apply_updates(p, upd), s, loss
        return step

    steps = {"xla": make_step(lx), backend: make_step(lk)}
    state = {k: (params, opt.init(params)) for k in steps}
    times = {k: [] for k in steps}
    for k, f in steps.items():                      # compile + warm up
        p, s, _ = jax.block_until_ready(f(*state[k]))
        state[k] = (p, s)
    order = ["xla", backend, backend, "xla"]
    for _ in range(-(-cfg["n_steps"] // 2)):
        for k in order:
            t0 = time.perf_counter()
            p, s, loss = jax.block_until_ready(steps[k](*state[k]))
            times[k].append(time.perf_counter() - t0)
            state[k] = (p, s)
            check(bool(np.isfinite(float(loss))), f"3DGS {k} loss not finite")
    med = {k: sorted(v)[len(v) // 2] * 1e3 for k, v in times.items()}
    print(f"[3dgs] train step ms (median of {len(times['xla'])}): "
          f"xla {med['xla']:.3f}, {backend} kernel {med[backend]:.3f}; "
          f"all xla {[round(t * 1e3, 3) for t in times['xla']]} "
          f"kernel {[round(t * 1e3, 3) for t in times[backend]]}; "
          f"peak_bytes_in_use {peak_bytes(jax.devices()[0])}", flush=True)


# ---------------------------------------------------- four cards
def phase_multi(seed: int, cfg: dict, n_dev: int = 4):
    """DP NeuS train step on a ('data','block') = (n,1) mesh and forest
    block-parallel step on (1,n), each against the same step on one card;
    sgd, so the update is lr·grad and compares without adam's sign
    amplification of near-zero gradients."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from nr3d_lib_tpu.ops import lotd as L
    from nr3d_lib_tpu.parallel import make_mesh
    from nr3d_lib_tpu.parallel.forest_parallel import (
        make_forest_sharded_train_step, pad_blocks_for_sharding)
    from nr3d_lib_tpu.parallel.train import make_sharded_train_step

    devs = jax.devices()
    check(len(devs) >= n_dev, f"need {n_dev} devices, found {len(devs)}")
    devs = devs[:n_dev]
    opt = optax.sgd(1e-2)

    def upd_errs(p_new, p_ref, p0):
        """(path, relative L2 of the update) per leaf."""
        return [(jax.tree_util.keystr(path),
                 rel_l2(np.asarray(a) - np.asarray(c),
                        np.asarray(b) - np.asarray(c)))
                for (path, a), b, c in zip(
                    jax.tree_util.tree_leaves_with_path(p_new),
                    jax.tree.leaves(p_ref), jax.tree.leaves(p0))]

    # --- data parallel: LoTD-NeuS step, rays sharded over 'data'
    _, graphdef, params, rest, _ = build_neus(seed, cfg)
    neus_loss = neus_loss_fn(graphdef)
    o, d, rgb, key = neus_batch(seed, cfg["n_rays"], 0)
    batch = {"o": o, "d": d, "rgb": rgb}

    def dp_loss(p, b, k):
        return neus_loss(p, rest, b["o"], b["d"], b["rgb"], k)

    results = {}
    with jax.default_matmul_precision("highest"):
        for name, shape, dv in (("one", (1, 1), devs[:1]),
                                ("dp", (n_dev, 1), devs)):
            mesh = make_mesh(shape, ("data", "block"), devices=dv)
            step = make_sharded_train_step(dp_loss, opt, mesh=mesh,
                                           donate=False)
            p_in = jax.device_put(params, NamedSharding(mesh, P()))
            b_in = jax.device_put(batch, NamedSharding(mesh, P("data")))
            if name == "dp":
                placed = {d_ for x in jax.tree.leaves(b_in)
                          for d_ in x.sharding.device_set}
                check(placed == set(dv), f"DP batch on {placed}, not {dv}")
            p_new, _, loss = step(p_in, opt.init(p_in), b_in, key)
            results[name] = (jax.device_get(p_new), float(loss))
    errs = upd_errs(results["dp"][0], results["one"][0], params)
    t_err = max(e for p, e in errs if "['encoding']" in p)
    m_err = max(e for p, e in errs if "['encoding']" not in p)
    dp_loss_rel = abs(results["dp"][1] - results["one"][1]) \
        / abs(results["one"][1])
    print(f"[multi] DP ({n_dev},1) LoTD-NeuS step vs one card: loss rel "
          f"{dp_loss_rel:.3e} (limit {LOSS_RTOL}), update rel L2 table "
          f"{t_err:.3e} (limit {TABLE_GRAD_RTOL}), other leaves max "
          f"{m_err:.3e} (limit {GRAD_RTOL})", flush=True)
    check(dp_loss_rel <= LOSS_RTOL and t_err <= TABLE_GRAD_RTOL
          and m_err <= GRAD_RTOL, "DP step differs from one card")

    # --- forest block model-parallelism: per-block tables over 'block'
    lotd = ngp_lotd_cfg(8, 16, 256, 17)
    meta = L.generate_meta(3, lotd["lod_res"], 2, lotd["lod_types"],
                           hashmap_size=lotd["hashmap_size"])
    n_blocks, n_pts = 64, 2 ** 18
    k = jax.random.split(jax.random.key(seed + 5), 5)
    blocks = pad_blocks_for_sharding(
        1e-2 * jax.random.normal(k[0], (n_blocks, meta.n_params)), n_dev)
    w = 0.1 * jax.random.normal(k[1], (meta.out_features, 1))
    x = jax.random.uniform(k[2], (n_pts, 3))
    bidx = jax.random.randint(k[3], (n_pts,), 0, n_blocks)
    tgt = jnp.sin(8.0 * x[:, :1]) * jnp.cos(4.0 * x[:, 1:2])

    def forest_loss(other, feats, b):
        return jnp.mean((feats @ other - b["tgt"]) ** 2)

    p0 = {"blocks": blocks, "other": w}
    results = {}
    with jax.default_matmul_precision("highest"):
        for name, shape, dv in (("one", (1, 1), devs[:1]),
                                ("mp", (1, n_dev), devs)):
            mesh = make_mesh(shape, ("data", "block"), devices=dv)
            step = make_forest_sharded_train_step(forest_loss, opt, meta,
                                                  mesh)
            p_in = {"blocks": jax.device_put(
                        blocks, NamedSharding(mesh, P("block", None))),
                    "other": jax.device_put(w, NamedSharding(mesh, P()))}
            b_in = jax.device_put({"x": x, "bidx": bidx, "tgt": tgt},
                                  NamedSharding(mesh, P("data")))
            if name == "mp":
                placed = p_in["blocks"].sharding.device_set
                check(placed == set(dv), f"blocks on {placed}, not {dv}")
            p_new, _, loss = step(p_in, opt.init(p_in), b_in, None)
            if name == "mp":
                check(p_new["blocks"].sharding.spec[0] == "block",
                      "blocks lost their block sharding")
            results[name] = (jax.device_get(p_new), float(loss))
    mp_err = max(e for _, e in upd_errs(results["mp"][0],
                                        results["one"][0], p0))
    mp_loss_rel = abs(results["mp"][1] - results["one"][1]) \
        / abs(results["one"][1])
    print(f"[multi] forest block-parallel (1,{n_dev}) {n_blocks} blocks vs "
          f"one card: loss rel {mp_loss_rel:.3e}, update max rel L2 "
          f"{mp_err:.3e} (limit {FOREST_RTOL})", flush=True)
    check(mp_loss_rel <= FOREST_RTOL and mp_err <= FOREST_RTOL,
          "forest block-parallel step differs from one card")


# ------------------------------------------------------------------- main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--multi-gpu", action="store_true",
                    help="run only the four-card phase")
    args = ap.parse_args(argv)

    import jax

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: no GPU (JAX backend is "
              f"{jax.default_backend()!r}); refusing to run",
              file=sys.stderr)
        return 2

    from nr3d_lib_tpu.utils import enable_compile_cache

    print(f"[setup] compile cache {enable_compile_cache()}", flush=True)
    try:
        device = phase_device(jax)
        if args.multi_gpu:
            phase_multi(args.seed, NEUS_FULL)
        else:
            phase_main_path(args.seed, NEUS_FULL)
            phase_correctness(args.seed, NEUS_FULL)
            phase_gaussian(args.seed, GAUSS_FULL)
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
