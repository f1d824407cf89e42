"""Interim GPU benchmark: the LoTD brick encode layer and the end-to-end
render/train jobs of experiments/bench_render.py.

    python bench.py            # one GPU, one process on the card

Prints one JSON line {"metric", "value", "unit", "vs_baseline", "device",
"detail"}. It needs a GPU: with none it exits non-zero (there is no CPU
fallback). Timing: `block_until_ready` after a warm-up call, median of
repeats; the end-to-end jobs use bench_render's own harness. The benchmark
with named cells, per-layer spans and a peaks table is ROADMAP item A1.

Baseline (BASELINE.md): the reference CUDA LoTD forward, 8-level
Dense+Hash, 3.6M points, fp32-in/fp16-params → 1.24 ms ≈ 2.9 GSamples/s
(nr3d_lib lotd/tests/unit_test.py:131; the reference's hardware is not
stated). vs_baseline = ours / 2.9.

Detail keys:
  fwd_random_gs       — brick encode forward, 3.6M uniform-random points
  fwdbwd_random_gs    — value_and_grad wrt (table, x)
  nablas_2nd_order_gs — eikonal path: nablas and its second-order backward
  render_* / train_*  — end-to-end rays/s (bench_render.py)
  train_step_gaussian_500k_ms — 3DGS train step, 500k gaussians @ 512²
"""

import json
import sys
import time

BASELINE_GS = 2.9  # GSamples/s (reference CUDA, 3.6M pts, fwd, random)


def note(msg):
    print(f"# {msg}", file=sys.stderr, flush=True)


def median_time(fn, *args, reps: int = 5) -> float:
    import jax

    jax.block_until_ready(fn(*args))               # compile + warm up
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2]


def main() -> int:
    import jax

    if jax.default_backend() != "gpu":
        note(f"no GPU (backend {jax.default_backend()!r}); refusing to run")
        return 2
    from nr3d_lib_tpu.utils import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp

    from nr3d_lib_tpu.ops import lotd_brick as B

    dev = jax.devices()[0]
    detail = {}
    # the reference bench config: 8 levels 16→2048, dense small + hash
    meta = B.make_brick_meta(
        [16, 32, 64, 128, 256, 512, 1024, 2048],
        ["Dense", "Dense", "Dense", "Hash", "Hash", "Hash", "Hash", "Hash"],
        hashmap_rows=4096)
    n_pts = 3_600_000
    k1, k2 = jax.random.split(jax.random.key(0), 2)
    table = jax.random.normal(k1, (meta.total_rows, 128), jnp.float32) * 1e-2
    x = jax.random.uniform(k2, (n_pts, 3), jnp.float32)

    @jax.jit
    def fwd(xx, tt):
        return B.brick_encode_xla(xx, tt, meta)

    @jax.jit
    def fwdbwd(xx, tt):
        def loss(t_, x_):
            return jnp.sum(B.brick_encode_xla(x_, t_, meta) ** 2)

        return jax.value_and_grad(loss, argnums=(0, 1))(tt, xx)

    @jax.jit
    def nablas_fwdbwd(xx, tt):
        gup = jnp.full((xx.shape[0], 2 * meta.n_levels), 1e-2, jnp.float32)

        def loss(g_, x_, t_):
            _, vjp = jax.vjp(lambda q: B.brick_encode_xla(q, t_, meta), x_)
            return jnp.sum(vjp(g_)[0] ** 2)

        return jax.value_and_grad(loss, argnums=(0, 1, 2))(gup, xx, tt)

    for name, fn in (("fwd_random_gs", fwd), ("fwdbwd_random_gs", fwdbwd),
                     ("nablas_2nd_order_gs", nablas_fwdbwd)):
        detail[name] = n_pts / median_time(fn, x, table) / 1e9
        note(f"{name} = {detail[name]}")

    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "bench_render", os.path.join(os.path.dirname(os.path.abspath(
            __file__)), "experiments", "bench_render.py"))
    br = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(br)
    jobs = [
        ("render_fwd_brick_compressed_krays",
         lambda: br.main(use_brick=True, mode="march_occ_compressed") / 1e3),
        ("train_step_neus_compressed_krays",
         lambda: br.main_train(use_brick=True, kind="neus_compressed") / 1e3),
        ("render_fwd_forest_krays", lambda: br.main_forest() / 1e3),
        ("train_step_gaussian_500k_ms", lambda: br.main_train_gaussian()),
    ]
    for name, job in jobs:
        detail[name] = job()
        note(f"{name} = {detail[name]}")

    print(json.dumps({
        "metric": "lotd_fwd_throughput_8lvl_dense_hash_3.6Mpts",
        "value": detail["fwd_random_gs"],
        "unit": "GSamples/s",
        "vs_baseline": detail["fwd_random_gs"] / BASELINE_GS,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "detail": detail,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
