"""Pytest config: run all tests on a simulated 8-device CPU mesh.

The CPU backend is forced via jax.config (before any backend is
initialized), so the suite never opens a GPU. Tests that need the card are
marked `gpu` and take the `gpu_device` fixture, which skips them here; on
the card, `python chip_smoke.py` runs the same checks at full size.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
# Float64 available for finite-difference gradient checks (tests only; the
# library itself computes in fp32/bf16).
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

# ---------------------------------------------------------------- slow lane
# Default runs are the FAST set (pytest.ini pins `-m "not slow"`); the
# full lane is
#     python -m pytest tests/ -m "slow or not slow" -q
# Every component marked slow keeps a fast test in the same file (smaller
# config or a sibling model test), so the fast set's component reach is
# unchanged — only depth/scale moves to the slow lane. The list holds the
# tests that took >30 s in a full-suite timing run, plus redundant 20-30 s
# siblings. The fast lane runs in ~5 minutes with 6 xdist workers.
_SLOW = {
    "test_permuto_cell4.py::test_nablas4_kernel_and_dynamic_field",
    "test_permuto_cell4.py::test_custom_vjp_cpu_and_fit",
    "test_permuto_cell.py::test_sdf_cell_nablas_split",
    "test_examples.py::test_example_smoke",
    "test_lotd_brick.py::test_brick_sdf_field_nablas_path",
    "test_parallel.py::test_forest_block_sharded_encode_and_train_step",
    "test_parallel.py::test_graft_entry_dryrun",
    "test_model_families.py::test_forest_neus_model_query_and_grads",
    "test_model_families.py::test_permuto_static_field_family",
    "test_forest_accel.py::test_forest_sharded_train_step",
    "test_forest_accel.py::test_forest_segment_march_mode_model",
    "test_forest_accel.py::test_forest_empty_block_skipping_reduces_samples",
    "test_model_classes.py::test_dynamic_permuto_neus_model",
    "test_model_classes.py::test_lotd_neus_model_brick_backend_train_step",
    "test_model_classes.py::test_emernerf_model",
    "test_query_modes.py::test_neus_sphere_trace_vs_march_occ",
    "test_variants_utils.py::test_neus_dynamic_query",
    "test_variants_utils.py::test_neus_compressed_query_matches_uncompressed",
    "test_permuto_sphere_trace.py::test_permuto_fwd_dydx_and_second_order",
    "test_viewer.py::test_viewer_controls_dynamic_model",
    # 20-30s band, each redundant with a faster sibling in the same file
    "test_mesh_gs_misc.py::test_gaussian_splatting_render",
    "test_query_modes.py::test_neus_compressed_default_keeps_far_occupied",
    "test_query_modes.py::test_nerf_compressed_grad_flows",
    "test_lotd_growers.py::test_style_lotd_with_grower_type",
    "test_viewer.py::test_viewer_overlay_datalayer",
    "test_variants_utils.py::test_neus_batched_query",
    "test_model_classes.py::test_dynamic_generative_neus_model",
    "test_forest_brick.py::test_forest_model_brick_backend_train_step",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        base = f"{item.fspath.basename}::{item.originalname}" \
            if hasattr(item, "originalname") else item.nodeid
        if base in _SLOW:
            item.add_marker(pytest.mark.slow)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip: decided when the test runs, never at
    import (xdist workers must all collect the same tests). The suite
    forces the CPU backend, so this skips in the test lane; card-only
    checks run through `python chip_smoke.py` on the GPU."""
    try:
        gpus = jax.devices("gpu")
    except RuntimeError:
        gpus = []
    if not gpus:
        pytest.skip("needs an NVIDIA GPU (run `python chip_smoke.py` there)")
    return gpus[0]
