"""Test config: the tests run on the CPU with an 8-device virtual mesh, so
the sharding tests need no accelerator. The platform is set through
jax.config after importing jax (the `jax_num_cpu_devices` option sets the
virtual device count).

Tests that need a GPU carry the `gpu` marker and take the `gpu_device`
fixture, which decides at run time whether a card is present and skips
otherwise — never at import or collection, so every xdist worker collects
the same tests. On a machine with a card they run with
`MRT_TEST_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/`."""

import os

import jax

jax.config.update("jax_platforms", os.environ.get("MRT_TEST_PLATFORMS", "cpu"))
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_default_matmul_precision", "float32")
# NO persistent compile cache for the suite: XLA:CPU AOT export segfaults
# serializing some of the very large executables this suite compiles
# (reproducible "Fatal Python error" inside compilation_cache.
# put_executable_and_time at the book2 parity renders — jax has no
# max-entry-size gate to exclude just those). The in-process jit cache
# still dedups within a run.
jax.config.update("jax_enable_compilation_cache", False)


import gc

import pytest

# Fast lane: `pytest -m "not slow"` runs in ~5 min (the full suite takes
# ~20 min on the 8-virtual-device CPU mesh and is the merge gate, not the
# iteration loop). Tests costing >=8 s are marked slow here centrally;
# entries are either full node names (with param brackets) or bare test
# function names (marks every parametrization).
SLOW_TESTS = {
    # fused kernel on the sharded mesh (interpret mode)
    "test_fused_distributed_matches_xla_distributed",
    # train-step equivalences + gradient checks (full suite still gates)
    "test_packed_train_step_spp_step_matches_sp_axis",
    "test_packed_train_step_matches_unpacked",
    "test_train_step_loss_decreases_and_grads_flow",
    "test_packed_train_step_pixel_count_not_pack_aligned",
    "test_sharded_wavefront_matches_unsharded",
    "test_gradients_match_finite_differences",
    "test_all_param_gradients_finite",
    "test_sharded_workqueue_matches_single",
    "test_wavefront_matches_progressive_single_device",
    "test_fast_perlin_statistics_match_exact",
    "test_packed_scan_matches_unpacked",
    "test_all_simple_scenes_render_finite",
    "test_packed_scan_truncation_is_observable_not_silent",
    "test_scan_and_while_loops_agree",
    # per-scene goldens/parity: keep the cheap scenes in the fast lane
    # (cornell_box, cornell_smoke, two_spheres, random_spheres stay fast)
    "test_scene_matches_golden[book2_final]",
    "test_scene_matches_golden[earth]",
    "test_scene_matches_golden[triangles]",
    "test_scene_matches_golden[perlin_spheres]",
    "test_scene_matches_golden[random_spheres_2]",
    "test_channel_means_match_reference[book2_final]",
    "test_channel_means_match_reference[earth]",
    "test_channel_means_match_reference[triangles]",
    "test_channel_means_match_reference[perlin_spheres]",
    "test_channel_means_match_reference[random_spheres_2]",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        name = item.nodeid.rsplit("::", 1)[-1]
        base = name.split("[", 1)[0]
        if name in SLOW_TESTS or base in SLOW_TESTS:
            item.add_marker(pytest.mark.slow)


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test where JAX has none. The suite
    forces the CPU platform above, so this skips in the CPU run."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs a GPU (run on the card via chip_smoke.py)")
    return devs[0]


@pytest.fixture(autouse=True, scope="module")
def _clear_jit_caches_between_modules():
    """XLA:CPU reproducibly SEGFAULTS in backend_compile_and_load once the
    process has accumulated ~130 tests' worth of compiled executables
    (tens of GB of live programs); individual tests pass in isolation.
    Dropping compiled programs between modules keeps the process inside
    the envelope; within-module compilation sharing is preserved."""
    yield
    jax.clear_caches()
    gc.collect()
