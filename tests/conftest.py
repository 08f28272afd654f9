"""Run the tests on a virtual 8-device CPU mesh (the standard fake-multi-
device trick) with float64 enabled for finite-difference oracles. The GPU
is measured by chip_smoke.py and bench*.py, not by the unit suite.

Tests marked ``gpu`` compile for the card and skip on the CPU; run them on
a GPU machine with ``QPPVM_TEST_GPU=1 python -m pytest -m gpu tests/``
(the variable keeps this file from pinning JAX to the CPU).
"""
import os

import pytest

# the GPU tests compare the card against the CPU, so keep both backends
os.environ["JAX_PLATFORMS"] = ("cuda,cpu" if os.environ.get("QPPVM_TEST_GPU")
                               == "1" else "cpu")
os.environ["JAX_ENABLE_X64"] = "true"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)
jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])


@pytest.fixture
def gpu():
    """The GPU devices, or skip: decided here, at run time, never while
    the test modules are imported (every xdist worker must collect the same
    tests)."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        pytest.skip("needs a GPU (QPPVM_TEST_GPU=1 python -m pytest -m gpu "
                    "tests/ on a GPU machine)")
    return devices


# ---------------------------------------------------------------------------
# "slow" marker: the ~15 heaviest closed-loop/e2e tests (>=40 s each on this
# image's CPU; ~60% of the suite's 40-minute wall time). Quick gate for
# iterating on solver/task/model code:
#     python -m pytest tests/ -q -m "not slow"      (~15 min)
# Full runs (CI / end-of-round) stay the default — e2e behavior coverage is
# the repo's primary safety net, never skipped silently.
# ---------------------------------------------------------------------------
SLOW_TESTS = {
    "test_force_acc_trace_matches_independent_law",
    "test_leg_lift_and_replant",
    "test_dryrun_multichip_8",
    "test_humanoid_stand_on_estimated_state",
    "test_humanoid_single_support_lift_and_replant",
    "test_humanoid_push_recovery_closed_loop",
    "test_config2_dual_arm_sine_tracking",
    "test_energy_conservation_free_fall",
    "test_humanoid_double_support_stand",
    "test_ant_forceacc_stand",
    "test_centaur_stand_squat_e2e",
    "test_step_recovery_decision_channel",
    "test_humanoid_rollout_health_under_pushes",
    "test_gate_sequence_inside_horizon",
    "test_constrained_ticks_match_certified_oracle",
    "test_scenario_randomization_healthy",
    "test_quadruped_static_walk_8_strides",
    "test_humanoid_step_in_place",
    "test_published_humanoid_forceacc_stand",
    "test_capture_step_recovery_closed_loop",
    "test_rollout_one_step_matches_plant_step",
    "test_device_stream_matches_host_dispatch",
    "test_ring_exact_on_real_wbc_tick",
    "test_ring_defect_shrinks_and_payload_reported",
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: heavyweight closed-loop/e2e test (>=40 s)")
    config.addinivalue_line(
        "markers", "gpu: compiles for the GPU; skips without one")


def pytest_collection_modifyitems(config, items):
    for item in items:
        if item.name.split("[")[0] in SLOW_TESTS:
            item.add_marker(pytest.mark.slow)
