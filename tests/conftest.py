"""Test configuration: the CPU backend with 8 virtual devices, so the
multi-device sharding paths run host-side (``--xla_force_host_platform_
device_count=8``) and the replay kernel runs in Pallas interpret mode.

``JAX_PLATFORMS`` is set to ``cpu`` unless the caller already chose a
platform: ``chip_smoke.py`` runs the tests marked ``gpu`` in its own
process on the card.  Tests marked ``gpu`` skip without a GPU (their
``gpu`` fixture decides at run time, so every xdist worker collects the
same tests).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.RandomState(0)


# ---------------------------------------------------------------------------
# slow tier: module-scoped compile fixtures dominate the full suite;
# `pytest -m "not slow"` is the fast developer loop.  Membership =
# measured >~10 s per test (or a whole module when its fixture is the
# cost) — re-derive with `pytest --durations=60` when it drifts.
# ---------------------------------------------------------------------------

_SLOW_NODES = (
    "test_graft_entry.py::test_dryrun_multichip_8",
    "test_e2e.py",
    "test_masking.py",
    "test_streaming.py",
    "test_streaming_trainer.py",
    "test_supervised.py",
    "test_train_step.py::test_fused_iterations_match_sequential",
    "test_train_step.py::test_pool_advances_and_terminates",
    "test_losses.py::TestGeneratorValueLoss::test_gradient_partitioning",
    "test_losses.py::TestCriticLoss::test_critic_grads_flow",
    "test_data.py::TestSyntheticSpread",
    "test_data.py::TestSyntheticTexture",
    "test_serving.py::test_map_batches_depth_invariant",
    "test_tools.py::TestSelectPolicy::test_select_end_to_end_with_promote",
    "test_tools.py::TestEditSequence",
    "test_fivek_path.py::test_import_validator",
)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: heavy compile/training tests (full suite only; "
        "deselect with -m 'not slow')")
    config.addinivalue_line(
        "markers", "gpu: runs the kernel compiled for the GPU; skips "
        "without one (run on the card by chip_smoke.py)")


def pytest_collection_modifyitems(config, items):
    for item in items:
        if any(s in item.nodeid for s in _SLOW_NODES):
            item.add_marker(pytest.mark.slow)
