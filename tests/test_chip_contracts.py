"""Accuracy contracts that only a GPU can show, run through ``chip_smoke``'s
phase functions at full size.

* ``nn_distances`` recall at 30,000 x 50 (phase 3): on the GPU the
  candidate matmul runs the explicit three-pass bf16 dot algorithm and the
  top-k lowers through XLA's GPU path, neither of which the CPU suite sees.
* The default f32 pruned density fit at 8,627 x 20 against the stored
  host-f64 full-landmark fit (phase 1): its parity depends on the GPU's
  f32 arithmetic, not just on the algorithm.

Both are marked ``gpu`` and skip without one; on the card run
``python -m pytest tests/test_chip_contracts.py -m gpu`` with
``MELLON_GPU_TESTS=1`` (so that ``conftest.py`` leaves the backend alone).
``chip_smoke.py`` runs the same phases.
"""

import os
import sys

import pytest

import jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    """Skip unless JAX's first device is a GPU (decided at run time)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU")


def test_knn_recall_contract_on_gpu(gpu):
    """>=99.9% of 1-NN distances within 1e-4 relative of host-f64 exact."""
    out = chip_smoke.phase_knn_recall()
    assert out["frac_within_tol"] >= chip_smoke.KNN_RECALL_FRAC


def test_pruned_fit_parity_at_bench_shape_on_gpu(gpu):
    """Default f32 fit vs the host-f64 full-landmark fit at 8,627 x 20."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from accuracy_cert import ARTIFACT, artifact_x

    fit = chip_smoke.phase_density_fit(artifact_x(), ARTIFACT, warm_runs=0)
    assert fit["cert"]["log_density_corr_vs_f64"] >= chip_smoke.FIT_MIN_CORR
    assert (
        fit["cert"]["rmse_frac_of_spread_vs_f64"]
        <= chip_smoke.FIT_MAX_RMSE_FRAC
    )
