"""CPU tests of ``chip_smoke.py``: every phase at a tiny size (the
four-device phase on virtual CPU devices), the device guard, and the
compilation-cache placement it shares with ``bench.py`` and ``scripts/``."""

import hashlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

import mellon_tpu  # noqa: E402
from mellon_tpu.utils.compile_cache import use_compile_cache  # noqa: E402


def _tiny_data(n=240, d=3, seed=0):
    x = chip_smoke.clustered_data(jax.random.PRNGKey(seed), n, d)
    return np.asarray(x, dtype=np.float32)


@pytest.fixture(scope="module")
def tiny_fit(tmp_path_factory):
    """phase_density_fit on tiny data against a stored f64 fit of it."""
    x = _tiny_data()
    ref = mellon_tpu.DensityEstimator(n_landmarks=60).fit_predict(
        jnp.asarray(x, dtype=jnp.float64)
    )
    artifact = str(tmp_path_factory.mktemp("cert") / "ref.npz")
    np.savez_compressed(
        artifact,
        x=x,
        log_density=np.asarray(ref, dtype=np.float64),
        x_sha=hashlib.sha256(np.ascontiguousarray(x).tobytes()).hexdigest(),
    )
    return x, artifact, chip_smoke.phase_density_fit(
        x, artifact, warm_runs=1, gram_landmarks=40, n_landmarks=60
    )


def test_phase_density_fit_tiny(tiny_fit):
    x, _, fit = tiny_fit
    assert fit["cert"]["log_density_corr_vs_f64"] >= chip_smoke.FIT_MIN_CORR
    assert 0 < fit["latent_dim"] <= fit["n_landmarks"] <= x.shape[0]
    assert fit["gram"]["bytes"] == x.shape[0] * 40 * 4
    assert fit["gram"]["max_abs_err"] <= 1e-5


def test_phase_density_fit_refuses_other_data(tiny_fit):
    """The certificate only holds for the data the reference was fit on."""
    x, artifact, _ = tiny_fit
    with pytest.raises(RuntimeError, match="different data"):
        chip_smoke.phase_density_fit(
            x[::-1].copy(), artifact, warm_runs=0, n_landmarks=60
        )


def test_phase_predictor_tiny(tiny_fit):
    x, _, fit = tiny_fit
    out = chip_smoke.phase_predictor(fit["estimator"], x[:50] + 0.01)
    assert out["roundtrip_max_abs_diff"] <= chip_smoke.PREDICTOR_ROUNDTRIP_TOL


def test_phase_knn_recall_tiny():
    out = chip_smoke.phase_knn_recall(n=600, d=20)
    assert out["frac_within_tol"] >= chip_smoke.KNN_RECALL_FRAC


def test_exact_nn_distances_f64_matches_brute_force():
    x = _tiny_data(n=300, d=4, seed=2)
    d = np.linalg.norm(
        x[:, None, :].astype(np.float64) - x[None, :, :], axis=-1
    )
    np.fill_diagonal(d, np.inf)
    np.testing.assert_allclose(
        chip_smoke.exact_nn_distances_f64(x), d.min(axis=1), rtol=1e-9
    )


def test_phase_ds_matmul_tiny():
    out = chip_smoke.phase_ds_matmul(n=64, k=300, widths=(1, 8))
    assert set(out) == {1, 8}
    assert all(r["worst_share_of_bound"] <= 1.0 for r in out.values())


def test_phase_nuts_tiny(tiny_fit):
    out = chip_smoke.phase_nuts(
        tiny_fit[2]["estimator"], num_chains=4, num_warmup=150,
        num_samples=150, rhat_max=1.1,
    )
    assert min(out["leapfrogs_per_draw"]) >= 1.0
    assert out["rhat_dims"] == tiny_fit[2]["latent_dim"]


def test_phase_four_cards_on_virtual_devices():
    devices = jax.devices()
    assert len(devices) >= 4, "tests run on 8 virtual CPU devices"
    out = chip_smoke.phase_four_cards(
        devices[:4], n=256, m=8, num_warmup=100, num_samples=100,
        max_tree_depth=4,
    )
    assert out["all_reduce_in_hlo"]
    assert out["max_mean_diff_mcse"] <= chip_smoke.MEAN_AGREEMENT_MCSE


@pytest.mark.parametrize("argv", [[], ["--four-cards"]])
def test_main_refuses_cpu(argv, capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main(argv)
    assert exc.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    assert use_compile_cache(str(tmp_path)) == str(tmp_path / "env")
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_into_checkout(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        got = use_compile_cache(str(tmp_path))
        assert got == str(tmp_path / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_repo_cache_dir_is_ignored_by_git():
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
