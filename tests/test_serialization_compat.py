"""Serialization interchange tests: our predictors load JSON written in the
reference's on-disk format (module names ``mellon.*``), including the
<1.4.0 migration path, and PredictorTime round-trips."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mellon_tpu import DensityEstimator, Predictor, TimeSensitiveDensityEstimator
from mellon_tpu.ops.kernels import Covariance, Matern52


@pytest.fixture(scope="module")
def fitted():
    x = jax.random.normal(jax.random.PRNGKey(0), (60, 2))
    est = DensityEstimator(n_landmarks=20)
    est.fit(x)
    return x, est


def test_load_reference_style_predictor_dict(fitted):
    """A dict with the reference's metadata (module 'mellon.conditional',
    class 'LandmarksConditionalCholesky') resolves onto our classes."""
    x, est = fitted
    state = est.predict.to_dict()
    expected = np.asarray(est.predict(x))

    # rewrite metadata to look like the reference wrote it
    state["metadata"]["module_name"] = "mellon.conditional"
    state["metadata"]["module_version"] = "1.7.1"
    state["cov_func"]["metadata"]["module_name"] = "mellon.cov"
    state["cov_func"]["metadata"]["module_version"] = "1.7.1"

    restored = Predictor.from_dict(json.loads(json.dumps(state)))
    np.testing.assert_allclose(np.asarray(restored(x)), expected, atol=1e-10)


def test_pre_140_migration(fitted):
    """Old predictors (<1.4.0) lack n_obs/_state_variables; the migration
    shim reconstructs them (parity: ``mellon/base_predictor.py:699-713``)."""
    x, est = fitted
    state = est.predict.to_dict()
    expected = np.asarray(est.predict(x))

    state["metadata"]["module_name"] = "mellon.conditional"
    state["metadata"]["module_version"] = "1.3.1"
    del state["data"]["n_obs"]
    del state["data"]["_state_variables"]
    state["data"].pop("d", None)
    state["data"].pop("d_method", None)

    restored = Predictor.from_dict(json.loads(json.dumps(state)))
    np.testing.assert_allclose(np.asarray(restored(x)), expected, atol=1e-10)
    assert restored.n_obs is None


def test_covariance_reference_module_resolution():
    cov = Matern52(ls=2.5)
    state = cov.to_dict()
    state["metadata"]["module_name"] = "mellon.cov"
    restored = Covariance.from_dict(json.loads(json.dumps(state)))
    assert isinstance(restored, Matern52)
    assert restored.ls == 2.5


def test_time_predictor_serialization_roundtrip(tmp_path):
    key = jax.random.PRNGKey(1)
    n_per = 30
    xs = jnp.concatenate(
        [jax.random.normal(jax.random.fold_in(key, i), (n_per, 2)) for i in range(2)]
    )
    times = jnp.concatenate([jnp.zeros(n_per), jnp.ones(n_per)])
    est = TimeSensitiveDensityEstimator(ls_time=1.0)
    est.fit(xs, times)

    pred = est.predict
    expected = np.asarray(pred(xs[:10], time=0.5))
    path = str(tmp_path / "time_predictor.json.gz")
    pred.to_json(path, compress="gzip")
    restored = Predictor.from_json(path)
    np.testing.assert_allclose(
        np.asarray(restored(xs[:10], time=0.5)), expected, atol=1e-10
    )
    # multi_time still works on the restored instance
    grid = jnp.asarray([0.0, 1.0])
    assert restored(xs[:5], multi_time=grid).shape == (5, 2)


def test_serialized_json_structure(fitted):
    """The JSON layout matches the reference contract: data/cov_func/metadata
    with typed array encoding."""
    _, est = fitted
    state = json.loads(est.predict.to_json())
    assert set(state.keys()) == {"data", "cov_func", "metadata"}
    assert state["cov_func"]["type"] == "mellon.Covariance"
    weights = state["data"]["weights"]
    assert weights["type"] == "jax.numpy"
    assert isinstance(weights["data"], list)
    assert "classname" in state["metadata"]


def test_own_version_does_not_trip_migration(fitted, caplog):
    """Our 0.x version numbers must not trigger the reference's <1.4.0
    migration path (caught by a verification probe)."""
    import logging

    x, est = fitted
    json_str = est.predict.to_json()
    with caplog.at_level(logging.WARNING, logger="mellon_tpu"):
        restored = Predictor.from_json_str(json_str)
    assert not any("1.4.0" in r.message for r in caplog.records)
    np.testing.assert_allclose(
        np.asarray(restored(x[:5])), np.asarray(est.predict(x[:5])), atol=1e-12
    )


# --- vendored fixtures actually written by the reference ------------------
#
# tests/fixtures/reference_*_predictor.json* were produced by running the
# REAL reference package (/root/reference, mellon v1.7.1) in this
# environment with its absent host deps (jaxopt, pynndescent) stubbed at
# module level only — the exercised paths (FunctionEstimator fit;
# DensityEstimator fit with optimizer="adam" and precomputed nn_distances)
# never call into either.  reference_fixture_data.npz records the inputs
# and the reference's own predictions, making the "loads reference JSON"
# claim load-bearing rather than simulated.


@pytest.fixture(scope="module")
def reference_fixture_dir():
    import pathlib

    d = pathlib.Path(__file__).parent / "fixtures"
    if not (d / "reference_fixture_data.npz").exists():
        pytest.skip("reference fixtures not present")
    return d


def test_load_genuine_reference_function_predictor(reference_fixture_dir):
    data = np.load(reference_fixture_dir / "reference_fixture_data.npz")
    pred = Predictor.from_json(
        str(reference_fixture_dir / "reference_function_predictor.json")
    )
    got = np.asarray(pred(jnp.asarray(data["x"])))
    np.testing.assert_allclose(got, data["fe_pred"], atol=1e-5)


def test_load_genuine_reference_density_predictor(reference_fixture_dir):
    data = np.load(reference_fixture_dir / "reference_fixture_data.npz")
    pred = Predictor.from_json(
        str(reference_fixture_dir / "reference_density_predictor.json.gz"),
        compress="gzip",
    )
    x = jnp.asarray(data["x"])
    np.testing.assert_allclose(np.asarray(pred(x)), data["de_pred"], atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(pred(x, normalize=True)), data["de_pred_norm"], atol=1e-5
    )


@pytest.mark.parametrize(
    "version, expected",
    [
        ("1.3.1", (1, 3, 1)),
        ("1.4.0rc1", (1, 4, 0)),
        ("v1.7", (1, 7)),
        ("dev", None),
    ],
)
def test_release_tuple(version, expected):
    """Version strings compare by their numeric release (the <1.4.0
    migration test), without a packaging dependency."""
    from mellon_tpu.inference.predictors import _release_tuple

    assert _release_tuple(version) == expected
