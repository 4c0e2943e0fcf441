"""FunctionEstimator tests, mirroring the reference's
``tests/test_function_estimator.py``, ``tests/test_leverage.py``, and
``tests/test_pergene_sigma.py`` strategies (SURVEY.md §4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mellon_tpu import FunctionEstimator
from mellon_tpu.ops import Matern52
from mellon_tpu.utils.util import stabilize


@pytest.fixture(scope="module")
def data():
    key = jax.random.PRNGKey(0)
    x = jax.random.uniform(key, (60, 2), minval=-2, maxval=2)
    y = jnp.sin(x[:, 0]) + 0.5 * jnp.cos(2 * x[:, 1])
    return x, y


def test_fit_predict_interpolates(data):
    x, y = data
    est = FunctionEstimator(sigma=1e-3)
    got = est.fit_predict(x, y)
    np.testing.assert_allclose(np.asarray(got), np.asarray(y), atol=1e-2)


def test_extrapolation_smoothness(data):
    x, y = data
    est = FunctionEstimator(sigma=1e-3)
    est.fit(x, y)
    xnew = x + 0.01
    got = est.predict(xnew)
    np.testing.assert_allclose(np.asarray(got), np.asarray(y), atol=0.05)


def test_multioutput(data):
    x, y = data
    Y = jnp.stack([y, -2 * y], axis=1)
    est = FunctionEstimator(sigma=1e-3)
    got = est.fit_predict(x, Y)
    assert got.shape == (60, 2)
    np.testing.assert_allclose(np.asarray(got[:, 1]), -2 * np.asarray(got[:, 0]), atol=1e-4)


def test_sparse_close_to_full(data):
    x, y = data
    full = FunctionEstimator(sigma=1e-3, gp_type="full")
    got_full = full.fit_predict(x, y)
    sparse = FunctionEstimator(sigma=1e-3, n_landmarks=30)
    got_sparse = sparse.fit_predict(x, y)
    corr = np.corrcoef(np.asarray(got_full), np.asarray(got_sparse))[0, 1]
    assert corr > 0.99


def test_per_feature_sigma_matches_per_column_fits(data):
    """(p,) sigma fit must equal independent scalar-sigma fits per column
    (parity contract: reference ``tests/test_pergene_sigma.py:34-50``)."""
    x, y = data
    Y = jnp.stack([y, y**2], axis=1)
    sigmas = jnp.asarray([0.1, 0.3])
    est = FunctionEstimator(sigma=sigmas)
    got = est.fit_predict(x, Y)
    for j in range(2):
        single = FunctionEstimator(sigma=float(sigmas[j]))
        got_j = single.fit_predict(x, Y[:, j])
        # the scalar path adds sigma^2 I exactly while the per-feature path
        # stabilizes with jitter on top (same asymmetry as the reference),
        # so agreement is to ~jitter-amplified precision
        np.testing.assert_allclose(np.asarray(got[:, j]), np.asarray(got_j), atol=1e-4)


def test_leverage_matches_hat_matrix(data):
    """Leverage equals diag(K (K + sigma² I)⁻¹) explicitly
    (parity contract: reference ``tests/test_leverage.py:26-45``)."""
    x, y = data
    sigma = 0.2
    est = FunctionEstimator(sigma=sigma, gp_type="full")
    est.fit(x, y)
    h = np.asarray(est.leverage())

    cov = est.cov_func
    K = np.asarray(cov(x, x))
    H = K @ np.linalg.inv(
        np.asarray(stabilize(jnp.asarray(K + sigma**2 * np.eye(60)), est.jitter))
    )
    np.testing.assert_allclose(h, np.diag(H), atol=1e-4)
    assert np.all(h >= 0)
    assert np.all(h <= 1)


def test_sparse_leverage_correlates_with_full(data):
    x, y = data
    sigma = 0.2
    full = FunctionEstimator(sigma=sigma, gp_type="full")
    full.fit(x, y)
    h_full = np.asarray(full.leverage())
    sparse = FunctionEstimator(sigma=sigma, n_landmarks=30)
    sparse.fit(x, y)
    h_sparse = np.asarray(sparse.leverage())
    from scipy.stats import spearmanr

    rho = spearmanr(h_full, h_sparse).statistic
    assert rho > 0.8


def test_loo_residuals_and_obs_variance(data):
    x, y = data
    noise = 0.1 * jax.random.normal(jax.random.PRNGKey(3), y.shape)
    est = FunctionEstimator(sigma=0.1, obs_variance=True)
    est.fit(x, y + noise)
    r2 = np.asarray(est.loo_residuals_squared())
    assert r2.shape == (60,)
    assert np.all(r2 >= 0)
    var = np.asarray(est.get_obs_variance())
    assert var.shape == (60,)


def test_uncertainty(data):
    x, y = data
    est = FunctionEstimator(sigma=0.1, predictor_with_uncertainty=True)
    est.fit(x, y)
    var = est.predict.covariance(x[:5])
    assert var.shape == (5,)
    mean_var = est.predict.mean_covariance(x[:5])
    assert mean_var.shape == (5,)
    total = est.predict.uncertainty(x[:5])
    np.testing.assert_allclose(
        np.asarray(total), np.asarray(var) + np.asarray(mean_var), atol=1e-12
    )


def test_nystroem_gp_type_rejected():
    with pytest.raises(ValueError, match="Nyström"):
        FunctionEstimator(gp_type="sparse_nystroem")


def test_shape_mismatch_raises(data):
    x, y = data
    est = FunctionEstimator(sigma=0.1)
    with pytest.raises(ValueError):
        est.fit(x, y[:10])


def test_per_observation_per_feature_sigma(data):
    """(n, p) sigma: each observation/feature pair has its own noise level
    (parity contract: reference ``tests/test_perobservation_sigma.py``)."""
    x, y = data
    Y = jnp.stack([y, y**2], axis=1)
    key = jax.random.PRNGKey(5)
    sigma_np = 0.05 + 0.3 * jax.random.uniform(key, Y.shape)
    est = FunctionEstimator(sigma=sigma_np)
    got = est.fit_predict(x, Y)
    assert got.shape == Y.shape
    assert np.all(np.isfinite(np.asarray(got)))
    # down-weighting noisy observations: prediction tracks y where noise small
    resid = np.abs(np.asarray(got - Y))
    assert resid.mean() < 0.5


def test_sigma_shape_disambiguation(data):
    """(p,) vs (n,) ambiguity resolves to per-feature with a warning
    (parity: ``mellon/conditional.py:29-35``)."""
    from mellon_tpu.inference.conditionals import _is_per_feature_sigma

    # (p,) with y (n, p)
    assert _is_per_feature_sigma(jnp.ones(3), jnp.ones((10, 3)))
    # (1, p)
    assert _is_per_feature_sigma(jnp.ones((1, 3)), jnp.ones((10, 3)))
    # (n, p)
    assert _is_per_feature_sigma(jnp.ones((10, 3)), jnp.ones((10, 3)))
    # scalar is not per-feature
    assert not _is_per_feature_sigma(0.5, jnp.ones((10, 3)))
    # 1-d y is never per-feature
    assert not _is_per_feature_sigma(jnp.ones(10), jnp.ones(10))


def test_full_gp_per_feature_sigma(data):
    """Per-feature sigma on the FULL (no landmarks) conditional."""
    x, y = data
    Y = jnp.stack([y, -y], axis=1)
    est = FunctionEstimator(sigma=jnp.asarray([0.05, 0.2]), gp_type="full")
    got = est.fit_predict(x, Y)
    assert got.shape == Y.shape
    for j, s in enumerate([0.05, 0.2]):
        single = FunctionEstimator(sigma=s, gp_type="full")
        got_j = single.fit_predict(x, Y[:, j])
        np.testing.assert_allclose(
            np.asarray(got[:, j]), np.asarray(got_j), atol=1e-4
        )


@pytest.fixture
def propagate_logs():
    """The package logger has propagate=False (own stdout handler); caplog
    needs propagation on to observe records."""
    import logging

    logger = logging.getLogger("mellon_tpu")
    logger.propagate = True
    yield
    logger.propagate = False


def test_f32_singular_landmark_kernel_host_rescue(caplog, propagate_logs):
    """f32-singular landmark kernels must NOT silently degrade accuracy.

    With wide kernels over many landmarks the landmark kernel is numerically
    singular in float32; escalating jitter lets the Cholesky "succeed" while
    inflating prediction RMSE ~30x (observed on f32 FunctionEstimator fits).
    The conditional instead recomputes the weights on the host in float64.
    The estimator surface casts to f64 under this test suite's x64 config,
    so the conditional is driven directly with f32 operands (the production
    device dtype).  Regression for ``_host_f64_landmarks_weights``."""
    import logging

    from mellon_tpu.inference.conditionals import LandmarksConditional

    rs = np.random.RandomState(3)
    x32 = jnp.asarray(rs.randn(600, 4), dtype=jnp.float32)
    xu32 = jnp.asarray(rs.randn(200, 4), dtype=jnp.float32)
    Y32 = jnp.stack(
        [jnp.sin(x32[:, 0]), jnp.cos(x32[:, 1])], axis=1
    ).astype(jnp.float32)
    # ls far above the data spread -> K(xu, xu) ~ all-ones, f32-singular
    cov = Matern52(50.0)
    sigma = jnp.asarray([0.1, 0.2], dtype=jnp.float32)

    with caplog.at_level(logging.WARNING, logger="mellon_tpu"):
        cond = LandmarksConditional(
            x32, xu32, Y32, 0.0, cov, sigma=sigma, jitter=1e-6
        )
    assert any("singular at f32" in r.message for r in caplog.records)

    got = cond._mean(x32[:50])
    assert got.dtype == jnp.float32

    # independent float64 ground truth of the sparse-GP conditional mean
    x = np.asarray(x32, dtype=np.float64)
    xu = np.asarray(xu32, dtype=np.float64)
    Y = np.asarray(Y32, dtype=np.float64)
    K = np.asarray(cov(xu32, xu32), dtype=np.float64)
    Kuf = np.asarray(cov(xu32, x32), dtype=np.float64)
    jit64 = 1e-12
    while True:
        try:
            Lp = np.linalg.cholesky(K + jit64 * np.eye(200))
            break
        except np.linalg.LinAlgError:
            jit64 *= 10
    A = np.linalg.solve(Lp, Kuf)
    expected = []
    for j, s in enumerate([0.1, 0.2]):
        A_l, r_l = A / s**2, Y[:, j] / s**2
        L_B = np.linalg.cholesky(A_l @ A.T + np.eye(200))
        c = np.linalg.solve(L_B, A @ r_l)
        w = np.linalg.solve(Lp.T, np.linalg.solve(L_B.T, c))
        expected.append(np.asarray(cov(x32[:50], xu32), dtype=np.float64) @ w)
    expected = np.stack(expected, axis=1)
    scale = float(np.abs(expected).max())
    np.testing.assert_allclose(
        np.asarray(got, dtype=np.float64), expected, atol=2e-3 * scale
    )

    # scalar-sigma flavor of the same rescue exercises the other branch
    cond_s = LandmarksConditional(
        x32, xu32, Y32[:, 0], 0.0, cov, sigma=0.1, jitter=1e-6
    )
    got_s = cond_s._mean(x32[:50])
    np.testing.assert_allclose(
        np.asarray(got_s, dtype=np.float64),
        expected[:, 0],
        atol=2e-3 * scale,
    )


def test_predict_before_fit_raises_informative():
    """predict before fit must raise a clear 'not yet computed' error, not
    an AttributeError (review fix)."""
    est = FunctionEstimator()
    with pytest.raises(ValueError, match="not yet computed"):
        est.predict


def test_multi_fit_predict_1d_wrong_length_raises_shape_error():
    """A 1-D Y of wrong length must surface the informative shape error,
    not an IndexError from reading Y.shape[1] (review fix)."""
    key = jax.random.PRNGKey(5)
    x = jax.random.uniform(key, (30, 2), minval=-2, maxval=2)
    est = FunctionEstimator(n_landmarks=10)
    with pytest.raises((ValueError,)):
        est.multi_fit_predict(x, jnp.ones(7))
