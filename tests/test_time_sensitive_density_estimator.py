"""TimeSensitiveDensityEstimator tests, mirroring the reference's
``tests/test_time_sensitive_density_estimator.py`` strategy (SURVEY.md §4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mellon_tpu import TimeSensitiveDensityEstimator


@pytest.fixture(scope="module")
def data():
    key = jax.random.PRNGKey(0)
    n_per = 40
    xs, ts = [], []
    for i, t in enumerate([0.0, 1.0, 2.0]):
        shift = 0.5 * t
        xs.append(
            jax.random.normal(jax.random.fold_in(key, i), (n_per, 2)) + shift
        )
        ts.append(jnp.full(n_per, t))
    return jnp.concatenate(xs), jnp.concatenate(ts)


@pytest.fixture(scope="module")
def fitted(data):
    x, times = data
    est = TimeSensitiveDensityEstimator(ls_time=1.5)
    est.fit(x, times)
    return est


def test_fit_shapes(data, fitted):
    x, _ = data
    assert fitted.log_density_x.shape == (x.shape[0],)
    assert fitted.x.shape == (x.shape[0], 3)  # time column appended


def test_product_kernel(fitted):
    # space x time product kernel with separate length scales
    rep = repr(fitted.cov_func)
    assert "*" in rep


def test_predict_at_time(data, fitted):
    x, times = data
    pred = fitted.predict(x[:10], time=0.0)
    assert pred.shape == (10,)
    assert np.all(np.isfinite(np.asarray(pred)))
    # scalar time is broadcast
    pred1 = fitted.predict(x[:10], time=jnp.zeros(10))
    np.testing.assert_allclose(np.asarray(pred), np.asarray(pred1), atol=1e-12)


def test_predictor_consistency(data, fitted):
    x, times = data
    pred = fitted.predict(x, time=times)
    ld = np.asarray(fitted.log_density_x)
    rel_err = np.max(np.abs(ld - np.asarray(pred))) / np.std(ld)
    assert rel_err < 1e-3


def test_multi_time(data, fitted):
    x, _ = data
    grid = jnp.asarray([0.0, 1.0, 2.0])
    preds = fitted.predict(x[:7], multi_time=grid)
    assert preds.shape == (7, 3)


def test_time_derivative(data, fitted):
    x, _ = data
    td = fitted.predict.time_derivative(x[:9], 1.0)
    assert td.shape == (9,)
    assert np.all(np.isfinite(np.asarray(td)))


def test_gradient_at_time(data, fitted):
    x, _ = data
    g = fitted.predict.gradient(x[:5], 1.0)
    assert g.shape == (5, 2)


def test_n_obs_average_cell_count(data, fitted):
    # predictor n_obs = average cells per time point
    assert fitted.predict.n_obs == pytest.approx(40.0)


def test_normalize_per_time_point(data):
    x, times = data
    est = TimeSensitiveDensityEstimator(ls_time=1.5, normalize_per_time_point=True)
    ld = est.fit_predict(x, times)
    assert np.all(np.isfinite(np.asarray(ld)))


def test_ls_time_heuristic(data):
    """Full auto ls_time estimation: nested per-time density fits."""
    x, times = data
    est = TimeSensitiveDensityEstimator()
    est.fit(x, times)
    assert est.ls_time is not None
    assert est.ls_time > 0


def test_too_few_samples_per_time_raises():
    x = jnp.ones((5, 2))
    times = jnp.asarray([0.0, 0.0, 1.0, 1.0, 2.0])
    est = TimeSensitiveDensityEstimator(ls_time=1.0)
    with pytest.raises(ValueError, match="Insufficient data"):
        est.fit(x, times)


def test_string_and_html_repr(fitted):
    assert len(str(fitted)) > 0
    assert len(fitted._repr_html_()) > 0


def test_multi_time_hessian_semantics(data, fitted):
    """Hessian with multi_time: equal time points give equal results and
    distinct ones differ (parity: reference
    ``test_time_sensitive_density_estimator.py:56-68``)."""
    x, _ = data
    n, d = x.shape
    multi = [1.0, 1.0, 2.0]
    hess = fitted.predict.hessian(x, multi_time=jnp.asarray(multi))
    assert hess.shape == (n, len(multi), d, d)
    np.testing.assert_array_equal(
        np.asarray(hess[:, 0]), np.asarray(hess[:, 1])
    )
    assert np.any(np.asarray(hess[:, 0]) != np.asarray(hess[:, 2]))
    sng, ld = fitted.predict.hessian_log_determinant(x, 1.0)
    assert sng.shape == (n,)
    assert ld.shape == (n,)


@pytest.mark.parametrize(
    "rank, n_landmarks, compress",
    [
        (1.0, 10, None),
        (0.99, 60, "gzip"),
        (0.99, 60, "bz2"),
    ],
)
def test_serialization_roundtrip(data, tmp_path, rank, n_landmarks, compress):
    import mellon_tpu

    x, times = data
    suffix = {"gzip": ".json.gz", "bz2": ".json.bz2", None: ".json"}[compress]
    test_file = str(tmp_path / f"predictor{suffix}")
    est = TimeSensitiveDensityEstimator(
        rank=rank, n_landmarks=n_landmarks, ls_time=1.5
    )
    est.fit(x, times)
    dens = est.predict(x, times)
    est.predict.to_json(test_file, compress=compress)
    predictor = mellon_tpu.Predictor.from_json(test_file, compress=compress)
    np.testing.assert_allclose(
        np.asarray(predictor(x, times)), np.asarray(dens), rtol=1e-6
    )


def test_serialization_with_uncertainty(data, tmp_path):
    """ADVI + uncertainty predictor roundtrip (parity: reference
    ``test_time_sensitive_density_estimator.py:168-213``)."""
    import mellon_tpu

    x, times = data
    n = x.shape[0]
    test_file = str(tmp_path / "predictor.json.gz")
    est = TimeSensitiveDensityEstimator(
        rank=0.99,
        n_landmarks=60,
        ls_time=1.5,
        optimizer="advi",
        predictor_with_uncertainty=True,
    )
    est.fit(x, times)
    dens = est.predict(x, times)
    assert est.predict.covariance(x, times).shape == (n,)
    assert est.predict.mean_covariance(x, times).shape == (n,)
    uncertainty = est.predict.uncertainty(x, times)
    assert uncertainty.shape == (n,)
    est.predict.to_json(test_file, compress="gzip")
    predictor = mellon_tpu.Predictor.from_json(test_file, compress="gzip")
    np.testing.assert_allclose(
        np.asarray(predictor(x, times)), np.asarray(dens), rtol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(predictor.uncertainty(x, times)),
        np.asarray(uncertainty),
        rtol=1e-6,
    )


def test_save_intermediate_ls_times(data):
    """_save_intermediate_ls_times exposes the per-time fits used by the
    ls_time heuristic (parity: reference ``:91-132``)."""
    x, times = data
    est = TimeSensitiveDensityEstimator(
        n_landmarks=20, _save_intermediate_ls_times=True
    )
    est.fit(x, times)
    assert hasattr(est, "densities")
    assert hasattr(est, "predictors")
    assert hasattr(est, "numeric_stages")
    assert est.landmarks.shape[0] == 20


def test_error_paths_and_staged_protocol(data):
    """Error semantics + staged protocol (parity: reference ``:215-257``)."""
    x, times = data
    Xt = jnp.concatenate([x, times[:, None]], axis=1)
    wide = jnp.concatenate([x] * 26 + [times[:, None]], axis=1)
    est = TimeSensitiveDensityEstimator(ls_time=1.5)

    with pytest.raises(ValueError):
        est.fit_predict()
    with pytest.raises(ValueError):
        est.fit(None)
    est.set_x(Xt)
    with pytest.raises(ValueError):
        est.prepare_inference(wide)
    loss_func, initial_value = est.prepare_inference(None)
    est.run_inference(loss_func, initial_value, "advi")
    est.process_inference(est.pre_transformation)
    with pytest.raises(ValueError):
        est.predict(x[:, :-1], times)
    with pytest.raises(ValueError):
        est.fit_predict(wide)
    est.fit_predict()
    est.predict.n_obs = None
    with pytest.raises(ValueError):
        est.predict(x, time=times, normalize=True)


@pytest.mark.parametrize(
    "normalization, different",
    [
        (False, False),
        # equal per-time counts make count-based normalization a no-op
        (True, False),
        ([4, 1000, 4], True),
        (jnp.array([4, 1000, 4]), True),
        ({0.0: 4, 1.0: 1000, 2.0: 4}, True),
    ],
)
def test_normalization_forms(data, fitted, normalization, different):
    """normalize_per_time_point accepts bool/list/array/dict forms
    (parity: reference ``:260-279``).  The unequal synthetic counts make
    any non-default normalization visibly change the densities."""
    x, times = data
    est = TimeSensitiveDensityEstimator(
        ls_time=1.5, normalize_per_time_point=normalization
    )
    est.fit(x, times)
    dens = np.asarray(est.predict(x, times))
    ref = np.asarray(fitted.log_density_x)
    rel = np.std(dens - ref) / np.std(ref)
    if different:
        assert rel > 1e-2
    else:
        assert rel < 1e-4


def test_fused_time_prepare_validates_normalize_dict(data):
    """The fused prepare must apply the same eager normalize validation as
    the lazy path: a dict missing a time point raises the documented
    ValueError, not a raw KeyError (review fix)."""
    x, times = data
    unique = np.unique(np.asarray(times))
    bad = {float(unique[0]): 50.0}  # missing the remaining time points
    est = TimeSensitiveDensityEstimator(
        ls_time=1.5, normalize_per_time_point=bad
    )
    with pytest.raises(ValueError):
        est.fit(x, times)


def test_batched_ls_time_matches_per_time_loop(data):
    """The batched masked FULL-GP ls_time path must reproduce the exact
    per-time-loop estimate (the padded latents carry zero gradient, so the
    masked fit is exact for the real cells)."""
    from mellon_tpu.models import ls_time as lt
    from mellon_tpu.ops.kernels import Matern52
    from mellon_tpu.parameters import compute_nn_distances_within_time_points
    from mellon_tpu.utils.validation import validate_time_x

    x, times = data
    xt = validate_time_x(x, times)
    nn = compute_nn_distances_within_time_points(xt)

    ls_batched = lt.compute_ls_time(nn, xt, Matern52)

    orig = lt._batched_ls_time_densities
    lt._batched_ls_time_densities = lambda *a, **k: None
    try:
        ls_loop = lt.compute_ls_time(nn, xt, Matern52)
    finally:
        lt._batched_ls_time_densities = orig

    assert ls_batched == pytest.approx(ls_loop, rel=2e-3)


def test_batched_ls_time_declines_unsupported_configs(data):
    """return_data, non-L-BFGS optimizers, fractal d, and unknown kwargs
    must fall back to the per-time loop (exact reference semantics)."""
    from mellon_tpu.models import ls_time as lt

    x, times = data
    nn = jnp.ones(x.shape[0]) * 0.3
    xt = jnp.concatenate([x, times[:, None]], axis=1)
    ut = jnp.unique(times)
    assert (
        lt._batched_ls_time_densities(
            xt, nn, None, {"optimizer": "adam"}, ut, 0
        )
        is None
    )
    assert (
        lt._batched_ls_time_densities(
            xt, nn, None, {"d_method": "fractal"}, ut, 0
        )
        is None
    )
    assert (
        lt._batched_ls_time_densities(
            xt, nn, None, {"n_landmarks": 10}, ut, 0
        )
        is None
    )


def test_batched_ls_time_rescue_ladder_matches_loop():
    """f32-singular per-time kernels (near-duplicate cells) must take the
    batched path's jitter-escalation / host-f64 rescue and still match the
    per-time loop (which rides safe_cholesky's identical ladder)."""
    from mellon_tpu.models import ls_time as lt
    from mellon_tpu.ops.kernels import Matern52
    from mellon_tpu.parameters import compute_nn_distances_within_time_points
    from mellon_tpu.utils.validation import validate_time_x

    key = jax.random.PRNGKey(4)
    xs, ts = [], []
    for i, t in enumerate([0.0, 1.0, 2.0]):
        base = jax.random.normal(jax.random.fold_in(key, i), (20, 2)) + 0.3 * t
        # tight triples around each base point -> ill-conditioned kernel
        jit3 = 1e-4 * jax.random.normal(jax.random.fold_in(key, 10 + i), (3, 20, 2))
        pts = (base[None, :, :] + jit3).reshape(-1, 2)
        xs.append(pts)
        ts.append(jnp.full(pts.shape[0], t))
    x = jnp.concatenate(xs)
    times = jnp.concatenate(ts)
    xt = validate_time_x(x, times)
    nn = compute_nn_distances_within_time_points(xt)

    ls_batched = lt.compute_ls_time(nn, xt, Matern52)
    assert np.isfinite(ls_batched) and ls_batched > 0

    orig = lt._batched_ls_time_densities
    lt._batched_ls_time_densities = lambda *a, **k: None
    try:
        ls_loop = lt.compute_ls_time(nn, xt, Matern52)
    finally:
        lt._batched_ls_time_densities = orig
    assert ls_batched == pytest.approx(ls_loop, rel=0.05)


def test_batched_ls_time_host_rescue_f32():
    """f32-singular per-time kernels must trigger the host-f64 rescue (which
    rebuilds each singular group's kernel from host coordinates rather than
    fetching the padded stack) and still produce finite densities and a
    valid ls_time."""
    import logging

    import jax
    import numpy as np

    from mellon_tpu.models.ls_time import compute_ls_time
    from mellon_tpu.ops.kernels import Matern52

    x64_was = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        rng = np.random.RandomState(0)
        groups = []
        for t in range(3):
            # tight clusters of near-duplicate points: with a wide kernel
            # the per-group covariance is numerically singular in f32
            centers = rng.randn(4, 2).astype(np.float32)
            pts = np.repeat(centers, 10, axis=0)
            pts += 1e-4 * rng.randn(*pts.shape).astype(np.float32)
            times = np.full((40, 1), float(t), dtype=np.float32)
            groups.append(np.hstack([pts, times]))
        xt = jnp.asarray(np.vstack(groups))
        nn = jnp.asarray(
            np.abs(rng.rand(120)).astype(np.float32) * 0.01 + 1e-4
        )

        records = []

        class Capture(logging.Handler):
            def emit(self, record):
                records.append(record.getMessage())

        handler = Capture()
        logging.getLogger("mellon_tpu").addHandler(handler)
        try:
            # jitter far below f32 resolution: the on-device ladder (3
            # escalations) cannot recover, deterministically forcing the
            # host-f64 rescue (whose own ladder starts at 1e-12)
            ls = compute_ls_time(
                nn,
                xt,
                Matern52,
                warn_below=2,
                density_estimator_kwargs={"ls": 30.0, "jitter": 1e-30},
            )
        finally:
            logging.getLogger("mellon_tpu").removeHandler(handler)
        assert np.isfinite(ls) and ls > 0
        assert any("factorizing those groups on the host" in m for m in records), records
    finally:
        jax.config.update("jax_enable_x64", x64_was)


def test_host_f64_cores_match_device_kernels():
    """The ls_time rescue rebuilds singular groups' kernels on the host
    from numpy re-implementations of the radial profiles; pin them to the
    device kernel definitions so a convention change in ops/kernels.py
    cannot silently make the rescue factorize a different matrix."""
    from mellon_tpu.models.ls_time import _HOST_F64_CORES
    from mellon_tpu.ops.kernels import ExpQuad, Exponential, Matern32, Matern52

    device_kernels = {
        "matern32": Matern32,
        "matern52": Matern52,
        "expquad": ExpQuad,
        "exponential": Exponential,
    }
    rs = np.random.RandomState(11)
    x = rs.randn(40, 3)
    for tag, host_core in _HOST_F64_CORES.items():
        ls = 1.7
        K_host = host_core(x, ls)
        K_dev = np.asarray(device_kernels[tag](ls)(jnp.asarray(x), jnp.asarray(x)))
        np.testing.assert_allclose(
            K_host, K_dev, rtol=1e-5, atol=1e-6, err_msg=tag
        )


def test_batched_loss_finite_on_overflowing_latents():
    """Zoom line-search trial points can push exp(F+V) past the f32 range;
    the batched loss must stay finite with finite gradients (and keep
    repelling) instead of producing 0*inf = NaN through the padding mask —
    the failure observed in f32 at the d=2 bench shape."""
    from mellon_tpu.models.ls_time import _batched_density_loss

    T, n_pad = 2, 4
    rs = np.random.RandomState(0)
    L = jnp.asarray(
        np.stack([np.eye(n_pad), np.eye(n_pad)]), dtype=jnp.float32
    )
    nng = jnp.asarray(rs.uniform(0.05, 0.2, (T, n_pad)), dtype=jnp.float32)
    mask = jnp.asarray(
        [[1, 1, 1, 0], [1, 1, 0, 0]], dtype=jnp.float32
    )
    mu = jnp.asarray([-5.0, -5.0], dtype=jnp.float32)
    d32 = jnp.asarray(2.0, dtype=jnp.float32)

    # latents large enough that F + V >> 88 (f32 exp overflow)
    z_big = jnp.full((T * n_pad,), 500.0, dtype=jnp.float32)
    loss_fn = lambda z: _batched_density_loss(z, L, nng, mask, mu, d32)
    val = loss_fn(z_big)
    grad = jax.grad(loss_fn)(z_big)
    assert np.isfinite(float(val))
    assert np.isfinite(np.asarray(grad)).all()
    # still repelling: even larger latents cost more
    assert float(loss_fn(2 * z_big)) > float(val)
    # padded latents carry only the prior gradient (= z itself)
    g = np.asarray(grad).reshape(T, n_pad)
    np.testing.assert_allclose(g[0, 3], 500.0, rtol=1e-5)
    np.testing.assert_allclose(g[1, 2:], 500.0, rtol=1e-5)
    # and in the sane regime the safe exp is exactly exp
    z_small = jnp.zeros((T * n_pad,), dtype=jnp.float32)
    F = mu[:, None] * jnp.ones((T, n_pad))
    const = float(
        d32 * jnp.log(jnp.pi) / 2
        - jax.scipy.special.gammaln(d32 / 2 + 1)
    )
    V = np.log(np.asarray(nng)) * 2.0 + const
    Vdr = np.log(2.0) + np.log(np.asarray(nng)) + const
    ref = -(
        -0.5 * 0.0
        - (T * n_pad / 2) * np.log(2 * np.pi)
        + float(
            jnp.sum(
                jnp.where(
                    mask > 0,
                    (jnp.asarray(F) + Vdr) - jnp.exp(jnp.asarray(F) + V),
                    0.0,
                )
            )
        )
    )
    np.testing.assert_allclose(float(loss_fn(z_small)), ref, rtol=1e-5)


def test_batched_ls_time_nonfinite_falls_back_to_loop(data, monkeypatch, caplog):
    """A diverged joint L-BFGS (non-finite loss) must never leak garbage
    densities into the ls fit: the batched path retries from zeros, then
    concedes to the exact per-time loop (observed in f32 at the d=2 bench
    shape where all rescued per-time factors are f32-singular)."""
    import logging

    from mellon_tpu.models import ls_time as lt
    from mellon_tpu.ops.kernels import Matern52
    from mellon_tpu.parameters import compute_nn_distances_within_time_points
    from mellon_tpu.utils.validation import validate_time_x

    x, times = data
    xt = validate_time_x(x, times)
    nn = compute_nn_distances_within_time_points(xt)

    class _Diverged:
        loss = float("nan")
        pre_transformation = None

    calls = {"n": 0}

    def fake_minimize(fn, z0, loss_args=()):
        calls["n"] += 1
        return _Diverged()

    monkeypatch.setattr(lt, "minimize_lbfgsb", fake_minimize)
    logger = logging.getLogger("mellon_tpu")
    logger.propagate = True  # the package config disables propagation
    try:
        with caplog.at_level(logging.WARNING, logger="mellon_tpu"):
            out = lt._batched_ls_time_densities(
                xt, nn, Matern52, {}, jnp.unique(xt[:, -1]), 0
            )
    finally:
        logger.propagate = False
    assert out is None
    assert calls["n"] == 2  # initial attempt + zero-init retry
    assert any("falling back to the exact per-time loop" in r.message
               for r in caplog.records)


def test_batched_ls_time_f32_rescue_uses_extended_precision(caplog):
    """f32 time-group kernels that defeat the jitter ladder take the
    host-f64 rescue, and the rescued groups' densities run through the
    extended-precision (double-single) predict; the f32 result must
    reproduce the f64 batched densities.

    Driven through _batched_ls_time_densities directly: the public
    compute_ls_time validates (and, in the x64 test env, promotes) its
    inputs, so genuine f32 numerics cannot be staged through it here.
    """
    import logging

    from mellon_tpu.models import ls_time as lt
    from mellon_tpu.ops.kernels import Matern52
    from mellon_tpu.parameters import compute_nn_distances_within_time_points

    rs = np.random.RandomState(0)
    T, per, d = 4, 120, 2
    # near-duplicate clusters + a saturating given ls: f32-singular
    # kernels; jitter far below f32 resolution keeps the in-ladder
    # escalation (x10, three tries) below the conditioning, as the 98k
    # d=2 bench shape does at full scale with the default jitter
    base = rs.randn(12, d) * 0.02
    xs, ts = [], []
    for t in range(T):
        pts = base[rs.randint(0, 12, per)] + 2e-4 * rs.randn(per, d)
        xs.append(pts + 0.005 * t)
        ts.append(np.full(per, float(t)))
    x32 = jnp.asarray(np.concatenate(xs), jnp.float32)
    t32 = jnp.asarray(np.concatenate(ts), jnp.float32)
    xt32 = jnp.concatenate([x32, t32[:, None]], axis=1)
    nn32 = jnp.asarray(
        np.asarray(compute_nn_distances_within_time_points(xt32)), jnp.float32
    )
    ut = np.unique(np.asarray(t32))
    kw = dict(jitter=1e-15, ls=1.0)

    logger = logging.getLogger("mellon_tpu")
    logger.propagate = True
    try:
        with caplog.at_level(logging.INFO, logger="mellon_tpu"):
            dens32 = lt._batched_ls_time_densities(
                xt32, nn32, Matern52, kw, ut, 500
            )
    finally:
        logger.propagate = False
    msgs = [r.message for r in caplog.records]
    assert any("factorizing those groups on the host" in m for m in msgs)
    assert any("double-single" in m for m in msgs), (
        "extended-precision predict did not engage for rescued groups"
    )
    assert dens32 is not None and dens32.dtype == jnp.float32
    assert bool(jnp.all(jnp.isfinite(dens32)))

    # f64 ground truth: the same batched procedure on promoted inputs
    # (factorizes on device in f64, no rescue)
    dens64 = lt._batched_ls_time_densities(
        xt32.astype(jnp.float64), nn32.astype(jnp.float64), Matern52, kw,
        ut, 500,
    )
    assert dens64 is not None and dens64.dtype == jnp.float64
    d32 = np.asarray(dens32, np.float64)
    d64 = np.asarray(dens64)
    for g in range(T):
        c = np.corrcoef(d32[g], d64[g])[0, 1]
        assert c > 0.99, f"group {g}: corr {c} vs f64 batched densities"
