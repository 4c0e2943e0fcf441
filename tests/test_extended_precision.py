"""Extended-precision (double-single) product tests: error-free slice
accumulation vs numpy float64, and the full-capacity whitening hook.

NEW capability (SURVEY.md §7 "Precision"): the
reference runs float64 on the host everywhere, so it has no counterpart —
these tests pin the accuracy contract that makes the f32 pipeline
match it at extreme kernel conditioning.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla

from mellon_tpu.ops.extended_precision import (
    _two_sum,
    ds_from_f64,
    ds_matmul,
    host_triangular_inverse_ds,
    whiten_with_hostf64,
)


def _mat52(X, Y, ls):
    xx = (X * X).sum(1)[:, None]
    yy = (Y * Y).sum(1)[None, :]
    sq = xx - 2 * X @ Y.T + yy + 1e-12
    r = np.sqrt(5.0) * np.sqrt(np.maximum(sq, 1e-12)) / ls
    return (r + r * r / 3 + 1) * np.exp(-r)


def _ill_conditioned_case(rs, m=400, n=1500, ls=200.0):
    """Replica of the 98k d=2 conditioning: product Matern52 kernel with a
    saturating length scale over clustered landmarks."""
    xu = np.concatenate(
        [rs.randn(m, 2) * 0.5, (np.arange(m) % 8)[:, None] * 1.0], axis=1
    )
    x = np.concatenate(
        [rs.randn(n, 2) * 0.5, rs.randint(0, 8, n)[:, None] * 1.0], axis=1
    )
    K = _mat52(xu[:, :2], xu[:, :2], ls) * _mat52(xu[:, 2:], xu[:, 2:], 0.375)
    Lp64 = np.linalg.cholesky(K + 1e-6 * np.eye(m))
    C = (
        _mat52(x[:, :2], xu[:, :2], ls) * _mat52(x[:, 2:], xu[:, 2:], 0.375)
    ).astype(np.float32)
    return x, xu, C, Lp64


def test_two_sum_exact():
    a = jnp.float32(1.0)
    b = jnp.float32(1e-8)
    s, e = _two_sum(a, b)
    # the rounded sum plus its error term reconstructs the exact value
    assert float(s) == 1.0
    assert float(e) == pytest.approx(1e-8, rel=1e-6)


def test_ds_from_f64_roundtrip():
    rs = np.random.RandomState(0)
    X = rs.randn(50, 40) * np.exp(3 * rs.randn(50, 40))
    hi, lo = ds_from_f64(X)
    back = np.asarray(hi, np.float64) + np.asarray(lo, np.float64)
    np.testing.assert_allclose(back, X, rtol=3e-15)


def test_ds_matmul_random_accuracy():
    rs = np.random.RandomState(1)
    A = rs.randn(200, 300).astype(np.float32)
    B64 = rs.randn(300, 100) * np.exp(rs.randn(300, 100))
    Bh, Bl = ds_from_f64(B64)
    ref = A.astype(np.float64) @ B64
    out = np.asarray(ds_matmul(jnp.asarray(A), Bh, Bl), np.float64)
    amp = np.abs(A).astype(np.float64) @ np.abs(B64)
    # the only surviving error is the final f32 rounding of the OUTPUT
    # (2^-24 relative to each entry) plus a ~2^-40-of-amplitude slicing
    # floor — far below the ~1e-7-of-amplitude f32 accumulation floor
    assert (np.abs(out - ref) <= 3e-7 * np.abs(ref) + 1e-8 * amp).all()


def test_ds_matmul_beats_f32_trsm_at_ill_conditioning():
    rs = np.random.RandomState(2)
    _, _, C, Lp64 = _ill_conditioned_case(rs)
    Bh, Bl = host_triangular_inverse_ds(Lp64)
    ref = sla.solve_triangular(Lp64, C.T.astype(np.float64), lower=True).T
    out = np.asarray(ds_matmul(jnp.asarray(C), Bh, Bl), np.float64)
    f32 = np.asarray(
        jax.scipy.linalg.solve_triangular(
            jnp.asarray(Lp64.astype(np.float32)), jnp.asarray(C).T, lower=True
        ).T,
        np.float64,
    )
    scale = np.sqrt((ref**2).mean())
    err_ds = np.sqrt(((out - ref) ** 2).mean()) / scale
    err_f32 = np.sqrt(((f32 - ref) ** 2).mean()) / scale
    assert err_ds < 1e-6
    assert err_ds < err_f32 / 100


def test_ds_matmul_row_blocking_consistent():
    rs = np.random.RandomState(3)
    A = rs.randn(70, 130).astype(np.float32)  # K not a CHUNK_K multiple
    B64 = rs.randn(130, 60)
    Bh, Bl = ds_from_f64(B64)
    full = np.asarray(ds_matmul(jnp.asarray(A), Bh, Bl))
    blocked = np.asarray(ds_matmul(jnp.asarray(A), Bh, Bl, block_rows=32))
    np.testing.assert_array_equal(full, blocked)


def test_whiten_with_hostf64_matches_f64_trsm():
    import mellon_tpu

    rs = np.random.RandomState(4)
    x, xu, _, Lp64 = _ill_conditioned_case(rs, m=300, n=900)
    cov = mellon_tpu.cov.Matern52(200.0, active_dims=slice(None, -1)) * (
        mellon_tpu.cov.Matern52(0.375, active_dims=-1)
    )
    xj = jnp.asarray(x, jnp.float32)
    xuj = jnp.asarray(xu, jnp.float32)
    # fully-f64 reference: the kernel VALUES are evaluated in f64 too —
    # the whitening path evaluates C in double-single arithmetic, so the
    # f32-rounded kernel is NOT the right comparison target
    from mellon_tpu.ops.extended_precision import host_spec_kernel_f64

    spec, params = cov.operand_spec()
    C64 = host_spec_kernel_f64(spec, params, xj, xuj)
    ref = sla.solve_triangular(Lp64, C64.T, lower=True).T
    out = np.asarray(
        whiten_with_hostf64(xj, cov, xuj, Lp64, block_rows=256), np.float64
    )
    scale = np.sqrt((ref**2).mean())
    assert np.sqrt(((out - ref) ** 2).mean()) / scale < 1e-5
    # and it must beat the f32-kernel + f32-TRSM route by far
    C32 = np.asarray(cov(xj, xuj), np.float64)
    f32route = np.asarray(
        jax.scipy.linalg.solve_triangular(
            jnp.asarray(Lp64.astype(np.float32)),
            jnp.asarray(C32, jnp.float32).T,
            lower=True,
        ).T,
        np.float64,
    )
    err_f32 = np.sqrt(((f32route - ref) ** 2).mean()) / scale
    err_ds = np.sqrt(((out - ref) ** 2).mean()) / scale
    assert err_ds < err_f32 / 50


def test_compute_L_uses_extended_precision_hook(caplog):
    """A (f32-singular, host-f64-factorized) no-prune estimator whitens L
    through the double-single path and matches the f64 TRSM."""
    import logging

    import mellon_tpu
    from mellon_tpu import config

    rs = np.random.RandomState(5)
    x, xu, _, Lp64 = _ill_conditioned_case(rs, m=200, n=500)
    est = mellon_tpu.DensityEstimator(n_landmarks=200, gp_type="sparse_cholesky")
    est.x = jnp.asarray(x, jnp.float32)
    est.landmarks = jnp.asarray(xu, jnp.float32)
    est.cov_func = mellon_tpu.cov.Matern52(
        200.0, active_dims=slice(None, -1)
    ) * mellon_tpu.cov.Matern52(0.375, active_dims=-1)
    est.gp_type = mellon_tpu.util.GaussianProcessType.SPARSE_CHOLESKY
    est.Lp = jnp.asarray(Lp64, jnp.float32)
    est._hostf64_Lp = Lp64
    est.check_rank = False

    logger = logging.getLogger("mellon_tpu")
    logger.propagate = True
    try:
        with caplog.at_level(logging.INFO, logger="mellon_tpu"):
            L = est._compute_L()
    finally:
        logger.propagate = False
    assert any(
        "double-single" in r.message for r in caplog.records
    ), "extended-precision whitening did not engage"

    from mellon_tpu.ops.extended_precision import host_spec_kernel_f64

    spec, params = est.cov_func.operand_spec()
    C64 = host_spec_kernel_f64(spec, params, est.x, est.landmarks)
    ref = sla.solve_triangular(Lp64, C64.T, lower=True).T
    scale = np.sqrt((ref**2).mean())
    assert np.sqrt(((np.asarray(L, np.float64) - ref) ** 2).mean()) / scale < 1e-5

    # the opt-out flag restores the plain path
    old = config.EXTENDED_PRECISION_WHITEN
    try:
        config.EXTENDED_PRECISION_WHITEN = False
        caplog.clear()
        logger.propagate = True
        with caplog.at_level(logging.INFO, logger="mellon_tpu"):
            est._compute_L()
        assert not any("double-single" in r.message for r in caplog.records)
    finally:
        config.EXTENDED_PRECISION_WHITEN = old
        logger.propagate = False


# ---------------------------------------------------------------------------
# double-single kernel evaluation: all six reference kernels + algebra
# (RatQuad/Linear/Pow cores were once absent; the others
# existed but lost ~6 digits on the r²/3 term through the python-float
# Dekker-split bug fixed in _coerce_working_dtype)
# ---------------------------------------------------------------------------


def _ds_case_kernels():
    from mellon_tpu.ops.kernels import (
        ExpQuad,
        Exponential,
        Linear,
        Matern32,
        Matern52,
        RatQuad,
    )

    # every parameter chosen exactly f32-representable so the f64 reference
    # and the double-single evaluation see identical inputs
    return {
        "matern52": Matern52(ls=1.703125),
        "matern32": Matern32(ls=1.703125),
        "expquad": ExpQuad(ls=1.703125),
        "exponential": Exponential(ls=1.703125),
        "ratquad": RatQuad(alpha=1.3125, ls=1.703125),
        "ratquad_sharp": RatQuad(alpha=0.5, ls=0.3125),
        "linear": Linear(ls=2.125),
        "pow": Matern52(ls=1.703125) ** 3.5,
        "mul": Matern52(ls=1.703125) * RatQuad(alpha=2.0, ls=0.875),
        "add": Linear(ls=3.0) + ExpQuad(ls=1.125),
    }


@pytest.mark.parametrize("name", sorted(_ds_case_kernels()))
def test_ds_kernel_cores_f64_equivalent(name):
    """ds_eval_operand_spec matches the f64 kernel evaluation to ~1e-12
    relative on all six reference kernels and their Add/Mul/Pow algebra
    (f32 evaluation of the same kernels is ~1e-6)."""
    from mellon_tpu.ops.extended_precision import ds_eval_operand_spec

    k = _ds_case_kernels()[name]
    rs = np.random.RandomState(0)
    x = jnp.asarray(rs.randn(120, 3).astype(np.float32) * 2)
    y = jnp.asarray(rs.randn(80, 3).astype(np.float32) * 2)
    spec, params = k.operand_spec()
    h, l = ds_eval_operand_spec(spec, params, x, y)
    got = np.asarray(h, dtype=np.float64) + np.asarray(l, dtype=np.float64)
    with jax.enable_x64(True):
        ref = np.asarray(
            k.k(
                jnp.asarray(np.asarray(x), jnp.float64),
                jnp.asarray(np.asarray(y), jnp.float64),
            )
        )
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() / scale < 1e-12


def test_ds_mul2_python_float_constant_exact():
    """Regression for the Dekker-split dtype bug: multiplying a ds pair by
    a python-float double-single constant (e.g. 1/3) must stay error-free;
    before the fix the constant's split ran at host f64 and the product
    lost ~6 digits (3e-6 absolute on r²/3 at r² ~ 50)."""
    from mellon_tpu.ops.extended_precision import _ds_const, ds_mul2

    third = _ds_const(1.0 / 3.0)
    r2 = jnp.asarray(np.linspace(0.01, 120.0, 4001, dtype=np.float32))
    h, l = ds_mul2(r2, jnp.zeros_like(r2), *third)
    got = np.asarray(h, np.float64) + np.asarray(l, np.float64)
    ref = np.asarray(r2, np.float64) * (
        np.float64(third[0]) + np.float64(third[1])
    )
    assert np.abs(got - ref).max() < 1e-11


def test_ds_pow_nonpositive_base_matches_f32():
    """Pow with non-positive bases falls back to the plain-precision
    semantics (0**b = 0, negative**fractional = NaN) instead of NaN-ing
    through log."""
    from mellon_tpu.ops.extended_precision import ds_pow2

    a = jnp.asarray(np.array([0.0, -1.5, 2.0], dtype=np.float32))
    z = jnp.zeros_like(a)
    b = jnp.asarray(np.float32(2.5))
    h, l = ds_pow2(a, z, b, jnp.zeros_like(b))
    got = np.asarray(h, np.float64) + np.asarray(l, np.float64)
    assert got[0] == 0.0
    assert np.isnan(got[1])
    assert got[2] == pytest.approx(2.0**2.5, rel=1e-12)
