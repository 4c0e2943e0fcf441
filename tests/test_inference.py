"""Inference-layer tests: optimizers, ADVI, Laplace, likelihoods.

Mirrors the reference's ``tests/test_inference.py`` and ``tests/test_laplace.py``
strategy (SURVEY.md §4): optimizers converge on toy quadratics; the Laplace
std is exact on quadratic losses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mellon_tpu.inference import (
    compute_laplace_std,
    compute_loss_func,
    compute_transform,
    minimize_adam,
    minimize_lbfgsb,
    nearest_neighbors_likelihood,
    normal_prior,
    poisson_likelihood,
    run_advi,
)


def quad_loss(z):
    scales = jnp.asarray([1.0, 4.0, 0.25])
    return 0.5 * jnp.sum(scales * (z - jnp.asarray([1.0, -2.0, 3.0])) ** 2)


def test_lbfgs_converges_on_quadratic():
    res = minimize_lbfgsb(quad_loss, jnp.zeros(3))
    np.testing.assert_allclose(
        np.asarray(res.pre_transformation), [1.0, -2.0, 3.0], atol=1e-4
    )
    assert res.loss < 1e-8


def test_adam_reduces_loss():
    res = minimize_adam(quad_loss, jnp.zeros(3), n_iter=200)
    assert float(res.losses[-1]) < float(res.losses[0])
    np.testing.assert_allclose(
        np.asarray(res.pre_transformation), [1.0, -2.0, 3.0], atol=0.5
    )


def test_laplace_std_exact_on_quadratic():
    res = minimize_lbfgsb(quad_loss, jnp.zeros(3))
    stds = compute_laplace_std(quad_loss, res.pre_transformation)
    np.testing.assert_allclose(
        np.asarray(stds), 1 / np.sqrt([1.0, 4.0, 0.25]), atol=1e-5
    )


def test_laplace_std_clips_zero_curvature():
    flat_loss = lambda z: 0.5 * z[0] ** 2  # no curvature in z[1]
    stds = compute_laplace_std(flat_loss, jnp.zeros(2))
    assert float(stds[0]) == pytest.approx(1.0, abs=1e-5)
    assert float(stds[1]) == pytest.approx(1e4, rel=1e-3)  # 1/sqrt(1e-8)


def test_advi_matches_laplace_on_gaussian():
    # posterior is exactly Gaussian -> ADVI should find mean and stds
    res = run_advi(quad_loss, jnp.zeros(3), n_iter=600, init_learn_rate=0.1)
    np.testing.assert_allclose(
        np.asarray(res.pre_transformation), [1.0, -2.0, 3.0], atol=0.2
    )
    np.testing.assert_allclose(
        np.asarray(res.pre_transformation_std),
        1 / np.sqrt([1.0, 4.0, 0.25]),
        rtol=0.4,
    )


def test_nn_likelihood_peaks_at_mle():
    from mellon_tpu.utils.util import mle

    key = jax.random.PRNGKey(0)
    r = jax.random.uniform(key, (20,), minval=0.05, maxval=0.3)
    d = 2
    lik = nearest_neighbors_likelihood(r, d)
    opt_ld = mle(r, d)
    base = lik(opt_ld)
    for eps in [0.1, -0.1]:
        assert float(lik(opt_ld + eps)) < float(base)


def test_poisson_likelihood_finite():
    key = jax.random.PRNGKey(1)
    dist = jax.random.uniform(key, (10, 5), minval=0.05, maxval=0.5)
    lik = poisson_likelihood(dist)
    val = lik(2.0 * jnp.ones(10), jnp.zeros(10))
    assert np.isfinite(float(val))


def test_density_loss_pipeline():
    key = jax.random.PRNGKey(2)
    x = jax.random.normal(key, (30, 2))
    from mellon_tpu.ops import Matern52, _full_rank
    from mellon_tpu.ops.neighbors import nn_distances

    nn = nn_distances(x)
    cov = Matern52(ls=1.0)
    L = _full_rank(x, cov)
    transform = compute_transform(0.0, L)
    loss = compute_loss_func(nn, 2, transform, 30)
    z0 = jnp.zeros(30)
    res = minimize_lbfgsb(loss, z0)
    assert float(loss(res.pre_transformation)) < float(loss(z0))


def test_lbfgs_matches_scipy_on_density_loss():
    """Our on-device L-BFGS reaches the same optimum as scipy's L-BFGS-B
    (the reference's optimizer, ``mellon/inference.py:272-288``)."""
    from scipy.optimize import minimize as scipy_minimize

    key = jax.random.PRNGKey(5)
    x = jax.random.normal(key, (80, 2))
    from mellon_tpu.ops import Matern52, _standard_low_rank, _full_rank
    from mellon_tpu.ops.neighbors import nn_distances
    from mellon_tpu.parameters import compute_ls, compute_mu, compute_initial_value

    nn = nn_distances(x)
    ls = compute_ls(nn)
    mu = compute_mu(nn, 2)
    cov = Matern52(ls=ls)
    xu = x[:20]
    Lp = _full_rank(xu, cov)
    L = _standard_low_rank(x, cov, xu, Lp=Lp)
    z0 = compute_initial_value(nn, 2, mu, L)
    transform = compute_transform(mu, L)
    loss = compute_loss_func(nn, 2, transform, 20)

    ours = minimize_lbfgsb(loss, z0)

    val_grad = jax.value_and_grad(loss)
    scipy_res = scipy_minimize(
        lambda z: [np.asarray(v, dtype=np.float64) for v in val_grad(jnp.asarray(z))],
        np.asarray(z0),
        jac=True,
        method="L-BFGS-B",
    )
    # same optimum within optimizer termination tolerance
    assert ours.loss <= scipy_res.fun + 1e-3
    np.testing.assert_allclose(
        np.asarray(ours.pre_transformation), scipy_res.x, atol=5e-2
    )


def test_lbfgs_bf16_two_phase_matches_f32():
    """precision="bf16" two-phase L-BFGS reaches the f32 optimum on the
    density loss with f32 operands (the production device dtype)."""
    import numpy as np

    from mellon_tpu.inference.losses import density_loss
    from mellon_tpu.inference.optimizers import minimize_lbfgsb

    key = jax.random.PRNGKey(0)
    n, m = 500, 32
    L = (jax.random.normal(key, (n, m)) / jnp.sqrt(m)).astype(jnp.float32)
    nn = (0.05 + 0.3 * jax.random.uniform(jax.random.fold_in(key, 1), (n,))).astype(
        jnp.float32
    )
    args = (L, nn, 5.0, -3.0)
    z0 = jnp.zeros(m, dtype=jnp.float32)
    res_f32 = minimize_lbfgsb(density_loss, z0, loss_args=args)
    res_bf16 = minimize_lbfgsb(
        density_loss, z0, loss_args=args, precision="bf16"
    )
    assert abs(res_bf16.loss - res_f32.loss) < 1e-3 * abs(res_f32.loss)
    f_a = np.asarray(L @ res_f32.pre_transformation)
    f_b = np.asarray(L @ res_bf16.pre_transformation)
    assert np.corrcoef(f_a, f_b)[0, 1] > 0.999

    with pytest.raises(ValueError, match="precision"):
        minimize_lbfgsb(density_loss, z0, loss_args=args, precision="int8")


def test_lbfgs_bf16_without_loss_args_falls_back():
    """precision="bf16" with a closure-style loss (no threaded operands)
    must run the standard single-phase solve, not crash."""
    from mellon_tpu.inference.optimizers import minimize_lbfgsb

    res = minimize_lbfgsb(
        lambda z: jnp.sum((z - 3.0) ** 2), jnp.zeros(4), precision="bf16"
    )
    np.testing.assert_allclose(
        np.asarray(res.pre_transformation), np.full(4, 3.0), atol=1e-4
    )
