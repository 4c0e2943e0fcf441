"""Sampler tests: NUTS/HMC correctness on analytic targets, agreement with
Laplace on the density model, chain sharding on the virtual 8-device mesh,
and checkpoint roundtrip.

These cover capabilities that are NEW relative to the reference (which has
no sampling); the Laplace-agreement test is the analogue of the reference's
``tests/test_laplace.py`` ADVI-vs-Laplace check, with NUTS as the gold
standard.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mellon_tpu.inference.diagnostics import (
    effective_sample_size,
    split_rhat,
    summarize,
)
from mellon_tpu.inference.mcmc import run_mcmc, sample_density_posterior


@pytest.fixture(scope="module")
def gaussian_target():
    cov = jnp.asarray([[2.0, 0.9], [0.9, 1.0]])
    prec = jnp.linalg.inv(cov)
    mean = jnp.asarray([1.0, -1.0])

    def pot(z):
        d = z - mean
        return 0.5 * d @ prec @ d

    return pot, np.asarray(mean), np.asarray(cov)


def test_nuts_recovers_gaussian(gaussian_target):
    pot, mean, cov = gaussian_target
    res = run_mcmc(
        pot,
        jnp.zeros(2),
        jax.random.PRNGKey(0),
        num_warmup=500,
        num_samples=1000,
        num_chains=4,
    )
    s = summarize(res.samples)
    np.testing.assert_allclose(s["mean"], mean, atol=0.1)
    np.testing.assert_allclose(s["std"], np.sqrt(np.diag(cov)), rtol=0.1)
    assert np.all(s["rhat"] < 1.05)
    assert np.all(s["ess"] > 200)
    assert int(np.asarray(res.diverging).sum()) == 0


def test_hmc_recovers_gaussian(gaussian_target):
    pot, mean, cov = gaussian_target
    res = run_mcmc(
        pot,
        jnp.zeros(2),
        jax.random.PRNGKey(1),
        num_warmup=500,
        num_samples=1000,
        num_chains=4,
        algorithm="hmc",
        num_leapfrog_steps=16,
    )
    s = summarize(res.samples)
    np.testing.assert_allclose(s["mean"], mean, atol=0.15)
    np.testing.assert_allclose(s["std"], np.sqrt(np.diag(cov)), rtol=0.15)


def test_nuts_mass_adaptation_scaled_target():
    """Badly scaled Gaussian: the adapted diagonal mass must absorb the
    scale difference."""
    scales = jnp.asarray([0.01, 1.0, 100.0])

    def pot(z):
        return 0.5 * jnp.sum(jnp.square(z / scales))

    res = run_mcmc(
        pot,
        jnp.zeros(3),
        jax.random.PRNGKey(2),
        num_warmup=800,
        num_samples=1000,
        num_chains=4,
    )
    s = summarize(res.samples)
    np.testing.assert_allclose(s["std"], np.asarray(scales), rtol=0.25)
    # inverse mass should reflect the variances over orders of magnitude
    ratio = np.asarray(res.inv_mass_diag)
    assert ratio[2] / ratio[0] > 1e4


def test_nuts_agrees_with_laplace_on_density_model():
    """Posterior std from NUTS ≈ diagonal Laplace on a near-Gaussian
    density posterior (the BASELINE acceptance criterion within MC error)."""
    from mellon_tpu import DensityEstimator
    from mellon_tpu.inference.laplace import compute_laplace_std

    x = jax.random.normal(jax.random.PRNGKey(3), (50, 2))
    est = DensityEstimator()
    est.prepare_inference(x)
    est.run_inference()

    laplace_std = np.asarray(
        compute_laplace_std(est.loss_func, est.pre_transformation)
    )

    res, f_samples = sample_density_posterior(
        est, num_warmup=400, num_samples=400, num_chains=4, seed=4
    )
    s = summarize(res.samples)
    assert np.all(s["rhat"] < 1.1)
    # MAP vs posterior mean
    corr = np.corrcoef(np.asarray(est.pre_transformation), s["mean"])[0, 1]
    assert corr > 0.5
    # Laplace std vs MCMC std: same scale on average
    ratio = s["std"].mean() / laplace_std.mean()
    assert 0.5 < ratio < 2.0
    # function samples: mean log-density close to MAP log-density
    f_mean = np.asarray(f_samples.mean(axis=0))
    ld = np.asarray(est.process_inference(build_predict=False))
    assert np.corrcoef(f_mean, ld)[0, 1] > 0.9


def test_chain_sharding_on_mesh():
    """Chains sharded over the 8 virtual devices produce valid samples."""
    from mellon_tpu.parallel import chain_sharding, create_mesh

    mesh = create_mesh(n_chains=8, n_cells=1)

    def pot(z):
        return 0.5 * jnp.sum(z**2)

    z0 = jnp.zeros((8, 2))
    res = run_mcmc(
        pot,
        z0,
        jax.random.PRNGKey(5),
        num_warmup=200,
        num_samples=200,
        num_chains=8,
        chain_sharding=chain_sharding(mesh),
    )
    s = summarize(res.samples)
    np.testing.assert_allclose(s["mean"], np.zeros(2), atol=0.15)
    np.testing.assert_allclose(s["std"], np.ones(2), rtol=0.15)


def test_cell_sharded_loss_matches_single_device():
    """The cell-sharded loss is numerically identical to the local loss."""
    from mellon_tpu import DensityEstimator
    from mellon_tpu.parallel import create_mesh, sharded_loss_from_estimator

    x = jax.random.normal(jax.random.PRNGKey(6), (64, 2))
    est = DensityEstimator()
    est.prepare_inference(x)

    mesh = create_mesh(n_chains=1, n_cells=8)
    sharded_loss = sharded_loss_from_estimator(est, mesh)
    z = 0.1 * jnp.ones_like(est.initial_value)
    local = float(est.loss_func(z))
    sharded = float(jax.jit(sharded_loss)(z))
    assert local == pytest.approx(sharded, rel=1e-10)
    # gradients too
    g_local = np.asarray(jax.grad(est.loss_func)(z))
    g_sharded = np.asarray(jax.jit(jax.grad(sharded_loss))(z))
    np.testing.assert_allclose(g_local, g_sharded, rtol=1e-8)


def test_checkpoint_roundtrip(tmp_path):
    from mellon_tpu.inference.samplers import HMCState
    from mellon_tpu.parallel import load_sampler_state, save_sampler_state

    state = HMCState(
        jnp.arange(4.0), jnp.asarray(1.5), jnp.asarray([0.1, 0.2, 0.3, 0.4])
    )
    path = str(tmp_path / "ckpt.npz")
    save_sampler_state(
        path,
        state=state,
        step_size=jnp.asarray(0.3),
        inv_mass_diag=jnp.ones(4),
        metadata={"algorithm": "nuts"},
    )
    loaded = load_sampler_state(path, state_template=state)
    np.testing.assert_allclose(np.asarray(loaded["state"].z), np.arange(4.0))
    assert float(loaded["step_size"]) == pytest.approx(0.3)
    assert loaded["metadata"]["algorithm"] == "nuts"
    # base name and full .npz name must address the same checkpoint
    # (including the metadata sidecar)
    loaded2 = load_sampler_state(str(tmp_path / "ckpt"), state_template=state)
    assert loaded2["metadata"]["algorithm"] == "nuts"
    np.testing.assert_allclose(
        np.asarray(loaded2["inv_mass_diag"]), np.ones(4)
    )


def test_diagnostics_on_iid_samples():
    key = jax.random.PRNGKey(7)
    samples = jax.random.normal(key, (4, 500, 3))
    rhat = split_rhat(samples)
    np.testing.assert_allclose(rhat, 1.0, atol=0.05)
    ess = effective_sample_size(samples)
    assert np.all(ess > 1000)  # iid -> ess ~ total draws


def test_ess_matches_ar1_ground_truth():
    """For an AR(1) chain with coefficient phi, the integrated
    autocorrelation time is (1+phi)/(1-phi), so
    ESS = N / tau — check the estimator recovers it within sampling noise."""
    rng = np.random.RandomState(0)
    phi = 0.7
    c, n = 8, 4000
    x = np.zeros((c, n))
    innov = rng.randn(c, n) * np.sqrt(1 - phi**2)
    for t in range(1, n):
        x[:, t] = phi * x[:, t - 1] + innov[:, t]
    ess = effective_sample_size(x[:, :, None])
    expected = c * n * (1 - phi) / (1 + phi)
    assert 0.7 * expected < float(ess[0]) < 1.4 * expected, (
        float(ess[0]),
        expected,
    )


def test_ess_detects_stuck_chain():
    """A constant (stuck) dimension must not report a large ESS."""
    rng = np.random.RandomState(1)
    good = rng.randn(4, 500)
    stuck = np.zeros((4, 500)) + rng.randn(4, 1)  # constant per chain
    samples = np.stack([good, stuck], axis=-1)
    rhat = split_rhat(samples)
    assert float(rhat[1]) > 1.1  # disagreeing constant chains -> large rhat


def test_estimator_nuts_optimizer():
    """optimizer='nuts' on the estimator: full posterior with std summary."""
    from mellon_tpu import DensityEstimator

    x = jax.random.normal(jax.random.PRNGKey(11), (40, 2))
    est = DensityEstimator(optimizer="nuts", n_iter=200)
    ld = est.fit_predict(x)
    assert np.all(np.isfinite(np.asarray(ld)))
    assert est.pre_transformation_std is not None
    assert est.posterior_samples.shape[0] == 4  # chains
    # MAP-style estimate should agree with the posterior mean path
    est_map = DensityEstimator()
    ld_map = est_map.fit_predict(x)
    assert np.corrcoef(np.asarray(ld), np.asarray(ld_map))[0, 1] > 0.95


def test_estimator_smc_optimizer():
    from mellon_tpu import DensityEstimator

    x = jax.random.normal(jax.random.PRNGKey(12), (40, 2))
    est = DensityEstimator(optimizer="smc")
    ld = est.fit_predict(x)
    assert np.all(np.isfinite(np.asarray(ld)))
    assert est.pre_transformation_std is not None


def test_streaming_knn_matches_exact():
    import mellon_tpu.ops.neighbors as nb

    x = jax.random.normal(jax.random.PRNGKey(13), (300, 3))
    expected = np.asarray(nb.knn_distances(x, 4))
    old = nb.DEFAULT_COL_BLOCK
    try:
        nb.DEFAULT_COL_BLOCK = 64  # force the column-streamed path
        got = np.asarray(nb.knn_distances(x, 4))
    finally:
        nb.DEFAULT_COL_BLOCK = old
    np.testing.assert_allclose(got, expected, atol=1e-6)


def test_bf16_precision_sampling():
    """precision='bf16' samples a posterior indistinguishable (to MC error)
    from the f32 posterior."""
    from mellon_tpu import DensityEstimator

    x = jax.random.normal(jax.random.PRNGKey(21), (60, 2)).astype(jnp.float32)
    est = DensityEstimator(n_landmarks=20)
    est.prepare_inference(x)
    est.run_inference()
    res32, f32s = sample_density_posterior(
        est, num_warmup=200, num_samples=200, num_chains=2, seed=5
    )
    res16, f16s = sample_density_posterior(
        est, num_warmup=200, num_samples=200, num_chains=2, seed=5,
        precision="bf16",
    )
    m32 = np.asarray(f32s.mean(axis=0))
    m16 = np.asarray(f16s.mean(axis=0))
    assert np.corrcoef(m32, m16)[0, 1] > 0.99
    with pytest.raises(ValueError, match="precision"):
        sample_density_posterior(est, precision="fp8")


def test_nuts_non_gaussian_target():
    """Log-gamma target: exact non-Gaussian moments (mean=digamma(3),
    var=trigamma(3)) — catches detailed-balance errors a Gaussian can't."""
    from scipy.special import polygamma, digamma

    def pot(z):
        return -(3.0 * z[0] - jnp.exp(z[0]))  # z = log g, g ~ Gamma(3, 1)

    res = run_mcmc(
        pot,
        jnp.zeros(1),
        jax.random.PRNGKey(30),
        num_warmup=500,
        num_samples=2000,
        num_chains=4,
    )
    s = summarize(res.samples)
    assert np.all(s["rhat"] < 1.02)
    np.testing.assert_allclose(s["mean"][0], digamma(3.0), atol=0.05)
    np.testing.assert_allclose(
        s["std"][0], np.sqrt(polygamma(1, 3.0)), rtol=0.08
    )


def test_nuts_step_returns_gradient_at_proposal():
    """The transition hands off tree.grad_proposal as the new state's
    gradient (no recompute); it must equal grad(potential) at the returned
    position or the NEXT transition's first leapfrog would be corrupted."""
    from mellon_tpu.inference.samplers import hmc_init, nuts_kernel

    def potential(z):
        return 0.5 * jnp.sum(z**2 * jnp.arange(1.0, 4.0))

    step = nuts_kernel(potential, max_tree_depth=6)
    state = hmc_init(potential, jnp.asarray([0.5, -1.0, 2.0]))
    inv_mass = jnp.ones(3)
    key = jax.random.PRNGKey(3)
    for i in range(5):
        key, sub = jax.random.split(key)
        state, _ = step(state, sub, 0.2, inv_mass)
        np.testing.assert_allclose(
            np.asarray(state.grad),
            np.asarray(jax.grad(potential)(state.z)),
            rtol=1e-6,
        )
        np.testing.assert_allclose(
            float(state.potential), float(potential(state.z)), rtol=1e-6
        )


def test_shard_predict_matches_single_device(density_fit_mesh=None):
    """Sharded predictor evaluation over the cells axis must equal the
    plain predictor at every query point."""
    from mellon_tpu import DensityEstimator
    from mellon_tpu.parallel.mesh import create_mesh
    from mellon_tpu.parallel.sharding import shard_predict

    key = jax.random.PRNGKey(6)
    x = jax.random.normal(key, (96, 3))
    est = DensityEstimator(n_landmarks=20)
    est.fit(x)
    pred = est.predict

    mesh = create_mesh(n_chains=1, n_cells=8)
    sharded = shard_predict(pred, mesh)
    Xnew = jax.random.normal(jax.random.fold_in(key, 1), (64, 3))
    got = np.asarray(sharded(Xnew))
    want = np.asarray(pred(Xnew))
    np.testing.assert_allclose(got, want, atol=1e-5)
    got_n = np.asarray(sharded(Xnew, normalize=True))
    want_n = np.asarray(pred(Xnew, normalize=True))
    np.testing.assert_allclose(got_n, want_n, atol=1e-5)


def test_estimator_sampler_options():
    """Constructor-level sampler configuration reaches the NUTS run and the
    estimator reports the north-star ESS/s metric."""
    from mellon_tpu import DensityEstimator

    x = jax.random.normal(jax.random.PRNGKey(14), (40, 2))
    est = DensityEstimator(
        optimizer="nuts",
        sampler_options={
            "num_chains": 2,
            "num_warmup": 150,
            "num_samples": 120,
            "target_accept": 0.9,
        },
    )
    ld = est.fit_predict(x)
    assert np.all(np.isfinite(np.asarray(ld)))
    assert est.posterior_samples.shape[0] == 2
    assert est.posterior_samples.shape[1] == 120
    assert est.ess.shape == (est.posterior_samples.shape[-1],)
    assert np.all(np.isfinite(est.ess))
    assert est.ess_per_second > 0
    assert est.sampling_time > 0


def test_estimator_sampler_options_smc():
    from mellon_tpu import DensityEstimator

    x = jax.random.normal(jax.random.PRNGKey(15), (40, 2))
    est = DensityEstimator(
        optimizer="smc",
        sampler_options={"num_particles": 256, "num_mutation_steps": 3},
    )
    ld = est.fit_predict(x)
    assert np.all(np.isfinite(np.asarray(ld)))
    assert est.posterior_samples.shape[0] == 256


def test_estimator_sampler_options_validation():
    from mellon_tpu import DensityEstimator

    with pytest.raises(ValueError, match="Unknown sampler_options"):
        DensityEstimator(sampler_options={"chains": 4})
    with pytest.raises(ValueError, match="positive number"):
        DensityEstimator(sampler_options={"num_chains": -1})
    with pytest.raises(ValueError, match="must be a dict"):
        DensityEstimator(sampler_options=[("num_chains", 4)])
    # count-valued options must be whole numbers: the sampler paths
    # int()-cast, so 0.5 would silently become 0 chains/particles
    with pytest.raises(ValueError, match="positive integer"):
        DensityEstimator(sampler_options={"num_chains": 0.5})
    with pytest.raises(ValueError, match="positive integer"):
        DensityEstimator(sampler_options={"num_particles": 0.9})
    with pytest.raises(ValueError, match="positive number"):
        DensityEstimator(sampler_options={"num_chains": True})
    # whole-valued floats and genuine floats for float options are fine
    DensityEstimator(sampler_options={"num_chains": 4.0})
    DensityEstimator(sampler_options={"target_accept": 0.9})


def test_chunked_execution_matches_monolithic(gaussian_target):
    """steps_per_call splits the run into short chunk programs with sampler
    state carried on device; the posterior estimates must agree with the
    monolithic program (same procedure, different PRNG folding) and the
    warmup products (step size, mass matrix) must be close."""
    pot, mean, cov = gaussian_target
    kwargs = dict(
        num_warmup=300,
        num_samples=600,
        num_chains=4,
        initial_step_size=0.2,
    )
    mono = run_mcmc(pot, jnp.zeros(2), jax.random.PRNGKey(0), **kwargs)
    # chunk size that does NOT divide the phase lengths (30/240/30/600):
    # exercises the remainder-chunk programs too
    chunked = run_mcmc(
        pot, jnp.zeros(2), jax.random.PRNGKey(0), steps_per_call=64, **kwargs
    )

    for res in (mono, chunked):
        assert res.samples.shape == (4, 600, 2)
        assert np.isfinite(np.asarray(res.samples)).all()

    flat_m = np.asarray(mono.samples).reshape(-1, 2)
    flat_c = np.asarray(chunked.samples).reshape(-1, 2)
    np.testing.assert_allclose(flat_c.mean(axis=0), mean, atol=0.15)
    np.testing.assert_allclose(
        np.cov(flat_c.T), cov, atol=0.4
    )
    np.testing.assert_allclose(
        flat_c.mean(axis=0), flat_m.mean(axis=0), atol=0.15
    )
    # adapted warmup products agree to sampling noise
    assert float(chunked.step_size) == pytest.approx(
        float(mono.step_size), rel=0.6
    )
    np.testing.assert_allclose(
        np.asarray(chunked.inv_mass_diag),
        np.asarray(mono.inv_mass_diag),
        rtol=0.6,
    )
    rhat = split_rhat(np.asarray(chunked.samples))
    assert rhat.max() < 1.05


def test_estimator_nuts_steps_per_call_option():
    """sampler_options={'steps_per_call': K} routes the estimator's NUTS
    fit through the chunked driver."""
    from mellon_tpu import DensityEstimator

    x = jax.random.normal(jax.random.PRNGKey(3), (60, 2))
    est = DensityEstimator(
        n_landmarks=20,
        optimizer="nuts",
        sampler_options={
            "num_warmup": 60,
            "num_samples": 60,
            "num_chains": 2,
            "steps_per_call": 16,
        },
    )
    ld = est.fit_predict(x)
    assert np.isfinite(np.asarray(ld)).all()
    assert est.posterior_samples.shape[1] == 60


def test_hessian_preconditioned_sampling_fixes_ill_conditioning():
    """On a badly-scaled correlated Gaussian, diagonal-mass NUTS with a
    shallow depth cap random-walks (trees max out), while the MAP-Hessian
    preconditioner makes the target near-isotropic: trees turn early,
    Rhat converges and the posterior matches the analytic moments."""
    from mellon_tpu.inference.mcmc import (
        hessian_cholesky,
        precondition_transform,
        preconditioned_potential,
        unwhiten_samples,
    )

    rs = np.random.RandomState(0)
    dim = 24
    # strongly correlated covariance with ~1e6 condition number (the f32
    # Hessian Cholesky handles ~1/sqrt(eps_f32) conditioning)
    Q, _ = np.linalg.qr(rs.randn(dim, dim))
    scales = np.logspace(-1.5, 1.5, dim)
    cov = (Q * scales**2) @ Q.T
    prec = jnp.asarray(np.linalg.inv(cov), jnp.float32)
    mean = jnp.asarray(rs.randn(dim), jnp.float32)

    def pot(z, prec, mean):
        d = z - mean
        return 0.5 * d @ prec @ d

    args = (prec, mean)
    R = hessian_cholesky(pot, mean, jnp.asarray(1e-10, jnp.float32), *args)
    # R Rᵀ must reproduce the precision matrix
    np.testing.assert_allclose(
        np.asarray(R @ R.T), np.asarray(prec), rtol=2e-3, atol=1e-4
    )

    T = precondition_transform(R)
    pot_w = preconditioned_potential(pot)
    res = run_mcmc(
        pot_w,
        jnp.zeros(dim),
        jax.random.PRNGKey(0),
        num_warmup=300,
        num_samples=600,
        num_chains=4,
        max_tree_depth=6,
        potential_args=(T, mean) + args,
    )
    assert int(np.asarray(res.diverging).sum()) == 0
    # trees turn: far below the 63-leapfrog depth-6 cap on average
    lf_per_draw = float(np.asarray(res.num_leapfrog).mean())
    assert lf_per_draw < 40
    z = unwhiten_samples(res.samples, T, mean)
    flat = np.asarray(z).reshape(-1, dim)
    rhat = split_rhat(np.asarray(z))
    assert rhat.max() < 1.05
    # moments of the worst-scaled directions match analytically
    proj = flat @ np.asarray(Q)
    np.testing.assert_allclose(
        proj.std(axis=0), scales, rtol=0.35
    )
    np.testing.assert_allclose(
        flat.mean(axis=0), np.asarray(mean),
        atol=3 * scales.max() / np.sqrt(len(flat) / 50),
    )


def test_estimator_nuts_precondition_option():
    """sampler_options={'precondition': 'hessian'} fits through the
    dense-metric transform and returns z-space draws whose field matches
    the plain NUTS fit."""
    from mellon_tpu import DensityEstimator

    x = jax.random.normal(jax.random.PRNGKey(5), (80, 2))
    plain = DensityEstimator(
        n_landmarks=24, optimizer="nuts",
        sampler_options={"num_warmup": 100, "num_samples": 150,
                         "num_chains": 2},
    )
    ld_plain = np.asarray(plain.fit_predict(x))
    pre = DensityEstimator(
        n_landmarks=24, optimizer="nuts",
        sampler_options={"num_warmup": 100, "num_samples": 150,
                         "num_chains": 2, "precondition": "hessian"},
    )
    ld_pre = np.asarray(pre.fit_predict(x))
    assert np.isfinite(ld_pre).all()
    assert np.corrcoef(ld_pre, ld_plain)[0, 1] > 0.95
    # posterior_samples are z-space: their mean field must track the fit
    assert pre.posterior_samples.shape[:2] == (2, 150)

    with pytest.raises(ValueError, match="must be one of"):
        DensityEstimator(
            optimizer="nuts", sampler_options={"precondition": "dense"}
        )


def test_density_loss_vmap_matches_single_eval():
    """The chain-vmapped potential must equal the per-chain evaluation.

    Under ``vmap`` the per-chain L matvec becomes a matmul; without
    ``losses.MATVEC_PRECISION`` the default reduced-precision product put
    ~1e-3-relative, high-frequency-in-z rounding on the sampled potential
    surface — the root cause of the round-3/4 north-star mixing failure
    (trees maxed at any depth, step-size collapse, Rhat in the hundreds).
    """
    from mellon_tpu.inference.losses import density_loss

    key = jax.random.PRNGKey(0)
    n, m = 20_000, 256
    L = jax.random.normal(key, (n, m), dtype=jnp.float32) / jnp.sqrt(m)
    nn = 0.05 + 0.3 * jax.random.uniform(
        jax.random.fold_in(key, 1), (n,), dtype=jnp.float32
    )
    args = (L, nn, 10.0, -6.0)
    z = 0.1 * jax.random.normal(jax.random.fold_in(key, 2), (8, m))
    v_vmap = np.asarray(jax.vmap(lambda zz: density_loss(zz, *args))(z))
    v_single = np.asarray(
        jnp.stack([density_loss(z[i], *args) for i in range(8)])
    )
    # identical code path up to batching; only matmul-pass rounding can
    # separate them — require agreement far below one nat
    np.testing.assert_allclose(v_vmap, v_single, rtol=0, atol=5e-2)


def test_nuts_mixes_on_large_density_model():
    """Regression for the matmul-precision mixing failure at realistic
    scale: multi-chain NUTS on a 8k-cell density loss must turn its trees
    well below the depth cap and converge (the broken potential surface
    produced 100% maxed trees and Rhat > 100 at this shape)."""
    from mellon_tpu.inference.losses import density_loss
    from mellon_tpu.inference.optimizers import minimize_lbfgsb

    key = jax.random.PRNGKey(3)
    n, m = 20_000, 256
    L = jax.random.normal(key, (n, m), dtype=jnp.float32) / jnp.sqrt(m)
    nn = 0.05 + 0.3 * jax.random.uniform(
        jax.random.fold_in(key, 1), (n,), dtype=jnp.float32
    )
    args = (L, nn, 10.0, -6.0)
    z0 = minimize_lbfgsb(
        density_loss, jnp.zeros(m, dtype=jnp.float32), loss_args=args
    ).pre_transformation

    res = run_mcmc(
        density_loss,
        z0,
        jax.random.PRNGKey(5),
        num_warmup=300,
        num_samples=200,
        num_chains=6,
        max_tree_depth=8,
        initial_step_size=0.05,
        potential_args=args,
    )
    steps = np.asarray(res.num_leapfrog)
    # the broken potential surface had EVERY tree at the cap (255); a
    # healthy run at this shape measures ~15 leapfrogs/draw
    maxed = float((steps >= 2**8 - 1).mean())
    assert maxed < 0.5, f"{maxed:.0%} of trees at the depth cap"
    rhat = split_rhat(np.asarray(res.samples))
    assert float(rhat.max()) < 1.1
    ess = effective_sample_size(np.asarray(res.samples))
    # a healthy run at this scale is near-iid; the broken one was ~4
    assert float(np.median(ess)) > 300


def test_density_loss_offset_algebraic_identity():
    """loss(z, ..., offset) == loss(z, ...) - n*offset exactly (constant
    shift: no gradient or posterior change) — f64 check."""
    from mellon_tpu.inference.losses import density_loss

    key = jax.random.PRNGKey(0)
    n, m = 300, 8
    L = jax.random.normal(key, (n, m), dtype=jnp.float64) / jnp.sqrt(m)
    nn = 0.05 + 0.3 * jax.random.uniform(
        jax.random.fold_in(key, 1), (n,), dtype=jnp.float64
    )
    z = jax.random.normal(jax.random.fold_in(key, 2), (m,), dtype=jnp.float64)
    c = 3.7
    a = float(density_loss(z, L, nn, 20.0, -10.0))
    b = float(density_loss(z, L, nn, 20.0, -10.0, c))
    assert b == pytest.approx(a - n * c, rel=1e-12)
    ga = jax.grad(density_loss)(z, L, nn, 20.0, -10.0)
    gb = jax.grad(density_loss)(z, L, nn, 20.0, -10.0, c)
    np.testing.assert_allclose(np.asarray(ga), np.asarray(gb), rtol=1e-12)


def test_zero_centering_restores_f32_energy_resolution():
    """Round-5 scale fix: at O(n) potential magnitude the f32 energy
    DIFFERENCE between nearby states quantizes to whole ulps (measured
    -2.0 vs a -0.15 truth at |loss| ~ 2e7), which collapses the NUTS step
    size and sends every tree to the depth cap at 1M cells; the per-term
    zero-centering operand restores ~1e-3-nat resolution."""
    from mellon_tpu.inference.losses import density_loss

    n, m = 200_000, 32
    key = jax.random.PRNGKey(0)
    L32 = (jax.random.normal(key, (n, m)) / jnp.sqrt(m)).astype(jnp.float32)
    nn32 = (
        0.05
        + 0.3 * jax.random.uniform(jax.random.fold_in(key, 1), (n,))
    ).astype(jnp.float32)
    z1 = 0.1 * jax.random.normal(jax.random.fold_in(key, 2), (m,)).astype(
        jnp.float32
    )
    z2 = z1 + 1e-3 * jax.random.normal(
        jax.random.fold_in(key, 3), (m,)
    ).astype(jnp.float32)

    v1 = float(density_loss(z1, L32, nn32, 20.0, -10.0))
    assert abs(v1) > 1e6  # the regime where raw f32 differences quantize
    c = jnp.asarray(np.float32(v1 / n))

    L64 = jnp.asarray(np.asarray(L32), jnp.float64)
    nn64 = jnp.asarray(np.asarray(nn32), jnp.float64)
    z1_64 = jnp.asarray(np.asarray(z1), jnp.float64)
    z2_64 = jnp.asarray(np.asarray(z2), jnp.float64)
    dE_true = float(
        density_loss(z2_64, L64, nn64, 20.0, -10.0)
        - density_loss(z1_64, L64, nn64, 20.0, -10.0)
    )
    dE_cent = float(
        density_loss(z2, L32, nn32, 20.0, -10.0, c)
        - density_loss(z1, L32, nn32, 20.0, -10.0, c)
    )
    assert abs(dE_cent - dE_true) < 0.05 * max(abs(dE_true), 0.01)


def test_zero_centered_potential_wiring():
    """zero_centered_potential appends the offset operand for the
    operand-threaded density loss (potential ~0 at z0) and no-ops for
    anything else."""
    from mellon_tpu.inference.losses import density_loss
    from mellon_tpu.inference.mcmc import zero_centered_potential

    key = jax.random.PRNGKey(0)
    n, m = 500, 8
    L = (jax.random.normal(key, (n, m)) / jnp.sqrt(m)).astype(jnp.float32)
    nn = (
        0.05 + 0.3 * jax.random.uniform(jax.random.fold_in(key, 1), (n,))
    ).astype(jnp.float32)
    z0 = jnp.zeros(m, dtype=jnp.float32)
    args = (L, nn, 20.0, -10.0)
    fn, new_args = zero_centered_potential(density_loss, z0, args)
    assert fn is density_loss and len(new_args) == 5
    v = float(density_loss(z0, *new_args))
    v_raw = float(density_loss(z0, *args))
    assert abs(v) < 1e-3 * max(abs(v_raw), 1.0)

    def other_potential(z):
        return jnp.sum(z**2)

    fn2, args2 = zero_centered_potential(other_potential, z0, ())
    assert fn2 is other_potential and args2 == ()
