"""Compare posterior approximations of the density model: diagonal Laplace,
ADVI, NUTS, and SMC — means and standard deviations of the latent GP
function.

Device analogue of the reference's ``scripts/compare_laplace_advi.py``
(198 LoC), extended with the exact samplers the reference lacks.

Usage: python scripts/compare_posteriors.py [n_cells] [n_dims]
"""

import sys
import time

from _common import jax, log  # noqa: F401  (repo path + compile cache)

import jax.numpy as jnp
import numpy as np


def main(n=200, d=3, seed=0):
    from mellon_tpu import DensityEstimator
    from mellon_tpu.inference.laplace import compute_laplace_std
    from mellon_tpu.inference.mcmc import sample_density_posterior
    from mellon_tpu.inference.smc import smc_density_posterior
    from mellon_tpu.inference.advi import run_advi
    from mellon_tpu.inference.diagnostics import summarize

    key = jax.random.PRNGKey(seed)
    x = jax.random.normal(key, (n, d))

    est = DensityEstimator()
    est.prepare_inference(x)

    # --- MAP + Laplace ------------------------------------------------------
    t0 = time.time()
    est.run_inference()
    t_map = time.time() - t0
    z_map = est.pre_transformation
    t0 = time.time()
    laplace_std = compute_laplace_std(est.loss_func, z_map)
    t_laplace = time.time() - t0
    f_map = np.asarray(est.transform(z_map))
    f_laplace_std = np.asarray(
        jnp.sqrt(jnp.sum(jnp.square(est.L * laplace_std[None, :]), axis=1))
    )

    # --- ADVI ---------------------------------------------------------------
    t0 = time.time()
    advi = run_advi(est.loss_func, est.initial_value, n_iter=300)
    t_advi = time.time() - t0
    f_advi = np.asarray(est.transform(advi.pre_transformation))
    f_advi_std = np.asarray(
        jnp.sqrt(
            jnp.sum(
                jnp.square(est.L * advi.pre_transformation_std[None, :]), axis=1
            )
        )
    )

    # --- NUTS ---------------------------------------------------------------
    t0 = time.time()
    mcmc_res, f_samples = sample_density_posterior(
        est, num_warmup=500, num_samples=500, num_chains=4, seed=seed
    )
    t_nuts = time.time() - t0
    diag = summarize(mcmc_res.samples)
    f_nuts = np.asarray(f_samples.mean(axis=0))
    f_nuts_std = np.asarray(f_samples.std(axis=0))

    # --- SMC ----------------------------------------------------------------
    t0 = time.time()
    smc_res, f_particles = smc_density_posterior(est, num_particles=1024, seed=seed)
    t_smc = time.time() - t0
    f_smc = np.asarray(f_particles.mean(axis=0))
    f_smc_std = np.asarray(f_particles.std(axis=0))

    def corr(a, b):
        return np.corrcoef(a, b)[0, 1]

    print(f"\n=== posterior comparison (n={n}, d={d}) ===")
    print(f"MAP (L-BFGS):      {t_map:7.2f}s")
    print(f"Laplace std:       {t_laplace:7.2f}s")
    print(f"ADVI:              {t_advi:7.2f}s")
    print(
        f"NUTS:              {t_nuts:7.2f}s  "
        f"(max rhat {diag['rhat'].max():.3f}, min ess {diag['ess'].min():.0f})"
    )
    print(f"SMC:               {t_smc:7.2f}s  ({len(smc_res.betas)} stages)")
    print("\nmean-function agreement with NUTS (corr):")
    print(f"  MAP:  {corr(f_map, f_nuts):.4f}")
    print(f"  ADVI: {corr(f_advi, f_nuts):.4f}")
    print(f"  SMC:  {corr(f_smc, f_nuts):.4f}")
    print("\nstd agreement with NUTS (corr / mean-ratio):")
    print(
        f"  Laplace: {corr(f_laplace_std, f_nuts_std):.4f} / "
        f"{f_laplace_std.mean() / f_nuts_std.mean():.3f}"
    )
    print(
        f"  ADVI:    {corr(f_advi_std, f_nuts_std):.4f} / "
        f"{f_advi_std.mean() / f_nuts_std.mean():.3f}"
    )
    print(
        f"  SMC:     {corr(f_smc_std, f_nuts_std):.4f} / "
        f"{f_smc_std.mean() / f_nuts_std.mean():.3f}"
    )


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 200
    d = int(sys.argv[2]) if len(sys.argv) > 2 else 3
    main(n, d)
