"""SMC evidence-estimation benchmark on the density model.

SMC is a new capability (the reference has no sampler,
``mellon/inference.py`` stops at MAP/ADVI), so there is no reference row
to beat — this bench pins the absolute throughput of the tempered sweep
on one chip: adaptive stages from N(0, I) to the posterior with HMC
mutations, reporting wall time, the stage count the adaptive tempering
chose, the log-evidence estimate, and mutation-gradient throughput
(the same (n, m) x (m, particles) shared-matmul economics as NUTS chain
scaling).

Usage: python scripts/smc_bench.py [n] [m] [num_particles] [laplace]

``laplace`` anneals from the diagonal-Laplace Gaussian at the MAP with
the adjusted likelihood (same β=1 target and evidence) instead of the
N(0, I) prior — the practical configuration for peaked posteriors.
"""

import sys
import time

from _common import jax, log  # noqa: F401  (repo path + compile cache)

import jax.numpy as jnp
import numpy as np


def main(n=100_000, m=512, num_particles=1024, start="prior", repeats=1):
    from mellon_tpu.inference.laplace import compute_laplace_std
    from mellon_tpu.inference.losses import density_loss
    from mellon_tpu.inference.optimizers import minimize_lbfgsb
    from mellon_tpu.inference.smc import loglik_from_loss, run_smc

    log(f"devices: {jax.devices()}  n={n:,} m={m} particles={num_particles} "
        f"start={start}")
    key = jax.random.PRNGKey(0)
    L = jax.random.normal(key, (n, m), dtype=jnp.float32) / jnp.sqrt(m)
    nn = 0.05 + 0.3 * jax.random.uniform(
        jax.random.fold_in(key, 1), (n,), dtype=jnp.float32
    )
    d, mu = 20.0, -10.0
    prior_kwargs = {}
    if start == "laplace":
        t0 = time.time()
        res_map = minimize_lbfgsb(
            density_loss, jnp.zeros(m, dtype=jnp.float32),
            loss_args=(L, nn, jnp.asarray(d), jnp.asarray(mu)),
        )
        z_map = res_map.pre_transformation
        sigma = jnp.clip(
            jnp.asarray(compute_laplace_std(
                density_loss, z_map,
                loss_args=(L, nn, jnp.asarray(d), jnp.asarray(mu)),
            )),
            1e-3, 10.0,
        )
        log(f"MAP + Laplace std: {time.time()-t0:.1f}s (loss {res_map.loss:.4g})")

        def q_sample(k, n_p):
            return z_map[None, :] + sigma[None, :] * jax.random.normal(
                k, (n_p, m), dtype=z_map.dtype
            )

        def q_logpdf(z):
            u = (z - z_map) / sigma
            return (-0.5 * jnp.sum(u**2) - jnp.sum(jnp.log(sigma))
                    - 0.5 * m * jnp.log(2 * jnp.pi))

        def loglik(z, Lx, nnx, dx, mux):
            return -density_loss(z, Lx, nnx, dx, mux) - q_logpdf(z)

        prior_kwargs = dict(prior_sample=q_sample, prior_logpdf=q_logpdf)
    else:
        loglik = loglik_from_loss(density_loss)

    def sweep(seed):
        t0 = time.time()
        res = run_smc(
            loglik,
            m,
            jax.random.PRNGKey(seed),
            num_particles=num_particles,
            num_mutation_steps=5,
            num_leapfrog_steps=8,
            loglik_args=(L, nn, d, mu),
            **prior_kwargs,
        )
        jax.device_get(res.log_evidence)
        return time.time() - t0, res

    t_cold, res = sweep(1)
    log(f"cold sweep: {t_cold:.1f}s ({len(res.betas)} stages)")
    t_warm, res = sweep(2)

    stages = len(res.betas)
    # per stage: num_mutation_steps HMC mutations x num_leapfrog_steps
    # leapfrogs, each evaluating the loglik gradient for every particle
    grads = stages * 5 * 8 * num_particles
    ess = float(np.asarray(res.ess_history)[-1])
    accept = float(np.mean(np.asarray(res.acceptance_history)))
    log(
        f"warm sweep: {t_warm:.1f}s  stages={stages}  "
        f"log_evidence={float(res.log_evidence):.1f}  "
        f"final ESS={ess:.0f}/{num_particles}  accept={accept:.2f}"
    )
    log(
        f"mutation-gradient throughput: {grads / t_warm:,.0f} "
        f"particle-leapfrogs/s"
    )

    if repeats > 1:
        # evidence error bar across independent sweeps:
        # the warm sweep above counts as the first replicate
        evs = [float(res.log_evidence)]
        for s in range(3, 3 + repeats - 1):
            _, res_r = sweep(s)
            evs.append(float(res_r.log_evidence))
        log(
            f"log-evidence over {repeats} independent sweeps: "
            f"{np.mean(evs):.1f} +- {np.std(evs, ddof=1):.2f} nats "
            f"(values: {', '.join(f'{e:.1f}' for e in evs)})"
        )


if __name__ == "__main__":
    argv = sys.argv[1:]
    start = "laplace" if "laplace" in argv else "prior"
    kw = {}
    for a in argv:
        if a.startswith("repeats="):
            kw["repeats"] = int(a.split("=")[1])
    nums = [
        int(a) for a in argv if a not in ("laplace", "prior") and "=" not in a
    ]
    main(*nums, start=start, **kw)
