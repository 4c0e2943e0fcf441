"""BASELINE config 5, single-chip slice: NUTS posterior for a 1M-cell,
50-dim DensityEstimator with 5k landmarks (pivot-pruned to the kernel's
effective rank) on one chip.

Runs the real pipeline — prepare_inference on 1M cells, L-BFGS MAP, then
multi-chain NUTS on the operand-threaded density loss — and reports
draws/s and leapfrogs/s.  Chains shard across chips linearly (the chains
mesh axis), so pod-slice numbers are chains x this rate per chip.

Usage: python scripts/atlas_nuts_bench.py [n] [d] [m] [chains] [warmup]
           [samples] [precond]

``precond``: Newton-polish the MAP, build the MAP-Hessian Cholesky
preconditioner (blocked HVPs; at 1M x 1024 the build is a few minutes,
then trees turn in ~15 leapfrogs), and sample in the whitened w-space —
the round-4/5 lesson that a short-warmup diagonal-mass run at this scale
never adapts (Rhat in the thousands with every tree at the cap).
"""

import sys
import time

from _common import jax, log  # noqa: F401  (repo path + compile cache)

import jax.numpy as jnp
import numpy as np



def main(n=1_000_000, d=50, m=5_000, chains=8, warmup=50, samples=50,
         precond=False):
    from bench import make_data
    from mellon_tpu.inference.mcmc import (
        hessian_cholesky,
        newton_polish,
        precondition_transform,
        preconditioned_potential,
        run_mcmc,
        unwhiten_samples,
        zero_centered_potential,
    )
    import mellon_tpu

    log(f"devices: {jax.devices()}  n={n:,} d={d} m={m:,} chains={chains} "
        f"warmup={warmup} samples={samples} precond={precond}")
    x = make_data(jax.random.PRNGKey(0), n, d)
    x.block_until_ready()

    est = mellon_tpu.DensityEstimator(n_landmarks=m)
    t0 = time.time()
    est.prepare_inference(x)
    est.run_inference()
    jax.device_get(est.pre_transformation[:1])
    log(
        f"prepare + MAP: {time.time()-t0:.1f}s "
        f"(latent dim {est.L.shape[1]}, loss {est.losses[-1]:.6g})"
    )

    pot = est._loss_fn
    pot_args = tuple(est._loss_args)
    z0 = est.pre_transformation
    # at 1M cells the potential is 1.3e7 where one f32 ulp is 1.0 — energy
    # differences quantize and every tree caps; re-center it at the MAP
    # (see losses.density_loss)
    pot, pot_args = zero_centered_potential(pot, z0, pot_args)
    if precond:
        t0 = time.time()
        z0, gn0, gn1 = newton_polish(pot, z0, pot_args)
        log(f"Newton polish: |grad| {gn0:.3g} -> {gn1:.3g} "
            f"[{time.time()-t0:.1f}s]")
        t0 = time.time()
        R = precondition_transform(hessian_cholesky(
            pot, z0, jnp.asarray(1e-6, jnp.float32), *pot_args, block=256,
        ))
        jax.device_get(R[:1, :1])
        log(f"MAP-Hessian Cholesky + inverse ({z0.shape[-1]}x"
            f"{z0.shape[-1]}): {time.time()-t0:.1f}s")
        run_pot = preconditioned_potential(pot)
        z_map, z0_run = z0, jnp.zeros_like(z0)
        run_args = (R, z_map) + pot_args
    else:
        run_pot, z0_run, run_args = pot, z0, pot_args

    def sample(seed):
        # chunked: at 1M x 1024 the run is long enough to want mid-run
        # checkpoints between chunk programs
        result = run_mcmc(
            run_pot,
            z0_run,
            jax.random.PRNGKey(seed),
            num_warmup=warmup,
            num_samples=samples,
            num_chains=chains,
            max_tree_depth=10 if precond else 7,
            initial_step_size=0.5 if precond else 0.05,
            steps_per_call=5,
            potential_args=run_args,
        )
        if precond:
            result = result._replace(
                samples=unwhiten_samples(result.samples, R, z_map)
            )
        return result

    t0 = time.time()
    result = sample(1)
    jax.device_get(result.step_size)
    log(f"cold NUTS (compile + warmup + sampling): {time.time()-t0:.1f}s")

    t0 = time.time()
    result = sample(2)
    jax.device_get(result.step_size)
    dt = time.time() - t0
    draws = chains * samples
    leapfrogs = int(np.asarray(result.num_leapfrog).sum())
    accept = float(np.asarray(result.accept_prob).mean())
    div = int(np.asarray(result.diverging).sum())
    log(
        f"warm NUTS: {dt:.1f}s for {draws} draws ({leapfrogs:,} leapfrogs, "
        f"accept {accept:.2f}, {div} divergences)"
    )
    log(f"draws/s: {draws/dt:.2f}   leapfrogs/s: {leapfrogs/dt:,.0f}")

    from mellon_tpu.inference.diagnostics import (
        effective_sample_size,
        split_rhat,
    )

    m_lat = result.samples.shape[-1]
    sub = np.sort(
        np.random.RandomState(0).choice(m_lat, size=min(m_lat, 256),
                                        replace=False)
    )
    samples_sub = np.asarray(
        jax.device_get(result.samples[:, :, jnp.asarray(sub)])
    )
    ess = effective_sample_size(samples_sub)
    rhat = split_rhat(samples_sub)
    log(
        f"ESS over {len(sub)} dims: min {float(ess.min()):.0f} / median "
        f"{float(np.median(ess)):.0f} of {draws} draws; split-Rhat max "
        f"{float(rhat.max()):.4f}   min-ESS/s {float(ess.min())/dt:.2f}"
    )


if __name__ == "__main__":
    argv = sys.argv[1:]
    precond = "precond" in argv
    nums = [int(a) for a in argv if a != "precond"]
    main(*nums, precond=precond)
