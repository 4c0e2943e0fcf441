"""North-star benchmark: NUTS effective samples / second / chip on the
density model at 100k cells x 5k landmarks (BASELINE.json primary metric).

ESS/s from short windows after a short warmup is a saturated
short-window floor, not a throughput.  This script measures the number
properly:

* defaults of 500 warmup / 1000 sampling draws (full Stan-style windowed
  adaptation of the diagonal mass matrix);
* ESS from the FULL-length chains over a 512-dimension subsample (gathered
  on device before transfer), with the Geyer truncation lag per dimension —
  any dimension whose initial positive sequence hits the window end is
  flagged (its ESS is a lower bound, not a measurement);
* split-R-hat over the same dimensions plus the potential (energy) trace;
* ESS/draw alongside ESS/s, and a sampling-phase-only ESS/s estimate (the
  one program covers warmup+sampling; the sampling share of wall time is
  estimated from the sampled leapfrogs/draw rate).

Modes:
  synthetic (default) — operands L = randn(n, m)/sqrt(m), random nn
      distances: the literal BASELINE shape, maximally hard (no pruning).
  prepared — a genuinely prepared DensityEstimator on clustered synthetic
      data (bench.make_data): prepare_inference + L-BFGS MAP, then NUTS on
      the operand-threaded loss with the REAL (pivot-pruned) L.

Usage: python scripts/nuts_bench.py [n] [m] [num_warmup] [num_samples]
           [num_chains] [f32|bf16] [prepared]
"""

import sys
import time

from _common import jax, log  # noqa: F401  (repo path + compile cache)

import jax.numpy as jnp
import numpy as np

ESS_SUBSAMPLE = 512
RHAT_THRESHOLD = 1.01


def _make_synthetic(n, m):
    key = jax.random.PRNGKey(0)
    L = jax.random.normal(key, (n, m), dtype=jnp.float32) / jnp.sqrt(m)
    nn = 0.05 + 0.3 * jax.random.uniform(
        jax.random.fold_in(key, 1), (n,), dtype=jnp.float32
    )
    d, mu = 20.0, -10.0
    return L, nn, d, mu


def _report(result, t_total, num_warmup, num_samples, num_chains, m):
    from mellon_tpu.inference.diagnostics import (
        effective_sample_size,
        split_rhat,
    )

    total_draws = num_chains * num_samples
    total_leapfrogs = int(np.asarray(result.num_leapfrog).sum())
    accept = float(np.asarray(result.accept_prob).mean())
    div = int(np.asarray(result.diverging).sum())
    log(
        f"warm run: {t_total:.2f}s for {total_draws} draws "
        f"({total_leapfrogs:,} leapfrogs, accept {accept:.2f}, "
        f"{div} divergences)"
    )

    # ---- device-side dim subsample, then ONE transfer ---------------------
    sub = np.sort(
        np.random.RandomState(0).choice(
            m, size=min(m, ESS_SUBSAMPLE), replace=False
        )
    )
    t0 = time.time()
    samples_sub = np.asarray(
        jax.device_get(result.samples[:, :, jnp.asarray(sub)])
    )
    pots = np.asarray(result.potential)  # (chains, draws)
    log(
        f"transferred ({num_chains}, {num_samples}, {len(sub)}) sample "
        f"subsample + potentials in {time.time()-t0:.1f}s"
    )

    # ---- full-length ESS with truncation flags ----------------------------
    ess, trunc = effective_sample_size(samples_sub, return_truncation=True)
    saturated = trunc + 2 > num_samples
    n_sat = int(saturated.sum())
    rhat = split_rhat(samples_sub)
    rhat_pot = float(split_rhat(pots[:, :, None])[0])
    n_bad_rhat = int((rhat > RHAT_THRESHOLD).sum())

    ess_min, ess_med, ess_max = (
        float(ess.min()), float(np.median(ess)), float(ess.max())
    )
    log(
        f"ESS over {len(sub)} dims (full {num_samples}-draw chains): "
        f"min {ess_min:.0f} / median {ess_med:.0f} / max {ess_max:.0f}   "
        f"ESS/draw min {ess_min/total_draws:.4f} / "
        f"median {ess_med/total_draws:.4f}"
    )
    log(
        f"Geyer truncation: {n_sat}/{len(sub)} dims hit the window end "
        + ("(ESS is a lower bound there)" if n_sat else "(none saturated)")
    )
    log(
        f"split-Rhat: max {float(rhat.max()):.4f}, "
        f"{n_bad_rhat}/{len(sub)} dims > {RHAT_THRESHOLD}; "
        f"potential Rhat {rhat_pot:.4f}"
    )

    # ---- rates ------------------------------------------------------------
    # the program covers warmup+sampling; estimate the sampling share of
    # wall time from the sampled leapfrogs/draw (post-adaptation tree depth
    # is stationary, so warmup draws after adaptation cost about the same)
    lf_per_draw = total_leapfrogs / max(total_draws, 1)
    est_total_lf = lf_per_draw * (num_warmup + num_samples) * num_chains
    t_sampling = t_total * total_leapfrogs / est_total_lf
    log(
        f"draws/s: {total_draws / t_total:.2f} (total wall) / "
        f"{total_draws / t_sampling:.2f} (sampling-phase est.)   "
        f"leapfrogs/s: {total_leapfrogs / t_sampling:,.0f}"
    )
    log(
        f"min/median ESS/s (total wall): "
        f"{ess_min / t_total:.2f} / {ess_med / t_total:.2f}   "
        f"(sampling-phase est.): "
        f"{ess_min / t_sampling:.2f} / {ess_med / t_sampling:.2f}"
    )
    moments = {
        "sub": sub,
        "mean": samples_sub.reshape(-1, samples_sub.shape[-1]).mean(0),
        "std": samples_sub.reshape(-1, samples_sub.shape[-1]).std(0),
        "ess": ess,
    }
    return est_total_lf, t_sampling, moments


def main(n=100_000, m=5_000, num_warmup=500, num_samples=1_000,
         num_chains=64, precision="f32", prepared=False, chunk=None,
         depth=7, precond=False, save=None):
    from mellon_tpu.inference.losses import density_loss
    from mellon_tpu.inference.mcmc import (
        hessian_cholesky,
        newton_polish,
        precondition_transform,
        preconditioned_potential,
        run_mcmc,
        unwhiten_samples,
        zero_centered_potential,
    )

    log(
        f"devices: {jax.devices()}  n={n:,} m={m:,} chains={num_chains} "
        f"warmup={num_warmup} draws={num_samples} "
        f"mode={'prepared' if prepared else 'synthetic'} "
        f"chunk={chunk} max_tree_depth={depth} precond={precond}"
    )

    if prepared:
        # the REAL pipeline: prepare a density model on clustered data and
        # sample its operand-threaded loss (L is the pivot-pruned factor)
        import mellon_tpu
        from bench import make_data

        d_feat = 20
        x = make_data(jax.random.PRNGKey(0), n, d_feat)
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
        potential_fn = est._loss_fn
        potential_args = est._loss_args
        z0 = est.pre_transformation
        m_eff = int(est.L.shape[1])
    else:
        L, nn, d, mu = _make_synthetic(n, m)
        potential_args = (L, nn, d, mu)
        potential_fn = density_loss

        # start at the MAP (the realistic entry point: sample_density_
        # posterior seeds chains from the fitted pre_transformation)
        from mellon_tpu.inference.optimizers import minimize_lbfgsb

        t0 = time.time()
        res_map = minimize_lbfgsb(
            density_loss, jnp.zeros(m, dtype=jnp.float32),
            loss_args=potential_args,
        )
        z0 = res_map.pre_transformation
        log(f"MAP warm start: {time.time()-t0:.1f}s (loss {res_map.loss:.4g})")

        if precision == "bf16":
            L = L.astype(jnp.bfloat16)
            potential_args = (L, nn, d, mu)
            log("using bf16 storage for L")
        m_eff = m

    # re-center the sampled potential at the MAP: at O(n) magnitude the
    # f32 energy differences quantize (1 ulp at 1.3e7 is 1.0) and the
    # step collapses with every tree at the cap (see losses.density_loss)
    potential_fn, potential_args = zero_centered_potential(
        potential_fn, z0, tuple(potential_args)
    )

    if precond:
        # dense-metric sampling: MAP-Hessian Cholesky transform (the
        # diagonal-mass runs max out every tree at this posterior's
        # conditioning)
        t0 = time.time()
        pot_base = density_loss if not prepared else potential_fn
        z0, gn0, gn1 = newton_polish(pot_base, z0, tuple(potential_args))
        log(f"Newton polish: |grad| {gn0:.3g} -> {gn1:.3g} "
            f"[{time.time()-t0:.1f}s]")
        t0 = time.time()
        R = precondition_transform(hessian_cholesky(
            pot_base,
            z0, jnp.asarray(1e-6, jnp.float32), *potential_args,
        ))
        jax.device_get(R[:1, :1])
        log(f"MAP-Hessian Cholesky + inverse ({z0.shape[-1]}x"
            f"{z0.shape[-1]}): {time.time()-t0:.1f}s")
        pot_w = preconditioned_potential(potential_fn)
        z_map, z0_run = z0, jnp.zeros_like(z0)
        run_args = (R, z_map) + tuple(potential_args)
        run_pot = pot_w
    else:
        z0_run, run_args, run_pot = z0, tuple(potential_args), potential_fn

    def sample(seed):
        result = run_mcmc(
            run_pot,
            z0_run,
            jax.random.PRNGKey(seed),
            num_warmup=num_warmup,
            num_samples=num_samples,
            num_chains=num_chains,
            max_tree_depth=depth,
            # in the preconditioned (w) coordinates the target is
            # near-N(0, I), so the natural step is O(1); a 0.05 start
            # sends early-warmup trees to the depth cap
            initial_step_size=0.5 if precond else 0.05,
            steps_per_call=chunk,
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
    t_cold = time.time() - t0
    log(f"cold run (compile + load + warmup + sampling): {t_cold:.1f}s")

    t0 = time.time()
    result = sample(2)
    jax.device_get(result.step_size)
    t_total = time.time() - t0

    _, _, moments = _report(
        result, t_total, num_warmup, num_samples, num_chains, m_eff
    )
    if save:
        # posterior moments over the dim subsample (z-space: precond draws
        # are unwhitened before _report) — the artifact the precision-knob
        # agreement check (scripts/precision_agreement.py) consumes
        np.savez(save, **moments)
        log(f"saved posterior moments to {save}")


if __name__ == "__main__":
    argv = sys.argv[1:]
    precision = next((a for a in argv if a in ("f32", "bf16")), "f32")
    prepared = "prepared" in argv
    kw = {}
    for a in argv:
        if a.startswith("chunk="):
            kw["chunk"] = int(a.split("=")[1])
        elif a.startswith("depth="):
            kw["depth"] = int(a.split("=")[1])
        elif a.startswith("save="):
            kw["save"] = a.split("=", 1)[1]
    kw["precond"] = "precond" in argv
    nums = [
        int(a) for a in argv
        if a not in ("f32", "bf16", "prepared", "precond") and "=" not in a
    ]
    main(*nums, precision=precision, prepared=prepared, **kw)
