"""bf16-storage posterior agreement on a prepared model: same prepared 100k-cell DensityEstimator, same seed,
Hessian-preconditioned NUTS with f32 vs bfloat16 storage of L
(``sample_density_posterior(precision="bf16")``), compared by
per-dimension moment agreement within MC error (same test as
scripts/precision_agreement.py).

Usage: python bf16_agreement_direct.py [n] [m] [chains] [warmup] [draws]
"""

import sys
import time

from _common import jax, log  # noqa: F401

import jax.numpy as jnp
import numpy as np


def main(n=100_000, m=5_000, chains=128, warmup=300, draws=500):
    import mellon_tpu
    from bench import make_data
    from mellon_tpu.inference.mcmc import sample_density_posterior

    log(f"devices: {jax.devices()}  n={n:,} m={m:,} chains={chains} "
        f"warmup={warmup} draws={draws}")
    x = make_data(jax.random.PRNGKey(0), n, 20)
    x.block_until_ready()
    est = mellon_tpu.DensityEstimator(n_landmarks=m)
    t0 = time.time()
    est.prepare_inference(x)
    est.run_inference()
    jax.device_get(est.pre_transformation[:1])
    log(f"prepare + MAP: {time.time()-t0:.1f}s (latent dim {est.L.shape[1]})")

    moments = {}
    for precision in (None, "bf16"):
        t0 = time.time()
        res, _ = sample_density_posterior(
            est, num_warmup=warmup, num_samples=draws, num_chains=chains,
            seed=1, precondition="hessian", steps_per_call=25,
            precision=precision, function_samples=False,
        )
        jax.device_get(res.step_size)
        dt = time.time() - t0
        lf = int(np.asarray(res.num_leapfrog).sum())
        total = chains * draws
        zs = np.asarray(
            jax.device_get(res.samples)
        ).reshape(-1, res.samples.shape[-1])
        from mellon_tpu.inference.diagnostics import effective_sample_size

        samp = np.asarray(res.samples)
        ess = effective_sample_size(samp)
        label = precision or "f32"
        moments[label] = (zs.mean(0), zs.std(0), np.asarray(ess))
        log(
            f"{label}: {dt:.1f}s, {total/dt:.0f} draws/s, "
            f"{lf/total:.1f} lf/draw, min ESS {float(np.min(ess)):.0f}"
        )

    (ma, sa, ea), (mb, sb, eb) = moments["f32"], moments["bf16"]
    se_mean = np.sqrt(sa**2 / ea + sb**2 / eb)
    z_mean = np.abs(ma - mb) / se_mean
    se_std = np.sqrt(sa**2 / (2 * (ea - 1)) + sb**2 / (2 * (eb - 1)))
    z_std = np.abs(sa - sb) / se_std
    log(
        f"bf16-vs-f32 agreement over {len(ma)} dims: means max|z| "
        f"{z_mean.max():.2f} / median {np.median(z_mean):.2f} "
        f"(dims>3: {int((z_mean > 3).sum())}); stds max|z| "
        f"{z_std.max():.2f} / median {np.median(z_std):.2f} "
        f"(dims>3: {int((z_std > 3).sum())})"
    )
    log(
        f"max abs mean diff {np.abs(ma-mb).max():.3e} vs posterior sd "
        f"{sa.mean():.3e}; function-mean corr "
        f"{np.corrcoef(ma, mb)[0, 1]:.6f}"
    )
    ok = z_mean.max() <= 5.0
    log(f"AGREEMENT {'PASS' if ok else 'FAIL'} (threshold max|z| <= 5)")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(*[int(a) for a in sys.argv[1:]]))
