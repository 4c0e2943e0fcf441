"""MCMC convergence diagnostics: split-R̂ and effective sample size.

NEW capability (the reference has no sampling, hence no diagnostics).
Implementations follow the standard definitions (Gelman et al., BDA3 /
Vehtari et al. 2021 rank-normalization omitted for simplicity): split-R̂
from within/between-chain variances and ESS from pairwise-summed
autocorrelations estimated by FFT.
"""

import jax.numpy as jnp
import numpy as np


def split_rhat(samples):
    """Split-R̂ per dimension.

    Parameters
    ----------
    samples : (num_chains, num_samples, dim)

    Returns
    -------
    (dim,) array of split-R̂ values (≈1 at convergence).
    """
    samples = np.asarray(samples)
    c, n, d = samples.shape
    half = n // 2
    splits = np.concatenate(
        [samples[:, :half], samples[:, half : 2 * half]], axis=0
    )  # (2c, half, d)
    m, n_, _ = splits.shape
    chain_means = splits.mean(axis=1)          # (m, d)
    chain_vars = splits.var(axis=1, ddof=1)    # (m, d)
    between = n_ * chain_means.var(axis=0, ddof=1)
    within = chain_vars.mean(axis=0)
    var_est = (n_ - 1) / n_ * within + between / n_
    return np.sqrt(var_est / within)


def _autocov_fft(x):
    """Autocovariance of a 1-d series via FFT."""
    n = len(x)
    x = x - x.mean()
    f = np.fft.rfft(x, 2 * n)
    acov = np.fft.irfft(f * np.conj(f))[:n].real / n
    return acov


def effective_sample_size(samples, return_truncation=False):
    """ESS per dimension using Geyer's initial monotone sequence over the
    chain-averaged autocorrelations.

    Parameters
    ----------
    samples : (num_chains, num_samples, dim)
    return_truncation : bool — when True, additionally return the lag at
        which Geyer's initial positive sequence stopped for each
        dimension.  A truncation lag that reaches the chain length means
        the autocorrelation never went negative within the window, i.e.
        the ESS for that dimension is a window-limited LOWER BOUND, not a
        measurement — the signature of chains far shorter than the
        integrated autocorrelation time (a short-window ESS floor is not
        a throughput).

    Returns
    -------
    (dim,) array of effective sample sizes; with ``return_truncation``,
    the tuple ``(ess, truncation_lag)`` where ``truncation_lag`` is the
    (dim,) integer array of final lags (saturated when
    ``truncation_lag + 2 > num_samples``).
    """
    samples = np.asarray(samples)
    c, n, d = samples.shape
    ess = np.empty(d)
    trunc = np.empty(d, dtype=np.int64)
    for j in range(d):
        acovs = np.stack([_autocov_fft(samples[i, :, j]) for i in range(c)])
        mean_var = acovs[:, 0].mean()
        # between-chain contribution (uses overall variance)
        var_plus = mean_var * (n - 1) / n
        if c > 1:
            var_plus += samples[:, :, j].mean(axis=1).var(ddof=1)
        rho = 1 - (mean_var - acovs.mean(axis=0)) / var_plus
        # Geyer: sum consecutive pairs while positive
        tau = 1.0
        t = 1
        while t + 1 < n:
            pair = rho[t] + rho[t + 1]
            if pair < 0:
                break
            tau += 2 * pair
            t += 2
        ess[j] = c * n / max(tau, 1e-8)
        trunc[j] = t
    if return_truncation:
        return ess, trunc
    return ess


def summarize(samples):
    """Convenience summary dict: mean/std/R̂/ESS per dimension."""
    samples = np.asarray(samples)
    flat = samples.reshape(-1, samples.shape[-1])
    return {
        "mean": flat.mean(axis=0),
        "std": flat.std(axis=0, ddof=1),
        "rhat": split_rhat(samples),
        "ess": effective_sample_size(samples),
    }
