"""Whitened transforms and Bayesian loss functions.

Behavioural parity target: ``mellon/inference.py:125-219, 341-372``.
"""

import jax
import jax.numpy as jnp
from jax.scipy.special import gammaln

from .likelihoods import nearest_neighbors_likelihood, normal_prior, poisson_likelihood

# Precision of the L-matvec inside the sampled/optimized losses.  An f32
# matmul at DEFAULT precision runs reduced-precision arithmetic (TF32 on
# the GPU: 10 mantissa bits), and under the chain/particle vmap the
# per-chain matvec becomes a matmul, so every potential/gradient
# evaluation picks up ~1e-3-relative rounding that is HIGH-FREQUENCY in
# z.  MAP/L-BFGS tolerates it; Hamiltonian MCMC does not: the noise breaks
# leapfrog energy conservation at a step-size-independent ~0.05-1
# nats/eval, dual averaging reacts by collapsing the step size, and every
# NUTS tree runs to the depth cap with frozen chains (reproduced on CPU
# with a bf16 product; gone at HIGHEST — see scripts/sampler_sanity.py).
# HIGHEST (full f32) is the default.  MELLON_TPU_MATVEC_PRECISION=high
# opts into three bf16 products with f32 accumulation
# (``DotAlgorithmPreset.BF16_BF16_F32_X3``, ~f32 accurate), the arithmetic
# this option was certified with — use it only with a posterior-agreement
# check against the default.
import os as _os

_MATVEC_PRECISION_OPTIONS = {
    # 'default' restores the reduced-precision product — only for A/B
    # experiments against the corrected paths; never for sampling.
    "default": jax.lax.Precision.DEFAULT,
    "high": jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3,
    "highest": jax.lax.Precision.HIGHEST,
}
_matvec_env = _os.environ.get("MELLON_TPU_MATVEC_PRECISION", "highest")
try:
    MATVEC_PRECISION = _MATVEC_PRECISION_OPTIONS[_matvec_env.strip().lower()]
except KeyError:
    raise ValueError(
        f"MELLON_TPU_MATVEC_PRECISION={_matvec_env!r} is not recognised; "
        f"allowed values are {sorted(_MATVEC_PRECISION_OPTIONS)} "
        "(case-insensitive)."
    ) from None


# ---------------------------------------------------------------------------
# static loss functions (operands threaded, nothing closed over)
#
# These are the forms the optimizers/samplers jit: because the function
# identity is a stable module-level object and every operand (including the
# n x m matrix L) is a runtime argument, one compiled program serves every
# fit of the same shape — no multi-hundred-MB weight constants are baked
# into executables and compilation caches hit across fits and processes.
# ---------------------------------------------------------------------------

def density_loss(z, L, nn_distances, d, mu, loss_offset_per_term=0.0):
    """Negative log-posterior of the whitened density model, fully
    argument-threaded (same math as :func:`compute_loss_func`).

    The matvec accumulates in f32 regardless of L's storage dtype, so
    passing L as bfloat16 halves the HBM traffic of the leapfrog/optimizer
    hot loop (the roofline) at the cost of ~1e-3 relative perturbation of
    the latent function — an opt-in speed/accuracy trade for sampling.

    ``loss_offset_per_term`` subtracts a constant from each of the n
    likelihood terms INSIDE the reduction, returning
    ``loss - n*offset`` without ever materializing the large total.  This
    matters for sampling at scale: the total potential grows ~O(n) (1.3e7
    at 1M cells, where one f32 ulp is 1.0), so energy DIFFERENCES between
    leapfrog states quantize to ±0.5-1 nats no matter how small the step
    — dual averaging then equilibrates at an arbitrary tiny step (pure
    representation noise yields mean accept ≈ 0.78, right at the 0.8
    target) and every NUTS tree runs to the depth cap.  Setting the
    offset to loss(z_MAP)/n re-centers the sampled potential to O(√n)
    where f32 differences are exact to ~1e-3 nats.  A constant shift
    changes no gradient, MH ratio, or posterior — only its
    representability.  (Round-5 root cause of the synthetic-5000 and
    1M-atlas "every tree at the cap" pathology; the 100k prepared model
    escaped it only because its |loss| ≈ 2.4e5 keeps the noise at 0.03.)
    """
    k = z.shape[0]
    prior = -(1 / 2) * jnp.sum(z**2) - (k / 2) * jnp.log(2 * jnp.pi)
    acc_dtype = jnp.float64 if L.dtype == jnp.float64 else jnp.float32
    f = (
        jnp.dot(
            L,
            z.astype(L.dtype),
            preferred_element_type=acc_dtype,
            precision=MATVEC_PRECISION,
        )
        + mu
    )
    const = (d * jnp.log(jnp.pi) / 2) - gammaln(d / 2 + 1)
    V = jnp.log(nn_distances) * d + const
    Vdr = jnp.log(d) + ((d - 1) * jnp.log(nn_distances)) + const
    likelihood = jnp.sum((f + Vdr) - jnp.exp(f + V) + loss_offset_per_term)
    return -(prior + likelihood)


def density_loglik(z, L, nn_distances, d, mu):
    """Likelihood term of the whitened density model alone (for SMC
    tempering), fully argument-threaded."""
    f = jnp.dot(L, z, precision=MATVEC_PRECISION) + mu
    const = (d * jnp.log(jnp.pi) / 2) - gammaln(d / 2 + 1)
    V = jnp.log(nn_distances) * d + const
    Vdr = jnp.log(d) + ((d - 1) * jnp.log(nn_distances)) + const
    return jnp.sum((f + Vdr) - jnp.exp(f + V))


def dimensionality_loss(z, L, distances, mu_dim, mu_dens):
    """Negative log-posterior of the joint dimension+density model, fully
    argument-threaded (same math as
    :func:`compute_dimensionality_loss_func`)."""
    k = z.shape[0]
    prior = -(1 / 2) * jnp.sum(z**2) - (k / 2) * jnp.log(2 * jnp.pi)
    dims = jnp.exp(jnp.dot(L, z[0, :], precision=MATVEC_PRECISION) + mu_dim)
    log_dens = jnp.dot(L, z[1, :], precision=MATVEC_PRECISION) + mu_dens

    n_neighbors = distances.shape[1]
    counts = jnp.arange(1, n_neighbors + 1)
    ldist = jnp.log(jnp.sort(distances, axis=-1)) + jnp.log(jnp.pi) / 2
    pred = log_dens[:, None] + (
        dims[:, None] * ldist - gammaln(dims[:, None] / 2 + 1)
    )
    logp = pred * counts[None, :] - jnp.exp(pred) - gammaln(counts)[None, :]
    likelihood = jnp.sum(logp)
    return -(prior + likelihood)


def compute_transform(mu, L):
    """z -> f = L z + mu (parity: ``mellon/inference.py:125-139``)."""

    def transform(z):
        return jnp.dot(L, z, precision=MATVEC_PRECISION) + mu

    return transform


def compute_dimensionality_transform(mu_dim, mu_dens, L):
    """2-row z -> (exp(dim GP), density GP)
    (parity: ``mellon/inference.py:142-164``)."""

    def transform(z):
        dims, dens = z[0, :], z[1, :]
        return (
            jnp.exp(jnp.dot(L, dims, precision=MATVEC_PRECISION) + mu_dim),
            jnp.dot(L, dens, precision=MATVEC_PRECISION) + mu_dens,
        )

    return transform


def compute_loss_func(nn_distances, d, transform, k):
    """Negative log-posterior of the whitened density model
    (parity: ``mellon/inference.py:167-192``)."""
    prior = normal_prior(k)
    likelihood = nearest_neighbors_likelihood(nn_distances, d)

    def loss_func(z):
        return -(prior(z) + likelihood(transform(z)))

    return loss_func


def compute_dimensionality_loss_func(distances, transform, k):
    """Negative log-posterior of the joint dimension+density model
    (parity: ``mellon/inference.py:195-219``)."""
    prior = normal_prior(k)
    likelihood = poisson_likelihood(distances)

    def loss_func(z):
        dims, log_dens = transform(z)
        return -(prior(z) + likelihood(dims, log_dens))

    return loss_func


def compute_log_density_x(pre_transformation, transform):
    """Function values at the training points
    (parity: ``mellon/inference.py:341-354``)."""
    return transform(pre_transformation)


def compute_parameter_cov_factor(pre_transformation_std, L):
    """Left factor of the mean-function covariance induced by parameter
    uncertainty (parity: ``mellon/inference.py:357-372``)."""
    return L * pre_transformation_std[None, :]
