"""Sequential Monte Carlo with adaptive likelihood tempering.

NEW capability relative to the reference (BASELINE.json north star: "SMC over
the latent GP function ... resampling ... done via collectives").  The
whitened parametrization makes the prior exactly N(0, I), so particles
initialize from the prior and anneal into the posterior along
π_β(z) ∝ N(z; 0, I) · L(z)^β with β adapted so each stage keeps the
effective sample size near a target fraction.

Structure: each tempering stage — batched log-likelihood, the bisection
search for the next β, weighting, systematic resampling, and HMC mutation —
is ONE compiled program over the particle batch axis; the host loop makes a
single blocking fetch per stage (the four scalars driving the step-size
controller and the β ≥ 1 termination check).  Passing ``mesh=`` (or an
explicit ``particle_sharding=``) places the particles on a mesh axis and
shards the whole sweep: the per-particle log-likelihoods and mutations
partition across devices, and the ESS/evidence ``logsumexp`` reductions and
the resampling gather lower to collectives under GSPMD.
"""

import functools
import logging
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .samplers import hmc_init, hmc_kernel

logger = logging.getLogger("mellon_tpu")

# laplace_start clips the diagonal-Laplace std into this range so a flat or
# ill-conditioned Hessian direction cannot explode the start distribution q;
# clipping more than the warn fraction of directions degrades the "short
# annealing path" rationale and is surfaced as a warning.
LAPLACE_SIGMA_MIN = 1e-3
LAPLACE_SIGMA_MAX = 10.0
LAPLACE_CLIP_WARN_FRACTION = 0.01

# smc_density_posterior(start="auto"): number of likelihood terms above
# which the Laplace start replaces the N(0, I) prior start.  At 100k cells
# the prior sweep rides the schedule floor for most of its stages with
# single-digit ESS and biases the evidence low (round-4 smc_p5 logs); the
# MAP + diagonal-Laplace fit that the laplace start needs is a fixed cost
# that is negligible at this scale.
SMC_LAPLACE_AUTO_N = 10_000


@functools.lru_cache(maxsize=None)
def loglik_from_loss(loss_fn):
    """Adapt a negative-log-posterior ``loss_fn(z, *args)`` into the
    likelihood term for tempering (posterior = N(0,I) prior × likelihood).

    Cached so the returned function has a stable identity per ``loss_fn`` —
    the jit key of the compiled SMC stages stays stable across fits.
    """

    def loglik(z, *args):
        dim = z.size
        prior = -0.5 * jnp.sum(z**2) - 0.5 * dim * jnp.log(2 * jnp.pi)
        return -loss_fn(z, *args) - prior

    return loglik


class SMCResult(NamedTuple):
    particles: jnp.ndarray       # (num_particles, dim)
    log_weights: jnp.ndarray     # (num_particles,) weights FOR `particles`:
    # zeros when the sweep reached beta=1 (the population was resampled and
    # mutated under the full posterior, so uniform weights are exact)
    betas: list                  # tempering schedule actually used
    ess_history: list
    acceptance_history: list
    log_evidence: jnp.ndarray    # log normalizing-constant estimate
    final_stage_log_weights: jnp.ndarray = None  # (num_particles,) the last
    # stage's actual pre-resampling weights — diagnose terminal ESS or
    # reweight-without-resampling analyses; None before any stage ran
    log_evidence_std: float = None  # across-sweep standard deviation of
    # log_evidence when smc_density_posterior ran num_sweeps > 1 (the
    # stated uncertainty of the evidence estimate); None for single sweeps


def _std_normal_logpdf(z):
    """Module-level default prior: stable identity keeps the stage program's
    jit key stable across fits."""
    return -0.5 * jnp.sum(z**2) - 0.5 * z.size * jnp.log(2 * jnp.pi)


def _ess_from_log_weights(log_w):
    log_w = log_w - jax.scipy.special.logsumexp(log_w)
    return jnp.exp(-jax.scipy.special.logsumexp(2 * log_w))


def _next_beta(log_lik, beta, target_ess, min_step):
    """Largest admissible β increment keeping ESS above target — 30
    bisection steps entirely on device (the old host-side search made ~32
    blocking fetches per stage; this makes none).

    ``min_step`` floors the increment.  The caller passes the schedule
    floor ``(1 - β) / stages_left`` so the sweep is GUARANTEED to reach
    β = 1 within ``max_stages``: on sharply peaked likelihoods the
    admissible increment can fall below one f32 ulp of beta (eps ~1.2e-7)
    and an unfloored ``beta + lo`` would stall the sweep at a fixed
    temperature forever.  A forced (floored) step offers no ESS guarantee
    for that stage — ESS may collapse far below target on a peaked
    likelihood — which the subsequent systematic resample and HMC
    mutation absorb; the caller logs when it happens.
    """
    hi0 = 1.0 - beta

    def ess_at(delta):
        return _ess_from_log_weights(delta * log_lik)

    full_ok = ess_at(hi0) >= target_ess

    def body(_, lo_hi):
        lo, hi = lo_hi
        mid = 0.5 * (lo + hi)
        ok = ess_at(mid) >= target_ess
        return jnp.where(ok, mid, lo), jnp.where(ok, hi, mid)

    zero = jnp.zeros_like(hi0)
    lo, _ = jax.lax.fori_loop(0, 30, body, (zero, hi0))
    eps = jnp.asarray(jnp.finfo(hi0.dtype).eps, hi0.dtype)
    lo = jnp.minimum(jnp.maximum(lo, jnp.maximum(min_step, eps)), hi0)
    # a floored step that consumes the whole remaining gap must land on
    # exactly 1.0 — `beta + (1 - beta)` can round below it in f32, which
    # would leak one spurious extra stage past the schedule guarantee
    done = full_ok | (lo >= hi0)
    return jnp.where(done, jnp.ones_like(hi0), beta + lo)


def _systematic_resample(key, log_w, num_particles):
    """Systematic resampling indices from normalized log weights."""
    w = jnp.exp(log_w - jax.scipy.special.logsumexp(log_w))
    positions = (jnp.arange(num_particles) + jax.random.uniform(key)) / num_particles
    cumsum = jnp.cumsum(w)
    # clamp: the f32 cumsum of the normalized weights can end BELOW the
    # last position (observed 1 - 3e-7 at 256 particles), in which case
    # searchsorted returns num_particles — an out-of-bounds gather index
    # that jnp.take silently fills with NaN, poisoning the next stage's
    # ESS and the evidence accumulator (observed on the 100k-cell bench)
    idx = jnp.searchsorted(cumsum, positions)
    return jnp.minimum(idx, num_particles - 1)


@partial(
    jax.jit,
    static_argnames=(
        "loglik_fn",
        "prior_logpdf",
        "num_mutation_steps",
        "num_leapfrog_steps",
    ),
)
def _smc_stage(
    loglik_fn,
    prior_logpdf,
    particles,
    key,
    beta,
    step_size,
    target_ess,
    min_step,
    num_mutation_steps,
    num_leapfrog_steps,
    *loglik_args,
):
    """One full tempering stage as a single program: weights → next β →
    evidence/ESS → systematic resampling → HMC mutation.  With sharded
    particles the reductions and the resampling gather are collectives."""
    num_particles, dim = particles.shape

    log_lik = jax.vmap(lambda z: loglik_fn(z, *loglik_args))(particles)
    new_beta = _next_beta(log_lik, beta, target_ess, min_step)
    log_w = (new_beta - beta) * log_lik
    log_ev_inc = jax.scipy.special.logsumexp(log_w) - jnp.log(num_particles)
    ess = _ess_from_log_weights(log_w)

    k_res, k_mut = jax.random.split(key)
    idx = _systematic_resample(k_res, log_w, num_particles)
    particles = jnp.take(particles, idx, axis=0)

    def potential(z):
        return -(prior_logpdf(z) + new_beta * loglik_fn(z, *loglik_args))

    kernel = hmc_kernel(potential, num_steps=num_leapfrog_steps)

    def one_chain(z, chain_key):
        state = hmc_init(potential, z)

        def body(i, carry):
            state, acc = carry
            k = jax.random.fold_in(chain_key, i)
            state, info = kernel(state, k, step_size, jnp.ones(dim))
            return state, acc + info.accept_prob

        state, acc = jax.lax.fori_loop(
            0, num_mutation_steps, body, (state, jnp.zeros(()))
        )
        return state.z, acc / num_mutation_steps

    mut_keys = jax.random.split(k_mut, num_particles)
    particles, accept = jax.vmap(one_chain)(particles, mut_keys)
    return particles, new_beta, ess, jnp.mean(accept), log_ev_inc, log_w


def run_smc(
    loglik_fn,
    dim,
    key,
    num_particles=1024,
    target_ess_frac=0.5,
    num_mutation_steps=5,
    mutation_step_size=0.2,
    num_leapfrog_steps=8,
    max_stages=100,
    prior_sample=None,
    prior_logpdf=None,
    loglik_args=(),
    mesh=None,
    particle_sharding=None,
):
    """Anneal particles from N(0, I) (or a custom prior) to the posterior
    ∝ prior · exp(loglik).

    ``loglik_fn`` is either ``f(z)`` or ``f(z, *loglik_args)``; threading the
    operands keeps the compiled stages free of baked constants.  Custom
    priors (``prior_sample`` + ``prior_logpdf``) compose with
    ``loglik_args``; their callables should close over small constants
    only (each new closure identity retraces the stage programs).

    ``mesh=`` shards the sweep: particles are placed on the mesh's chain
    axis (``num_particles`` should be divisible by its size) and every
    per-particle computation partitions across devices; cell-sharded
    ``loglik_args`` compose with it (chains × cells).  An explicit
    ``particle_sharding=`` (any ``NamedSharding`` whose spec splits the
    leading axis) overrides the default placement.

    The sweep ALWAYS reaches β = 1 within ``max_stages``: each stage's
    tempering step is floored at (remaining gap) / (stages left), so
    ``max_stages`` is a hard schedule bound, not a best-effort budget.
    Forced (floored) steps may undershoot the stage ESS target on sharply
    peaked likelihoods — logged as a warning, absorbed by the subsequent
    resample and HMC mutation.

    Returns an :class:`SMCResult`; ``log_evidence`` estimates
    log ∫ prior(z) exp(loglik(z)) dz.
    """
    if (prior_sample is None) != (prior_logpdf is None):
        raise ValueError(
            "Custom priors require BOTH prior_sample and prior_logpdf: with "
            "only one of them the tempering weights and HMC mutations would "
            "silently target the default N(0, I) prior, biasing the "
            "posterior and evidence estimates."
        )
    # custom prior callables may close over small constants (a mean/scale
    # vector); the LIKELIHOOD operands still thread through loglik_args so
    # large arrays never bake into the compiled stages

    key, sub = jax.random.split(key)
    if prior_sample is None:
        particles = jax.random.normal(sub, (num_particles, dim))
        prior_fn = _std_normal_logpdf
    else:
        particles = prior_sample(sub, num_particles)
        prior_fn = prior_logpdf

    if particle_sharding is None and mesh is not None:
        from ..parallel.mesh import chain_sharding as _chain_sharding

        particle_sharding = _chain_sharding(mesh)
    if particle_sharding is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        sharding = particle_sharding
        if isinstance(sharding, NamedSharding) and len(sharding.spec) < 2:
            sharding = NamedSharding(
                sharding.mesh, P(*(tuple(sharding.spec) + (None,)))
            )
        particles = jax.device_put(particles, sharding)

    dtype = particles.dtype
    beta = 0.0
    betas, ess_hist, accept_hist = [], [], []
    log_evidence = 0.0
    step_size = mutation_step_size
    target_ess = target_ess_frac * num_particles

    final_log_w = None
    for stage in range(max_stages):
        key, sub = jax.random.split(key)
        # schedule floor: taking at least (remaining gap) / (stages left)
        # per stage guarantees beta reaches EXACTLY 1.0 within max_stages
        # (the last stage's floor is the whole gap); the adaptive bisection
        # only ever takes MORE than the floor, never less
        min_step = (1.0 - beta) / (max_stages - stage)
        particles, new_beta, ess, accept, ev_inc, final_log_w = _smc_stage(
            loglik_fn,
            prior_fn,
            particles,
            sub,
            jnp.asarray(beta, dtype),
            jnp.asarray(step_size, dtype),
            jnp.asarray(target_ess, dtype),
            jnp.asarray(min_step, dtype),
            num_mutation_steps,
            num_leapfrog_steps,
            *loglik_args,
        )
        # the ONLY host synchronization of the stage: four scalars for the
        # controller, the logs, and the termination check
        new_beta, ess, accept, ev_inc = map(
            float, jax.device_get((new_beta, ess, accept, ev_inc))
        )
        log_evidence += ev_inc

        # smooth multiplicative controller towards ~65% acceptance
        # (bounded per-stage change; replaces the old 0.7x/1.3x bang-bang)
        step_size *= float(np.clip(np.exp(accept - 0.65), 0.6, 1.45))

        betas.append(new_beta)
        ess_hist.append(ess)
        accept_hist.append(accept)
        logger.info(
            "SMC stage %d: beta=%.4f ess=%.0f accept=%.2f step=%.3g",
            stage,
            new_beta,
            ess,
            accept,
            step_size,
        )
        if ess < 0.5 * target_ess:
            logger.warning(
                "SMC stage %d ESS %.0f fell well below target %.0f (forced "
                "tempering step on a peaked likelihood); the resample/"
                "mutation absorbs the degeneracy, but consider more stages "
                "or particles if this recurs.",
                stage,
                ess,
                target_ess,
            )
        beta = new_beta
        if beta >= 1.0:
            break

    return SMCResult(
        particles=particles,
        # uniform — the schedule floor guarantees the loop exits at beta=1,
        # so the returned population was resampled and mutated under the
        # full posterior; the last PRE-resampling weights are surfaced below
        log_weights=jnp.zeros(num_particles),
        betas=betas,
        ess_history=ess_hist,
        acceptance_history=accept_hist,
        log_evidence=jnp.asarray(log_evidence),
        final_stage_log_weights=final_log_w,
    )


def laplace_start(loss_fn, loss_args, z0, z_map=None):
    """Build the Laplace-start ingredients for :func:`run_smc`: the
    adjusted log-likelihood  log π(z) − log q(z)  and the custom-prior
    kwargs for q = N(z*, diag Laplace σ²).

    ``z_map`` reuses an already-fitted MAP; otherwise one L-BFGS run from
    ``z0`` computes it.  Returns ``(adjusted_loglik, prior_kwargs)``; the
    tempered target at β = 1 and the evidence estimate are identical to
    the N(0, I)-prior start, but the annealing path is short and
    well-mixed on peaked posteriors.
    """
    from .laplace import compute_laplace_std
    from .optimizers import minimize_lbfgsb

    if z_map is None:
        z_map = minimize_lbfgsb(
            loss_fn, z0, loss_args=loss_args
        ).pre_transformation
    z_map = jnp.asarray(z_map)
    dim = int(z_map.shape[-1])
    sigma = jnp.asarray(
        compute_laplace_std(loss_fn, z_map, loss_args=loss_args)
    )
    # guard: a flat/ill-conditioned Hessian direction would explode q.
    # Clipping distorts the Laplace approximation in the clipped
    # directions (the beta=1 target and evidence stay exact — only the
    # "short well-mixed annealing path" rationale degrades), so the
    # count is surfaced instead of silently absorbed.
    n_low, n_high = jax.device_get(
        (
            jnp.count_nonzero(sigma < LAPLACE_SIGMA_MIN),
            jnp.count_nonzero(sigma > LAPLACE_SIGMA_MAX),
        )
    )
    n_clipped = int(n_low) + int(n_high)
    if n_clipped:
        frac = n_clipped / dim
        msg = (
            "laplace_start: clipping %d of %d Laplace std entries into "
            "[%g, %g] (%d too sharp, %d too flat/ill-conditioned)."
        )
        args = (
            n_clipped, dim, LAPLACE_SIGMA_MIN, LAPLACE_SIGMA_MAX,
            int(n_low), int(n_high),
        )
        if frac > LAPLACE_CLIP_WARN_FRACTION:
            logger.warning(
                msg + " The clipped start no longer matches the Laplace "
                "approximation's scales in those directions; the SMC "
                "result at beta=1 is still exact, but expect a longer "
                "annealing path (consider start='prior' or inspecting "
                "the Hessian conditioning).",
                *args,
            )
        else:
            logger.info(msg, *args)
    sigma = jnp.clip(sigma, LAPLACE_SIGMA_MIN, LAPLACE_SIGMA_MAX)

    def q_sample(k, n):
        return z_map[None, :] + sigma[None, :] * jax.random.normal(
            k, (n, dim), dtype=z_map.dtype
        )

    def q_logpdf(z):
        u = (z - z_map) / sigma
        return (
            -0.5 * jnp.sum(u**2)
            - jnp.sum(jnp.log(sigma))
            - 0.5 * dim * jnp.log(2 * jnp.pi)
        )

    def adjusted_loglik(z, *args):
        # the big model operands thread through args (never baked); only
        # the small (z*, σ) vectors live in the closure
        return -loss_fn(z, *args) - q_logpdf(z)

    return adjusted_loglik, dict(prior_sample=q_sample, prior_logpdf=q_logpdf)


def smc_density_posterior(
    estimator, num_particles=1024, seed=0, start="auto", num_sweeps=1,
    **kwargs
):
    """SMC over the whitened latents of a prepared density estimator.

    ``start="prior"`` anneals from N(0, I) — the textbook sweep, but at
    scale (e.g. 100k cells) the posterior is so peaked relative to the
    prior that most tempering steps ride the schedule floor with
    collapsed per-stage ESS (the round-4 100-stage sweep spent ~60
    stages at single-digit ESS and landed ~35 nats below the
    Laplace-start estimate).  ``start="laplace"`` instead fits the MAP
    (reusing ``pre_transformation`` when the estimator is already fitted)
    and anneals from the diagonal-Laplace Gaussian q = N(z*, diag σ²)
    with the ADJUSTED log-likelihood  log π(z) − log q(z), which targets
    the exact posterior at β = 1 with an identical evidence estimate —
    the annealing path is then short (q already matches the posterior's
    location and scale), so the adaptive schedule reaches β = 1 in a few
    well-mixed stages instead of max_stages forced ones.

    ``start="auto"`` (the default) picks "laplace" once the model has at
    least :data:`SMC_LAPLACE_AUTO_N` likelihood terms and "prior" below —
    at small n the prior sweep is cheap and unbiased while the MAP adds a
    fixed cost; at scale the degenerate prior start is strictly worse.

    ``num_sweeps > 1`` runs that many independent sweeps (fresh RNG
    streams) and attaches the across-sweep standard deviation of the
    log-evidence to the returned result (``log_evidence_std``), with
    ``log_evidence`` replaced by the across-sweep mean — the stated
    uncertainty of the evidence estimate.  Particles/weights returned are
    the final sweep's.
    """
    if estimator.loss_func is None:
        raise ValueError(
            "Estimator not prepared. Call prepare_inference(x) first."
        )
    dim = int(estimator.initial_value.shape[0])

    loss_fn = getattr(estimator, "_loss_fn", None)
    loss_args = getattr(estimator, "_loss_args", ())
    if loss_fn is None:
        loss_fn, loss_args = estimator.loss_func, ()

    if start == "auto":
        nn = getattr(estimator, "nn_distances", None)
        n_terms = 0 if nn is None else int(np.asarray(jnp.shape(nn)[0]))
        start = "laplace" if n_terms >= SMC_LAPLACE_AUTO_N else "prior"
        logger.info(
            "SMC start='auto' resolved to '%s' (%s likelihood terms, "
            "threshold %s).",
            start, f"{n_terms:,}", f"{SMC_LAPLACE_AUTO_N:,}",
        )

    if start == "laplace":
        loglik, prior_kwargs = laplace_start(
            loss_fn,
            loss_args,
            estimator.initial_value,
            z_map=getattr(estimator, "pre_transformation", None),
        )
    elif start == "prior":
        loglik = loglik_from_loss(loss_fn)
        prior_kwargs = {}
    else:
        raise ValueError(
            f"Unknown start option: {start!r}. "
            'Available options are "auto", "prior" and "laplace".'
        )

    evidences = []
    result = None
    for sweep in range(max(int(num_sweeps), 1)):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), sweep)
        result = run_smc(
            loglik,
            dim,
            key,
            num_particles=num_particles,
            loglik_args=loss_args,
            **prior_kwargs,
            **kwargs,
        )
        evidences.append(float(result.log_evidence))
    if len(evidences) > 1:
        ev_mean = float(np.mean(evidences))
        ev_std = float(np.std(evidences, ddof=1))
        logger.info(
            "SMC evidence over %d independent sweeps: %.2f +- %.2f nats.",
            len(evidences), ev_mean, ev_std,
        )
        result = result._replace(
            log_evidence=jnp.asarray(ev_mean), log_evidence_std=ev_std
        )
    function_samples = jax.vmap(estimator.transform)(result.particles)
    return result, function_samples
