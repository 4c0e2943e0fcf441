"""Multi-chain MCMC driver with cross-chain warmup adaptation.

NEW capability relative to the reference (see :mod:`.samplers`).  The chain
axis is a plain batch axis: chains run under ``vmap`` inside one compiled
``lax.scan``, so placing the chain axis of the initial state on a
device-mesh axis shards chains across devices (adaptation statistics
reduce across the chain axis, which XLA lowers to a ``psum`` when sharded —
see :func:`mellon_tpu.parallel.sharding.shard_chains`).

Performance contract: the ENTIRE run — three warmup phases and sampling —
is one jitted program keyed on the (static) potential function and shapes;
model operands (e.g. the n×m matrix L of the density model) are threaded as
runtime arguments via ``potential_args``, never baked as constants, so the
executable is small and reused across fits.
"""

import functools
import logging
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .samplers import (
    da_init,
    da_update,
    hmc_init,
    hmc_kernel,
    nuts_kernel,
    welford_init,
    welford_update,
    welford_variance,
)

logger = logging.getLogger("mellon_tpu")


class MCMCResult(NamedTuple):
    samples: jnp.ndarray          # (num_chains, num_samples, dim)
    potential: jnp.ndarray        # (num_chains, num_samples)
    accept_prob: jnp.ndarray      # (num_chains, num_samples)
    diverging: jnp.ndarray        # (num_chains, num_samples)
    step_size: jnp.ndarray        # scalar (shared across chains)
    inv_mass_diag: jnp.ndarray    # (dim,)
    num_leapfrog: jnp.ndarray     # (num_chains, num_samples)


@partial(
    jax.jit,
    static_argnames=(
        "potential_fn",
        "algorithm",
        "max_tree_depth",
        "num_leapfrog_steps",
        "num_warmup",
        "num_samples",
        "target_accept",
    ),
)
def _run_mcmc_compiled(
    potential_fn,
    z0,
    key,
    num_warmup,
    num_samples,
    algorithm,
    max_tree_depth,
    num_leapfrog_steps,
    initial_step_size,
    target_accept,
    *potential_args,
):
    pot = (
        (lambda z: potential_fn(z, *potential_args))
        if potential_args
        else potential_fn
    )
    if algorithm == "nuts":
        kernel = nuts_kernel(pot, max_tree_depth=max_tree_depth)
    elif algorithm == "hmc":
        kernel = hmc_kernel(pot, num_steps=num_leapfrog_steps)
    else:
        raise ValueError(f"Unknown MCMC algorithm: {algorithm}")

    num_chains, dim = z0.shape
    batched_kernel = jax.vmap(kernel, in_axes=(0, 0, None, None))
    states = jax.vmap(lambda z: hmc_init(pot, z))(z0)

    n_phase_a = max(num_warmup // 10, 1)
    n_phase_b = max(num_warmup - 2 * n_phase_a, 0)
    n_phase_c = n_phase_a

    # ---- warmup A: step size only, identity mass ---------------------------
    identity_mass = jnp.ones(dim)

    def warmup_a(carry, keys):
        states, da = carry
        new_states, infos = batched_kernel(
            states, keys, jnp.exp(da.log_step), identity_mass
        )
        da = da_update(da, jnp.mean(infos.accept_prob), target=target_accept)
        return (new_states, da), None

    da = da_init(initial_step_size)
    keys_a = jax.random.split(jax.random.fold_in(key, 0), (n_phase_a, num_chains))
    (states, da), _ = jax.lax.scan(warmup_a, (states, da), keys_a)

    # ---- warmup B: step size + Welford mass --------------------------------
    def warmup_b(carry, keys):
        states, da, wf = carry
        new_states, infos = batched_kernel(
            states, keys, jnp.exp(da.log_step), identity_mass
        )
        da = da_update(da, jnp.mean(infos.accept_prob), target=target_accept)
        wf = jax.lax.fori_loop(
            0,
            num_chains,
            lambda i, w: welford_update(w, new_states.z[i]),
            wf,
        )
        return (new_states, da, wf), None

    wf = welford_init(dim)
    keys_b = jax.random.split(jax.random.fold_in(key, 1), (n_phase_b, num_chains))
    (states, da, wf), _ = jax.lax.scan(warmup_b, (states, da, wf), keys_b)
    inv_mass = jnp.where(
        wf.count > 2, welford_variance(wf), identity_mass
    )

    # ---- warmup C: step-size re-adaptation under the new metric ------------
    def warmup_c(carry, keys):
        states, da = carry
        new_states, infos = batched_kernel(
            states, keys, jnp.exp(da.log_step), inv_mass
        )
        da = da_update(da, jnp.mean(infos.accept_prob), target=target_accept)
        return (new_states, da), None

    da = da_init(jnp.exp(da.log_step_avg))
    keys_c = jax.random.split(jax.random.fold_in(key, 2), (n_phase_c, num_chains))
    (states, da), _ = jax.lax.scan(warmup_c, (states, da), keys_c)
    step_size = jnp.exp(da.log_step_avg)

    # ---- sampling ----------------------------------------------------------
    def sample_step(states, keys):
        new_states, infos = batched_kernel(states, keys, step_size, inv_mass)
        out = (
            new_states.z,
            new_states.potential,
            infos.accept_prob,
            infos.diverging,
            infos.num_steps,
        )
        return new_states, out

    keys_s = jax.random.split(
        jax.random.fold_in(key, 3), (num_samples, num_chains)
    )
    states, (zs, pots, accepts, divs, steps) = jax.lax.scan(
        sample_step, states, keys_s
    )

    return MCMCResult(
        samples=jnp.moveaxis(zs, 0, 1),
        potential=jnp.moveaxis(pots, 0, 1),
        accept_prob=jnp.moveaxis(accepts, 0, 1),
        diverging=jnp.moveaxis(divs, 0, 1),
        step_size=step_size,
        inv_mass_diag=inv_mass,
        num_leapfrog=jnp.moveaxis(steps, 0, 1),
    )


# ---------------------------------------------------------------------------
# chunked execution: the same three-phase warmup + sampling, split into
# short program executions with ALL sampler state (chain states, dual-
# averaging, Welford, mass matrix) carried as device arrays between calls.
#
# Why: a long monolithic run cannot be checkpointed or resumed.  Chunking
# costs one dispatch (~ms) per chunk and gives mid-run checkpointability;
# each chunk program is compiled once and reused for every chunk of its
# phase.
# ---------------------------------------------------------------------------


def _kernel_for(potential_fn, algorithm, max_tree_depth, num_leapfrog_steps,
                potential_args):
    pot = (
        (lambda z: potential_fn(z, *potential_args))
        if potential_args
        else potential_fn
    )
    if algorithm == "nuts":
        return pot, nuts_kernel(pot, max_tree_depth=max_tree_depth)
    elif algorithm == "hmc":
        return pot, hmc_kernel(pot, num_steps=num_leapfrog_steps)
    raise ValueError(f"Unknown MCMC algorithm: {algorithm}")


@partial(
    jax.jit,
    static_argnames=(
        "potential_fn", "algorithm", "max_tree_depth", "num_leapfrog_steps",
    ),
)
def _init_chunked(potential_fn, z0, algorithm, max_tree_depth,
                  num_leapfrog_steps, *potential_args):
    pot, _ = _kernel_for(
        potential_fn, algorithm, max_tree_depth, num_leapfrog_steps,
        potential_args,
    )
    return jax.vmap(lambda z: hmc_init(pot, z))(z0)


@partial(
    jax.jit,
    static_argnames=(
        "potential_fn", "algorithm", "max_tree_depth", "num_leapfrog_steps",
        "num_steps", "target_accept", "phase",
    ),
)
def _warmup_chunk(
    potential_fn, states, da, wf, inv_mass, chunk_key, num_steps,
    algorithm, max_tree_depth, num_leapfrog_steps, target_accept, phase,
    *potential_args,
):
    """``num_steps`` warmup transitions of phase 'a' (step size only,
    identity mass), 'b' (+ Welford mass accumulation) or 'c' (step-size
    re-adaptation under the adapted mass)."""
    _, kernel = _kernel_for(
        potential_fn, algorithm, max_tree_depth, num_leapfrog_steps,
        potential_args,
    )
    num_chains = states.z.shape[0]
    batched_kernel = jax.vmap(kernel, in_axes=(0, 0, None, None))
    dim = states.z.shape[1]
    identity_mass = jnp.ones(dim)
    mass = identity_mass if phase in ("a", "b") else inv_mass

    def body(carry, keys):
        states, da, wf = carry
        new_states, infos = batched_kernel(
            states, keys, jnp.exp(da.log_step), mass
        )
        da = da_update(da, jnp.mean(infos.accept_prob), target=target_accept)
        if phase == "b":
            wf = jax.lax.fori_loop(
                0,
                num_chains,
                lambda i, w: welford_update(w, new_states.z[i]),
                wf,
            )
        return (new_states, da, wf), None

    keys = jax.random.split(chunk_key, (num_steps, states.z.shape[0]))
    (states, da, wf), _ = jax.lax.scan(body, (states, da, wf), keys)
    return states, da, wf


@partial(
    jax.jit,
    static_argnames=(
        "potential_fn", "algorithm", "max_tree_depth", "num_leapfrog_steps",
        "num_steps",
    ),
)
def _sample_chunk(
    potential_fn, states, step_size, inv_mass, chunk_key, num_steps,
    algorithm, max_tree_depth, num_leapfrog_steps, *potential_args,
):
    _, kernel = _kernel_for(
        potential_fn, algorithm, max_tree_depth, num_leapfrog_steps,
        potential_args,
    )
    batched_kernel = jax.vmap(kernel, in_axes=(0, 0, None, None))

    def body(states, keys):
        new_states, infos = batched_kernel(states, keys, step_size, inv_mass)
        out = (
            new_states.z,
            new_states.potential,
            infos.accept_prob,
            infos.diverging,
            infos.num_steps,
        )
        return new_states, out

    keys = jax.random.split(chunk_key, (num_steps, states.z.shape[0]))
    states, outs = jax.lax.scan(body, states, keys)
    return states, outs


def _run_mcmc_chunked(
    potential_fn,
    z0,
    key,
    num_warmup,
    num_samples,
    algorithm,
    max_tree_depth,
    num_leapfrog_steps,
    initial_step_size,
    target_accept,
    steps_per_call,
    potential_args,
):
    K = int(steps_per_call)
    states = _init_chunked(
        potential_fn, z0, algorithm, max_tree_depth, num_leapfrog_steps,
        *potential_args,
    )
    dim = z0.shape[1]

    n_phase_a = max(num_warmup // 10, 1)
    n_phase_b = max(num_warmup - 2 * n_phase_a, 0)
    n_phase_c = n_phase_a

    def chunk_sizes(total):
        sizes = [K] * (total // K)
        if total % K:
            sizes.append(total % K)
        return sizes

    da = da_init(jnp.asarray(initial_step_size))
    wf = welford_init(dim)
    inv_mass = jnp.ones(dim)

    common = (algorithm, max_tree_depth, num_leapfrog_steps, target_accept)
    for phase, total in (("a", n_phase_a), ("b", n_phase_b)):
        phase_key = jax.random.fold_in(key, {"a": 0, "b": 1}[phase])
        for ci, size in enumerate(chunk_sizes(total)):
            states, da, wf = _warmup_chunk(
                potential_fn, states, da, wf, inv_mass,
                jax.random.fold_in(phase_key, ci), size, *common, phase,
                *potential_args,
            )
    inv_mass = jnp.where(wf.count > 2, welford_variance(wf), jnp.ones(dim))
    da = da_init(jnp.exp(da.log_step_avg))
    phase_key = jax.random.fold_in(key, 2)
    for ci, size in enumerate(chunk_sizes(n_phase_c)):
        states, da, wf = _warmup_chunk(
            potential_fn, states, da, wf, inv_mass,
            jax.random.fold_in(phase_key, ci), size, *common, "c",
            *potential_args,
        )
    step_size = jnp.exp(da.log_step_avg)

    phase_key = jax.random.fold_in(key, 3)
    collected = []
    for ci, size in enumerate(chunk_sizes(num_samples)):
        states, outs = _sample_chunk(
            potential_fn, states, step_size, inv_mass,
            jax.random.fold_in(phase_key, ci), size,
            algorithm, max_tree_depth, num_leapfrog_steps,
            *potential_args,
        )
        collected.append(outs)

    zs, pots, accepts, divs, steps = (
        jnp.concatenate([c[i] for c in collected], axis=0)
        for i in range(5)
    )
    return MCMCResult(
        samples=jnp.moveaxis(zs, 0, 1),
        potential=jnp.moveaxis(pots, 0, 1),
        accept_prob=jnp.moveaxis(accepts, 0, 1),
        diverging=jnp.moveaxis(divs, 0, 1),
        step_size=step_size,
        inv_mass_diag=inv_mass,
        num_leapfrog=jnp.moveaxis(steps, 0, 1),
    )


@partial(
    jax.jit,
    static_argnames=(
        "potential_fn",
        "algorithm",
        "max_tree_depth",
        "num_leapfrog_steps",
        "num_samples",
    ),
)
def _resume_mcmc_compiled(
    potential_fn,
    z0,
    key,
    num_samples,
    algorithm,
    max_tree_depth,
    num_leapfrog_steps,
    step_size,
    inv_mass,
    *potential_args,
):
    """Sampling-only program: no warmup phases, the adapted step size and
    mass matrix come from a checkpoint (see :mod:`..parallel.checkpoint`)."""
    pot = (
        (lambda z: potential_fn(z, *potential_args))
        if potential_args
        else potential_fn
    )
    if algorithm == "nuts":
        kernel = nuts_kernel(pot, max_tree_depth=max_tree_depth)
    elif algorithm == "hmc":
        kernel = hmc_kernel(pot, num_steps=num_leapfrog_steps)
    else:
        raise ValueError(f"Unknown MCMC algorithm: {algorithm}")

    num_chains, dim = z0.shape
    batched_kernel = jax.vmap(kernel, in_axes=(0, 0, None, None))
    states = jax.vmap(lambda z: hmc_init(pot, z))(z0)

    def sample_step(states, keys):
        new_states, infos = batched_kernel(states, keys, step_size, inv_mass)
        out = (
            new_states.z,
            new_states.potential,
            infos.accept_prob,
            infos.diverging,
            infos.num_steps,
        )
        return new_states, out

    keys_s = jax.random.split(key, (num_samples, num_chains))
    states, (zs, pots, accepts, divs, steps) = jax.lax.scan(
        sample_step, states, keys_s
    )

    return MCMCResult(
        samples=jnp.moveaxis(zs, 0, 1),
        potential=jnp.moveaxis(pots, 0, 1),
        accept_prob=jnp.moveaxis(accepts, 0, 1),
        diverging=jnp.moveaxis(divs, 0, 1),
        step_size=step_size,
        inv_mass_diag=inv_mass,
        num_leapfrog=jnp.moveaxis(steps, 0, 1),
    )


def resume_mcmc(
    potential_fn,
    z0,
    key,
    step_size,
    inv_mass_diag,
    num_samples=500,
    algorithm="nuts",
    max_tree_depth=10,
    num_leapfrog_steps=32,
    chain_sharding=None,
    potential_args=(),
):
    """Continue sampling from a checkpointed sampler state — NO re-warmup.

    The pod-restart path (SURVEY.md §5.4): restore ``z0`` (the chains' last
    positions, e.g. ``result.samples[:, -1, :]``), the adapted ``step_size``
    and ``inv_mass_diag`` from :func:`..parallel.checkpoint.load_sampler_state`,
    optionally reshard onto a DIFFERENT mesh via ``chain_sharding``, and run
    the sampling phase only.  Momenta are drawn fresh (exact: momentum is
    resampled every transition anyway), so the resumed chain targets the
    same stationary distribution with no warmup transient.
    """
    z0 = jnp.atleast_2d(z0)
    if chain_sharding is not None:
        z0 = jax.device_put(z0, chain_sharding)
    return _resume_mcmc_compiled(
        potential_fn,
        z0,
        key,
        int(num_samples),
        algorithm,
        int(max_tree_depth),
        int(num_leapfrog_steps),
        jnp.asarray(step_size),
        jnp.asarray(inv_mass_diag),
        *potential_args,
    )


def run_mcmc(
    potential_fn,
    z0,
    key,
    num_warmup=500,
    num_samples=500,
    num_chains=4,
    algorithm="nuts",
    max_tree_depth=10,
    num_leapfrog_steps=32,
    initial_step_size=0.1,
    target_accept=0.8,
    chain_sharding=None,
    steps_per_call=None,
    potential_args=(),
):
    """Sample from exp(-potential_fn) with NUTS or HMC.

    Parameters
    ----------
    potential_fn : callable — the negative log density; either ``f(z)`` or
        ``f(z, *potential_args)`` when operands are threaded.
    z0 : (dim,) or (num_chains, dim) initial positions.
    key : PRNG key.
    chain_sharding : optional ``jax.sharding.NamedSharding`` for the chain
        axis; when given, chain states are placed with it so chains run on
        separate devices.
    steps_per_call : optional int — when set, the run executes as a
        sequence of short chunk programs of at most this many transitions
        each, with all sampler state carried on device between calls
        (instead of one monolithic warmup+sampling program).  Use for
        mid-run checkpointability of long runs; the statistical
        procedure is identical (per-chunk PRNG folding differs from the
        monolithic key schedule, so draws are not bit-identical).
    potential_args : tuple of arrays passed through to ``potential_fn`` as
        runtime arguments (keeps large operands out of the executable).

    Returns
    -------
    MCMCResult with samples of shape (num_chains, num_samples, dim).
    """
    z0 = jnp.atleast_2d(z0)
    if z0.shape[0] == 1 and num_chains > 1:
        key, sub = jax.random.split(key)
        z0 = z0 + 0.1 * jax.random.normal(sub, (num_chains, z0.shape[1]))
    if chain_sharding is not None:
        z0 = jax.device_put(z0, chain_sharding)

    if steps_per_call is not None:
        return _run_mcmc_chunked(
            potential_fn,
            z0,
            key,
            int(num_warmup),
            int(num_samples),
            algorithm,
            int(max_tree_depth),
            int(num_leapfrog_steps),
            jnp.asarray(initial_step_size),
            float(target_accept),
            int(steps_per_call),
            tuple(potential_args),
        )

    return _run_mcmc_compiled(
        potential_fn,
        z0,
        key,
        int(num_warmup),
        int(num_samples),
        algorithm,
        int(max_tree_depth),
        int(num_leapfrog_steps),
        jnp.asarray(initial_step_size),
        float(target_accept),
        *potential_args,
    )


def sample_density_posterior(
    estimator,
    num_warmup=500,
    num_samples=500,
    num_chains=4,
    algorithm="nuts",
    seed=0,
    precision=None,
    precondition=None,
    function_samples=True,
    **kwargs,
):
    """Draw posterior samples of the latent GP function of a fitted (or
    prepared) density estimator and return (MCMCResult, function samples).

    This supersedes the reference's Laplace/ADVI posterior approximations
    with exact MCMC over the whitened latents z; the function-space samples
    are ``transform(z) = L z + mu`` applied per draw.

    ``function_samples=False`` returns ``(result, None)`` — required at
    scale when the (total draws × n cells) function matrix cannot fit in
    HBM (e.g. 64k draws × 100k cells = 25.6 GB); compute per-cell
    summaries from ``result.samples`` through ``estimator.transform`` in
    caller-chosen chunks instead.
    """
    if estimator.loss_func is None:
        raise ValueError(
            "Estimator not prepared. Call prepare_inference(x) first."
        )
    # use the operand-threaded static loss when the estimator provides it
    potential_fn = getattr(estimator, "_loss_fn", None)
    potential_args = getattr(estimator, "_loss_args", ())
    if potential_fn is None:
        potential_fn = estimator.loss_func
        potential_args = ()
    if precision == "bf16":
        # store the matrix operands in bfloat16: halves the HBM traffic of
        # each leapfrog (~1.9x measured) while the matvec still accumulates
        # in f32; perturbs the target by ~1e-3 relative
        logger.warning(
            "precision='bf16' sampling FAILED the posterior-agreement bar "
            "on the 100k-cell benchmark model: the ~1e-3 perturbation of "
            "the latent function acts as high-frequency potential noise — "
            "trees ran to the depth cap and posterior stds were biased in "
            "92% of dimensions.  Use it only with your own agreement "
            "check; the f32 default is certified."
        )
        potential_args = tuple(
            a.astype(jnp.bfloat16)
            if getattr(a, "ndim", 0) == 2 and a.dtype == jnp.float32
            else a
            for a in potential_args
        )
    elif precision is not None:
        raise ValueError(f"Unknown precision option: {precision}")
    z0 = estimator.initial_value
    if getattr(estimator, "pre_transformation", None) is not None:
        z0 = estimator.pre_transformation
    potential_fn, potential_args = zero_centered_potential(
        potential_fn, z0, potential_args
    )
    key = jax.random.PRNGKey(seed)
    if precondition == "hessian":
        # dense-metric sampling through the MAP-Hessian transform: the
        # density posterior's scale spread defeats diagonal mass
        # adaptation (trees max out at any depth); in w = Rᵀ(z - z*)
        # coordinates the target is near-N(0, I) and trees turn in a few
        # leapfrogs.  Requires a (near-)MAP z0.
        z0, _, _ = newton_polish(potential_fn, z0, potential_args)
        R = hessian_cholesky(
            potential_fn, z0, jnp.asarray(1e-6, z0.dtype), *potential_args
        )
        T = precondition_transform(R)
        pot_w = preconditioned_potential(potential_fn)
        result = run_mcmc(
            pot_w,
            jnp.zeros_like(z0),
            key,
            num_warmup=num_warmup,
            num_samples=num_samples,
            num_chains=num_chains,
            algorithm=algorithm,
            potential_args=(T, z0) + tuple(potential_args),
            **kwargs,
        )
        # report draws in z-space (the model's latents)
        result = result._replace(
            samples=unwhiten_samples(result.samples, T, z0)
        )
    elif precondition is not None:
        raise ValueError(
            f"Unknown precondition option: {precondition!r}. "
            'Available options are "hessian" and None.'
        )
    else:
        result = run_mcmc(
            potential_fn,
            z0,
            key,
            num_warmup=num_warmup,
            num_samples=num_samples,
            num_chains=num_chains,
            algorithm=algorithm,
            potential_args=potential_args,
            **kwargs,
        )
    if not function_samples:
        return result, None
    transform = estimator.transform
    flat = result.samples.reshape((-1,) + result.samples.shape[2:])
    return result, jax.vmap(transform)(flat)


def zero_centered_potential(potential_fn, z0, potential_args):
    """Re-center a density potential to ~0 at ``z0`` by threading the
    ``loss_offset_per_term`` operand (see :func:`..losses.density_loss`).

    At scale the total potential is O(n) and one f32 ulp at 1.3e7 is 1.0,
    so leapfrog energy differences quantize to ±0.5-1 nats regardless of
    step size — dual averaging then collapses the step and every tree
    runs to the depth cap (round-5 root cause of the 1M-atlas/synthetic
    non-mixing).  The shift must happen INSIDE the likelihood reduction
    (subtracting after the sum cannot recover bits already rounded away),
    hence the per-term operand rather than a wrapper.  No-op for
    potentials that are not the operand-threaded density loss.
    """
    from .losses import density_loss

    if potential_fn is not density_loss or len(potential_args) != 4:
        return potential_fn, potential_args
    n = potential_args[1].shape[0]
    v0 = _value_and_grad_program(potential_fn, z0, *potential_args)[0]
    offset = jnp.asarray(float(v0) / n, dtype=jnp.float32)
    logger.info(
        "Zero-centering the sampled potential: loss(z0) = %.6g over %s "
        "cells (offset %.6g/term); reported potentials are relative to z0.",
        float(v0), f"{n:,}", float(offset),
    )
    return potential_fn, tuple(potential_args) + (offset,)


# ---------------------------------------------------------------------------
# Hessian preconditioning: dense-metric NUTS through a potential transform
# ---------------------------------------------------------------------------
#
# Round-4 finding: on a prepared 100k-cell density model (512 latents) the
# posterior's scale spread defeats DIAGONAL mass adaptation outright —
# every NUTS tree maxes out even at depth 10 (1023 leapfrogs/draw,
# Rhat >> 1 after 500 warmup / 1000 draws).  The latent dimension is small
# (m = landmarks after pruning), so the FULL Hessian at the MAP is cheap:
# m HVPs = O(m * n * m) matmul work.  Sampling
# w = Rᵀ(z - z*) with H = R Rᵀ makes the target near-N(0, I) (the
# Bernstein-von-Mises regime at 100k cells), so trajectories U-turn in a
# few leapfrogs instead of never.  Each leapfrog adds one m x m
# triangular solve per chain — negligible next to the n x m matvec.


@partial(jax.jit, static_argnames=("potential_fn", "block"))
def _hessian_block(potential_fn, z_map, start, block, *potential_args):
    """``block`` Hessian columns from forward-over-reverse HVPs; start is
    a runtime operand so all blocks share one executable."""
    fun = (
        (lambda z: potential_fn(z, *potential_args))
        if potential_args
        else potential_fn
    )
    grad_f = jax.grad(fun)
    m = z_map.shape[-1]

    def hvp(offset):
        e = jnp.zeros((m,), dtype=z_map.dtype).at[start + offset].set(1.0)
        return jax.jvp(grad_f, (z_map,), (e,))[1]

    # the vmapped HVP's matvecs become matmuls whose default single
    # reduced-precision pass injects ~1e-3-relative error into H — enough
    # to corrupt the Hessian's soft eigenvalues and break the whitening
    # transform built from it (round-4 root cause; scripts/sampler_sanity.py)
    with jax.default_matmul_precision("highest"):
        return jax.vmap(hvp)(jnp.arange(block))


def hessian_cholesky(potential_fn, z_map, jitter, *potential_args,
                     block=512, host_f64=True):
    """Lower Cholesky factor R of the potential's Hessian at ``z_map``
    (H + jitter*I = R Rᵀ).  The m HVPs run in blocks of ``block`` basis
    vectors (each HVP lane carries O(n) intermediates, so a full-m vmap
    at 100k x 5000 would hold ~10 GB live); the last block overlaps to
    keep the shape static.

    The factorization runs on the host in float64 with jitter escalation
    (:func:`..ops.linalg.host_cholesky_f64`): the MAP Hessian of a
    100k-cell density model is ~1e4-1e8 conditioned, and a bare f32
    device Cholesky at that conditioning silently returns NaN — or,
    worse, a finite factor whose inverse no longer whitens (the round-4
    phase-2 precond runs adapted against exactly such a factor and every
    tree still maxed out).  m ≤ a few thousand, so the host factor is
    microseconds against the m HVPs that build H.

    ``host_f64=False`` keeps the factorization on device (jittered f32
    Cholesky at HIGHEST precision, host-f64 only as NaN fallback): a
    Newton solve needs any valid descent factor, not the
    preconditioner-grade f64 one, and at m=5000 the host path would add a
    ~100 MB device→host transfer per call (ADVICE r4)."""
    from ..ops.linalg import host_cholesky_f64

    m = z_map.shape[-1]
    b = min(block, m)
    rows = []
    prev_end = 0
    for start in range(0, m, b):
        start = min(start, m - b)
        part = _hessian_block(
            potential_fn, z_map, jnp.asarray(start), b, *potential_args
        )
        if start < prev_end:  # overlap on the final block
            part = part[prev_end - start :]
        rows.append(part)
        prev_end = max(prev_end, start + b)
    H = rows[0] if len(rows) == 1 else jnp.concatenate(rows, axis=0)
    if not host_f64:
        R = _device_jittered_cholesky(H, jnp.asarray(jitter, H.dtype))
        if not bool(jnp.any(jnp.isnan(R))):
            return R
        # fall through to the robust host path on failure
    import numpy as np

    H64 = np.asarray(jax.device_get(H), dtype=np.float64)
    H64 = 0.5 * (H64 + H64.T)
    R64 = host_cholesky_f64(H64, jitter=float(jitter))
    return jnp.asarray(R64, dtype=z_map.dtype)


@jax.jit
def _device_jittered_cholesky(H, jitter):
    """Symmetrize + jittered Cholesky on device at HIGHEST precision (the
    cheap factor for newton_polish's inner loop; NaN on failure)."""
    Hs = 0.5 * (H + H.T)
    diag = jnp.arange(Hs.shape[0])
    with jax.default_matmul_precision("highest"):
        return jnp.linalg.cholesky(Hs.at[diag, diag].add(jitter))


def precondition_transform(R):
    """T = R⁻ᵀ as an explicit matrix: the per-leapfrog coordinate map
    becomes one m×m MATMUL per chain batch instead of a triangular
    solve (whose blocked-panel lowering is far off matmul peak).

    The inverse is computed on the host in float64: at Hessian condition
    numbers of 1e6+ the f32 triangular solve loses enough accuracy that
    TᵀHT drifts visibly from I (the whole point of the transform), while
    the f64 inverse of the m×m factor costs microseconds.  The RESULT is
    f32 — representing a well-computed T in f32 is harmless; computing
    it in f32 is not."""
    import numpy as np
    from scipy.linalg import solve_triangular as host_solve_triangular

    R64 = np.asarray(jax.device_get(R), dtype=np.float64)
    eye = np.eye(R64.shape[0])
    T64 = host_solve_triangular(R64.T, eye, lower=False)
    return jnp.asarray(T64, dtype=R.dtype)


@functools.lru_cache(maxsize=None)
def preconditioned_potential(potential_fn):
    """Wrap ``potential_fn(z, *args)`` as ``pot(w, T, z_map, *args)`` with
    z = z_map + T w and T = R⁻ᵀ (see :func:`precondition_transform`).
    Cached so the wrapper has a stable identity per base potential (one
    compiled sampler program per model family)."""

    def pot(w, T, z_map, *args):
        # HIGHEST: under the chain vmap this matvec is a matmul whose
        # default reduced-precision pass would put ~1e-3-relative noise on
        # z — i.e. on the sampled potential surface (see losses.py note)
        z = z_map + jnp.dot(T, w, precision=jax.lax.Precision.HIGHEST)
        return potential_fn(z, *args)

    return pot


def unwhiten_samples(samples_w, T, z_map, block=65536):
    """Map w-space draws back to z: z = z_map + T w, blocked over the
    flattened draw axis."""
    shape = samples_w.shape
    flat = samples_w.reshape(-1, shape[-1])
    outs = []
    for s in range(0, flat.shape[0], block):
        wb = flat[s : s + block]
        outs.append(
            z_map[None, :]
            + jnp.dot(wb, T.T, precision=jax.lax.Precision.HIGHEST)
        )
    flat_z = outs[0] if len(outs) == 1 else jnp.concatenate(outs, axis=0)
    return flat_z.reshape(shape)


@partial(jax.jit, static_argnames=("potential_fn",))
def _value_and_grad_program(potential_fn, z, *potential_args):
    fun = (
        (lambda zz: potential_fn(zz, *potential_args))
        if potential_args
        else potential_fn
    )
    return jax.value_and_grad(fun)(z)


@partial(jax.jit, static_argnames=())
def _newton_step(R, g):
    from jax.scipy.linalg import cho_solve

    return cho_solve((R, True), g)


def newton_polish(potential_fn, z0, potential_args=(), iters=10,
                  jitter=1e-6, tol=1e-8):
    """Newton-polish a (near-)MAP point using the blocked full Hessian.

    Round-4 finding: at 100k cells x 512 latents the L-BFGS MAP exits at
    its iteration cap with a far-from-zero gradient (the same
    conditioning that defeats diagonal-mass NUTS also starves a
    limited-memory quasi-Newton method), and a Hessian metric taken at an
    unconverged point sends every preconditioned trajectory into a long
    transient.  The density posterior is log-concave, so full Newton
    converges quadratically; each iteration is one blocked-HVP Hessian
    build + an m x m Cholesky solve.  Backtracks (halving, 5 tries) if a
    step fails to decrease the potential.  Returns (z, grad_norm_before,
    grad_norm_after).
    """
    z = z0
    v0, g = _value_and_grad_program(potential_fn, z, *potential_args)
    gn0 = float(jnp.linalg.norm(g))
    value = v0
    for _ in range(int(iters)):
        gn = float(jnp.linalg.norm(g))
        if gn <= tol * max(1.0, abs(float(value))):
            break
        R = hessian_cholesky(
            potential_fn, z, jnp.asarray(jitter, z.dtype), *potential_args,
            host_f64=False,
        )
        dz = _newton_step(R, g)
        step = 1.0
        for _try in range(5):
            z_new = z - step * dz
            v_new, g_new = _value_and_grad_program(
                potential_fn, z_new, *potential_args
            )
            if bool(jnp.isfinite(v_new)) and float(v_new) <= float(value):
                z, value, g = z_new, v_new, g_new
                break
            step *= 0.5
        else:
            break  # no decrease: keep the best point found
    gn1 = float(jnp.linalg.norm(g))
    logger.info(
        "Newton polish: |grad| %.3g -> %.3g (potential %.6g).",
        gn0, gn1, float(value),
    )
    return z, gn0, gn1
