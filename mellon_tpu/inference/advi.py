"""Mean-field automatic differentiation variational inference (ADVI).

Behavioural parity target: ``mellon/inference.py:768-876``: a diagonal
Gaussian q(z) = N(mean, diag(std²)) fit by maximizing a 40-sample vmapped
Monte-Carlo ELBO with adam.  Differences from the reference, chosen
deliberately:

* the whole optimization is one ``lax.scan`` (the reference ran a Python
  loop with one device dispatch per step, ``mellon/inference.py:868-870``);
* per-iteration PRNG keys are derived by folding the iteration index into a
  base key instead of re-seeding ``PRNGKey(t)`` (same independence property,
  jit-friendly key derivation);
* the initial log-std is 0 (initial std 1.0), matching the reference's
  actual behaviour (``-10 * zeros_like`` at ``mellon/inference.py:855``).
"""

from collections import namedtuple
from functools import partial

import jax
import jax.numpy as jnp
import optax

DEFAULT_N_ITER = 100
DEFAULT_INIT_LEARN_RATE = 1e-1
DEFAULT_NUM_SAMPLES = 40

Results = namedtuple("Results", "pre_transformation pre_transformation_std losses")


def _gaussian_sample(key, mean, log_std):
    return mean + jnp.exp(log_std) * jax.random.normal(key, mean.shape)


def _gaussian_logpdf(x, mean, log_std):
    z = (x - mean) / jnp.exp(log_std)
    return jnp.sum(-0.5 * z**2 - log_std - 0.5 * jnp.log(2 * jnp.pi))


def elbo_estimate(logprob, key, mean, log_std, num_samples):
    """Average single-sample ELBO over ``num_samples`` vmapped draws
    (parity: ``mellon/inference.py:792-818``)."""
    keys = jax.random.split(key, num_samples)

    def single(k):
        sample = _gaussian_sample(k, mean, log_std)
        return logprob(sample) - _gaussian_logpdf(sample, mean, log_std)

    return jnp.mean(jax.vmap(single)(keys))


@partial(jax.jit, static_argnames=("loss_func", "n_iter", "nsamples"))
def _run_advi(
    loss_func, initial_parameters, n_iter, init_learn_rate, nsamples, seed,
    *loss_args,
):
    fun = (lambda z: loss_func(z, *loss_args)) if loss_args else loss_func

    def negative_logprob(x):
        return -fun(x)

    def objective(params, key):
        mean, log_std = params
        return -elbo_estimate(negative_logprob, key, mean, log_std, nsamples)

    schedule = lambda i: jnp.exp(-1e-2 * i) * init_learn_rate
    opt = optax.adam(schedule)
    init_params = (initial_parameters, jnp.zeros_like(initial_parameters))
    base_key = jax.random.PRNGKey(seed)

    def step(carry, t):
        params, state = carry
        key = jax.random.fold_in(base_key, t)
        value, grads = jax.value_and_grad(objective)(params, key)
        updates, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        return (params, state), value

    (params, _), elbos = jax.lax.scan(
        step, (init_params, opt.init(init_params)), jnp.arange(n_iter)
    )
    mean, log_std = params
    return mean, jnp.exp(log_std), elbos


def run_advi(
    loss_func,
    initial_parameters,
    n_iter=DEFAULT_N_ITER,
    init_learn_rate=DEFAULT_INIT_LEARN_RATE,
    nsamples=DEFAULT_NUM_SAMPLES,
    jit=True,
    seed=0,
    loss_args=(),
):
    """Fit a mean-field Gaussian approximation to exp(-loss_func).

    Returns (mean, std, ELBO history); API parity with
    ``mellon/inference.py:821-876``.  Pass big operands via ``loss_args``
    (``loss_func(z, *loss_args)``) so they stay runtime arguments.
    """
    mean, std, elbos = _run_advi(
        loss_func,
        initial_parameters,
        int(n_iter),
        init_learn_rate,
        int(nsamples),
        seed,
        *loss_args,
    )
    return Results(mean, std, elbos)
