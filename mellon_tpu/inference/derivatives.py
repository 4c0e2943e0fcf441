"""Vmapped autodiff wrappers: per-point gradient, Hessian, slogdet(Hessian).

Behavioural parity target: ``mellon/derivatives.py``.

Performance note: the vmapped cores are module-level jitted programs with
the differentiated ``function`` as the static key.  Predictor methods pass
bound methods, which hash by (instance, function), so repeated calls on the
same predictor reuse one executable — wrapping a fresh closure in
``jax.jit`` per call (the obvious formulation) recompiles and reloads the
program on every invocation.
"""

from functools import partial

import jax
import jax.numpy as jnp

from ..utils.validation import validate_1d, validate_float


def derivative(function, x, jit=True):
    """Scalar derivative at each point of a 1-d grid
    (parity: ``mellon/derivatives.py:7-45``)."""

    def get_grad(x):
        return jax.jacrev(function)(x)

    if jnp.isscalar(x):
        x = validate_float(x, "x")
        return get_grad(x)
    x = validate_1d(x)
    if jit:
        return _derivative_impl(function, x).T
    return jax.vmap(get_grad, in_axes=(0,))(x).T


@partial(jax.jit, static_argnums=(0,))
def _derivative_impl(function, x):
    return jax.vmap(lambda xi: jax.jacrev(function)(xi), in_axes=(0,))(x)


@partial(jax.jit, static_argnums=(0,))
def _gradient_impl(function, x, *args):
    def get_grad(xi, *a):
        return jax.jacrev(function)(xi[None, :], *a)

    in_axes = (0,) * (len(args) + 1)
    return jax.vmap(get_grad, in_axes=in_axes)(x, *args)


def gradient(function, x, *args, jit=True):
    """Per-row gradient of a row-wise scalar function
    (parity: ``mellon/derivatives.py:48-80``).

    With ``jit=True`` (default) the vmapped core is a cached program keyed
    on ``function`` — bound methods key per predictor instance, so repeated
    calls reuse one executable, but each distinct predictor stays pinned in
    the jit cache for the process lifetime.  Pass ``jit=False`` for
    throwaway predictors (e.g. bootstrap loops) to avoid that retention."""
    x = jnp.atleast_2d(x)
    impl = _gradient_impl if jit else _gradient_impl.__wrapped__
    gradients = impl(function, x, *args)
    if len(gradients.shape) <= 4:
        return gradients.reshape(x.shape)
    return gradients.reshape(gradients.shape[::2])


@partial(jax.jit, static_argnums=(0,))
def _hessian_impl(function, x, *args):
    def get_hess(xi, *a):
        return jax.jacfwd(jax.jacrev(function))(xi[None, :], *a)

    in_axes = (0,) * (len(args) + 1)
    return jax.vmap(get_hess, in_axes=in_axes)(x, *args)


def hessian(function, x, *args, jit=True):
    """Per-row Hessian (parity: ``mellon/derivatives.py:83-117``)."""
    x = jnp.atleast_2d(x)
    out_shape = x.shape + x.shape[1:]
    impl = _hessian_impl if jit else _hessian_impl.__wrapped__
    hessians = impl(function, x, *args)
    if len(hessians.shape) <= 6:
        return hessians.reshape(out_shape)
    return hessians.reshape(hessians.shape[::2])


@partial(jax.jit, static_argnums=(0,))
def _hessian_log_det_impl(function, x, *args):
    d = x.shape[1]

    def get_log_det(xi, *a):
        hess = jax.jacfwd(jax.jacrev(function))(xi[None, :], *a).reshape((d, d))
        sign, log_det = jnp.linalg.slogdet(hess)
        return sign, log_det

    in_axes = (0,) * (len(args) + 1)
    return jax.vmap(get_log_det, in_axes=in_axes)(x, *args)


def hessian_log_determinant(function, x, *args, jit=True):
    """Per-row sign and log|det| of the Hessian
    (parity: ``mellon/derivatives.py:120-155``)."""
    x = jnp.atleast_2d(x)
    impl = _hessian_log_det_impl if jit else _hessian_log_det_impl.__wrapped__
    return impl(function, x, *args)
