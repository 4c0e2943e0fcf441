"""Diagonal Laplace approximation of posterior standard deviations.

Behavioural parity target: ``mellon/inference.py:291-338``: the Hessian
diagonal of the negative log-posterior at the MAP, extracted with
forward-over-reverse HVPs, clipped at 1e-8, and inverted to standard
deviations.

Memory note: the HVP basis sweep is chunked (``batch_size``) so the k HVPs run
as vmapped groups without materializing a k×k Hessian; each HVP is two
passes over the O(n·m) loss graph.
"""

import logging

import jax
import jax.numpy as jnp

logger = logging.getLogger("mellon_tpu")


from functools import partial


@partial(jax.jit, static_argnames=("loss_func", "chunk"))
def _hvp_diag_chunk(loss_func, z, start, chunk, *loss_args):
    """HVP-diagonal for one contiguous basis chunk; start is a runtime
    operand so every chunk reuses one executable."""
    fun = (lambda p: loss_func(p, *loss_args)) if loss_args else loss_func
    grad_f = jax.grad(fun)
    k = z.size

    def hvp_diag(offset):
        e = jnp.zeros((k,), dtype=z.dtype).at[start + offset].set(1.0).reshape(
            z.shape
        )
        _, hvp = jax.jvp(grad_f, (z,), (e,))
        return jnp.vdot(hvp, e)

    return jax.vmap(hvp_diag)(jnp.arange(chunk))


def hessian_diagonal(loss_func, z, batch_size=512, loss_args=()):
    """Diagonal of the Hessian of loss_func at z via chunked HVPs."""
    k = z.size
    chunk = min(batch_size, k)
    n_chunks = -(-k // chunk)
    parts = []
    for i in range(n_chunks):
        start = i * chunk  # overlap on the last chunk keeps the shape static
        start = min(start, k - chunk)
        parts.append(
            _hvp_diag_chunk(
                loss_func, z, jnp.asarray(start), chunk, *loss_args
            )
        )
    diag = jnp.zeros((k,), dtype=z.dtype)
    for i, part in enumerate(parts):
        start = min(i * chunk, k - chunk)
        diag = diag.at[start : start + chunk].set(part)
    return diag.reshape(z.shape)


def compute_laplace_std(
    loss_func, pre_transformation, jit=False, batch_size=512, loss_args=()
):
    """Posterior std = 1/sqrt(clip(diag Hessian, 1e-8))
    (parity: ``mellon/inference.py:291-338``)."""
    h_diag = hessian_diagonal(
        loss_func, pre_transformation, batch_size=batch_size, loss_args=loss_args
    )
    h_diag = jnp.maximum(h_diag, 1e-8)
    stds = 1.0 / jnp.sqrt(h_diag)
    logger.info(
        "Laplace approximation: Hessian diagonal range [%.3e, %.3e], "
        "std range [%.3e, %.3e].",
        float(jnp.min(h_diag)),
        float(jnp.max(h_diag)),
        float(jnp.min(stds)),
        float(jnp.max(stds)),
    )
    return stds
