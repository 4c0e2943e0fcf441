"""Sharded model construction: cell-sharded log-prob and chain-sharded MCMC.

NEW capability relative to the reference (single-device only).  The central
object is the cell-sharded loss: the n per-cell likelihood terms and the
rows of the n×m matrix L are distributed over the ``cells`` mesh axis while
the m-dimensional latent z stays replicated; the log-likelihood sum over
cells lowers to an ``all-reduce`` under GSPMD.  This is the design
SURVEY.md §2.4/§5.7 calls for ("cells axis → psum"; rows of L sharded;
m×m landmark algebra replicated).
"""

import logging

import jax
import jax.numpy as jnp

from ..inference.likelihoods import nearest_neighbors_likelihood, normal_prior
from .mesh import CELL_AXIS, cell_sharding, chain_sharding, replicated

logger = logging.getLogger("mellon_tpu")


def shard_density_model(nn_distances, d, mu, L, mesh):
    """Place the density-model operands on the mesh and return a sharded
    loss function.

    Parameters
    ----------
    nn_distances : (n,) observed 1-NN distances — sharded over cells.
    d : scalar intrinsic dimensionality.
    mu : scalar GP mean.
    L : (n, m) transformation matrix — row-sharded over cells.
    mesh : a Mesh with a ``cells`` axis.

    Returns
    -------
    (loss_func, sharded_operands): ``loss_func(z)`` is pure and jit-able; the
    per-cell work partitions across devices and the likelihood sum becomes an
    all-reduce.
    """
    nn_sharded = jax.device_put(nn_distances, cell_sharding(mesh, ndim=1))
    L_sharded = jax.device_put(L, cell_sharding(mesh, ndim=2))

    k = L.shape[1]
    prior = normal_prior(k)
    likelihood = nearest_neighbors_likelihood(nn_sharded, d)

    def loss_func(z):
        f = L_sharded @ z + mu
        return -(prior(z) + likelihood(f))

    return loss_func, (nn_sharded, L_sharded)


def sharded_loss_from_estimator(estimator, mesh):
    """Build the cell-sharded loss for a prepared DensityEstimator."""
    if estimator.L is None or estimator.nn_distances is None:
        raise ValueError(
            "Estimator not prepared. Call prepare_inference(x) first."
        )
    loss, _ = shard_density_model(
        estimator.nn_distances, estimator.d, estimator.mu, estimator.L, mesh
    )
    return loss


def shard_chains(mesh, z0):
    """Place multi-chain initial positions on the chain axis of the mesh."""
    return jax.device_put(z0, chain_sharding(mesh))


def replicate(mesh, x):
    return jax.device_put(x, replicated(mesh))


def shard_predict(predictor, mesh):
    """Shard predictor evaluation over the ``cells`` mesh axis.

    Returns ``predict_fn(Xnew, **kwargs)`` that places the query points on
    the cells axis and evaluates the (replicated, small) predictor state
    against them — each device computes its row block of the
    ``k(Xnew_shard, landmarks) @ weights`` product, so atlas-scale
    out-of-sample evaluation scales linearly with the mesh without any
    host-side chunking.  ``Xnew.shape[0]`` should be divisible by the
    cells-axis size (pad the tail block otherwise).

    NEW capability relative to the reference (single-device only); the
    single-chip analogue is the predictor's internal chunked evaluation.
    """
    base = getattr(predictor, "landmarks", None)
    if base is None:
        base = predictor.x  # full conditional: condition on all points
    landmarks = jnp.asarray(base)
    weights = jnp.asarray(predictor.weights)
    mu = predictor.mu
    cov_func = predictor.cov_func
    landmarks = jax.device_put(landmarks, replicated(mesh))
    weights = jax.device_put(weights, replicated(mesh))

    @jax.jit
    def _eval(Xnew):
        Kus = cov_func(Xnew, landmarks)
        return mu + jnp.matmul(
            Kus, weights, precision=jax.lax.Precision.HIGHEST
        )

    def predict_fn(Xnew, normalize=False):
        Xnew = jax.device_put(
            jnp.asarray(Xnew), cell_sharding(mesh, ndim=jnp.ndim(Xnew))
        )
        out = _eval(Xnew)
        if normalize:
            out = out - jnp.log(predictor.n_obs)
        return out

    return predict_fn
