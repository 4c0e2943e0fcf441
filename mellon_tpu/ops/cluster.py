"""On-device k-means for landmark selection.

Replaces sklearn's host-side ``k_means`` (``mellon/parameters.py:243-291``).
Device design: Lloyd iterations under ``lax.scan`` with assignment by
blocked distance-argmin (one matmul per block) and centroid update by
``segment_sum`` — fully jittable, deterministic under a seed, and shardable
over the cells axis.
"""

import logging
from functools import partial

import jax
import jax.numpy as jnp


logger = logging.getLogger("mellon_tpu")

DEFAULT_N_ITER = 30
DEFAULT_ASSIGN_BLOCK = 4096


def _assign(x, centroids, block_size):
    """Nearest-centroid index per row of x, computed in row blocks.

    Uses the matmul squared-distance form without the epsilon/sqrt of
    ``utils.util.distance``: only the argmin matters here, and dropping the
    per-row constant |x|² halves the elementwise work."""
    n = x.shape[0]
    n_blocks = -(-n // block_size)
    pad = n_blocks * block_size - n
    xp = jnp.concatenate(
        [x, jnp.broadcast_to(x[:1], (pad,) + x.shape[1:])], axis=0
    ).reshape(n_blocks, block_size, x.shape[1])
    cn = jnp.sum(centroids * centroids, axis=1)

    def block_argmin(xb):
        d = -2.0 * xb @ centroids.T + cn[None, :]
        return jnp.argmin(d, axis=1)

    idx = jax.lax.map(block_argmin, xp).reshape(n_blocks * block_size)[:n]
    return idx


@partial(jax.jit, static_argnames=("k",))
def _kmeanspp_init(x, k, key):
    """Seeded k-means++ seeding: k sequential D²-weighted draws, each one
    distance pass over x (O(n·k·d) total, one ``lax.fori_loop`` on device)."""
    n, d = x.shape
    key, sub = jax.random.split(key)
    first = x[jax.random.randint(sub, (), 0, n)]
    centers = jnp.zeros((k, d), dtype=x.dtype).at[0].set(first)
    d2 = jnp.sum(jnp.square(x - first), axis=1)

    def body(i, state):
        centers, d2, key = state
        key, sub = jax.random.split(key)
        idx = jax.random.categorical(sub, jnp.log(jnp.maximum(d2, 1e-30)))
        c = x[idx]
        centers = centers.at[i].set(c)
        d2 = jnp.minimum(d2, jnp.sum(jnp.square(x - c), axis=1))
        return centers, d2, key

    centers, _, _ = jax.lax.fori_loop(1, k, body, (centers, d2, key))
    return centers


@partial(jax.jit, static_argnames=("k", "n_iter", "block_size"))
def _lloyd(x, init_centroids, k, n_iter, block_size):
    def step(centroids, _):
        idx = _assign(x, centroids, block_size)
        sums = jax.ops.segment_sum(x, idx, num_segments=k)
        counts = jax.ops.segment_sum(
            jnp.ones((x.shape[0],), dtype=x.dtype), idx, num_segments=k
        )
        new_centroids = jnp.where(
            counts[:, None] > 0, sums / jnp.maximum(counts[:, None], 1), centroids
        )
        return new_centroids, None

    centroids, _ = jax.lax.scan(step, init_centroids, None, length=n_iter)
    return centroids


def k_means(
    x,
    k,
    n_iter=DEFAULT_N_ITER,
    random_state=0,
    block_size=DEFAULT_ASSIGN_BLOCK,
    init="k-means++",
):
    """Seeded Lloyd k-means returning the (k, d) centroids.

    ``init="k-means++"`` (default, matching sklearn's default used by the
    reference) seeds with D²-weighted sampling; ``init="random"`` samples k
    distinct points uniformly — cheaper for very large k when a few extra
    Lloyd sweeps are acceptable.
    """
    x = jnp.atleast_2d(x)
    n = x.shape[0]
    if k > n:
        raise ValueError(f"k={k} must not exceed the number of points {n}.")
    key = jax.random.PRNGKey(int(random_state))
    if init == "k-means++":
        init_centroids = _kmeanspp_init(x, int(k), key)
    elif init == "random":
        init_idx = jax.random.choice(key, n, shape=(k,), replace=False)
        init_centroids = x[init_idx]
    else:
        raise ValueError(f"Unknown k-means init method: {init}")
    block = int(min(block_size, n))
    return _lloyd(x, init_centroids, int(k), int(n_iter), block)
