"""On-device nearest neighbors and local fractal dimension.

Replaces the reference's host-side dependencies: pynndescent (approximate
kNN, ``mellon/parameters.py:352-433``) and sklearn BallTree/KDTree
(``mellon/util.py:486-536``).  Device design: the pairwise-distance tile
is one matmul per (block x n) strip, reduced with ``lax.approx_min_k``
(XLA lowers it to an exact top-k on the GPU and the CPU) into a
candidate set that is re-ranked with cancellation-free coordinate
distances.  Deterministic; >=99.9% of 1-NN distances match
coordinate-exact to 1e-4 relative (the reference's pynndescent is itself
approximate).  Memory stays bounded by processing queries in row blocks
with ``lax.scan``.
"""

import logging
from functools import partial

import jax
import jax.numpy as jnp

from ..utils.util import distance

logger = logging.getLogger("mellon_tpu")

DEFAULT_BATCH_SIZE = 1024

# feature-count bound for exact (coordinate-difference) candidate
# selection in _knn_blocked; above it the matmul form + exact re-rank is
# used (see the f32 notes in _knn_blocked)
EXACT_CAND_DIM_MAX = 16
# database rows per distance strip; bounds the (batch x cols) intermediate
# to batch*cols*4 bytes (4 GB at the default batch) before streaming kicks in
DEFAULT_COL_BLOCK = 1 << 20


def _cross_term_precision(dtype):
    """Dot algorithm of the matmul-form candidate distances: three bf16
    products for f32 operands, full precision for any other dtype (the
    bf16 split would round f64 operands to f32)."""
    if dtype == jnp.float32:
        return jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3
    return jax.lax.Precision.HIGHEST


@partial(jax.jit, static_argnames=("k", "batch_size", "col_block"))
def _knn_blocked(query, x, k, batch_size, col_block=DEFAULT_COL_BLOCK):
    """Top-k smallest distances from each query row to all of x.

    Returns (distances (nq, k), indices (nq, k)), sorted ascending.

    Design: squared matmul-form distances (the sqrt is monotone — deferred
    to the re-rank), candidate selection with ``lax.approx_min_k`` (a
    partial-reduction top-k where the backend has one; exact on the GPU
    and the CPU), and one plain scan over query blocks.

    f32 note: the matmul form ``|x|² - 2xy + |y|²`` suffers catastrophic
    cancellation for small distances (error ~ eps·|x|², which dwarfs a tiny
    true distance and would corrupt the log-distance heuristics downstream).
    It is therefore only used to select >=2k candidates; the candidate
    distances are recomputed exactly from coordinate differences and
    re-ranked.

    Low-dimension refinement (round 5): on DENSE low-d data even the
    candidate SELECTION fails under the matmul form — the absolute noise
    eps·|x|² can exceed the squared 1-NN distance itself, so approx_min_k
    picks ~random members of a large near-ball and the exact re-rank then
    overestimates the 1-NN distance (measured at the 98k d=2 time-series
    shape: the geometric-mean NN distance inflated ls by 35% vs f64 and
    held the fidelity cert at corr 0.911).  For ``dim <=
    EXACT_CAND_DIM_MAX`` the candidate distances are therefore computed
    from coordinate differences directly (cancellation-free, relative-
    accurate at any scale): at low d the elementwise form costs ~3d flops
    per pair vs 2d for the matmul, and a d<=16 contraction leaves a matrix
    unit mostly idle anyway.
    """
    nq = query.shape[0]
    n = x.shape[0]
    dim = x.shape[1]
    exact_cand = dim <= EXACT_CAND_DIM_MAX
    # candidate margin + recall target (100k clustered cells, 50 dims):
    # n_cand=32 @ recall_target=0.99 leaves 99.9% of 1-NN distances within
    # 1e-4 relative of coordinate-exact where approx_min_k is approximate;
    # where it lowers exactly, recall can only be higher
    n_cand = min(max(2 * k + 4, 32), n)
    n_blocks = -(-nq // batch_size)
    pad = n_blocks * batch_size - nq
    # Pad with the first row; padded results are sliced off below.
    query_padded = jnp.concatenate(
        [query, jnp.broadcast_to(query[:1], (pad,) + query.shape[1:])], axis=0
    )
    blocks = query_padded.reshape(n_blocks, batch_size, query.shape[1])
    xn = jnp.sum(x * x, axis=1)  # hoisted: one pass over the database

    def sq_dists(qb, xb, xbn):
        if exact_cand:
            # coordinate-difference form, accumulated per dimension so the
            # live temporary stays (batch, cols) instead of
            # (batch, cols, dim)
            d2 = None
            for j in range(xb.shape[1]):
                diff = qb[:, j, None] - xb[None, :, j]
                d2 = diff * diff if d2 is None else d2 + diff * diff
            return d2
        qn = jnp.sum(qb * qb, axis=1, keepdims=True)
        # three bf16 products with f32 accumulation (the split-operand
        # algorithm, ~f32 accurate): one bf16 product puts ~8e-3 RELATIVE
        # noise on the cross term — an absolute error ~0.008·|x|² on the
        # squared distances, which drowned true 1-NN distances on dense
        # data (the 98k d=2 ls inflation).  TF32, what an f32 dot gets on
        # the GPU by default, keeps only 10 mantissa bits and is no better.
        return qn - 2.0 * jnp.matmul(
            qb, xb.T, precision=_cross_term_precision(qb.dtype)
        ) + xbn[None, :]

    def candidates_small(qb):
        _, cand_idx = jax.lax.approx_min_k(
            sq_dists(qb, x, xn), n_cand, recall_target=0.99
        )
        return cand_idx

    def candidates_streamed(qb):
        # column-blocked streaming for beyond-atlas n: one
        # (batch x col_block) strip at a time with a running candidate
        # merge — memory stays O(batch * col_block)
        n_col_blocks = -(-n // col_block)
        n_pad_cols = n_col_blocks * col_block - n
        x_padded = jnp.concatenate(
            [x, jnp.broadcast_to(x[:1], (n_pad_cols,) + x.shape[1:])], axis=0
        ).reshape(n_col_blocks, col_block, x.shape[1])
        xn_padded = jnp.concatenate(
            [xn, jnp.broadcast_to(xn[:1], (n_pad_cols,))]
        ).reshape(n_col_blocks, col_block)

        def col_step(carry, inputs):
            run_d2, run_idx = carry
            xb, xbn, col_offset = inputs
            d2 = sq_dists(qb, xb, xbn)
            valid = (col_offset + jnp.arange(col_block)) < n
            d2 = jnp.where(valid[None, :], d2, jnp.inf)
            vals, local_idx = jax.lax.approx_min_k(
                d2, n_cand, recall_target=0.99
            )
            merged_d2 = jnp.concatenate([run_d2, vals], axis=1)
            merged_idx = jnp.concatenate(
                [run_idx, col_offset + local_idx], axis=1
            )
            neg, pos = jax.lax.top_k(-merged_d2, n_cand)
            new_idx = jnp.take_along_axis(merged_idx, pos, axis=1)
            return (-neg, new_idx), None

        init = (
            jnp.full((qb.shape[0], n_cand), jnp.inf, dtype=x.dtype),
            jnp.zeros((qb.shape[0], n_cand), dtype=jnp.int32),
        )
        offsets = (jnp.arange(n_col_blocks) * col_block).astype(jnp.int32)
        (run_d2, run_idx), _ = jax.lax.scan(
            col_step, init, (x_padded, xn_padded, offsets)
        )
        return run_idx

    def block_topk(carry, qb):
        if n > col_block:
            cand_idx = candidates_streamed(qb)
        else:
            cand_idx = candidates_small(qb)
        # exact recompute from coordinate differences (no cancellation);
        # top_k instead of argsort keeps the lowering small
        nb = x[cand_idx]                                    # (B, n_cand, dim)
        exact = jnp.sqrt(
            jnp.sum(jnp.square(qb[:, None, :] - nb), axis=-1)
        )
        neg_vals, order = jax.lax.top_k(-exact, k)
        idx = jnp.take_along_axis(cand_idx, order, axis=1)
        return carry, (-neg_vals, idx)

    _, (dists, idx) = jax.lax.scan(block_topk, None, blocks)
    dists = dists.reshape(n_blocks * batch_size, k)[:nq]
    idx = idx.reshape(n_blocks * batch_size, k)[:nq]
    return dists, idx


def knn(x, k, query=None, batch_size=DEFAULT_BATCH_SIZE, col_block=DEFAULT_COL_BLOCK):
    """k nearest neighbors by blocked matmul sweep.

    Deterministic.  Candidate selection uses ``lax.approx_min_k``, which
    lowers to an exact top-k on the GPU and the CPU; the contract is
    >=99.9% of 1-NN distances within 1e-4 relative of coordinate-exact
    (see module docstring) — the reference's pynndescent search is
    itself approximate.

    Parameters
    ----------
    x : (n, d) array — the database points.
    k : int — number of neighbors to return.
    query : (nq, d) array, optional — defaults to ``x``; when querying the
        database itself the self-neighbor (distance ~0) is *included*, like
        the reference's ``tree.query(x, k)``.
    batch_size : int — query rows per distance tile.

    Returns
    -------
    (distances, indices) of shape (nq, k), ascending by distance.
    """
    x = jnp.atleast_2d(x)
    if query is None:
        query = x
    else:
        query = jnp.atleast_2d(query)
    k = int(k)
    if k > x.shape[0]:
        raise ValueError(
            f"k={k} must not exceed the number of database points {x.shape[0]}."
        )
    return _knn_blocked(
        query, x, k, int(min(batch_size, query.shape[0])), int(col_block)
    )


def knn_distances(x, k, batch_size=DEFAULT_BATCH_SIZE, method="auto"):
    """Distances to the k nearest *other* points for every point of x.

    Device replacement for ``mellon/parameters.py:352-404`` (pynndescent):
    blocked matmul search by default (``method='exact'`` forces it, naming
    the non-IVF path — see :func:`knn` for its accuracy contract);
    ``method='ivf'`` forces cluster-pruned
    search, which ``'auto'`` only picks on the CPU backend above
    :data:`IVF_THRESHOLD` points.  On the GPU 'auto' always takes the
    dense blocked sweep; that choice has not yet been measured against
    IVF there.
    """
    x = jnp.atleast_2d(x)
    use_ivf = method == "ivf" or (
        method == "auto"
        and x.shape[0] > IVF_THRESHOLD
        and jax.default_backend() == "cpu"
    )
    if use_ivf:
        logger.info(
            "Using cluster-pruned (IVF) kNN for %s points.", f"{x.shape[0]:,}"
        )
        dists, _ = knn_ivf(x, k)
        return dists
    dists, _ = knn(x, k + 1, batch_size=batch_size)
    return dists[:, 1:]


def nn_distances(x, batch_size=DEFAULT_BATCH_SIZE, method="auto"):
    """Distance to the single nearest neighbor of each point
    (replacement for ``mellon/parameters.py:407-433``)."""
    return knn_distances(x, 1, batch_size=batch_size, method=method)[:, 0]


# above this database size, nn_distances on the *CPU backend* switches from
# the blocked O(n²) sweep to cluster-pruned (IVF) search (44x faster at
# ~100% 1-NN recall in CPU tests).  Not auto-selected on the GPU (see
# knn_distances).
IVF_THRESHOLD = 500_000


def knn_ivf(
    x,
    k,
    n_clusters=None,
    n_probe=8,
    batch_size=512,
    seed=0,
):
    """Cluster-pruned approximate k-nearest neighbors (IVF).

    Points are quantized into ``n_clusters`` k-means cells; each query only
    searches the ``n_probe`` nearest cells.  Cuts the exact search's O(n²)
    to ~O(n²·p/c) — the standard accuracy/speed trade the reference also
    makes (pynndescent is approximate, ``mellon/parameters.py:397-404``).
    Distances of the surviving candidates are exact (coordinate
    differences), and the self-neighbor convention matches :func:`knn`.
    """
    import numpy as np

    x = jnp.atleast_2d(x)
    n, dim = x.shape
    if n_clusters is None:
        # fine quantization (~256 points/cell) keeps the padded candidate
        # tables small; probing 8 cells still gives near-perfect 1-NN recall
        n_clusters = max(n // 256, 16)
    n_probe = min(n_probe, n_clusters)

    from .cluster import _assign, k_means

    # coarse quantizer from a subsample
    sub = min(n, 100_000)
    key = jax.random.PRNGKey(seed)
    idx_sub = jax.random.choice(key, n, shape=(sub,), replace=False)
    # random init: for a coarse quantizer with thousands of cells the
    # sequential k-means++ seeding costs more than it buys
    centroids = k_means(
        x[idx_sub], n_clusters, n_iter=10, random_state=seed, init="random"
    )

    assign = _assign(x, centroids, 4096)                     # (n,)
    order = jnp.argsort(assign)
    assign_sorted = assign[order]
    counts = jnp.bincount(assign, length=n_clusters)
    # cap the per-cluster candidate list: unbalanced quantizers (dense
    # blobs) would otherwise blow the padded table and gather sizes; points
    # beyond the cap are truncated from the table (in dense cells the
    # nearest neighbors are abundant, so recall impact is negligible)
    avg = max(n // n_clusters, 1)
    cap = int(min(int(jnp.max(counts)), 8 * avg))
    n_truncated = int(jnp.sum(jnp.maximum(counts - cap, 0)))
    if n_truncated > 0:
        logger.info(
            "IVF table truncates %s points in oversized clusters "
            "(cap %d per cluster).",
            f"{n_truncated:,}",
            cap,
        )
    offsets = jnp.concatenate([jnp.zeros(1, dtype=counts.dtype), jnp.cumsum(counts)[:-1]])
    rank_within = jnp.arange(n) - offsets[assign_sorted]
    keep = rank_within < cap
    # (n_clusters, cap) table of point ids, sentinel n for padding
    ids = jnp.full((n_clusters * cap,), n, dtype=jnp.int32)
    flat_pos = jnp.where(keep, assign_sorted * cap + rank_within, n_clusters * cap)
    ids = jnp.concatenate([ids, jnp.full((1,), n, dtype=jnp.int32)])
    ids = ids.at[flat_pos].set(
        jnp.where(keep, order.astype(jnp.int32), n)
    )[:-1]
    ids = ids.reshape(n_clusters, cap)
    # sentinel row at index n -> +inf distance
    x_padded = jnp.concatenate([x, jnp.full((1, dim), jnp.inf, dtype=x.dtype)])

    n_blocks = -(-n // batch_size)
    pad = n_blocks * batch_size - n
    query_padded = jnp.concatenate(
        [x, jnp.broadcast_to(x[:1], (pad,) + x.shape[1:])], axis=0
    ).reshape(n_blocks, batch_size, dim)

    @partial(jax.jit, static_argnames=("k", "n_probe"))
    def _ivf_search(query_blocks, centroids, ids, x_padded, k, n_probe):
        """All blocks in one program: the table/centroids/points are runtime
        operands (never baked constants)."""

        def block_search(qb):
            dc = distance(qb, centroids)                      # (B, c)
            _, probe = jax.lax.top_k(-dc, n_probe)            # (B, p)

            def probe_step(carry, j):
                run_neg, run_idx = carry
                cand = ids[probe[:, j]]                       # (B, cap)
                pts = x_padded[cand]                          # (B, cap, dim)
                exact = jnp.sqrt(
                    jnp.sum(jnp.square(qb[:, None, :] - pts), axis=-1)
                )
                exact = jnp.where(jnp.isfinite(exact), exact, jnp.inf)
                kk = min(k + 1, exact.shape[1])
                neg_vals, local = jax.lax.top_k(-exact, kk)
                local_ids = jnp.take_along_axis(cand, local, axis=1)
                merged_neg = jnp.concatenate([run_neg, neg_vals], axis=1)
                merged_idx = jnp.concatenate([run_idx, local_ids], axis=1)
                new_neg, pos = jax.lax.top_k(merged_neg, k + 1)
                new_idx = jnp.take_along_axis(merged_idx, pos, axis=1)
                return (new_neg, new_idx), None

            init = (
                jnp.full((qb.shape[0], k + 1), -jnp.inf, dtype=x_padded.dtype),
                # sentinel = the padded inf row, safe for downstream gathers
                jnp.full(
                    (qb.shape[0], k + 1), x_padded.shape[0] - 1, dtype=jnp.int32
                ),
            )
            (neg, idx), _ = jax.lax.scan(probe_step, init, jnp.arange(n_probe))
            return -neg, idx

        return jax.lax.map(block_search, query_blocks)

    dists, idx = _ivf_search(
        query_padded, centroids, ids, x_padded, int(k), int(n_probe)
    )
    dists = dists.reshape(n_blocks * batch_size, k + 1)[:n]
    idx = idx.reshape(n_blocks * batch_size, k + 1)[:n]
    # drop the self column (distance ~0, first after sort)
    return dists[:, 1:], idx[:, 1:]


def local_dimensionality(x, k=30, x_query=None, neighbor_idx=None):
    """Local fractal dimension via a log-log regression over neighborhood
    pairwise distances.

    Behavioural parity: ``mellon/util.py:486-536``; the BallTree/KDTree
    search is replaced by the blocked device kNN (:func:`knn`) and the per-query
    ``lstsq`` by a closed-form simple-regression slope (identical result).
    """
    x = jnp.atleast_2d(x)
    if k > x.shape[0]:
        logger.warning(
            f"Number of nearest neighbors (k={k}) is greater than the "
            f"number of samples ({x.shape[0]}). Setting k to the number of samples."
        )
        k = x.shape[0]
    if neighbor_idx is None:
        if x_query is None:
            x_query = x
        _, idx = knn(x, k, query=x_query)
        neighbors = x[idx]
    else:
        x_query = x if x_query is None else x_query
        neighbors = x[neighbor_idx]

    i, j = jnp.triu_indices(k, k=1)
    neighbor_distances = jnp.linalg.norm(
        neighbors[..., i, :] - neighbors[..., j, :], axis=-1
    )
    neighborhood_distances = jnp.sort(neighbor_distances, axis=-1)

    kc2 = k * (k - 1) // 2
    a = jnp.log(neighborhood_distances)  # (nq, kc2)
    y = jnp.log(jnp.arange(1, kc2 + 1, dtype=a.dtype))  # (kc2,)

    # slope of y on a with intercept, per query point (closed-form lstsq)
    a_mean = a.mean(axis=-1, keepdims=True)
    y_mean = y.mean()
    cov = jnp.sum((a - a_mean) * (y - y_mean), axis=-1)
    var = jnp.sum(jnp.square(a - a_mean), axis=-1)
    return cov / var
