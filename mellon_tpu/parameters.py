"""Parameter selection heuristics ("auto-config").

Behavioural parity target: ``mellon/parameters.py`` (969 LoC) and
``mellon/compute_ls_time.py``.  All host-side dependencies of the reference
are replaced by on-device equivalents:

* sklearn k-means           -> :func:`mellon_tpu.ops.cluster.k_means`
* pynndescent approx. kNN   -> exact blocked kNN (:mod:`mellon_tpu.ops.neighbors`)
* sklearn Ridge warm start  -> :func:`mellon_tpu.ops.linalg.ridge_solve`

The gp-type / n_landmarks / rank decision tables are kept semantically
identical (``mellon/parameters.py:88-240``) — the reference test-suite treats
them as contracts.
"""

import logging

import numpy as np

import jax
import jax.numpy as jnp

from .ops.cluster import k_means
from .ops.linalg import (
    DEFAULT_RANK,
    DEFAULT_SIGMA,
    _full_decomposition_low_rank,
    _full_rank,
    _modified_low_rank,
    _standard_low_rank,
    ridge_solve,
)
from .ops.neighbors import (
    knn_distances as _knn_distances,
    local_dimensionality,
    nn_distances as _nn_distances,
)
from .utils.parameter_validation import (
    validate_normalize_parameter,
    validate_params,
)
from .utils.util import (
    DEFAULT_JITTER,
    GaussianProcessType,
    ensure_2d,
    mle,
)
from .utils.validation import (
    validate_array,
    validate_float_or_int,
    validate_float_or_iterable_numerical,
    validate_k,
    validate_positive_float,
    validate_positive_int,
    validate_time_x,
)

DEFAULT_N_LANDMARKS = 5000
DEFAULT_RANDOM_SEED = 42

logger = logging.getLogger("mellon_tpu")


def compute_rank(gp_type):
    """Default rank from the GP type (parity: ``mellon/parameters.py:88-115``)."""
    if gp_type is None:
        return 1.0
    if gp_type in (
        GaussianProcessType.FULL_NYSTROEM,
        GaussianProcessType.SPARSE_NYSTROEM,
    ):
        return DEFAULT_RANK
    return 1.0


def compute_n_landmarks(gp_type, n_samples, landmarks):
    """Default number of landmarks (parity: ``mellon/parameters.py:118-172``)."""
    if landmarks is not None:
        return landmarks.shape[0]
    if gp_type is None or gp_type == GaussianProcessType.FIXED:
        return min(n_samples, DEFAULT_N_LANDMARKS)
    if gp_type in (GaussianProcessType.FULL, GaussianProcessType.FULL_NYSTROEM):
        return n_samples
    if gp_type in (
        GaussianProcessType.SPARSE_CHOLESKY,
        GaussianProcessType.SPARSE_NYSTROEM,
    ):
        if n_samples <= DEFAULT_N_LANDMARKS:
            logger.warning(
                f"Gaussian Process type {gp_type} and default "
                f"number of landmarks {DEFAULT_N_LANDMARKS:,} < "
                f"number of cells {n_samples:,}. Reduce n_landmarks below "
                f"the number of cells to use {gp_type}."
            )
        return DEFAULT_N_LANDMARKS
    n_landmarks = min(n_samples, DEFAULT_N_LANDMARKS)
    logger.warning(
        f"Unknown Gaussian Process type {gp_type}, using default "
        f"n_landmarks={n_landmarks:,}."
    )
    return n_landmarks


def compute_gp_type(n_landmarks, rank, n_samples):
    """GP-type inference from landmarks/rank/samples
    (parity: ``mellon/parameters.py:175-240``)."""
    rank = validate_float_or_int(rank, "rank", optional=True)
    n_landmarks = validate_positive_int(n_landmarks, "n_landmarks")
    n_samples = validate_positive_int(n_samples, "n_samples")

    if n_landmarks == 0 or n_landmarks >= n_samples:
        if (
            rank is None
            or isinstance(rank, int)
            and (rank >= n_samples)
            or isinstance(rank, float)
            and rank >= 1.0
            or rank == 0
        ):
            logger.info(
                "Using non-sparse Gaussian Process since n_landmarks "
                f"({n_landmarks:,}) >= n_samples ({n_samples:,}) and rank = {rank}."
            )
            return GaussianProcessType.FULL
        logger.info(
            "Using full Gaussian Process with Nyström rank reduction since "
            f"n_landmarks ({n_landmarks:,}) >= n_samples ({n_samples:,}) "
            f"and rank = {rank}."
        )
        return GaussianProcessType.FULL_NYSTROEM
    if (
        rank is None
        or isinstance(rank, int)
        and (rank >= n_landmarks)
        or isinstance(rank, float)
        and rank >= 1.0
        or rank == 0
    ):
        logger.info(
            "Using sparse Gaussian Process since n_landmarks "
            f"({n_landmarks:,}) < n_samples ({n_samples:,}) and rank = {rank}."
        )
        return GaussianProcessType.SPARSE_CHOLESKY
    logger.info(
        "Using sparse Gaussian Process with improved Nyström rank reduction "
        f"since n_landmarks ({n_landmarks:,}) < n_samples ({n_samples:,}) "
        f"and rank = {rank}."
    )
    return GaussianProcessType.SPARSE_NYSTROEM


# above this cell count, k-means runs on a uniform subsample (the reference
# only *advises* this at n>1e6, ``mellon/base_model.py:227-233``; here it is
# automatic so atlas-scale fits stay tractable)
KMEANS_SUBSAMPLE_THRESHOLD = 200_000


def compute_landmarks(
    x, gp_type=None, n_landmarks=DEFAULT_N_LANDMARKS, random_state=DEFAULT_RANDOM_SEED
):
    """Landmarks as seeded on-device k-means centroids
    (parity: ``mellon/parameters.py:243-291``; sklearn replaced by
    :func:`mellon_tpu.ops.cluster.k_means`)."""
    if n_landmarks == 0:
        return None
    n = x.shape[0]
    x = ensure_2d(x)
    if n_landmarks <= 1:
        raise ValueError(
            f"n_landmarks must be 0 (disabled) or greater than 1, got "
            f"{n_landmarks}."
        )
    if n_landmarks >= n:
        if gp_type == GaussianProcessType.FIXED:
            logger.info(
                f"Gaussian process type is {gp_type} and "
                f"n_landmarks={n_landmarks:,} requested while only {n:,} "
                f"datapoints are available. Using all {n:,} datapoints as "
                "landmarks."
            )
            return x
        return None
    x_fit = x
    if n > max(KMEANS_SUBSAMPLE_THRESHOLD, 20 * n_landmarks):
        n_sub = max(KMEANS_SUBSAMPLE_THRESHOLD, 20 * n_landmarks)
        key = jax.random.PRNGKey(
            random_state if random_state is not None else DEFAULT_RANDOM_SEED
        )
        idx = jax.random.choice(key, n, shape=(n_sub,), replace=False)
        x_fit = x[idx]
        logger.info(
            f"Running k-means on a uniform subsample of {n_sub:,} of "
            f"{n:,} cells (quantization quality is insensitive to this)."
        )
    logger.info(
        f"Computing {n_landmarks:,} landmarks with k-means clustering "
        f"(random_state={random_state})."
    )
    return k_means(x_fit, n_landmarks, random_state=random_state)


def compute_landmarks_rescale_time(
    x,
    ls,
    ls_time,
    times=None,
    n_landmarks=DEFAULT_N_LANDMARKS,
    random_state=DEFAULT_RANDOM_SEED,
):
    """Landmarks in time-rescaled space
    (parity: ``mellon/parameters.py:294-349``)."""
    if n_landmarks == 0:
        return None
    ls = validate_positive_float(ls, "ls")
    ls_time = validate_positive_float(ls_time, "ls_time")
    x = validate_time_x(x, times)
    time_factor = ls / ls_time
    x = x.at[:, -1].set(x[:, -1] * time_factor)
    landmarks = compute_landmarks(
        x, n_landmarks=n_landmarks, random_state=random_state
    )
    if landmarks is not None:
        landmarks = landmarks.at[:, -1].set(landmarks[:, -1] / time_factor)
    return landmarks


def compute_distances(x, k, seed=DEFAULT_RANDOM_SEED):
    """Distances to the k nearest neighbors (self excluded), on device
    (parity: ``mellon/parameters.py:352-404``; pynndescent replaced — the
    seed is accepted for API parity but the exact search is deterministic)."""
    x = validate_array(x, "x")
    x = ensure_2d(x)
    n_samples = x.shape[0]
    if n_samples == 0:
        message = "Input data x is empty."
        logger.error(message)
        raise ValueError(message)
    validate_k(k, n_samples)
    return _knn_distances(x, k)


def compute_nn_distances(x, seed=DEFAULT_RANDOM_SEED):
    """Distance to the nearest neighbor of each instance, on device
    (parity: ``mellon/parameters.py:407-433``)."""
    return compute_distances(x, 1, seed=seed)[:, 0]


def _get_target_cell_count(normalize, time, av_cells_per_tp, unique_times):
    if isinstance(normalize, bool):
        return av_cells_per_tp
    if isinstance(normalize, dict):
        return normalize[time.item()]
    return normalize[unique_times.tolist().index(time)]


# above this many distinct time points the single-search formulation falls
# back to per-group searches (kept as a safety valve; with the round-5
# single-column augmentation the single search no longer scales with T)
MAX_ONEHOT_TIME_GROUPS = 64


def within_time_augmented(states, group, n_times):
    """Single-search formulation of within-group kNN (device-first redesign of
    the reference's per-time-point loop, ``mellon/parameters.py:444-531``):
    append ONE scaled group column ``C * group`` with C² larger than any
    within-group squared distance.  Within a group the column subtracts to
    exactly 0 (identical floats), so within-group distances are
    bit-identical to a per-group search; across groups the difference is
    at least C, excluding the pair.  One blocked kNN program over all n
    cells replaces T ragged-shaped searches (T program loads).

    Round-5 redesign: the earlier one-hot form existed to keep the MATMUL
    candidate selection's norm inflation constant across groups, but any
    BIG offset puts eps·BIG absolute noise on the matmul-form squared
    distances — which exceeded the true squared 1-NN distances on the
    dense 98k d=2 shape and inflated the ls heuristic 35% vs f64.  The
    augmented dimension is now d+1 ≤ EXACT_CAND_DIM_MAX for typical
    state spaces, so ``_knn_blocked`` selects candidates from exact
    coordinate-difference distances where the scaled column is
    cancellation-free by construction.  High-dimensional states (d+1 >
    EXACT_CAND_DIM_MAX) keep the one-hot form: there the search runs in
    matmul form, where the one-hot's CONSTANT norm inflation is what
    keeps the noise uniform across groups (a single group·C column's
    norm would grow with the group index).  Shared by the eager search
    below and the fused time prepare (``models/fused.py``)."""
    from .ops.neighbors import EXACT_CAND_DIM_MAX

    span2 = jnp.sum(jnp.square(jnp.max(states, axis=0) - jnp.min(states, axis=0)))
    if states.shape[1] + 1 <= EXACT_CAND_DIM_MAX:
        offset = 4.0 * jnp.sqrt(jnp.maximum(span2, 1.0))
        col = offset * group.astype(states.dtype)
        return jnp.concatenate([states, col[:, None]], axis=1)
    big = 16.0 * jnp.maximum(span2, 1.0)
    onehot = jax.nn.one_hot(group, n_times, dtype=states.dtype)
    return jnp.concatenate([states, jnp.sqrt(big / 2.0) * onehot], axis=1)


def compute_nn_distances_within_time_points(x, times=None, d=None, normalize=False):
    """1-NN distances within each time-point group, with optional
    sampling-bias normalization (parity: ``mellon/parameters.py:444-531``)."""
    x = validate_time_x(x, times)
    unique_times = jnp.unique(x[:, -1])
    n_cells = x.shape[0]
    av_cells_per_tp = n_cells / len(unique_times)

    validate_normalize_parameter(normalize, unique_times)

    if normalize is not False and normalize is not None:
        d = validate_float_or_iterable_numerical(d, "d", optional=False, positive=True)
        if jnp.ndim(d) > 0 and len(d) != x.shape[0]:
            ld = len(d)
            raise ValueError(
                f"If `d` (length={ld:,}) is a vector then it needs to have "
                f"one value per cell in x (x.shape[0]={n_cells:,})."
            )
        logger.info(
            "Normalizing nearest neighbor distances correcting sampling bias "
            f"for {len(unique_times):,} different time points."
        )

    states = x[:, :-1]
    group = jnp.searchsorted(unique_times, x[:, -1])
    n_times = len(unique_times)
    counts = jnp.bincount(group, length=n_times)
    for i, count in enumerate(np.asarray(counts)):
        if count < 2:
            time = unique_times[i]
            raise ValueError(
                f"Insufficient data: Only {int(count)} sample(s) found at "
                f"time point {time}. Nearest neighbors cannot be computed "
                "with less than two samples per time point. Please confirm if "
                "you have provided the correct time axis. If the time points "
                "indeed have very few samples, consider aggregating nearby "
                "time points for better results, or you may specify "
                "`nn_distances` manually."
            )

    if n_times <= MAX_ONEHOT_TIME_GROUPS:
        nn_distances = compute_nn_distances(
            within_time_augmented(states, group, n_times)
        )
    else:
        # very many time points: the one-hot columns would dominate the
        # matmul cost, so fall back to per-group searches
        nn_distances = jnp.zeros(x.shape[0], dtype=states.dtype)
        for i, time in enumerate(unique_times):
            mask = x[:, -1] == time
            nn_at_time = compute_nn_distances(states[mask])
            nn_distances = nn_distances.at[mask].set(nn_at_time)

    if normalize is not False and normalize is not None:
        targets = jnp.asarray(
            [
                _get_target_cell_count(normalize, time, av_cells_per_tp, unique_times)
                for time in unique_times
            ],
            dtype=nn_distances.dtype,
        )
        n_samples = counts[group].astype(nn_distances.dtype)
        factor = (n_samples / targets[group]) ** (1 / d)
        nn_distances = factor * nn_distances

    return nn_distances


def compute_d(x):
    """Embedding dimensionality (parity: ``mellon/parameters.py:534-542``)."""
    if len(x.shape) < 2:
        return 1
    return x.shape[1]


def compute_d_factal(x, k=10, n=500, seed=432):
    """Average local fractal dimension on a random subsample
    (parity: ``mellon/parameters.py:545-583``)."""
    if len(x.shape) < 2:
        return 1
    if n < x.shape[0]:
        key = jax.random.PRNGKey(seed)
        idx = jax.random.choice(key, x.shape[0], shape=(n,), replace=False)
        x_query = x[idx, ...]
    else:
        x_query = x
    local_dims = local_dimensionality(x, k=k, x_query=x_query)
    return float(local_dims.mean())


@jax.jit
def _mu_kernel(nn_distances, d):
    return jnp.quantile(mle(nn_distances, d), 0.01) - 10


@jax.jit
def _ls_kernel(nn_distances):
    return jnp.exp(jnp.log(nn_distances).mean() + 3.0)


def compute_mu(nn_distances, d):
    """1st percentile of the NN MLE minus 10
    (parity: ``mellon/parameters.py:586-599``).  One fused jit call — eager
    op-by-op dispatch is expensive on remote-compiled backends."""
    return float(_mu_kernel(nn_distances, d))


def compute_ls(nn_distances):
    """Geometric-mean NN distance times e³
    (parity: ``mellon/parameters.py:602-613``)."""
    return float(_ls_kernel(nn_distances))


def compute_cov_func(cov_func_curry, ls, ls_time=None):
    """Kernel from curry and length scales; space×time product kernel when
    ls_time is given (parity: ``mellon/parameters.py:616-645``)."""
    if ls_time is not None:
        return cov_func_curry(ls=ls, active_dims=slice(None, -1)) * cov_func_curry(
            ls=ls_time, active_dims=-1
        )
    return cov_func_curry(ls=ls)


def compute_Lp(
    x,
    cov_func,
    gp_type=None,
    landmarks=None,
    sigma=DEFAULT_SIGMA,
    jitter=DEFAULT_JITTER,
):
    """Landmark (or full) covariance Cholesky Lp
    (parity: ``mellon/parameters.py:648-714``)."""
    x = ensure_2d(x)
    n_samples = x.shape[0]
    if landmarks is None:
        n_landmarks = n_samples
        landmarks = x
    else:
        landmarks = ensure_2d(landmarks)
        n_landmarks = landmarks.shape[0]
    gp_type = GaussianProcessType.from_string(gp_type, optional=True)
    if gp_type is None:
        gp_type = compute_gp_type(n_landmarks, 1.0, n_samples)

    if gp_type in (
        GaussianProcessType.FULL_NYSTROEM,
        GaussianProcessType.SPARSE_NYSTROEM,
    ):
        return None
    if gp_type == GaussianProcessType.FULL:
        logger.info("Computing Lp.")
        return _full_rank(x, cov_func, sigma=sigma, jitter=jitter)
    if gp_type in (
        GaussianProcessType.SPARSE_CHOLESKY,
        GaussianProcessType.FIXED,
    ):
        return _full_rank(landmarks, cov_func, sigma=sigma, jitter=jitter)
    message = f"Unknown Gaussian Process type {gp_type}."
    logger.error(message)
    raise ValueError(message)


def validate_compute_L_input(x, cov_func, gp_type, landmarks, Lp, rank, sigma, jitter):
    """Parity: ``mellon/parameters.py:717-780``."""
    jitter = validate_positive_float(jitter, "jitter")
    rank = validate_float_or_int(rank, "rank", optional=True)

    n_samples = x.shape[0]
    n_landmarks = n_samples if landmarks is None else landmarks.shape[0]
    gp_type = GaussianProcessType.from_string(gp_type, optional=True)
    if rank is None:
        rank = compute_rank(gp_type)
    if gp_type is None:
        gp_type = compute_gp_type(n_landmarks, rank, n_samples)
    validate_params(rank, gp_type, n_samples, n_landmarks, landmarks)

    if (
        gp_type == GaussianProcessType.FULL
        and Lp is not None
        and Lp.shape != (n_samples, n_samples)
    ):
        message = (
            f" Wrong shape of Lp {Lp.shape} for {gp_type} and "
            f"{n_samples:,} samples."
        )
        logger.error(message)
        raise ValueError(message)
    elif (
        gp_type
        in (GaussianProcessType.SPARSE_CHOLESKY, GaussianProcessType.FIXED)
        and Lp is not None
        and Lp.shape != (n_landmarks, n_landmarks)
    ):
        message = (
            f" Wrong shape of Lp {Lp.shape} for {gp_type} and "
            f"{n_landmarks:,} landmarks."
        )
        logger.error(message)
        raise ValueError(message)

    x = ensure_2d(x)
    if landmarks is not None:
        landmarks = ensure_2d(landmarks)
    return x, landmarks, n_landmarks, n_samples, gp_type, rank


def compute_L(
    x,
    cov_func,
    gp_type=None,
    landmarks=None,
    Lp=None,
    rank=None,
    sigma=DEFAULT_SIGMA,
    jitter=DEFAULT_JITTER,
):
    """Transformation matrix L with L Lᵀ ≈ K, strategy dispatched on the GP
    type (parity: ``mellon/parameters.py:783-874``)."""
    x, landmarks, n_landmarks, n_samples, gp_type, rank = validate_compute_L_input(
        x, cov_func, gp_type, landmarks, Lp, rank, sigma, jitter
    )

    if gp_type == GaussianProcessType.FULL:
        if Lp is None:
            return _full_rank(x, cov_func, sigma=sigma, jitter=jitter)
        return Lp
    if gp_type == GaussianProcessType.FULL_NYSTROEM:
        return _full_decomposition_low_rank(
            x, cov_func, rank=rank, sigma=sigma, jitter=jitter
        )
    if gp_type in (GaussianProcessType.SPARSE_CHOLESKY, GaussianProcessType.FIXED):
        if Lp is None:
            return _standard_low_rank(x, cov_func, landmarks, sigma=sigma, jitter=jitter)
        return _standard_low_rank(
            x, cov_func, landmarks, Lp=Lp, sigma=sigma, jitter=jitter
        )
    if gp_type == GaussianProcessType.SPARSE_NYSTROEM:
        return _modified_low_rank(
            x, cov_func, landmarks, rank=rank, sigma=sigma, jitter=jitter
        )


@jax.jit
def _initial_value_kernel(nn_distances, d, mu, L):
    target = mle(nn_distances, d) - mu
    return ridge_solve(L, target, 1.0)


def compute_initial_value(nn_distances, d, mu, L):
    """Ridge warm start z minimizing ||Lz + mu - mle|| + ||z||, on device
    (parity: ``mellon/parameters.py:877-896``; sklearn Ridge replaced by
    :func:`mellon_tpu.ops.linalg.ridge_solve`; one fused program)."""
    return _initial_value_kernel(nn_distances, d, mu, L)


def compute_initial_zeros(x, L):
    return jnp.zeros((x.shape[0], L.shape[1]))


def compute_initial_ones(x, L):
    return jnp.ones(x.shape[0])


def compute_initial_dimensionalities(x, mu_dim, mu_dens, L, nn_distances, d):
    """Stacked Ridge warm starts for (log-dim, log-density)
    (parity: ``mellon/parameters.py:899-924``)."""
    target = jnp.log(d) - mu_dim
    if jnp.asarray(target).size == 1:
        target = jnp.full(L.shape[0], target)
    initial_dims = ridge_solve(L, target, alpha=1.0)
    initial_dens = compute_initial_value(nn_distances, d, mu_dens, L)
    return jnp.stack([initial_dims, initial_dens])


def compute_average_cell_count(x, normalize):
    """Average cells per time point for predictor normalization
    (parity: ``mellon/parameters.py:927-969``)."""
    n_cells = x.shape[0]
    unique_times = jnp.unique(x[:, -1])
    n_unique_times = unique_times.shape[0]

    if normalize is None or isinstance(normalize, bool):
        return n_cells / n_unique_times
    if isinstance(normalize, dict):
        return sum(normalize.values()) / n_unique_times
    if isinstance(normalize, (list, jnp.ndarray)):
        return float(jnp.sum(jnp.asarray(normalize))) / len(normalize)
    raise ValueError(f"Unrecognized type for 'normalize': {type(normalize)}")


def compute_time_derivatives(predictor, x, times=None):
    """Parity: ``mellon/parameters.py:67-71``."""
    if hasattr(predictor, "time_derivative"):
        return predictor.time_derivative(x, times)
    return jnp.zeros(x.shape[0])


def compute_density_gradient(predictor, x, times=None):
    """Parity: ``mellon/parameters.py:74-78``."""
    if hasattr(predictor, "time_derivative"):
        return predictor.gradient(x, times)
    return predictor.gradient(x)


def compute_density_diffusion(predictor, x, times=None):
    """Per-point slogdet of the density Hessian.  The reference computed but
    never returned this value (``mellon/parameters.py:81-85``); returning it
    is the deliberate fix."""
    if hasattr(predictor, "time_derivative"):
        sign, log_det = predictor.hessian_log_determinant(x, times)
    else:
        sign, log_det = predictor.hessian_log_determinant(x)
    return sign, log_det
