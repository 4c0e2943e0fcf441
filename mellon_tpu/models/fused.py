"""Fused one-program preparation for the default sparse fits (all four
estimator families).

The lazy attribute protocol (``_prepare_attribute``, parity with
``mellon/base_model.py:433-446``) computes nn-distances, heuristics,
landmarks, and the landmark Cholesky as separate device programs with a
host synchronization between each — every ``float()``/``bool()`` fetch is a
blocking round trip, and on remote-attached accelerators those round trips
dominate the warm fit.  This module compiles each model's whole default
pipeline

    kNN -> nn repair -> heuristics (mu/ls; local fractal dim for the
    dimensionality model; within-time search + normalization for the
    time-sensitive model) -> (subsample) -> k-means++ -> Lloyd
    -> landmark kernel -> Cholesky attempt (+ in-program pivot selection)

into ONE executable with ONE scalar fetch, and the follow-up factorization
(prune Cholesky + TRSM + ridge warm start) into a second program whose
validity is checked through the optimizer's own loss fetch (optimistic on
the default L-BFGS path).  Every fused prepare produces bit-identical
attributes to the lazy path (same underlying kernels, same PRNG key
discipline) — tested in ``tests/test_fused_prepare.py`` — and is applied
transparently by the estimators' ``prepare_inference``; any customization
(precomputed attributes, fractal d, custom kernels without an operand
spec, non-sparse GP types, computed ls_time) falls back to the lazy path
unchanged.
"""

import logging
from functools import partial

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular

from ..ops.cluster import DEFAULT_ASSIGN_BLOCK, DEFAULT_N_ITER, _kmeanspp_init, _lloyd
from ..ops.kernels import _SPEC_CORES, eval_operand_spec
from ..ops.linalg import PIVOT_REL_TOL, _pivoted_cholesky, ridge_solve
from ..ops.neighbors import DEFAULT_BATCH_SIZE, DEFAULT_COL_BLOCK, _knn_blocked
from ..parameters import KMEANS_SUBSAMPLE_THRESHOLD
from ..utils.util import GaussianProcessType, mle
from ..utils.validation import _nn_repair_impl, report_nn_repair

# pivot-factor width inside the fused programs; ranks at or above this cap
# fall back to the host-side iterative-doubling selection (rare)
FUSED_PIVOT_CAP = 1024


def _cpu_ivf_applies(n):
    """True when the lazy kNN path would auto-select cluster-pruned (IVF)
    search — CPU backend above IVF_THRESHOLD — in which case the fused
    O(n^2) sweep must decline so the lazy path keeps its 44x advantage.
    On the GPU the fused dense sweep runs at every size; it has not yet
    been measured against IVF there."""
    from ..ops.neighbors import IVF_THRESHOLD

    return n > IVF_THRESHOLD and jax.default_backend() == "cpu"


def _landmark_preamble(est, n, k):
    """Shared host-side landmark bookkeeping: the large-n advisory, the
    uniform-subsample decision + log, the k-means log, and the resolved
    random_state.  Byte-identical to the lazy path's messages
    (``compute_landmarks`` / ``BaseEstimator._compute_landmarks``)."""
    random_state = est._landmark_advisory_and_seed(n, k)
    threshold = max(KMEANS_SUBSAMPLE_THRESHOLD, 20 * k)
    n_sub = threshold if n > threshold else None
    if n_sub is not None:
        logger.info(
            f"Running k-means on a uniform subsample of {n_sub:,} of "
            f"{n:,} cells (quantization quality is insensitive to this)."
        )
    logger.info(
        f"Computing {k:,} landmarks with k-means clustering "
        f"(random_state={random_state})."
    )
    return n_sub, random_state


def _chol_attempt_with_pivot(K, jitter):
    """Jittered Cholesky attempt plus — only when it fails (lax.cond) — the
    diagonally-pivoted landmark selection, so the pruning path needs no
    separate program dispatch and host fetch."""
    diag = jnp.arange(K.shape[0])
    # HIGHEST matmul precision, matching _jittered_cholesky: the default
    # reduced-precision product (bf16 or TF32) puts ~1e-3-relative noise
    # on L that cond(Lp) amplifies through the whitening.
    with jax.default_matmul_precision("highest"):
        Lp = jnp.linalg.cholesky(K.at[diag, diag].add(jitter))
    ok = ~jnp.any(jnp.isnan(Lp))
    cap = min(K.shape[0], FUSED_PIVOT_CAP)

    def run_pivot():
        with jax.default_matmul_precision("highest"):
            piv, r, _ = _pivoted_cholesky(K, PIVOT_REL_TOL, cap)
        return piv.astype(jnp.int32), jnp.asarray(r, dtype=jnp.int32)

    def skip_pivot():
        return jnp.zeros((cap,), dtype=jnp.int32), jnp.asarray(0, dtype=jnp.int32)

    piv, r = jax.lax.cond(ok, skip_pivot, run_pivot)
    return Lp, ok, piv, r

logger = logging.getLogger("mellon_tpu")

# escape hatch (and A/B test hook): setting this False forces the lazy
# per-attribute path everywhere
ENABLED = True


@partial(
    jax.jit,
    static_argnames=("spec", "k_landmarks", "d_int", "n_sub", "knn_batch", "assign_block"),
)
def _fused_sparse_prepare_program(
    x, key, jitter, ls_factor, spec, k_landmarks, d_int, n_sub, knn_batch, assign_block
):
    """The fused pipeline; every stage reproduces the corresponding lazy
    computation exactly (same ops, same key usage)."""
    jitter = jnp.asarray(jitter, dtype=x.dtype)
    ls_factor = jnp.asarray(ls_factor, dtype=x.dtype)

    # 1-NN distance, self excluded (== compute_nn_distances)
    dists, _ = _knn_blocked(x, x, 2, knn_batch, DEFAULT_COL_BLOCK)
    nn_raw = dists[:, 1]
    nn, nan_c, inf_c, neg_c, all_bad = _nn_repair_impl(nn_raw)

    # heuristics (== _mu_kernel / _ls_kernel with ls_factor applied)
    mu = jnp.quantile(mle(nn, d_int), 0.01) - 10
    ls = jnp.exp(jnp.log(nn).mean() + 3.0) * ls_factor

    # landmarks (== compute_landmarks: optional uniform subsample, then
    # seeded k-means++/Lloyd; both code paths construct PRNGKey(random_state)
    # independently, so reusing `key` for choice and seeding is identical)
    x_fit = x
    if n_sub is not None:
        idx = jax.random.choice(key, x.shape[0], shape=(n_sub,), replace=False)
        x_fit = x[idx]
    init_centroids = _kmeanspp_init(x_fit, k_landmarks, key)
    xu = _lloyd(x_fit, init_centroids, k_landmarks, DEFAULT_N_ITER, assign_block)

    # landmark kernel + first Cholesky attempt (== _jittered_cholesky)
    K = eval_operand_spec(spec, (ls,), xu, xu)
    Lp, ok, piv, r = _chol_attempt_with_pivot(K, jitter)

    return nn, nan_c, inf_c, neg_c, all_bad, mu, ls, xu, K, Lp, ok, piv, r


@partial(jax.jit, static_argnames=("spec", "d_int"))
def _fused_factorize_program(x, xu, Lp, nn, mu, params, spec, d_int):
    """Stage 2 when the landmark Cholesky succeeded: cross-covariance TRSM
    (== _standard_low_rank_fused_spec) + ridge warm start
    (== _initial_value_kernel) in one executable.  ``params`` is the
    kernel's operand tuple (e.g. ``(ls,)`` or ``(ls, ls_time)``)."""
    C = eval_operand_spec(spec, params, x, xu)
    # HIGHEST-precision TRSM, matching _standard_low_rank_fused_spec (the
    # lazy path) and the chunked route — see _chol_attempt_with_pivot.
    with jax.default_matmul_precision("highest"):
        L = solve_triangular(Lp, C.T, lower=True).T
    z0 = ridge_solve(L, mle(nn, d_int) - mu, 1.0)
    return L, z0


@partial(jax.jit, static_argnames=("spec", "d_int"))
def _fused_prune_factorize_program(K, piv, x, xu, nn, mu, params, jitter, spec, d_int):
    """Stage 2 for the pruning path: gather the selected landmark submatrix,
    factorize with jitter (== safe_cholesky's first attempt), then TRSM +
    ridge warm start — one executable, one validity flag."""
    jitter = jnp.asarray(jitter, dtype=K.dtype)
    K_sub = K[piv][:, piv]
    diag = jnp.arange(K_sub.shape[0])
    # HIGHEST precision for the factorization and TRSM, matching
    # _prune_chol_program / _chunked_prune_factorize (ADVICE r4 #1).
    with jax.default_matmul_precision("highest"):
        Lp = jnp.linalg.cholesky(K_sub.at[diag, diag].add(jitter))
    ok = ~jnp.any(jnp.isnan(Lp))
    xu_sel = xu[piv]
    C = eval_operand_spec(spec, params, x, xu_sel)
    with jax.default_matmul_precision("highest"):
        L = solve_triangular(Lp, C.T, lower=True).T
    z0 = ridge_solve(L, mle(nn, d_int) - mu, 1.0)
    return Lp, xu_sel, L, z0, ok


@jax.jit
def _prune_chol_program(K, piv, jitter):
    """Submatrix Cholesky alone — the first leg of the CHUNKED stage-2
    route for large (n, pruned-m) shapes (see _finish_factorization): the
    single-program TRSM at (98k, 2176) keeps ~8 GB of panel-update temps
    alive, so the TRSM runs row-chunked as separate program calls
    instead."""
    jitter = jnp.asarray(jitter, dtype=K.dtype)
    K_sub = K[piv][:, piv]
    diag = jnp.arange(K_sub.shape[0])
    with jax.default_matmul_precision("highest"):
        Lp = jnp.linalg.cholesky(K_sub.at[diag, diag].add(jitter))
    return Lp, ~jnp.any(jnp.isnan(Lp))


@partial(jax.jit, static_argnames=("d_int",))
def _ridge_warmstart_program(L, nn, mu, d_int):
    """Ridge warm start alone (third leg of the chunked stage-2 route)."""
    return ridge_solve(L, mle(nn, d_int) - mu, 1.0)


def _chunked_prune_factorize(est, K, piv, x, xu, nn, mu, params, spec, d_int):
    """Chunked stage-2 for the pruning path: submatrix Cholesky, then the
    row-chunked TRSM (shared shape-stable executable per chunk), then the
    ridge warm start — same results as _fused_prune_factorize_program in
    three+ program calls with bounded temps."""
    from ..ops.linalg import _chunked_rows, _standard_low_rank_fused_spec

    Lp, ok = _prune_chol_program(K, piv, float(est.jitter))
    xu_sel = xu[piv]
    kernel = partial(_standard_low_rank_fused_spec, spec, params)
    L = _chunked_rows(kernel, x, xu_sel, Lp)
    z0 = _ridge_warmstart_program(L, nn, float(mu), d_int)
    return Lp, xu_sel, L, z0, ok


def maybe_fused_sparse_prepare(est):
    """Apply the fused prepare to ``est`` if it is in the default sparse
    configuration.  Returns True when the attributes were set (the lazy
    ``_prepare_attribute`` chain then finds them present and skips), False
    to fall back to the lazy path."""
    curry = est.cov_func_curry
    tag = getattr(curry, "_spec_tag", None)
    if not (
        ENABLED
        and est.nn_distances is None
        and est.mu is None
        and est.ls is None
        and est.cov_func is None
        and est.landmarks is None
        and est.Lp is None
        and est.L is None
        and est.initial_value is None
        and est.d is None
        and getattr(est, "d_method", None) == "embedding"
        and est.gp_type == GaussianProcessType.SPARSE_CHOLESKY
        and tag in _SPEC_CORES
        and tuple(getattr(curry, "_spec_params", ())) == ("ls",)
    ):
        return False

    x = est.x
    n, d_int = x.shape
    if d_int > 50:
        return False  # the lazy path raises the documented d>50 error
    if _cpu_ivf_applies(n):
        return False  # the lazy kNN auto-selects IVF at this scale on CPU
    k = int(est.n_landmarks)
    if not 1 < k < n:
        return False
    x64 = x.dtype == jnp.float64

    logger.info("Computing nearest neighbor distances.")
    logger.info(
        f"Using embedding dimensionality d={d_int}. "
        'Use d_method="fractal" to enable effective density normalization.'
    )
    n_sub, random_state = _landmark_preamble(est, n, k)

    spec = (tag, None, 1)
    key = jax.random.PRNGKey(int(random_state))
    nn, nan_c, inf_c, neg_c, all_bad, mu, ls, xu, K, Lp, ok, piv, r = (
        _fused_sparse_prepare_program(
            x,
            key,
            float(est.jitter),
            float(est.ls_factor),
            spec,
            k,
            d_int,
            n_sub,
            int(min(DEFAULT_BATCH_SIZE, n)),
            int(min(DEFAULT_ASSIGN_BLOCK, n_sub if n_sub is not None else n)),
        )
    )
    # ONE host transfer for every scalar the host logic needs (+ the pivot
    # list, a few KB, computed in-program only when the Cholesky failed)
    nan_c, inf_c, neg_c, all_bad, mu, ls, ok, piv, r = jax.device_get(
        (nan_c, inf_c, neg_c, all_bad, mu, ls, ok, piv, r)
    )
    report_nn_repair(nan_c, inf_c, neg_c, all_bad)

    est.nn_distances = nn
    est.d = d_int
    est.mu = float(mu)
    est.ls = float(ls)
    est.cov_func = curry(float(ls))
    logger.info("Using covariance function %s.", str(est.cov_func))
    est.landmarks = xu
    params = (float(ls),)

    def run_ok(xu_, Lp_):
        return _fused_factorize_program(x, xu_, Lp_, nn, float(mu), params, spec, d_int)

    def run_prune(piv_):
        return _fused_prune_factorize_program(
            K, piv_, x, xu, nn, float(mu), params, float(est.jitter), spec, d_int
        )

    def run_prune_big(piv_):
        return _chunked_prune_factorize(
            est, K, piv_, x, xu, nn, mu, params, spec, d_int
        )

    _finish_factorization(
        est, x, xu, K, Lp, bool(ok), x64, run_ok, run_prune,
        pivot=(piv, int(r)), run_prune_big=run_prune_big,
    )
    return True


def maybe_fused_nystroem_prepare(est):
    """Fused prepare for the ``sparse_nystroem`` configuration at m > 512.

    Stage 1 is the SAME program as the default sparse prepare (kNN →
    heuristics → k-means → landmark kernel → Cholesky attempt + in-program
    pivot), so the expensive executable is shared across GP types.  The
    Cholesky-whitened Nyström factorization then reuses the sparse path's
    TRSM program for H = C Lp⁻ᵀ and runs the fractional-mass selection on
    the whitened Gram (``ops/linalg.py:_nystroem_select_and_project``) —
    replacing the lazy path's dozens of eager dispatches and per-attribute
    host fetches, and certifying corr 0.999998 vs host-f64 at the
    2,000-landmark bench shape (the earlier sketch-whitening design
    measured 0.996-0.997).  When the landmark kernel is f32-singular the
    pivoted subset from stage 1 prunes the landmarks first, exactly like
    the sparse path.  m ≤ 512 keeps the lazy exact-eigh path (reference
    bit-parity there).
    """
    curry = est.cov_func_curry
    tag = getattr(curry, "_spec_tag", None)
    if not (
        ENABLED
        and est.nn_distances is None
        and est.mu is None
        and est.ls is None
        and est.cov_func is None
        and est.landmarks is None
        and est.Lp is None
        and est.L is None
        and est.initial_value is None
        and est.d is None
        and not est.check_rank
        and getattr(est, "d_method", None) == "embedding"
        and est.gp_type == GaussianProcessType.SPARSE_NYSTROEM
        and tag in _SPEC_CORES
        and tuple(getattr(curry, "_spec_params", ())) == ("ls",)
    ):
        return False

    from ..ops.linalg import (
        NYSTROEM_EXACT_MAX,
        RANK_BUCKETS,
        _chunked_rows,
        _nystroem_select_and_project,
        _standard_low_rank_fused_spec,
        safe_cholesky,
        select_stable_landmarks,
    )
    from .base import RANK_FRACTION_THRESHOLD

    x = est.x
    n, d_int = x.shape
    if d_int > 50:
        return False  # the lazy path raises the documented d>50 error
    if _cpu_ivf_applies(n):
        return False  # the lazy kNN auto-selects IVF at this scale on CPU
    k = int(est.n_landmarks)
    if not NYSTROEM_EXACT_MAX < k < n:
        return False  # small m: exact-eigh lazy path (reference parity)

    logger.info("Computing nearest neighbor distances.")
    logger.info(
        f"Using embedding dimensionality d={d_int}. "
        'Use d_method="fractal" to enable effective density normalization.'
    )
    n_sub, random_state = _landmark_preamble(est, n, k)

    spec = (tag, None, 1)
    key = jax.random.PRNGKey(int(random_state))
    nn, nan_c, inf_c, neg_c, all_bad, mu, ls, xu, K, Lp, ok, piv, r = (
        _fused_sparse_prepare_program(
            x,
            key,
            float(est.jitter),
            float(est.ls_factor),
            spec,
            k,
            d_int,
            n_sub,
            int(min(DEFAULT_BATCH_SIZE, n)),
            int(min(DEFAULT_ASSIGN_BLOCK, n_sub if n_sub is not None else n)),
        )
    )
    # ONE host transfer for every scalar the host logic needs (+ the pivot
    # list, computed in-program only when the Cholesky attempt failed)
    nan_c, inf_c, neg_c, all_bad, mu, ls, ok, piv, r = jax.device_get(
        (nan_c, inf_c, neg_c, all_bad, mu, ls, ok, piv, r)
    )
    report_nn_repair(nan_c, inf_c, neg_c, all_bad)

    est.nn_distances = nn
    est.d = d_int
    est.mu = float(mu)
    est.ls = float(ls)
    est.cov_func = curry(float(ls))
    logger.info("Using covariance function %s.", str(est.cov_func))

    params = (float(ls),)
    x64 = x.dtype == jnp.float64
    if bool(ok):
        est.landmarks = xu
        xu_sel, Lp_sel = xu, Lp
    elif x64:
        # f64 parity: no pruning — safe_cholesky raises like the lazy path
        est.landmarks = xu
        xu_sel = xu
        Lp_sel = safe_cholesky(K, jitter=est.jitter, max_tries=0)
    else:
        # f32: prune to the pivoted-Cholesky landmark subset (computed
        # inside stage 1), mirroring the sparse path's discipline
        cap = min(k, FUSED_PIVOT_CAP)
        r = int(r)
        if 0 < r < cap:
            buckets = [b for b in RANK_BUCKETS if b <= r]
            if buckets:
                r = buckets[-1]
            logger.info(
                "Pivoted Cholesky selected %d of %d landmarks "
                "(relative tolerance %.0e).",
                r,
                k,
                PIVOT_REL_TOL,
            )
            import numpy as np

            piv_sel = np.asarray(piv[:r])
        else:
            piv_sel = select_stable_landmarks(K, rel_tol=PIVOT_REL_TOL)
        logger.warning(
            "Landmark kernel is singular at f32; pruning %d "
            "redundant landmarks (keeping %d).",
            k - len(piv_sel),
            len(piv_sel),
        )
        piv_arr = jnp.asarray(piv_sel, dtype=jnp.int32)
        xu_sel = xu[piv_arr]
        est.landmarks = xu_sel
        est.n_landmarks = int(len(piv_sel))
        Lp_sel = safe_cholesky(
            K[piv_arr][:, piv_arr], jitter=est.jitter, max_tries=3
        )

    rank = est.rank
    # whitened features via the sparse path's TRSM program — row-chunked
    # at large (n, m) exactly like _standard_low_rank, so a
    # well-conditioned full-width landmark kernel at large n cannot OOM
    # the single-program solve — then the mass selection on their Gram
    H = _chunked_rows(
        partial(_standard_low_rank_fused_spec, spec, params), x, xu_sel, Lp_sel
    )
    L = _nystroem_select_and_project(H, rank)
    # _compute_L's logging/warning contract for the Nyström types
    new_rank = L.shape[1]
    n_landmarks_now = xu_sel.shape[0]
    if new_rank > (rank * RANK_FRACTION_THRESHOLD * n_landmarks_now):
        logger.warning(
            f"Shallow rank reduction from {n_landmarks_now:,} to "
            f"{new_rank:,} indicates underrepresentation by landmarks. "
            "Consider increasing n_landmarks!"
        )
    logger.info(f"Using rank {new_rank:,} covariance representation.")
    est.L = L
    return True


@partial(
    jax.jit,
    static_argnames=(
        "spec",
        "k_landmarks",
        "d_int",
        "n_sub",
        "n_times",
        "normalize",
        "knn_batch",
        "assign_block",
    ),
)
def _fused_time_prepare_program(
    x,
    group,
    counts,
    targets,
    key,
    jitter,
    ls_time,
    ls_factor,
    spec,
    k_landmarks,
    d_int,
    n_sub,
    n_times,
    normalize,
    knn_batch,
    assign_block,
):
    """Fused preparation for the time-sensitive density model with a given
    ls_time: within-time 1-NN (one-hot group columns, ==
    compute_nn_distances_within_time_points) -> optional sampling-bias
    normalization -> repair -> mu/ls -> time-rescaled k-means landmarks
    (== compute_landmarks_rescale_time) -> product-kernel Cholesky attempt."""
    jitter = jnp.asarray(jitter, dtype=x.dtype)
    ls_time = jnp.asarray(ls_time, dtype=x.dtype)
    ls_factor = jnp.asarray(ls_factor, dtype=x.dtype)
    states = x[:, :-1]

    # within-time 1-NN by one-hot group columns (bit-identical to a
    # per-group search; see parameters.within_time_augmented)
    from ..parameters import within_time_augmented

    x_aug = within_time_augmented(states, group, n_times)
    dists, _ = _knn_blocked(x_aug, x_aug, 2, knn_batch, DEFAULT_COL_BLOCK)
    nn_raw = dists[:, 1]

    if normalize:
        n_samples = counts[group].astype(nn_raw.dtype)
        factor = (n_samples / targets[group]) ** (1.0 / d_int)
        nn_model = factor * nn_raw
        nn_ls_src = nn_raw  # the lazy path re-searches without
        # normalization for the ls heuristic; the search is deterministic,
        # so reusing the raw distances is identical
    else:
        nn_model = nn_raw
        nn_ls_src = None

    nn, nan_c, inf_c, neg_c, all_bad = _nn_repair_impl(nn_model)
    if nn_ls_src is None:
        nn_ls_src = nn

    mu = jnp.quantile(mle(nn, d_int), 0.01) - 10
    ls = jnp.exp(jnp.log(nn_ls_src).mean() + 3.0) * ls_factor

    # landmarks in time-rescaled space
    time_factor = ls / ls_time
    x_resc = x.at[:, -1].multiply(time_factor)
    x_fit = x_resc
    if n_sub is not None:
        idx = jax.random.choice(key, x.shape[0], shape=(n_sub,), replace=False)
        x_fit = x_resc[idx]
    init_centroids = _kmeanspp_init(x_fit, k_landmarks, key)
    xu = _lloyd(x_fit, init_centroids, k_landmarks, DEFAULT_N_ITER, assign_block)
    xu = xu.at[:, -1].divide(time_factor)

    K = eval_operand_spec(spec, (ls, ls_time), xu, xu)
    Lp, ok, piv, r = _chol_attempt_with_pivot(K, jitter)

    return nn, nan_c, inf_c, neg_c, all_bad, mu, ls, xu, K, Lp, ok, piv, r


@partial(
    jax.jit,
    static_argnames=(
        "spec",
        "k_landmarks",
        "k_query",
        "k_dim",
        "n_sub",
        "knn_batch",
        "assign_block",
    ),
)
def _fused_dim_prepare_program(
    x,
    key,
    jitter,
    ls_factor,
    spec,
    k_landmarks,
    k_query,
    k_dim,
    n_sub,
    knn_batch,
    assign_block,
):
    """Fused preparation for the dimensionality model: ONE kNN search serves
    both the k-NN distance matrix (likelihood) and the local-fractal-dimension
    neighborhoods, then mu/ls heuristics, k-means landmarks, and the landmark
    Cholesky attempt — one executable, one scalar fetch.

    The lazy path performs two searches (k and 30 neighbors); a single
    search at max(k+1, 30) sliced to each width returns identical neighbor
    sets (top-k of a sorted larger search)."""
    from ..ops.neighbors import local_dimensionality

    jitter = jnp.asarray(jitter, dtype=x.dtype)
    ls_factor = jnp.asarray(ls_factor, dtype=x.dtype)

    kk = max(k_query + 1, k_dim)
    dists, idx = _knn_blocked(x, x, kk, knn_batch, DEFAULT_COL_BLOCK)
    distances = dists[:, 1 : k_query + 1]  # self excluded (== compute_distances)
    nn = dists[:, 1]
    # per-cell local fractal dimension (== local_dimensionality; the lazy
    # path's own search includes the self neighbor, as idx[:, :k_dim] does)
    d = local_dimensionality(x, k=k_dim, neighbor_idx=idx[:, :k_dim])

    # heuristics: the dimensionality path applies no nn-distance repair
    # (parity: its _compute_nn_distances returns distances[:, 0] directly)
    mu_dens = jnp.quantile(mle(nn, d), 0.01) - 10
    ls = jnp.exp(jnp.log(nn).mean() + 3.0) * ls_factor

    x_fit = x
    if n_sub is not None:
        sub_idx = jax.random.choice(key, x.shape[0], shape=(n_sub,), replace=False)
        x_fit = x[sub_idx]
    init_centroids = _kmeanspp_init(x_fit, k_landmarks, key)
    xu = _lloyd(x_fit, init_centroids, k_landmarks, DEFAULT_N_ITER, assign_block)

    K = eval_operand_spec(spec, (ls,), xu, xu)
    Lp, ok, piv, r = _chol_attempt_with_pivot(K, jitter)

    return distances, d, mu_dens, ls, xu, K, Lp, ok, piv, r


@partial(jax.jit, static_argnames=("spec",))
def _fused_dim_factorize_program(x, xu, Lp, distances, d, mu_dim, mu_dens, params, spec):
    """Dimensionality stage 2: TRSM + the stacked (log-dim, log-density)
    ridge warm starts (== compute_initial_dimensionalities)."""
    C = eval_operand_spec(spec, params, x, xu)
    with jax.default_matmul_precision("highest"):  # see _chol_attempt_with_pivot
        L = solve_triangular(Lp, C.T, lower=True).T
    nn = distances[:, 0]
    z_dim = ridge_solve(L, jnp.log(d) - mu_dim, 1.0)
    z_dens = ridge_solve(L, mle(nn, d) - mu_dens, 1.0)
    return L, jnp.stack([z_dim, z_dens])


@partial(jax.jit, static_argnames=("spec",))
def _fused_dim_prune_factorize_program(
    K, piv, x, xu, distances, d, mu_dim, mu_dens, params, jitter, spec
):
    """Dimensionality stage 2 for the pruning path."""
    jitter = jnp.asarray(jitter, dtype=K.dtype)
    K_sub = K[piv][:, piv]
    diag = jnp.arange(K_sub.shape[0])
    # HIGHEST precision, matching the density prune program (ADVICE r4 #1).
    with jax.default_matmul_precision("highest"):
        Lp = jnp.linalg.cholesky(K_sub.at[diag, diag].add(jitter))
    ok = ~jnp.any(jnp.isnan(Lp))
    xu_sel = xu[piv]
    C = eval_operand_spec(spec, params, x, xu_sel)
    with jax.default_matmul_precision("highest"):
        L = solve_triangular(Lp, C.T, lower=True).T
    nn = distances[:, 0]
    z_dim = ridge_solve(L, jnp.log(d) - mu_dim, 1.0)
    z_dens = ridge_solve(L, mle(nn, d) - mu_dens, 1.0)
    return Lp, xu_sel, L, jnp.stack([z_dim, z_dens]), ok


@partial(
    jax.jit,
    static_argnames=("k_landmarks", "n_sub", "knn_batch", "assign_block"),
)
def _fused_function_prepare_program(
    x, key, ls_factor, k_landmarks, n_sub, knn_batch, assign_block
):
    """Fused preparation for the function estimator: kNN -> repair -> ls ->
    k-means landmarks (no optimizer and no landmark factorization exist on
    this path — the conditional handles its own solves with sigma)."""
    ls_factor = jnp.asarray(ls_factor, dtype=x.dtype)
    dists, _ = _knn_blocked(x, x, 2, knn_batch, DEFAULT_COL_BLOCK)
    nn, nan_c, inf_c, neg_c, all_bad = _nn_repair_impl(dists[:, 1])
    ls = jnp.exp(jnp.log(nn).mean() + 3.0) * ls_factor
    x_fit = x
    if n_sub is not None:
        idx = jax.random.choice(key, x.shape[0], shape=(n_sub,), replace=False)
        x_fit = x[idx]
    init_centroids = _kmeanspp_init(x_fit, k_landmarks, key)
    xu = _lloyd(x_fit, init_centroids, k_landmarks, DEFAULT_N_ITER, assign_block)
    return nn, nan_c, inf_c, neg_c, all_bad, ls, xu


def maybe_fused_function_prepare(est):
    """Fused prepare for FunctionEstimator in its default sparse
    configuration.  Returns True when applied."""
    curry = est.cov_func_curry
    tag = getattr(curry, "_spec_tag", None)
    if not (
        ENABLED
        and est.nn_distances is None
        and est.ls is None
        and est.cov_func is None
        and est.landmarks is None
        and est.gp_type == GaussianProcessType.SPARSE_CHOLESKY
        and tag in _SPEC_CORES
        and tuple(getattr(curry, "_spec_params", ())) == ("ls",)
    ):
        return False

    x = est.x
    n = x.shape[0]
    if _cpu_ivf_applies(n):
        return False  # the lazy kNN auto-selects IVF at this scale on CPU
    k = int(est.n_landmarks)
    if not 1 < k < n:
        return False

    logger.info("Computing nearest neighbor distances.")
    n_sub, random_state = _landmark_preamble(est, n, k)

    key = jax.random.PRNGKey(int(random_state))
    nn, nan_c, inf_c, neg_c, all_bad, ls, xu = _fused_function_prepare_program(
        x,
        key,
        float(est.ls_factor),
        k,
        n_sub,
        int(min(DEFAULT_BATCH_SIZE, n)),
        int(min(DEFAULT_ASSIGN_BLOCK, n_sub if n_sub is not None else n)),
    )
    nan_c, inf_c, neg_c, all_bad, ls = jax.device_get(
        (nan_c, inf_c, neg_c, all_bad, ls)
    )
    report_nn_repair(nan_c, inf_c, neg_c, all_bad)

    est.nn_distances = nn
    est.ls = float(ls)
    est.cov_func = curry(float(ls))
    logger.info("Using covariance function %s.", str(est.cov_func))
    est.landmarks = xu
    return True


def maybe_fused_dimensionality_prepare(est):
    """Fused prepare for DimensionalityEstimator in its default sparse
    configuration.  Returns True when applied."""
    curry = est.cov_func_curry
    tag = getattr(curry, "_spec_tag", None)
    if not (
        ENABLED
        and est.distances is None
        and est.nn_distances is None
        and est.d is None
        and est.mu_dens is None
        and est.ls is None
        and est.cov_func is None
        and est.landmarks is None
        and est.Lp is None
        and est.L is None
        and est.initial_value is None
        and est.gp_type == GaussianProcessType.SPARSE_CHOLESKY
        and tag in _SPEC_CORES
        and tuple(getattr(curry, "_spec_params", ())) == ("ls",)
    ):
        return False

    x = est.x
    n = x.shape[0]
    if _cpu_ivf_applies(n):
        return False  # the lazy kNN auto-selects IVF at this scale on CPU
    k = int(est.n_landmarks)
    k_query = int(est.k)
    k_dim = 30
    if not 1 < k < n or k_query + 1 >= n or n < 31:
        return False  # tiny inputs: lazy path's validation/warnings apply
    x64 = x.dtype == jnp.float64

    logger.info("Computing distances.")
    n_sub, random_state = _landmark_preamble(est, n, k)

    spec = (tag, None, 1)
    key = jax.random.PRNGKey(int(random_state))
    distances, d, mu_dens, ls, xu, K, Lp, ok, piv, r = _fused_dim_prepare_program(
        x,
        key,
        float(est.jitter),
        float(est.ls_factor),
        spec,
        k,
        k_query,
        k_dim,
        n_sub,
        int(min(DEFAULT_BATCH_SIZE, n)),
        int(min(DEFAULT_ASSIGN_BLOCK, n_sub if n_sub is not None else n)),
    )
    mu_dens, ls, ok, piv, r = jax.device_get((mu_dens, ls, ok, piv, r))

    est.distances = distances
    est.nn_distances = distances[:, 0]
    est.d = d
    est.mu_dens = float(mu_dens)
    est.ls = float(ls)
    est.cov_func = curry(float(ls))
    logger.info("Using covariance function %s.", str(est.cov_func))
    est.landmarks = xu
    params = (float(ls),)
    mu_dim = float(est.mu_dim)

    def run_ok(xu_, Lp_):
        return _fused_dim_factorize_program(
            x, xu_, Lp_, distances, d, mu_dim, float(mu_dens), params, spec
        )

    def run_prune(piv_):
        return _fused_dim_prune_factorize_program(
            K,
            piv_,
            x,
            xu,
            distances,
            d,
            mu_dim,
            float(mu_dens),
            params,
            float(est.jitter),
            spec,
        )

    _finish_factorization(
        est, x, xu, K, Lp, bool(ok), x64, run_ok, run_prune, pivot=(piv, int(r))
    )
    return True


def maybe_fused_time_prepare(est):
    """Fused prepare for TimeSensitiveDensityEstimator when ls_time is
    given and the estimator is otherwise in its default sparse
    configuration.  Returns True when applied."""
    curry = est.cov_func_curry
    tag = getattr(curry, "_spec_tag", None)
    if not (
        ENABLED
        and est.nn_distances is None
        and est.mu is None
        and est.ls is None
        and est.ls_time is not None
        and est.cov_func is None
        and est.landmarks is None
        and est.Lp is None
        and est.L is None
        and est.initial_value is None
        and est.d is None
        and getattr(est, "d_method", None) == "embedding"
        and est.gp_type == GaussianProcessType.SPARSE_CHOLESKY
        and tag in _SPEC_CORES
        and tuple(getattr(curry, "_spec_params", ())) == ("ls",)
    ):
        return False

    import numpy as np

    from ..parameters import (
        MAX_ONEHOT_TIME_GROUPS,
        _get_target_cell_count,
        compute_cov_func,
    )

    x = est.x
    n = x.shape[0]
    d_int = x.shape[1] - 1
    if d_int > 50:
        return False  # the lazy path raises the documented d>50 error
    if _cpu_ivf_applies(n):
        return False  # the lazy kNN auto-selects IVF at this scale on CPU
    k = int(est.n_landmarks)
    if not 1 < k < n:
        return False
    x64 = x.dtype == jnp.float64

    # host-side time bookkeeping (one small transfer of the time column)
    t_host = np.asarray(x[:, -1])
    unique_times, counts_np = np.unique(t_host, return_counts=True)
    n_times = len(unique_times)
    if n_times > MAX_ONEHOT_TIME_GROUPS or (counts_np < 2).any():
        # many groups: the lazy path's per-group fallback applies;
        # undersampled time point: the lazy path raises the documented error
        return False
    group = np.searchsorted(unique_times, t_host)

    normalize = est.normalize_per_time_point
    do_normalize = normalize is not False and normalize is not None
    av_cells_per_tp = n / n_times
    if do_normalize:
        # same eager validation as the lazy path
        # (compute_nn_distances_within_time_points) — without it a
        # missing dict key or wrong-length list surfaces as a raw
        # KeyError/IndexError below or is silently truncated
        from ..utils.parameter_validation import validate_normalize_parameter

        validate_normalize_parameter(normalize, jnp.asarray(unique_times))
        targets = np.asarray(
            [
                _get_target_cell_count(
                    normalize, t, av_cells_per_tp, jnp.asarray(unique_times)
                )
                for t in unique_times
            ],
            dtype=np.float64,
        )
        logger.info(
            "Normalizing nearest neighbor distances correcting sampling "
            f"bias for {n_times} different time points."
        )
    else:
        targets = np.ones(n_times)

    logger.info("Computing nearest neighbor distances within time points.")
    logger.info(
        f"Using embedding dimensionality d={d_int}. "
        'Use d_method="fractal" to enable effective density normalization.'
    )
    if do_normalize:
        logger.info("Computing non-normalized nn_distances for length scale heuristic.")
    n_sub, random_state = _landmark_preamble(est, n, k)

    # product-kernel structure from a value-free template
    spec, _ = compute_cov_func(curry, 1.0, 1.0).operand_spec()
    key = jax.random.PRNGKey(int(random_state))
    nn, nan_c, inf_c, neg_c, all_bad, mu, ls, xu, K, Lp, ok, piv, r = (
        _fused_time_prepare_program(
            x,
            jnp.asarray(group, dtype=jnp.int32),
            jnp.asarray(counts_np, dtype=jnp.int32),
            jnp.asarray(targets, dtype=x.dtype),
            key,
            float(est.jitter),
            float(est.ls_time),
            float(est.ls_factor),
            spec,
            k,
            d_int,
            n_sub,
            n_times,
            bool(do_normalize),
            int(min(DEFAULT_BATCH_SIZE, n)),
            int(min(DEFAULT_ASSIGN_BLOCK, n_sub if n_sub is not None else n)),
        )
    )
    nan_c, inf_c, neg_c, all_bad, mu, ls, ok, piv, r = jax.device_get(
        (nan_c, inf_c, neg_c, all_bad, mu, ls, ok, piv, r)
    )
    report_nn_repair(nan_c, inf_c, neg_c, all_bad)

    est.nn_distances = nn
    est.d = d_int
    est.mu = float(mu)
    est.ls = float(ls)
    est.cov_func = compute_cov_func(curry, float(ls), float(est.ls_time))
    logger.info("Using covariance function %s.", str(est.cov_func))
    est.landmarks = xu
    params = (float(ls), float(est.ls_time))

    def run_ok(xu_, Lp_):
        return _fused_factorize_program(x, xu_, Lp_, nn, float(mu), params, spec, d_int)

    def run_prune(piv_):
        return _fused_prune_factorize_program(
            K, piv_, x, xu, nn, float(mu), params, float(est.jitter), spec, d_int
        )

    def run_prune_big(piv_):
        return _chunked_prune_factorize(
            est, K, piv_, x, xu, nn, mu, params, spec, d_int
        )

    _finish_factorization(
        est, x, xu, K, Lp, bool(ok), x64, run_ok, run_prune,
        pivot=(piv, int(r)), run_prune_big=run_prune_big,
    )
    return True


def _finish_factorization(est, x, xu, K, Lp, ok, x64, run_ok, run_prune, pivot=None,
                          run_prune_big=None):
    """Shared stage-2 tail of the fused prepares: accept the landmark
    Cholesky attempt, or prune to the pivoted subset and run one submatrix
    program.  ``run_ok(xu, Lp) -> (L, z0)`` and ``run_prune(piv) ->
    (Lp, xu_sel, L, z0, ok)`` are the model-specific factorization
    programs; ``pivot`` is the (piv, r) already computed inside the stage-1
    program when the Cholesky failed (None or r >= cap falls back to the
    host-side selection).  ``run_prune_big``, when given, is the chunked
    multi-program variant used when the (n, pruned-m) TRSM would OOM as a
    single program (see _chunked_prune_factorize)."""
    from .base import SAMPLE_LANDMARK_RATIO
    from ..ops.linalg import (
        PIVOT_REL_TOL,
        RANK_BUCKETS,
        safe_cholesky,
        select_stable_landmarks,
    )

    n = x.shape[0]
    k = xu.shape[0]
    if ok:
        est.Lp = Lp
        would_check_rank = (
            est.check_rank is None and SAMPLE_LANDMARK_RATIO * k < n
        ) or bool(est.check_rank)
        if would_check_rank:
            # leave L/initial_value to the lazy path so the documented
            # rank-estimation diagnostics run unchanged
            return
        L, z0 = run_ok(xu, Lp)
        est.L = L
        est.initial_value = z0
        logger.info(f"Using rank {k:,} covariance representation.")
        return

    if x64:
        # f64 parity: the lazy path raises through safe_cholesky
        est.Lp = safe_cholesky(K, jitter=est.jitter, max_tries=0)
        return

    from .. import config

    if not config.PRUNE_SINGULAR_LANDMARKS:
        # full-capacity opt-out: keep all landmarks, factorize once on the
        # host in f64 (host-side jitter escalation only as a last resort
        # for matrices indefinite even at f64 resolution; the escalated
        # f32 safe_cholesky below is the final fallback), leave
        # L/initial_value to the lazy chain (which chunks the large TRSM)
        import numpy as _np

        from ..ops.linalg import host_cholesky_f64

        logger.warning(
            "Landmark kernel is singular at f32; keeping all %d landmarks "
            "(pruning disabled) and factorizing once on the host in "
            "float64.",
            k,
        )
        # rebuild K on the host in f64 from coordinates when the kernel
        # structure supports it (see BaseEstimator._lp_accept_or_prune)
        K_for_chol = K
        try:
            from ..ops.extended_precision import host_spec_kernel_f64

            spec_h, params_h = est.cov_func.operand_spec()
            K_for_chol = host_spec_kernel_f64(spec_h, params_h, xu)
        except (NotImplementedError, AttributeError):
            pass
        try:
            L_host64 = host_cholesky_f64(K_for_chol, jitter=est.jitter)
        except _np.linalg.LinAlgError:
            est.Lp = safe_cholesky(K, jitter=est.jitter, max_tries=3)
            return
        # keep the f64 factor for the lazy chain's extended-precision
        # whitening (see BaseEstimator._compute_L)
        est._hostf64_Lp = L_host64
        est.Lp = jnp.asarray(L_host64, dtype=K.dtype)
        return

    # f32 pruning path: pivoted-Cholesky landmark subset (already computed
    # inside the stage-1 program unless the tolerance was not reached within
    # the fused cap), then one program for submatrix Cholesky + TRSM +
    # ridge warm start
    cap = min(k, FUSED_PIVOT_CAP)
    if pivot is not None and 0 < pivot[1] < cap:
        piv_full, r = pivot
        # quantization identical to select_stable_landmarks
        buckets = [b for b in RANK_BUCKETS if b <= r]
        if buckets:
            r = buckets[-1]
        logger.info(
            "Pivoted Cholesky selected %d of %d landmarks "
            "(relative tolerance %.0e).",
            r,
            k,
            PIVOT_REL_TOL,
        )
        import numpy as np

        piv = np.asarray(piv_full[:r])
    else:
        piv = select_stable_landmarks(K, rel_tol=PIVOT_REL_TOL)
    logger.warning(
        "Landmark kernel is singular at f32; pruning %d "
        "redundant landmarks (keeping %d).",
        k - len(piv),
        len(piv),
    )
    est.n_landmarks = int(len(piv))
    if est.check_rank is None:
        # rank is known by construction; skip the SVD check
        est.check_rank = False
    piv_arr = jnp.asarray(piv, dtype=jnp.int32)
    if bool(est.check_rank):
        # an explicitly requested rank diagnostic must run in _compute_L:
        # set only the (validated) Cholesky and landmarks and leave
        # L/initial_value lazy — running the full prune program here would
        # pay the O(n·m) TRSM + ridge warm start only to discard them
        est.landmarks = xu[piv_arr]
        est.Lp = safe_cholesky(K[piv][:, piv], jitter=est.jitter, max_tries=3)
        return
    from ..ops.linalg import TRSM_CHUNK_MIN_M, TRSM_CHUNK_MIN_N

    if (
        run_prune_big is not None
        and len(piv) >= TRSM_CHUNK_MIN_M
        and n > TRSM_CHUNK_MIN_N
    ):
        Lp2, xu_sel, L, z0, ok2 = run_prune_big(piv_arr)
    else:
        Lp2, xu_sel, L, z0, ok2 = run_prune(piv_arr)
    est.landmarks = xu_sel
    if est.optimizer == "L-BFGS-B" and getattr(est, "_in_fit", False):
        # optimistic (only inside fit/fit_predict, where run_inference is
        # guaranteed to follow): the pivoted subset with jitter essentially
        # always factors, so don't pay a blocking fetch for ok2 here — the
        # optimizer's own loss fetch reveals a failure (non-finite loss),
        # and _run_inference rebuilds from this fallback and retries.  A
        # bare prepare_inference() call validates eagerly below instead, so
        # externally driven workflows never see unverified NaNs.
        est.Lp = Lp2
        est.L = L
        est.initial_value = z0
        est._fused_lp_fallback = (K, piv)
        logger.info(f"Using rank {len(piv):,} covariance representation.")
    elif bool(ok2):
        est.Lp = Lp2
        est.L = L
        est.initial_value = z0
        logger.info(f"Using rank {len(piv):,} covariance representation.")
    else:
        # rare: the submatrix still needs jitter escalation — reuse the
        # robust path and let L/initial_value fall back to the lazy chain
        K_sub = K[piv][:, piv]
        est.Lp = safe_cholesky(K_sub, jitter=est.jitter, max_tries=3)
