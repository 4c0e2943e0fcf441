"""Covariance decompositions: Cholesky, truncated eigh, Nyström variants.

Behavioural parity target: ``mellon/decomposition.py``.  Device notes: all
factorizations run on-device through XLA's blocked Cholesky/eigh; the
precision-critical spot is the m x m landmark Cholesky at small jitter
(``mellon/decomposition.py:79-123``), for which :func:`safe_cholesky`
escalates the jitter geometrically instead of failing outright in f32.
"""

import logging
from functools import partial

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular

from ..utils.util import stabilize, DEFAULT_JITTER

DEFAULT_RANK = 0.99
DEFAULT_SIGMA = 0
# relative diagonal tolerance of the pivoted partial Cholesky used for
# landmark pruning (shared by select_stable_landmarks and the fused prepare)
PIVOT_REL_TOL = 1e-6

logger = logging.getLogger("mellon_tpu")


def cholesky_with_check(K, jitter=DEFAULT_JITTER):
    """Cholesky of an already-stabilized matrix with the reference's NaN
    error semantics (``mellon/decomposition.py:114-123``)."""
    L = jnp.linalg.cholesky(K)
    if bool(jnp.any(jnp.isnan(L))):
        message = (
            f"Covariance not positively definite with jitter={jitter}. "
            "Consider increasing the jitter for numerical stabilization."
        )
        logger.error(message)
        raise ValueError(message)
    return L


@jax.jit
def _jittered_cholesky(K, jitter):
    """One reusable program: chol(K + jitter I) and a validity flag.

    The jitter is a runtime operand (not a baked constant) so escalation
    retries reuse the same executable — important on backends where loading
    a new program is expensive.
    """
    idx = jnp.arange(K.shape[0])
    A = K.at[idx, idx].add(jitter)
    # highest: the blocked Cholesky's inner matmuls otherwise run one
    # reduced-precision pass (~1e-3 relative — far coarser than f32); at
    # m <= 5000 the extra passes cost milliseconds
    with jax.default_matmul_precision("highest"):
        L = jnp.linalg.cholesky(A)
    ok = ~jnp.any(jnp.isnan(L))
    return L, ok


def safe_cholesky(K, jitter=DEFAULT_JITTER, max_tries=0):
    """Cholesky with optional geometric jitter escalation and a host-f64
    factorization as the final fallback.

    With ``max_tries=0`` this is exactly the reference behaviour (raise on
    NaN).  With ``max_tries>0`` (the f32 default) it retries with 10x
    jitter (same executable, jitter is a runtime operand), then — for
    genuinely ill-conditioned PSD kernels, common for wide Matern kernels
    over thousands of landmarks — factorizes once on the host in f64.  The
    result is always lower-triangular, so every downstream triangular solve
    works unchanged.
    """
    L, ok = _jittered_cholesky(K, jnp.asarray(jitter, dtype=K.dtype))
    ok = bool(ok)
    tries = 0
    extra = max(jitter, DEFAULT_JITTER)
    while not ok and tries < max_tries:
        extra = extra * 10
        tries += 1
        logger.warning(f"Cholesky failed; retrying with jitter={extra:.2e}.")
        L, ok = _jittered_cholesky(K, jnp.asarray(extra, dtype=K.dtype))
        ok = bool(ok)
    if not ok and max_tries > 0:
        # Precision fallback: the kernel matrix is PSD but its condition
        # number exceeds f32 resolution (common for wide Matern kernels over
        # thousands of landmarks).  Factorize once on the host in f64 — the
        # one-time m³ cost matches what the reference spends (its whole
        # pipeline is host f64) while all O(n·m) compute stays on device.
        import numpy as np

        logger.warning(
            "Cholesky failed after jitter escalation; "
            "factorizing once on host in float64."
        )
        try:
            L_host = host_cholesky_f64(K, jitter=max(jitter, DEFAULT_JITTER))
            L = jnp.asarray(L_host, dtype=K.dtype)
            ok = True
        except np.linalg.LinAlgError:
            pass
    # ok already encodes the NaN check (see _jittered_cholesky) — no second
    # device round trip needed when the factorization succeeded
    if not ok:
        message = (
            f"Covariance not positively definite with jitter={jitter}. "
            "Consider increasing the jitter for numerical stabilization."
        )
        logger.error(message)
        raise ValueError(message)
    return L


def _eigendecomposition(
    A, rank=DEFAULT_RANK, with_raw_rank=False, force_quantize=False
):
    """Top-eigenpair selection keeping a given count or eigenvalue-mass
    fraction (parity: ``mellon/decomposition.py:23-76``).

    Fractional ranks are rounded UP to the next power-of-two bucket
    (capped at the matrix size): the mass criterion makes the selected
    rank data-dependent, and a data-dependent output shape would force a
    fresh compile of every downstream executable on each fit.  The
    bucket never keeps fewer
    eigenpairs than the reference's searchsorted selection, so accuracy
    only improves over the parity behavior.  (Note the searchsorted
    convention itself, kept for parity, selects the largest rank whose
    cumulative mass is strictly BELOW the target — the selected pairs can
    fall one eigenvalue short of the requested mass, and the reference's
    "Recovering X% variance" log reports the mass of p+1 pairs,
    ``mellon/decomposition.py:62-72``.)

    A matrix with no positive eigenvalues raises a ValueError with jitter
    advice — the reference crashes with an opaque IndexError on the empty
    cumulative sum (``mellon/decomposition.py:58-62``); deliberate fix."""
    s, v = jnp.linalg.eigh(A)
    return _select_eigenpairs(
        s, v, rank, A.shape[0], with_raw_rank, force_quantize
    )


def _select_eigenpairs(
    s, v, rank, quantize_dim, with_raw_rank=False, force_quantize=False
):
    """The count/eigenvalue-mass selection of :func:`_eigendecomposition`,
    operating on an already-computed (ascending) eigendecomposition so the
    sketch-based large-Gram path shares the exact selection semantics.

    ``force_quantize`` buckets fractional-rank selections to powers of two
    even when ``quantize_dim`` ≤ 256 — the Nyström path uses it because a
    data-dependent selected rank changes L's column count and forces a
    fresh compile of every downstream executable per fit (observed: three
    'warm' fits each recompiling for ranks 48/53/64 out of a pruned
    256-landmark basis)."""
    # one transfer for every scalar the selection logic needs (each
    # bool()/int() on a device value is a blocking round trip)
    n_pos, any_nonpos = jax.device_get(
        (jnp.count_nonzero(s > 0), jnp.any(s <= 0))
    )
    if bool(any_nonpos):
        logger.warning(
            "Covariance matrix is singular (non-positive eigenvalues "
            "detected); predictions may be unreliable. Consider raising "
            "the jitter."
        )
    p = int(n_pos)
    if p == 0:
        message = (
            "Covariance matrix has no positive eigenvalues; cannot compute "
            "a low-rank factorization. Consider raising the jitter."
        )
        logger.error(message)
        raise ValueError(message)
    summed = jnp.cumsum(s[: -p - 1 : -1])
    raw_p = p  # mass-selected rank BEFORE power-of-two quantization
    if isinstance(rank, float):
        target = summed[-1] * rank
        p = int(jnp.searchsorted(summed, target))
        if p == 0:
            logger.warning(
                f"Low variance percentage {rank:%} indicated rank=0. "
                "Bumping rank to 1."
            )
            p = 1
        raw_p = p
        if force_quantize or quantize_dim > 256:
            # exact reference semantics below this size — the compile cost
            # of a fresh shape is negligible there and the test contracts
            # (searchsorted rank) stay bit-exact
            quantized = next((b for b in RANK_BUCKETS if b >= p), None)
            p_stable = min(
                quantized if quantized is not None else p, quantize_dim
            )
            if p_stable != p:
                logger.info(
                    "Quantizing eigendecomposition rank %d to %d "
                    "(shape-stable executables).",
                    p,
                    p_stable,
                )
                p = p_stable
    else:
        p = min(rank, p)
        raw_p = p
    # a sketch-based caller may hold fewer eigenpairs than quantize_dim
    # (the saturation loop widens the sketch before this binds)
    p = min(p, s.shape[0])
    if (isinstance(rank, float) and rank < 1) or rank < len(summed):
        p_report = min(p, len(summed) - 1)
        frac = summed[p_report] / summed[-1]
        logger.info(f"Recovering {float(frac):%} variance in eigendecomposition.")
    if with_raw_rank:
        return s[-p:], v[:, -p:], raw_p
    return s[-p:], v[:, -p:]


@partial(jax.jit, static_argnames=("rank", "n_iter", "seed"))
def randomized_eigh(A, rank, n_iter=2, seed=0):
    """Randomized truncated eigendecomposition of a symmetric PSD matrix:
    Gaussian range finder + ``n_iter`` subspace iterations + a small exact
    eigh on the projected matrix (Halko/Martinsson/Tropp structure).

    Everything is matmul-shaped: the m×m input only ever appears in m×m×p
    matmuls and (m, p) QR factorizations with p = rank + oversampling, so
    this replaces the O(m³) ``eigh`` — whose iterative solvers slow down
    on the near-degenerate spectra wide kernel matrices produce — with a
    few dense products.  Returns ``(s, v)`` in ascending order like
    ``jnp.linalg.eigh``, truncated to ``rank`` columns.
    """
    m = A.shape[0]
    p = min(m, rank + 16)
    # every product at HIGHEST: a reduced-precision product (bf16 or
    # TF32) puts ~1e-3 relative noise into the projected matrix B, and the tail of
    # its spectrum (used by the Nyström mass selection, then amplified by
    # rsqrt) is smaller than that noise — measured as log-density corr
    # 0.906 vs f64 at the 2,000-landmark bench shape before the pin
    hp = partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)
    omega = jax.random.normal(jax.random.PRNGKey(seed), (m, p), dtype=A.dtype)
    Q, _ = jnp.linalg.qr(hp(A, omega))
    for _ in range(n_iter):
        Q, _ = jnp.linalg.qr(hp(A, Q))
    B = hp(Q.T, hp(A, Q))
    B = 0.5 * (B + B.T)
    s, U = jnp.linalg.eigh(B)
    keep = min(rank, p)
    return s[-keep:], hp(Q, U[:, -keep:])


def _full_rank(x, cov_func, sigma=DEFAULT_SIGMA, jitter=DEFAULT_JITTER):
    """L = chol(K + max(sigma^2, jitter) I)
    (parity: ``mellon/decomposition.py:79-123``; in f32 the jitter escalates
    geometrically before failing, which the reference — running f64 — never
    needed)."""
    if isinstance(sigma, (int, float)):
        # common case (default sigma=0): resolve the jitter on the host —
        # float() on a device scalar would be a blocking round trip
        eff_jitter = max(float(sigma) ** 2, jitter)
    else:
        sigma2 = jnp.square(sigma)
        eff_jitter = float(jnp.maximum(sigma2, jitter))
    K = cov_func(x, x)
    max_tries = 0 if K.dtype == jnp.float64 else 3
    return safe_cholesky(K, jitter=eff_jitter, max_tries=max_tries)


def _full_decomposition_low_rank(
    x, cov_func, rank=DEFAULT_RANK, sigma=DEFAULT_SIGMA, jitter=DEFAULT_JITTER
):
    """Truncated eigendecomposition of the full covariance
    (parity: ``mellon/decomposition.py:126-171``)."""
    sigma2 = jnp.square(sigma)
    sigma2 = jnp.where(sigma2 < jitter, jitter, sigma2)
    W = stabilize(cov_func(x, x), sigma2)
    s, v = _eigendecomposition(W, rank=rank)
    # rank quantization can pull in trailing non-positive eigenvalues;
    # clipping makes those columns exactly zero (inert latent dimensions)
    return v * jnp.sqrt(jnp.maximum(s, 0.0))


@partial(jax.jit, static_argnames=("cov_func",))
def _standard_low_rank_fused(cov_func, x, xu, Lp):
    """Fused kernel-evaluation + TRSM: one program so XLA fuses the
    distance/kernel elementwise chain instead of materializing each (n, m)
    intermediate eagerly — essential at atlas scale (1M x 512 tiles are
    2 GB each).

    Fallback path for user-defined kernels without an operand spec: the
    kernel object is a static argument, so a new kernel instance means a
    new program."""
    C = cov_func(x, xu)
    # highest: the TRSM's blocked panel updates are matmuls; the default
    # reduced-precision pass would put ~1e-3-relative noise on H that the
    # whitening amplifies by cond(Lp) (the n·m² extra passes are tens of
    # ms even at the 98k x 5000 full-capacity shape)
    with jax.default_matmul_precision("highest"):
        return solve_triangular(Lp, C.T, lower=True).T


@partial(jax.jit, static_argnames=("spec",))
def _standard_low_rank_fused_spec(spec, params, x, xu, Lp):
    """Spec-keyed variant of :func:`_standard_low_rank_fused`: the kernel
    *structure* is the static key and its length scales are runtime
    operands, so one executable serves every fit of the same shape — no
    per-fit retrace/reload when the auto-selected ls changes."""
    from .kernels import eval_operand_spec

    C = eval_operand_spec(spec, params, x, xu)
    with jax.default_matmul_precision("highest"):  # see the fused variant
        return solve_triangular(Lp, C.T, lower=True).T


# chunk the kernel+TRSM program over rows of x when BOTH dims are large:
# at (98k, 5000) the single-program solve allocates >1 GB transposed
# panels (sized for a 16 GB device; not yet re-derived for the GPU's
# memory); the atlas shapes (1M x 512) are unaffected.
# The m threshold is 1536 (was 4096): the TRSM lowering keeps a
# dynamic-update-slice panel chain alive across remat copies, and a
# (98k, 2176) single-program solve — the d=2 tutorial shape once the
# accurate grams retain their larger pivot rank — measured ~8 GB of
# those temps.
TRSM_CHUNK_MIN_M = 1536
TRSM_CHUNK_MIN_N = 32768
TRSM_CHUNK_ROWS = 16384


def chunked_whiten(x, cov_func, xu, Lp):
    """H = k(x, xu) Lp⁻ᵀ via the fused kernel-evaluation + TRSM program,
    row-chunked over x when BOTH dimensions are large (the single-program
    solve at e.g. (98k, 5000) allocates >1 GB transposed panels).  One
    shape-stable executable serves every chunk.  Shared by
    the sparse-Cholesky factorization, the large-m Nyström whitening
    (lazy and fused paths), and the full-capacity (no-prune) route."""
    try:
        spec, params = cov_func.operand_spec()
    except (NotImplementedError, AttributeError):
        kernel = partial(_standard_low_rank_fused, cov_func)
    else:
        kernel = partial(_standard_low_rank_fused_spec, spec, params)
    return _chunked_rows(kernel, x, xu, Lp)


def _chunked_rows(kernel, x, xu, Lp):
    """Apply ``kernel(x_chunk, xu, Lp)`` row-chunked over x (see
    :func:`chunked_whiten`); the fused prepares call this directly with
    their spec-keyed kernel."""
    n, m = x.shape[0], xu.shape[0]
    if m >= TRSM_CHUNK_MIN_M and n > TRSM_CHUNK_MIN_N:
        blocks = []
        for start in range(0, n, TRSM_CHUNK_ROWS):
            xi = x[start : start + TRSM_CHUNK_ROWS]
            if xi.shape[0] < TRSM_CHUNK_ROWS:
                # pad to the common chunk shape (one executable serves all
                # chunks); padded rows are dropped below
                pad = TRSM_CHUNK_ROWS - xi.shape[0]
                xi = jnp.concatenate([xi, jnp.zeros((pad, x.shape[1]), x.dtype)])
            blocks.append(kernel(xi, xu, Lp))
        return jnp.concatenate(blocks, axis=0)[:n]
    return kernel(x, xu, Lp)


def _standard_low_rank(
    x, cov_func, xu, Lp=None, sigma=DEFAULT_SIGMA, jitter=DEFAULT_JITTER
):
    """Sparse-Cholesky L: triangular solve of the cross-covariance against
    the landmark Cholesky (parity: ``mellon/decomposition.py:174-210``).

    The (n, m) solve maps to a blocked TRSM in XLA; rows of L shard
    naturally over a cells axis.  Very large (n, m) pairs are chunked
    over rows (one shape-stable program reused per chunk).
    """
    if Lp is None:
        Lp = _full_rank(xu, cov_func, sigma=sigma, jitter=jitter)
    return chunked_whiten(x, cov_func, xu, Lp)


@jax.jit
def _nystroem_gram(C):
    """CᵀC at highest matmul precision (full f32)."""
    return jnp.matmul(C.T, C, precision=jax.lax.Precision.HIGHEST)


# below this landmark count the improved Nyström uses exact eigh end to end
# (reference bit-parity; the m³ cost is negligible there)
NYSTROEM_EXACT_MAX = 512
# initial randomized-sketch width for the large-m selection path; doubled
# (rarely) when the fractional-mass rank selection saturates the sketch
NYSTROEM_SKETCH = 512


def _modified_low_rank(
    x, cov_func, xu, rank=DEFAULT_RANK, sigma=DEFAULT_SIGMA, jitter=DEFAULT_JITTER
):
    """Improved Nyström: QR of the cross-covariance, double
    eigendecomposition (parity: ``mellon/decomposition.py:213-266``).

    Device-first redesign for large landmark sets (m > 512): the reference
    takes TWO full m×m eigendecompositions — of W = K_uu and of
    M = R W⁻¹ Rᵀ — which hit iterative eigh's worst case (wide kernels
    have near-degenerate spectra), plus a QR of the (n, m) cross-covariance.
    Instead W is Cholesky-factorized (with safe_cholesky's f32 rescue
    ladder) and the whitened features H = C Lp⁻ᵀ carry the identity
    C W⁻¹ Cᵀ = H Hᵀ: the fractional-mass rank selection runs on the
    whitened Gram HᵀH — whose nonzero spectrum equals the reference's
    M — and L = H U.  No m×m eigh, no n×m QR, no inverse-sqrt of noisy
    eigenvalues; see :func:`_nystroem_select_and_project` for the
    accuracy comparison against the earlier sketch-whitening design.
    """
    m = xu.shape[0]
    if m <= NYSTROEM_EXACT_MAX:
        sigma2 = jnp.square(sigma)
        sigma2 = jnp.where(sigma2 < jitter, jitter, sigma2)
        W = stabilize(cov_func(xu, xu), sigma2)
        C = cov_func(x, xu)
        Q, R = jnp.linalg.qr(C, mode="reduced")
        s, v = _eigendecomposition(W, rank=m)
        T = R @ v
        S, V = _eigendecomposition(T / s @ T.T, rank=rank)
        # see _full_decomposition_low_rank: quantized ranks may include
        # non-positive eigenvalues; clip so the extra columns are zero
        return Q @ V * jnp.sqrt(jnp.maximum(S, 0.0))
    # ---- large m: Cholesky-whitened improved Nyström -----------------------
    # Writing H = C Lp⁻ᵀ with Lp = chol(W) gives C W⁻¹ Cᵀ = H Hᵀ exactly,
    # so the fractional-mass selection runs on the SMALL whitened Gram
    # HᵀH — whose nonzero spectrum equals the reference's M = R W⁻¹ Rᵀ —
    # and L = H U.  Compared to whitening through a W-eigendecomposition
    # (rsqrt of sketch eigenvalues), the triangular solve amplifies NO f32
    # spectral noise: on the 2,000-landmark bench shape the eigensolver
    # route certified corr 0.996 vs host-f64 while this route certifies
    # 0.999998, and it reuses the TRSM/Cholesky programs the sparse path
    # already loads.  The f32 rescue is safe_cholesky's ladder (escalated
    # jitter, then one host-f64 factorization); the fused prepare
    # (models/fused.py) prunes to the pivoted landmark subset instead.
    max_tries = 0 if x.dtype == jnp.float64 else 3
    K = cov_func(xu, xu)
    if isinstance(sigma, (int, float)):
        eff_jitter = max(float(sigma) ** 2, jitter)
    else:
        # per-element noise floor: stabilize the diagonal with
        # max(sigma_i^2, jitter) elementwise (broadcast like the reference's
        # stabilize + add_variance), then factorize without extra jitter on
        # the first attempt
        sigma2 = jnp.maximum(jnp.square(jnp.asarray(sigma)), jitter)
        idx = jnp.arange(K.shape[0])
        K = K.at[idx, idx].add(sigma2)
        eff_jitter = 0.0
    Lp = safe_cholesky(K, jitter=eff_jitter, max_tries=max_tries)
    # row-chunked whitening: the (n, m) kernel+TRSM program at large n AND
    # large m otherwise allocates >1 GB transposed panels
    H = chunked_whiten(x, cov_func, xu, Lp)
    return _nystroem_select_and_project(H, rank)


@jax.jit
def _matmul_highest(A, B):
    return jnp.matmul(A, B, precision=jax.lax.Precision.HIGHEST)


# above this whitened-basis width the mass selection uses the randomized
# sketch of the Gram instead of a direct (QDWH) eigh
NYSTROEM_DIRECT_EIGH_MAX = 1024


def _nystroem_select_and_project(H, rank):
    """Fractional-mass rank selection on the whitened Gram HᵀH and the
    projection L = H U — shared by the lazy :func:`_modified_low_rank`
    large-m path and the fused prepare
    (``models/fused.py:maybe_fused_nystroem_prepare``)."""
    G = _nystroem_gram(H)
    m = G.shape[0]
    if m <= NYSTROEM_DIRECT_EIGH_MAX:
        S, U, raw_p = _eigendecomposition(
            G, rank=rank, with_raw_rank=True, force_quantize=True
        )
        basis = m
    else:
        # the whitened Gram decays fast (0.999 of its mass typically sits
        # in well under NYSTROEM_SKETCH directions), so a sketch suffices
        # for the selection; saturation (near-flat spectra) doubles it
        sketch = min(m, NYSTROEM_SKETCH)
        if isinstance(rank, int):
            sketch = min(m, max(sketch, 2 * rank))
        while True:
            s_all, v_all = randomized_eigh(G, sketch)
            S, U, raw_p = _select_eigenpairs(
                s_all, v_all, rank, m, with_raw_rank=True, force_quantize=True
            )
            if raw_p < (3 * sketch) // 4 or sketch >= m:
                break
            logger.info(
                "Nyström mass selection saturated the %d-column sketch "
                "(selected %d); doubling the sketch.",
                sketch,
                raw_p,
            )
            sketch = min(2 * sketch, m)
        basis = sketch
    logger.info(
        "Cholesky-whitened Nyström eigensolver: rank %d from the "
        "%d-column whitened basis of %d landmarks.",
        S.shape[0],
        basis,
        m,
    )
    return _matmul_highest(H, U)


@partial(jax.jit, static_argnames=("max_rank",))
def _pivoted_cholesky(K, rel_tol, max_rank):
    """Greedy diagonally-pivoted partial Cholesky of a PSD matrix.

    Returns (pivots (max_rank,), r, L (m, max_rank)): after r steps the
    selected pivot rows/columns capture the matrix to relative tolerance
    ``rel_tol`` on the residual diagonal.  One compiled while_loop; each step
    is an O(m · max_rank) matvec.
    """
    m = K.shape[0]
    diag0 = jnp.diagonal(K)
    thresh = rel_tol * jnp.max(diag0)

    def cond(state):
        k, d, L, piv = state
        return (k < max_rank) & (jnp.max(d) > thresh)

    def body(state):
        k, d, L, piv = state
        p = jnp.argmax(d)
        dp = d[p]
        # residual column p: K[:, p] - L[:, :k] @ L[p, :k]  (zeros beyond k)
        col = K[:, p] - L @ L[p, :]
        l_col = col / jnp.sqrt(dp)
        d = jnp.maximum(d - jnp.square(l_col), 0.0)
        d = d.at[p].set(0.0)
        L = L.at[:, k].set(l_col)
        piv = piv.at[k].set(p.astype(piv.dtype))
        return k + 1, d, L, piv

    k0 = 0
    L0 = jnp.zeros((m, max_rank), dtype=K.dtype)
    piv0 = jnp.zeros((max_rank,), dtype=jnp.int32)
    r, _, L, piv = jax.lax.while_loop(cond, body, (k0, diag0, L0, piv0))
    return piv, r, L


RANK_BUCKETS = (64, 128, 256, 512, 1024, 2048, 4096, 8192)


def select_stable_landmarks(K, rel_tol=PIVOT_REL_TOL, max_rank=None, quantize=True):
    """Greedy landmark subset whose kernel submatrix is f32-factorizable.

    For wide kernels over thousands of landmarks, K_uu is numerically
    rank-deficient in f32; the diagonally-pivoted partial Cholesky picks the
    maximally informative subset (the dropped landmarks are linearly
    redundant at the given tolerance), so the sparse-GP model can simply use
    fewer, better-conditioned inducing points — entirely on device.  This is
    the "modified incomplete Cholesky" rank reduction of the north star
    (BASELINE.json).

    ``quantize=True`` rounds the selected count DOWN to a power-of-two
    bucket: the dropped pivots are the least informative, and the stable
    shape means every downstream executable (TRSM, warm start, optimizer)
    is reused across fits instead of recompiling per dataset.

    Returns the pivot indices as a host array.
    """
    m = K.shape[0]
    if max_rank is None:
        # iterative doubling: each pivot step streams the (m, max_rank)
        # factor, so a tight cap cuts the loop's bandwidth ~m/cap-fold.
        # Typical kernel numerical ranks are far below m; if the cap is hit
        # (r == cap means the tolerance was not reached) double and rerun.
        cap = min(m, 1024)
        while True:
            piv, r, _ = _pivoted_cholesky(K, rel_tol, int(cap))
            r, piv = jax.device_get((r, piv))
            r = int(r)
            if r < cap or cap >= m:
                break
            cap = min(2 * cap, m)
    else:
        piv, r, _ = _pivoted_cholesky(K, rel_tol, int(max_rank))
        # one host transfer for the count and the pivot list together
        r, piv = jax.device_get((r, piv))
        r = int(r)
    if quantize:
        buckets = [b for b in RANK_BUCKETS if b <= r]
        if buckets:
            r = buckets[-1]
    logger.info(
        "Pivoted Cholesky selected %d of %d landmarks "
        "(relative tolerance %.0e).",
        r,
        m,
        rel_tol,
    )
    import numpy as np

    return np.asarray(piv[:r])


def host_cholesky_f64(K, jitter=DEFAULT_JITTER, max_tries=8):
    """Lower Cholesky of ``K`` computed on the host in float64 with
    geometric jitter escalation (x10 per retry from max(jitter, 1e-12)).

    Shared rescue primitive for f32-singular PSD kernels (used by
    safe_cholesky's final fallback, the landmarks-conditional host rescue,
    and the batched ls_time fits).  Accepts a numpy or JAX array; returns
    a float64 numpy array.  Raises numpy.linalg.LinAlgError when the
    matrix is not factorizable within the escalation budget.
    """
    import numpy as np

    A = np.asarray(jax.device_get(K), dtype=np.float64)
    m = A.shape[0]
    hj = max(float(jitter), 1e-12)
    for _ in range(max_tries):
        try:
            R = np.linalg.cholesky(A + hj * np.eye(m))
            if hj > max(float(jitter), 1e-12):
                # Silent escalation would hide a badly conditioned matrix
                # behind a degraded factor (a preconditioner built with
                # 1e3x the requested jitter no longer whitens) — say so.
                logger.warning(
                    "Host f64 Cholesky needed jitter escalation to %.1e "
                    "(requested %.1e); the factor is valid but the matrix "
                    "is ill-conditioned at the requested regularization.",
                    hj,
                    float(jitter),
                )
            return R
        except np.linalg.LinAlgError:
            hj *= 10
    import numpy.linalg as _nl

    raise _nl.LinAlgError(
        "Matrix not factorizable on the host in float64 even after "
        f"{max_tries} jitter escalations."
    )


def solve_psd_from_cholesky(L, b):
    """Solve (L Lᵀ) z = b given lower Cholesky factor L."""
    return solve_triangular(L.T, solve_triangular(L, b, lower=True))


@jax.jit
def ridge_solve(L, target, alpha=1.0):
    """Minimize ||L z - target||² + alpha ||z||² on device.

    Replaces sklearn's host-side Ridge warm start
    (``mellon/parameters.py:877-896``).  Solved via the normal equations with
    a Cholesky of (LᵀL + alpha I) — an m x m matmul + factorization,
    fused into one program.
    """
    m = L.shape[1]
    G = L.T @ L + alpha * jnp.eye(m, dtype=L.dtype)
    Lc = jnp.linalg.cholesky(G)
    rhs = L.T @ target
    return solve_psd_from_cholesky(Lc, rhs)
