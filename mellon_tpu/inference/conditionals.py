"""Conditional-GP predictors: three conditioning families × three flavors.

Behavioural parity target: ``mellon/conditional.py`` (975 LoC):

* :class:`_FullConditional` — exact conditioning on all training points
  (``mellon/conditional.py:183-441``);
* :class:`_LandmarksConditional` — Nyström/SoR conditioning through inducing
  points with the sigma-adjusted sparse solve
  (``mellon/conditional.py:455-735``);
* :class:`_LandmarksConditionalCholesky` — latents live on the landmarks,
  weights = Lᵀ⁻¹ z (``mellon/conditional.py:750-963``).

Each family provides ``_mean``, ``_covariance``, ``_mean_covariance``,
``_leverage`` (hat-matrix diagonal), and ``_obs_variance`` (HC3-corrected
residuals smoothed by a second GP), plus per-feature / per-observation sigma
via vmapped per-column solves.  All solves are XLA Cholesky/TRSM on device.
"""

import logging
from functools import partial

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular

from ..ops.linalg import DEFAULT_SIGMA
from ..utils.util import DEFAULT_JITTER, add_variance, ensure_2d, stabilize
from .predictors import ExpPredictor, Predictor, PredictorTime

logger = logging.getLogger("mellon_tpu")


def _hp(a, b):
    """Matrix product at HIGHEST precision.  Conditional algebra combines
    kernel values with solve outputs (weights/factors) that can reach ~1e3
    in magnitude for ill-conditioned landmark kernels; a reduced-precision
    matrix-matrix product (bf16 or TF32) would inject O(1) error there (a
    matvec stays accurate, which masked this until multi-output fits).
    These products are small (n_new x m x p), so the cost is negligible."""
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


@partial(jax.jit, static_argnames=("spec",))
def _fused_mean_spec(spec, params, Xnew, base, weights, mu):
    from ..ops.kernels import eval_operand_spec

    Kus = eval_operand_spec(spec, params, Xnew, base)
    return mu + jnp.matmul(Kus, weights, precision=jax.lax.Precision.HIGHEST)


def _conditional_mean(cov_func, Xnew, base, weights, mu):
    """Conditional mean ``mu + K(Xnew, base) @ weights`` as ONE fused
    program, spec-keyed like the factorization path (the kernel structure
    is the static key, its length scales are runtime operands): the
    distance -> kernel elementwise chain fuses into the matmul instead of
    materializing each (n_new, m) intermediate in HBM, and a serving
    process pays one program load per query shape instead of one dispatch
    per op.  Kernels without an operand spec (user-defined) evaluate
    eagerly as before."""
    try:
        spec, params = cov_func.operand_spec()
    except (NotImplementedError, AttributeError):
        return mu + _hp(cov_func(Xnew, base), weights)
    return _fused_mean_spec(spec, tuple(params), Xnew, base, weights, mu)


@partial(jax.jit, static_argnames=("spec",))
def _fused_cov_diag_spec(spec, params, Xnew, base, L, kss):
    from ..ops.kernels import eval_operand_spec

    Kus = eval_operand_spec(spec, params, base, Xnew)
    A = solve_triangular(L, Kus, lower=True)
    return kss - jnp.sum(jnp.square(A), axis=0)


def _conditional_cov_diag(cov_func, Xnew, base, L):
    """Posterior diag covariance ``k(x,x) - colsum(sq(trsm(L, K)))`` as one
    fused spec-keyed program (serving path; same design as
    :func:`_conditional_mean`).  Conditionals that carry a sparse
    correction term use :func:`_conditional_cov_diag2` instead.  Falls
    back to eager evaluation for kernels without an operand spec."""
    kss = cov_func.diag(Xnew)
    try:
        spec, params = cov_func.operand_spec()
    except (NotImplementedError, AttributeError):
        A = solve_triangular(L, cov_func(base, Xnew), lower=True)
        return kss - jnp.sum(jnp.square(A), axis=0)
    return _fused_cov_diag_spec(spec, tuple(params), Xnew, base, L, kss)


@partial(jax.jit, static_argnames=("spec",))
def _fused_cov_diag2_spec(spec, params, Xnew, base, L, Cs, kss):
    from ..ops.kernels import eval_operand_spec

    Kus = eval_operand_spec(spec, params, base, Xnew)
    A = solve_triangular(L, Kus, lower=True)
    C = solve_triangular(Cs, Kus, lower=True)
    return (
        kss
        - jnp.sum(jnp.square(A), axis=0)
        + jnp.sum(jnp.square(C), axis=0)
    )


def _conditional_cov_diag2(cov_func, Xnew, base, L, Cs):
    """Nyström-residual diag + sparse correction (two TRSMs against the
    same cross-kernel) as one fused spec-keyed program."""
    kss = cov_func.diag(Xnew)
    try:
        spec, params = cov_func.operand_spec()
    except (NotImplementedError, AttributeError):
        Kus = cov_func(base, Xnew)
        A = solve_triangular(L, Kus, lower=True)
        C = solve_triangular(Cs, Kus, lower=True)
        return (
            kss
            - jnp.sum(jnp.square(A), axis=0)
            + jnp.sum(jnp.square(C), axis=0)
        )
    return _fused_cov_diag2_spec(spec, tuple(params), Xnew, base, L, Cs, kss)


@partial(jax.jit, static_argnames=("spec",))
def _fused_mean_cov_diag_spec(spec, params, Xnew, base, W):
    from ..ops.kernels import eval_operand_spec

    Kus = eval_operand_spec(spec, params, Xnew, base)
    cov_L = jnp.matmul(Kus, W, precision=jax.lax.Precision.HIGHEST)
    return jnp.sum(cov_L * cov_L, axis=1)


def _conditional_mean_cov_diag(cov_func, Xnew, base, W):
    """Parameter-uncertainty diag variance ``rowsum(sq(K @ W))`` as one
    fused spec-keyed program, eager fallback without an operand spec."""
    try:
        spec, params = cov_func.operand_spec()
    except (NotImplementedError, AttributeError):
        cov_L = _hp(cov_func(Xnew, base), W)
        return jnp.sum(cov_L * cov_L, axis=1)
    return _fused_mean_cov_diag_spec(spec, tuple(params), Xnew, base, W)


# ---------------------------------------------------------------------------
# sigma-shape disambiguation helpers
# ---------------------------------------------------------------------------

def _is_per_feature_sigma(sigma, y):
    """Detect per-feature sigma shapes (p,), (1, p), (n, p)
    (parity: ``mellon/conditional.py:13-36``)."""
    if sigma is None or jnp.isscalar(sigma) or jnp.ndim(sigma) == 0:
        return False
    if (
        jnp.ndim(sigma) == 2
        and sigma.shape[0] == 1
        and jnp.ndim(y) == 2
        and sigma.shape[1] == y.shape[1]
    ):
        return True
    if jnp.ndim(sigma) == 2 and jnp.ndim(y) == 2 and sigma.shape == y.shape:
        return True
    if jnp.ndim(sigma) == 1 and jnp.ndim(y) == 2 and sigma.shape[0] == y.shape[1]:
        if sigma.shape[0] == y.shape[0]:
            logger.warning(
                f"sigma length {sigma.shape[0]} matches both n_obs and "
                "n_features. Interpreting as per-feature. Pass sigma with "
                "shape (n, 1) for per-observation."
            )
        return True
    return False


def _normalize_per_feature_sigma(sigma):
    """(1, p) -> (p,) (parity: ``mellon/conditional.py:39-43``)."""
    if jnp.ndim(sigma) == 2 and sigma.shape[0] == 1:
        return jnp.squeeze(sigma, axis=0)
    return sigma


def _check_covariance(obj):
    if not hasattr(obj, "L"):
        raise ValueError(
            "The predictor was computed without covariance. "
            "Recompute setting `with_uncertainty=True.`"
        )


def _check_uncertainty(obj):
    if not hasattr(obj, "W"):
        raise ValueError(
            "The predictor was computed without uncertainty, e.g., using ADVI. "
            "Recompute setting `with_uncertainty=True.` and define "
            "`pre_transformation_std`, e.g., by using `optimizer='advi'`."
        )


def _check_obs_variance(obj):
    if not hasattr(obj, "variance_weights"):
        raise ValueError(
            "The predictor was computed without obs_variance. "
            "Recompute setting `obs_variance=True`."
        )


def _get_L(x, cov_func, jitter=DEFAULT_JITTER, y_cov_factor=None, K=None):
    """Cholesky of k(x,x)+noise with the reference's NaN error semantics
    (parity: ``mellon/conditional.py:69-81``)."""
    from ..ops.linalg import safe_cholesky

    if K is None:
        K = cov_func(x, x)
    K = add_variance(K, y_cov_factor, jitter=jitter)
    # In f32 (the device default) the factorization escalates jitter and finally
    # clamps the spectrum before failing; the reference runs f64 where the
    # first attempt virtually always succeeds.
    max_tries = 0 if K.dtype == jnp.float64 else 3
    # K already carries the noise/jitter on its diagonal
    return safe_cholesky(K, jitter=0.0, max_tries=max_tries)


# above this many Kuf elements the host-f64 rescue solve would move too
# much data; fall back to landmark pruning instead
HOST_F64_BUDGET = 250_000_000


def _host_f64_landmarks_weights(K, Kuf, r, sigma, jitter, y_is_mean, per_feature):
    """Weights of the landmarks conditional computed on the host in float64.

    Rescue path for f32-singular landmark kernels: jitter escalation lets
    the on-device factorization "succeed" while destroying accuracy (the
    regularized solve needs directions that f32 Cholesky cannot resolve),
    but the f32-rounded kernel VALUES retain ample information — refactoring
    and solving them in f64 reproduces the reference's f64 pipeline (RMSE
    verified to match to ~1e-3 of the data scale where escalated-jitter f32
    was 30x off).  float64 is unavailable in-process when x64 is disabled,
    so this runs in plain numpy on the host; the m x m / m x n algebra is
    small at gene-trend scales.

    Returns (weights, L_B, Lp, A) as float64 numpy arrays (caller casts;
    A is returned so downstream algebra reuses the accurate f64 solve
    instead of re-solving against the ill-conditioned factor in f32).
    """
    import numpy as np

    try:
        from scipy.linalg import solve_triangular as np_trsm
    except Exception:  # pragma: no cover - scipy is present in practice
        def np_trsm(a, b, lower=False, trans=0):
            op = a.T if trans in (1, "T") else a
            return np.linalg.solve(op, b)

    from ..ops.linalg import host_cholesky_f64

    Kuf = np.asarray(Kuf, dtype=np.float64)
    r = np.asarray(r, dtype=np.float64)
    m = np.shape(K)[0]
    # the f32-rounded kernel values can leave eigenvalues slightly below
    # -jitter; escalation in f64 is benign (verified: rmse degrades only
    # ~50% even at 1e-3, vs 30x for the f32 escalation this path replaces)
    Lp = host_cholesky_f64(K, jitter=jitter)
    A = np_trsm(Lp, Kuf, lower=True)
    eye = np.eye(m)

    def solve_one(A_l, r_l):
        LBB = A_l @ A.T + eye
        L_B = np.linalg.cholesky(LBB)
        c = np_trsm(L_B, A @ r_l, lower=True)
        w = np_trsm(Lp.T, np_trsm(L_B.T, c))
        return w, L_B

    # S = A Aᵀ is the O(m²n) term; every scalar-weighted branch reuses it
    # (A_l Aᵀ = S/σ² exactly) so per-feature fits pay it once, not p times
    def solve_scaled(inv_s2, r_l):
        L_B = np.linalg.cholesky(S * inv_s2 + eye)
        c = np_trsm(L_B, A @ r_l, lower=True)
        w = np_trsm(Lp.T, np_trsm(L_B.T, c))
        return w, L_B

    if per_feature:
        sigma_arr = np.asarray(sigma, dtype=np.float64)
        S = None if sigma_arr.ndim == 2 else A @ A.T
        cols = []
        for j in range(r.shape[1]):
            if sigma_arr.ndim == 2:
                s2 = np.square(sigma_arr[:, j])
                w, _ = solve_one(A / s2, r[:, j] / s2)
            else:
                s2 = float(sigma_arr[j]) ** 2
                w, _ = solve_scaled(1.0 / s2, r[:, j] / s2)
            cols.append(w)
        return np.stack(cols, axis=1), None, Lp, A
    if y_is_mean:
        S = A @ A.T
        return (*solve_scaled(1.0, r), Lp, A)
    sigma_arr = np.asarray(sigma, dtype=np.float64)
    if sigma_arr.ndim == 0:
        s2 = float(sigma_arr) ** 2
        S = A @ A.T
        return (*solve_scaled(1.0 / s2, r / s2), Lp, A)
    if sigma_arr.shape == r.shape[:1] and r.ndim == 1:
        # element-wise noise; 2-D residuals with a length-n sigma are an
        # unsupported configuration on the device path too
        s2 = np.square(sigma_arr)
        return (*solve_one(A / s2, r / s2), Lp, A)
    if sigma_arr.shape == (r.shape[0], r.shape[0]):
        L_s = np.linalg.cholesky(sigma_arr + jitter * np.eye(r.shape[0]))
        r_l = np_trsm(L_s.T, np_trsm(L_s, r, lower=True))
        A_l = np_trsm(L_s.T, np_trsm(L_s, A.T, lower=True)).T
        return (*solve_one(A_l, r_l), Lp, A)
    raise ValueError("Unsupported sigma configuration.")


def _landmarks_lp_with_pruning(xu, cov_func, jitter, K=None, known_singular=False):
    """Landmark Cholesky with f32 pruning: when the landmark kernel is
    numerically singular in f32 (wide kernels over many landmarks), prune
    to the pivoted-Cholesky-selected subset instead of escalating jitter —
    escalation succeeds numerically but destroys the conditional's accuracy
    (observed 30x RMSE inflation on a FunctionEstimator fit), while the
    pruned subset reproduces the f64 fit.  Mirrors the density models'
    ``_compute_Lp`` pruning.  Returns (possibly pruned xu, Lp)."""
    from ..ops.linalg import (
        _jittered_cholesky,
        safe_cholesky,
        select_stable_landmarks,
    )

    if K is None:
        K = cov_func(xu, xu)
    if K.dtype == jnp.float64:
        return xu, _get_L(xu, cov_func, jitter, K=K)
    if not known_singular:
        L, ok = _jittered_cholesky(K, jnp.asarray(jitter, dtype=K.dtype))
        if bool(ok):
            return xu, L
    piv = select_stable_landmarks(K)
    logger.warning(
        "Landmark kernel is singular at f32; pruning %d "
        "redundant landmarks (keeping %d).",
        xu.shape[0] - len(piv),
        len(piv),
    )
    xu = xu[piv]
    K_sub = K[piv][:, piv]
    return xu, safe_cholesky(K_sub, jitter=jitter, max_tries=3)


def _sigma_to_y_cov_factor(sigma, y_cov_factor, n):
    """Lift sigma to a covariance left-factor
    (parity: ``mellon/conditional.py:101-135``)."""
    if sigma is None and y_cov_factor is None:
        message = (
            "No input uncertainty specified. Make sure to set `sigma` or "
            "`pre_transformation_std`, "
            'e.g., by using `optimizer="advi", to quantify uncertainty '
            "of the prediction."
        )
        logger.error(message)
        raise ValueError(message)
    if y_cov_factor is not None and sigma is not None and bool(jnp.any(sigma > 0)):
        raise ValueError(
            "One can specify either `sigma` or `y_cov_factor` to describe "
            "input noise, but not both."
        )
    if y_cov_factor is not None:
        return y_cov_factor

    if jnp.ndim(sigma) == 2 and jnp.shape(sigma) == (n, 1):
        # (n, 1) per-observation sigma (the shape the ambiguity warning
        # recommends) lifts like a 1-D per-observation vector
        sigma = jnp.ravel(sigma)
    sigma_ndim = jnp.ndim(sigma)
    if sigma_ndim == 0:
        return jnp.eye(n) * sigma
    if sigma_ndim == 1:
        return jnp.diag(sigma)
    if sigma_ndim > 1:
        y_cov_factor = jnp.zeros((n,) + sigma.shape)

        def update_diag(i, ycf, val):
            return ycf.at[i, ...].set(val)

        return jax.vmap(update_diag, in_axes=(0, 0, 0), out_axes=0)(
            jnp.arange(n), y_cov_factor, sigma
        )
    raise ValueError(f"Unsupported `sigma` dimensions `{sigma_ndim}`.")


def _process_sigma(sigma, r, A, jitter=DEFAULT_JITTER):
    """Interpret sigma (scalar / element-wise / full covariance) and return
    sigma-adjusted (r_l, A_l) (parity: ``mellon/conditional.py:138-180``).

    sigma² is floored at ``jitter`` — the same floor ``add_variance``
    applies on the full-conditional path — so the documented default
    sigma=0 conditions near-noiselessly instead of dividing by zero (the
    reference silently returns all-NaN predictions for a default-sigma
    sparse FunctionEstimator; deliberate fix)."""
    if jnp.ndim(sigma) == 2 and sigma.shape == (jnp.shape(r)[0], 1):
        # (n, 1) per-observation sigma — the shape the ambiguity warning
        # in _is_per_feature_sigma recommends
        sigma = jnp.ravel(sigma)
    if jnp.isscalar(sigma) or (sigma.shape == r.shape and r.ndim <= 1) or (
        jnp.ndim(sigma) == 1 and sigma.shape[0] == jnp.shape(r)[0]
    ):
        logger.info("Sigma interpreted as element-wise standard deviation.")
        sigma2 = jnp.maximum(jnp.square(sigma), jitter)
        if jnp.ndim(sigma2) == 1 and jnp.ndim(r) > 1:
            r_l = r / sigma2[:, None]
        else:
            r_l = r / sigma2
        A_l = A / sigma2
    elif sigma.shape == r.shape and r.ndim > 1:
        logger.error("Sigma as distinct noise per output is not implemented.")
        raise NotImplementedError(
            "FunctionEstimator not implemented for multiple noises."
        )
    elif sigma.shape == (r.shape[0],) + r.shape and r.ndim > 1:
        logger.error(
            "Sigma as distinct covariance matrix per output is not implemented."
        )
        raise NotImplementedError(
            "FunctionEstimator not implemented for multiple covariance matrices."
        )
    elif sigma.shape == (r.shape[0], r.shape[0]):
        logger.info("Sigma interpreted as full covariance matrix.")
        L_s = jnp.linalg.cholesky(stabilize(sigma, jitter))
        r_l = solve_triangular(L_s.T, solve_triangular(L_s, r, lower=True))
        # whiten A's observation axis (columns): A is (m, n) while L_s is
        # (n, n), so the solve runs against A.T (the reference's own branch
        # is shape-inconsistent here for m != n, mellon/conditional.py:175)
        A_l = solve_triangular(
            L_s.T, solve_triangular(L_s, A.T, lower=True)
        ).T
    else:
        raise ValueError("Unsupported sigma configuration.")
    return r_l, A_l


def _sparse_solve(Lp, A, r_l, A_l):
    """Sparse-GP weight solve: B = I + A_l Aᵀ, weights = Lpᵀ⁻¹ L_Bᵀ⁻¹ L_B⁻¹ A r_l
    (parity: ``mellon/conditional.py:57-66``).  Returns (weights, L_B)."""
    LBB = stabilize(_hp(A_l, A.T), 1)
    L_B = jnp.linalg.cholesky(LBB)
    c = solve_triangular(L_B, _hp(A, r_l), lower=True)
    weights = solve_triangular(Lp.T, solve_triangular(L_B.T, c))
    return weights, L_B


def _leverage_sigma_is_per_feature(conditional, sigma, n_eval):
    """Classify an ad-hoc leverage sigma as per-feature vs per-observation.

    ``_leverage(Xnew, sigma)`` accepts a sigma that may differ from the
    constructor's, so the stored ``per_feature_sigma`` flag only applies
    when the shapes match; otherwise a 1-D sigma whose length equals the
    number of evaluation points is per-observation and anything else is
    per-feature (mirroring ``_is_per_feature_sigma``'s shape rules)."""
    if jnp.ndim(sigma) == 0:
        return False
    stored = getattr(conditional, "sigma", None)
    if (
        stored is not None
        and jnp.ndim(stored) == jnp.ndim(sigma)
        and jnp.shape(stored) == jnp.shape(sigma)
    ):
        # the stored flag wins, including for a full-covariance (n, n)
        # sigma (per_feature_sigma=False), which the leverage formulas
        # reject with an informative error downstream
        return bool(getattr(conditional, "per_feature_sigma", False))
    if jnp.ndim(sigma) == 2:
        return True
    if jnp.shape(sigma)[0] == n_eval:
        return False
    return True


def _hat_diagonal(B, K_uu, sigma, jitter, per_feature=False):
    """Sparse-GP hat diagonal, validated against its physical range.

    Scalar sigma: h = diag(B M⁻¹ Bᵀ), M = sigma² K_uu + BᵀB.  Per-feature
    sigma (p,) vmaps that over features and returns (n, p).  Per-observation
    sigma (n,) uses the heteroscedastic form h = diag(B M⁻¹ Bᵀ D⁻¹) with
    D = diag(sigma²), M = K_uu + Bᵀ D⁻¹ B (which reduces to the scalar
    formula when all sigmas are equal); an (n, p) sigma vmaps that over
    feature columns.  The dispatch is by the caller's explicit
    ``per_feature`` flag — the reference dispatches on ``ndim(sigma)``
    alone (``mellon/conditional.py:599-610``), silently treating a
    per-observation (n,) sigma as per-feature and producing an (n, n)
    leverage surface; deliberate fix.

    When the landmark kernel is f32-singular, M inherits the ~1e12
    condition number and the f32 inverse corrupts h grossly (observed
    h < -1; the HC3 obs-variance correction divides by (1-h)²).  The
    device result is therefore range-checked and recomputed on the host in
    float64 when it leaves [0, 1] — the same rescue discipline as the
    conditional weights, self-validating so it also protects deserialized
    predictors."""
    n = B.shape[0]

    def _check_per_obs_length(k):
        if k != n:
            raise ValueError(
                f"Per-observation sigma has length {k} but leverage is "
                f"evaluated at {n} points; per-observation noise is only "
                "defined at the training geometry."
            )

    def _dev_scalar(sigma_g):
        M = stabilize(sigma_g**2 * K_uu + _hp(B.T, B), jitter)
        return jnp.sum(_hp(B, jnp.linalg.inv(M)) * B, axis=1)

    def _dev_per_obs(sigma_col):
        # floored at jitter so a zero noise entry cannot divide by zero
        inv_s2 = 1.0 / jnp.maximum(jnp.square(sigma_col), jitter)
        Bw = B * inv_s2[:, None]
        M = stabilize(K_uu + _hp(B.T, Bw), jitter)
        return jnp.sum(_hp(B, jnp.linalg.inv(M)) * Bw, axis=1)

    if not per_feature and jnp.ndim(sigma) == 2 and jnp.shape(sigma)[1] == 1:
        sigma = jnp.ravel(sigma)  # (n, 1) per-observation
    if per_feature and jnp.ndim(sigma) == 2:
        _check_per_obs_length(sigma.shape[0])
        h = jax.vmap(_dev_per_obs, in_axes=1, out_axes=1)(sigma)
    elif per_feature:
        h = jax.vmap(_dev_scalar)(jnp.atleast_1d(sigma)).T
    elif jnp.ndim(sigma) >= 2:
        raise NotImplementedError(
            "Leverage with a full-covariance sigma is not supported; "
            "supply a scalar, per-feature, or per-observation sigma."
        )
    elif jnp.ndim(sigma) == 1:
        sigma_obs = jnp.ravel(sigma)
        _check_per_obs_length(sigma_obs.shape[0])
        h = _dev_per_obs(sigma_obs)
    else:
        h = _dev_scalar(sigma)
    if h.dtype == jnp.float64:
        return h
    tol = 1e-3
    # jnp.all of the in-range test (not jnp.any of the violation) so NaN/Inf
    # results also fail the check and take the rescue
    if bool(jnp.all((h >= -tol) & (h <= 1 + tol))):
        return h
    import numpy as np

    logger.warning(
        "Leverage left [0, 1] on the f32 path (ill-conditioned landmark "
        "kernel); recomputing on the host in float64."
    )
    B64 = np.asarray(B, dtype=np.float64)
    K64 = np.asarray(K_uu, dtype=np.float64)
    m = K64.shape[0]
    eye = np.eye(m)
    s64 = np.asarray(sigma, dtype=np.float64)

    def _host_scalar(s):
        M64 = s**2 * K64 + B64.T @ B64 + float(jitter) * eye
        return np.sum(B64 @ np.linalg.inv(M64) * B64, axis=1)

    def _host_per_obs(s_col):
        Bw64 = B64 / np.square(s_col)[:, None]
        M64 = K64 + B64.T @ Bw64 + float(jitter) * eye
        return np.sum(B64 @ np.linalg.inv(M64) * Bw64, axis=1)

    if per_feature and s64.ndim == 2:
        h64 = np.stack([_host_per_obs(s64[:, g]) for g in range(s64.shape[1])], axis=1)
    elif per_feature:
        h64 = np.stack([_host_scalar(s) for s in np.atleast_1d(s64)], axis=1)
    elif s64.ndim >= 1:
        h64 = _host_per_obs(s64.ravel())
    else:
        h64 = _host_scalar(s64)
    # Genuine h -> 1 (zero-noise interpolation) is a statistical degeneracy:
    # the HC3 correction divides by (1-h)^2, so clipping would silently
    # manufacture a finite correction where none exists.  Surface it loudly
    # before bounding the numerical overshoot strictly below 1.
    n_degenerate = int(np.sum(h64 >= 1.0 - 1e-6))
    if n_degenerate:
        logger.warning(
            "%d observation(s) have leverage ~1 even in float64 "
            "(zero-noise interpolation): the HC3 observation-variance "
            "correction is undefined there and will be reported at its "
            "clipped ceiling. Increase sigma (observation noise) or reduce "
            "landmark density to resolve the degeneracy.",
            n_degenerate,
        )
    return jnp.asarray(np.clip(h64, 0.0, 1.0 - 1e-6), dtype=h.dtype)


# ---------------------------------------------------------------------------
# full conditional
# ---------------------------------------------------------------------------

class _FullConditional:
    """Exact GP conditioning on all training points
    (parity: ``mellon/conditional.py:183-441``)."""

    def __init__(
        self,
        x,
        y,
        mu,
        cov_func,
        L=None,
        sigma=DEFAULT_SIGMA,
        jitter=DEFAULT_JITTER,
        y_cov_factor=None,
        y_is_mean=False,
        with_uncertainty=False,
        obs_variance=False,
    ):
        x = ensure_2d(x)
        original_sigma = sigma
        per_feature = _is_per_feature_sigma(sigma, y)

        K = cov_func(x, x)

        if per_feature:
            sigma_pf = _normalize_per_feature_sigma(sigma)
            n = x.shape[0]
            r = y - mu

            def _solve_one(sigma_g, r_g):
                L_g = jnp.linalg.cholesky(
                    stabilize(K + sigma_g**2 * jnp.eye(n), jitter)
                )
                return solve_triangular(
                    L_g.T, solve_triangular(L_g, r_g, lower=True)
                )

            sigma_in_axis = 1 if jnp.ndim(sigma_pf) == 2 else 0
            weights = jax.vmap(_solve_one, in_axes=(sigma_in_axis, 1), out_axes=1)(
                sigma_pf, r
            )
        else:
            if L is None:
                logger.info(
                    "Recomputing covariance decomposition for predictive function."
                )
                if y_is_mean:
                    L = _get_L(x, cov_func, jitter, K=K)
                else:
                    y_cov_factor = _sigma_to_y_cov_factor(
                        sigma, y_cov_factor, x.shape[0]
                    )
                    sigma = None
                    L = _get_L(x, cov_func, jitter, y_cov_factor, K=K)
            r = y - mu
            weights = solve_triangular(L.T, solve_triangular(L, r, lower=True))

        self.cov_func = cov_func
        self.x = x
        self.weights = weights
        self.mu = mu
        self.jitter = jitter
        self.sigma = original_sigma
        self.per_feature_sigma = per_feature
        self.n_input_features = x.shape[1]
        self.n_obs = x.shape[0]

        self._state_variables = {
            "x", "weights", "mu", "jitter", "sigma", "per_feature_sigma",
        }

        if obs_variance:
            self._compute_obs_variance(
                x, y, mu, cov_func, original_sigma, jitter, weights, K,
                per_feature=per_feature,
            )

        if not with_uncertainty:
            return

        if per_feature:
            # one noise-free Cholesky instead of one per feature
            L = _get_L(x, cov_func, jitter, K=K)
        elif L is None:
            y_cov_factor = _sigma_to_y_cov_factor(sigma, y_cov_factor, x.shape[0])
            sigma = None
            L = _get_L(x, cov_func, jitter, y_cov_factor, K=K)

        self.L = L
        self._state_variables.add("L")

        if not per_feature:
            y_cov_factor = _sigma_to_y_cov_factor(sigma, y_cov_factor, x.shape[0])
            W = solve_triangular(L.T, solve_triangular(L, y_cov_factor, lower=True))
            self.W = W
            self._state_variables.add("W")

    def _compute_obs_variance(
        self, x, y, mu, cov_func, sigma, jitter, weights, K, per_feature=False
    ):
        """HC3-corrected residuals smoothed by a second GP
        (parity: ``mellon/conditional.py:308-364``).

        Deliberate fixes over the reference: dispatch is by the explicit
        ``per_feature`` flag rather than ``ndim(sigma)`` (a per-observation
        (n,) sigma is heteroscedastic noise, handled by the scalar formulas
        element-wise — ``sigma**2 * eye(n)`` broadcasts to diag(sigma²)),
        and the (n, p) per-feature solve vmaps sigma over its FEATURE axis
        (the reference's ``in_axes=(0, 1)`` at ``mellon/conditional.py:352``
        maps sigma over observations, crashing for n != p)."""
        n = x.shape[0]
        prediction = mu + _hp(K, weights)

        def _lev_one(sigma_g):
            # sigma² floored at jitter (as in add_variance): with sigma=0
            # the raw formula gives h = 1 exactly and the HC3 correction
            # divides by (1-h)² = 0
            s2 = jnp.maximum(sigma_g**2, jitter)
            L = jnp.linalg.cholesky(stabilize(K + s2 * jnp.eye(n), jitter))
            Linv = solve_triangular(L, jnp.eye(n), lower=True)
            return 1 - s2 * jnp.sum(jnp.square(Linv), axis=0)

        if per_feature:
            sigma_pf = _normalize_per_feature_sigma(sigma)
            sigma_in_axis = 1 if jnp.ndim(sigma_pf) == 2 else 0
            h = jax.vmap(_lev_one, in_axes=sigma_in_axis, out_axes=1)(sigma_pf)
        else:
            sigma_eff = sigma if jnp.ndim(sigma) == 0 else jnp.ravel(sigma)
            h = _lev_one(sigma_eff)

        residual = y - prediction
        if residual.ndim > h.ndim:
            h = h[..., None]
        corrected_r2 = residual**2 / (1 - h) ** 2

        variance_mu = 0.0

        def _var_solve_one(sigma_g, cr2_g):
            L_var = jnp.linalg.cholesky(
                stabilize(K + sigma_g**2 * jnp.eye(n), jitter)
            )
            return solve_triangular(
                L_var.T,
                solve_triangular(L_var, cr2_g - variance_mu, lower=True),
            )

        if per_feature:
            sigma_pf = _normalize_per_feature_sigma(sigma)
            sigma_in_axis = 1 if jnp.ndim(sigma_pf) == 2 else 0
            variance_weights = jax.vmap(
                _var_solve_one, in_axes=(sigma_in_axis, 1), out_axes=1
            )(sigma_pf, corrected_r2)
        else:
            sigma_eff = sigma if jnp.ndim(sigma) == 0 else jnp.ravel(sigma)
            variance_weights = _var_solve_one(sigma_eff, corrected_r2)

        self.variance_weights = variance_weights
        self.variance_mu = variance_mu
        self._corrected_r2 = corrected_r2
        self._state_variables.add("variance_weights")
        self._state_variables.add("variance_mu")

    def _mean(self, Xnew):
        return _conditional_mean(
            self.cov_func, Xnew, self.x, self.weights, self.mu
        )

    def _leverage(self, Xnew, sigma):
        """h = 1 - sigma² diag((K + sigma² I)⁻¹) at the training geometry
        (parity: ``mellon/conditional.py:375-400``).

        Deliberate fixes over the reference: dispatch by the stored
        ``per_feature_sigma`` flag (a per-observation (n,) sigma takes the
        scalar formula element-wise instead of being vmapped into an
        (n, n) surface), and 2-D per-feature sigma vmaps over its feature
        axis (the reference's default axis-0 vmap at
        ``mellon/conditional.py:397`` crashes for (n, p) sigma)."""
        x = self.x
        jitter = self.jitter
        n = x.shape[0]
        K_train = self.cov_func(x, x)

        def _lev_one(sigma_g):
            # sigma² floored at jitter (see _compute_obs_variance)
            s2 = jnp.maximum(sigma_g**2, jitter)
            L = jnp.linalg.cholesky(
                stabilize(K_train + s2 * jnp.eye(n), jitter)
            )
            Linv = solve_triangular(L, jnp.eye(n), lower=True)
            return 1 - s2 * jnp.sum(jnp.square(Linv), axis=0)

        if Xnew is not None and jnp.shape(Xnew)[0] != n:
            raise ValueError(
                f"Leverage of the full conditional is defined at the "
                f"{n:,} training points but {jnp.shape(Xnew)[0]:,} points "
                "were given (parity: ``mellon/conditional.py:375-400`` "
                "evaluates at the training geometry)."
            )
        if _leverage_sigma_is_per_feature(self, sigma, n):
            sigma = _normalize_per_feature_sigma(sigma)
            sigma_in_axis = 1 if jnp.ndim(sigma) == 2 else 0
            return jax.vmap(_lev_one, in_axes=sigma_in_axis)(sigma).T

        if jnp.ndim(sigma) == 2 and jnp.shape(sigma)[1] == 1:
            sigma = jnp.ravel(sigma)  # (n, 1) per-observation
        if jnp.ndim(sigma) >= 2:
            raise NotImplementedError(
                "Leverage with a full-covariance sigma is not supported; "
                "supply a scalar, per-feature, or per-observation sigma."
            )
        sigma_eff = sigma if jnp.ndim(sigma) == 0 else jnp.ravel(sigma)
        return _lev_one(sigma_eff)

    def _obs_variance(self, Xnew):
        _check_obs_variance(self)
        return _conditional_mean(
            self.cov_func, Xnew, self.x, self.variance_weights,
            self.variance_mu,
        )

    def _covariance(self, Xnew, diag=True):
        _check_covariance(self)
        if diag:
            return _conditional_cov_diag(self.cov_func, Xnew, self.x, self.L)
        Kus = self.cov_func(self.x, Xnew)
        A = solve_triangular(self.L, Kus, lower=True)
        Kss = self.cov_func(Xnew, Xnew)
        return Kss - _hp(A.T, A)

    def _mean_covariance(self, Xnew, diag=True):
        _check_uncertainty(self)
        if diag:
            return _conditional_mean_cov_diag(
                self.cov_func, Xnew, self.x, self.W
            )
        cov_L = _hp(self.cov_func(Xnew, self.x), self.W)
        return _hp(cov_L, cov_L.T)


class FullConditional(_FullConditional, Predictor):
    pass


class ExpFullConditional(_FullConditional, ExpPredictor):
    pass


class FullConditionalTime(_FullConditional, PredictorTime):
    pass


# ---------------------------------------------------------------------------
# landmarks conditional (rank < n_landmarks or noisy y)
# ---------------------------------------------------------------------------

class _LandmarksConditional:
    """Nyström/SoR conditioning through inducing points
    (parity: ``mellon/conditional.py:455-735``)."""

    def __init__(
        self,
        x,
        xu,
        y,
        mu,
        cov_func,
        L=None,
        Lp=None,
        sigma=DEFAULT_SIGMA,
        jitter=DEFAULT_JITTER,
        y_cov_factor=None,
        y_is_mean=False,
        with_uncertainty=False,
        obs_variance=False,
    ):
        x = ensure_2d(x)
        xu = ensure_2d(xu)
        original_sigma = sigma
        per_feature = _is_per_feature_sigma(sigma, y)

        host_rescued = False
        host64 = None
        if Lp is None:
            from ..ops.linalg import _jittered_cholesky

            K = cov_func(xu, xu)
            if K.dtype != jnp.float64:
                Lp, chol_ok = _jittered_cholesky(
                    K, jnp.asarray(jitter, dtype=K.dtype)
                )
                if not bool(chol_ok):
                    n_elem = xu.shape[0] * x.shape[0]
                    # Noise-free mean reconditioning (the density models'
                    # Nyström predictor: y_is_mean, sigma 0/None, no
                    # uncertainty factor) prefers the on-device pivoted
                    # prune: verified 0.005%-of-spread agreement with the
                    # f64 solve on the tutorial-scale Nyström fit, vs a
                    # host-f64 rescue that costs seconds of 2-core BLAS +
                    # O(n·m) transfers.  Noisy/multi-output conditionals
                    # keep the exact-model rescue (3x closer to f64 in the
                    # extreme-singularity test).
                    noise_free_mean = (
                        y_is_mean
                        and y_cov_factor is None
                        and (
                            sigma is None
                            or (jnp.ndim(sigma) == 0 and float(sigma) == 0.0)
                        )
                    )
                    if noise_free_mean:
                        xu, Lp = _landmarks_lp_with_pruning(
                            xu, cov_func, jitter, K=K, known_singular=True
                        )
                    elif n_elem <= HOST_F64_BUDGET:
                        logger.warning(
                            "Landmark kernel is singular at f32; computing "
                            "the conditional weights on the host in float64."
                        )
                        Kuf = cov_func(xu, x)
                        w64, LB64, Lp64, A64 = _host_f64_landmarks_weights(
                            K, Kuf, y - mu, sigma, jitter,
                            y_is_mean, per_feature,
                        )
                        weights = jnp.asarray(w64, dtype=K.dtype)
                        L_B = (
                            None if LB64 is None
                            else jnp.asarray(LB64, dtype=K.dtype)
                        )
                        Lp = jnp.asarray(Lp64, dtype=K.dtype)
                        # the accurate f64 solve, rounded for storage — NOT
                        # an f32 re-solve against the ill-conditioned factor
                        A = jnp.asarray(A64, dtype=K.dtype)
                        host64 = (Lp64, LB64, A64, K)
                        host_rescued = True
                    else:
                        xu, Lp = _landmarks_lp_with_pruning(
                            xu, cov_func, jitter, K=K, known_singular=True
                        )
            else:
                Lp = _get_L(xu, cov_func, jitter, K=K)

        if not host_rescued:
            Kuf = cov_func(xu, x)
            A = solve_triangular(Lp, Kuf, lower=True)
        r = y - mu

        if host_rescued:
            pass
        elif per_feature:
            sigma_pf = _normalize_per_feature_sigma(sigma)

            if jnp.ndim(sigma_pf) == 1:
                # scalar sigma per feature: A_l Aᵀ = S/σ² exactly, so the
                # O(m²n) product runs once instead of once per feature
                S = _hp(A, A.T)
                Ar = _hp(A, r)  # (m, p)

                def _solve_one(sigma_g, Ar_g):
                    sigma2 = jnp.maximum(jnp.square(sigma_g), jitter)
                    LBB = stabilize(S / sigma2, 1)
                    L_B = jnp.linalg.cholesky(LBB)
                    c = solve_triangular(L_B, Ar_g / sigma2, lower=True)
                    return solve_triangular(
                        Lp.T, solve_triangular(L_B.T, c)
                    )

                weights = jax.vmap(_solve_one, in_axes=(0, 1), out_axes=1)(
                    sigma_pf, Ar
                )
            else:
                # (n, p) sigma: the weighting is per observation, so each
                # feature needs its own product
                def _solve_one(sigma_g, r_g):
                    sigma2 = jnp.maximum(jnp.square(sigma_g), jitter)
                    r_l = r_g / sigma2
                    A_l = A / sigma2
                    w, _ = _sparse_solve(Lp, A, r_l, A_l)
                    return w

                weights = jax.vmap(_solve_one, in_axes=(1, 1), out_axes=1)(
                    sigma_pf, r
                )
            L_B = None
        else:
            if y_is_mean:
                r_l, A_l = r, A
            else:
                r_l, A_l = _process_sigma(sigma, r, A, jitter=jitter)
            weights, L_B = _sparse_solve(Lp, A, r_l, A_l)

        self.cov_func = cov_func
        self.landmarks = xu
        self.weights = weights
        self.mu = mu
        self.jitter = jitter
        self.sigma = original_sigma
        self.per_feature_sigma = per_feature
        self.n_input_features = xu.shape[1]
        self.n_obs = x.shape[0]

        self._state_variables = {
            "landmarks", "weights", "mu", "jitter", "sigma", "per_feature_sigma",
        }

        if obs_variance:
            self._compute_obs_variance(
                x, y, xu, mu, cov_func, sigma, jitter, weights, Lp, Kuf, A,
                host64=host64 if host_rescued else None,
                per_feature=per_feature,
            )

        if not with_uncertainty:
            return

        self.L = Lp
        self._state_variables.add("L")

        if not per_feature:
            if host_rescued:
                # keep the product in f64 (both factors came from the host)
                Cs = jnp.asarray(host64[0] @ host64[1], dtype=Lp.dtype)
            else:
                Cs = _hp(Lp, L_B)
            self.Cs = Cs
            self._state_variables.add("Cs")

        if not y_is_mean:
            return

        if per_feature:
            # same contract as _FullConditional: no parameter-uncertainty
            # factor W for per-feature sigma (the per-feature solves have no
            # shared L_B); mean_covariance raises via _check_uncertainty.
            # The reference instead crashes here with an undefined L_B
            # (``mellon/conditional.py:583``); deliberate fix.
            return

        # Lift sigma to a covariance factor when no explicit factor was
        # given — the reference uses y_cov_factor unconditionally and
        # crashes on None (``mellon/conditional.py:582-584``);
        # _FullConditional lifts it the same way (deliberate fix).
        y_l = (
            y_cov_factor
            if y_cov_factor is not None
            else _sigma_to_y_cov_factor(sigma, None, x.shape[0])
        )
        if host_rescued:
            # parameter-uncertainty factor through the accurate f64 solves
            import numpy as _np

            try:
                from scipy.linalg import solve_triangular as _np_trsm
            except Exception:  # pragma: no cover - scipy is present
                def _np_trsm(a, b, lower=False):
                    return _np.linalg.solve(a, b)

            Lp64, LB64, A64, _ = host64
            y64 = _np.asarray(y_l, dtype=_np.float64)
            C64 = _np_trsm(LB64, A64 @ y64, lower=True)
            Z64 = _np_trsm(LB64.T, C64)
            W = jnp.asarray(_np_trsm(Lp64.T, Z64), dtype=Lp.dtype)
        else:
            C = solve_triangular(L_B, _hp(A, y_l), lower=True)
            Z = solve_triangular(L_B.T, C)
            W = solve_triangular(Lp.T, Z)
        self.W = W
        self._state_variables.add("W")

    def _compute_obs_variance(
        self, x, y, xu, mu, cov_func, sigma, jitter, weights, Lp, Kuf, A,
        host64=None, per_feature=False,
    ):
        """Parity: ``mellon/conditional.py:589-649``.

        ``host64`` carries the (Lp, L_B, A, K) float64 factors when the
        conditional was host-rescued (f32-singular landmark kernel): the
        second-GP variance-weight solve then also runs on the host so it
        is not corrupted by the very conditioning the rescue avoids."""
        prediction = mu + _hp(Kuf.T, weights)
        B = Kuf.T  # n x m
        K_uu = _hp(Lp, Lp.T)

        sigma_h = (
            _normalize_per_feature_sigma(sigma)
            if per_feature
            else sigma
        )
        h = _hat_diagonal(B, K_uu, sigma_h, jitter, per_feature=per_feature)

        residual = y - prediction
        if residual.ndim > h.ndim:
            h = h[..., None]
        corrected_r2 = residual**2 / (1 - h) ** 2

        variance_mu = 0.0
        if host64 is not None:
            vw64, _, _, _ = _host_f64_landmarks_weights(
                host64[3], Kuf, corrected_r2 - variance_mu, sigma, jitter,
                False, per_feature,
            )
            variance_weights = jnp.asarray(vw64, dtype=Lp.dtype)
        elif per_feature:
            # dispatch mirrors the weights solve above; the reference vmaps
            # sigma over axis 0 for ANY ndim>=1 (``mellon/conditional.py:
            # 638-641``), which maps an (n, p) sigma over observations and
            # misroutes per-observation (n,) sigma entirely (deliberate fix)
            sigma_pf = _normalize_per_feature_sigma(sigma)
            r_var = corrected_r2 - variance_mu

            def _var_solve_one(sigma_g, r_var_g):
                sigma2 = jnp.maximum(jnp.square(sigma_g), jitter)
                r_l = r_var_g / sigma2
                A_l = A / sigma2
                w, _ = _sparse_solve(Lp, A, r_l, A_l)
                return w

            sigma_in_axis = 1 if jnp.ndim(sigma_pf) == 2 else 0
            variance_weights = jax.vmap(
                _var_solve_one, in_axes=(sigma_in_axis, 1), out_axes=1
            )(sigma_pf, r_var)
        else:
            r_var = corrected_r2 - variance_mu
            r_l, A_l = _process_sigma(sigma, r_var, A, jitter=jitter)
            variance_weights, _ = _sparse_solve(Lp, A, r_l, A_l)

        self.variance_weights = variance_weights
        self.variance_mu = variance_mu
        self._corrected_r2 = corrected_r2
        self._state_variables.add("variance_weights")
        self._state_variables.add("variance_mu")

    def _mean(self, Xnew):
        return _conditional_mean(
            self.cov_func, Xnew, self.landmarks, self.weights, self.mu
        )

    def _leverage(self, Xnew, sigma):
        """Sparse-GP hat diagonal via the m x m system M = sigma² K_uu + BᵀB
        (parity: ``mellon/conditional.py:660-685``)."""
        xu = self.landmarks
        jitter = self.jitter
        B = self.cov_func(Xnew, xu)
        if hasattr(self, "L") and self.L is not None:
            K_uu = _hp(self.L, self.L.T)
        else:
            K_uu = self.cov_func(xu, xu)

        per_feature = _leverage_sigma_is_per_feature(self, sigma, B.shape[0])
        if per_feature:
            sigma = _normalize_per_feature_sigma(sigma)
        return _hat_diagonal(B, K_uu, sigma, jitter, per_feature=per_feature)

    def _obs_variance(self, Xnew):
        _check_obs_variance(self)
        return _conditional_mean(
            self.cov_func,
            Xnew,
            self.landmarks,
            self.variance_weights,
            self.variance_mu,
        )

    def _covariance(self, Xnew, diag=False):
        """Nyström residual + sparse correction CᵀC
        (parity: ``mellon/conditional.py:694-719``)."""
        _check_covariance(self)
        cov_func = self.cov_func
        xu = self.landmarks
        L = self.L

        if self.per_feature_sigma:
            if diag:
                return _conditional_cov_diag(cov_func, Xnew, xu, L)
            Kus = cov_func(xu, Xnew)
            As = solve_triangular(L, Kus, lower=True)
            return cov_func(Xnew, Xnew) - _hp(As.T, As)

        Cs = self.Cs
        if diag:
            return _conditional_cov_diag2(cov_func, Xnew, xu, L, Cs)
        Kus = cov_func(xu, Xnew)
        As = solve_triangular(L, Kus, lower=True)
        C = solve_triangular(Cs, Kus, lower=True)
        return cov_func(Xnew, Xnew) - _hp(As.T, As) + _hp(C.T, C)

    def _mean_covariance(self, Xnew, diag=True):
        _check_uncertainty(self)
        if diag:
            return _conditional_mean_cov_diag(
                self.cov_func, Xnew, self.landmarks, self.W
            )
        cov_L = _hp(self.cov_func(Xnew, self.landmarks), self.W)
        return _hp(cov_L, cov_L.T)


class LandmarksConditional(_LandmarksConditional, Predictor):
    pass


class ExpLandmarksConditional(_LandmarksConditional, ExpPredictor):
    pass


class LandmarksConditionalTime(_LandmarksConditional, PredictorTime):
    pass


# ---------------------------------------------------------------------------
# landmarks-Cholesky conditional (latents on the landmarks)
# ---------------------------------------------------------------------------

class _LandmarksConditionalCholesky:
    """Latents live on the landmarks; weights = Lᵀ⁻¹ z
    (parity: ``mellon/conditional.py:750-963``)."""

    def __init__(
        self,
        xu,
        pre_transformation,
        mu,
        cov_func,
        n_obs,
        L=None,
        sigma=DEFAULT_SIGMA,
        jitter=DEFAULT_JITTER,
        y_is_mean=False,
        with_uncertainty=False,
        obs_variance=False,
        obs_x=None,
        obs_y=None,
    ):
        xu = ensure_2d(xu)
        original_sigma = sigma
        if L is None:
            logger.info(
                "Recomputing covariance decomposition for predictive function."
            )
            if y_is_mean:
                L = _get_L(xu, cov_func, jitter)
            else:
                y_cov_factor = _sigma_to_y_cov_factor(sigma, None, xu.shape[0])
                sigma = None
                L = _get_L(xu, cov_func, jitter, y_cov_factor)

        weights = solve_triangular(L.T, pre_transformation)

        if obs_variance:
            Lp = L if y_is_mean else _get_L(xu, cov_func, jitter)
        else:
            Lp = None

        self.cov_func = cov_func
        self.landmarks = xu
        self.weights = weights
        self.mu = mu
        self.jitter = jitter
        self.sigma = original_sigma
        self.per_feature_sigma = False
        self.n_input_features = xu.shape[1]
        self.n_obs = n_obs

        self._state_variables = {
            "landmarks", "weights", "mu", "jitter", "sigma", "per_feature_sigma",
        }

        if obs_variance:
            if obs_x is None or obs_y is None:
                raise ValueError(
                    "obs_x and obs_y are required when obs_variance=True "
                    "for LandmarksConditionalCholesky."
                )
            self._compute_obs_variance(
                obs_x, obs_y, xu, mu, cov_func, original_sigma, jitter, weights, Lp
            )

        if not with_uncertainty:
            return

        self.L = L
        self._state_variables.add("L")

        if sigma is None:
            # the L-recompute branch above consumed sigma into the noise
            # factor; reuse the original for the uncertainty push-through
            # (the reference crashes here with eye * None)
            sigma = original_sigma
        if sigma is None:
            # raises the informative "No input uncertainty specified" error
            _sigma_to_y_cov_factor(None, None, xu.shape[0])
        if jnp.ndim(sigma) == 1:
            Stds = jnp.diag(sigma)
        else:
            Stds = jnp.eye(xu.shape[0]) * sigma
        W = solve_triangular(L.T, Stds)
        self.W = W
        self._state_variables.add("W")

    def _compute_obs_variance(
        self, x, y, xu, mu, cov_func, sigma, jitter, weights, Lp
    ):
        """Parity: ``mellon/conditional.py:869-897``."""
        x = ensure_2d(x)
        Kxu = cov_func(x, xu)
        prediction = mu + _hp(Kxu, weights)
        h = self._leverage(x, sigma)
        residual = y - prediction
        if residual.ndim > h.ndim:
            h = h[..., None]
        corrected_r2 = residual**2 / (1 - h) ** 2

        Kuf_var = cov_func(xu, x)
        A_var = solve_triangular(Lp, Kuf_var, lower=True)
        variance_mu = 0.0
        r_var = corrected_r2 - variance_mu
        r_l, A_l = _process_sigma(sigma, r_var, A_var, jitter=jitter)
        variance_weights, _ = _sparse_solve(Lp, A_var, r_l, A_l)

        self.variance_weights = variance_weights
        self.variance_mu = variance_mu
        self._corrected_r2 = corrected_r2
        self._state_variables.add("variance_weights")
        self._state_variables.add("variance_mu")

    def _mean(self, Xnew):
        return _conditional_mean(
            self.cov_func, Xnew, self.landmarks, self.weights, self.mu
        )

    def _leverage(self, Xnew, sigma):
        xu = self.landmarks
        jitter = self.jitter
        B = self.cov_func(Xnew, xu)
        if hasattr(self, "L") and self.L is not None:
            K_uu = _hp(self.L, self.L.T)
        else:
            K_uu = self.cov_func(xu, xu)
        # this family has no per-feature sigma concept (sigma here is the
        # scalar noise passed through compute_conditional); a latent-std
        # vector would be rejected by _hat_diagonal's length check
        return _hat_diagonal(B, K_uu, sigma, jitter, per_feature=False)

    def _obs_variance(self, Xnew):
        _check_obs_variance(self)
        return _conditional_mean(
            self.cov_func,
            Xnew,
            self.landmarks,
            self.variance_weights,
            self.variance_mu,
        )

    def _covariance(self, Xnew, diag=True):
        _check_covariance(self)
        if diag:
            return _conditional_cov_diag(
                self.cov_func, Xnew, self.landmarks, self.L
            )
        K = self.cov_func(self.landmarks, Xnew)
        A = solve_triangular(self.L, K, lower=True)
        return self.cov_func(Xnew, Xnew) - _hp(A.T, A)

    def _mean_covariance(self, Xnew, diag=True):
        _check_uncertainty(self)
        if diag:
            return _conditional_mean_cov_diag(
                self.cov_func, Xnew, self.landmarks, self.W
            )
        cov_L = _hp(self.cov_func(Xnew, self.landmarks), self.W)
        return _hp(cov_L, cov_L.T)


class LandmarksConditionalCholesky(_LandmarksConditionalCholesky, Predictor):
    pass


class ExpLandmarksConditionalCholesky(_LandmarksConditionalCholesky, ExpPredictor):
    pass


class LandmarksConditionalCholeskyTime(_LandmarksConditionalCholesky, PredictorTime):
    pass
