"""Automatic time length-scale selection.

Behavioural parity target: ``mellon/compute_ls_time.py``: fit one density
model per unique time point, correlate the per-time density fields, and fit
the time-kernel length scale to match the correlations (the L-BFGS fit runs
on device via :func:`mellon_tpu.inference.optimizers.minimize_lbfgsb`).

Device-first redesign of the per-time fits (SURVEY.md §7 "hard part": the
reference nests a full serial DensityEstimator fit per time point,
``mellon/compute_ls_time.py:66-85``): in the default configuration every
per-time model takes the FULL-GP path (per-time cell counts are below the
5000-landmark default), so all T fits are expressed as ONE batched, masked
program — groups padded to a common width, per-group kernel matrices
Cholesky-factorized under ``vmap``, and a single joint L-BFGS over the
stacked whitened latents (the per-group losses are independent, so the
joint optimum coincides with the per-group optima; padded latent entries
have exactly zero gradient and stay at their zero initialization, making
the masked fit EXACT for the real cells).  This removes T serial optimizer
runs and, on shape-sensitive backends, T distinct program compilations —
ragged group sizes all share one padded executable.
"""

import logging
from functools import partial

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular
from jax.scipy.special import gammaln

from ..inference.optimizers import minimize_lbfgsb
from ..utils.util import DEFAULT_JITTER, mle
from ..utils.validation import validate_time_x

logger = logging.getLogger("mellon_tpu")

# above this per-time cell count the batched FULL-GP fit's (T, n_pad²)
# kernel stack outgrows its value (and the reference's own per-time models
# would go sparse); fall back to the per-time loop
BATCH_GROUP_CAP = 4096
# keys of density_estimator_kwargs the batched path knows how to honor
_BATCHABLE_KEYS = {
    "cov_func_curry",
    "d_method",
    "d",
    "optimizer",
    "ls",
    "ls_factor",
    "jit",
    "mu",
    "jitter",
}


# host-f64 evaluations of the single-length-scale kernel cores the batched
# path admits, for the rescue of f32-singular time groups: recomputing the
# (small) per-group kernel from its already-host-resident coordinates avoids
# fetching the padded (T, n_pad, n_pad) kernel stack from the device — the
# transfer that made the all-groups rescue slower than the per-time loop
def _host_radial(profile):
    def core(x, ls):
        import numpy as np

        # matmul distance form: the coordinate-difference tensor would
        # materialize (n, n, d) f64 — ~1 GB per 2.4k-cell group at d=20,
        # which made the all-groups rescue the dominant cost of the
        # batched d=20 warm fit.  In f64 the cancellation that rules this
        # form out on the f32 device path is harmless (the kernel values
        # are consumed at f32 downstream).
        sq_norms = np.sum(x * x, axis=1)
        sq = sq_norms[:, None] + sq_norms[None, :] - 2.0 * (x @ x.T)
        return profile(np.sqrt(np.maximum(sq, 0.0)) / ls)

    return core


def _make_host_f64_cores():
    import numpy as np

    sqrt3, sqrt5 = np.sqrt(3.0), np.sqrt(5.0)
    return {
        "matern32": _host_radial(
            lambda r: (1.0 + sqrt3 * r) * np.exp(-sqrt3 * r)
        ),
        "matern52": _host_radial(
            lambda r: (1.0 + sqrt5 * r + 5.0 / 3.0 * r**2)
            * np.exp(-sqrt5 * r)
        ),
        "expquad": _host_radial(lambda r: np.exp(-0.5 * r**2)),
        "exponential": _host_radial(lambda r: np.exp(-0.5 * r)),
    }


_HOST_F64_CORES = _make_host_f64_cores()


def _masked_quantile_01(values, mask, n_real):
    """1%-quantile (linear interpolation) of ``values`` where ``mask`` is
    set — equals ``jnp.quantile(values[mask], 0.01)`` with a static shape."""
    padded = jnp.where(mask > 0, values, jnp.inf)
    srt = jnp.sort(padded)
    pos = 0.01 * (n_real - 1.0)
    lo = jnp.clip(jnp.floor(pos).astype(jnp.int32), 0, srt.shape[0] - 1)
    hi = jnp.clip(lo + 1, 0, srt.shape[0] - 1)
    w = pos - lo
    v_hi = jnp.where(hi < n_real, srt[hi], srt[lo])
    return srt[lo] * (1.0 - w) + v_hi * w


def _safe_exp(x):
    """``exp`` with a linear continuation above 60: finite and still
    strictly increasing, so an overflowing line-search trial point stays
    *repelling* (large finite loss, finite gradient) instead of poisoning
    the optimizer with ``inf - inf = NaN``.  The double-``where`` keeps the
    gradient NaN-free too.  e^60 ~ 1e26 is far beyond any optimum (the
    A-term is O(1) per cell at the MAP), so the fit itself never sees the
    continuation."""
    big = x > 60.0
    xs = jnp.where(big, 60.0, x)
    return jnp.where(big, jnp.exp(60.0) * (1.0 + (x - 60.0)), jnp.exp(xs))


def _batched_density_loss(zflat, L_stack, nng, mask, mu_t, d):
    """Sum of the T masked whitened density losses.  Identical math to
    ``inference.losses.density_loss`` per group; padded cells contribute a
    masked-out likelihood term and a prior term whose gradient is zero at
    the zero initialization, so they never move.

    The likelihood uses :func:`_safe_exp` and a ``where``-mask (not a
    multiply): with ten jointly-fit groups whose rescued factors are
    near-singular, the zoom line search can probe latents where
    ``exp(F + V)`` overflows f32 — a multiplicative mask then yields
    ``0 * -inf = NaN`` for padded cells and ``inf`` gradients for real
    ones, aborting L-BFGS at step 1 with a NaN loss (observed in f32 at
    the d=2 bench shape)."""
    T, n_pad, _ = L_stack.shape
    Z = zflat.reshape(T, n_pad)
    # accurate matvec: the batched einsum otherwise runs one reduced-
    # precision product, putting ~1e-3-relative high-frequency noise on
    # the joint loss surface — the same effect that froze the NUTS chains
    # (losses.py) here degrades the joint L-BFGS optimum and with it the
    # cross-time density correlations that ls_time is fit to.  Routed
    # through losses.MATVEC_PRECISION so the env knob covers it too.
    from ..inference.losses import MATVEC_PRECISION

    F = (
        jnp.einsum("tij,tj->ti", L_stack, Z, precision=MATVEC_PRECISION)
        + mu_t[:, None]
    )
    const = (d * jnp.log(jnp.pi) / 2) - gammaln(d / 2 + 1)
    V = jnp.log(nng) * d + const
    Vdr = jnp.log(d) + (d - 1) * jnp.log(nng) + const
    A = _safe_exp(F + V)
    B = F + Vdr
    loglik = jnp.sum(jnp.where(mask > 0, B - A, 0.0))
    prior = -0.5 * jnp.sum(Z**2) - (Z.size / 2) * jnp.log(2 * jnp.pi)
    return -(prior + loglik)


def _batched_ls_time_densities(
    x, nn_distances, cov_func_curry, kw, unique_times, warn_below
):
    """Densities (T, n) from one batched masked FULL-GP fit, or None when
    the configuration requires the exact per-time loop."""
    import numpy as np

    from ..parameters import compute_cov_func

    extra = set(kw) - _BATCHABLE_KEYS
    if extra:
        return None
    if kw.get("optimizer") not in (None, "L-BFGS-B"):
        return None
    d_method = kw.get("d_method")
    d_given = kw.get("d")
    if d_method == "fractal":
        return None  # per-group fractal dimension needs the loop
    if d_method == "manual" and d_given is None:
        return None  # let the per-time estimator raise its documented error
    try:
        template = compute_cov_func(cov_func_curry, 1.0)
        spec, params0 = template.operand_spec()
    except (NotImplementedError, TypeError):
        return None
    if len(params0) != 1:
        return None  # only single-length-scale kernels are batched

    times = np.asarray(x[:, -1])
    ut = np.asarray(unique_times)
    sizes = np.asarray([(times == t).sum() for t in ut])
    if sizes.max() > BATCH_GROUP_CAP or sizes.min() < 2:
        return None

    states = x[:, :-1]
    ds = states.shape[1]
    d = float(d_given) if d_given is not None else float(ds)
    if d > 50:
        return None  # the per-time estimator raises the documented error
    T = len(ut)
    n_pad = int(sizes.max())
    jitter_kw = kw.get("jitter")
    if jitter_kw is not None and not (
        isinstance(jitter_kw, (int, float)) and jitter_kw > 0
    ):
        return None  # let the per-time estimator raise its validation error
    jitter = float(jitter_kw) if jitter_kw is not None else DEFAULT_JITTER

    logger.info(
        f"Batched ls_time fits: {T} time points padded to {n_pad:,} cells "
        "run as one masked FULL-GP program (joint L-BFGS over all groups)."
    )
    for t, n_cells in zip(ut, sizes):
        if n_cells < warn_below:
            logger.warning(
                f"Time point {t} only has {n_cells:,} cells. "
                "This could lead to inaccurate estimation of the time "
                "length scale `ls_time`."
            )

    x_np = np.asarray(states)
    nn_np = np.asarray(nn_distances)
    xg = np.zeros((T, n_pad, ds), dtype=x_np.dtype)
    nng = np.ones((T, n_pad), dtype=nn_np.dtype)
    mask = np.zeros((T, n_pad), dtype=x_np.dtype)
    for i, t in enumerate(ut):
        sel = times == t
        k = int(sel.sum())
        xg[i, :k] = x_np[sel]
        nn_slice = nn_np[sel].copy()
        # per-slice repair, mirroring the per-time estimator's
        # validate_nn_distances on its nn_distances slice
        invalid = ~np.isfinite(nn_slice) | (nn_slice <= 0)
        if invalid.all():
            return None  # the per-time loop raises the documented error
        if invalid.any():
            logger.warning(
                f"Repairing {int(invalid.sum()):,} invalid nn_distances in "
                f"time group {t} (set to the minimum positive value found)."
            )
            nn_slice[invalid] = nn_slice[~invalid].min()
        nng[i, :k] = nn_slice
        mask[i, :k] = 1.0
    xg_host = xg  # host copy kept for the f64 rescue of singular groups
    xg, nng, mask = jnp.asarray(xg), jnp.asarray(nng), jnp.asarray(mask)
    n_t = jnp.asarray(sizes, dtype=xg.dtype)

    ls_given = kw.get("ls")
    ls_factor_kw = kw.get("ls_factor")
    ls_factor = float(ls_factor_kw) if ls_factor_kw is not None else 1.0
    mu_given = kw.get("mu")

    from ..ops.kernels import eval_operand_spec

    @jax.jit
    def stats(xg, nng, mask, n_t):
        mle_g = mle(nng, d)
        if mu_given is not None:
            mu_t = jnp.full((T,), float(mu_given), dtype=xg.dtype)
        else:
            mu_t = (
                jax.vmap(_masked_quantile_01)(mle_g, mask, n_t) - 10.0
            )
        if ls_given is not None:
            ls_t = jnp.full((T,), float(ls_given), dtype=xg.dtype)
        else:
            log_mean = jnp.sum(jnp.log(nng) * mask, axis=1) / n_t
            ls_t = jnp.exp(log_mean + 3.0) * ls_factor
        return mle_g, mu_t, ls_t

    @jax.jit
    def masked_kernels(xg, mask, ls_t):
        def one(xg_t, mask_t, ls_g):
            K = eval_operand_spec(spec, (ls_g,), xg_t, xg_t)
            m2 = mask_t[:, None] * mask_t[None, :]
            return K * m2 + jnp.diag(1.0 - mask_t)

        return jax.vmap(one)(xg, mask, ls_t)

    @jax.jit
    def chol(K_stack, jitters):
        def one(K_t, j):
            diag = jnp.arange(K_t.shape[0])
            L = jnp.linalg.cholesky(K_t.at[diag, diag].add(j))
            return L, jnp.any(jnp.isnan(L))

        return jax.vmap(one)(K_stack, jitters)

    @jax.jit
    def ridge(L_stack, mask, target):
        # masked ridge warm start: (LᵀWL + I) z = LᵀW (mle − mu).
        # HIGHEST-precision Gram + Cholesky solve: a reduced-precision
        # Gram fed to an f32 LU solve returned NaN for host-f64-rescued
        # factors (the host f64 ridge on the same operands is clean),
        # which poisoned the joint L-BFGS at step 1
        hp = partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)

        def one(L_t, mask_t, target_t):
            Lw = L_t * mask_t[:, None]
            G = hp(Lw.T, Lw)
            diag = jnp.arange(G.shape[0])
            rhs = hp(Lw.T, target_t * mask_t)
            c = jnp.linalg.cholesky(G.at[diag, diag].add(1.0))
            y = solve_triangular(c, rhs, lower=True)
            return solve_triangular(c.T, y, lower=False)

        return jax.vmap(one)(L_stack, mask, target)

    mle_g, mu_t, ls_t = stats(xg, nng, mask, n_t)
    K_stack = masked_kernels(xg, mask, ls_t)

    # the same rescue ladder as safe_cholesky, batched: per-group jitter
    # escalation (one executable, jitters are operands), then host-f64
    # factorization of the f32-rounded kernel values for still-singular
    # groups (full per-time kernels are routinely f32-singular — the loop
    # path pays exactly this ladder per time point)
    jitters = np.full(T, jitter, dtype=np.dtype(str(xg.dtype)))
    L_stack, bad = chol(K_stack, jnp.asarray(jitters))
    bad = np.asarray(bad)
    tries = 0
    while bad.any() and tries < 3:
        tries += 1
        jitters = np.where(bad, jitters * 10, jitters)
        logger.warning(
            f"Batched Cholesky failed for {int(bad.sum())} time group(s); "
            f"retrying with escalated jitter (try {tries})."
        )
        L_stack, bad = chol(K_stack, jnp.asarray(jitters))
        bad = np.asarray(bad)
    if bad.any():
        logger.warning(
            f"Batched Cholesky failed for {int(bad.sum())} time group(s) "
            "after jitter escalation; factorizing those groups on the host "
            "in float64."
        )
        from ..ops.linalg import host_cholesky_f64

        bad_idx = np.flatnonzero(bad)
        host_core = (
            _HOST_F64_CORES.get(spec[0])
            if len(spec) == 3 and spec[1] is None
            else None
        )
        if host_core is not None:
            # rebuild each singular group's kernel on the host in f64 from
            # its (small, host-resident) coordinates — no device fetch at
            # all, and full f64 precision instead of f32-rounded values
            ls_host = np.asarray(jax.device_get(ls_t), dtype=np.float64)
            K_bad = np.empty((len(bad_idx), n_pad, n_pad), dtype=np.float64)
            for j_g, g in enumerate(bad_idx):
                k = int(sizes[g])
                K_bad[j_g] = np.eye(n_pad)
                K_bad[j_g, :k, :k] = host_core(
                    xg_host[g, :k].astype(np.float64), ls_host[g]
                )
        else:
            # unsupported kernel structure: fetch only the still-singular
            # groups' (f32-rounded) kernel values
            K_bad = np.asarray(
                jax.device_get(K_stack[jnp.asarray(bad_idx)]),
                dtype=np.float64,
            )
        fixed = np.empty_like(K_bad)
        for j_g in range(len(bad_idx)):
            try:
                fixed[j_g] = host_cholesky_f64(K_bad[j_g], jitter=jitter)
            except np.linalg.LinAlgError:
                return None  # genuinely unfactorizable: exact loop decides
        # one upload of ONLY the rescued factors (the previous all-groups
        # round trip — full L_stack down, full L_stack up — was the
        # transfer bound that made the batched path slower than the loop)
        L_stack = L_stack.at[jnp.asarray(bad_idx)].set(
            jnp.asarray(fixed, dtype=L_stack.dtype)
        )
        rescued_f64 = (bad_idx, fixed)
    else:
        rescued_f64 = None

    z0 = ridge(L_stack, mask, mle_g - mu_t[:, None])
    # rescued factors can be ill-conditioned enough that the f32 ridge
    # normal equations blow up; a non-finite warm start would poison the
    # joint L-BFGS at step 1
    z0 = jnp.where(jnp.isfinite(z0), z0, 0.0)

    loss_args = (L_stack, nng, mask, mu_t, jnp.asarray(d, dtype=xg.dtype))
    res = minimize_lbfgsb(_batched_density_loss, jnp.ravel(z0), loss_args=loss_args)
    if not np.isfinite(float(res.loss)):
        # the batched path must never hand garbage to the ls fit: retry
        # once from the prior mean (exact for padded cells, valid init),
        # then concede to the per-time loop
        logger.warning(
            "Batched ls_time L-BFGS diverged (non-finite loss); "
            "retrying from the zero initialization."
        )
        res = minimize_lbfgsb(
            _batched_density_loss, jnp.zeros_like(jnp.ravel(z0)),
            loss_args=loss_args,
        )
        if not np.isfinite(float(res.loss)):
            logger.warning(
                "Batched ls_time fit is non-finite after the zero-init "
                "retry; falling back to the exact per-time loop."
            )
            return None
    Z = res.pre_transformation.reshape(T, n_pad)

    @jax.jit
    def predict(states, xg, L_stack, Z, ls_t, mu_t):
        def one(op):
            xg_t, L_t, z_t, ls_g, mu_g = op
            w = solve_triangular(L_t.T, z_t, lower=False)
            Ks = eval_operand_spec(spec, (ls_g,), states, xg_t)
            # HIGHEST: vmapped over groups this matvec is a matmul; the
            # default reduced-precision pass perturbs the densities whose
            # cross-time correlations define ls_time
            return mu_g + jnp.dot(Ks, w, precision=jax.lax.Precision.HIGHEST)

        return jax.lax.map(one, (xg, L_stack, Z, ls_t, mu_t))

    dens = predict(states, xg, L_stack, Z, ls_t, mu_t)
    if rescued_f64 is not None:
        # extended-precision predict for the host-f64-rescued groups: their
        # factors are ill-conditioned enough that the f32 triangular solve
        # w = L⁻ᵀz and the f32 product K_s w amplify rounding by ~cond(L)
        # — the drift behind an ls_time accuracy gap at the d=2 bench
        # shape.  The tiny (n_pad,) solve runs on the host
        # in f64; the big (n, n_pad) product runs on device as a
        # double-single matmul.
        import scipy.linalg as sla

        from ..ops.extended_precision import ds_from_f64, ds_matmul

        bad_idx_r, fixed_r = rescued_f64
        logger.info(
            "Extended-precision (double-single) predict for %d host-f64-"
            "rescued time group(s).",
            len(bad_idx_r),
        )
        Z_host = np.asarray(jax.device_get(Z), dtype=np.float64)
        mu_host_r = np.asarray(jax.device_get(mu_t), dtype=np.float64)
        rows = []
        for j_g, g in enumerate(bad_idx_r):
            w64 = sla.solve_triangular(
                fixed_r[j_g].T, Z_host[g], lower=False
            )
            w_hi, w_lo = ds_from_f64(w64[:, None])
            Ks = eval_operand_spec(
                spec, (jnp.asarray(ls_t[g]),), states, xg[g]
            )
            rows.append(mu_host_r[g] + ds_matmul(Ks, w_hi, w_lo)[:, 0])
        dens = dens.at[jnp.asarray(np.asarray(bad_idx_r))].set(
            jnp.stack(rows).astype(dens.dtype)
        )
    if not bool(jnp.all(jnp.isfinite(dens))):
        # the cross-time correlation of a non-finite density row would turn
        # the whole ls_time fit into NaN; the exact loop is always valid
        logger.warning(
            "Batched ls_time densities are non-finite; falling back to "
            "the exact per-time loop."
        )
        return None
    return dens


def compute_ls_time(
    nn_distances,
    x,
    cov_func_curry,
    times=None,
    warn_below=500,
    return_data=False,
    density_estimator_kwargs=dict(),
):
    """Estimate ls_time from cross-time density correlations
    (parity: ``mellon/compute_ls_time.py:12-104``).

    In the default configuration the per-time fits run as one batched
    masked program (see module docstring); ``return_data=True`` or any
    configuration the batch cannot express exactly falls back to the
    reference's per-time loop.
    """
    from .density import DensityEstimator

    x = validate_time_x(x, times)
    times = x[:, -1]
    states = x[:, :-1]
    unique_times = jnp.unique(times)
    n_times = len(unique_times)

    densities = None
    if not return_data:
        densities = _batched_ls_time_densities(
            x,
            nn_distances,
            cov_func_curry,
            density_estimator_kwargs,
            unique_times,
            warn_below,
        )

    predictors = []
    if densities is None:
        per_time = []
        for i, time in enumerate(unique_times):
            mask = times == time
            n_cells = int(jnp.sum(mask))
            logger.info(
                f"[{i + 1} of {n_times}] Computing density for {n_cells:,} "
                f"cells at time point {time}."
            )
            if n_cells < warn_below:
                logger.warning(
                    f"Time point {time} only has {n_cells:,} cells. "
                    "This could lead to inaccurate estimation of the time "
                    "length scale `ls_time`."
                )
            x_at_time = x[mask, :-1]
            est = DensityEstimator(
                nn_distances=nn_distances[mask], **density_estimator_kwargs
            )
            est.fit(x_at_time)
            per_time.append(est.predict(states))
            predictors.append(est)
        densities = jnp.stack(per_time)

    corrs = jnp.corrcoef(densities)
    delta_t = jnp.abs(
        unique_times.reshape(-1, 1) - unique_times.reshape(1, -1)
    ).reshape(-1, 1)

    def ls_loss(log_ls):
        ls = jnp.exp(log_ls)
        covs = cov_func_curry(ls)(delta_t, jnp.zeros((1, 1))).reshape(
            (n_times, n_times)
        )
        return jnp.linalg.norm(covs - corrs)

    opt = minimize_lbfgsb(ls_loss, jnp.asarray(0.0))
    ls = float(jnp.exp(opt.pre_transformation))

    if return_data:
        return ls, densities, predictors, unique_times
    return ls
