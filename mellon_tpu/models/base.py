"""Shared estimator machinery: validated constructor, lazy attribute
preparation, optimizer dispatch.

Behavioural parity target: ``mellon/base_model.py`` (482 LoC).
"""

import logging
import math

from ..inference.advi import run_advi
from ..inference.laplace import compute_laplace_std
from ..inference.optimizers import (
    DEFAULT_INIT_LEARN_RATE,
    DEFAULT_JIT,
    DEFAULT_N_ITER,
    DEFAULT_OPTIMIZER,
    minimize_adam,
    minimize_lbfgsb,
)
from ..ops.kernels import Matern52
from ..parameters import (
    DEFAULT_RANDOM_SEED,
    compute_L,
    compute_Lp,
    compute_cov_func,
    compute_gp_type,
    compute_landmarks,
    compute_ls,
    compute_n_landmarks,
    compute_nn_distances,
    compute_rank,
)
from ..utils.parameter_validation import (
    validate_cov_func,
    validate_cov_func_curry,
    validate_params,
)
from ..utils.util import (
    DEFAULT_JITTER,
    GaussianProcessType,
    object_str,
    test_rank,
)
from ..utils.validation import (
    validate_array,
    validate_bool,
    validate_float,
    validate_float_or_int,
    validate_float_or_iterable_numerical,
    validate_nn_distances,
    validate_positive_float,
    validate_positive_int,
    validate_string,
)

DEFAULT_COV_FUNC = Matern52
RANK_FRACTION_THRESHOLD = 0.8
SAMPLE_LANDMARK_RATIO = 10

# constructor-level sampler configuration accepted via ``sampler_options=``
# (NEW relative to the reference, which has no samplers): keys for
# optimizer="nuts" and optimizer="smc" respectively
_NUTS_OPTION_KEYS = {
    "num_chains",
    "num_warmup",
    "num_samples",
    "target_accept",
    "max_tree_depth",
    "initial_step_size",
    # chunked execution: bound each program execution to this many
    # transitions (run_mcmc steps_per_call) — required for long runs on
    # backends that bound a single execution's duration
    "steps_per_call",
    # dense-metric sampling: "hessian" preconditions the potential with
    # the MAP-Hessian Cholesky (the density posterior's scale spread
    # defeats diagonal mass adaptation at scale)
    "precondition",
}
_SMC_OPTION_KEYS = {
    "num_particles",
    "target_ess_frac",
    "num_mutation_steps",
    "mutation_step_size",
    "num_leapfrog_steps",
    "max_stages",
    "start",
}
# string-valued options with their allowed values
_STR_SAMPLER_OPTIONS = {
    "start": ("prior", "laplace"),
    "precondition": ("hessian",),
}
_SAMPLER_OPTION_KEYS = _NUTS_OPTION_KEYS | _SMC_OPTION_KEYS
# count-valued options: the sampler paths int()-cast these, so accepting
# 0.5 here would silently become 0 chains/particles downstream
_INT_SAMPLER_OPTION_KEYS = {
    "num_chains",
    "num_warmup",
    "num_samples",
    "max_tree_depth",
    "num_particles",
    "num_mutation_steps",
    "num_leapfrog_steps",
    "max_stages",
    "steps_per_call",
}

logger = logging.getLogger("mellon_tpu")


def _validate_sampler_options(options):
    """Validate the ``sampler_options`` dict (None -> {})."""
    if options is None:
        return {}
    if not isinstance(options, dict):
        raise ValueError(
            "sampler_options must be a dict of sampler settings, got "
            f"{type(options).__name__}."
        )
    unknown = set(options) - _SAMPLER_OPTION_KEYS
    if unknown:
        raise ValueError(
            f"Unknown sampler_options key(s) {sorted(unknown)}. "
            f"NUTS accepts {sorted(_NUTS_OPTION_KEYS)}; "
            f"SMC accepts {sorted(_SMC_OPTION_KEYS)}."
        )
    for name, value in options.items():
        if name in _STR_SAMPLER_OPTIONS:
            if value not in _STR_SAMPLER_OPTIONS[name]:
                raise ValueError(
                    f"sampler_options[{name!r}] must be one of "
                    f"{_STR_SAMPLER_OPTIONS[name]}, got {value!r}."
                )
            continue
        # finiteness first: inf on an int-keyed option would raise an
        # uncaught OverflowError in the integrality check below, and
        # NaN passes `value <= 0` (NaN comparisons are False)
        if (
            isinstance(value, bool)
            or not isinstance(value, (int, float))
            or not math.isfinite(value)
            or value <= 0
        ):
            raise ValueError(
                f"sampler_options[{name!r}] must be a positive number, "
                f"got {value!r}."
            )
        if name in _INT_SAMPLER_OPTION_KEYS and value != int(value):
            raise ValueError(
                f"sampler_options[{name!r}] must be a positive integer, "
                f"got {value!r}."
            )
    return dict(options)


class BaseEstimator:
    """Base class of all estimators (parity: ``mellon/base_model.py:56-482``)."""

    def __init__(
        self,
        cov_func_curry=DEFAULT_COV_FUNC,
        n_landmarks=None,
        rank=None,
        jitter=DEFAULT_JITTER,
        optimizer=DEFAULT_OPTIMIZER,
        n_iter=DEFAULT_N_ITER,
        init_learn_rate=DEFAULT_INIT_LEARN_RATE,
        landmarks=None,
        gp_type=None,
        nn_distances=None,
        d=None,
        mu=0,
        ls=None,
        ls_factor=1,
        cov_func=None,
        Lp=None,
        L=None,
        initial_value=None,
        predictor_with_uncertainty=False,
        jit=DEFAULT_JIT,
        check_rank=None,
        random_state=DEFAULT_RANDOM_SEED,
        precision=None,
        sampler_options=None,
    ):
        if precision not in (None, "f32", "bf16"):
            raise ValueError(
                f"Unknown precision option: {precision!r}. "
                'Available options are "bf16", "f32" and None.'
            )
        self.precision = precision
        self.cov_func_curry = validate_cov_func_curry(
            cov_func_curry, cov_func, "cov_func_curry"
        )
        self.n_landmarks = validate_positive_int(
            n_landmarks, "n_landmarks", optional=True
        )
        self.random_state = validate_positive_int(
            random_state, "random_state", optional=True
        )
        self.rank = validate_float_or_int(rank, "rank", optional=True)
        self.jitter = validate_positive_float(jitter, "jitter")
        self.landmarks = validate_array(landmarks, "landmarks", optional=True)
        self.gp_type = GaussianProcessType.from_string(gp_type, optional=True)
        self.nn_distances = validate_array(nn_distances, "nn_distances", optional=True)
        self.nn_distances = validate_nn_distances(self.nn_distances, optional=True)
        self.mu = validate_float(mu, "mu", optional=True)
        self.ls = validate_positive_float(ls, "ls", optional=True)
        self.ls_factor = validate_positive_float(ls_factor, "ls_factor")
        self.cov_func = validate_cov_func(cov_func, "cov_func", optional=True)
        self.Lp = validate_array(Lp, "Lp", optional=True)
        self.L = validate_array(L, "L", optional=True)
        self.d = validate_float_or_iterable_numerical(
            d, "d", optional=True, positive=True
        )
        self.initial_value = validate_array(
            initial_value, "initial_value", optional=True
        )
        self.optimizer = validate_string(
            optimizer,
            "optimizer",
            choices={"adam", "advi", "L-BFGS-B", "nuts", "smc"},
        )
        self.n_iter = validate_positive_int(n_iter, "n_iter")
        self.init_learn_rate = validate_positive_float(
            init_learn_rate, "init_learn_rate"
        )
        self.predictor_with_uncertainty = validate_bool(
            predictor_with_uncertainty, "predictor_with_uncertainty"
        )
        self.jit = validate_bool(jit, "jit")
        self.check_rank = validate_bool(check_rank, "check_rank", optional=True)
        self.sampler_options = _validate_sampler_options(sampler_options)
        self.x = None
        self.pre_transformation = None

    def __str__(self):
        return self.__repr__()

    def __repr__(self):
        name = self.__class__.__name__
        landmarks = object_str(self.landmarks, ["landmarks", "dims"])
        Lp = object_str(self.Lp, ["landmarks", "landmarks"])
        L = object_str(self.L, ["cells", "ranks"])
        nn_distances = object_str(self.nn_distances, ["cells"])
        initial_value = object_str(self.initial_value, ["ranks"])
        d = object_str(self.d, ["cells"])
        return (
            f"{name}("
            f"\n    check_rank={self.check_rank},"
            f"\n    cov_func={self.cov_func},"
            f"\n    cov_func_curry={self.cov_func_curry},"
            f"\n    d={d},"
            f"\n    gp_type={self.gp_type},"
            f"\n    initial_value={initial_value},"
            f"\n    jit={self.jit},"
            f"\n    jitter={self.jitter},"
            f"\n    landmarks={landmarks},"
            f"\n    L={L},"
            f"\n    Lp={Lp},"
            f"\n    ls={self.ls},"
            f"\n    ls_factor={self.ls_factor},"
            f"\n    mu={self.mu},"
            f"\n    n_landmarks={self.n_landmarks},"
            f"\n    nn_distances={nn_distances},"
            f"\n    optimizer={self.optimizer},"
            f"\n    predictor_with_uncertainty={self.predictor_with_uncertainty},"
            f"\n    random_state={self.random_state},"
            f"\n    rank={self.rank},"
            "\n)"
        )

    def __call__(self, x=None):
        return self.fit_predict(x=x)

    def set_x(self, x):
        """Validate and pin the training data
        (parity: ``mellon/base_model.py:176-213``)."""
        if self.x is not None and x is not None and self.x is not x:
            message = "self.x has been set already, but is not equal to the argument x."
            error = ValueError(message)
            logger.error(error)
            raise error
        if self.x is None and x is None:
            message = "Required argument x is missing and self.x has not been set."
            error = ValueError(message)
            logger.error(error)
            raise error
        if x is None:
            x = self.x
        self.x = validate_array(x, "x")
        return self.x

    def _compute_n_landmarks(self):
        return compute_n_landmarks(self.gp_type, self.x.shape[0], self.landmarks)

    def _landmark_advisory_and_seed(self, n_samples, n_landmarks):
        """Large-n advisory log + resolved random_state, shared by the lazy
        landmark computations and the fused preambles."""
        if n_samples > 100 * n_landmarks and n_samples > 1e6:
            logger.info(
                f"Large number of {n_samples:,} cells and "
                f"small number of {n_landmarks:,} landmarks. Consider "
                "computing k-means on a subset of cells and passing "
                "the results as 'landmarks' to speed up the process."
            )
        return (
            self.random_state if self.random_state is not None else DEFAULT_RANDOM_SEED
        )

    def _compute_landmarks(self):
        x = self.x
        n_landmarks = self.n_landmarks
        gp_type = self.gp_type
        random_state = self._landmark_advisory_and_seed(x.shape[0], n_landmarks)
        return compute_landmarks(
            x, gp_type, n_landmarks=n_landmarks, random_state=random_state
        )

    def _compute_rank(self):
        return compute_rank(self.gp_type)

    def _compute_gp_type(self):
        return compute_gp_type(self.n_landmarks, self.rank, self.x.shape[0])

    def _compute_nn_distances(self):
        logger.info("Computing nearest neighbor distances.")
        seed = (
            self.random_state if self.random_state is not None else DEFAULT_RANDOM_SEED
        )
        nn_distances = compute_nn_distances(self.x, seed=seed)
        return validate_nn_distances(nn_distances)

    def _compute_ls(self):
        ls = compute_ls(self.nn_distances)
        ls *= self.ls_factor
        return ls

    def _compute_cov_func(self):
        cov_func = compute_cov_func(self.cov_func_curry, self.ls)
        logger.info("Using covariance function %s.", str(cov_func))
        return cov_func

    def _lp_accept_or_prune(self, K, L, ok):
        """Finish the f32 sparse Lp: accept the Cholesky attempt (L, ok) of
        the landmark kernel K, or prune to the pivoted-Cholesky-selected
        landmark subset and re-factorize.  Shared by the lazy attribute path
        and the fused prepare program (which performs the first attempt
        inside one larger executable)."""
        from ..ops.linalg import select_stable_landmarks, safe_cholesky

        if bool(ok):
            return L
        from .. import config

        if not config.PRUNE_SINGULAR_LANDMARKS:
            # full capacity goes straight to the host-f64 factorization
            # (which itself escalates jitter only as a last resort for
            # matrices that are indefinite even at f64 resolution); the
            # f32 escalated safe_cholesky below is the final fallback if
            # even that fails
            import numpy as np
            import jax.numpy as jnp

            from ..ops.linalg import host_cholesky_f64

            logger.warning(
                "Landmark kernel is singular at f32; keeping all %d "
                "landmarks (pruning disabled) and factorizing once on the "
                "host in float64.",
                self.landmarks.shape[0],
            )
            # rebuild the landmark kernel on the host in f64 from its
            # coordinates when the kernel structure supports it: at this
            # conditioning even the f32 ROUNDING of the kernel values
            # (~6e-8) perturbs the factorization materially (round-4
            # B-mode experiment)
            K_for_chol = K
            try:
                from ..ops.extended_precision import host_spec_kernel_f64

                spec, params = self.cov_func.operand_spec()
                K_for_chol = host_spec_kernel_f64(spec, params, self.landmarks)
            except (NotImplementedError, AttributeError):
                pass
            try:
                L_host64 = host_cholesky_f64(K_for_chol, jitter=self.jitter)
            except np.linalg.LinAlgError:
                return safe_cholesky(K, jitter=self.jitter, max_tries=3)
            # keep the f64 factor: _compute_L whitens through its
            # triangular inverse in extended (double-single) precision —
            # the f32 TRSM against this near-singular factor was the
            # binding fidelity limit at extreme kernel conditioning
            self._hostf64_Lp = L_host64
            return jnp.asarray(L_host64, dtype=K.dtype)
        piv = select_stable_landmarks(K, rel_tol=1e-6)
        logger.warning(
            "Landmark kernel is singular at f32; pruning %d "
            "redundant landmarks (keeping %d).",
            self.landmarks.shape[0] - len(piv),
            len(piv),
        )
        self.landmarks = self.landmarks[piv]
        self.n_landmarks = int(len(piv))
        if self.check_rank is None:
            # rank is known by construction; skip the SVD check
            self.check_rank = False
        K_sub = K[piv][:, piv]
        return safe_cholesky(K_sub, jitter=self.jitter, max_tries=3)

    def _compute_Lp(self):
        import jax.numpy as jnp

        # f32 fast path for the sparse case: when the landmark kernel is
        # numerically singular in f32, prune to the pivoted-Cholesky-selected
        # subset (dropping linearly redundant landmarks) instead of paying a
        # host-f64 factorization — fully on device, and every downstream
        # O(n·m)/O(m³) op shrinks with the reduced m.
        if (
            self.landmarks is not None
            and self.gp_type
            in (GaussianProcessType.SPARSE_CHOLESKY, GaussianProcessType.FIXED)
        ):
            from ..ops.linalg import _jittered_cholesky

            K = self.cov_func(self.landmarks, self.landmarks)
            if K.dtype != jnp.float64:
                L, ok = _jittered_cholesky(
                    K, jnp.asarray(self.jitter, dtype=K.dtype)
                )
                return self._lp_accept_or_prune(K, L, ok)

        return compute_Lp(
            self.x,
            self.cov_func,
            self.gp_type,
            self.landmarks,
            sigma=0,
            jitter=self.jitter,
        )

    def _compute_L(self):
        x = self.x
        gp_type = self.gp_type
        landmarks = self.landmarks
        rank = self.rank
        check_rank = self.check_rank

        from .. import config

        if (
            getattr(self, "_hostf64_Lp", None) is not None
            and config.EXTENDED_PRECISION_WHITEN
            and landmarks is not None
            and gp_type
            in (GaussianProcessType.SPARSE_CHOLESKY, GaussianProcessType.FIXED)
        ):
            # full-capacity path: the landmark kernel was f32-singular and
            # factorized on the host in f64; whiten through its triangular
            # inverse in extended (double-single) precision on device —
            # f64-equivalent accuracy from bf16 matrix products
            from ..ops.extended_precision import whiten_with_hostf64

            logger.info(
                "Whitening %s cells against the host-f64 factor in "
                "extended (double-single) precision.",
                f"{x.shape[0]:,}",
            )
            L = whiten_with_hostf64(x, self.cov_func, landmarks, self._hostf64_Lp)
        else:
            L = compute_L(
                x,
                self.cov_func,
                gp_type,
                landmarks=landmarks,
                Lp=self.Lp,
                rank=rank,
                sigma=0,
                jitter=self.jitter,
            )

        new_rank = L.shape[1]
        n_samples = x.shape[0]
        n_landmarks = n_samples if landmarks is None else landmarks.shape[0]

        if (
            gp_type
            in (GaussianProcessType.SPARSE_NYSTROEM, GaussianProcessType.FULL_NYSTROEM)
        ) and new_rank > (rank * RANK_FRACTION_THRESHOLD * n_landmarks):
            logger.warning(
                f"Shallow rank reduction from {n_landmarks:,} to {new_rank:,} "
                "indicates underrepresentation by landmarks. Consider "
                "increasing n_landmarks!"
            )

        if (
            check_rank is None
            and gp_type == GaussianProcessType.SPARSE_CHOLESKY
            and SAMPLE_LANDMARK_RATIO * n_landmarks < n_samples
        ) or (check_rank is not None and check_rank):
            logger.info(
                "Estimating approximation accuracy "
                f"since {n_samples:,} samples are more than "
                f"{SAMPLE_LANDMARK_RATIO} x {n_landmarks:,} landmarks."
            )
            test_rank(L, threshold=RANK_FRACTION_THRESHOLD)
        logger.info(f"Using rank {new_rank:,} covariance representation.")
        return L

    def validate_parameter(self):
        """Cross-check the parameter combination
        (parity: ``mellon/base_model.py:360-369``)."""
        validate_params(
            self.rank, self.gp_type, self.x.shape[0], self.n_landmarks, self.landmarks
        )

    def _run_inference(self):
        """Optimizer dispatch (parity: ``mellon/base_model.py:371-431``).

        When the estimator provides an operand-threaded static loss
        (``_loss_fn``/``_loss_args``), the optimizers receive the operands as
        runtime arguments so one small executable serves every fit; the
        user-facing ``loss_func`` closure remains available for custom
        optimization loops.
        """
        function = self.loss_func
        loss_fn = getattr(self, "_loss_fn", None)
        loss_args = getattr(self, "_loss_args", ())
        if loss_fn is None:
            loss_fn, loss_args = function, ()
        initial_value = self.initial_value
        optimizer = self.optimizer
        fallback = getattr(self, "_fused_lp_fallback", None)
        if fallback is not None and optimizer != "L-BFGS-B":
            # the optimistic factorization is only loss-checked on the
            # L-BFGS path; for any other optimizer verify it eagerly here
            # (NaNs in Lp propagate into the warm start)
            import jax.numpy as _jnp

            self._fused_lp_fallback = None
            if not bool(_jnp.all(_jnp.isfinite(initial_value))):
                from ..ops.linalg import safe_cholesky

                logger.warning(
                    "Optimistic factorization was invalid; rebuilding with "
                    "jitter escalation."
                )
                K, piv = fallback
                self.Lp = safe_cholesky(
                    K[piv][:, piv], jitter=self.jitter, max_tries=3
                )
                self.L = None
                self.initial_value = None
                self.transform = None
                self.loss_func = None
                for attr in ("L", "initial_value", "transform", "loss_func"):
                    self._prepare_attribute(attr)
                initial_value = self.initial_value
                loss_fn = getattr(self, "_loss_fn", None)
                loss_args = getattr(self, "_loss_args", ())
                if loss_fn is None:
                    loss_fn, loss_args = self.loss_func, ()
        logger.info("Running inference using %s.", optimizer)
        if (
            getattr(self, "precision", None) == "bf16"
            and optimizer in ("nuts", "smc")
            and loss_args
        ):
            # bf16 operand storage halves sampler HBM traffic (~1.9x
            # leapfrog throughput); same cast sample_density_posterior
            # applies for its precision="bf16" option
            import jax.numpy as _jnp

            loss_args = tuple(
                a.astype(_jnp.bfloat16)
                if getattr(a, "ndim", 0) == 2 and a.dtype == _jnp.float32
                else a
                for a in loss_args
            )
        if optimizer == "adam":
            results = minimize_adam(
                loss_fn,
                initial_value,
                n_iter=self.n_iter,
                init_learn_rate=self.init_learn_rate,
                jit=self.jit,
                loss_args=loss_args,
            )
            self.pre_transformation = results.pre_transformation
            self.pre_transformation_std = None
            self.opt_state = results.opt_state
            self.losses = results.losses
        elif optimizer == "advi":
            results = run_advi(
                loss_fn,
                initial_value,
                n_iter=self.n_iter,
                init_learn_rate=self.init_learn_rate,
                jit=self.jit,
                loss_args=loss_args,
            )
            self.pre_transformation = results.pre_transformation
            self.pre_transformation_std = results.pre_transformation_std
            self.losses = results.losses
        elif optimizer == "L-BFGS-B":
            results = minimize_lbfgsb(
                loss_fn,
                initial_value,
                jit=self.jit,
                loss_args=loss_args,
                precision=getattr(self, "precision", None),
            )
            fallback = getattr(self, "_fused_lp_fallback", None)
            self._fused_lp_fallback = None  # release K either way
            if fallback is not None and not math.isfinite(results.loss):
                # the fused prepare factorized the pruned landmark kernel
                # optimistically (no blocking validity fetch); a non-finite
                # loss means that Cholesky needed jitter escalation after
                # all — rebuild robustly and rerun
                from ..ops.linalg import safe_cholesky

                logger.warning(
                    "Non-finite loss from optimistic factorization; "
                    "rebuilding with jitter escalation and retrying."
                )
                K, piv = fallback
                self.Lp = safe_cholesky(
                    K[piv][:, piv], jitter=self.jitter, max_tries=3
                )
                self.L = None
                self.initial_value = None
                self.transform = None
                self.loss_func = None
                for attr in ("L", "initial_value", "transform", "loss_func"):
                    self._prepare_attribute(attr)
                return self._run_inference()
            self.pre_transformation = results.pre_transformation
            self.pre_transformation_std = None
            self.opt_state = results.opt_state
            self.losses = [results.loss]
        elif optimizer == "nuts":
            # full posterior via NUTS (new relative to the reference); the
            # posterior mean/std summarize the chain for the predictor's
            # mean-field uncertainty machinery, and the raw draws are kept
            # on .posterior_samples
            import jax as _jax
            import jax.numpy as _jnp

            from ..inference.mcmc import run_mcmc

            seed = (
                self.random_state
                if self.random_state is not None
                else DEFAULT_RANDOM_SEED
            )
            # run_mcmc samples 1-d latent vectors (z0 rows are chains); a
            # structured latent like the dimensionality model's (2, k)
            # stacked GPs samples through a flattening wrapper — without it
            # the (2, k) initial value would be misread as 2 chains of 1-d
            # latents and crash inside the loss
            latent_shape = initial_value.shape
            if initial_value.ndim == 1:
                mcmc_loss, mcmc_z0 = loss_fn, initial_value
            else:
                mcmc_z0 = _jnp.ravel(initial_value)

                def mcmc_loss(z, *args):
                    return loss_fn(z.reshape(latent_shape), *args)

            opts = {
                "num_warmup": max(self.n_iter, 200),
                "num_samples": max(self.n_iter, 200),
                "num_chains": 4,
                "target_accept": 0.8,
                "max_tree_depth": 10,
                "initial_step_size": 0.1,
            }
            precondition = self.sampler_options.get("precondition")
            opts.update(
                {
                    k: v
                    for k, v in self.sampler_options.items()
                    if k in _NUTS_OPTION_KEYS
                }
            )
            if precondition == "hessian":
                from ..inference.mcmc import (
                    hessian_cholesky,
                    newton_polish,
                    precondition_transform,
                    preconditioned_potential,
                )

                mcmc_z0, _, _ = newton_polish(mcmc_loss, mcmc_z0, loss_args)
                R_pre = precondition_transform(
                    hessian_cholesky(
                        mcmc_loss,
                        mcmc_z0,
                        _jnp.asarray(self.jitter, mcmc_z0.dtype),
                        *loss_args,
                    )
                )
                z_map_pre = mcmc_z0
                mcmc_loss = preconditioned_potential(mcmc_loss)
                loss_args = (R_pre, z_map_pre) + tuple(loss_args)
                mcmc_z0 = _jnp.zeros_like(mcmc_z0)

            import time as _time

            t0 = _time.perf_counter()
            result = run_mcmc(
                mcmc_loss,
                mcmc_z0,
                _jax.random.PRNGKey(seed),
                num_warmup=int(opts["num_warmup"]),
                num_samples=int(opts["num_samples"]),
                num_chains=int(opts["num_chains"]),
                target_accept=float(opts["target_accept"]),
                max_tree_depth=int(opts["max_tree_depth"]),
                initial_step_size=float(opts["initial_step_size"]),
                steps_per_call=(
                    int(opts["steps_per_call"])
                    if opts.get("steps_per_call") is not None
                    else None
                ),
                potential_args=loss_args,
            )
            result.samples.block_until_ready()
            self.sampling_time = _time.perf_counter() - t0
            if precondition == "hessian":
                # draws were taken in w = Rᵀ(z - z*) coordinates; map back
                # to the model's latents before any downstream use
                from ..inference.mcmc import unwhiten_samples

                result = result._replace(
                    samples=unwhiten_samples(result.samples, R_pre, z_map_pre)
                )
            flat = result.samples.reshape((-1,) + result.samples.shape[2:])
            self.pre_transformation = flat.mean(axis=0).reshape(latent_shape)
            self.pre_transformation_std = flat.std(axis=0).reshape(latent_shape)
            self.posterior_samples = result.samples.reshape(
                result.samples.shape[:2] + latent_shape
            )
            self.mcmc_result = result
            self.losses = _jnp.ravel(result.potential)
            # the north-star throughput metric is effective samples per
            # second (BASELINE.md), not raw draws/s — summarize it here so
            # every estimator-level NUTS run reports it
            from ..inference.diagnostics import effective_sample_size

            import numpy as _np

            ess = _np.asarray(effective_sample_size(result.samples))
            self.ess = ess
            self.ess_per_second = float(_np.min(ess) / self.sampling_time)
            logger.info(
                "NUTS: %d draws in %.2fs; ESS min/median %.0f/%.0f "
                "(%.1f effective samples/s, min-ESS basis).",
                int(opts["num_chains"]) * int(opts["num_samples"]),
                self.sampling_time,
                float(_np.min(ess)),
                float(_np.median(ess)),
                self.ess_per_second,
            )
        elif optimizer == "smc":
            import jax as _jax
            import jax.numpy as _jnp

            from ..inference.smc import loglik_from_loss, run_smc

            seed = (
                self.random_state
                if self.random_state is not None
                else DEFAULT_RANDOM_SEED
            )
            if initial_value.ndim != 1:
                raise ValueError(
                    "optimizer='smc' currently supports 1-d latent vectors."
                )
            dim = int(initial_value.shape[-1])
            smc_opts = {"num_particles": 1024}
            smc_opts.update(
                {
                    k: v
                    for k, v in self.sampler_options.items()
                    if k in _SMC_OPTION_KEYS
                }
            )
            smc_opts["num_particles"] = int(smc_opts["num_particles"])
            for int_key in ("num_mutation_steps", "num_leapfrog_steps",
                            "max_stages"):
                if int_key in smc_opts:
                    smc_opts[int_key] = int(smc_opts[int_key])
            start = smc_opts.pop("start", "prior")
            prior_kwargs = {}
            if start == "laplace":
                # anneal from the diagonal-Laplace Gaussian at the MAP with
                # the adjusted likelihood (same beta=1 target and evidence;
                # short well-mixed schedule on peaked posteriors)
                from ..inference.smc import laplace_start

                loglik, prior_kwargs = laplace_start(
                    loss_fn, loss_args, initial_value
                )
            else:
                loglik = loglik_from_loss(loss_fn)
            result = run_smc(
                loglik,
                dim,
                _jax.random.PRNGKey(seed),
                loglik_args=loss_args,
                **prior_kwargs,
                **smc_opts,
            )
            self.pre_transformation = result.particles.mean(axis=0)
            self.pre_transformation_std = result.particles.std(axis=0)
            self.posterior_samples = result.particles
            self.smc_result = result
            self.losses = [float(-result.log_evidence)]
        else:
            error = ValueError(
                f"Unknown optimizer {optimizer}. You can use .loss_func and "
                ".initial_value as loss function and initial state for an "
                "external optimization. Write optimal state to "
                ".pre_transformation to enable prediction with .predict()."
            )
            logger.error(error)
            raise error

        if optimizer != "advi" and self.predictor_with_uncertainty:
            if self.pre_transformation_std is None:
                logger.info(
                    "Computing Laplace approximation for posterior uncertainty."
                )
                self.pre_transformation_std = compute_laplace_std(
                    loss_fn,
                    self.pre_transformation,
                    jit=self.jit,
                    loss_args=loss_args,
                )

    def _prepare_attribute(self, attribute):
        """Lazy attribute computation via the ``_compute_<attr>`` convention
        (parity: ``mellon/base_model.py:433-446``)."""
        if getattr(self, attribute) is not None:
            return
        function = getattr(self, "_compute_" + attribute)
        setattr(self, attribute, function())

    def prepare_inference(self, x):
        ...

    def fit(self):
        ...

    @property
    def predict(self):
        ...

    def fit_predict(self, x):
        ...
