"""Foundation utilities: distances, jitter, MLE, GP-type enum, serialization.

Behavioural parity target: ``mellon/util.py`` (reference).  The numerical
functions are written XLA-first: pairwise distances go through a single
matmul, and everything is jit/vmap/shard
friendly (no data-dependent Python control flow).
"""

import functools
import inspect
import logging
from enum import Enum
from inspect import Parameter
from typing import List

import jax
import jax.numpy as jnp
from jax.scipy.special import gammaln

from .validation import validate_array

logger = logging.getLogger("mellon_tpu")

DEFAULT_JITTER = 1e-6
DEFAULT_RANK_TOL = 5e-1


# ---------------------------------------------------------------------------
# distances
# ---------------------------------------------------------------------------

@jax.jit
def distance(x, y):
    """Pairwise Euclidean distances via one matmul, fused into one
    program.

    Parity: ``mellon/util.py:351-366`` (including the 1e-12 epsilon inside the
    sqrt for gradient stability at zero distance).
    """
    xx = jnp.sum(x * x, axis=1)[:, None]
    yy = jnp.sum(y * y, axis=1)[None, :]
    # HIGHEST (full f32): a reduced-precision product (one bf16 pass,
    # ~1e-3 relative, or TF32, the GPU's default for f32 dots) puts
    # orders more noise on every kernel gram than f32 rounding (~6e-8) —
    # at degenerate kernel conditioning that noise is amplified by
    # cond(Lp) through the whitening.  The contraction is over d (tiny
    # FLOPs next to the O(n*m) output), so full precision is free.
    xy = jnp.tensordot(
        x, y, axes=(1, 1), precision=jax.lax.Precision.HIGHEST
    )
    sq = xx - 2 * xy + yy + 1e-12
    # floor at the epsilon, not at 0: f32 cancellation can leave sq <= 0 for
    # coincident points despite the epsilon, and autodiff through sqrt(0)
    # yields 0 * inf = NaN (it poisoned predictor.gradient at training
    # points); where the floor binds, d(maximum)/d(sq) = 0 so the gradient
    # is exactly 0 — the correct limit for the symmetric distance
    return jnp.sqrt(jnp.maximum(sq, 1e-12))


def distance_grad(x, eps=1e-12):
    """Return ``f(y) -> (dist (n,m), grad (n,m,d))`` for fixed x.

    Parity: ``mellon/util.py:369-426``.
    """
    xx = jnp.sum(x * x, axis=1)[:, None]

    def grad(y):
        yy = jnp.sum(y * y, axis=1)[None, :]
        xy = jnp.tensordot(
            x, y, axes=(1, 1), precision=jax.lax.Precision.HIGHEST
        )
        sq = xx - 2 * xy + yy + eps
        dist = jnp.sqrt(jnp.maximum(sq, 0))
        delta = y[None, :] - x[:, None]
        gradient = delta / (dist[..., None] + eps)
        return dist, gradient

    return grad


def batched_vmap(func, x, *args, batch_size=100):
    """Apply ``vmap(func)`` over row-batches of x to bound peak memory.

    Parity: ``mellon/util.py:52-60``.  Uses a Python loop over static batch
    boundaries (each batch shape is static, so XLA caches two compilations at
    most: full batch and remainder).
    """
    n = x.shape[0]
    out = []
    vfunc = jax.vmap(func, in_axes=(0,) + (None,) * len(args))
    for start in range(0, n, batch_size):
        out.append(vfunc(x[start : start + batch_size], *args))
    return jnp.vstack(out)


# ---------------------------------------------------------------------------
# jitter / covariance stabilization
# ---------------------------------------------------------------------------

def add_diagonal(A, value):
    """A + value * I (parity: ``mellon/util.py:269-280``)."""
    idx = jnp.arange(A.shape[0])
    return A.at[..., idx, idx].add(value)


def stabilize(A, jitter=DEFAULT_JITTER):
    """Add jitter to the diagonal (parity: ``mellon/util.py:283-293``)."""
    return add_diagonal(A, jitter)


def add_variance(K, M=None, jitter=DEFAULT_JITTER):
    """K + M Mᵀ with a floor of ``jitter`` on the added diagonal.

    Parity: ``mellon/util.py:296-331``.
    """
    if M is None:
        return stabilize(K, jitter=jitter)
    if jnp.isscalar(M) or getattr(M, "ndim", None) == 0:
        sigma2 = max(jitter, float(M) ** 2)
        return add_diagonal(K, sigma2)
    noise = M @ M.T
    diag_noise = jnp.diagonal(noise)
    diff = jnp.where(diag_noise < jitter, jitter - diag_noise, 0)
    return K + noise + jnp.diag(diff)


# ---------------------------------------------------------------------------
# nearest-neighbor MLE of log density
# ---------------------------------------------------------------------------

def mle(nn_distances, d):
    """Point-wise MLE of log density from 1-NN distances in d dimensions.

    Parity: ``mellon/util.py:334-348``.
    """
    return gammaln(d / 2 + 1) - (d / 2) * jnp.log(jnp.pi) - d * jnp.log(nn_distances)


# ---------------------------------------------------------------------------
# active-dims helpers (feature sub-spaces for product kernels)
# ---------------------------------------------------------------------------

def ensure_2d(X):
    """Promote 1-d arrays to a column-per-sample 2-d layout
    (parity: ``mellon/util.py:135-147``)."""
    return jnp.atleast_2d(X.T).T


def select_active_dims(x, active_dims):
    """Slice the feature axis (parity: ``mellon/util.py:150-171``)."""
    if active_dims is not None:
        if jnp.isscalar(active_dims):
            active_dims = [active_dims]
        x = x[..., active_dims]
    return x


def expand_to_inactive(values, target_shape, active_dims):
    """Scatter gradient values into the full feature axis, zeros elsewhere
    (parity: ``mellon/util.py:174-203``)."""
    if active_dims is None:
        return values
    if jnp.isscalar(active_dims):
        active_dims = [active_dims]
    full = jnp.zeros(target_shape, dtype=values.dtype)
    return full.at[..., active_dims].set(values)


# ---------------------------------------------------------------------------
# multi-time vmap decorator
# ---------------------------------------------------------------------------

def make_multi_time_argument(func):
    """Add an optional ``multi_time`` kwarg that vmaps the wrapped method over
    a grid of time values (parity: ``mellon/util.py:206-266``)."""
    sig = inspect.signature(func)
    new_params = list(sig.parameters.values()) + [
        Parameter("multi_time", Parameter.POSITIONAL_OR_KEYWORD, default=None)
    ]
    new_sig = sig.replace(parameters=new_params)

    @functools.wraps(func)
    def wrapper(self, *args, **kwargs):
        multi_time = kwargs.pop("multi_time", None)
        do_jit = kwargs.get("jit", False)
        if multi_time is not None:
            if kwargs.get("time", None) is not None:
                raise ValueError(
                    "Cannot specify both 'time' and 'multi_time' arguments"
                )
            multi_time = validate_array(multi_time, "multi_time")

            def at_time(t):
                return func(self, *args, **kwargs, time=t)

            if do_jit:
                at_time = jax.jit(at_time)
            return jax.vmap(at_time, in_axes=0, out_axes=1)(multi_time)
        return func(self, *args, **kwargs)

    wrapper.__signature__ = new_sig
    return wrapper


# ---------------------------------------------------------------------------
# rank diagnostics
# ---------------------------------------------------------------------------

def test_rank(input, tol=DEFAULT_RANK_TOL, threshold=None):
    """Approximate-rank diagnostic of the transformation matrix L
    (parity: ``mellon/util.py:429-483``)."""
    if hasattr(input, "shape"):
        L = input
    elif hasattr(input, "L"):
        L = input.L
        if L is None:
            raise AttributeError(
                "Matrix L is not found in the estimator object. "
                "Consider running `.prepare_inference()`."
            )
    else:
        raise TypeError(
            "Input must be either a matrix or an estimator with a transformation L."
        )
    if len(L.shape) != 2:
        raise ValueError("Matrix L must be 2D.")

    approx_rank = jnp.linalg.matrix_rank(L, rtol=tol)
    max_rank = min(L.shape)
    rank_fraction = float(approx_rank) / max_rank

    if threshold is not None:
        if rank_fraction > threshold:
            logger.warning(
                f"High approx. rank fraction ({rank_fraction:.1%}). "
                "Consider increasing 'n_landmarks'."
            )
        else:
            logger.info(
                f"Rank fraction ({rank_fraction:.1%}, lower is better) is "
                "within acceptable range. Current settings should provide "
                "satisfactory model performance."
            )
    else:
        print(
            f"The approx. rank fraction is {rank_fraction:.1%} "
            f"({int(approx_rank):,} of {max_rank:,}). Lower is better."
        )
    return int(approx_rank)


# ---------------------------------------------------------------------------
# serialization primitives (mellon-compatible typed JSON encoding)
# ---------------------------------------------------------------------------

def _None_to_str(v):
    return "None" if v is None else v


def _str_to_None(v):
    if isinstance(v, str) and v == "None":
        return None
    return v


def make_serializable(x):
    """Typed JSON encoding of arrays/slices/dicts/sets.

    On-disk format parity: ``mellon/util.py:69-97`` — arrays are tagged
    ``{"type": "jax.numpy", "data": [...]}`` so predictors serialized by the
    reference load here and vice versa.
    """
    if isinstance(x, bool):
        return x
    if hasattr(x, "dtype") and hasattr(x, "tolist"):
        # numpy / jax arrays and scalars
        if getattr(x, "ndim", 1) == 0:
            return x.item()
        return {"type": "jax.numpy", "data": x.tolist()}
    if isinstance(x, int):
        return int(x)
    if isinstance(x, float):
        return float(x)
    if isinstance(x, slice):
        dat = [_None_to_str(v) for v in (x.start, x.stop, x.step)]
        return {"type": "slice", "data": dat}
    if isinstance(x, dict):
        return {"type": "dict", "data": {k: make_serializable(v) for k, v in x.items()}}
    if isinstance(x, (set, frozenset)):
        return {"type": "set", "data": [make_serializable(v) for v in x]}
    return _None_to_str(x)


def deserialize(serializable_x):
    """Inverse of :func:`make_serializable`
    (format parity: ``mellon/util.py:106-132``)."""
    if isinstance(serializable_x, dict):
        data_type = serializable_x.get("type")
        if data_type == "jax.numpy":
            return jnp.asarray(serializable_x["data"])
        if data_type == "slice":
            dat = [_str_to_None(v) for v in serializable_x["data"]]
            return slice(*dat)
        if data_type == "dict":
            return {k: deserialize(v) for k, v in serializable_x["data"].items()}
        if data_type == "set":
            return {deserialize(v) for v in serializable_x["data"]}
        return serializable_x
    return _str_to_None(serializable_x)


# ---------------------------------------------------------------------------
# GP type enum
# ---------------------------------------------------------------------------

class GaussianProcessType(str, Enum):
    """Sparse-GP strategy selector with fuzzy string parsing.

    Parity: ``mellon/util.py:589-667``.
    """

    FULL = "full"
    FULL_NYSTROEM = "full_nystroem"
    SPARSE_CHOLESKY = "sparse_cholesky"
    SPARSE_NYSTROEM = "sparse_nystroem"
    FIXED = "fixed"

    @staticmethod
    def from_string(s, optional: bool = False):
        if s is None:
            if optional:
                return None
            logger.error("Gaussian process type must be specified but is None.")
            raise ValueError("Gaussian process type must be specified but is None.")
        if isinstance(s, GaussianProcessType):
            return s
        if not isinstance(s, str):
            # e.g. the class object itself was passed as a "no value" marker
            if s is GaussianProcessType and optional:
                return None
            raise ValueError(f"Unknown Gaussian Process type: {s}")

        normalized = s.lower().replace(" ", "_")
        for gp_type in GaussianProcessType:
            if gp_type.value == normalized:
                logger.info(f"Gaussian Process type: {gp_type.value}")
                return gp_type
        for gp_type in GaussianProcessType:
            if normalized in gp_type.value:
                logger.warning(
                    f"Partial match found for Gaussian Process type: "
                    f"{gp_type.value}. Input was: {s}"
                )
                return gp_type
        message = f"Unknown Gaussian Process type: {s}"
        logger.error(message)
        raise ValueError(message)


# ---------------------------------------------------------------------------
# repr helpers and verbosity
# ---------------------------------------------------------------------------

def object_str(obj: object, dim_names: List[str] = None) -> str:
    """Concise metadata repr for arrays (parity: ``mellon/util.py:670-711``)."""
    if hasattr(obj, "shape") and hasattr(obj, "dtype"):
        dims = obj.shape
        if dim_names:
            dim_strs = [f"{dim:,} {name}" for dim, name in zip(dims, dim_names)]
        else:
            dim_strs = [f"{dim:,}" for dim in dims]
        for i in range(len(dim_strs), len(dims)):
            dim_strs.append(f"{dims[i]} dimension {i + 1}")
        dim_str = " x ".join(dim_strs)
        return f"<array {dim_str}, dtype={obj.dtype}>"
    return str(obj)


def object_html(obj: object, dim_names: list = None) -> str:
    """HTML metadata repr (parity: ``mellon/util.py:714-761``)."""

    def escape_html(text):
        return (
            str(text)
            .replace("&", "&amp;")
            .replace("<", "&lt;")
            .replace(">", "&gt;")
            .replace('"', "&quot;")
            .replace("'", "&#39;")
        )

    if hasattr(obj, "shape") and hasattr(obj, "dtype"):
        dims = obj.shape
        dim_names = dim_names or []
        dim_strs = [
            f"{dim:,} {name}" if name else f"{dim:,}"
            for dim, name in zip(dims, dim_names + [None] * (len(dims) - len(dim_names)))
        ]
        dim_str = " x ".join(dim_strs)
        return (
            f"<span>&lt;array {escape_html(dim_str)}, "
            f"dtype={escape_html(obj.dtype)}&gt;</span>"
        )
    return f"<span>{escape_html(obj)}</span>"


def set_verbosity(verbose: bool):
    """Toggle INFO/WARNING logging (parity: ``mellon/util.py:539-569``)."""
    level = logging.INFO if verbose else logging.WARNING
    logger.setLevel(level)
    logger.info(f"Logging verbosity set to {'INFO' if verbose else 'WARNING'}.")


from ..config import set_jax_config  # noqa: E402  (re-export for API parity)


def __getattr__(name):
    # lazy re-export for API parity with ``mellon.util.local_dimensionality``
    # (``mellon/util.py:486-536``); the device implementation lives in
    # ops.neighbors, which imports this module (direct import would cycle)
    if name == "local_dimensionality":
        from ..ops.neighbors import local_dimensionality

        return local_dimensionality
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
