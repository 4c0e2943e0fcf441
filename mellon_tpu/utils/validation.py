"""Input validation helpers.

Behavioural parity target: ``mellon/validation.py`` (reference).  The
functions keep the reference's error semantics (same triggering conditions)
so that estimator-level error-path tests carry over, but the implementation
is our own and dtype-aware (f32 by default, f64 when x64 is enabled).
"""

from collections.abc import Iterable
import logging
import math

import jax
import jax.numpy as jnp

logger = logging.getLogger("mellon_tpu")


def _to_python_scalar(value):
    """Collapse 0-d numpy/JAX scalars to Python scalars; pass through others."""
    if hasattr(value, "item") and getattr(value, "ndim", None) == 0:
        try:
            return value.item()
        except (ValueError, TypeError):
            return value
    if hasattr(value, "item") and not hasattr(value, "ndim"):
        # numpy scalar types without ndim attribute
        try:
            return value.item()
        except (ValueError, TypeError):
            return value
    return value


def validate_array(iterable, name, optional=False, ndim=None):
    """Convert to a float array; allow tracers; parity with
    ``mellon/validation.py:302-361``."""
    if iterable is None:
        if optional:
            return None
        raise TypeError(f"'{name}' can't be None.")

    if hasattr(iterable, "todense"):
        array = jnp.asarray(iterable.todense(), dtype=float)
    elif isinstance(iterable, Iterable) or hasattr(iterable, "shape"):
        array = jnp.asarray(iterable, dtype=float)
    else:
        raise TypeError(
            f"'{name}' should be iterable or sparse, got {type(iterable)} instead."
        )

    if ndim is not None:
        allowed = (ndim,) if isinstance(ndim, int) else tuple(ndim)
        if array.ndim not in allowed:
            raise ValueError(
                f"'{name}' must be a {allowed}-dimensional array, "
                f"got {array.ndim}-dimensional array instead."
            )
    return array


def validate_time_x(x, times=None, n_features=None, cast_scalar=False):
    """Concatenate a time column onto x; parity with
    ``mellon/validation.py:23-101``."""
    x = validate_array(x, "x", ndim=2)
    if (
        cast_scalar
        and times is not None
        and (jnp.isscalar(times) or all(s == 1 for s in getattr(times, "shape", ())))
    ):
        times = jnp.full(x.shape[0], times)
    times = validate_array(times, "times", optional=True, ndim=(1, 2))

    if times is not None:
        if times.ndim == 1:
            times = times.reshape(-1, 1)
        elif times.ndim != 2 or times.shape[1] != 1:
            raise ValueError("'times' must be a 1D array or a 2D array with 1 column.")
        if x.shape[0] != times.shape[0]:
            raise ValueError(
                "'x' and 'times' must have the same number of samples. "
                f"Got {x.shape[0]} for 'x' and {times.shape[0]} for 'times'."
            )
        x = jnp.concatenate((x, times), axis=1)

    if n_features is not None:
        if x.shape[1] == n_features - 1 and times is None:
            raise ValueError(
                f"Expected {n_features} features including 'times' in 'x' but "
                f"only found {x.shape[1]} features and 'times' is not provided."
            )
        if x.shape[1] != n_features:
            raise ValueError(
                f"Wrong number of features in 'x'. Expected {n_features} "
                f"but got {x.shape[1]}."
            )
    return x


def validate_float_or_int(value, param_name, optional=False):
    if value is None and optional:
        return None
    value = _to_python_scalar(value)
    if not isinstance(value, (float, int)):
        try:
            value = float(value)
        except TypeError:
            raise ValueError(
                f"'{param_name}' should be a positive integer or float number "
                f"but is {type(value)}"
            )
    if isinstance(value, float) and math.isnan(value):
        raise ValueError(f"'{param_name}' should be a non-NaN float number")
    return value


def validate_positive_float(value, param_name, optional=False):
    if value is None and optional:
        return None
    value = _to_python_scalar(value)
    try:
        value = float(value)
    except (TypeError, ValueError):
        raise ValueError(
            f"'{param_name}' should be a float number but is {type(value)}"
        )
    if value <= 0:
        raise ValueError(f"'{param_name}' should be a positive float number")
    if math.isnan(value):
        raise ValueError(f"'{param_name}' should be a non-NaN float number")
    return value


def validate_float(value, param_name, optional=False):
    if value is None:
        if optional:
            return None
        raise ValueError(
            f"'{param_name}' is None, but is required to be a float number"
        )
    if hasattr(value, "size") and getattr(value, "size", None) == 1:
        value = jnp.squeeze(jnp.asarray(value))
    value = _to_python_scalar(value)
    if not isinstance(value, (float, int)):
        try:
            value = float(value)
        except TypeError:
            raise ValueError(
                f"'{param_name}' should be a float number but is {type(value)}"
            )
    if isinstance(value, float) and math.isnan(value):
        raise ValueError(f"'{param_name}' should be a non-NaN float number")
    return value


def validate_positive_int(value, param_name, optional=False):
    if optional and value is None:
        return None
    value = _to_python_scalar(value)
    if isinstance(value, bool) or not isinstance(value, int) or value < 0:
        raise ValueError(f"'{param_name}' should be a positive integer number")
    return value


def validate_bool(value, name, optional=False):
    if value is None:
        if optional:
            return None
        raise TypeError(f"'{name}' can't be None.")
    if not isinstance(value, bool):
        raise TypeError(f"{name} should be of type bool, got {type(value)} instead.")
    return value


def validate_string(value, name, choices=None):
    if not isinstance(value, str):
        raise TypeError(f"{name} should be of type str, got {type(value)} instead.")
    if choices and value not in choices:
        raise ValueError(f"{name} should be one of {choices}, got '{value}' instead.")
    return value


def validate_float_or_iterable_numerical(value, name, optional=False, positive=False):
    if value is None and optional:
        return None
    if getattr(value, "ndim", None) == 0:
        value = _to_python_scalar(value)
    if isinstance(value, bool):
        raise TypeError(
            f"{name} should be of type int, float or iterable, got {type(value)} instead."
        )
    if isinstance(value, (int, float)):
        value = float(value)
        if positive and value < 0:
            raise ValueError(f"{name} should be a non-negative number or array")
        return value
    if (isinstance(value, Iterable) and not isinstance(value, str)) or hasattr(
        value, "shape"
    ):
        result = jnp.asarray(value, dtype=float)
        if positive and bool((result < 0).any()):
            raise ValueError(f"All elements in {name} should be non-negative")
        return result
    raise TypeError(
        f"{name} should be of type int, float or iterable, got {type(value)} instead."
    )


def validate_1d(x):
    x = jnp.asarray(x, dtype=float)
    if x.ndim == 0:
        x = x[None]
    if x.ndim != 1:
        raise ValueError("`x` must be exactly 1-dimensional.")
    return x


def _nn_repair_kernel(nn_distances):
    """Single fused computation of invalid-value masks, counts and repaired
    distances (one jit call instead of ~8 eager dispatches)."""
    return _nn_repair_jit(nn_distances)


def _nn_repair_impl(nn):
    nan_mask = jnp.isnan(nn)
    inf_mask = jnp.isinf(nn)
    non_positive_mask = nn <= 0
    bad_idx = nan_mask | inf_mask | non_positive_mask
    min_positive = jnp.min(jnp.where(bad_idx, jnp.inf, nn))
    repaired = jnp.where(~bad_idx, nn, min_positive)
    return (
        repaired,
        nan_mask.sum(),
        inf_mask.sum(),
        non_positive_mask.sum(),
        jnp.all(bad_idx),
    )


# module-level jit: one stable program instead of a fresh closure (and thus
# a retrace + program load) per fit
_nn_repair_jit = jax.jit(_nn_repair_impl)


def report_nn_repair(nan_count, inf_count, negative_count, all_bad):
    """Emit the repair warning / all-invalid error for pre-fetched repair
    counts (shared by :func:`validate_nn_distances` and the fused prepare
    path, which computes the counts inside one larger program)."""
    nan_count = int(nan_count)
    inf_count = int(inf_count)
    negative_count = int(negative_count)
    total_invalid = nan_count + inf_count + negative_count

    if bool(all_bad):
        message = (
            f"All {total_invalid:,} computed nearest neighbor distances "
            "(`nn_distances` attribute) contain invalid values: "
            f"{nan_count:,} NaN, {inf_count:,} infinite, "
            f"{negative_count:,} less or equal 0. "
            "Please check the input data. Setting invalid distances to the "
            "minimum positive value found."
        )
        logger.error(message)
        raise ValueError(message)

    if total_invalid > 0:
        logger.warning(
            "The computed nearest neighbor distances (`nn_distances` attribute) "
            f"contain {total_invalid:,} invalid values: {nan_count:,} NaN, "
            f"{inf_count:,} infinite, {negative_count:,} less or equal 0. "
            "Please check the input data. Setting invalid distances to the "
            "minimum positive value found."
        )


def validate_nn_distances(nn_distances, optional=False):
    """Repair invalid nearest-neighbor distances; parity with
    ``mellon/validation.py:528-592``."""
    if nn_distances is None:
        if optional:
            return None
        message = "nn_distances are required but None is given."
        logger.error(message)
        raise ValueError(message)

    repaired, nan_count, inf_count, negative_count, all_bad = _nn_repair_kernel(
        nn_distances
    )
    # one host transfer for all four scalars (each separate int()/bool()
    # would be its own blocking device round trip)
    nan_count, inf_count, negative_count, all_bad = jax.device_get(
        (nan_count, inf_count, negative_count, all_bad)
    )
    report_nn_repair(nan_count, inf_count, negative_count, all_bad)
    return repaired


def validate_k(k, n_samples):
    """Parity with ``mellon/validation.py:595-611``."""
    if isinstance(k, bool) or not isinstance(k, int):
        message = f"Parameter k must be an integer, got {type(k).__name__} instead."
        logger.error(message)
        raise ValueError(message)
    if k < 1:
        message = f"Parameter k must be at least 1, got {k}."
        logger.error(message)
        raise ValueError(message)
    if k >= n_samples:
        message = (
            "Parameter k must be smaller than the number of samples. "
            f"Got k={k:,} with {n_samples:,} samples."
        )
        logger.error(message)
        raise ValueError(message)
