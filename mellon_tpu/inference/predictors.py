"""Predictor facade: callable conditional-mean functions with uncertainty,
derivatives, and JSON serialization.

Behavioural parity target: ``mellon/base_predictor.py`` (1194 LoC).  The
on-disk JSON format is kept interchangeable with the reference — including
the <1.4.0 migration shim and class re-resolution by module path — so
predictors serialized by mellon load here and vice versa (module names
beginning with ``mellon.`` are mapped onto our classes).
"""

import bz2
import gzip
import json
import logging
import re
import sys
from abc import ABC, abstractmethod
from datetime import datetime
from functools import wraps
from importlib import import_module
from typing import List, Set, Union

import jax.numpy as jnp

from ..ops.kernels import Covariance
from ..utils.util import (
    deserialize,
    ensure_2d,
    make_multi_time_argument,
    make_serializable,
    object_html,
    object_str,
)
from ..utils.validation import (
    validate_array,
    validate_bool,
    validate_time_x,
)
from .derivatives import gradient, hessian, hessian_log_determinant

logger = logging.getLogger("mellon_tpu")

# queries larger than this evaluate in row chunks so the (n_query, m) kernel
# tile stays memory-bounded at atlas scale
PREDICT_CHUNK_SIZE = 200_000


def _release_tuple(version):
    """Numeric release of a version string, e.g. "1.3.0rc1" -> (1, 3, 0);
    None when it does not start with a number."""
    match = re.match(r"v?(\d+(?:\.\d+)*)", str(version).strip())
    return tuple(int(p) for p in match.group(1).split(".")) if match else None


def _chunked_rows(fn, x, chunk_size=PREDICT_CHUNK_SIZE):
    n = x.shape[0]
    if n <= chunk_size:
        return fn(x)
    parts = [fn(x[start : start + chunk_size]) for start in range(0, n, chunk_size)]
    return jnp.concatenate(parts, axis=0)


def _check_n_features(obj, x):
    if x.shape[1] != obj.n_input_features:
        raise ValueError(
            f"The predictor was trained on data with {obj.n_input_features} "
            f"features. However, the provided input data has {x.shape[1]} "
            "features. Please ensure that the input data has the same number "
            "of features as the training data."
        )


def _normalization_warnings(obj):
    """Emit the d/d_method advisory messages
    (parity: ``mellon/base_predictor.py:229-252``)."""
    if obj.d_method == "fractal":
        return
    if obj.d_method == "manual":
        logger.info(
            f"Using normalization with manually set d={obj.d}. "
            "Note: Normalization is most effective when d approximates the "
            "intrinsic dimensionality of the data."
        )
    elif (
        obj.d_method is None
        and isinstance(obj.d, (int, float))
        and float(obj.d).is_integer()
    ) or obj.d_method == "embedding":
        logger.warning(
            "The normalization is only effective if d approximates the "
            f"intrinsic dimensionality. Current values: d_method={obj.d_method}, "
            f'd={obj.d}. Consider using d_method="fractal" for more accurate '
            "results."
        )


class Predictor(ABC):
    """Conditional-mean predictor (parity: ``mellon/base_predictor.py:43-734``)."""

    n_input_features: int
    n_obs: int
    d: int = None
    d_method: str = None
    _state_variables: Union[Set, List]

    @abstractmethod
    def __init__(self):
        ...

    def __str__(self):
        return self.__repr__()

    def __repr__(self):
        n_obs = "None" if self.n_obs is None else f"{self.n_obs:,}"
        return (
            'A predictor of class "'
            + self.__class__.__name__
            + '" with covariance function "'
            + repr(self.cov_func)
            + f'" trained on {n_obs} observations '
            + f"with {self.n_input_features:,} features "
            + "and data:\n"
            + "\n".join(
                str(key) + ": " + object_str(v) for key, v in self._data_dict().items()
            )
        )

    def _repr_html_(self):
        n_obs = "None" if self.n_obs is None else f"{self.n_obs:,}"
        header = f"""
        <h2>Predictor Object: {self.__class__.__name__}</h2>
        <p><strong>Covariance Function:</strong> {repr(self.cov_func)}</p>
        <p><strong>Trained on:</strong> {n_obs} observations</p>
        <p><strong>Number of Features:</strong> {self.n_input_features:,}</p>
        """
        rows = "".join(
            f"<tr><td>{key}</td><td>{object_html(value)}</td></tr>"
            for key, value in self._data_dict().items()
        )
        table = f"""
        <h3>Data Attributes</h3>
        <table style="border: 1px solid black; border-collapse: collapse;">
            <tr><th>Attribute</th><th>Value</th></tr>
            {rows}
        </table>
        """
        return header + table

    @abstractmethod
    def _mean(self, *args, **kwargs):
        ...

    def mean(self, x, normalize=False):
        """Conditional mean at x with optional log(n_obs) normalization
        (parity: ``mellon/base_predictor.py:180-257``)."""
        x = validate_array(x, "x")
        x = ensure_2d(x)
        normalize = validate_bool(normalize, "normalize")
        _check_n_features(self, x)
        if normalize:
            if self.n_obs is None or self.n_obs == 0:
                message = (
                    "Cannot normalize without n_obs. Please set self.n_obs to "
                    "the number of samples/cells trained on to enable "
                    "normalization."
                )
                logger.error(message)
                raise ValueError(message)
            _normalization_warnings(self)
            return _chunked_rows(self._mean, x) - jnp.log(self.n_obs)
        return _chunked_rows(self._mean, x)

    __call__ = mean

    @abstractmethod
    def _leverage(self, Xnew, sigma):
        ...

    def leverage(self, x):
        """Diagonal of the hat matrix H = K (K + sigma² I)⁻¹
        (parity: ``mellon/base_predictor.py:263-288``)."""
        x = validate_array(x, "x")
        x = ensure_2d(x)
        _check_n_features(self, x)
        return self._leverage(x, self.sigma)

    def loo_residuals_squared(self, x, y):
        """HC3 squared leave-one-out residuals r²/(1-h)²
        (parity: ``mellon/base_predictor.py:290-324``)."""
        x = validate_array(x, "x")
        y = validate_array(y, "y")
        x = ensure_2d(x)
        _check_n_features(self, x)
        prediction = self._mean(x)
        residual = y - prediction
        h = self._leverage(x, self.sigma)
        if residual.ndim > h.ndim:
            h = h[..., None]
        return residual**2 / (1 - h) ** 2

    @abstractmethod
    def _obs_variance(self, Xnew):
        ...

    def obs_variance(self, x):
        """Smoothed observation-noise variance surface
        (parity: ``mellon/base_predictor.py:330-355``)."""
        x = validate_array(x, "x")
        x = ensure_2d(x)
        _check_n_features(self, x)
        return self._obs_variance(x)

    @abstractmethod
    def _covariance(self, *args, **kwargs):
        ...

    def _has_per_feature_sigma(self):
        return getattr(self, "per_feature_sigma", False)

    def covariance(self, x, diag=True, noise_free=False):
        """Posterior covariance of the conditional GP
        (parity: ``mellon/base_predictor.py:365-415``)."""
        if self._has_per_feature_sigma() and not noise_free:
            raise ValueError(
                "This predictor was fitted with per-feature sigma, so the "
                "covariance is noise-free (sigma=0) and does not include "
                "observation noise. Pass noise_free=True to acknowledge this "
                "and obtain the noise-free covariance, then account for "
                "observation noise separately (e.g., via obs_variance)."
            )
        x = validate_array(x, "x")
        x = ensure_2d(x)
        _check_n_features(self, x)
        if diag:
            return _chunked_rows(lambda b: self._covariance(b, diag=True), x)
        return self._covariance(x, diag=diag)

    @abstractmethod
    def _mean_covariance(self, *args, **kwargs):
        ...

    def mean_covariance(self, x, diag=True):
        """Mean-function covariance from parameter uncertainty
        (parity: ``mellon/base_predictor.py:421-448``)."""
        x = validate_array(x, "x")
        x = ensure_2d(x)
        _check_n_features(self, x)
        if diag:
            return _chunked_rows(
                lambda b: self._mean_covariance(b, diag=True), x
            )
        return self._mean_covariance(x, diag=diag)

    def uncertainty(self, x, diag=True):
        """Total predictive uncertainty = covariance + mean_covariance
        (parity: ``mellon/base_predictor.py:450-479``)."""
        x = validate_array(x, "x")
        x = ensure_2d(x)
        _check_n_features(self, x)
        return self._covariance(x, diag=diag) + self._mean_covariance(x, diag=diag)

    def _data_dict(self):
        return {key: getattr(self, key) for key in self._state_variables}

    def gradient(self, x, jit=True):
        """Per-point gradient of the mean
        (parity: ``mellon/base_predictor.py:490-505``)."""
        x = validate_array(x, "x")
        x = ensure_2d(x)
        return gradient(self._mean, x, jit=jit)

    def hessian(self, x, jit=True):
        """Per-point Hessian of the mean
        (parity: ``mellon/base_predictor.py:507-521``)."""
        x = validate_array(x, "x")
        x = ensure_2d(x)
        return hessian(self.__call__, x, jit=jit)

    def hessian_log_determinant(self, x, jit=True):
        """Per-point slogdet of the Hessian
        (parity: ``mellon/base_predictor.py:523-539``)."""
        x = validate_array(x, "x")
        x = ensure_2d(x)
        return hessian_log_determinant(self.__call__, x, jit=jit)

    # -- serialization ------------------------------------------------------

    def __getstate__(self):
        module_name = self.__class__.__module__
        try:
            metamodule = import_module(module_name.split(".")[0])
            version = getattr(metamodule, "__version__", "NA")
        except ImportError:
            version = "NA"
        data = self._data_dict()
        data.update(
            {
                "n_input_features": self.n_input_features,
                "n_obs": self.n_obs,
                "d": self.d,
                "d_method": self.d_method,
                "_state_variables": self._state_variables,
            }
        )
        data = {k: make_serializable(v) for k, v in data.items()}
        return {
            "data": data,
            "cov_func": self.cov_func.__getstate__(),
            "metadata": {
                "classname": self.__class__.__name__,
                "module_name": module_name,
                "module_version": version,
                "serialization_date": datetime.now().isoformat(),
                "python_version": sys.version,
            },
        }

    def __setstate__(self, state):
        for name, value in state["data"].items():
            setattr(self, name, deserialize(value))
        self.cov_func = Covariance.from_dict(state["cov_func"])

    def copy(self):
        """Deep copy through serialization
        (parity: ``mellon/base_predictor.py:597-602``)."""
        state = self.__getstate__()
        new_instance = self.__class__.__new__(self.__class__)
        new_instance.__setstate__(state)
        return new_instance

    def to_json(self, filename=None, compress=None):
        """Serialize to a JSON file (optionally gzip/bz2)
        (parity: ``mellon/base_predictor.py:604-644``)."""
        json_str = json.dumps(self.to_dict())
        if filename is None:
            return json_str
        if compress == "gzip":
            if isinstance(filename, str) and not filename.endswith(".gz"):
                filename += ".gz"
            with gzip.open(filename, "wt") as f:
                f.write(json_str)
        elif compress == "bz2":
            if isinstance(filename, str) and not filename.endswith(".bz2"):
                filename += ".bz2"
            with bz2.open(filename, "wt") as f:
                f.write(json_str)
        elif compress is None:
            with open(filename, "w") as f:
                f.write(json_str)
        else:
            msg = (
                f"Unknown compression format {compress}.\n"
                'Availabe formats are "gzip", "bz2" and None.'
            )
            logger.error(msg)
            raise ValueError(msg)
        logger.info(f"Written predictor to {filename}.")

    def to_dict(self):
        return self.__getstate__()

    @classmethod
    def from_json(cls, filepath, compress=None):
        """Deserialize from a JSON file with compression auto-detection
        (parity: ``mellon/base_predictor.py:654-682``)."""
        filename = str(filepath)
        if compress is None:
            compress = "none"
        if compress == "gzip" or filename.endswith(".gz"):
            open_func = gzip.open
        elif compress == "bz2" or filename.endswith(".bz2"):
            open_func = bz2.open
        else:
            open_func = open
        with open_func(filepath, "rt") as f:
            json_str = f.read()
        return cls.from_json_str(json_str)

    @classmethod
    def from_dict(cls, data_dict):
        """Deserialize from a dict, including the reference's <1.4.0
        migration shim and cross-framework module mapping
        (parity: ``mellon/base_predictor.py:684-720``)."""
        clsname = data_dict["metadata"]["classname"]
        module_name = data_dict["metadata"]["module_name"]
        module_version = data_dict["metadata"]["module_version"]

        # the <1.4.0 migration applies only to files written by the
        # reference package ("mellon.*"); our own version numbering is
        # independent of it
        is_reference = module_name.split(".")[0] == "mellon"
        release = _release_tuple(module_version)
        old = is_reference and release is not None and release < (1, 4, 0)
        if old:
            logger.warning(
                f"Loading a predictor written by version {module_version} < 1.4.0. "
                "Please set predictor.n_obs to enable normalization."
            )
            if module_name.endswith(".conditional"):
                clsname = clsname.replace("ConditionalMean", "Conditional")
            data_dict["data"]["n_obs"] = data_dict["data"].get("n_obs", None)
            state_vars = set(data_dict["data"].keys()) - {"n_input_features"}
            data_dict["data"]["_state_variables"] = data_dict["data"].get(
                "_state_variables", state_vars
            )

        Subclass = _resolve_predictor_class(clsname, module_name)
        instance = Subclass.__new__(Subclass)
        instance.__setstate__(data_dict)
        return instance

    @classmethod
    def from_json_str(cls, json_str):
        return cls.from_dict(json.loads(json_str))


def _resolve_predictor_class(clsname, module_name):
    """Resolve a predictor class, mapping reference module paths
    (``mellon.conditional`` etc.) onto our conditional classes."""
    from . import conditionals

    if hasattr(conditionals, clsname):
        return getattr(conditionals, clsname)
    try:
        module = import_module(module_name)
        return getattr(module, clsname)
    except (ImportError, AttributeError):
        pass
    raise ValueError(
        f"Cannot resolve predictor class {clsname} from module {module_name}."
    )


class ExpPredictor(Predictor):
    """Predictor returning exp(mean) — used for dimensionality
    (parity: ``mellon/base_predictor.py:737-810``)."""

    def mean(self, x, logscale=False):
        x = validate_array(x, "x")
        logscale = validate_bool(logscale, "logscale")
        x = ensure_2d(x)
        _check_n_features(self, x)
        if logscale:
            return self._mean(x)
        return jnp.exp(self._mean(x))

    __call__ = mean

    @wraps(Predictor.covariance)
    def covariance(self, *args, **kwargs):
        logger.warning(
            "The covariance will be computed for the predicted value in log scale."
        )
        return super().covariance(*args, **kwargs)

    @wraps(Predictor.mean_covariance)
    def mean_covariance(self, *args, **kwargs):
        logger.warning(
            "The mean_covariance will be computed for the predicted value in log scale."
        )
        return super().mean_covariance(*args, **kwargs)

    @wraps(Predictor.uncertainty)
    def uncertainty(self, *args, **kwargs):
        logger.warning(
            "The uncertainty will be computed for the predicted value in log scale."
        )
        return super().uncertainty(*args, **kwargs)


class PredictorTime(Predictor):
    """Predictor with a time covariate and multi_time vmap
    (parity: ``mellon/base_predictor.py:813-1194``)."""

    @make_multi_time_argument
    def mean(self, Xnew, time=None, normalize=False):
        Xnew = validate_time_x(
            Xnew, time, n_features=self.n_input_features, cast_scalar=True
        )
        normalize = validate_bool(normalize, "normalize")
        if normalize:
            if self.n_obs is None or self.n_obs == 0:
                message = (
                    "Cannot normalize without n_obs. Please set self.n_obs to "
                    "the number of samples/cells (per time point) trained on "
                    "to enable normalization."
                )
                logger.error(message)
                raise ValueError(message)
            _normalization_warnings(self)
            return self._mean(Xnew) - jnp.log(self.n_obs)
        return self._mean(Xnew)

    __call__ = mean

    @make_multi_time_argument
    def covariance(self, Xnew, time=None, diag=True):
        Xnew = validate_time_x(
            Xnew, time, n_features=self.n_input_features, cast_scalar=True
        )
        return self._covariance(Xnew, diag=diag)

    @make_multi_time_argument
    def mean_covariance(self, Xnew, time=None, diag=True):
        Xnew = validate_time_x(
            Xnew, time, n_features=self.n_input_features, cast_scalar=True
        )
        return self._mean_covariance(Xnew, diag=diag)

    @make_multi_time_argument
    def uncertainty(self, Xnew, time=None, diag=True):
        Xnew = validate_time_x(
            Xnew, time, n_features=self.n_input_features, cast_scalar=True
        )
        return self._covariance(Xnew, diag=diag) + self._mean_covariance(
            Xnew, diag=diag
        )

    @make_multi_time_argument
    def time_derivative(self, x, time, jit=True):
        """d/dt of the prediction (last input component)
        (parity: ``mellon/base_predictor.py:1051-1091``)."""
        Xnew = validate_time_x(
            x, time, n_features=self.n_input_features, cast_scalar=True
        )
        return super().gradient(Xnew, jit=jit)[:, -1]

    @make_multi_time_argument
    def gradient(self, x, time, jit=True):
        Xnew = validate_time_x(
            x, time, n_features=self.n_input_features, cast_scalar=True
        )
        X, time = Xnew[:, :-1], Xnew[:, -1]
        return gradient(self.mean, X, time, jit=jit)

    @make_multi_time_argument
    def hessian(self, x, time, jit=True):
        Xnew = validate_time_x(
            x, time, n_features=self.n_input_features, cast_scalar=True
        )
        X, time = Xnew[:, :-1], Xnew[:, -1]
        return hessian(self.mean, X, time, jit=jit)

    @make_multi_time_argument
    def hessian_log_determinant(self, x, time, jit=True):
        Xnew = validate_time_x(
            x, time, n_features=self.n_input_features, cast_scalar=True
        )
        X, time = Xnew[:, :-1], Xnew[:, -1]
        return hessian_log_determinant(self.mean, X, time, jit=jit)
