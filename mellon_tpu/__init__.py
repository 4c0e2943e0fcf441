"""mellon-tpu: an accelerator-native probabilistic inference framework with the
capabilities of settylab/Mellon (non-parametric cell-state density,
dimensionality, time-sensitive density and function estimation on sparse
Gaussian processes with a nearest-neighbor-distance likelihood).

Unlike the reference (``mellon/__init__.py:44-59``), importing this package
has no JAX side effects: the platform and precision are whatever the host
program configured, so accelerator executions stay f32 by default.
"""

import logging
import sys

from .version import __version__
from .config import setup_jax, set_jax_config
from .ops.kernels import Covariance
from .utils import util
from .utils import validation
from .models import (
    DensityEstimator,
    DimensionalityEstimator,
    FunctionEstimator,
    TimeSensitiveDensityEstimator,
)
from .inference.predictors import Predictor
from .ops import kernels as cov
from . import parameters
from . import inference
from . import models as model
from .inference import conditionals as conditional
from .inference import derivatives
from .ops import linalg as decomposition
from .utils.util import set_verbosity

# Register the legacy namespace aliases as importable module paths so
# ``from mellon_tpu.util import distance`` works like the reference's
# ``from mellon.util import distance`` (``mellon/_util.py`` etc.), not just
# attribute access.
for _name, _mod in (
    ("util", util),
    ("cov", cov),
    ("model", model),
    ("conditional", conditional),
    ("validation", validation),
    ("derivatives", derivatives),
    ("decomposition", decomposition),
):
    sys.modules[__name__ + "." + _name] = _mod

# Default logging configuration in the reference's dictConfig shape
# (cf. ``mellon/__init__.py:62-105``), under this package's logger name.
LOGGING_CONFIG = {
    "version": 1,
    "disable_existing_loggers": False,
    "formatters": {
        "standard": {
            "format": "[%(asctime)s] [%(levelname)-8s] %(message)s",
        },
    },
    "handlers": {
        "console": {
            "level": "DEBUG",
            "class": "logging.StreamHandler",
            "formatter": "standard",
            "stream": sys.stdout,
        },
    },
    "loggers": {
        "mellon_tpu": {
            "handlers": ["console"],
            "level": "INFO",
            "propagate": False,
        },
    },
}


def setup_logging(config=None):
    """Set up logging and return the package logger.

    Parameters
    ----------
    config : dict, optional
        ``logging.config.dictConfig`` dictionary; defaults to
        :data:`LOGGING_CONFIG` (cf. reference ``mellon/__init__.py:89-105``).
    """
    import logging.config

    if config is None:
        config = LOGGING_CONFIG
    logging.config.dictConfig(config)
    return logging.getLogger("mellon_tpu")


logger = setup_logging()

__all__ = [
    "DensityEstimator",
    "FunctionEstimator",
    "DimensionalityEstimator",
    "TimeSensitiveDensityEstimator",
    "Predictor",
    "Covariance",
    "__version__",
    "setup_jax",
    "set_jax_config",
    "util",
    "cov",
    "model",
    "parameters",
    "inference",
    "conditional",
    "decomposition",
    "derivatives",
    "validation",
    "logger",
    "setup_logging",
    "set_verbosity",
]
