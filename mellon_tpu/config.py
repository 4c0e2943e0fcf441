"""Global numeric configuration for mellon-tpu.

The reference implementation (mellon, ``mellon/__init__.py:44-59``) pins JAX to
CPU and enables x64 at import time.  That is the wrong default for an
accelerator, whose fast paths are f32 and below.  mellon-tpu instead

* never touches the platform at import time,
* computes in whatever dtype JAX's ``x64`` flag implies (f64 when enabled —
  used by the CPU test-suite for parity with the reference — f32 otherwise),
* concentrates the precision-sensitive work (the m x m landmark Cholesky,
  cf. ``mellon/decomposition.py:79-123``) behind adaptive jitter so that f32
  stays stable on the device.
"""

import jax
import jax.numpy as jnp

DEFAULT_JITTER = 1e-6

# f32 landmark-pruning policy.  When the landmark kernel is numerically
# singular at f32 the default prunes to the pivoted-Cholesky subset (every
# downstream O(n·m) op shrinks, executables stay small).  Setting this to
# False keeps ALL landmarks and factorizes the full kernel once on the
# host in float64 instead — full reference capacity at f32 storage, at
# the cost of the larger factorization and a host round trip.  Relevant
# when the kernel's f32 rank is far below the landmark count and the
# pruned model visibly under-resolves (e.g. the 98k-cell d=2 time-series
# shape).
PRUNE_SINGULAR_LANDMARKS = True

# When the full-capacity path (PRUNE_SINGULAR_LANDMARKS = False) has
# factorized the landmark kernel on the host in f64, whiten the cells
# against it in extended (double-single) precision on device
# (ops/extended_precision.py) instead of an f32 TRSM.  The f32 solve
# against a near-singular factor amplifies rounding by ~cond(Lp) and
# capped the 98k-cell d=2 time-series fidelity at corr 0.76; the
# double-single product is f64-equivalent.  Opt out to reproduce the
# plain f32-TRSM behaviour.
EXTENDED_PRECISION_WHITEN = True


def default_float():
    """Return the active default float dtype (f64 iff jax x64 is enabled)."""
    return jnp.asarray(0.0).dtype


def is_x64():
    return jnp.asarray(0.0).dtype == jnp.float64


def set_jax_config(enable_x64=True, platform_name="cpu"):
    """Compatibility shim mirroring the reference's ``set_jax_config``
    (``mellon/util.py:572-586``).  Unlike the reference, mellon-tpu never calls
    this at import time."""
    jax.config.update("jax_enable_x64", enable_x64)
    jax.config.update("jax_platform_name", platform_name)


def setup_jax(enable_x64=True, platform="cpu"):
    """Compatibility shim for the reference's ``setup_jax``
    (``mellon/__init__.py:44-55``). Not invoked at import time."""
    jax.config.update("jax_enable_x64", enable_x64)
    jax.config.update("jax_platform_name", platform)
