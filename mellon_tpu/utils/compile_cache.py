"""Placement of JAX's persistent compilation cache for the repository's
scripts (``chip_smoke.py``, ``bench.py`` and ``scripts/``)."""

import os

import jax

CACHE_ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def use_compile_cache(repo_root):
    """Return the compilation-cache directory in use, setting one if needed.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX has already read it and
    nothing is changed here.  Otherwise the cache goes to the fixed path
    ``<repo_root>/.jax_cache`` (listed in ``.gitignore``), fixed so that a
    later run of the same checkout finds what an earlier one compiled.
    """
    env_dir = os.environ.get(CACHE_ENV_VAR)
    if env_dir:
        return env_dir
    cache_dir = os.path.join(os.path.abspath(repo_root), ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    return cache_dir
