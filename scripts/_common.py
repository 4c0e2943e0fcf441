"""Shared preamble for the benchmark/profiling scripts: repo-root import
path, persistent compilation cache, and the timestamped ``log`` helper.

Usage (first import in every script, before any other jax use)::

    from _common import jax, log
"""

import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402

from mellon_tpu.utils.compile_cache import use_compile_cache  # noqa: E402

use_compile_cache(REPO)


def log(msg):
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)
