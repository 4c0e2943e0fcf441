"""Multi-process distributed runtime tests (SURVEY.md §5.4/§5.8).

Spawns a REAL 2-process ``jax.distributed`` CPU cluster and round-trips a
sampler checkpoint whose arrays are sharded across the processes — the
configuration a pod slice presents, where a plain ``device_get`` on a
non-fully-addressable array raises and ``process_allgather`` is required.
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mellon_tpu.parallel.checkpoint import (
    load_sampler_state,
    save_sampler_state,
)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_distributed_checkpoint(tmp_path):
    """distributed_initialize + checkpoint save/load + cross-process NUTS
    window + cross-process SMC sweep across 2 real processes (the worker
    asserts moment/evidence agreement with process-local runs)."""
    port = _free_port()
    worker = os.path.join(os.path.dirname(__file__), "_distributed_worker.py")
    env = dict(os.environ)
    # the worker pins the platform itself; scrub outer backend settings that
    # would preempt it
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    # the workers import mellon_tpu from the repo checkout
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(port), str(pid), str(tmp_path)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            env=env,
        )
        for pid in (0, 1)
    ]
    outputs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=480)
            outputs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, out) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert f"WORKER_CKPT_OK {pid}" in out, out
        assert f"WORKER_NUTS_OK {pid}" in out, out
        assert f"WORKER_OK {pid}" in out, out


def test_checkpoint_typed_prng_key_roundtrip(tmp_path):
    """Typed jax.random.key checkpoints restore to a working typed key."""
    key = jax.random.key(42)
    path = str(tmp_path / "typed")
    save_sampler_state(path, rng_key=key, step_size=jnp.asarray(0.1))
    loaded = load_sampler_state(path)
    restored = loaded["rng_key"]
    assert jnp.issubdtype(restored.dtype, jax.dtypes.prng_key)
    np.testing.assert_array_equal(
        np.asarray(jax.random.key_data(restored)),
        np.asarray(jax.random.key_data(key)),
    )
    # legacy raw uint32 keys still round-trip as raw arrays
    raw = jax.random.PRNGKey(3)
    path2 = str(tmp_path / "raw")
    save_sampler_state(path2, rng_key=raw)
    loaded2 = load_sampler_state(path2)
    assert loaded2["rng_key"].dtype == jnp.uint32
    np.testing.assert_array_equal(
        np.asarray(loaded2["rng_key"]), np.asarray(raw)
    )


def test_checkpoint_typed_key_inside_state_tree(tmp_path):
    """Typed keys nested in the sampler-state pytree are encoded per leaf."""
    state = {"z": jnp.arange(3.0), "key": jax.random.key(9)}
    path = str(tmp_path / "tree")
    save_sampler_state(path, state=state)
    loaded = load_sampler_state(path, state_template=state)
    assert jnp.issubdtype(loaded["state"]["key"].dtype, jax.dtypes.prng_key)
    np.testing.assert_allclose(
        np.asarray(loaded["state"]["z"]), np.arange(3.0)
    )
    np.testing.assert_array_equal(
        np.asarray(jax.random.key_data(loaded["state"]["key"])),
        np.asarray(jax.random.key_data(state["key"])),
    )
