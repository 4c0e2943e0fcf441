"""Batched vs per-time-loop automatic ls_time selection.

Measures batched vs per-time-loop ls_time selection: 20k cells
over 10 ragged time points (1.7k-2.5k cells each), cold and warm, at a
given state dimensionality.  d=2 is the hard case — the per-time FULL-GP
kernels are routinely f32-singular there, exercising the rescue ladder
(per-group jitter escalation, then host-f64 factorization of ONLY the
still-singular groups with kernels rebuilt on the host from coordinates —
no device fetch of the padded kernel stack).

The loop path is forced via ``return_data=True`` (the configuration the
batch cannot express); reference anchor for the loop being replaced:
``mellon/compute_ls_time.py:66-85``.

Usage: python scripts/ls_time_bench.py [d]
"""

import sys
import time

from _common import jax, log  # noqa: F401  (repo path + compile cache)

import jax.numpy as jnp
import numpy as np


def make_ragged_time_data(key, d, group_sizes):
    from bench import make_data

    n = int(np.sum(group_sizes))
    x = make_data(key, n, d)
    times = np.concatenate(
        [np.full(s, i, dtype=np.float32) for i, s in enumerate(group_sizes)]
    )
    return jnp.concatenate([x, jnp.asarray(times)[:, None]], axis=1)


def run(mode, x, nn):
    from mellon_tpu.models.ls_time import compute_ls_time
    from mellon_tpu.ops.kernels import Matern52

    t0 = time.time()
    out = compute_ls_time(
        nn, x, Matern52, return_data=(mode == "loop")
    )
    ls = out[0] if mode == "loop" else out
    return time.time() - t0, ls


def run_mode(d, mode):
    """One mode's cold+warm measurement (call in a FRESH process: the two
    modes share programs — kNN, kernels — so measuring them in one process
    lets whichever runs second reuse the first's compilations)."""
    from mellon_tpu.ops.neighbors import nn_distances

    rng = np.random.RandomState(0)
    sizes = rng.randint(1700, 2500, size=10)
    log(f"devices: {jax.devices()}  d={d} mode={mode} groups={list(sizes)}")
    xa = make_ragged_time_data(jax.random.PRNGKey(10), d, sizes)
    nna = nn_distances(xa[:, :-1])
    t_cold, ls_a = run(mode, xa, nna)
    xb = make_ragged_time_data(jax.random.PRNGKey(11), d, sizes)
    nnb = nn_distances(xb[:, :-1])
    t_warm, ls_b = run(mode, xb, nnb)
    log(f"{mode}: cold {t_cold:.1f}s  warm {t_warm:.1f}s  "
        f"(ls_time {ls_a:.3f} / {ls_b:.3f})")
    return t_cold, t_warm


def main(d=2):
    """Orchestrate: each mode in its own subprocess for fair cold numbers."""
    import re
    import subprocess

    results = {}
    for mode in ("batched", "loop"):
        proc = subprocess.run(
            [sys.executable, __file__, str(d), mode],
            capture_output=True,
            text=True,
        )
        sys.stderr.write(proc.stdout + proc.stderr)
        m = re.search(
            rf"{mode}: cold ([\d.]+)s\s+warm ([\d.]+)s", proc.stdout + proc.stderr
        )
        if m:
            results[mode] = (float(m.group(1)), float(m.group(2)))
    if len(results) == 2:
        bc, bw = results["batched"]
        lc, lw = results["loop"]
        log(f"cold speedup {lc / bc:.1f}x   warm speedup {lw / bw:.1f}x")
    else:
        log(f"incomplete results: {results}")


if __name__ == "__main__":
    argv = sys.argv[1:]
    mode = next((a for a in argv if a in ("batched", "loop")), None)
    nums = [int(a) for a in argv if a not in ("batched", "loop")]
    if mode is not None:
        run_mode(nums[0] if nums else 2, mode)
    else:
        main(*nums)
