"""Benchmark: DensityEstimator fit_predict on the reference's headline
workload shape (8,627 cells, 5000-landmark sparse GP — the basic-tutorial
measurement that took the reference 28.4 s on CPU, see BASELINE.md).

Methodology: one warmup fit on identically-shaped data compiles every
program, then three measured fits run end-to-end warm — kNN, k-means
landmarks, kernel factorization, whitened L-BFGS MAP, density extraction —
and the median is reported.  The fits run on the stored data of the
host-f64 reference fit, so the line carries its accuracy certificate.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline",
"device": {"platform", "kind", "count"}, ...certificate}.  ``vs_baseline``
is the speedup over the reference's 28.4 s (>1 is faster).  Exits non-zero
without a result when JAX finds no GPU.
"""

import json
import os
import sys
import time

import numpy as np

BASELINE_SECONDS = 28.4  # notebooks/basic_tutorial.ipynb cell 12 ("Wall time: 28.4 s")
N_CELLS = 8627
N_DIMS = 20
REPO = os.path.dirname(os.path.abspath(__file__))


def make_data(key, n, d):
    """Clustered synthetic data mimicking diffusion-map eigenvector scales."""
    import jax
    import jax.numpy as jnp

    k_centers, k_assign, k_noise, k_scale = jax.random.split(key, 4)
    n_clusters = 12
    centers = jax.random.normal(k_centers, (n_clusters, d)) * 2.0
    assign = jax.random.randint(k_assign, (n,), 0, n_clusters)
    scales = 0.3 + 0.4 * jax.random.uniform(k_scale, (n_clusters, 1))
    x = centers[assign] + scales[assign] * jax.random.normal(k_noise, (n, d))
    # decaying per-dimension scale like DM eigenvectors
    decay = jnp.exp(-0.15 * jnp.arange(d))
    return x * decay[None, :]


def run_fit(x):
    import jax.numpy as jnp

    import mellon_tpu

    log_density = mellon_tpu.DensityEstimator().fit_predict(x)
    log_density.block_until_ready()
    assert bool(jnp.all(jnp.isfinite(log_density))), "non-finite density"
    return log_density


def main():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"bench.py measures the GPU; JAX found {dev.platform!r} devices only."
        )
    import jax.numpy as jnp

    from mellon_tpu.utils.compile_cache import use_compile_cache

    print(f"[bench] compile cache: {use_compile_cache(REPO)}", file=sys.stderr)
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from accuracy_cert import ARTIFACT, artifact_x, compare

    # the exact data the host-f64 reference was fit on (regenerated data
    # would not match it bit for bit across backends)
    x_np = artifact_x()
    if x_np is None:
        raise SystemExit(f"missing {ARTIFACT}")
    x = jnp.asarray(x_np)
    x_warm = make_data(jax.random.PRNGKey(7), N_CELLS, N_DIMS)

    t0 = time.perf_counter()
    run_fit(x_warm)
    print(f"[bench] warmup fit: {time.perf_counter() - t0:.1f}s",
          file=sys.stderr, flush=True)
    times = []
    for i in range(3):
        t0 = time.perf_counter()
        ld = run_fit(x)
        times.append(time.perf_counter() - t0)
        print(f"[bench] measured fit {i}: {times[-1]:.4f}s", file=sys.stderr,
              flush=True)
    elapsed = sorted(times)[1]

    result = {
        "metric": "density_fit_predict_8627_cells_warm_seconds",
        "value": elapsed,
        "unit": "s",
        "vs_baseline": BASELINE_SECONDS / elapsed,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }
    result.update(compare(np.asarray(ld), x_np=x_np))
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
