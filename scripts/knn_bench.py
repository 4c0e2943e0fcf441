"""Atlas-scale kNN: exact streaming sweep vs cluster-pruned (IVF) search.

Measures wall time and 1-NN recall/distance agreement of the IVF path
against the exact path at a given scale so the auto-switch threshold in
``ops/neighbors.py`` (IVF_THRESHOLD) is set from on-chip evidence, not
guesswork.

Usage: python scripts/knn_bench.py [n] [d]
"""

import sys
import time

from _common import jax, log  # noqa: F401  (repo path + compile cache)

import jax.numpy as jnp



def main(n=1_000_000, d=50):
    from bench import make_data
    from mellon_tpu.ops import neighbors

    log(f"devices: {jax.devices()}  n={n:,} d={d}")
    x = make_data(jax.random.PRNGKey(0), n, d)
    x.block_until_ready()
    log("data ready")

    # --- IVF path (includes its quantizer build) ---
    t0 = time.time()
    d_ivf, _ = neighbors.knn_ivf(x, 1)
    d_ivf.block_until_ready()
    t_ivf_cold = time.time() - t0
    t0 = time.time()
    d_ivf, _ = neighbors.knn_ivf(x, 1)
    d_ivf.block_until_ready()
    t_ivf = time.time() - t0
    log(f"IVF 1-NN: cold {t_ivf_cold:.1f}s warm {t_ivf:.1f}s")

    # --- exact path (warmed like the IVF path: the cold run includes
    # compilation, which would bias the speedup used to set
    # IVF_THRESHOLD) ---
    t0 = time.time()
    d_exact = neighbors.knn_distances(x, 1, method="exact")
    d_exact.block_until_ready()
    t_exact_cold = time.time() - t0
    t0 = time.time()
    d_exact = neighbors.knn_distances(x, 1, method="exact")
    d_exact.block_until_ready()
    t_exact = time.time() - t0
    log(f"exact 1-NN: cold {t_exact_cold:.1f}s warm {t_exact:.1f}s")

    d_ivf = d_ivf[:, 0]
    d_exact = d_exact[:, 0]
    recall = float(jnp.mean(jnp.abs(d_ivf - d_exact) <= 1e-6 + 1e-4 * d_exact))
    rel = jnp.abs(d_ivf - d_exact) / jnp.maximum(d_exact, 1e-12)
    log(
        f"1-NN distance agreement: recall={recall:.6f} "
        f"max_rel_err={float(jnp.max(rel)):.3g} "
        f"mean_rel_err={float(jnp.mean(rel)):.3g} "
        f"speedup(warm)={t_exact / t_ivf:.1f}x"
    )


if __name__ == "__main__":
    args = [int(a) for a in sys.argv[1:]]
    main(*args)
