"""Per-stage breakdown of the fused sparse_nystroem warm fit at the
baseline-matrix shape (8,627 x 20, m=2000, rank=0.999).

The factorization is the Cholesky-whitened Nyström (H = C Lp^-T, mass
selection on H^T H); this script times each stage plus the isolated
suspect ops (eigh, Householder QR) so future regressions are
attributable.

Usage: python scripts/profile_nystroem.py
"""

import time

from _common import jax, log  # noqa: F401  (repo path + compile cache)

import jax.numpy as jnp


def _sync(out):
    """Host synchronization by fetching one element of every output
    leaf."""
    for leaf in jax.tree_util.tree_leaves(out):
        arr = jnp.ravel(leaf) if getattr(leaf, "ndim", 0) > 0 else leaf
        jax.device_get(arr[:1] if getattr(arr, "ndim", 0) else arr)


def timed(name, fn, *args, reps=3):
    out = fn(*args)
    _sync(out)
    times = []
    for _ in range(reps):
        t0 = time.time()
        out = fn(*args)
        _sync(out)
        times.append(time.time() - t0)
    log(f"{name}: {min(times)*1e3:.1f} ms (min of {reps})")
    return out


def main():
    from bench import make_data
    from mellon_tpu.models.fused import (
        DEFAULT_ASSIGN_BLOCK,
        DEFAULT_BATCH_SIZE,
        _fused_sparse_prepare_program,
    )
    from mellon_tpu.ops.linalg import (
        _eigendecomposition,
        _nystroem_gram,
        _standard_low_rank_fused_spec,
        randomized_eigh,
        safe_cholesky,
    )

    log(f"devices: {jax.devices()}")
    n, d, k = 8627, 20, 2000
    x = make_data(jax.random.PRNGKey(1), n, d)
    x.block_until_ready()
    spec = ("matern52", None, 1)
    key = jax.random.PRNGKey(42)

    out = timed(
        "stage1 (kNN+heuristics+kmeans+K+chol/pivot)",
        lambda: _fused_sparse_prepare_program(
            x, key, 1e-6, 1.0, spec, k, d, None,
            int(min(DEFAULT_BATCH_SIZE, n)), int(min(DEFAULT_ASSIGN_BLOCK, n)),
        ),
    )
    ls = float(out[6])
    xu, K, Lp, ok, piv, r = out[7], out[8], out[9], out[10], out[11], out[12]
    log(f"stage1 chol ok={bool(ok)} pivot r={int(r)}")

    if bool(ok):
        xu_sel, Lp_sel = xu, Lp
    else:
        import numpy as np
        from mellon_tpu.ops.linalg import RANK_BUCKETS

        rr = int(r)
        buckets = [b for b in RANK_BUCKETS if b <= rr]
        if buckets:
            rr = buckets[-1]
        piv_arr = jnp.asarray(np.asarray(piv[:rr]), dtype=jnp.int32)
        xu_sel = xu[piv_arr]
        Lp_sel = timed(
            "prune submatrix safe_cholesky",
            lambda: safe_cholesky(K[piv_arr][:, piv_arr], jitter=1e-6, max_tries=3),
        )

    H = timed(
        "TRSM H = C Lp^-T (shared sparse program)",
        lambda: _standard_low_rank_fused_spec(spec, (ls,), x, xu_sel, Lp_sel),
    )
    G = timed("whitened gram H^T H", _nystroem_gram, H)

    t0 = time.time()
    S, U, raw_p = _eigendecomposition(G, rank=0.999, with_raw_rank=True)
    log(f"_eigendecomposition(G {G.shape[0]}x{G.shape[0]}) incl. host syncs: "
        f"{(time.time()-t0)*1e3:.1f} ms (first), raw rank {raw_p}")
    t0 = time.time()
    S, U, raw_p = _eigendecomposition(G, rank=0.999, with_raw_rank=True)
    log(f"_eigendecomposition(G) warm: {(time.time()-t0)*1e3:.1f} ms")

    timed("final factor H @ U",
          jax.jit(lambda A, B: jnp.matmul(A, B, precision=jax.lax.Precision.HIGHEST)),
          H, U)

    # isolated suspects at representative shapes
    timed(f"eigh({G.shape[0]}x{G.shape[0]})",
          jax.jit(jnp.linalg.eigh), G)
    timed("randomized_eigh(K 2000^2, 512) [QRs + eigh528]",
          lambda: randomized_eigh(K, 512))
    A = jax.random.normal(jax.random.PRNGKey(0), (2000, 528), dtype=K.dtype)
    timed("one QR(2000x528)", jax.jit(lambda M: jnp.linalg.qr(M)[0]), A)

    # end-to-end fused fit for the same shape, cross-checking the sum
    import mellon_tpu

    def fit(seed):
        est = mellon_tpu.DensityEstimator(
            gp_type="sparse_nystroem", rank=0.999, n_landmarks=k
        )
        est.fit_predict(make_data(jax.random.PRNGKey(seed), n, d))

    t0 = time.time()
    fit(5)
    log(f"fit_predict cold-ish: {time.time()-t0:.1f}s")
    t0 = time.time()
    fit(6)
    log(f"fit_predict warm: {time.time()-t0:.1f}s")

    # fit-phase breakdown (the factorization stages above account for well
    # under a second; this locates the rest of the warm fit)
    xw = make_data(jax.random.PRNGKey(7), n, d)
    xw.block_until_ready()
    est = mellon_tpu.DensityEstimator(
        gp_type="sparse_nystroem", rank=0.999, n_landmarks=k
    )
    t0 = time.time(); est.prepare_inference(xw)
    log(f"phase prepare_inference: {time.time()-t0:.2f}s")
    t0 = time.time(); est.run_inference()
    log(f"phase run_inference (L-BFGS): {time.time()-t0:.2f}s")
    t0 = time.time(); est.process_inference(build_predict=False)
    log(f"phase process_inference (density): {time.time()-t0:.2f}s")
    t0 = time.time(); pred = est.predict
    log(f"phase predictor build: {time.time()-t0:.2f}s")
    t0 = time.time(); pred(xw).block_until_ready()
    log(f"phase predict eval @ {n}: {time.time()-t0:.2f}s")


if __name__ == "__main__":
    main()
