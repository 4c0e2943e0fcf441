"""Accuracy certificate for the headline benchmark shape.

Every speed claim must carry an accuracy number next to it (the
reference pins accuracy, not speed — cf. the reference's
``tests/test_reference_results.py:65-73``).  This script
produces that certificate at the EXACT benchmark shape (8,627 cells x 20
dims, the basic-tutorial workload of BASELINE.md): it compares the fast
f32 pruned-landmark fit against a host-f64 full-landmark fit (the
reference's numerics: x64, 5,000-landmark sparse Cholesky GP, no pruning)
on the SAME data.

Two modes:

``--write-reference``
    Run the host-f64 full-landmark fit on the CPU backend and store its
    log-density to ``benchdata/ld_ref_8627x20_f64.npz``.  The data is
    regenerated deterministically from ``bench.make_data(PRNGKey(42))``
    (JAX PRNGs are platform-invariant), so this artifact is reproducible
    bit-for-bit by anyone.  Must be launched on the CPU backend with
    ``JAX_PLATFORMS=cpu JAX_ENABLE_X64=1``.

default
    Run the fast fit on the current backend (the GPU when present) and
    print ONE JSON line with the (time, corr, rmse) triple::

        {"seconds": ..., "log_density_corr_vs_f64": ...,
         "rmse_frac_of_spread_vs_f64": ...}

``bench.py`` additionally consumes the stored artifact directly so the
driver's benchmark line carries the same accuracy fields.
"""

import argparse
import json
import os
import sys
import time

from _common import jax, log  # noqa: F401

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT = os.path.join(REPO, "benchdata", "ld_ref_8627x20_f64.npz")


def _bench_data():
    sys.path.insert(0, REPO)
    import bench

    # Always sample in f32 (even when the caller enabled x64 for the
    # reference fit) so the artifact hash matches the f32 bench path
    # bit-for-bit: jax.random draws differ between f32 and f64 dtypes.
    was_x64 = bool(jax.config.jax_enable_x64)
    jax.config.update("jax_enable_x64", False)
    try:
        x = bench.make_data(jax.random.PRNGKey(42), bench.N_CELLS, bench.N_DIMS)
        x = np.asarray(x, dtype=np.float32)
    finally:
        jax.config.update("jax_enable_x64", was_x64)
    return x


def write_reference():
    if jax.default_backend() != "cpu":
        raise SystemExit(
            "--write-reference must run on the CPU backend "
            "(JAX_PLATFORMS=cpu)."
        )
    jax.config.update("jax_enable_x64", True)
    import mellon_tpu

    x_np = _bench_data()
    x = jax.numpy.asarray(x_np, dtype=jax.numpy.float64)
    log(f"host-f64 full-landmark reference fit on {x.shape} ...")
    t0 = time.time()
    est = mellon_tpu.DensityEstimator()  # defaults: 5000-landmark sparse GP
    ld = np.asarray(est.fit_predict(x), dtype=np.float64)
    log(f"reference fit done in {time.time() - t0:.1f}s")
    assert np.all(np.isfinite(ld)), "non-finite reference log-density"
    n_landmarks = int(est.landmarks.shape[0])
    os.makedirs(os.path.dirname(ARTIFACT), exist_ok=True)
    # x is stored IN the artifact: floating-point kernels (exp, FMA
    # contraction) differ across backends, so regenerating the data on a GPU
    # does not reproduce the CPU bits — consumers must load this x.
    np.savez_compressed(
        ARTIFACT,
        x=x_np,
        log_density=ld,
        x_sha=_sha(x_np),
        n_landmarks=n_landmarks,
        x64=True,
    )
    log(
        f"wrote {ARTIFACT} (n_landmarks={n_landmarks}, "
        f"spread={ld.max() - ld.min():.3f})"
    )


def _sha(arr):
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def named_path(name):
    return os.path.join(REPO, "benchdata", f"ref_{name}_f64.npz")


def write_named_reference(name, x_np, times_np=None, est_cls="DensityEstimator",
                          est_kwargs=None):
    """Fit a host-f64 reference (the reference framework's numerics: x64,
    no f32 pruning) on ``x_np`` and store (x, [times], log_density) under
    ``benchdata/ref_<name>_f64.npz``.  Must run on the CPU backend with
    x64 enabled."""
    if jax.default_backend() != "cpu" or not jax.config.jax_enable_x64:
        raise SystemExit("write_named_reference needs CPU backend + x64")
    import mellon_tpu

    x = jax.numpy.asarray(np.asarray(x_np, dtype=np.float64))
    est = getattr(mellon_tpu, est_cls)(**(est_kwargs or {}))
    t0 = time.time()
    if times_np is not None:
        ld = est.fit_predict(x, jax.numpy.asarray(times_np, dtype=jax.numpy.float64))
    else:
        ld = est.fit_predict(x)
    ld = np.asarray(ld, dtype=np.float64)
    assert np.all(np.isfinite(ld)), f"non-finite f64 reference for {name}"
    log(f"[{name}] f64 reference fit in {time.time() - t0:.1f}s")
    payload = {"x": np.asarray(x_np, dtype=np.float32), "log_density": ld}
    if times_np is not None:
        payload["times"] = np.asarray(times_np, dtype=np.float32)
    os.makedirs(os.path.join(REPO, "benchdata"), exist_ok=True)
    np.savez_compressed(named_path(name), **payload)
    log(f"[{name}] wrote {named_path(name)}")


def named_x(name):
    """(x, times-or-None) the named f64 reference was fit on, or None."""
    path = named_path(name)
    if not os.path.exists(path):
        return None
    ref = np.load(path)
    times = np.asarray(ref["times"], dtype=np.float32) if "times" in ref else None
    return np.asarray(ref["x"], dtype=np.float32), times


def compare_named(name, ld_fast):
    """Accuracy-certificate dict vs the named f64 reference (None if absent).

    The fast fit MUST have been run on ``named_x(name)``'s data."""
    path = named_path(name)
    if not os.path.exists(path):
        return None
    ld_ref = np.asarray(np.load(path)["log_density"], dtype=np.float64)
    ld_fast = np.asarray(ld_fast, dtype=np.float64)
    corr = float(np.corrcoef(ld_fast, ld_ref)[0, 1])
    spread = float(ld_ref.max() - ld_ref.min())
    rmse = float(np.sqrt(np.mean((ld_fast - ld_ref) ** 2)))
    return {
        "log_density_corr_vs_f64": round(corr, 6),
        "rmse_frac_of_spread_vs_f64": round(rmse / spread, 6),
    }


def artifact_x(artifact=ARTIFACT):
    """The exact data the stored reference was fit on (None if absent).

    Callers must fit on THIS array (not a re-generated one): backend
    floating-point differences make regenerated data hash-mismatch.
    """
    if not os.path.exists(artifact):
        return None
    return np.asarray(np.load(artifact)["x"], dtype=np.float32)


def compare(ld_fast, artifact=ARTIFACT, x_np=None):
    """Return the accuracy-certificate dict for a fast-path log-density
    against the stored host-f64 reference (None when no artifact)."""
    if not os.path.exists(artifact):
        return None
    ref = np.load(artifact)
    if x_np is not None and str(ref["x_sha"]) != _sha(x_np):
        raise RuntimeError(
            "accuracy artifact was computed on different data; fit on "
            "accuracy_cert.artifact_x() or regenerate with "
            "scripts/accuracy_cert.py --write-reference"
        )
    ld_ref = np.asarray(ref["log_density"], dtype=np.float64)
    ld_fast = np.asarray(ld_fast, dtype=np.float64)
    corr = float(np.corrcoef(ld_fast, ld_ref)[0, 1])
    spread = float(ld_ref.max() - ld_ref.min())
    rmse = float(np.sqrt(np.mean((ld_fast - ld_ref) ** 2)))
    return {
        "log_density_corr_vs_f64": round(corr, 6),
        "rmse_frac_of_spread_vs_f64": round(rmse / spread, 6),
    }


def certify():
    import mellon_tpu

    x_np = artifact_x()
    if x_np is None:
        x_np = _bench_data()
    x = jax.numpy.asarray(x_np)
    log(f"fast fit on {jax.default_backend()} ...")
    est = mellon_tpu.DensityEstimator()
    est.fit(x)  # warmup (program loads)
    est2 = mellon_tpu.DensityEstimator()
    t0 = time.time()
    ld = est2.fit_predict(x)
    ld.block_until_ready()
    elapsed = time.time() - t0
    cert = compare(ld, x_np=x_np)
    out = {"seconds": round(elapsed, 3)}
    if cert is None:
        out["error"] = "no reference artifact; run --write-reference first"
    else:
        out.update(cert)
    print(json.dumps(out))


def _f32_data(fn, *args):
    """Generate data in f32 even under x64 (backend-portable bits)."""
    was_x64 = bool(jax.config.jax_enable_x64)
    jax.config.update("jax_enable_x64", False)
    try:
        out = fn(*args)
    finally:
        jax.config.update("jax_enable_x64", was_x64)
    return jax.tree.map(lambda a: np.asarray(a, dtype=np.float32), out)


def write_named_all():
    """Write the f64 references for every bench script's certified row:

    * ``nystroem_8627x20`` — baseline_matrix's sparse_nystroem row
    * ``time_98192x2``    — time_bench's time-series fit
    * ``atlas_sub_50000x50`` — a 50k subscale certificate for the 1M atlas
      fit (the full 1M host-f64 fit does not fit this container's RAM/time
      budget; the subscale run exercises the same pruned-factorization
      numerics)
    """
    if jax.default_backend() != "cpu":
        raise SystemExit("--write-named must run on the CPU backend")
    jax.config.update("jax_enable_x64", True)
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import bench
    import time_bench

    x = artifact_x()
    if x is None:
        x = _bench_data()
    write_named_reference(
        "nystroem_8627x20", x,
        est_kwargs=dict(gp_type="sparse_nystroem", rank=0.999, n_landmarks=2000),
    )
    xt, tt = _f32_data(time_bench.make_time_data, jax.random.PRNGKey(1), 98_192, 2, 8)
    write_named_reference(
        "time_98192x2", xt, times_np=tt, est_cls="TimeSensitiveDensityEstimator",
        est_kwargs=dict(ls_time=0.375),
    )
    xa = _f32_data(bench.make_data, jax.random.PRNGKey(0), 50_000, 50)
    write_named_reference(
        "atlas_sub_50000x50", xa, est_kwargs=dict(n_landmarks=5000),
    )


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--write-reference", action="store_true")
    p.add_argument("--write-named", action="store_true")
    args = p.parse_args()
    if args.write_reference:
        write_reference()
    elif args.write_named:
        write_named_all()
    else:
        certify()
