"""Smoke run of the main path on NVIDIA GPUs, through the public entry points.

One card (the default), in one process, at the reference tutorial's width:

1. density fit: ``DensityEstimator().fit_predict`` on the stored 8,627 x 20
   data, certified against the host-f64 fit in ``benchdata/``; beside it the
   plain XLA Matern-5/2 gram at 8,627 x 5,000 and its bytes bound;
2. predictor: values and gradients at 8,627 fresh points, and a gzip JSON
   round trip;
3. kNN recall contract at 30,000 x 50 against a host-f64 exact search;
4. the double-single product at (16,384 x 5,000) @ (5,000 x {1, 64})
   against numpy f64;
5. Hessian-preconditioned NUTS (8 chains, 500 + 500 draws) on the fitted
   model: finite draws and split-R-hat below 1.01.

``--four-cards`` runs only the multi-device path, on four cards: the
cell-sharded density loss and gradient at n = 100,000, m = 5,000 against one
card, and chain-sharded NUTS against the same seed on one card.

Usage::

    python chip_smoke.py                # one card
    python chip_smoke.py --four-cards   # four cards of one host

Every time printed carries the card's name and power limit.  The last line
of standard output is ``{"ok": true, "device": {...}}``; any failed phase
makes the exit code non-zero and that line is not printed.  With no GPU the
script exits non-zero before any phase.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# the fit certificate pinned for the default f32 fit (corr, rmse / spread)
FIT_MIN_CORR = 0.999
FIT_MAX_RMSE_FRAC = 0.03
PREDICTOR_ROUNDTRIP_TOL = 1e-6
# kNN recall contract of mellon_tpu.ops.neighbors
KNN_RECALL_FRAC = 0.999
KNN_REL_TOL = 1e-4
# ds_matmul bound: |out - ref| <= DS_REL * |ref| + DS_AMP * (|A| @ |B|)
DS_REL = 3e-7
DS_AMP = 1e-8
# four-card comparisons
SHARDED_REL_TOL = 1e-5
MEAN_AGREEMENT_MCSE = 4.0
# H100 SXM device-memory bandwidth (NVIDIA data sheet), for the gram's bound
H100_HBM_BYTES_PER_S = 3.35e12


def _import_repo_scripts():
    for path in (REPO, os.path.join(REPO, "scripts")):
        if path not in sys.path:
            sys.path.insert(0, path)


def _block(tree):
    import jax

    return jax.block_until_ready(tree)


def _timed(fn, *args, **kwargs):
    t0 = time.perf_counter()
    out = _block(fn(*args, **kwargs))
    return out, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# phases: each takes its sizes, raises on a broken contract, and returns the
# measurements it made (times are host-clock seconds around block_until_ready)
# ---------------------------------------------------------------------------


def matern_gram_time(x, y, ls, reps=50):
    """Mean seconds per call of the plain XLA Matern-5/2 gram k(x, y), with
    its max abs error on the first rows against numpy float64."""
    import jax.numpy as jnp

    from mellon_tpu.ops.kernels import Matern52

    x, y = jnp.asarray(x), jnp.asarray(y)
    kernel = Matern52(ls=jnp.asarray(ls, dtype=x.dtype))
    gram = _block(kernel.k(x, y))
    t0 = time.perf_counter()
    for _ in range(reps):
        gram = kernel.k(x, y)
    _block(gram)
    seconds = (time.perf_counter() - t0) / reps

    rows = min(256, x.shape[0])
    x64 = np.asarray(x[:rows], np.float64)
    y64 = np.asarray(y, np.float64)
    dist = np.sqrt(
        np.maximum(((x64[:, None, :] - y64[None, :, :]) ** 2).sum(-1), 1e-12)
    )
    r = np.sqrt(5.0) * dist / float(ls)
    ref = (1.0 + r + r * r / 3.0) * np.exp(-r)
    err = float(np.max(np.abs(np.asarray(gram[:rows], np.float64) - ref)))
    if not err <= 1e-5:
        raise AssertionError(f"Matern-5/2 gram off numpy f64 by {err:.3g}")
    return {"seconds": seconds, "bytes": gram.size * gram.dtype.itemsize,
            "max_abs_err": err}


def phase_density_fit(x, artifact, warm_runs=3, gram_landmarks=5_000,
                      n_landmarks=None):
    """``DensityEstimator().fit_predict(x)`` with defaults (``n_landmarks``
    overrides the landmark cap), certified against the host-f64 fit stored
    in ``artifact`` (which must hold this ``x``)."""
    import jax.numpy as jnp

    import mellon_tpu

    _import_repo_scripts()
    from accuracy_cert import compare

    kwargs = {} if n_landmarks is None else {"n_landmarks": n_landmarks}
    xj = jnp.asarray(x)
    est = mellon_tpu.DensityEstimator(**kwargs)
    ld, cold = _timed(est.fit_predict, xj)
    warm = [
        _timed(mellon_tpu.DensityEstimator(**kwargs).fit_predict, xj)[1]
        for _ in range(warm_runs)
    ]
    ld = np.asarray(ld)
    if ld.shape != (x.shape[0],) or not np.all(np.isfinite(ld)):
        raise AssertionError(f"log-density bad: shape {ld.shape}, "
                             f"{int(np.sum(~np.isfinite(ld)))} non-finite")
    cert = compare(ld, artifact=artifact, x_np=np.asarray(x))
    if (cert["log_density_corr_vs_f64"] < FIT_MIN_CORR
            or cert["rmse_frac_of_spread_vs_f64"] > FIT_MAX_RMSE_FRAC):
        raise AssertionError(f"fit certificate broken: {cert}")
    gram = matern_gram_time(
        xj, xj[: min(gram_landmarks, x.shape[0])], float(est.cov_func.ls)
    )
    return {
        "estimator": est,
        "cold_seconds": cold,
        "warm_median_seconds": float(np.median(warm)),
        "n_landmarks": int(est.landmarks.shape[0]),
        "latent_dim": int(est.L.shape[1]),
        "cert": cert,
        "gram": gram,
    }


def phase_predictor(est, x_new):
    """The fitted predictor's values and gradients at new points, and its
    gzip JSON round trip."""
    import jax.numpy as jnp

    import mellon_tpu

    x_new = jnp.asarray(x_new)
    pred = est.predict
    values, t_values = _timed(pred, x_new)
    grads, t_grads = _timed(pred.gradient, x_new)
    n, d = x_new.shape
    values, grads = np.asarray(values), np.asarray(grads)
    if values.shape != (n,) or grads.shape != (n, d):
        raise AssertionError(f"predictor shapes {values.shape}, {grads.shape}")
    if not (np.all(np.isfinite(values)) and np.all(np.isfinite(grads))):
        raise AssertionError("predictor values or gradients not finite")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "density_predictor.json")
        pred.to_json(path, compress="gzip")
        reloaded = mellon_tpu.Predictor.from_json(path + ".gz")
        diff = float(np.max(np.abs(np.asarray(reloaded(x_new)) - values)))
    if not diff <= PREDICTOR_ROUNDTRIP_TOL:
        raise AssertionError(f"reloaded predictor differs by {diff:.3g}")
    return {"values_seconds": t_values, "gradient_seconds": t_grads,
            "roundtrip_max_abs_diff": diff}


def clustered_data(key, n, d, n_clusters=12):
    import jax

    kc, ka, kn, ks = jax.random.split(key, 4)
    centers = jax.random.normal(kc, (n_clusters, d)) * 2.0
    assign = jax.random.randint(ka, (n,), 0, n_clusters)
    scales = 0.3 + 0.4 * jax.random.uniform(ks, (n_clusters, 1))
    return centers[assign] + scales[assign] * jax.random.normal(kn, (n, d))


def exact_nn_distances_f64(x):
    """1-NN distances by a blocked host float64 search (self excluded)."""
    x64 = np.asarray(x, dtype=np.float64)
    n = x64.shape[0]
    xn = np.sum(x64 * x64, axis=1)
    exact = np.empty(n)
    for i in range(0, n, 2048):
        qb = x64[i:i + 2048]
        d2 = xn[i:i + 2048, None] - 2.0 * qb @ x64.T + xn[None, :]
        d2[np.arange(qb.shape[0]), np.arange(i, i + qb.shape[0])] = np.inf
        exact[i:i + 2048] = np.sqrt(np.maximum(d2.min(axis=1), 0.0))
    return exact


def phase_knn_recall(n=30_000, d=50, seed=3):
    """``nn_distances`` on clustered f32 data against host-f64 exact: the
    share of 1-NN distances within ``KNN_REL_TOL`` relative."""
    import jax
    import jax.numpy as jnp

    from mellon_tpu.ops.neighbors import nn_distances

    x = clustered_data(jax.random.PRNGKey(seed), n, d).astype(jnp.float32)
    approx, cold = _timed(nn_distances, x)
    _, warm = _timed(nn_distances, x)
    exact = exact_nn_distances_f64(x)
    rel_err = np.abs(np.asarray(approx, np.float64) - exact) / np.maximum(
        exact, 1e-12
    )
    frac_ok = float(np.mean(rel_err <= KNN_REL_TOL))
    if frac_ok < KNN_RECALL_FRAC:
        raise AssertionError(
            f"kNN recall contract broken: {frac_ok:.4%} of 1-NN distances "
            f"within {KNN_REL_TOL} relative (worst {rel_err.max():.2e})"
        )
    return {"frac_within_tol": frac_ok, "worst_rel_err": float(rel_err.max()),
            "cold_seconds": cold, "warm_seconds": warm}


def phase_ds_matmul(n=16_384, k=5_000, widths=(1, 64), seed=1):
    """``ds_matmul`` A @ (B_hi + B_lo) against numpy float64 for each width
    of B; returns the worst error as a share of the allowed bound."""
    import jax.numpy as jnp

    from mellon_tpu.ops.extended_precision import ds_from_f64, ds_matmul

    rs = np.random.RandomState(seed)
    A = rs.randn(n, k).astype(np.float32)
    A_dev = jnp.asarray(A)
    A64 = A.astype(np.float64)
    out = {}
    for w in widths:
        B64 = rs.randn(k, w) * np.exp(rs.randn(k, w))
        Bh, Bl = ds_from_f64(B64)
        got, seconds = _timed(ds_matmul, A_dev, Bh, Bl)
        got = np.asarray(got, np.float64)
        ref = A64 @ B64
        bound = DS_REL * np.abs(ref) + DS_AMP * (np.abs(A64) @ np.abs(B64))
        worst = float(np.max(np.abs(got - ref) / bound))
        if not worst <= 1.0:
            raise AssertionError(
                f"ds_matmul at width {w} exceeds its bound by {worst:.3g}x"
            )
        out[w] = {"worst_share_of_bound": worst, "seconds": seconds}
    return out


def phase_nuts(est, num_chains=8, num_warmup=500, num_samples=500,
               rhat_max=None):
    """Hessian-preconditioned NUTS on a fitted density estimator: finite
    draws and split-R-hat below ``rhat_max`` on up to 512 latent dims."""
    _import_repo_scripts()
    from nuts_bench import ESS_SUBSAMPLE, RHAT_THRESHOLD

    from mellon_tpu.inference.diagnostics import split_rhat
    from mellon_tpu.inference.mcmc import sample_density_posterior

    rhat_max = RHAT_THRESHOLD if rhat_max is None else rhat_max

    def run(seed):
        return sample_density_posterior(
            est, num_warmup=num_warmup, num_samples=num_samples,
            num_chains=num_chains, precondition="hessian", seed=seed,
        )

    (first, _), cold = _timed(run, 0)
    (result, fsamples), warm = _timed(run, 1)
    samples = np.asarray(result.samples)
    if not (np.all(np.isfinite(samples))
            and np.all(np.isfinite(np.asarray(fsamples)))):
        raise AssertionError("NUTS draws or function samples not finite")
    dim = samples.shape[-1]
    sub = np.sort(np.random.RandomState(0).choice(
        dim, size=min(dim, ESS_SUBSAMPLE), replace=False))
    rhat = split_rhat(samples[:, :, sub])
    if not float(rhat.max()) < rhat_max:
        raise AssertionError(
            f"split-R-hat {float(rhat.max()):.4f} >= {rhat_max} "
            f"({int((rhat >= rhat_max).sum())}/{len(sub)} dims)"
        )
    draws = num_chains * num_samples
    return {
        "cold_seconds": cold,
        "warm_seconds": warm,
        "draws_per_second": draws / warm,
        # (first run, second run)
        "leapfrogs_per_draw": tuple(
            float(np.asarray(r.num_leapfrog).mean()) for r in (first, result)
        ),
        "step_size": tuple(
            float(np.mean(np.asarray(r.step_size))) for r in (first, result)
        ),
        "max_rhat": float(rhat.max()),
        "rhat_dims": len(sub),
    }


def phase_four_cards(devices, n=100_000, m=5_000, num_chains=8,
                     num_warmup=200, num_samples=200, max_tree_depth=5):
    """The multi-device path on four devices against the first alone:

    * ``density_loss`` and its gradient with ``L``/``nn_distances`` sharded
      over cells on a (chains=1, cells=4) mesh, whose compiled gradient
      must hold an all-reduce;
    * ``run_mcmc`` with chains sharded on a (chains=4, cells=1) mesh against
      the same seed on one device: posterior means on up to 512 dims agree
      within ``MEAN_AGREEMENT_MCSE`` Monte-Carlo standard errors.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    _import_repo_scripts()
    from nuts_bench import ESS_SUBSAMPLE, _make_synthetic

    from mellon_tpu.inference.diagnostics import effective_sample_size
    from mellon_tpu.inference.losses import density_loss
    from mellon_tpu.inference.mcmc import run_mcmc, zero_centered_potential
    from mellon_tpu.inference.optimizers import minimize_lbfgsb
    from mellon_tpu.parallel.mesh import CELL_AXIS, CHAIN_AXIS, create_mesh

    devices = list(devices)[:4]
    if len(devices) < 4:
        raise RuntimeError(f"needs 4 devices, found {len(devices)}")
    one = devices[0]
    out = {}

    with jax.default_device(one):
        L, nn, d, mu = _make_synthetic(n, m)
        z = 0.01 * jax.random.normal(jax.random.PRNGKey(5), (m,), L.dtype)
        vg = jax.jit(jax.value_and_grad(density_loss))
        (v1, g1), out["loss_grad_one_seconds"] = _timed(vg, z, L, nn, d, mu)

    cells = create_mesh(n_chains=1, n_cells=4, devices=devices)
    Ls = jax.device_put(L, NamedSharding(cells, P(CELL_AXIS, None)))
    nns = jax.device_put(nn, NamedSharding(cells, P(CELL_AXIS)))
    zs = jax.device_put(z, NamedSharding(cells, P()))
    (v4, g4), out["loss_grad_four_seconds"] = _timed(vg, zs, Ls, nns, d, mu)
    hlo = jax.jit(jax.grad(density_loss)).lower(
        zs, Ls, nns, d, mu).compile().as_text()
    out["all_reduce_in_hlo"] = "all-reduce" in hlo
    v_rel = abs(float(v4) - float(v1)) / abs(float(v1))
    g1, g4 = np.asarray(g1), np.asarray(g4)
    g_rel = float(np.max(np.abs(g4 - g1)) / np.max(np.abs(g1)))
    out["loss_rel_diff"], out["grad_rel_diff"] = v_rel, g_rel
    if not out["all_reduce_in_hlo"]:
        raise AssertionError("cell-sharded gradient holds no all-reduce")
    if not (v_rel <= SHARDED_REL_TOL and g_rel <= SHARDED_REL_TOL):
        raise AssertionError(
            f"cell-sharded loss/grad off one device: {v_rel:.3g}, {g_rel:.3g}"
        )

    with jax.default_device(one):
        z_map = minimize_lbfgsb(
            density_loss, jnp.zeros(m, L.dtype), loss_args=(L, nn, d, mu)
        ).pre_transformation
        pot, args = zero_centered_potential(density_loss, z_map, (L, nn, d, mu))
    key = jax.random.PRNGKey(11)
    kwargs = dict(num_warmup=num_warmup, num_samples=num_samples,
                  num_chains=num_chains, max_tree_depth=max_tree_depth,
                  initial_step_size=0.05)
    with jax.default_device(one):
        res1, out["nuts_one_seconds"] = _timed(
            run_mcmc, pot, z_map, key, potential_args=args, **kwargs)
    chains = create_mesh(n_chains=4, n_cells=1, devices=devices)
    args_rep = tuple(
        jax.device_put(a, NamedSharding(chains, P())) for a in args)
    res4, out["nuts_four_seconds"] = _timed(
        run_mcmc, pot, jax.device_put(z_map, NamedSharding(chains, P())), key,
        chain_sharding=NamedSharding(chains, P(CHAIN_AXIS, None)),
        potential_args=args_rep, **kwargs)

    sub = np.sort(np.random.RandomState(0).choice(
        m, size=min(m, ESS_SUBSAMPLE), replace=False))
    stats = []
    for res in (res1, res4):
        s = np.asarray(res.samples)[:, :, sub]
        if not np.all(np.isfinite(s)):
            raise AssertionError("NUTS draws not finite")
        flat = s.reshape(-1, s.shape[-1])
        mcse = flat.std(axis=0, ddof=1) / np.sqrt(effective_sample_size(s))
        stats.append((flat.mean(axis=0), mcse))
    (mean1, mcse1), (mean4, mcse4) = stats
    z_scores = np.abs(mean4 - mean1) / np.sqrt(mcse1**2 + mcse4**2)
    out["max_mean_diff_mcse"] = float(np.max(z_scores))
    out["leapfrogs_per_draw"] = float(np.asarray(res4.num_leapfrog).mean())
    if not out["max_mean_diff_mcse"] <= MEAN_AGREEMENT_MCSE:
        raise AssertionError(
            f"chain-sharded posterior means off one device by "
            f"{out['max_mean_diff_mcse']:.3g} MCSE"
        )
    return out


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------


def require_gpu(count):
    """The JAX devices, if the first is a GPU and there are ``count``;
    otherwise exit non-zero.  Nothing falls back to the CPU."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke.py needs an NVIDIA GPU; JAX found "
            f"{devices[0].platform!r} devices only."
        )
    if len(devices) < count:
        raise SystemExit(f"needs {count} GPUs; JAX found {len(devices)}.")
    return devices


def card_lines():
    """``nvidia-smi``'s name and power limit, one line per card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--four-cards", action="store_true",
        help="run only the multi-device path, on four cards",
    )
    args = parser.parse_args(argv)
    devices = require_gpu(4 if args.four_cards else 1)

    import jax

    cards = card_lines()
    for line in cards:
        print(line, flush=True)
    card = cards[0]

    from mellon_tpu.utils.compile_cache import use_compile_cache

    print(f"device_kind: {devices[0].device_kind}; devices: {len(devices)}")
    print(f"jax {jax.__version__}")
    print(f"compile cache: {use_compile_cache(REPO)}", flush=True)

    def say(label, seconds):
        print(f"{label}: {seconds:.6f} s [{card}]", flush=True)

    failed = []

    def run_phase(name, fn):
        print(f"--- {name}", flush=True)
        t0 = time.perf_counter()
        try:
            result = fn()
        except Exception:
            traceback.print_exc()
            failed.append(name)
            print(f"FAILED: {name}", flush=True)
            return None
        say(f"{name} total", time.perf_counter() - t0)
        return result

    if args.four_cards:
        r = run_phase("four cards", lambda: phase_four_cards(devices))
        if r:
            say("loss+grad, one card (incl. compile)", r["loss_grad_one_seconds"])
            say("loss+grad, cells over 4 cards (incl. compile)",
                r["loss_grad_four_seconds"])
            print(f"loss rel diff {r['loss_rel_diff']:.3g}, grad rel diff "
                  f"{r['grad_rel_diff']:.3g}, all-reduce in HLO: "
                  f"{r['all_reduce_in_hlo']}")
            say("NUTS 8 chains, one card (incl. compile)", r["nuts_one_seconds"])
            say("NUTS 8 chains over 4 cards (incl. compile)",
                r["nuts_four_seconds"])
            print(f"posterior means: max |diff| = "
                  f"{r['max_mean_diff_mcse']:.3f} MCSE; leapfrogs/draw "
                  f"{r['leapfrogs_per_draw']:.1f}")
    else:
        _import_repo_scripts()
        from accuracy_cert import ARTIFACT, artifact_x
        from bench import N_CELLS, N_DIMS, make_data

        x = artifact_x()
        if x is None:
            raise SystemExit(f"missing {ARTIFACT}")
        fit = run_phase("1 density fit", lambda: phase_density_fit(x, ARTIFACT))
        if fit:
            say("first fit, cold (incl. compile)", fit["cold_seconds"])
            say("warm fit, median of 3", fit["warm_median_seconds"])
            print(f"landmarks kept {fit['n_landmarks']}, latent dim "
                  f"{fit['latent_dim']}; certificate {fit['cert']}")
            g = fit["gram"]
            say(f"XLA Matern-5/2 gram {x.shape[0]} x 5000 f32, per call",
                g["seconds"])
            say("its bytes bound (one write at 3.35 TB/s)",
                g["bytes"] / H100_HBM_BYTES_PER_S)
            print(f"gram max abs err vs numpy f64 {g['max_abs_err']:.3g}")

            x_new = np.asarray(make_data(jax.random.PRNGKey(7), N_CELLS, N_DIMS))
            p = run_phase("2 predictor",
                          lambda: phase_predictor(fit["estimator"], x_new))
            if p:
                say("predictor values at 8,627 points (incl. compile)",
                    p["values_seconds"])
                say("predictor gradients (incl. compile)", p["gradient_seconds"])
                print(f"round trip max abs diff {p['roundtrip_max_abs_diff']:.3g}")
        else:
            failed.append("2 predictor (needs phase 1)")

        k = run_phase("3 kNN recall 30,000 x 50", phase_knn_recall)
        if k:
            say("nn_distances cold (incl. compile)", k["cold_seconds"])
            say("nn_distances warm", k["warm_seconds"])
            print(f"{k['frac_within_tol']:.5%} within 1e-4 relative; worst "
                  f"{k['worst_rel_err']:.3g}")

        ds = run_phase("4 double-single product", phase_ds_matmul)
        if ds:
            for w, r in ds.items():
                say(f"ds_matmul 16384x5000 @ 5000x{w} (incl. compile)",
                    r["seconds"])
                print(f"width {w}: worst error {r['worst_share_of_bound']:.3g}"
                      " of the bound")

        if fit:
            nuts = run_phase("5 NUTS", lambda: phase_nuts(fit["estimator"]))
            if nuts:
                say("NUTS 8 chains 500+500, first run (incl. compile)",
                    nuts["cold_seconds"])
                say("NUTS 8 chains 500+500, second run", nuts["warm_seconds"])
                print(f"second run draws/s {nuts['draws_per_second']:.1f}; "
                      f"leapfrogs/draw (first, second) "
                      f"{nuts['leapfrogs_per_draw']}; step size "
                      f"{nuts['step_size']}; max split-R-hat "
                      f"{nuts['max_rhat']:.4f} over {nuts['rhat_dims']} dims")
        else:
            failed.append("5 NUTS (needs phase 1)")

    if failed:
        print(f"failed phases: {failed}", flush=True)
        return 1
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
