"""Posterior-agreement check between two NUTS runs.

Loads two moment files saved by ``nuts_bench.py ... save=PATH`` (same
model, same seed, different ``MELLON_TPU_MATVEC_PRECISION`` or L storage
dtype) and tests per-dimension agreement of posterior means and stds
within Monte-Carlo error:

  z_mean[i] = |mean_a[i] - mean_b[i]| / sqrt(sd_a[i]^2/ESS_a[i]
                                            + sd_b[i]^2/ESS_b[i])

Means should agree with |z| ~ O(1) (the runs use different RNG streams
only through the arithmetic, but the chains decorrelate, so treat them as
independent).  Stds are compared via their MC standard error
sd/sqrt(2(ESS-1)).

Usage: python precision_agreement.py a.npz b.npz [label_a] [label_b]
Exit status 1 if the max |z| over dims exceeds ZMAX (5.0) — loud failure
for the campaign driver.
"""

import sys

import numpy as np

from _common import log  # noqa: F401

ZMAX = 5.0


def main(path_a, path_b, label_a="a", label_b="b"):
    a = np.load(path_a)
    b = np.load(path_b)
    assert np.array_equal(a["sub"], b["sub"]), "dim subsamples differ"
    se_mean = np.sqrt(a["std"] ** 2 / a["ess"] + b["std"] ** 2 / b["ess"])
    z_mean = np.abs(a["mean"] - b["mean"]) / se_mean
    se_std = np.sqrt(
        a["std"] ** 2 / (2 * (a["ess"] - 1)) + b["std"] ** 2 / (2 * (b["ess"] - 1))
    )
    z_std = np.abs(a["std"] - b["std"]) / se_std
    log(
        f"posterior agreement {label_a} vs {label_b} over "
        f"{len(a['sub'])} dims:"
    )
    log(
        f"  means: max|z| {z_mean.max():.2f}  median|z| "
        f"{np.median(z_mean):.2f}  dims>3 {int((z_mean > 3).sum())}"
    )
    log(
        f"  stds:  max|z| {z_std.max():.2f}  median|z| "
        f"{np.median(z_std):.2f}  dims>3 {int((z_std > 3).sum())}"
    )
    log(
        f"  mean abs diff: {np.abs(a['mean'] - b['mean']).max():.3e} max / "
        f"{np.abs(a['mean'] - b['mean']).mean():.3e} avg   "
        f"posterior sd scale: {a['std'].mean():.3e}"
    )
    ok = z_mean.max() <= ZMAX and z_std.max() <= ZMAX
    log(
        f"AGREEMENT {'PASS' if ok else 'FAIL'} "
        f"(threshold max|z| <= {ZMAX})"
    )
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
