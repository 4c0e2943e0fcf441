"""Unit tests for the ops layer: distances, kernels, decompositions,
neighbors, k-means.  Mirrors the reference's test strategy for
``tests/test_cov.py``, ``tests/test_util.py`` (SURVEY.md §4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mellon_tpu.ops import (
    Covariance,
    ExpQuad,
    Exponential,
    Linear,
    Matern32,
    Matern52,
    RatQuad,
    _eigendecomposition,
    _full_decomposition_low_rank,
    _full_rank,
    _modified_low_rank,
    _standard_low_rank,
    k_means,
    knn,
    knn_distances,
    local_dimensionality,
    nn_distances,
    ridge_solve,
)
from mellon_tpu.utils.util import distance, distance_grad, mle, stabilize

ALL_KERNELS = [Matern32, Matern52, ExpQuad, Exponential, RatQuad, Linear]


@pytest.fixture(scope="module")
def data():
    key = jax.random.PRNGKey(0)
    x = jax.random.normal(key, (50, 3))
    y = jax.random.normal(jax.random.PRNGKey(1), (20, 3))
    return x, y


def test_distance_matches_naive(data):
    x, y = data
    d = distance(x, y)
    naive = np.sqrt(
        ((np.asarray(x)[:, None, :] - np.asarray(y)[None, :, :]) ** 2).sum(-1)
    )
    np.testing.assert_allclose(np.asarray(d), naive, atol=1e-5)


def test_distance_grad(data):
    x, y = data
    dist, grad = distance_grad(x)(y)
    np.testing.assert_allclose(np.asarray(dist), np.asarray(distance(x, y)), atol=1e-12)
    # compare to autodiff of distance wrt y
    autodiff = jax.jacfwd(lambda yy: distance(x, yy))(y)
    # autodiff shape (n, m, m, d): gradient wrt y_j only nonzero at j
    ad = np.asarray(autodiff)
    idx = np.arange(y.shape[0])
    ad_diag = ad[:, idx, idx, :]
    np.testing.assert_allclose(np.asarray(grad), ad_diag, atol=1e-6)


@pytest.mark.parametrize("Kernel", ALL_KERNELS)
def test_kernel_evaluation_and_diag(Kernel, data):
    x, y = data
    cov = Kernel(ls=1.3) if Kernel is not RatQuad else Kernel(alpha=1.2, ls=1.3)
    K = cov(x, y)
    assert K.shape == (50, 20)
    diag = cov.diag(x)
    np.testing.assert_allclose(
        np.asarray(diag), np.asarray(jnp.diagonal(cov(x, x))), atol=1e-6
    )


@pytest.mark.parametrize("Kernel", ALL_KERNELS)
def test_kernel_grad_matches_autodiff(Kernel, data):
    x, y = data
    cov = Kernel(ls=1.3)
    grad = cov.k_grad(x)(y)
    auto = Covariance.k_grad(cov, x)(y)
    np.testing.assert_allclose(np.asarray(grad), np.asarray(auto), atol=1e-5)


def test_kernel_algebra(data):
    x, y = data
    c1, c2 = Matern52(ls=1.0), ExpQuad(ls=2.0)
    np.testing.assert_allclose(
        np.asarray((c1 + c2)(x, y)), np.asarray(c1(x, y) + c2(x, y)), atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray((c1 * c2)(x, y)), np.asarray(c1(x, y) * c2(x, y)), atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray((c1**2.0)(x, y)), np.asarray(c1(x, y) ** 2.0), atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray((c1 + 1.5)(x, y)), np.asarray(c1(x, y) + 1.5), atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray((c1 * 0.5)(x, y)), np.asarray(c1(x, y) * 0.5), atol=1e-12
    )


def test_kernel_algebra_grads(data):
    x, y = data
    c1, c2 = Matern52(ls=1.0), ExpQuad(ls=2.0)
    for comp in [c1 + c2, c1 * c2, c1**2.0, c1 * 0.5, c1 + 1.5]:
        grad = comp.k_grad(x)(y)
        auto = Covariance.k_grad(comp, x)(y)
        np.testing.assert_allclose(np.asarray(grad), np.asarray(auto), atol=1e-5)


def test_active_dims_product_kernel(data):
    x, _ = data
    cov = Matern52(ls=1.0, active_dims=slice(None, -1)) * Matern52(
        ls=0.5, active_dims=-1
    )
    K = cov(x, x)
    K_manual = Matern52(ls=1.0)(x[:, :-1], x[:, :-1]) * Matern52(ls=0.5)(
        x[:, -1:], x[:, -1:]
    )
    np.testing.assert_allclose(np.asarray(K), np.asarray(K_manual), atol=1e-12)


def test_kernel_serialization_roundtrip(data):
    x, y = data
    cov = Matern52(ls=1.7, active_dims=slice(None, -1)) * ExpQuad(
        ls=0.3, active_dims=-1
    )
    restored = Covariance.from_json(cov.to_json())
    np.testing.assert_allclose(
        np.asarray(cov(x, y)), np.asarray(restored(x, y)), atol=1e-12
    )


def test_full_rank_decomposition(data):
    x, _ = data
    cov = Matern52(ls=1.0)
    L = _full_rank(x, cov, jitter=1e-6)
    K = stabilize(cov(x, x), 1e-6)
    np.testing.assert_allclose(np.asarray(L @ L.T), np.asarray(K), atol=1e-8)


def test_low_rank_decompositions(data):
    x, _ = data
    xu = x[:15]
    cov = Matern52(ls=2.0)
    K = cov(x, x)

    L_nys = _full_decomposition_low_rank(x, cov, rank=0.999)
    assert L_nys.shape[0] == 50
    err = np.abs(np.asarray(L_nys @ L_nys.T) - np.asarray(K)).max()
    assert err < 1e-2

    L_std = _standard_low_rank(x, cov, xu)
    assert L_std.shape == (50, 15)

    L_mod = _modified_low_rank(x, cov, xu, rank=0.99)
    assert L_mod.shape[0] == 50
    assert L_mod.shape[1] <= 15


def test_eigendecomposition_rank_selection():
    A = jnp.diag(jnp.asarray([10.0, 5.0, 1.0, 0.1, 0.01]))
    s, v = _eigendecomposition(A, rank=3)
    assert s.shape == (3,)
    s, v = _eigendecomposition(A, rank=0.9)
    # reference semantics (mellon/decomposition.py:59-62): p = searchsorted of
    # the cumulative eigenvalue mass at target 0.9*16.11=14.5 -> p=1
    assert s.shape[0] == 1
    np.testing.assert_allclose(float(s[0]), 10.0)


def test_cholesky_failure_raises():
    A = jnp.asarray([[1.0, 2.0], [2.0, 1.0]])  # not PSD

    class FakeCov:
        def __call__(self, x, y):
            return A

    with pytest.raises(ValueError, match="not positively definite"):
        _full_rank(jnp.zeros((2, 1)), FakeCov(), jitter=1e-6)


def test_knn_exact():
    key = jax.random.PRNGKey(3)
    x = jax.random.normal(key, (40, 2))
    d_all = np.array(distance(x, x))
    np.fill_diagonal(d_all, np.inf)
    expect_nn = d_all.min(axis=1)
    got = np.asarray(nn_distances(x))
    np.testing.assert_allclose(got, expect_nn, atol=1e-5)

    k = 5
    got_k = np.asarray(knn_distances(x, k))
    expect_k = np.sort(d_all, axis=1)[:, :k]
    np.testing.assert_allclose(got_k, expect_k, atol=1e-5)


def test_knn_query():
    x = jnp.asarray([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0], [5.0, 5.0]])
    q = jnp.asarray([[0.9, 0.1]])
    d, i = knn(x, 2, query=q)
    assert int(i[0, 0]) == 1


def test_kmeans_landmarks():
    key = jax.random.PRNGKey(4)
    centers = jnp.asarray([[0.0, 0.0], [10.0, 10.0], [-10.0, 10.0]])
    pts = centers[jax.random.randint(key, (300,), 0, 3)] + 0.1 * jax.random.normal(
        jax.random.PRNGKey(5), (300, 2)
    )
    landmarks = k_means(pts, 3, random_state=0)
    assert landmarks.shape == (3, 2)
    # each true center should have a landmark nearby
    d = np.asarray(distance(centers, landmarks))
    assert d.min(axis=1).max() < 1.0


def test_local_dimensionality():
    key = jax.random.PRNGKey(6)
    # planar data embedded in 3D should have local dim ~ 2
    x2 = jax.random.normal(key, (500, 2))
    x = jnp.concatenate([x2, jnp.zeros((500, 1))], axis=1)
    dims = local_dimensionality(x, k=30)
    assert 1.5 < float(dims.mean()) < 2.5


def test_ridge_solve_matches_normal_equations():
    key = jax.random.PRNGKey(7)
    L = jax.random.normal(key, (30, 10))
    target = jax.random.normal(jax.random.PRNGKey(8), (30,))
    z = ridge_solve(L, target, alpha=1.0)
    expect = np.linalg.solve(
        np.asarray(L.T @ L) + np.eye(10), np.asarray(L.T @ target)
    )
    np.testing.assert_allclose(np.asarray(z), expect, atol=1e-8)


def test_mle():
    nn = jnp.asarray([0.1, 0.5, 1.0])
    vals = mle(nn, 2)
    assert vals.shape == (3,)
    assert bool(vals[0] > vals[2])


@pytest.mark.parametrize(
    "dtype, expected",
    [
        (jnp.float32, jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3),
        (jnp.float64, jax.lax.Precision.HIGHEST),
    ],
)
def test_knn_cross_term_precision(dtype, expected):
    """The matmul-form candidate distances use three bf16 products for f32
    (never the GPU's TF32 default) and full precision otherwise."""
    from mellon_tpu.ops.neighbors import _cross_term_precision

    assert _cross_term_precision(jnp.dtype(dtype)) == expected


def test_knn_f32_matmul_candidates_match_exact():
    """Above EXACT_CAND_DIM_MAX columns the f32 search (matmul-form
    candidates, exact re-rank) finds the f64 nearest neighbours."""
    from mellon_tpu.ops.neighbors import EXACT_CAND_DIM_MAX, knn

    d = EXACT_CAND_DIM_MAX + 4
    x = jax.random.normal(jax.random.PRNGKey(22), (300, d))
    dist32, _ = knn(x.astype(jnp.float32), 2)
    dist64, _ = knn(x.astype(jnp.float64), 2)
    np.testing.assert_allclose(
        np.asarray(dist32[:, 1]), np.asarray(dist64[:, 1]), rtol=1e-5
    )


def test_ivf_knn_recall():
    """Cluster-pruned kNN matches the exact search at high recall."""
    from mellon_tpu.ops.neighbors import knn_ivf

    x = jax.random.normal(jax.random.PRNGKey(22), (3000, 4))
    exact = np.asarray(knn_distances(x, 3))
    ivf_d, _ = knn_ivf(x, 3, n_clusters=48, n_probe=8)
    recall = np.mean(np.isclose(np.asarray(ivf_d), exact, atol=1e-9))
    assert recall > 0.97
    # the 1-NN column (the density model's input) is essentially exact
    assert np.mean(np.isclose(np.asarray(ivf_d)[:, 0], exact[:, 0], atol=1e-9)) > 0.999


def test_operand_spec_matches_direct_evaluation(data):
    from mellon_tpu.ops.kernels import eval_operand_spec

    x, y = data
    kernels = [
        Matern32(1.3),
        Matern52(0.8),
        ExpQuad(2.0),
        Exponential(1.1),
        RatQuad(ls=1.5, alpha=2.5),
        Linear(3.0),
        Matern52(1.2, active_dims=slice(None, -1)) * Matern32(0.5, active_dims=-1),
        Matern52(1.2) + 0.7,
        (ExpQuad(1.0) + Linear(2.0)) ** 2.0,
        Matern52(1.0, active_dims=[0, 2, 4]) * 1.5,
    ]
    for cov in kernels:
        spec, params = cov.operand_spec()
        hash(spec)  # static part must be a valid jit key
        direct = cov(x, y)
        via_spec = eval_operand_spec(spec, params, x, y)
        np.testing.assert_allclose(
            np.asarray(direct), np.asarray(via_spec), atol=1e-12
        )


def test_factorization_program_reused_across_length_scales():
    """Two fits whose auto-selected ls differs must share one compiled
    factorization program: the ls is an operand, not a baked constant
    (a per-fit retrace/compile/load was the dominant warm-fit cost)."""
    from mellon_tpu.ops.linalg import (
        _standard_low_rank,
        _standard_low_rank_fused_spec,
    )

    key = jax.random.PRNGKey(3)
    x = jax.random.normal(key, (40, 3))
    xu = x[:10]
    before = _standard_low_rank_fused_spec._cache_size()
    L1 = _standard_low_rank(x, Matern52(1.0), xu)
    mid = _standard_low_rank_fused_spec._cache_size()
    L2 = _standard_low_rank(x, Matern52(2.5), xu)
    after = _standard_low_rank_fused_spec._cache_size()
    assert mid == before + 1
    assert after == mid  # second ls value hits the same executable
    assert L1.shape == L2.shape == (40, 10)
    assert not np.allclose(np.asarray(L1), np.asarray(L2))


def test_knn_streamed_column_path_matches_single_strip():
    """The column-streaming merge (atlas-scale path, n > col_block) must
    return the same neighbors as the single-strip path, including the
    non-divisible tail columns."""
    from mellon_tpu.ops.neighbors import knn

    key = jax.random.PRNGKey(9)
    x = jax.random.normal(key, (233, 4))
    d_full, i_full = knn(x, 5)
    d_str, i_str = knn(x, 5, col_block=64)  # 233 cols -> 4 strips with tail
    np.testing.assert_allclose(np.asarray(d_str), np.asarray(d_full), atol=1e-10)
    np.testing.assert_array_equal(np.asarray(i_str), np.asarray(i_full))


def test_eigendecomposition_no_positive_eigenvalues_raises():
    """A matrix without positive eigenvalues must raise with jitter advice
    (the reference crashes with an opaque IndexError on the empty cumsum,
    ``mellon/decomposition.py:58-62``), for float and int ranks alike."""
    Z = jnp.zeros((6, 6))
    with pytest.raises(ValueError, match="no positive eigenvalues"):
        _eigendecomposition(Z, rank=0.99)
    with pytest.raises(ValueError, match="no positive eigenvalues"):
        _eigendecomposition(Z, rank=3)


def test_factory_forwards_lp_to_landmarks_conditional():
    """compute_conditional must forward Lp so the landmarks conditional
    skips rebuilding the m×m landmark Cholesky (the reference drops it,
    ``mellon/inference.py:495``); predictions are identical either way."""
    from mellon_tpu.inference.factories import compute_conditional
    from mellon_tpu.ops.kernels import Matern52
    from mellon_tpu.ops.linalg import _full_rank

    key = jax.random.PRNGKey(12)
    x = jax.random.uniform(key, (40, 2), minval=-2, maxval=2)
    xu = x[::4]
    y = jnp.sin(x[:, 0])
    cov = Matern52(1.0)
    Lp = _full_rank(xu, cov, jitter=1e-6)
    kwargs = dict(sigma=0.1, jitter=1e-6, y_is_mean=False)
    c_with = compute_conditional(
        x, xu, None, None, y, 0.0, cov, None, Lp, **kwargs
    )
    c_without = compute_conditional(
        x, xu, None, None, y, 0.0, cov, None, None, **kwargs
    )
    np.testing.assert_allclose(
        np.asarray(c_with._mean(x)), np.asarray(c_without._mean(x)), atol=1e-6
    )


def _clustered(key, n, d):
    """Clustered data with decaying per-dimension scale (realistic kernel
    spectra; cf. bench.make_data)."""
    k_c, k_a, k_n = jax.random.split(key, 3)
    centers = jax.random.normal(k_c, (10, d)) * 2.0
    assign = jax.random.randint(k_a, (n,), 0, 10)
    pts = centers[assign] + 0.4 * jax.random.normal(k_n, (n, d))
    return pts * jnp.exp(-0.15 * jnp.arange(d))[None, :]


def test_modified_low_rank_randomized_matches_exact():
    """Above the NYSTROEM_EXACT_MAX gate the improved Nyström switches to
    the randomized sketch eigensolver; on realistic (fast-decaying) kernel
    spectra its L L^T must match the exact double-eigh reference path."""
    import mellon_tpu.ops.linalg as lg
    from mellon_tpu.ops.kernels import Matern52

    x = _clustered(jax.random.PRNGKey(17), 1200, 8)
    xu = x[:600]
    cov = Matern52(3.0)

    assert xu.shape[0] > lg.NYSTROEM_EXACT_MAX
    L_rand = lg._modified_low_rank(x, cov, xu, rank=0.99)

    old = lg.NYSTROEM_EXACT_MAX
    try:
        lg.NYSTROEM_EXACT_MAX = 10**9  # force the exact reference path
        L_exact = lg._modified_low_rank(x, cov, xu, rank=0.99)
    finally:
        lg.NYSTROEM_EXACT_MAX = old

    # the two paths may disagree in the negligible tail the power-of-two
    # rank quantization pads in; the contract is that both approximate the
    # TRUE covariance equally well, and agree to the tail scale overall
    K_true = np.asarray(cov(x, x))
    Ke = np.asarray(L_exact @ L_exact.T)
    Kr = np.asarray(L_rand @ L_rand.T)
    err_exact = np.linalg.norm(K_true - Ke) / np.linalg.norm(K_true)
    err_rand = np.linalg.norm(K_true - Kr) / np.linalg.norm(K_true)
    assert err_rand < 1.05 * err_exact + 1e-6
    assert np.linalg.norm(Ke - Kr) / np.linalg.norm(Ke) < 1e-3


def test_modified_low_rank_randomized_near_flat_spectrum():
    """On an adversarial near-flat spectrum (iid points in low dims) the
    sketch truncates real mass; the result must still approximate the TRUE
    covariance about as well as the exact rank-limited path does."""
    import mellon_tpu.ops.linalg as lg
    from mellon_tpu.ops.kernels import Matern52

    key = jax.random.PRNGKey(17)
    x = jax.random.normal(key, (1200, 4)) * 2
    xu = x[:600]
    cov = Matern52(3.0)
    K_true = np.asarray(cov(x, x))

    L_rand = lg._modified_low_rank(x, cov, xu, rank=0.99)
    old = lg.NYSTROEM_EXACT_MAX
    try:
        lg.NYSTROEM_EXACT_MAX = 10**9
        L_exact = lg._modified_low_rank(x, cov, xu, rank=0.99)
    finally:
        lg.NYSTROEM_EXACT_MAX = old

    def rel_err(L):
        Lh = np.asarray(L)
        return np.linalg.norm(K_true - Lh @ Lh.T) / np.linalg.norm(K_true)

    assert rel_err(L_rand) < 1.5 * rel_err(L_exact) + 1e-3


def test_randomized_eigh_top_spectrum():
    """randomized_eigh recovers the dominant eigenpairs of a PSD matrix."""
    from mellon_tpu.ops.linalg import randomized_eigh

    rng = np.random.RandomState(0)
    Q, _ = np.linalg.qr(rng.randn(300, 300))
    vals = np.sort(np.concatenate([np.geomspace(1e-6, 10.0, 290),
                                   np.geomspace(20.0, 100.0, 10)]))
    A = jnp.asarray((Q * vals) @ Q.T)
    s, v = randomized_eigh(A, 16)
    # the well-separated dominant pairs converge fast; the pairs at the
    # sketch edge (s ~ the 10/20 gap) are only oversampling-accurate
    np.testing.assert_allclose(np.asarray(s)[-5:], vals[-5:], rtol=1e-7)
    np.testing.assert_allclose(np.asarray(s)[-10:], vals[-10:], rtol=1e-4)
    res = np.asarray(A @ v - v * s)
    assert np.linalg.norm(res, axis=0)[-5:].max() < 1e-3 * vals[-1]


def test_eigendecomposition_raw_rank_pre_quantization():
    """with_raw_rank must report the mass-selected rank BEFORE the
    power-of-two bucket: the Nystroem sketch-saturation check uses it, and
    the quantized rank would spuriously saturate mid-range selections."""
    from mellon_tpu.ops.linalg import _eigendecomposition

    rs = np.random.RandomState(3)
    n = 300  # > 256 so fractional ranks quantize
    A = rs.randn(n, 2 * n)
    W = jnp.asarray(A @ A.T / (2 * n) + 1e-3 * np.eye(n))
    s, v, raw_p = _eigendecomposition(W, rank=0.9, with_raw_rank=True)
    p = s.shape[0]
    assert raw_p <= p  # quantization only rounds UP
    # allowed: raw (no quantization), a power-of-two bucket, or the n cap
    # (quantized ranks are clipped to A.shape[0] when the bucket exceeds n)
    assert p in (raw_p, 2, 4, 8, 16, 32, 64, 128, 256, 512, n)
    # integer ranks: raw == selected
    s2, v2, raw2 = _eigendecomposition(W, rank=17, with_raw_rank=True)
    assert raw2 == s2.shape[0] == 17


def test_knn_exact_candidates_survive_offset_cluster():
    """Regression for the round-5 candidate-selection fix: on a dense
    cluster far from the origin the matmul-form squared distances carry
    absolute cancellation noise eps*|x|^2 that exceeds the true squared
    1-NN distances (this is what inflated the ls heuristic 35% at the 98k
    d=2 shape and held its fidelity cert at corr 0.911).  The low-d exact
    coordinate-difference candidate path must return 1-NN distances at
    relative accuracy regardless of the coordinate offset.  (For scale:
    forcing the same data through the matmul path by padding to >16 dims
    yields ~99% of distances wrong by >10%.)"""
    from mellon_tpu.ops.neighbors import nn_distances

    rs = np.random.RandomState(0)
    x = (1000.0 + rs.rand(2000, 2) * 1.0).astype(np.float32)
    nn = np.asarray(nn_distances(jnp.asarray(x)))
    x64 = x.astype(np.float64)
    full = np.sqrt(((x64[:, None, :] - x64[None, :, :]) ** 2).sum(-1))
    np.fill_diagonal(full, np.inf)
    ref = full.min(1)
    rel = np.abs(nn - ref) / ref
    assert rel.max() < 1e-5, rel.max()
