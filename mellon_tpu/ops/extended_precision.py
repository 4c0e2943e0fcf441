"""Extended-precision (double-single) matrix products from bf16 matmuls.

Why this exists (SURVEY.md §7 "Precision"): at the
reference's 98k-cell d=2 time-series shape the product kernel saturates and
the landmark matrix K_uu is so ill-conditioned that the sparse-GP
factorization L = C Lp⁻ᵀ amplifies f32 rounding by ~cond(Lp) — the f32
triangular solve against a (host-f64) factor certifies only corr 0.76
against the reference's fully-f64 pipeline.  The reference never sees this
because it runs float64 on the host (``mellon/__init__.py:44-59``);
this layer gives f64-EQUIVALENT products from f32 storage and bf16
matrix products.

The scheme (Ozaki-style error-free slicing):

* The ill-conditioned triangular factor is inverted ONCE on the host in
  f64 (m×m, seconds) and shipped as a double-single pair
  ``B = B_hi + B_lo`` of f32 arrays — 48 effective mantissa bits.
* The big (n, m) × (m, m) product ``A @ B`` runs on device as a sum of
  bf16×bf16→f32 matmuls over *fixed-point slices*: rows of A and columns
  of B are scaled by powers of two into [-1, 1), then cut into 8-bit
  slices on an ABSOLUTE binary grid (slice k holds bits [8k, 8(k+1)) of
  the scaled value), so every slice is exactly bf16-representable and the
  product of two slices is an exact multiple of a common grid.  With
  contraction chunks of ≤128 terms the f32 accumulator of the matmul
  stays within 23 bits of the grid — every chunk partial sum is EXACT,
  not merely rounded.  This premise is the hardware's: it needs a
  bf16×bf16 product that accumulates in f32 without dropping bits
  (``chip_smoke.py`` checks it on the GPU at (16,384 x 5,000) @
  (5,000 x {1, 64}) against numpy float64).
* Chunk partials and slice-pair partials combine elementwise in
  double-single arithmetic (TwoSum), so the only unrecoverable errors are
  the dropped high-order slice pairs (≤ 2⁻⁴⁰ of the accumulation
  amplitude) and the f32 representation of A itself.

Cost: ``len(kept pairs)`` (20 by default) bf16 matmuls over the data —
about 20× a plain bf16 matmul's FLOPs.

No reference counterpart exists (the reference is host-f64 end to end).
"""

import logging
import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

logger = logging.getLogger("mellon_tpu")

# 8-bit slices: bf16 has an 8-bit significand (7 explicit + 1 implicit),
# so an 8-bit fixed-point slice is exactly representable
SLICE_BITS = 8
# contraction-chunk length: products of two 8-bit slices live on a 16-bit
# grid; 2^7 = 128 of them sum to <= 23 bits — exactly representable in the
# f32 accumulator of a bf16 matmul
CHUNK_K = 128
# number of slices of the f32 A operand and of the double-single B
# operand (6 x 8 = 48 bits).  A needs FIVE slices, not three: the slices
# live on an absolute per-row grid, so an element 2^-8k below its row
# maximum only keeps 24 - 8k of its f32 bits — with 5 slices every
# element >= 2^-16 of the row max is captured in full, and the truncation
# floor drops to ~2^-41 of the accumulation amplitude (measured: 3 slices
# floor at ~1e-7 of amplitude, which is no better than a compensated f32
# product under heavy cancellation)
A_SLICES = 5
B_SLICES = 6
# keep slice pairs with i + j <= MAX_PAIR: dropped pairs contribute
# <= ~2^-(8*(MAX_PAIR+1)) of the accumulation amplitude
MAX_PAIR = 5


def _two_sum(a, b):
    """Error-free transformation: a + b = s + e exactly (Knuth TwoSum,
    branch-free, 6 flops — no FMA required)."""
    a, b = _coerce_working_dtype(a, b)  # see _coerce_working_dtype
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _ds_add(hi, lo, v):
    """Add an f32 value to a double-single accumulator."""
    s, e = _two_sum(hi, v)
    return s, lo + e


def _exact_pow2(e):
    """Exactly 2**e for integer-valued float e.  ``jnp.exp2`` is a
    polynomial approximation with ~1-ulp error even at integer arguments
    (measured: exp2(-13) = 1.2207025e-4 on XLA CPU f32, 5e-7 relative off)
    — ``ldexp`` constructs the exponent bits exactly."""
    return jnp.ldexp(jnp.ones((), dtype=e.dtype), e.astype(jnp.int32))


def _pow2_scale(max_abs):
    """Exact power-of-two scale 2**e with |x| / 2**e < 1 for |x| <= max_abs."""
    e = jnp.floor(jnp.log2(jnp.maximum(max_abs, 1e-38))) + 1.0
    return _exact_pow2(e), e


def _fixed_point_slices(x_scaled, n_slices, extra=None, extra_after=None):
    """Cut |x| < 1 into ``n_slices`` 8-bit slices on the absolute binary
    grid: slice k is a multiple of 2^-8(k+1) with |slice| <= 2^-8k —
    exactly bf16-representable.  ``extra`` (same shape) is added to the
    residual after ``extra_after`` slices (used to append the low word of
    a double-single operand once the high word's bits are exhausted)."""
    slices = []
    r = x_scaled
    for k in range(n_slices):
        g = float(2.0 ** (-SLICE_BITS * (k + 1)))
        s = jnp.round(r * (1.0 / g)) * g
        slices.append(s.astype(jnp.bfloat16))
        r = r - s
        if extra is not None and k + 1 == extra_after:
            r = r + extra
    return slices


def _kept_pairs(a_slices=None, b_slices=None, max_pair=None):
    return [
        (i, j)
        for i in range(a_slices if a_slices is not None else A_SLICES)
        for j in range(b_slices if b_slices is not None else B_SLICES)
        if i + j <= (max_pair if max_pair is not None else MAX_PAIR)
    ]


@partial(jax.jit, static_argnames=("with_ds",))
def _ds_matmul_block(A, B_hi, B_lo, A_lo=None, with_ds=False):
    """One row-block of the extended-precision product A @ (B_hi + B_lo).

    A: (nb, K) f32 — optionally a double-single pair with ``A_lo`` (used
    when the left operand is itself an extended-precision kernel
    evaluation);  B_hi/B_lo: (K, M) f32 double-single pair.
    Returns f32 (nb, M), or the (hi, lo) pair when ``with_ds``.
    """
    nb, K = A.shape
    M = B_hi.shape[1]

    # --- per-row / per-column power-of-two scaling -------------------------
    a_scale, a_e = _pow2_scale(jnp.max(jnp.abs(A), axis=1, keepdims=True))
    b_max = jnp.max(jnp.abs(B_hi), axis=0, keepdims=True)
    b_scale, b_e = _pow2_scale(b_max)
    As = A / a_scale
    Bs_hi = B_hi / b_scale
    Bs_lo = B_lo / b_scale

    # --- fixed-point slicing ----------------------------------------------
    n_a_slices = A_SLICES if A_lo is None else B_SLICES
    a_slices = _fixed_point_slices(
        As,
        n_a_slices,
        extra=None if A_lo is None else A_lo / a_scale,
        extra_after=None if A_lo is None else 3,
    )
    b_slices = _fixed_point_slices(
        Bs_hi, B_SLICES, extra=Bs_lo, extra_after=3
    )
    pairs = _kept_pairs(a_slices=n_a_slices)

    # --- pad the contraction axis to a CHUNK_K multiple --------------------
    n_chunks = -(-K // CHUNK_K)
    Kp = n_chunks * CHUNK_K
    if Kp != K:
        pad_a = [(0, 0), (0, Kp - K)]
        pad_b = [(0, Kp - K), (0, 0)]
        a_slices = [jnp.pad(s, pad_a) for s in a_slices]
        b_slices = [jnp.pad(s, pad_b) for s in b_slices]

    a_stack = jnp.stack(a_slices)          # (n_a_slices, nb, Kp) bf16
    b_stack = jnp.stack(b_slices)          # (B_SLICES, Kp, M) bf16
    # add small-magnitude pairs first so the double-single accumulator's
    # low word absorbs them before the large pairs land
    pairs.sort(key=lambda ij: -(ij[0] + ij[1]))

    def chunk_body(carry, c):
        hi, lo = carry
        a_c = jax.lax.dynamic_slice(
            a_stack, (0, 0, c * CHUNK_K), (n_a_slices, nb, CHUNK_K)
        )
        b_c = jax.lax.dynamic_slice(
            b_stack, (0, c * CHUNK_K, 0), (B_SLICES, CHUNK_K, M)
        )
        for i, j in pairs:
            # exact chunk partial: bf16 x bf16 products on a common grid,
            # f32-accumulated within 23 bits
            p = jnp.matmul(
                a_c[i], b_c[j], preferred_element_type=jnp.float32
            )
            hi, lo = _ds_add(hi, lo, p)
        return (hi, lo), None

    init = (
        jnp.zeros((nb, M), dtype=jnp.float32),
        jnp.zeros((nb, M), dtype=jnp.float32),
    )
    (hi, lo), _ = jax.lax.scan(
        chunk_body, init, jnp.arange(n_chunks)
    )

    # --- undo the exact power-of-two scaling -------------------------------
    unscale = _exact_pow2(a_e + b_e)
    hi = hi * unscale
    lo = lo * unscale
    if with_ds:
        return hi, lo
    return hi + lo


def ds_matmul(A, B_hi, B_lo, block_rows=16384, with_ds=False):
    """Extended-precision A @ (B_hi + B_lo) with ~2⁻⁴⁰-relative
    accumulation error, row-blocked so one shape-stable executable serves
    arbitrarily large n.

    A : (n, K) f32 device array.
    B_hi, B_lo : (K, M) f32 double-single pair (e.g. from
        :func:`ds_from_f64`).
    """
    A = jnp.asarray(A, jnp.float32)
    n = A.shape[0]
    if n <= block_rows:
        return _ds_matmul_block(A, B_hi, B_lo, with_ds=with_ds)
    outs = []
    for start in range(0, n, block_rows):
        Ai = A[start : start + block_rows]
        if Ai.shape[0] < block_rows:
            Ai = jnp.pad(Ai, [(0, block_rows - Ai.shape[0]), (0, 0)])
        outs.append(_ds_matmul_block(Ai, B_hi, B_lo, with_ds=with_ds))
    if with_ds:
        hi = jnp.concatenate([o[0] for o in outs], axis=0)[:n]
        lo = jnp.concatenate([o[1] for o in outs], axis=0)[:n]
        return hi, lo
    return jnp.concatenate(outs, axis=0)[:n]


def ds_from_f64(X64):
    """Double-single (hi, lo) f32 pair of a host float64 array — exact to
    ~2⁻⁴⁸ relative."""
    X64 = np.asarray(X64, dtype=np.float64)
    hi = X64.astype(np.float32)
    lo = (X64 - hi.astype(np.float64)).astype(np.float32)
    return jnp.asarray(hi), jnp.asarray(lo)


def host_triangular_inverse_ds(Lp64, lower=True):
    """(inv(Lp)ᵀ as a double-single pair, computed once on the host in
    f64).  Lp is the m×m Cholesky factor from
    :func:`..linalg.host_cholesky_f64`; the returned pair feeds
    :func:`ds_matmul` so L = C Lp⁻ᵀ becomes one extended-precision GEMM
    with no sequential triangular dependency on device."""
    import scipy.linalg as sla

    Lp64 = np.asarray(Lp64, dtype=np.float64)
    m = Lp64.shape[0]
    inv = sla.solve_triangular(Lp64, np.eye(m), lower=lower)
    return ds_from_f64(inv.T)


@partial(jax.jit, static_argnames=("spec",))
def _ds_whiten_block_spec(spec, params, xi, xu, B_hi, B_lo):
    """One row-block of the fully-extended-precision whitening: kernel
    evaluation in double-single arithmetic (C as a (hi, lo) pair) followed
    by the ds×ds sliced product — one program per block shape."""
    C_hi, C_lo = ds_eval_operand_spec(spec, params, xi, xu)
    return _ds_matmul_block(C_hi, B_hi, B_lo, A_lo=C_lo)


def whiten_with_hostf64(x, cov_func, xu, Lp64, block_rows=4096):
    """L = k(x, xu) Lp⁻ᵀ at f64-equivalent accuracy, on device.

    The full-capacity (``config.PRUNE_SINGULAR_LANDMARKS = False``) path:
    the landmark kernel was factorized once on the host in f64
    (:func:`..linalg.host_cholesky_f64`); its triangular inverse ships as
    a double-single pair; the cross-covariance is EVALUATED in
    double-single arithmetic (ds distances/sqrt/exp — the round-4 B-mode
    experiment showed the f32 rounding of the kernel VALUES, amplified by
    ~cond(Lp), dominates once the solve is accurate: device-f32 C reached
    corr 0.76 while host-f64 C reached 0.91 at the 98k d=2 shape); and
    the whitening runs as the sliced ds×ds product.  Kernels without a
    double-single core fall back to f32 evaluation with a log note.
    """
    B_hi, B_lo = host_triangular_inverse_ds(Lp64)
    try:
        spec, params = cov_func.operand_spec()
    except (NotImplementedError, AttributeError):
        spec = None
    ds_eval = False
    if spec is not None:
        try:
            # probe the spec for double-single support on a tiny slice
            ds_eval_operand_spec(spec, params, x[:1], xu[:1])
            ds_eval = True
        except NotImplementedError:
            # WARNING, not INFO: the full-capacity path silently losing
            # its f64-equivalence guarantee is exactly the degradation
            # this route exists to avoid
            logger.warning(
                "Kernel %s has no double-single evaluation core; the "
                "extended-precision whitening will use f32 kernel values "
                "and its f64-equivalence guarantee does NOT hold.",
                type(cov_func).__name__,
            )
    n = x.shape[0]
    blocks = []
    for start in range(0, n, block_rows):
        xi = x[start : start + block_rows]
        if xi.shape[0] < block_rows and n > block_rows:
            xi = jnp.concatenate(
                [xi, jnp.zeros((block_rows - xi.shape[0], x.shape[1]), x.dtype)]
            )
        if ds_eval:
            blocks.append(
                _ds_whiten_block_spec(spec, params, xi, xu, B_hi, B_lo)
            )
            continue
        if spec is not None:
            from .kernels import eval_operand_spec

            C = eval_operand_spec(spec, params, xi, xu)
        else:
            C = cov_func(xi, xu)
        blocks.append(_ds_matmul_block(C, B_hi, B_lo))
    L = blocks[0] if len(blocks) == 1 else jnp.concatenate(blocks, axis=0)
    return L[:n]


# ---------------------------------------------------------------------------
# double-single scalar arithmetic (elementwise): the building blocks
# for f64-equivalent kernel EVALUATION on device.  Mode-B/C of the round-4
# fidelity experiment showed that an accurate solve alone is not enough at
# extreme conditioning: the f32 rounding (~6e-8 absolute) of the kernel
# values themselves is amplified by ~cond(Lp) through the whitening, so C
# must be evaluated in extended precision too.
# ---------------------------------------------------------------------------


def _coerce_working_dtype(a, b):
    """Force both operands onto the working array dtype BEFORE any
    splitting arithmetic.  A python-float operand is f64 on the host, so
    its Dekker split would run at f64 (c = 4097 then splits the 53-bit
    mantissa into a 41-bit high part that is NOT f32-representable) and
    the error term becomes garbage once the parts round to f32 inside the
    traced product — measured as a 3e-6 absolute error on r²/3 in the
    Matern52 double-single core (same failure mode as the split-constant
    note in :func:`ds_exp2neg`)."""
    if not hasattr(a, "dtype"):
        a = jnp.asarray(a, dtype=getattr(b, "dtype", jnp.float32))
    if not hasattr(b, "dtype"):
        b = jnp.asarray(b, dtype=a.dtype)
    return a, b


def _fast_two_sum(a, b):
    """a + b = s + e exactly, assuming |a| >= |b| (or a == 0)."""
    a, b = _coerce_working_dtype(a, b)
    s = a + b
    return s, b - (s - a)


def _two_prod(a, b):
    """a * b = p + e exactly (Dekker splitting; f32 split constant 2^12+1,
    no FMA required)."""
    a, b = _coerce_working_dtype(a, b)
    p = a * b
    c = 4097.0
    aa = a * c
    ah = aa - (aa - a)
    al = a - ah
    bb = b * c
    bh = bb - (bb - b)
    bl = b - bh
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def ds_add2(ah, al, bh, bl):
    """(ah + al) + (bh + bl) as a normalized double-single pair."""
    s, e = _two_sum(ah, bh)
    e = e + (al + bl)
    return _fast_two_sum(s, e)


def ds_mul2(ah, al, bh, bl):
    """(ah + al) * (bh + bl) as a normalized double-single pair."""
    p, e = _two_prod(ah, bh)
    e = e + (ah * bl + al * bh)
    return _fast_two_sum(p, e)


def ds_div2(ah, al, bh, bl):
    """(ah + al) / (bh + bl) via one Newton correction."""
    q1 = ah / bh
    # r = a - q1 * b in double-single
    p, pe = _two_prod(q1, bh)
    rh, rl = ds_add2(ah, al, -p, -(pe + q1 * bl))
    q2 = rh / bh
    return _fast_two_sum(q1, q2)


def ds_sqrt2(ah, al):
    """sqrt(ah + al) via one Newton correction (ah >= 0)."""
    s = jnp.sqrt(jnp.maximum(ah, 0.0))
    p, pe = _two_prod(s, s)
    d = ((ah - p) - pe) + al
    e = jnp.where(s > 0, d / (2.0 * s), 0.0)
    return _fast_two_sum(s, e)


def _ds_const(v):
    """Host float64 constant as an f32 double-single pair."""
    v = np.float64(v)
    hi = np.float32(v)
    lo = np.float32(v - np.float64(hi))
    return float(hi), float(lo)


_LN2_HI, _LN2_LO = _ds_const(0.6931471805599453094172321)
_LOG2E = 1.4426950408889634
# 1/n! for the exp Taylor series, n = 12 .. 2, as double-single pairs
_EXP_COEFFS = [_ds_const(1.0 / math.factorial(n)) for n in range(12, 1, -1)]


def ds_exp2neg(ah, al):
    """exp(ah + al) as a double-single pair, accurate to ~2^-45 relative.

    Intended for non-positive arguments (kernel evaluations use exp(-r));
    large negative inputs underflow cleanly through the 2^k scaling.
    """
    k = jnp.round(ah * _LOG2E)
    # the split constants MUST be arrays of the working dtype: a python
    # float operand makes the Dekker split run at f64 weak-typing and the
    # mixed-precision products break two_prod's exactness (measured as a
    # ~5e-8 reduction error before this cast)
    p1, e1 = _two_prod(k, jnp.asarray(_LN2_HI, ah.dtype))
    p2, e2 = _two_prod(k, jnp.asarray(_LN2_LO, ah.dtype))
    th, tl = _two_sum(ah, -p1)
    tl = tl + al - e1
    th, tl = ds_add2(th, tl, -p2, -e2)
    # Taylor for e^t on |t| <= ln2/2: Horner in double-single
    ph = jnp.full_like(ah, _EXP_COEFFS[0][0])
    pl = jnp.full_like(ah, _EXP_COEFFS[0][1])
    for ch, cl in _EXP_COEFFS[1:]:
        ph, pl = ds_mul2(ph, pl, th, tl)
        ph, pl = ds_add2(ph, pl, ch, cl)
    # e^t = 1 + t + t^2 * P(t) with P = sum_{n=2..12} t^{n-2}/n!
    ph, pl = ds_mul2(ph, pl, th, tl)
    ph, pl = ds_mul2(ph, pl, th, tl)
    ph, pl = ds_add2(ph, pl, th, tl)
    ph, pl = ds_add2(ph, pl, 1.0, 0.0)
    s = _exact_pow2(k)  # exact power-of-two scaling (ldexp, not exp2)
    return ph * s, pl * s


def ds_log2(ah, al):
    """ln(ah + al) as a double-single pair, for ah > 0.

    f32 seed + one extended-precision Newton refinement: with
    y0 = log(ah) accurate to ~2⁻²⁴ relative, r = (x·e^(−y0) − 1) computed
    in double-single satisfies |r| ≲ 2⁻²², and
    ln x = y0 + r − r²/2 + O(r³) with the r³ term (~2⁻⁶⁶) below the
    double-single precision floor.  The e^(−y0) evaluation reuses
    :func:`ds_exp2neg` (its range reduction is sign-agnostic; only
    overflow at |arg| ≳ 88 is excluded, unreachable here since
    |y0| = |ln x| ≲ 88 for finite f32 x)."""
    y0 = jnp.log(ah)
    zero = jnp.zeros_like(ah)
    eh, el = ds_exp2neg(-y0, zero)
    ph, pl = ds_mul2(ah, al, eh, el)
    rh, rl = ds_add2(ph, pl, -1.0, 0.0)
    r2h, r2l = ds_mul2(rh, rl, rh, rl)
    ch, cl = ds_add2(rh, rl, -0.5 * r2h, -0.5 * r2l)
    return ds_add2(y0, zero, ch, cl)


def ds_pow2(ah, al, bh, bl):
    """(ah + al) ** (bh + bl) as a double-single pair via exp(b·ln a).

    Defined for ah > 0; non-positive bases fall back to the f32 power
    (matching the plain-precision semantics, e.g. 0**b = 0 for b > 0 and
    NaN for negative bases with fractional exponents)."""
    safe_h = jnp.where(ah > 0, ah, 1.0)
    safe_l = jnp.where(ah > 0, al, 0.0)
    lh, ll = ds_log2(safe_h, safe_l)
    th, tl = ds_mul2(lh, ll, bh, bl)
    eh, el = ds_exp2neg(th, tl)
    fallback = (ah + al) ** (bh + bl)
    return (
        jnp.where(ah > 0, eh, fallback),
        jnp.where(ah > 0, el, 0.0),
    )


# ---------------------------------------------------------------------------
# double-single kernel evaluation from the operand spec
# ---------------------------------------------------------------------------

_DS_EPS = _ds_const(1e-12)
_SQRT3 = _ds_const(np.sqrt(np.float64(3.0)))
_SQRT5 = _ds_const(np.sqrt(np.float64(5.0)))
_THIRD = _ds_const(1.0 / 3.0)
_HALF = (0.5, 0.0)


def _ds_distance(x, y):
    """Pairwise Euclidean distance as a double-single pair.

    Exact-difference form: two_sum differences (error-free), double-single
    squares and sums, plus the reference's 1e-12 epsilon inside the sqrt
    (``mellon/util.py:351-366`` parity — in f64 semantics)."""
    d = x.shape[1]
    ah = jnp.zeros((x.shape[0], y.shape[0]), dtype=x.dtype)
    al = jnp.zeros_like(ah)
    for j in range(d):
        dh, dl = _two_sum(x[:, j, None], -y[None, :, j])
        sh, sl = ds_mul2(dh, dl, dh, dl)
        ah, al = ds_add2(ah, al, sh, sl)
    ah, al = ds_add2(ah, al, *_DS_EPS)
    return ds_sqrt2(ah, al)


def _ds_scaled_r(x, y, ls, scale_const):
    ch, cl = ds_div2(
        jnp.asarray(scale_const[0], x.dtype),
        jnp.asarray(scale_const[1], x.dtype),
        ls,
        jnp.zeros_like(ls),
    )
    dh, dl = _ds_distance(x, y)
    return ds_mul2(dh, dl, ch, cl)


def _ds_matern52(x, y, ls):
    rh, rl = _ds_scaled_r(x, y, ls, _SQRT5)
    r2h, r2l = ds_mul2(rh, rl, rh, rl)
    r23h, r23l = ds_mul2(r2h, r2l, *_THIRD)
    ph, pl = ds_add2(rh, rl, r23h, r23l)
    ph, pl = ds_add2(ph, pl, 1.0, 0.0)
    eh, el = ds_exp2neg(-rh, -rl)
    return ds_mul2(ph, pl, eh, el)


def _ds_matern32(x, y, ls):
    rh, rl = _ds_scaled_r(x, y, ls, _SQRT3)
    ph, pl = ds_add2(rh, rl, 1.0, 0.0)
    eh, el = ds_exp2neg(-rh, -rl)
    return ds_mul2(ph, pl, eh, el)


def _ds_expquad(x, y, ls):
    rh, rl = _ds_scaled_r(x, y, ls, (1.0, 0.0))
    r2h, r2l = ds_mul2(rh, rl, rh, rl)
    hh, hl = ds_mul2(r2h, r2l, *_HALF)
    return ds_exp2neg(-hh, -hl)


def _ds_exponential(x, y, ls):
    rh, rl = _ds_scaled_r(x, y, ls, (1.0, 0.0))
    hh, hl = ds_mul2(rh, rl, *_HALF)
    return ds_exp2neg(-hh, -hl)


def _ds_ratquad(x, y, ls, alpha):
    """(1 + r²/2α)^(−α) with r = ‖x−y‖/ls, via exp(−α·ln u) in
    double-single (u ≥ 1 so ln u ≥ 0 and the exp argument is
    non-positive).  Parity: ``mellon/cov.py:399-499``."""
    rh, rl = _ds_scaled_r(x, y, ls, (1.0, 0.0))
    r2h, r2l = ds_mul2(rh, rl, rh, rl)
    zero = jnp.zeros_like(alpha)
    qh, ql = ds_div2(r2h, r2l, 2.0 * alpha, 2.0 * zero)
    uh, ul = ds_add2(qh, ql, 1.0, 0.0)
    lh, ll = ds_log2(uh, ul)
    th, tl = ds_mul2(lh, ll, alpha, zero)
    return ds_exp2neg(-th, -tl)


def _ds_linear(x, y, ls):
    """x·y / ls with an error-free-product accumulated dot product.
    Parity: ``mellon/cov.py:502-592``."""
    d = x.shape[1]
    ah = jnp.zeros((x.shape[0], y.shape[0]), dtype=x.dtype)
    al = jnp.zeros_like(ah)
    for j in range(d):
        ph, pe = _two_prod(x[:, j, None], y[None, :, j])
        ah, al = ds_add2(ah, al, ph, pe)
    return ds_div2(ah, al, ls, jnp.zeros_like(ls))


_DS_CORES = {
    "matern52": _ds_matern52,
    "matern32": _ds_matern32,
    "expquad": _ds_expquad,
    "exponential": _ds_exponential,
    "ratquad": _ds_ratquad,
    "linear": _ds_linear,
}


def ds_eval_operand_spec(spec, params, x, y):
    """Evaluate a kernel operand spec at double-single precision; returns
    the (hi, lo) pair.  Mirrors :func:`..kernels.eval_operand_spec` with
    f64-equivalent arithmetic; raises NotImplementedError for structures
    without a double-single core (callers fall back to f32)."""
    params = tuple(jnp.asarray(p).astype(x.dtype) for p in params)
    (h, l), used = _ds_eval_spec(spec, params, 0, x, y)
    if used != len(params):
        raise ValueError("operand spec consumed wrong number of parameters")
    return h, l


def _ds_eval_spec(spec, params, i, x, y):
    from .kernels import _restore_active_dims
    from ..utils.util import select_active_dims

    tag = spec[0]
    active_dims = _restore_active_dims(spec[1])
    x = select_active_dims(x, active_dims)
    y = select_active_dims(y, active_dims)
    if tag in ("add", "mul", "pow"):
        (lh, ll), i = _ds_eval_branch(spec[2], params, i, x, y)
        (rh, rl), i = _ds_eval_branch(spec[3], params, i, x, y)
        if tag == "add":
            return ds_add2(lh, ll, rh, rl), i
        if tag == "mul":
            return ds_mul2(lh, ll, rh, rl), i
        return ds_pow2(lh, ll, rh, rl), i
    core = _DS_CORES.get(tag)
    if core is None:
        raise NotImplementedError(
            f"No double-single core for kernel spec tag {tag!r}."
        )
    n = spec[2]
    return core(x, y, *params[i : i + n]), i + n


def _ds_eval_branch(spec, params, i, x, y):
    if spec == "__const__":
        return (params[i], jnp.zeros_like(params[i])), i + 1
    return _ds_eval_spec(spec, params, i, x, y)


# ---------------------------------------------------------------------------
# host-f64 kernel evaluation from the operand spec (numpy mirror)
# ---------------------------------------------------------------------------


def _np_distance(X, Y):
    xx = np.sum(X * X, axis=1)[:, None]
    yy = np.sum(Y * Y, axis=1)[None, :]
    sq = xx - 2.0 * (X @ Y.T) + yy + 1e-12
    return np.sqrt(np.maximum(sq, 1e-12))


_NP_CORES = {
    "matern32": lambda X, Y, ls: (lambda r: (r + 1) * np.exp(-r))(
        np.sqrt(3.0) * _np_distance(X, Y) / ls
    ),
    "matern52": lambda X, Y, ls: (lambda r: (r + r * r / 3 + 1) * np.exp(-r))(
        np.sqrt(5.0) * _np_distance(X, Y) / ls
    ),
    "expquad": lambda X, Y, ls: np.exp(
        -np.square(_np_distance(X, Y) / ls) / 2
    ),
    "exponential": lambda X, Y, ls: np.exp(-_np_distance(X, Y) / ls / 2),
    "ratquad": lambda X, Y, ls, alpha: (
        np.square(_np_distance(X, Y) / ls) / (2 * alpha) + 1
    )
    ** -alpha,
    "linear": lambda X, Y, ls: X @ Y.T / ls,
}

_NP_OPS = {
    "add": lambda a, b: a + b,
    "mul": lambda a, b: a * b,
    "pow": lambda a, b: a**b,
}


def host_spec_kernel_f64(spec, params, X, Y=None):
    """Evaluate a kernel operand spec on the host in float64 — the
    reference's numerics (``mellon/__init__.py:44-59``), used to rebuild
    the landmark kernel from coordinates for the full-capacity
    factorization instead of factorizing f32-rounded values."""
    from .kernels import _restore_active_dims
    from ..utils.util import select_active_dims

    X = np.asarray(jax.device_get(X), dtype=np.float64)
    Y = X if Y is None else np.asarray(jax.device_get(Y), dtype=np.float64)
    params = tuple(
        np.float64(np.asarray(jax.device_get(p))) for p in params
    )
    val, used = _np_eval_spec(spec, params, 0, X, Y)
    if used != len(params):
        raise ValueError("operand spec consumed wrong number of parameters")
    return val


def _np_eval_spec(spec, params, i, X, Y):
    from .kernels import _restore_active_dims
    from ..utils.util import select_active_dims

    tag = spec[0]
    active_dims = _restore_active_dims(spec[1])
    X = np.asarray(select_active_dims(X, active_dims))
    Y = np.asarray(select_active_dims(Y, active_dims))
    if tag in _NP_OPS:
        left, i = _np_eval_branch(spec[2], params, i, X, Y)
        right, i = _np_eval_branch(spec[3], params, i, X, Y)
        return _NP_OPS[tag](left, right), i
    core = _NP_CORES.get(tag)
    if core is None:
        raise NotImplementedError(
            f"No host-f64 core for kernel spec tag {tag!r}."
        )
    n = spec[2]
    return core(X, Y, *params[i : i + n]), i + n


def _np_eval_branch(spec, params, i, X, Y):
    if spec == "__const__":
        return params[i], i + 1
    return _np_eval_spec(spec, params, i, X, Y)
