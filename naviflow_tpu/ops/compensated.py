"""Compensated (double-single) floating-point evaluation for residuals.

Purpose: the accelerator path is float32, whose outer-residual floor is
~2e-7 — the residual field ``r = src - A x``
suffers catastrophic cancellation when the true residual is ~1e-7 of the
O(1) stencil terms, so 1e-7 convergence targets (reference regime, e.g.
``matrix_BiCGSTAB.py:21``) could previously only be demonstrated in f64 on
CPU.  These helpers evaluate the residual as an error-free transformation:
every product via Dekker TwoProduct (exact f32 split multiplication),
every accumulation via Knuth TwoSum, carrying a (hi, lo) double-single
pair — the hi word is the correctly rounded f32 of the EXACT residual.
~6x the flops of the plain stencil, but the op is bandwidth-bound, so the
measured cost is small; used only for the residual *measurement*, never
inside the solver iterations.

In f64 (CPU tests) the same code simply produces ~1e-31-accurate
residuals, so golden tests compare it against the plain f64 evaluation.
"""

from __future__ import annotations

import jax.numpy as jnp


def two_sum(a, b):
    """Knuth TwoSum: s + e == a + b exactly (any rounding mode)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _split(a):
    """Dekker split: a == hi + lo with hi/lo each having half-width
    mantissas.  Factor 2^ceil(p/2)+1: f32 (p=24) -> 4097, f64 (p=53) ->
    134217729."""
    factor = jnp.asarray(4097.0 if a.dtype == jnp.float32 else 134217729.0,
                         a.dtype)
    c = factor * a
    hi = c - (c - a)
    lo = a - hi
    return hi, lo


def two_prod(a, b):
    """Dekker TwoProduct: p + e == a*b exactly (no FMA needed)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def compensated_linear_combination(terms):
    """sum of ``terms`` as a double-single (hi, lo) pair.

    ``terms``: list of either arrays (added exactly as-is) or (coef, x)
    pairs (multiplied with TwoProduct).  Accumulation by cascaded TwoSum
    with first-order error propagation (double-single "add" without
    renormalization at every step — errors are summed separately, which is
    exact to second order and sufficient for a 2^24 dynamic range).
    """
    hi = None
    lo = None
    for t in terms:
        if isinstance(t, tuple):
            p, e = two_prod(*t)
        else:
            p, e = t, None
        if hi is None:
            hi = p
            lo = jnp.zeros_like(p) if e is None else e
        else:
            hi, carry = two_sum(hi, p)
            lo = lo + carry if e is None else lo + (carry + e)
    # renormalize once
    s, e = two_sum(hi, lo)
    return s, e


def residual_5pt(x, src, a_e, a_w, a_n, a_s, a_p, shifts):
    """Exact-to-f32 residual r = src + sum(a_nb x_nb) - a_p x.

    ``shifts``: (xE, xW, xN, xS) pre-shifted neighbor arrays.  Returns the
    hi word of the double-single residual.
    """
    xE, xW, xN, xS = shifts
    hi, _ = compensated_linear_combination([
        src, (a_e, xE), (a_w, xW), (a_n, xN), (a_s, xS), (-a_p, x),
    ])
    return hi


def compensated_norm(x):
    """L2 norm with exact squaring + compensated pairwise accumulation
    (:func:`fold_dot`)."""
    return jnp.sqrt(fold_dot(x, x))


# ---------------------------------------------------------------------------
# Compensated pairwise reductions
#
# `fold_sum` is a PAIRWISE sum with an explicit compensation channel: each
# halving fold is a vectorized `two_sum` whose rounding errors accumulate in
# a side array folded alongside (the carries are O(eps) of the data, so
# plain adds on the error channel contribute only O(eps^2)).  The result
# matches the exact sum to a couple of ulps — accuracy-equivalent to f64
# accumulation for f32 data — in log2(n) vector ops, all static slices
# (no scatter, no dynamic shapes).
# ---------------------------------------------------------------------------


def _mask_overlap(b, axis, n_overlap):
    """Zero the first ``n_overlap`` rows/cols of ``b`` (exact operation —
    an iota-mask ``where``)."""
    import jax

    idx = jax.lax.broadcasted_iota(jnp.int32, b.shape, axis)
    return jnp.where(idx >= n_overlap, b, jnp.zeros_like(b))


def fold_sum(x, err0=None):
    """Compensated sum of ALL elements of a 2-D array.

    Ceil-halving folds: the upper half is taken as the LAST ``ceil(n/2)``
    rows (overlapping the lower half by one row when ``n`` is odd, with the
    overlapped row masked to zero — static slices + iota masks only).

    ``err0``: optional same-shape array added into the compensation channel
    (used by :func:`fold_dot` to seed the TwoProduct tails).
    """
    err = jnp.zeros_like(x) if err0 is None else err0
    for axis in (0, 1):
        while x.shape[axis] > 1:
            n = x.shape[axis]
            h = (n + 1) // 2
            if axis == 0:
                a, b = x[:h], x[n - h:]
                ea, eb = err[:h], err[n - h:]
            else:
                a, b = x[:, :h], x[:, n - h:]
                ea, eb = err[:, :h], err[:, n - h:]
            if 2 * h > n:  # odd: first row of b aliases last row of a
                b = _mask_overlap(b, axis, 2 * h - n)
                eb = _mask_overlap(eb, axis, 2 * h - n)
            x, c = two_sum(a, b)
            err = ea + eb + c
    s, c = two_sum(x[0, 0], err[0, 0])
    del c  # hi word is the correctly rounded compensated sum
    return s


def fold_dot(a, b):
    """Compensated dot product: exact per-element TwoProduct, pairwise
    compensated accumulation.  For the breakdown-sensitive BiCGSTAB scalars
    (rho, denom, omega) whose values near convergence are ~eps of
    sum|a_i b_i|."""
    p, e = two_prod(a, b)
    return fold_sum(p, err0=e)

