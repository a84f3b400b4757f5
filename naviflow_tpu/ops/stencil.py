"""Shift helpers and the generic 5-point stencil apply.

These are the building blocks shared by the momentum and pressure operators.
Everything is expressed as whole-array shifted reads with zero padding —
XLA fuses the shifts, multiplies and adds into a single elementwise kernel,
which is the data-parallel formulation of the reference's sliced NumPy
stencils (``helpers/matrix_free.py:100-133``,
``momentum_solver/matrix_free_momentum.py:49-79``).

Index convention: axis 0 is i (x / east-west), axis 1 is j (y / north-south).
``shift_e(x)[i, j] == x[i+1, j]`` (zero beyond the boundary), etc.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp


def shift_e(x):
    """x[i+1, j], zero-padded at the east edge."""
    return jnp.pad(x[1:, :], ((0, 1), (0, 0)))


def shift_w(x):
    """x[i-1, j], zero-padded at the west edge."""
    return jnp.pad(x[:-1, :], ((1, 0), (0, 0)))


def shift_n(x):
    """x[i, j+1], zero-padded at the north edge."""
    return jnp.pad(x[:, 1:], ((0, 0), (0, 1)))


def shift_s(x):
    """x[i, j-1], zero-padded at the south edge."""
    return jnp.pad(x[:, :-1], ((0, 0), (1, 0)))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class StencilCoeffs:
    """5-point stencil coefficients + source, all full-grid arrays.

    Row form: ``a_p * x_P - a_e * x_E - a_w * x_W - a_n * x_N - a_s * x_S = src``.
    Matches the coefficient-dict contract of the reference discretizations
    (``power_law.py:202-209``).
    """

    a_e: jax.Array
    a_w: jax.Array
    a_n: jax.Array
    a_s: jax.Array
    a_p: jax.Array
    src: jax.Array

    def replace(self, **kw) -> "StencilCoeffs":
        return dataclasses.replace(self, **kw)


def apply_stencil(x, c: StencilCoeffs):
    """A @ x for the 5-point operator (full grid; boundary rows whose
    coefficients are zero simply produce ``a_p * x`` there)."""
    return (
        c.a_p * x
        - c.a_e * shift_e(x)
        - c.a_w * shift_w(x)
        - c.a_n * shift_n(x)
        - c.a_s * shift_s(x)
    )


def neighbor_sum(x, c: StencilCoeffs):
    """Sum of off-diagonal contributions a_e*x_E + a_w*x_W + a_n*x_N + a_s*x_S."""
    return (
        c.a_e * shift_e(x)
        + c.a_w * shift_w(x)
        + c.a_n * shift_n(x)
        + c.a_s * shift_s(x)
    )


def _edit_mask(shape, rows, cols):
    ii = jax.lax.broadcasted_iota(jnp.int32, shape, 0)
    jj = jax.lax.broadcasted_iota(jnp.int32, shape, 1)
    m = jnp.ones(shape, bool)
    if rows is not None:
        lo, hi = (rows, rows + 1) if isinstance(rows, int) else rows
        m &= (ii >= lo) & (ii < hi)
    if cols is not None:
        lo, hi = (cols, cols + 1) if isinstance(cols, int) else cols
        m &= (jj >= lo) & (jj < hi)
    return m


def _col_val(val, cols):
    # a 1-D value written into a single column must broadcast down axis 0
    if isinstance(cols, int) and hasattr(val, "ndim") and val.ndim == 1:
        return val[:, None]
    return val


def where_set(x, val, *, rows=None, cols=None):
    """``x.at[rows, cols].set(val)`` in select form.

    ``rows``/``cols``: an int index, a ``(lo, hi)`` half-open range, or
    ``None`` (whole axis).  Same values as the scatter form, but lowers as
    a pure elementwise select that fuses with its neighbours.
    """
    return jnp.where(_edit_mask(x.shape, rows, cols), _col_val(val, cols), x)


def where_add(x, delta, *, rows=None, cols=None):
    """``x.at[rows, cols].add(delta)`` in select form (see where_set)."""
    return jnp.where(_edit_mask(x.shape, rows, cols),
                     x + _col_val(delta, cols), x)


def interior_mask(shape, lo_i=1, hi_i=1, lo_j=1, hi_j=1, dtype=bool):
    """Boolean mask that is True strictly inside the given margins."""
    ni, nj = shape
    ii = jax.lax.broadcasted_iota(jnp.int32, shape, 0)
    jj = jax.lax.broadcasted_iota(jnp.int32, shape, 1)
    m = (ii >= lo_i) & (ii <= ni - 1 - hi_i) & (jj >= lo_j) & (jj <= nj - 1 - hi_j)
    return m.astype(dtype) if dtype is not bool else m
