"""Cell-centered multigrid transfers (for even grid sizes).

The reference's hierarchy is vertex-style on ``2**k - 1`` grids
(``multigrid_helpers.py``), which cannot be block-decomposed evenly.  For
power-of-two grids — the distributed path and the large-grid benchmarks —
we coarsen cell-centered: ``nc = nf / 2``, coarse cell (I, J) covers the
2x2 fine block.

* :func:`restrict_cc` — 2x2 block average (the adjoint of piecewise-constant
  prolongation up to scale);
* :func:`prolong_cc` — standard bilinear cell-centered interpolation
  (per-axis weights 3/4 nearest / 1/4 next, clamped at boundaries);
* exact Galerkin coarse operators come from the same comb trick as the
  vertex path (``ops/stencil9.galerkin_coarsen`` works with any linear R/P
  whose composite column support stays within one coarse ring).

Array form: both operators are separable tensor products, applied as an
axis-0 strided op followed by a transpose sandwich for axis 1 (no
minor-axis strided access).  Whether the transposes beat direct strided
slices on the GPU is not measured yet.
"""

from __future__ import annotations

import jax.numpy as jnp


def _restrict_ax0(y):
    """(2m, n) -> (m, n): average adjacent row pairs (axis-0 stride only)."""
    return 0.5 * (y[0::2] + y[1::2])


def restrict_cc(fine):
    """(2m, 2n) -> (m, n): mean over each 2x2 block."""
    return _restrict_ax0(_restrict_ax0(fine).T).T


def _prolong_ax0(c):
    """(m, n) -> (2m, n) bilinear along axis 0 with clamped edges."""
    up = jnp.concatenate([c[:1], c[:-1]], 0)  # c[I-1] clamped
    dn = jnp.concatenate([c[1:], c[-1:]], 0)  # c[I+1] clamped
    even = 0.75 * c + 0.25 * up  # fine row 2I
    odd = 0.75 * c + 0.25 * dn  # fine row 2I+1
    return jnp.stack([even, odd], axis=1).reshape(2 * c.shape[0], c.shape[1])


def prolong_cc(coarse):
    """(m, n) -> (2m, 2n) bilinear cell-centered interpolation."""
    return _prolong_ax0(_prolong_ax0(coarse).T).T
