"""9-point stencils and exact Galerkin coarsening (RAP).

The reference's multigrid rediscretizes coarse levels from harmonically
restricted d-coefficients (``multigrid_helpers.py:196-329``).  Measured
against the true Galerkin operator R·A·P that construction is ~2x too strong
near the boundary bands of the consistent operator, which caps the V-cycle
convergence factor around 0.5 (and diverges when "corrected" naively).  We
instead form the exact Galerkin coarse operators:

* with full-weighting restriction R and bilinear prolongation P, the coarse
  operator of a 9-point fine operator is again 9-point;
* all nine coarse stencil arrays are recovered with NINE applications of the
  composite map R∘A∘P to 3-strided "comb" grids: columns K1, K2 of RAP with
  ``|K1-K2|_inf >= 3`` have disjoint supports, so injecting a comb of unit
  vectors and reading the result recovers every column exactly — pure
  whole-array ops, no gathers, O(N) per level, done once per pressure solve.

Stencils are stored SIGNED: ``apply9(x) = sum_k s_k * shift_k(x)`` including
the center, so Galerkin products need no sign bookkeeping.

Smoothing on 9-point levels uses four-color Gauss-Seidel (colors
``(i%2, j%2)`` — every neighbor of a cell, including diagonals, has a
different color, so each masked quarter-sweep is a true GS update).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from .poisson import PoissonCoeffs
from .stencil import shift_e, shift_n, shift_s, shift_w


def shift_ne(x):
    return jnp.pad(x[1:, 1:], ((0, 1), (0, 1)))


def shift_nw(x):
    return jnp.pad(x[:-1, 1:], ((1, 0), (0, 1)))


def shift_se(x):
    return jnp.pad(x[1:, :-1], ((0, 1), (1, 0)))


def shift_sw(x):
    return jnp.pad(x[:-1, :-1], ((1, 0), (1, 0)))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Stencil9:
    """Signed 9-point stencil: (A x)[i,j] = c*x + e*x_E + w*x_W + n*x_N +
    s*x_S + ne*x_NE + nw*x_NW + se*x_SE + sw*x_SW."""

    c: jax.Array
    e: jax.Array
    w: jax.Array
    n: jax.Array
    s: jax.Array
    ne: jax.Array
    nw: jax.Array
    se: jax.Array
    sw: jax.Array

    @property
    def shape(self):
        return self.c.shape


def from_poisson(pc: PoissonCoeffs) -> Stencil9:
    """Embed the 5-point pressure operator (row form diag - a_nb) as a signed
    9-point stencil."""
    z = jnp.zeros_like(pc.diag)
    return Stencil9(
        c=pc.diag, e=-pc.a_e, w=-pc.a_w, n=-pc.a_n, s=-pc.a_s,
        ne=z, nw=z, se=z, sw=z,
    )


def apply9(x, st: Stencil9):
    return (
        st.c * x
        + st.e * shift_e(x)
        + st.w * shift_w(x)
        + st.n * shift_n(x)
        + st.s * shift_s(x)
        + st.ne * shift_ne(x)
        + st.nw * shift_nw(x)
        + st.se * shift_se(x)
        + st.sw * shift_sw(x)
    )


def apply5(x, st: Stencil9):
    """Apply a Stencil9 whose corner entries are known-zero (the 5-point
    finest level, ``from_poisson``).  The corner arrays are runtime zeros
    XLA cannot eliminate; skipping them cuts the HBM traffic of the
    dominant fine-level ops by ~1/3 at bandwidth-bound sizes.  Summation
    order matches :func:`apply9`'s first five terms, so results are
    bit-identical (adding an exact +0.0 never changes a finite f32 sum)."""
    return (
        st.c * x
        + st.e * shift_e(x)
        + st.w * shift_w(x)
        + st.n * shift_n(x)
        + st.s * shift_s(x)
    )


def apply_five(x, st: Stencil9, five_point: bool):
    """Dispatch on the trace-time ``five_point`` flag carried by multigrid
    levels: 5-point fast path on the finest (from_poisson) level, full
    9-point on Galerkin coarse levels."""
    return apply5(x, st) if five_point else apply9(x, st)


def _comb(shape, a, b, dtype):
    """Unit comb: ones at cells with (i % 3, j % 3) == (a, b)."""
    ii = jax.lax.broadcasted_iota(jnp.int32, shape, 0)
    jj = jax.lax.broadcasted_iota(jnp.int32, shape, 1)
    return ((ii % 3 == a) & (jj % 3 == b)).astype(dtype)


_OFFSET_NAMES = {
    (0, 0): "c",
    (1, 0): "e",
    (-1, 0): "w",
    (0, 1): "n",
    (0, -1): "s",
    (1, 1): "ne",
    (-1, 1): "nw",
    (1, -1): "se",
    (-1, -1): "sw",
}


def comb_select(images, ii, jj, di: int, dj: int):
    """Read the comb image value for neighbor offset (di, dj) at each cell:
    ``images[(ii+di)%3, (jj+dj)%3, local_cell]`` — without a gather.

    The naive advanced-indexing form lowers to ``gather``; this form is
    pure elementwise selects that fuse with the rest of the RAP build.
    Cell (i, j) needs image class ``((ii+di)%3, (jj+dj)%3)``; that equals
    (a, b) exactly where ``ii%3 == (a-di)%3`` and ``jj%3 == (b-dj)%3``, so
    nine masked selects recover the same elements bit-for-bit.

    ``images``: (3, 3, m, n); ``ii``, ``jj``: (m, n) global index iotas.
    """
    mi = [(ii % 3) == r for r in range(3)]
    mj = [(jj % 3) == r for r in range(3)]
    val = jnp.zeros(images.shape[2:], images.dtype)
    for a in range(3):
        for b in range(3):
            m = mi[(a - di) % 3] & mj[(b - dj) % 3]
            val = jnp.where(m, images[a, b], val)
    return val


def galerkin_coarsen(st: Stencil9, restrict_fn, prolong_fn, nxc: int, nyc: int) -> Stencil9:
    """Exact A_c = R A P via nine comb applications.

    ``restrict_fn``: fine (nx,ny) -> coarse (nxc,nyc); ``prolong_fn``:
    coarse -> fine.  For coarse cell (I,J) and offset (di,dj), the stencil
    entry s_{di,dj}[I,J] = RAP[(I,J), (I+di, J+dj)] is read from the comb
    image whose class contains (I+di, J+dj).
    """
    dtype = st.c.dtype
    ii = jax.lax.broadcasted_iota(jnp.int32, (nxc, nyc), 0)
    jj = jax.lax.broadcasted_iota(jnp.int32, (nxc, nyc), 1)

    # nine comb applications of the composite P -> A -> R chain (a plain
    # loop, not vmap, so the arithmetic matches the distributed build in
    # parallel/dist_mg.py bit-for-bit — vmap batching changes XLA fusion
    # and costs a couple of ULPs)
    images = jnp.stack(
        [restrict_fn(apply9(prolong_fn(_comb((nxc, nyc), a, b, dtype)), st))
         for a in range(3) for b in range(3)]
    ).reshape(3, 3, nxc, nyc)

    entries = {}
    for (di, dj), name in _OFFSET_NAMES.items():
        # neighbor (I+di, J+dj) belongs to comb class ((I+di)%3, (J+dj)%3);
        # select the matching image value per cell (gather-free)
        val = comb_select(images, ii, jj, di, dj)
        # zero entries that reach outside the coarse grid
        inside = (
            (ii + di >= 0) & (ii + di <= nxc - 1) & (jj + dj >= 0) & (jj + dj <= nyc - 1)
        )
        entries[name] = jnp.where(inside, val, jnp.zeros_like(val))

    return Stencil9(**entries)


def stencil9_diagonal(st: Stencil9, floor: float = 1e-15):
    return jnp.where(jnp.abs(st.c) < floor, jnp.ones_like(st.c), st.c)


def gs4_sweep(p, b, st: Stencil9, omega: float = 1.0):
    """One four-color Gauss-Seidel sweep (valid for any 9-point stencil)."""
    shape = p.shape
    ii = jax.lax.broadcasted_iota(jnp.int32, shape, 0)
    jj = jax.lax.broadcasted_iota(jnp.int32, shape, 1)
    inv_c = 1.0 / stencil9_diagonal(st)

    def quarter(p, color_mask):
        off = apply9(p, st) - st.c * p  # off-diagonal contribution
        p_new = (b - off) * inv_c
        return jnp.where(color_mask, p + omega * (p_new - p), p)

    for a in range(2):
        for bpar in range(2):
            p = quarter(p, (ii % 2 == a) & (jj % 2 == bpar))
    return p


def jacobi9_sweep(p, b, st: Stencil9, omega: float = 0.8):
    r = b - apply9(p, st)
    return p + omega * r / stencil9_diagonal(st)
