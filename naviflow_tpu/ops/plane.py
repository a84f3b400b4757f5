"""Color-plane (checkerboard) layout for red-black smoothing.

The masked red-black update wastes half its arithmetic and half its
bytes — each half-sweep evaluates the stencil at EVERY cell and selects
one color.  Splitting the field into its red ((i+j) even) and
black planes of shape (nx, ny/2) makes each half-sweep touch exactly the
cells it updates: 2x less arithmetic and no color mask.

Layout (j = lane dimension; parity of j within a row alternates with the
row, so the planes are rectangular):

    R[i, jc] = p[i, 2*jc + (i % 2)]        (red:   i + j even)
    B[i, jc] = p[i, 2*jc + 1 - (i % 2)]    (black: i + j odd)

Neighbor map (derived in closed form; verified by the tests):

    red (i, jc):  e -> B[i+1, jc]   w -> B[i-1, jc]      (row rolls)
                  n -> B[i, jc + (i%2)]                  (column roll at odd
                  s -> B[i, jc + (i%2) - 1]               rows, selected
    black (i,jc): e -> R[i+1, jc]   w -> R[i-1, jc]       by row parity)
                  n -> R[i, jc + 1 - (i%2)]
                  s -> R[i, jc - (i%2)]

Everything here is value-level jnp (row/column rolls + row-parity selects +
trailing-dim reshapes), usable on any backend.  Cell-centered restriction
and prolongation are also plane-friendly (row-pair sums / parity-selected
column mixes), so the plane layout can persist across an entire fine-level
down/up pass.

Boundary exactness: out-of-range rolls wrap, and the wrapped
contributions are annihilated by the zero boundary links of the stencil
planes — the same convention as the roll-based full-array kernels.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _inv_diag(S):
    c = S[0]
    safe = jnp.where(jnp.abs(c) < 1e-15, jnp.ones_like(c), c)
    return 1.0 / safe


def _row_parity(m, n, dtype=jnp.bool_):
    ii = jax.lax.broadcasted_iota(jnp.int32, (m, n), 0)
    return (ii % 2) == 1  # True on ODD rows


def split_planes(x):
    """(m, n) -> (red, black) planes of shape (m, n // 2)."""
    m, n = x.shape
    xr = x.reshape(m, n // 2, 2)
    odd = _row_parity(m, n // 2)
    red = jnp.where(odd, xr[:, :, 1], xr[:, :, 0])
    black = jnp.where(odd, xr[:, :, 0], xr[:, :, 1])
    return red, black


def merge_planes(red, black):
    """Inverse of :func:`split_planes`."""
    m, nc = red.shape
    odd = _row_parity(m, nc)
    lane0 = jnp.where(odd, black, red)
    lane1 = jnp.where(odd, red, black)
    return jnp.stack([lane0, lane1], axis=2).reshape(m, 2 * nc)


def _roll(x, shift, axis):
    return jnp.roll(x, shift, axis)


def plane_neighbors(other, odd):
    """The four 5-point neighbors of one color's cells, read from the
    OTHER color's plane.  Returns (e, w, n, s) planes."""
    e = _roll(other, -1, 0)
    w = _roll(other, 1, 0)
    n = jnp.where(odd, _roll(other, -1, 1), other)
    s = jnp.where(odd, other, _roll(other, 1, 1))
    return e, w, n, s


def plane_neighbors_black(other, odd):
    """Neighbors of BLACK cells read from the red plane (mirrored lane
    offsets)."""
    e = _roll(other, -1, 0)
    w = _roll(other, 1, 0)
    n = jnp.where(odd, other, _roll(other, -1, 1))
    s = jnp.where(odd, _roll(other, 1, 1), other)
    return e, w, n, s


class PlaneStencil5:
    """5-point stencil + rhs in plane layout, split ONCE (the
    amortization that makes the layout pay).  Holds both the
    diagonal-normalized form for sweeps (``p_new = bh - sum(link_hat *
    neighbor)``) and the raw planes for residuals."""

    def __init__(self, st, b):
        S = (st.c, st.e, st.w, st.n, st.s)
        invc = _inv_diag(S)
        self.c = split_planes(st.c)
        self.e = split_planes(st.e)
        self.w = split_planes(st.w)
        self.n = split_planes(st.n)
        self.s = split_planes(st.s)
        self.b = split_planes(b)
        self.bh = split_planes(b * invc)
        self.eh = split_planes(st.e * invc)
        self.wh = split_planes(st.w * invc)
        self.nh = split_planes(st.n * invc)
        self.sh = split_planes(st.s * invc)


def plane_rb_sweep(R, B, ps: PlaneStencil5):
    """One red-black Gauss-Seidel sweep entirely in plane space —
    numerically the (diagonal-normalized re-association of the) standard
    ``_rb2_sweep`` with omega=1."""
    m, nc = R.shape
    odd = _row_parity(m, nc)
    e, w, n, s = plane_neighbors(B, odd)
    R = ps.bh[0] - (ps.eh[0] * e + ps.wh[0] * w + ps.nh[0] * n
                    + ps.sh[0] * s)
    e, w, n, s = plane_neighbors_black(R, odd)
    B = ps.bh[1] - (ps.eh[1] * e + ps.wh[1] * w + ps.nh[1] * n
                    + ps.sh[1] * s)
    return R, B


def plane_residual(R, B, ps: PlaneStencil5):
    """r = b - A p in plane space (raw, un-normalized planes — split once
    in :class:`PlaneStencil5`)."""
    m, nc = R.shape
    odd = _row_parity(m, nc)
    e, w, n, s = plane_neighbors(B, odd)
    rR = ps.b[0] - (ps.c[0] * R + ps.e[0] * e + ps.w[0] * w
                    + ps.n[0] * n + ps.s[0] * s)
    e, w, n, s = plane_neighbors_black(R, odd)
    rB = ps.b[1] - (ps.c[1] * B + ps.e[1] * e + ps.w[1] * w
                    + ps.n[1] * n + ps.s[1] * s)
    return rR, rB


def plane_restrict_cc(rR, rB):
    """Cell-centered 2x2-mean restriction directly from planes to the
    STANDARD coarse layout: coarse[I, J] = mean of fine rows 2I, 2I+1 at
    column J of both planes (row-pair sums only — no column ops)."""
    s = rR + rB
    return 0.5 * (s[0::2] + s[1::2]) * 0.5


def plane_prolong_cc(ec):
    """Clamped bilinear cell-centered prolongation from the STANDARD
    coarse layout directly into correction planes (row prolongation first;
    the column mix is selected by row parity, since a fine
    cell's column parity within its row equals the row parity for red
    and its complement for black)."""
    from .transfer_cc import _prolong_ax0

    t = _prolong_ax0(ec)  # (2*nxc, nyc): rows prolonged, columns coarse
    up = jnp.concatenate([t[:, :1], t[:, :-1]], 1)   # ec[:, J-1] clamped
    dn = jnp.concatenate([t[:, 1:], t[:, -1:]], 1)   # ec[:, J+1] clamped
    even_col = 0.75 * t + 0.25 * up   # fine column 2J
    odd_col = 0.75 * t + 0.25 * dn    # fine column 2J+1
    m, nc = t.shape
    odd = _row_parity(m, nc)
    ef_R = jnp.where(odd, odd_col, even_col)
    ef_B = jnp.where(odd, even_col, odd_col)
    return ef_R, ef_B


# ---------------------------------------------------------------------------
# Plane-resident fine-level V-cycle pieces (XLA value-level).
#
# The point of the layout is AMORTIZATION: the splits (b + the five stencil
# arrays) happen once per solve, the merge once, and every smoothing
# half-sweep in between touches half-size arrays with no color-masked waste
# — halving both the streamed bytes and the arithmetic of the dominant
# fine-level work.  These helpers keep (R, B) as the fine-level state so
# the solve's while_loop never materializes the interleaved p.
# ---------------------------------------------------------------------------


def plane_fine_down(R, B, ps: PlaneStencil5, n_pre: int):
    """Pre-smooth + residual + cc-restriction with a plane-resident fine
    level.  Returns (R, B, r_coarse) — r_coarse in STANDARD layout."""
    for _ in range(n_pre):
        R, B = plane_rb_sweep(R, B, ps)
    rR, rB = plane_residual(R, B, ps)
    return R, B, plane_restrict_cc(rR, rB)


def plane_fine_up(R, B, ps: PlaneStencil5, ec, n_post: int):
    """Prolongated coarse correction + post-smoothing, plane-resident."""
    efR, efB = plane_prolong_cc(ec)
    R, B = R + efR, B + efB
    for _ in range(n_post):
        R, B = plane_rb_sweep(R, B, ps)
    return R, B


def plane_residual_norm(R, B, ps: PlaneStencil5):
    """||b - A p|| without merging the planes."""
    rR, rB = plane_residual(R, B, ps)
    return jnp.sqrt(jnp.sum(rR * rR) + jnp.sum(rB * rB))
