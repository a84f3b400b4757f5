"""Multigrid transfer operators (restriction / prolongation / coefficient
restriction) as static-slice jnp kernels.

JAX rebuild of ``naviflow_oo/solver/pressure_solver/helpers/
multigrid_helpers.py``.  Grid convention: levels are ``2**k - 1`` cells per
axis; coarse cell (I, J) coincides with fine cell (2I+1, 2J+1), so
``nc = (nf - 1) // 2``.

Semantics preserved:
* injection restriction ``fine[1::2, 1::2]`` (reference :8-21);
* full-weighting restriction with weights 1/4 (center), 1/8 (edges),
  1/16 (corners) *times four* — i.e. the h^2-scaled variant (reference
  :23-70, Remark 2.7.5 scaling baked into the weights);
* bilinear prolongation with coincident-point injection and boundary slabs
  copied from the first interior line (reference :73-192);
* harmonic-mean d-coefficient restriction with the 0.25 Poisson rescale and
  boundary injection (reference :196-329).

Array form: every transfer here is a separable tensor product of 1-D
operators, applied as an axis-0 strided op plus a transpose sandwich for
axis 1, so no transfer lowers to a minor-axis strided slice or a
``.at[::2].set`` scatter.  Boundary-slab copying folds into the 1-D
operators (first / last fine row equals the adjacent interior row, which is
exactly the coarse endpoint), so results match the reference construction.
"""

from __future__ import annotations

import jax.numpy as jnp


def coarse_size(nf: int) -> int:
    return (nf - 1) // 2


def _interleave_ax0(a, b):
    """Rows a[0], b[0], a[1], b[1], ... (axis-0 interleave only)."""
    return jnp.stack([a, b], axis=1).reshape(2 * a.shape[0], a.shape[1])


def restrict_inject(fine):
    """Injection at odd indices (reference :8-21)."""
    t = fine[1::2]
    return (t.T[1::2]).T


def _fw_ax0(y):
    """(nf, n) -> (nc, n) full-weighting rows: 1/4 y[2I] + 1/2 y[2I+1] +
    1/4 y[2I+2]."""
    return 0.25 * y[0:-2:2] + 0.5 * y[1::2] + 0.25 * y[2::2]


def restrict_full_weighting(fine):
    """h^2-scaled full-weighting restriction (reference :23-70): tensor
    product of per-axis (1/4, 1/2, 1/4) stencils — center 1/4, edges 1/8,
    corners 1/16, identical weights to the reference's 2-D form."""
    return _fw_ax0(_fw_ax0(fine).T).T


def _linear_ax0(c):
    """(nc, n) -> (2nc+1, n) vertex bilinear rows: fine row 2I+1 = c[I],
    row 2I+2 = midpoint, rows 0 / nf-1 = boundary copies of the adjacent
    interior row (= c[0] / c[-1])."""
    mid = 0.5 * (c[:-1] + c[1:])
    midext = jnp.concatenate([mid, c[-1:]], 0)
    return jnp.concatenate([c[:1], _interleave_ax0(c, midext)], 0)


def prolong_linear(coarse, mx: int, my: int):
    """Bilinear prolongation to an (mx, my) fine grid (reference :73-192):
    injection at (2I+1, 2J+1), edge/face averages between, boundary slabs
    copied from the first interior line, corners from the diagonal."""
    del mx, my  # implied by the coarse shape: nf = 2 nc + 1
    return _linear_ax0(_linear_ax0(coarse).T).T


def _cubic_midpoints(c):
    """Midpoint values between consecutive entries along axis 0: 4-point
    cubic (Catmull-Rom at t=1/2) weights (-1, 9, 9, -1)/16 in the
    interior, linear average in the first/last interval."""
    lin = 0.5 * (c[:-1] + c[1:])
    if c.shape[0] >= 4:
        cub = (-c[:-3] + 9.0 * c[1:-2] + 9.0 * c[2:-1] - c[3:]) / 16.0
        return jnp.concatenate([lin[:1], cub, lin[-1:]], 0)
    return lin


def _cubic_ax0(c):
    """(nc, n) -> (2nc+1, n) cubic rows, same layout as :func:`_linear_ax0`
    with Catmull-Rom midpoints."""
    midext = jnp.concatenate([_cubic_midpoints(c), c[-1:]], 0)
    return jnp.concatenate([c[:1], _interleave_ax0(c, midext)], 0)


def prolong_cubic(coarse, mx: int, my: int):
    """Cubic prolongation to an (mx, my) fine grid — the counterpart of
    the reference's cubic-spline interpolation option
    (``multigrid_helpers.py:333-391``, scipy spline).  Deviation,
    documented: a *local* tensor-product cubic (Catmull-Rom midpoint
    stencil) rather than a global spline — same O(h^4) interior accuracy,
    compiler-friendly strided slices instead of a host-side solve.
    Boundary slabs are copied from the first interior line exactly as
    ``prolong_linear`` does.

    Only valid as a correction prolongation with
    ``coarsening='rediscretize'`` (the reference's pairing): its 4-wide
    column support breaks the 3-strided comb recovery of the Galerkin RAP
    (``ops/stencil9.galerkin_coarsen``).
    """
    del mx, my  # implied by the coarse shape: nf = 2 nc + 1
    return _cubic_ax0(_cubic_ax0(coarse).T).T


def _harmonic_pair(d1, d2):
    """Harmonic mean where both positive, else arithmetic (reference :253-260)."""
    both = (d1 > 0) & (d2 > 0)
    harm = 2.0 / (1.0 / jnp.where(both, d1, 1.0) + 1.0 / jnp.where(both, d2, 1.0))
    return jnp.where(both, harm, 0.5 * (d1 + d2))


def restrict_d_coefficients(d_u, d_v):
    """Harmonic-mean restriction of the momentum d-fields with the 0.25
    Poisson rescale (reference ``restrict_coefficients``, :196-329).

    d_u_coarse[I, J] pairs fine faces (2I, 2J) and (2I+1, 2J); boundary
    faces are injected.  Output shapes: ((nxc+1, nyc), (nxc, nyc+1)).
    """
    nxf = d_u.shape[0] - 1
    nyf = d_v.shape[1] - 1
    nxc, nyc = coarse_size(nxf), coarse_size(nyf)
    dtype = d_u.dtype

    # --- d_u: interior coarse faces I = 1..nxc-1, all coarse cells J ---
    d1 = d_u[2 : nxf - 1 : 2, 0 : nyf - 1 : 2]  # rows 2I, cols 2J
    d2 = d_u[3:nxf:2, 0 : nyf - 1 : 2]  # rows 2I+1
    du_int = _harmonic_pair(d1, d2)  # (nxc-1, nyc)
    du_c = jnp.zeros((nxc + 1, nyc), dtype)
    du_c = du_c.at[1:nxc, :].set(du_int)
    du_c = du_c.at[0, :].set(d_u[0, 0 : nyf - 1 : 2])
    du_c = du_c.at[nxc, :].set(d_u[nxf, 0 : nyf - 1 : 2])

    # --- d_v: interior coarse faces J = 1..nyc-1, all coarse cells I ---
    e1 = d_v[0 : nxf - 1 : 2, 2 : nyf - 1 : 2]
    e2 = d_v[0 : nxf - 1 : 2, 3:nyf:2]
    dv_int = _harmonic_pair(e1, e2)  # (nxc, nyc-1)
    dv_c = jnp.zeros((nxc, nyc + 1), dtype)
    dv_c = dv_c.at[:, 1:nyc].set(dv_int)
    dv_c = dv_c.at[:, 0].set(d_v[0 : nxf - 1 : 2, 0])
    dv_c = dv_c.at[:, nyc].set(d_v[0 : nxf - 1 : 2, nyf])

    return 0.25 * du_c, 0.25 * dv_c
