"""Power-law discretization of the staggered momentum equations.

Fully vectorized rebuild of Patankar's power-law scheme as
implemented by the reference
(``naviflow_oo/solver/momentum_solver/discretization/power_law.py``):

* face mass fluxes from staggered interpolation (reference :95-98, :260-263);
* ``a_face = D * A(|F/D|) + max(∓F, 0)`` with ``A(P) = max(0, 1-0.1P)^5``
  (reference :19-44);
* ``a_p = sum(a_nb) + (Fe-Fw) + (Fn-Fs)`` with the boundary-row flux
  specializations (no flow through walls, reference :112-140, :273-301);
* pressure-gradient source ``(p_W - p_P)*dy`` / ``(p_S - p_P)*dx``;
* Practice-B boundary folding: the known boundary velocity times its
  coefficient moves into the source and the link is cut (reference :144-199,
  :303-355).  Unlike the reference — which only folds sides that were
  explicitly registered with the BC manager — we fold *all four* sides
  unconditionally.  This is numerically identical whenever the boundary
  values of the iterate equal their BC values (always true here, BCs are
  re-applied each step) and makes the interior system self-contained, which
  the matrix-free solvers rely on.

The reference's per-edge Python loops become masked whole-array updates;
XLA fuses the entire assembly into one elementwise pass over the grid.
"""

from __future__ import annotations

import jax.numpy as jnp

from .stencil import StencilCoeffs, where_add, where_set


def power_law_A(F, D):
    """A(|P|) = max(0, 1 - 0.1|F/D|)^5 (reference ``power_law_function``, :19-44)."""
    base = jnp.maximum(0.0, 1.0 - 0.1 * jnp.abs(F / D))
    return jnp.where(jnp.abs(D) > 1e-10, base**5, jnp.zeros_like(base))


def u_momentum_coefficients(u, v, p, *, dx, dy, rho, mu) -> StencilCoeffs:
    """Unrelaxed u-momentum coefficients on the full (nx+1, ny) grid.

    Rows i=0 and i=nx (boundary u nodes) are all-zero: they are never solved
    — their values come from the velocity BCs.  Matches
    ``PowerLawDiscretization.calculate_u_coefficients`` with every side
    Practice-B folded.
    """
    nxp1, ny = u.shape
    nx = nxp1 - 1
    De = mu * dy / dx
    Dn = mu * dx / dy

    # Solved rows i = 1 .. nx-1 (local row r corresponds to i = r+1).
    uc = u[1:nx, :]
    Fe = 0.5 * rho * dy * (u[2 : nx + 1, :] + uc)
    Fw = 0.5 * rho * dy * (u[0 : nx - 1, :] + uc)
    # Fn[.., j] uses v[:, j+1]; Fs[.., j] uses v[:, j].  No flow through the
    # bottom (Fs=0 at j=0) or top (Fn=0 at j=ny-1) walls.
    Fn = 0.5 * rho * dx * (v[1:nx, 1:] + v[0 : nx - 1, 1:])
    Fs = 0.5 * rho * dx * (v[1:nx, :-1] + v[0 : nx - 1, :-1])
    Fn = where_set(Fn, 0.0, cols=ny - 1)
    Fs = where_set(Fs, 0.0, cols=0)

    a_e = De * power_law_A(Fe, De) + jnp.maximum(-Fe, 0.0)
    a_w = De * power_law_A(Fw, De) + jnp.maximum(Fw, 0.0)
    a_n = Dn * power_law_A(Fn, Dn) + jnp.maximum(-Fn, 0.0)
    a_s = Dn * power_law_A(Fs, Dn) + jnp.maximum(Fs, 0.0)
    # Walls carry no north/south link on their adjacent row.
    a_n = where_set(a_n, 0.0, cols=ny - 1)
    a_s = where_set(a_s, 0.0, cols=0)

    a_p = a_e + a_w + a_n + a_s + (Fe - Fw) + (Fn - Fs)
    src = (p[0 : nx - 1, :] - p[1:nx, :]) * dy

    # Practice B: fold boundary-velocity contributions into the source and
    # cut the links (local row 0 is i=1; local row nx-2 is i=nx-1).
    src = where_add(src, a_w[0, :] * u[0, :], rows=0)
    a_w = where_set(a_w, 0.0, rows=0)
    src = where_add(src, a_e[nx - 2, :] * u[nx, :], rows=nx - 2)
    a_e = where_set(a_e, 0.0, rows=nx - 2)
    src = where_add(src, a_s[:, 1] * u[1:nx, 0], cols=1)
    a_s = where_set(a_s, 0.0, cols=1)
    src = where_add(src, a_n[:, ny - 2] * u[1:nx, ny - 1], cols=ny - 2)
    a_n = where_set(a_n, 0.0, cols=ny - 2)

    pad = lambda x: jnp.pad(x, ((1, 1), (0, 0)))
    return StencilCoeffs(
        a_e=pad(a_e), a_w=pad(a_w), a_n=pad(a_n), a_s=pad(a_s), a_p=pad(a_p), src=pad(src)
    )


def v_momentum_coefficients(u, v, p, *, dx, dy, rho, mu) -> StencilCoeffs:
    """Unrelaxed v-momentum coefficients on the full (nx, ny+1) grid.

    Columns j=0 and j=ny (boundary v nodes) are all-zero.  Matches
    ``PowerLawDiscretization.calculate_v_coefficients`` with every side
    Practice-B folded.  Note the reference computes coefficients on the
    left/right columns i=0 and i=nx-1 too (wall-flux specializations,
    reference :273-301) — these feed d_v even though v there is fixed by BCs.
    """
    nx, nyp1 = v.shape
    ny = nyp1 - 1
    De = mu * dy / dx
    Dn = mu * dx / dy

    # Solved columns j = 1 .. ny-1 (local column c corresponds to j = c+1).
    Fe = 0.5 * rho * dy * (u[1 : nx + 1, 1:ny] + u[1 : nx + 1, 0 : ny - 1])
    Fw = 0.5 * rho * dy * (u[0:nx, 1:ny] + u[0:nx, 0 : ny - 1])
    Fe = where_set(Fe, 0.0, rows=nx - 1)  # no flow through the right wall
    Fw = where_set(Fw, 0.0, rows=0)  # no flow through the left wall
    Fn = 0.5 * rho * dx * (v[:, 1:ny] + v[:, 2 : ny + 1])
    Fs = 0.5 * rho * dx * (v[:, 0 : ny - 1] + v[:, 1:ny])

    a_e = De * power_law_A(Fe, De) + jnp.maximum(-Fe, 0.0)
    a_w = De * power_law_A(Fw, De) + jnp.maximum(Fw, 0.0)
    a_n = Dn * power_law_A(Fn, Dn) + jnp.maximum(-Fn, 0.0)
    a_s = Dn * power_law_A(Fs, Dn) + jnp.maximum(Fs, 0.0)
    a_e = where_set(a_e, 0.0, rows=nx - 1)
    a_w = where_set(a_w, 0.0, rows=0)

    a_p = a_e + a_w + a_n + a_s + (Fe - Fw) + (Fn - Fs)
    src = (p[:, 0 : ny - 1] - p[:, 1:ny]) * dx

    # Practice B (local column 0 is j=1; local column ny-2 is j=ny-1).
    src = where_add(src, a_s[:, 0] * v[:, 0], cols=0)
    a_s = where_set(a_s, 0.0, cols=0)
    src = where_add(src, a_n[:, ny - 2] * v[:, ny], cols=ny - 2)
    a_n = where_set(a_n, 0.0, cols=ny - 2)
    src = where_add(src, a_w[1, :] * v[0, 1:ny], rows=1)
    a_w = where_set(a_w, 0.0, rows=1)
    src = where_add(src, a_e[nx - 2, :] * v[nx - 1, 1:ny], rows=nx - 2)
    a_e = where_set(a_e, 0.0, rows=nx - 2)

    pad = lambda x: jnp.pad(x, ((0, 0), (1, 1)))
    return StencilCoeffs(
        a_e=pad(a_e), a_w=pad(a_w), a_n=pad(a_n), a_s=pad(a_s), a_p=pad(a_p), src=pad(src)
    )


def relax_coefficients(coeffs: StencilCoeffs, field, alpha: float) -> StencilCoeffs:
    """Patankar implicit under-relaxation: ``a_p/alpha``,
    ``src += (1-alpha) * (a_p/alpha) * field_old``.

    Matches ``matrix_free_momentum.py:429-430`` /
    ``base_momentum_solver.py:107-136`` (including the 1e-12 floor on a_p).
    """
    a_p_floor = jnp.where(jnp.abs(coeffs.a_p) > 1e-12, coeffs.a_p, 1e-12)
    a_p_rel = a_p_floor / alpha
    src_rel = coeffs.src + (1.0 - alpha) * a_p_rel * field
    return coeffs.replace(a_p=a_p_rel, src=src_rel)


def d_coefficient(a_p_relaxed, spacing, *, is_u: bool):
    """d = spacing / a_p_relaxed (= alpha * spacing / a_p_unrelaxed), masked to
    zero on the unsolved boundary rows/columns.

    This is the dataflow contract between momentum and pressure solvers
    (``matrix_free_momentum.py:449``, ``jacobi_solver.py:80``): the pressure
    operator consumes d_u[1:nx, :] and d_v[:, 1:ny] only, but we zero the
    unused slabs for hygiene.
    """
    d = jnp.where(jnp.abs(a_p_relaxed) > 1e-12, spacing / a_p_relaxed, 0.0)
    if is_u:
        d = where_set(where_set(d, 0.0, rows=0), 0.0, rows=d.shape[0] - 1)
    else:
        d = where_set(where_set(d, 0.0, cols=0), 0.0, cols=d.shape[1] - 1)
    return d
