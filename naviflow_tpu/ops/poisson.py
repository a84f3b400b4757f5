"""Pressure-correction Poisson operator, RHS, and divergence.

This is THE hot kernel of the framework — the JAX rebuild of the
reference's matrix-free variable-coefficient 5-point operator
(``naviflow_oo/solver/pressure_solver/helpers/matrix_free.py:6-135``) and its
explicit-matrix twin (``helpers/coeff_matrix.py:6-121``).  Semantics preserved
exactly, including two load-bearing quirks:

1. **Boundary fold** (reference ``matrix_free.py:63-84``): at each wall the
   *opposite-face* coefficient of the boundary cell is added to the diagonal
   and then zeroed (e.g. at the west wall, ``diag[0,:] += east[0,:];
   east[0,:] = 0``).  This cuts the boundary cell's off-diagonal link into the
   interior while keeping the diagonal unchanged — an asymmetric operator.
   The reference's entire solver zoo was validated against this operator, so
   we reproduce it bit-for-bit (``variant='reference'``).  A standard
   symmetric Neumann variant (``variant='symmetric'``: boundary-face
   coefficients are simply absent and off-diagonal links stay intact) is also
   provided for the CG-based solvers that want SPD(-up-to-nullspace) systems,
   and a ``variant='consistent'`` (default for the algorithms) that
   additionally masks the d-entries of faces the velocity corrector never
   updates, making the operator the *exact* Schur complement of the
   correction step: after an exact p' solve the corrected velocity is
   divergence-free in every cell.  The reference operator leaves a persistent
   boundary-cell continuity defect that floors the outer residual near 1e-3;
   the consistent variant converges to machine precision.

2. **Gauge pin** (reference ``matrix_free.py:86-97``, ``coeff_matrix.py:113-121``,
   ``rhs_construction.py:19``): row (0,0) is replaced by identity and the RHS
   entry zeroed, fixing p'(0,0)=0.

Layout note: the reference flattens in Fortran order; we keep fields 2-D
``(nx, ny)`` everywhere — no flattening, no reshapes, XLA sees one fused
stencil.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from .stencil import shift_e, shift_n, shift_s, shift_w, where_add, where_set


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PoissonCoeffs:
    """Variable coefficients of the pressure-correction operator.

    Row form: ``diag*p - a_e*p_E - a_w*p_W - a_n*p_N - a_s*p_S``; the (0,0)
    row is an identity row when ``pinned`` (handled in :func:`apply_poisson`).
    """

    a_e: jax.Array
    a_w: jax.Array
    a_n: jax.Array
    a_s: jax.Array
    diag: jax.Array


def poisson_coefficients(d_u, d_v, *, dx, dy, rho, variant: str = "reference") -> PoissonCoeffs:
    """Build the 5-point pressure-correction coefficients from the momentum
    d-fields (reference ``matrix_free.py:44-84`` / ``gauss_seidel.py:214-266``).

    a_E[i,j] = rho*d_u[i+1,j]*dy (i<nx-1),  a_W[i,j] = rho*d_u[i,j]*dy (i>0),
    a_N[i,j] = rho*d_v[i,j+1]*dx (j<ny-1),  a_S[i,j] = rho*d_v[i,j]*dx (j>0).
    """
    nxp1, _ = d_u.shape
    nx = nxp1 - 1
    ny = d_v.shape[1] - 1

    if variant == "consistent":
        # Zero the d-entries of faces the velocity corrector never touches
        # (u rows j=0, ny-1 and v columns i=0, nx-1 are boundary-adjacent BC
        # rows, skipped by ``update_velocity``).  With these masked, an exact
        # p' solve makes the corrected field divergence-free in *every* cell
        # — the reference operator (which keeps them) leaves a persistent
        # O(a*p') defect in boundary cells that floors the outer residual
        # near 1e-3 (the reference's own demonstrated tolerance regime).
        d_u = where_set(where_set(d_u, 0.0, cols=0), 0.0, cols=ny - 1)
        d_v = where_set(where_set(d_v, 0.0, rows=0), 0.0, rows=nx - 1)

    a_e = jnp.pad(rho * d_u[1:nx, :] * dy, ((0, 1), (0, 0)))
    a_w = jnp.pad(rho * d_u[1:nx, :] * dy, ((1, 0), (0, 0)))
    a_n = jnp.pad(rho * d_v[:, 1:ny] * dx, ((0, 0), (0, 1)))
    a_s = jnp.pad(rho * d_v[:, 1:ny] * dx, ((0, 0), (1, 0)))

    diag = jnp.zeros((nx, ny), d_u.dtype)
    if variant == "reference":
        # Fold the boundary cell's interior-facing coefficient into the
        # diagonal and cut the link (reference quirk, see module docstring).
        diag = where_add(diag, a_e[0, :], rows=0)
        diag = where_add(diag, a_w[nx - 1, :], rows=nx - 1)
        diag = where_add(diag, a_n[:, 0], cols=0)
        diag = where_add(diag, a_s[:, ny - 1], cols=ny - 1)
        a_e = where_set(a_e, 0.0, rows=0)
        a_w = where_set(a_w, 0.0, rows=nx - 1)
        a_n = where_set(a_n, 0.0, cols=0)
        a_s = where_set(a_s, 0.0, cols=ny - 1)
    elif variant not in ("symmetric", "consistent"):
        raise ValueError(f"Unknown poisson operator variant: {variant}")

    diag = diag + a_e + a_w + a_n + a_s
    return PoissonCoeffs(a_e=a_e, a_w=a_w, a_n=a_n, a_s=a_s, diag=diag)


def apply_poisson(p, c: PoissonCoeffs, *, pinned: bool = True):
    """Matrix-free A @ p (reference ``compute_Ap_product``, 2-D layout).

    With ``pinned``, the (0,0) row acts as identity: (Ap)[0,0] = p[0,0], and —
    matching the explicit matrix whose column (0,0) entries remain — neighbor
    reads of p[0,0] are *not* masked (the reference matrix pins the row only).
    """
    out = (
        c.diag * p
        - c.a_e * shift_e(p)
        - c.a_w * shift_w(p)
        - c.a_n * shift_n(p)
        - c.a_s * shift_s(p)
    )
    if pinned:
        out = where_set(out, p[0, 0], rows=0, cols=0)
    return out


def poisson_diagonal(c: PoissonCoeffs, *, pinned: bool = True, floor: float = 1e-15):
    """Diagonal for Jacobi-type smoothers, floored like the reference
    (``gauss_seidel.py:263-264`` sets a_P < 1e-15 to 1)."""
    d = jnp.where(c.diag < floor, jnp.ones_like(c.diag), c.diag)
    if pinned:
        d = where_set(d, 1.0, rows=0, cols=0)
    return d


def pressure_rhs(u_star, v_star, *, dx, dy, rho, pin: bool = True):
    """Continuity defect b = rho * ((u_W - u_E) dy + (v_S - v_N) dx) per cell,
    with b[0,0]=0 under the pinned gauge (reference ``rhs_construction.get_rhs``,
    :3-21; kept 2-D instead of Fortran-flattened)."""
    b = rho * (
        (u_star[:-1, :] - u_star[1:, :]) * dy + (v_star[:, :-1] - v_star[:, 1:]) * dx
    )
    if pin:
        b = where_set(b, 0.0, rows=0, cols=0)
    return b


def pressure_rhs2(u_star, v_star, *, dx, dy, rho, pin: bool = True):
    """Sign-flipped RHS variant (reference ``rhs_construction.get_rhs2``,
    :28-52 — matches the + sign velocity-correction convention; unused by
    the shipped solvers, kept for parity)."""
    return -pressure_rhs(u_star, v_star, dx=dx, dy=dy, rho=rho, pin=pin)


def divergence(u, v, *, dx, dy):
    """Cell-centered velocity divergence (reference
    ``validation/cavity_flow.py:147-175``)."""
    return (u[1:, :] - u[:-1, :]) / dx + (v[:, 1:] - v[:, :-1]) / dy


def max_interior_divergence(u, v, *, dx, dy):
    """Max |div| excluding one boundary ring (reference
    ``base_algorithm.get_max_divergence``, :134-159)."""
    div = divergence(u, v, dx=dx, dy=dy)
    return jnp.max(jnp.abs(div[1:-1, 1:-1]))
