"""Pressure-correction solvers (matrix-free, fully jit-compiled).

JAX rebuild of the reference pressure-solver zoo
(``naviflow_oo/solver/pressure_solver/``).  Every solver here is a
``lax.while_loop`` over fused whole-grid stencil ops — the matrix-free
equivalent of the reference's SciPy/PyAMG/PETSc (C/C++) inner loops.

Common contract (reference ``base_pressure_solver.PressureSolver.solve``,
:85-108): given the RHS (continuity defect) and the Poisson coefficients
built from d_u/d_v, return the pressure correction plus residual info.
Inner convergence is on ``||b - Ap|| / ||b|| < tol`` exactly as in the
reference (``jacobi.py:185-200``, ``gauss_seidel.py:168-186``), and the
gauge is pinned at cell (0,0).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp

from ..ops.poisson import PoissonCoeffs, apply_poisson, poisson_diagonal
from ..ops.stencil import shift_e, shift_n, shift_s, shift_w, where_set


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PressureSolveInfo:
    """Residual info returned by every pressure solve."""

    iterations: jax.Array  # int32 inner-iteration count
    residual_field: jax.Array  # b - A p (full grid)
    rel_residual: jax.Array  # ||b - Ap|| / ||b|| at exit


@dataclasses.dataclass(frozen=True)
class JacobiPressureConfig:
    """Weighted Jacobi: p += omega * D^-1 (b - Ap) (reference ``jacobi.py``)."""

    tolerance: float = 1e-5
    max_iterations: int = 10000
    omega: float = 0.8
    check_every: int = 1
    kind: str = "jacobi"


@dataclasses.dataclass(frozen=True)
class DirectPressureConfig:
    """Dense direct solve — exact reference for small grids (reference
    ``direct.py``'s SuperLU ``spsolve`` becomes an on-device
    ``jnp.linalg.solve``; O(n^3), intended for <= ~64^2 grids and the
    multigrid coarsest level)."""

    kind: str = "direct"


@dataclasses.dataclass(frozen=True)
class RBGSPressureConfig:
    """Red-black Gauss-Seidel with SOR (reference ``gauss_seidel.py``
    ``method_type='red_black'``; the sequential 'standard'/'symmetric'
    variants have no parallel analog — red-black is the parallel substitute
    the reference itself prefers, ``GS_vcycle.py:53``)."""

    tolerance: float = 1e-5
    max_iterations: int = 10000
    omega: float = 1.5
    check_every: int = 1
    kind: str = "rbgs"


def rbgs_sweep(p, b, c: PoissonCoeffs, omega: float, *, pin: bool = True):
    """One red-black SOR sweep (reference ``_rb_gauss_seidel_step``,
    ``gauss_seidel.py:268-305``), as two masked whole-grid half-updates."""
    shape = p.shape
    ii = jax.lax.broadcasted_iota(jnp.int32, shape, 0)
    jj = jax.lax.broadcasted_iota(jnp.int32, shape, 1)
    red = (ii + jj) % 2 == 0
    if pin:
        red = where_set(red, False, rows=0, cols=0)
    black = jnp.logical_not(red)
    if pin:
        black = where_set(black, False, rows=0, cols=0)
    inv_ap = 1.0 / poisson_diagonal(c, pinned=pin)

    def half(p, color):
        nbsum = (
            c.a_e * shift_e(p)
            + c.a_w * shift_w(p)
            + c.a_n * shift_n(p)
            + c.a_s * shift_s(p)
        )
        p_new = (b + nbsum) * inv_ap
        return jnp.where(color, p + omega * (p_new - p), p)

    p = half(p, red)
    p = half(p, black)
    if pin:
        p = where_set(p, 0.0, rows=0, cols=0)
    return p


def jacobi_sweep(p, b, c: PoissonCoeffs, omega: float, *, pin: bool = True):
    """p_new = p + omega * D^-1 (b - Ap) (reference ``jacobi.py:170-178``)."""
    diag = poisson_diagonal(c, pinned=pin)
    r = b - apply_poisson(p, c, pinned=pin)
    p_new = p + omega * r / diag
    if pin:
        p_new = where_set(p_new, 0.0, rows=0, cols=0)
    return p_new


def _iterate(p0, b, c: PoissonCoeffs, sweep_fn, tol, max_iter, check_every, pin):
    """Generic sweep-until-converged driver: runs ``check_every`` sweeps per
    residual evaluation, stops on ||b - Ap||/||b|| < tol."""
    bnorm = jnp.linalg.norm(b)
    safe_bnorm = jnp.where(bnorm > 0, bnorm, jnp.ones_like(bnorm))
    big = jnp.asarray(jnp.inf, p0.dtype)

    def cond(carry):
        p, k, rel = carry
        return (k < max_iter) & (rel >= tol)

    def body(carry):
        p, k, _ = carry
        p = jax.lax.fori_loop(0, check_every, lambda _, q: sweep_fn(q), p)
        r = b - apply_poisson(p, c, pinned=pin)
        rel = jnp.linalg.norm(r) / safe_bnorm
        return (p, k + check_every, rel)

    p, iters, rel = jax.lax.while_loop(
        cond, body, (p0, jnp.asarray(0, jnp.int32), big)
    )
    if not pin:
        # Unpinned gauge: the operator's nullspace contains the constant mode
        # of the connected cell component; remove the mean so the returned
        # correction is gauge-normalized (nullspace projection — the
        # alternative the reference itself hints at, ``simpler.py:31``).
        p = p - jnp.mean(p)
    r = b - apply_poisson(p, c, pinned=pin)
    return p, PressureSolveInfo(iterations=iters, residual_field=r, rel_residual=rel)


def pres_correct(b, c: PoissonCoeffs, p_star, cfg, *, alpha_p: float = 0.3,
                 pin: bool = False):
    """Legacy convenience: solve for p', apply relaxed update, fix gauge
    (reference ``helpers/pressure_corrections.pres_correct``)."""
    p_prime, info = solve_pressure(b, c, jnp.zeros_like(p_star), cfg, pin=pin)
    p = p_star + alpha_p * p_prime
    if pin:
        p = where_set(p, 0.0, rows=0, cols=0)
    return p, p_prime, info


def dense_poisson_matrix(c: PoissonCoeffs, *, pin: bool):
    """Assemble the dense pressure matrix with Fortran cell numbering
    k = i + j*nx (reference ``coeff_matrix.get_coeff_mat`` semantics).

    For the unpinned (singular, symmetric) variants, empty rows are floored
    to identity and a rank-one ones/n shift fixes the constant-mode gauge:
    for compatible b the solution satisfies A x = b with mean(x) ~ 0.
    """
    nx, ny = c.diag.shape
    n = nx * ny
    f = lambda x: x.T.reshape(-1)  # Fortran flatten (i fastest)
    idx = jnp.arange(n)
    diag = f(c.diag)
    if not pin:
        diag = jnp.where(jnp.abs(diag) < 1e-15, jnp.ones_like(diag), diag)
    A = jnp.zeros((n, n), c.diag.dtype)
    A = A.at[idx, idx].set(diag)
    # a_e: (k, k+1); zero where i == nx-1 by construction, so wrap is harmless
    A = A.at[idx[:-1], idx[:-1] + 1].add(-f(c.a_e)[:-1])
    A = A.at[idx[1:], idx[1:] - 1].add(-f(c.a_w)[1:])
    A = A.at[idx[:-nx], idx[:-nx] + nx].add(-f(c.a_n)[:-nx])
    A = A.at[idx[nx:], idx[nx:] - nx].add(-f(c.a_s)[nx:])
    if pin:
        A = A.at[0, :].set(0.0).at[0, 0].set(1.0)
    else:
        A = A + jnp.ones_like(A) / n
    return A


def solve_pressure_direct(b, c: PoissonCoeffs, *, pin: bool = False):
    """Exact dense solve (reference ``DirectPressureSolver``)."""
    nx, ny = b.shape
    A = dense_poisson_matrix(c, pin=pin)
    b_flat = b.T.reshape(-1)
    x = jnp.linalg.solve(A, b_flat)
    p = x.reshape(ny, nx).T
    if not pin:
        p = p - jnp.mean(p)
    r = b - apply_poisson(p, c, pinned=pin)
    bnorm = jnp.linalg.norm(b)
    rel = jnp.linalg.norm(r) / jnp.where(bnorm > 0, bnorm, 1.0)
    return p, PressureSolveInfo(
        iterations=jnp.asarray(1, jnp.int32), residual_field=r, rel_residual=rel
    )


def solve_pressure(
    b, c: PoissonCoeffs, p0, cfg, *, pin: bool = False
) -> Tuple[jax.Array, PressureSolveInfo]:
    """Dispatch on the (static) solver config.

    ``pin``: fix the gauge by the (0,0) identity row (reference parity; use
    with ``variant='reference'`` coefficients where cell (0,0) is referenced
    by its neighbors).  With the consistent/symmetric operators, cell (0,0)
    can be disconnected, so the gauge is fixed by mean-removal instead.
    """
    if cfg.kind == "direct":
        return solve_pressure_direct(b, c, pin=pin)
    if cfg.kind == "jacobi":
        sweep = lambda p: jacobi_sweep(p, b, c, cfg.omega, pin=pin)
    elif cfg.kind == "rbgs":
        sweep = lambda p: rbgs_sweep(p, b, c, cfg.omega, pin=pin)
    else:
        raise ValueError(f"Unknown pressure solver kind: {cfg.kind}")
    if pin:
        p0 = where_set(p0, 0.0, rows=0, cols=0)
    return _iterate(
        p0, b, c, sweep, cfg.tolerance, cfg.max_iterations, cfg.check_every, pin
    )
