"""Matrix-free Krylov pressure solvers: CG, preconditioned CG, BiCGSTAB,
and GMG-preconditioned CG.

JAX rebuild of the reference Krylov paths — SciPy ``cg``/``bicgstab``
on explicit CSR or LinearOperators, optionally preconditioned by SuperLU ILU,
PyAMG, or geometric-multigrid cycles (``matrix_BiCGSTAB.py``,
``matrix_free_BiCGSTAB.py``, ``preconditioned_cg_solver.py``,
``geo_multigrid_cg.py``).  Here every solver is a ``lax.while_loop`` whose
body is fused stencil matvecs and whole-grid reductions; on a sharded mesh
the reductions become ``psum`` collectives for free (they are ``jnp.sum`` /
``jnp.vdot`` over the sharded field).

Gauge handling: these run on the *consistent/symmetric* (singular, SPD on
the range) operator without pinning; the Krylov iterates stay in the
zero-mean complement automatically when b is compatible, and the returned
correction is mean-normalized.  (The reference pins row (0,0) instead, which
breaks symmetry — SURVEY §7 "gauge pinning" risk item; mean projection is
the alternative the reference itself mentions at ``simpler.py:31``.)

ILU preconditioning (SuperLU, inherently sequential triangular solves) is
replaced by Jacobi or multigrid preconditioning — the reference's own
top-tier configuration is GMG-preconditioned CG (``geo_multigrid_cg.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp

from ..ops.poisson import PoissonCoeffs, apply_poisson, poisson_diagonal
from .multigrid import MultigridConfig, build_levels, make_preconditioner
from .pressure import PressureSolveInfo

# Every contraction here is pinned to full float32 precision: on the GPU an
# unpinned float32 dot may run in TF32 (~3 decimal digits), which these
# recurrences do not survive.
_HI = jax.lax.Precision.HIGHEST


def _vdot(a, b):
    return jnp.vdot(a, b, precision=_HI)


@dataclasses.dataclass(frozen=True)
class CGPressureConfig:
    """(Preconditioned) conjugate gradients (reference
    ``preconditioned_cg_solver.py`` with the AMG preconditioner swapped for
    Jacobi/none; use :class:`MGCGPressureConfig` for the multigrid one)."""

    tolerance: float = 1e-7
    max_iterations: int = 2000
    preconditioner: str = "jacobi"  # 'none' | 'jacobi'
    kind: str = "cg"


@dataclasses.dataclass(frozen=True)
class BiCGSTABPressureConfig:
    """Matrix-free BiCGSTAB (reference ``matrix_free_BiCGSTAB.py``)."""

    tolerance: float = 1e-7
    max_iterations: int = 2000
    preconditioner: str = "jacobi"  # 'none' | 'jacobi'
    kind: str = "bicgstab"


@dataclasses.dataclass(frozen=True)
class GMRESPressureConfig:
    """Matrix-free restarted GMRES(m) (reference exposes GMRES through
    SciPy — ``BiCGSTAB_solver.py:317-390`` — and as a PETSc KSP type,
    ``matrix_momentum_solver.py:372-591``; here it is one fused
    ``lax.while_loop`` of Arnoldi cycles with psum-safe dot products)."""

    tolerance: float = 1e-7
    max_iterations: int = 2000  # total Arnoldi steps across restarts
    restart: int = 20
    preconditioner: str = "jacobi"  # 'none' | 'jacobi'
    kind: str = "gmres"


@dataclasses.dataclass(frozen=True)
class MGCGPressureConfig:
    """GMG-preconditioned CG — the reference's north-star pressure path
    (``geo_multigrid_cg.py:73-203``): M = ``mg_cycles`` multigrid cycles."""

    tolerance: float = 1e-7
    max_iterations: int = 200
    mg_cycles: int = 1
    mg: MultigridConfig = MultigridConfig(pre_smoothing=2, post_smoothing=2)
    kind: str = "mgcg"


def _zero_mean(x):
    return x - jnp.mean(x)


def _pcg(b, A, M, x0, tol, maxiter):
    """Flexible preconditioned CG (Polak–Ribière beta) — tolerant of the
    mildly nonsymmetric multigrid preconditioner."""
    b = _zero_mean(b)
    x = _zero_mean(x0)
    r = b - A(x)
    z = M(r)
    p = z
    rz = _vdot(r, z)
    bnorm = jnp.linalg.norm(b)
    tol_abs = tol * jnp.where(bnorm > 0, bnorm, 1.0)

    eps = jnp.asarray(jnp.finfo(b.dtype).tiny * 1e6, b.dtype)

    def cond(carry):
        x, r, z, p, rz, k, ok = carry
        return ok & (k < maxiter) & (jnp.linalg.norm(r) > tol_abs)

    def body(carry):
        x, r, z, p, rz, k, ok = carry
        Ap = A(p)
        pAp = _vdot(p, Ap)
        # breakdown guard: near-zero or negative curvature (f32 cancellation
        # on the singular system) ends the iteration instead of producing
        # a huge step
        good = pAp > eps * _vdot(p, p)
        alpha = jnp.where(good, rz / jnp.where(pAp == 0, 1.0, pAp), 0.0)
        x = x + alpha * p
        r_new = r - alpha * Ap
        z_new = M(r_new)
        rz_new = _vdot(r_new, z_new)
        # Polak–Ribière (flexible) beta
        beta = jnp.where(
            jnp.abs(rz) > eps, _vdot(r_new - r, z_new) / rz, 0.0
        )
        p = z_new + beta * p
        return (x, r_new, z_new, p, rz_new, k + 1, good)

    x, r, _, _, _, k, _ = jax.lax.while_loop(
        cond, body, (x, r, z, p, rz, jnp.asarray(0, jnp.int32), jnp.asarray(True))
    )
    return x, r, k


def _bicgstab(b, A, M, x0, tol, maxiter):
    b = _zero_mean(b)
    x = _zero_mean(x0)
    r = b - A(x)
    rhat = r
    rho = alpha = omega = jnp.asarray(1.0, b.dtype)
    v = p = jnp.zeros_like(b)
    bnorm = jnp.linalg.norm(b)
    tol_abs = tol * jnp.where(bnorm > 0, bnorm, 1.0)

    eps = jnp.asarray(jnp.finfo(b.dtype).tiny * 1e6, b.dtype)

    def cond(carry):
        x, r, rho, alpha, omega, v, p, k, ok = carry
        return ok & (k < maxiter) & (jnp.linalg.norm(r) > tol_abs)

    def body(carry):
        x, r, rho, alpha, omega, v, p, k, ok = carry
        rho_new = _vdot(rhat, r)
        good = (jnp.abs(rho) > eps) & (jnp.abs(omega) > eps)
        beta = jnp.where(good, (rho_new / jnp.where(rho == 0, 1.0, rho))
                         * (alpha / jnp.where(omega == 0, 1.0, omega)), 0.0)
        p = r + beta * (p - omega * v)
        ph = M(p)
        v = A(ph)
        denom = _vdot(rhat, v)
        good = good & (jnp.abs(denom) > eps)
        alpha = jnp.where(good, rho_new / jnp.where(denom == 0, 1.0, denom), 0.0)
        s = r - alpha * v
        sh = M(s)
        t = A(sh)
        tt = _vdot(t, t)
        omega_new = jnp.where(
            tt > eps, _vdot(t, s) / jnp.where(tt == 0, 1.0, tt), 0.0)
        x = x + alpha * ph + omega_new * sh
        r = s - omega_new * t
        return (x, r, rho_new, alpha, omega_new, v, p, k + 1, good)

    carry = (x, r, rho, alpha, omega, v, p, jnp.asarray(0, jnp.int32),
             jnp.asarray(True))
    x, r, *_, k, _ = jax.lax.while_loop(cond, body, carry)
    return x, r, k


def gmres_solve(b, A, M, x0, tol, maxiter, restart):
    """Restarted GMRES(m) with right preconditioning: solves A x = b via the
    Krylov space of A∘M, x = M(z).  One ``lax.while_loop`` over restart
    cycles; each cycle runs the full m Arnoldi steps (modified Gram-Schmidt,
    statically shaped basis) and solves the (m+1)×m least-squares problem by
    SVD (``jnp.linalg.lstsq``).  Normal equations (HᵀH) were used through
    round 3 and are fine when the preconditioned operator is easy (the MG/
    Jacobi pressure and momentum uses, a handful of Arnoldi steps); they
    SQUARE the condition number, which in f32 on the hard Newton saddle-point
    systems (``algorithms/newton.py``: H genuinely ill-conditioned near
    stagnation) returned meaningless y and stalled the whole outer Newton
    iteration at 255², fixed by this lstsq.
    On happy breakdown (h_{j+1,j} ≈ 0) the next basis vector is zeroed so
    trailing columns carry no junk; the SVD cutoff handles the resulting
    rank deficiency exactly.

    All reductions are ``_vdot``/``jnp.linalg.norm`` over the field, so on
    a sharded mesh they lower to psum collectives.  Returns ``(x, r, k)``
    with k = total Arnoldi steps taken (multiples of m).
    """
    dtype = x0.dtype
    m = restart
    AM = lambda y: A(M(y))
    bnorm = jnp.linalg.norm(b)
    tol_abs = tol * jnp.where(bnorm > 0, bnorm, 1.0)
    tiny = jnp.asarray(jnp.finfo(dtype).tiny * 1e6, dtype)

    def cycle(x, r):
        beta = jnp.linalg.norm(r)
        safe_beta = jnp.maximum(beta, tiny)
        V = jnp.zeros((m + 1,) + x.shape, dtype).at[0].set(r / safe_beta)
        H = jnp.zeros((m + 1, m), dtype)

        def arnoldi(j, carry):
            V, H = carry
            w = AM(V[j])

            def mgs(i, acc):
                w, hcol = acc
                hij = _vdot(V[i], w) * (i <= j)
                return (w - hij * V[i], hcol.at[i].set(hij))

            w, hcol = jax.lax.fori_loop(0, m, mgs, (w, jnp.zeros(m + 1, dtype)))
            hn = jnp.linalg.norm(w)
            hcol = hcol.at[j + 1].set(hn)
            # happy breakdown: a ~zero continuation means the Krylov space is
            # exhausted — zero the basis vector (and so every later column)
            # instead of normalizing noise into the basis
            breakdown = hn <= jnp.asarray(
                jnp.finfo(dtype).eps, dtype) * 100 * safe_beta
            V = V.at[j + 1].set(
                jnp.where(breakdown, 0.0, w / jnp.maximum(hn, tiny)))
            return (V, H.at[:, j].set(hcol))

        V, H = jax.lax.fori_loop(0, m, arnoldi, (V, H))
        # min_y || beta e1 - H y ||: SVD least squares (rank-robust in f32)
        e1 = jnp.zeros(m + 1, dtype).at[0].set(beta)
        y, _, _, _ = jnp.linalg.lstsq(H, e1)
        dx = M(jnp.tensordot(y, V[:m], axes=1, precision=_HI))
        x = x + dx
        return x, b - A(x)

    def cond(carry):
        x, r, k = carry
        return (k < maxiter) & (jnp.linalg.norm(r) > tol_abs)

    def body(carry):
        x, r, k = carry
        x, r = cycle(x, r)
        return (x, r, k + m)

    x = x0
    r = b - A(x)
    x, r, k = jax.lax.while_loop(cond, body, (x, r, jnp.asarray(0, jnp.int32)))
    return x, r, k


def _jacobi_M(c: PoissonCoeffs):
    inv_d = 1.0 / poisson_diagonal(c, pinned=False)
    return lambda r: r * inv_d


def solve_pressure_krylov(
    b, c: PoissonCoeffs, p0, cfg, *, d_u=None, d_v=None, dx=None, dy=None,
    rho=None, variant="consistent",
) -> Tuple[jax.Array, PressureSolveInfo]:
    """Krylov dispatch with the same contract as ``solve_pressure``.

    For ``mgcg`` the d-fields and grid spacing must be supplied so the
    multigrid hierarchy can be built.
    """
    A = lambda x: apply_poisson(x, c, pinned=False)
    if cfg.kind == "mgcg":
        levels = build_levels(d_u, d_v, cfg.mg, dx=dx, dy=dy, rho=rho, variant=variant)
        M = make_preconditioner(levels, cfg.mg, cfg.mg_cycles)
        x, r, k = _pcg(b, A, M, p0, cfg.tolerance, cfg.max_iterations)
    else:
        if cfg.preconditioner == "jacobi":
            M = _jacobi_M(c)
        elif cfg.preconditioner == "none":
            M = lambda r: r
        else:
            raise ValueError(f"Unknown preconditioner: {cfg.preconditioner}")
        if cfg.kind == "cg":
            x, r, k = _pcg(b, A, M, p0, cfg.tolerance, cfg.max_iterations)
        elif cfg.kind == "bicgstab":
            x, r, k = _bicgstab(b, A, M, p0, cfg.tolerance, cfg.max_iterations)
        elif cfg.kind == "gmres":
            x, r, k = gmres_solve(_zero_mean(b), A, M, _zero_mean(p0),
                                  cfg.tolerance, cfg.max_iterations, cfg.restart)
        else:
            raise ValueError(f"Unknown Krylov pressure solver: {cfg.kind}")

    x = _zero_mean(x)
    bnorm = jnp.linalg.norm(b)
    rel = jnp.linalg.norm(r) / jnp.where(bnorm > 0, bnorm, 1.0)
    return x, PressureSolveInfo(iterations=k, residual_field=r, rel_residual=rel)
