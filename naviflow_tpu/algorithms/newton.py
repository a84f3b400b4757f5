"""Steady Newton–Krylov (JFNK) solver for the coupled momentum+continuity
system.

Capability the reference lacks entirely: its SIMPLE-family solvers never
converged ANY scheme at Re >= 7500 on 511^2
(``/root/reference/main_scripts/05 geo_multigrid/results/notConverged/511/``),
and this framework's own measured limit is the same physics — the
lid-driven cavity's steady branch loses stability near Re~8000 (Hopf
bifurcation), so the *fixed-point* SIMPLE iteration limit-cycles at
~5e-5 with the accuracy-resolving QUICK/LUDS schemes (PERF.md, "Numerics
carried over").  Newton's method has no such stability restriction: it
converges to the steady branch whether or not that branch is stable.

Formulation
-----------
Unknown w = (u, v, p) on the staggered grid.  Residual F(w):

* momentum blocks: the *unrelaxed* discrete momentum residuals
  ``src(u,v,p) - A(u,v) x`` on interior nodes (identical arithmetic to the
  convergence norms of the SIMPLE loop — ``solvers/momentum.py``
  ``_unrelaxed_residual`` — so Newton's reported norms are directly
  comparable to the outer-loop stall levels);
* continuity block: the mean-projected continuity defect
  ``pressure_rhs(u, v)`` (the p-gauge invariance F(w + c·e_p) = F(w)
  makes the all-ones pressure direction an exact Jacobian null vector;
  projecting the continuity residual's mean removes the matching left
  null vector).

Jacobian-vector products are EXACT via ``jax.linearize`` (forward-mode AD
through the full nonlinear assembly — power-law/QUICK coefficients
included), not finite differences: one linearization per Newton step,
reused across all GMRES iterations.  The linearized residual is the same
stencil arithmetic as F itself, all fused by XLA.

The linear solve is right-preconditioned restarted GMRES
(``solvers/krylov.gmres_solve`` on the flattened state) with a
SIMPLE-type block preconditioner frozen at the current Newton iterate:

  M r = [du = r_u / a_p;  dv = r_v / a_p;
         dp = MG-solve(L(d_u,d_v) dp = r_c - div(du,dv));
         du,dv -= d * grad dp]

i.e. one linearized SIMPLE iteration — diagonal momentum solve plus one
multigrid pressure-projection — which is the classical SIMPLE
preconditioner for the incompressible Navier–Stokes saddle-point system.

Globalization: pseudo-transient continuation (Kelley & Keyes, SINUM 1998
— "Convergence analysis of pseudo-transient continuation") with the SER
timestep schedule, plus a backtracking line search on ||F|| (halve the
step until monotone decrease, ``max_backtracks`` tries).  PTC is
load-bearing twice over: (a) the raw steady Jacobian past the Hopf point
is so ill-conditioned that even unrestarted f64 GMRES(240) stagnates at
~0.7 relative residual (measured round 4, 127^2-255^2), while the
rho*vol/dtau-shifted systems are SIMPLE-preconditionable; (b) the early
implicit-Euler-like steps march through the unstable oscillatory modes
that defeat every fixed-point iteration.  Reynolds/grid continuation
composes on top (``benchmarks/scale_runs.py``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from ..core.bc import BoundaryConditions, apply_velocity_bcs
from ..core.fluid import FluidProperties
from ..core.mesh import StructuredMesh
from ..core.state import FlowState
from ..ops.poisson import poisson_coefficients, pressure_rhs
from ..ops.powerlaw import d_coefficient
from ..solvers.krylov import gmres_solve
from ..solvers.momentum import (_assemble_coeffs, _unrelaxed_residual,
                                _u_interior_mask, _v_interior_mask)
from ..solvers.multigrid import MultigridConfig, multigrid_solve


@dataclasses.dataclass(frozen=True)
class NewtonDiagnostics:
    """Newton-run record.  ``final_residual`` is max(||r_u||, ||r_v||) —
    the same interior-L2 unrelaxed momentum norms the SIMPLE-family outer
    loops converge on, so Newton results compare directly against the
    outer-loop stall levels in PERF.md."""

    converged: bool
    iterations: int
    final_residual: float
    residual_history: tuple
    gmres_iterations: int


@dataclasses.dataclass(frozen=True)
class NewtonConfig:
    """JFNK configuration (all fields static -> one compiled program)."""

    max_newton: int = 40
    # convergence on max(||r_u||, ||r_v||) — the same interior-L2
    # unrelaxed momentum norms the SIMPLE outer loop converges on
    tolerance: float = 1e-5
    scheme: str = "quick"  # momentum discretization: power_law|quick|luds
    # inexact-Newton forcing: GMRES solves to ||J d + F|| <= eta ||F||
    gmres_tol: float = 1e-2
    # the preconditioned Jacobian is strongly non-normal (its 31^2 spectrum
    # clusters at +1 in [0.7, 2.3] yet restarted GMRES(30) still needs
    # hundreds of steps at >=127^2) — longer recurrences pay
    gmres_restart: int = 60
    gmres_maxiter: int = 240
    max_backtracks: int = 5
    # preconditioner MG solve (frozen coefficients, loose tolerance)
    precond_cycles: int = 4
    # Jacobi sweeps on the momentum blocks inside the preconditioner (1 =
    # the pure diagonal solve; >1 sweeps the frozen momentum stencil, which
    # preconditions the convection coupling the diagonal misses — needed at
    # fine grids / high Re where GMRES otherwise stagnates)
    momentum_sweeps: int = 1
    # under-relaxation of the *first* Newton steps when starting far from
    # the solution (1.0 = full Newton); the line search handles the rest
    initial_damping: float = 1.0
    # pseudo-transient continuation (Kelley & Keyes, SINUM 1998): solve
    # (rho dx dy / dtau + J) d = -F with the SER schedule
    # dtau_k = dtau0 * ||F_0|| / ||F_k|| (per-step growth clamped).  The
    # diagonal shift makes the momentum block dominant, which the SIMPLE
    # preconditioner captures — measured round 4: the UNSHIFTED Newton
    # Jacobian at >=127^2 stagnates even full(!) f64 GMRES at lin_rel ~0.7,
    # while the shifted systems solve to 1e-2 in a few dozen iterations.
    # As dtau -> inf this recovers plain Newton, so the endgame is still
    # quadratic; the implicit-Euler character of the early steps is also
    # exactly what steps PAST an unstable (post-Hopf) steady branch.
    # dtau0 = 0 disables (plain Newton).
    dtau0: float = 0.5
    dtau_max: float = 1e8
    ser_growth: float = 4.0
    # GMRES chunking across host calls: 0 = the whole gmres_maxiter solve
    # inside one jitted Newton-step program (fine to 511^2); k > 0 = run k
    # restart cycle(s) per jitted program, driven from the host with early
    # exit between chunks.  Chunking bounds each program at k*restart
    # preconditioned iterations, so a 1023^2+ Newton step is no longer one
    # long device program.  Identical restart structure (a restart cycle is
    # a fresh Arnoldi from the current residual, so splitting cycles across
    # programs changes nothing algorithmically); the linearization is
    # re-traced per chunk at the frozen iterate — one extra assembly forward
    # pass per chunk, negligible against the restart cycle it wraps.
    gmres_chunk: int = 0


def _flatten(u, v, p):
    return jnp.concatenate([u.ravel(), v.ravel(), p.ravel()])


def _unflatten(w, su, sv, sp):
    nu = su[0] * su[1]
    nv = sv[0] * sv[1]
    u = w[:nu].reshape(su)
    v = w[nu:nu + nv].reshape(sv)
    p = w[nu + nv:].reshape(sp)
    return u, v, p


def make_residual(*, dx, dy, rho, mu, bc: BoundaryConditions, scheme: str,
                  su, sv, sp):
    """Flat residual F: R^N -> R^N (momentum blocks + projected
    continuity block).  Differentiable end-to-end."""
    u_mask = _u_interior_mask(su)
    v_mask = _v_interior_mask(sv)

    def F(w):
        u, v, p = _unflatten(w, su, sv, sp)
        u, v = apply_velocity_bcs(u, v, bc)
        c_u = _assemble_coeffs(u, v, p, dx=dx, dy=dy, rho=rho, mu=mu,
                               scheme=scheme, is_u=True)
        c_v = _assemble_coeffs(u, v, p, dx=dx, dy=dy, rho=rho, mu=mu,
                               scheme=scheme, is_u=False)
        from ..solvers.momentum import _apply

        # ORIENTATION MATTERS: momentum rows are A u - src (not the SIMPLE
        # defect src - A u), so the Jacobian's momentum block is +A-like.
        # With the defect orientation J ~ -A and the SIMPLE preconditioner
        # (which approximates +A^{-1}) produces a mixed-sign AM spectrum
        # straddling zero — measured round 4 at 31^2: ~90% of eigenvalues
        # with NEGATIVE real part, GMRES stagnating at 0.7-1.0 relative
        # residual even unrestarted in f64.  The norm is sign-invariant, so
        # convergence reporting is unchanged.
        r_u = jnp.where(u_mask, _apply(u, c_u) - c_u.src, 0.0)
        r_v = jnp.where(v_mask, _apply(v, c_v) - c_v.src, 0.0)
        r_c = pressure_rhs(u, v, dx=dx, dy=dy, rho=rho, pin=False)
        r_c = r_c - jnp.mean(r_c)  # project the left null vector
        return _flatten(r_u, r_v, r_c)

    return F


def make_preconditioner(u, v, p, *, dx, dy, rho, mu, bc, scheme,
                        pres_cfg: MultigridConfig, su, sv, sp,
                        momentum_sweeps: int = 1, ap_shift=0.0):
    """SIMPLE-type block preconditioner frozen at the Newton iterate
    (u, v, p): ``momentum_sweeps`` Jacobi sweeps on the frozen momentum
    stencils + one MG pressure projection.  ``ap_shift`` (traced scalar)
    adds the pseudo-transient rho*dx*dy/dtau mass term to the momentum
    diagonal so M matches the shifted operator GMRES solves."""
    ub, vb = apply_velocity_bcs(u, v, bc)
    c_u = _assemble_coeffs(ub, vb, p, dx=dx, dy=dy, rho=rho, mu=mu,
                           scheme=scheme, is_u=True)
    c_v = _assemble_coeffs(ub, vb, p, dx=dx, dy=dy, rho=rho, mu=mu,
                           scheme=scheme, is_u=False)
    ap_u = c_u.a_p + ap_shift
    ap_v = c_v.a_p + ap_shift
    inv_ap_u = jnp.where(c_u.a_p > 0, 1.0 / ap_u, 0.0)
    inv_ap_v = jnp.where(c_v.a_p > 0, 1.0 / ap_v, 0.0)
    # d-coefficients of the UNRELAXED (but pseudo-time-shifted) system
    # (alpha folded out: Newton works on the true equations, not the
    # relaxed ones)
    d_u = d_coefficient(ap_u, dy, is_u=True)
    d_v = d_coefficient(ap_v, dx, is_u=False)
    u_mask = _u_interior_mask(su)
    v_mask = _v_interior_mask(sv)

    from ..solvers.momentum import _apply

    def M(r):
        r_u, r_v, r_c = _unflatten(r, su, sv, sp)
        du = jnp.where(u_mask, r_u * inv_ap_u, 0.0)
        dv = jnp.where(v_mask, r_v * inv_ap_v, 0.0)
        for _ in range(momentum_sweeps - 1):
            du = jnp.where(
                u_mask,
                du + (r_u - _apply(du, c_u) - ap_shift * du) * inv_ap_u, 0.0)
            dv = jnp.where(
                v_mask,
                dv + (r_v - _apply(dv, c_v) - ap_shift * dv) * inv_ap_v, 0.0)
        # continuity: we need D(du_final) = r_c where D = pressure_rhs and
        # du_final = du0 + d grad dp.  The library Poisson operator satisfies
        # pressure_rhs(d grad x) = -L x (that is SIMPLE's own correction
        # identity), so D(du_final) = div(du0) - L dp = r_c requires
        #   L dp = div(du0) - r_c.
        # (The round-4 spectrum study at 31^2 caught the sign: with
        # r_c - div the Schur block eigenvalues land at -1 and GMRES
        # stagnates; with div - r_c the AM spectrum clusters at +1.)
        div_duv = pressure_rhs(du, dv, dx=dx, dy=dy, rho=rho, pin=False)
        rhs = div_duv - r_c
        rhs = rhs - jnp.mean(rhs)
        dp, _ = multigrid_solve(rhs, d_u, d_v, jnp.zeros(sp, rhs.dtype),
                                pres_cfg, dx=dx, dy=dy, rho=rho,
                                variant="consistent")
        # velocity correction du += d * grad dp (signs as update_velocity)
        grad_u = jnp.pad(dp[:-1, :] - dp[1:, :], ((1, 1), (0, 0)))
        grad_v = jnp.pad(dp[:, :-1] - dp[:, 1:], ((0, 0), (1, 1)))
        du = jnp.where(u_mask, du + d_u * grad_u, du)
        dv = jnp.where(v_mask, dv + d_v * grad_v, dv)
        dp = dp - jnp.mean(dp)
        return _flatten(du, dv, dp)

    return M


@functools.lru_cache(maxsize=16)
def _build_newton_step(su, sv, sp, dx, dy, rho, mu, bc, cfg: NewtonConfig,
                       pres_cfg: MultigridConfig):
    """One jitted Newton step: linearize F at w, GMRES-solve J d = -F,
    line-search the update.  Returns (w', norms, gmres_iters, n_backtracks)."""
    F = make_residual(dx=dx, dy=dy, rho=rho, mu=mu, bc=bc, scheme=cfg.scheme,
                      su=su, sv=sv, sp=sp)

    def mom_norms(w):
        """The SIMPLE-comparable convergence norms at w: interior L2 of the
        unrelaxed momentum residuals."""
        u, v, p = _unflatten(w, su, sv, sp)
        u, v = apply_velocity_bcs(u, v, bc)
        c_u = _assemble_coeffs(u, v, p, dx=dx, dy=dy, rho=rho, mu=mu,
                               scheme=cfg.scheme, is_u=True)
        c_v = _assemble_coeffs(u, v, p, dx=dx, dy=dy, rho=rho, mu=mu,
                               scheme=cfg.scheme, is_u=False)
        _, un = _unrelaxed_residual(u, c_u, is_u=True)
        _, vn = _unrelaxed_residual(v, c_v, is_u=False)
        return jnp.maximum(un, vn)

    u_mask = _u_interior_mask(su)
    v_mask = _v_interior_mask(sv)
    shift_mask = _flatten(u_mask.astype(jnp.float32),
                          v_mask.astype(jnp.float32),
                          jnp.zeros(sp, jnp.float32))

    def _linearized(w, inv_dtau):
        """Linearize F at w; return (Fw, shifted Jv, preconditioner M)."""
        Fw, jvp = jax.linearize(F, w)
        # pseudo-transient shift: rho*vol/dtau on interior momentum rows
        # (continuity is the algebraic constraint — never shifted)
        shift = (rho * dx * dy * inv_dtau) * shift_mask.astype(w.dtype)
        jvp_s = lambda z: jvp(z) + shift * z
        u, v, p = _unflatten(w, su, sv, sp)
        M = make_preconditioner(
            u, v, p, dx=dx, dy=dy, rho=rho, mu=mu, bc=bc, scheme=cfg.scheme,
            pres_cfg=pres_cfg, su=su, sv=sv, sp=sp,
            momentum_sweeps=cfg.momentum_sweeps,
            ap_shift=rho * dx * dy * inv_dtau)
        return Fw, jvp_s, M

    def _line_search(w, d, damping, f0):
        # backtracking line search on ||F||.  Plain Newton demands monotone
        # decrease; PTC steps follow the implicit-Euler trajectory, which is
        # NOT ||F||-monotone (measured: ~+0.2% steps near a plateau that the
        # strict search rejected down to lam=2^-5, freezing the iteration),
        # so in PTC mode only genuine blow-ups (>25%) are backtracked.
        accept = 1.25 if cfg.dtau0 > 0 else 1.0

        def try_step(lam):
            wn = w + lam * d
            return wn, jnp.linalg.norm(F(wn))

        def body(carry):
            lam, wn, fn, n = carry
            lam = lam * 0.5
            wn, fn = try_step(lam)
            return lam, wn, fn, n + 1

        def cond(carry):
            lam, wn, fn, n = carry
            return (fn >= accept * f0) & (n < cfg.max_backtracks)

        w1, f1 = try_step(damping)
        if cfg.max_backtracks > 0:
            lam, w1, f1, n_bt = jax.lax.while_loop(
                cond, body, (damping, w1, f1, jnp.asarray(0, jnp.int32)))
        else:  # PTC mode: accept the implicit-Euler step as taken
            n_bt = jnp.asarray(0, jnp.int32)
        return w1, f1, n_bt

    @jax.jit
    def newton_step(w, damping, inv_dtau):
        Fw, jvp_s, M = _linearized(w, inv_dtau)
        d, r_lin, k = gmres_solve(-Fw, jvp_s, M, jnp.zeros_like(w),
                                  cfg.gmres_tol, cfg.gmres_maxiter,
                                  cfg.gmres_restart)
        f0 = jnp.linalg.norm(Fw)
        lin_rel = jnp.linalg.norm(r_lin) / jnp.maximum(f0, 1e-30)
        w1, f1, n_bt = _line_search(w, d, damping, f0)
        return w1, mom_norms(w1), f1, f0, k, n_bt, lin_rel

    @jax.jit
    def gmres_chunk(w, d0, inv_dtau):
        """``cfg.gmres_chunk`` restart cycle(s) of the Newton linear solve,
        warm-started at d0 (one bounded program per host call).  A restart
        cycle is a fresh Arnoldi from the current residual, so splitting cycles
        across host calls is algorithmically the monolithic solve; the
        re-linearization at the frozen w costs one assembly pass."""
        Fw, jvp_s, M = _linearized(w, inv_dtau)
        d, r_lin, k = gmres_solve(-Fw, jvp_s, M, d0, cfg.gmres_tol,
                                  cfg.gmres_chunk * cfg.gmres_restart,
                                  cfg.gmres_restart)
        f0 = jnp.linalg.norm(Fw)
        return d, jnp.linalg.norm(r_lin), f0, k

    @jax.jit
    def apply_step(w, d, damping, f0):
        w1, f1, n_bt = _line_search(w, d, damping, f0)
        return w1, mom_norms(w1), f1, n_bt

    def newton_step_chunked(w, damping, inv_dtau):
        """Host-driven variant of ``newton_step``: same return contract,
        GMRES split into bounded ``gmres_chunk``-cycle programs."""
        d = jnp.zeros_like(w)
        total_k = 0
        f0 = r_lin = None
        n_chunks = -(-cfg.gmres_maxiter // (cfg.gmres_chunk
                                            * cfg.gmres_restart))
        for _ in range(n_chunks):
            d, r_lin, f0, k = gmres_chunk(w, d, inv_dtau)
            total_k += int(k)
            if float(r_lin) <= cfg.gmres_tol * max(float(f0), 1e-30):
                break
        lin_rel = r_lin / jnp.maximum(f0, 1e-30)
        w1, norms, f1, n_bt = apply_step(w, d, damping, f0)
        return w1, norms, f1, f0, jnp.asarray(total_k, jnp.int32), n_bt, \
            lin_rel

    step_fn = newton_step_chunked if cfg.gmres_chunk > 0 else newton_step
    return step_fn, F, mom_norms


def newton_solve(
    mesh: StructuredMesh,
    fluid: FluidProperties,
    bc: BoundaryConditions,
    state: FlowState,
    cfg: NewtonConfig = NewtonConfig(),
    pressure: MultigridConfig | None = None,
    verbose: bool = False,
) -> Tuple[FlowState, NewtonDiagnostics]:
    """Run Newton–Krylov from ``state`` (typically a SIMPLE-preconverged or
    continuation state) until ``max(||r_u||, ||r_v||) <= cfg.tolerance``.

    Host-driven outer loop (a handful of iterations, each one jitted
    program); returns :class:`NewtonDiagnostics` (residual metric
    identical to the SIMPLE-family convergence norms).
    """
    dx, dy = mesh.get_cell_sizes()
    rho, mu = fluid.get_density(), fluid.get_viscosity()
    pres_cfg = pressure or MultigridConfig(
        tolerance=1e-3, max_cycles=12, check_every=4)
    pres_cfg = dataclasses.replace(pres_cfg, max_cycles=max(
        pres_cfg.max_cycles, cfg.precond_cycles))

    su, sv, sp = state.u.shape, state.v.shape, state.p.shape
    newton_step, F, mom_norms = _build_newton_step(
        su, sv, sp, dx, dy, rho, mu, bc, cfg, pres_cfg)

    u, v = apply_velocity_bcs(state.u, state.v, bc)
    w = _flatten(u, v, state.p)
    norm0 = float(mom_norms(w))
    history = [norm0]
    converged = False
    total_gmres = 0
    it = 0
    dtau = cfg.dtau0
    for it in range(1, cfg.max_newton + 1):
        damping = jnp.asarray(
            cfg.initial_damping if it <= 2 else 1.0, w.dtype)
        inv_dtau = jnp.asarray(0.0 if dtau <= 0 else 1.0 / dtau, w.dtype)
        w, norm, f1, f0, k, n_bt, lin_rel = newton_step(w, damping,
                                                        inv_dtau)
        norm = float(norm)
        total_gmres += int(k)
        history.append(norm)
        if verbose:
            print(f"newton it {it}: mom_norm {norm:.3e}  ||F|| "
                  f"{float(f0):.3e}->{float(f1):.3e}  gmres {int(k)} "
                  f"(lin_rel {float(lin_rel):.2e})  dtau {dtau:.2e}  "
                  f"backtracks {int(n_bt)}", flush=True)
        if not jnp.isfinite(jnp.asarray(norm)):
            break
        if norm <= cfg.tolerance:
            converged = True
            break
        # linear-solve-aware dtau control (an SER variant): grow dtau
        # geometrically while GMRES actually solves the shifted system
        # (lin_rel at the forcing tolerance), hold when it merely makes
        # progress, shrink when it fails outright.  Classic ||F||-ratio SER
        # stalls here: near the pre-Hopf plateau PTC steps shrink ||F|| by
        # ~1%/step, so dtau would never grow, while the conditioning — the
        # thing dtau actually buys — is measured directly by lin_rel.
        if dtau > 0:
            lr = float(lin_rel)
            if lr <= 3.0 * cfg.gmres_tol:
                dtau = min(dtau * cfg.ser_growth, cfg.dtau_max)
            elif lr > 0.5:
                dtau = max(dtau / cfg.ser_growth, cfg.dtau0 / 8)

    u, v, p = _unflatten(w, su, sv, sp)
    u, v = apply_velocity_bcs(u, v, bc)
    p = p - jnp.mean(p)
    final = FlowState(u=u, v=v, p=p)
    diag = NewtonDiagnostics(
        converged=bool(converged),
        iterations=it,
        final_residual=history[-1],
        residual_history=tuple(history),
        gmres_iterations=total_gmres,
    )
    return final, diag
