"""SIMPLE pressure–velocity coupling as one fused, jit-compiled while-loop.

JAX rebuild of the reference outer iteration
(``naviflow_oo/solver/Algorithms/simple.py:78-269``).  The Python
while-loop + per-iteration native-library calls become a single
``jax.lax.while_loop`` whose body is the complete SIMPLE step — momentum
predictor, pressure-correction solve, relaxed pressure update, velocity
correction — traced once and compiled to one XLA program.

Semantics preserved from the reference loop body (``simple.py:114-212``):
1. u*, v* from the *relaxed* momentum systems, coefficients evaluated at the
   old (u, v, p*);
2. p' from the continuity defect of (u*, v*) with d_u, d_v;
3. ``p = p* + alpha_p p'`` (the reference then overwrites boundary pressure
   cells — see ``SIMPLEConfig.overwrite_boundary_pressure``);
4. ``u = u* + d_u (p'_W - p'_P)`` etc., then velocity BCs;
5. convergence on ``max(u_norm, v_norm) <= tol`` where the momentum norms are
   interior L2 norms of the unrelaxed residuals (``simple.py:174``), and the
   pressure rel-norm is ``l2(r_interior)/max_hist`` (``gauss_seidel.py:189-200``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import jax.numpy as jnp

from ..core.bc import BoundaryConditions, enforce_pressure_bcs
from ..core.fluid import FluidProperties
from ..core.mesh import StructuredMesh
from ..core.state import FlowState
from ..ops.poisson import poisson_coefficients, pressure_rhs
from ..solvers.dispatch import dispatch_pressure_solve
from ..solvers.momentum import JacobiMomentumConfig, solve_momentum_pair
from ..solvers.pressure import RBGSPressureConfig
from ..solvers.velocity import update_velocity
from .base import SolveDiagnostics, StepInfo, build_solver
from .lagged import make_lagged_mg, uses_lagged_mg


@dataclasses.dataclass(frozen=True)
class SIMPLEConfig:
    alpha_p: float = 0.3
    alpha_u: float = 0.7
    max_iterations: int = 1000
    tolerance: float = 1e-5
    # 'consistent' (default; converges to machine floor) or 'reference'
    # (bit-parity with the reference operator, stalls near 1e-3 — see
    # ops/poisson.py docstring).
    poisson_variant: str = "consistent"
    # The reference overwrites boundary pressure cells with their interior
    # neighbors every iteration (``base_algorithm.py:161-197``).  On a
    # staggered grid every pressure cell is a genuine unknown; the overwrite
    # zeroes the momentum pressure source at boundary-adjacent nodes and
    # locks the outer iteration into a boundary limit cycle (residual floor
    # ~5e-3).  Off by default; enable only for reference-parity runs.
    overwrite_boundary_pressure: bool = False


def make_simple_step(*, dx, dy, rho, mu, bc, cfg, mom_cfg, pres_cfg,
                     coarse_mode: str = "carry"):
    """One SIMPLE outer iteration as a pure function (u, v, p, extra) ->.

    ``extra`` is the pressure rel-norm running max; with a lagged-multigrid
    pressure config it additionally carries (age, coarse Stencil9 tuple) so
    the Galerkin coarse hierarchy is rebuilt only every
    ``coarse_rebuild_every`` iterations (see ``algorithms.lagged``).
    ``coarse_mode``: 'carry' uses the carried coarse hierarchy; 'rebuild'
    rebuilds it from this iteration's d-coefficients — the loop harness runs
    the 'rebuild' variant as the first iteration of every K-block
    (conditional-free lagging; ignored for non-lagged configs).
    """
    pin = cfg.poisson_variant == "reference"
    lagged = uses_lagged_mg(pres_cfg)
    if lagged:
        lg = make_lagged_mg(
            pres_cfg, dx=dx, dy=dy, rho=rho, variant=cfg.poisson_variant
        )

    def step(u, v, p, extra):
        if lagged:
            p_max_l2, mg_extra = extra
        else:
            p_max_l2 = extra

        p_star = p
        ((u_star, d_u, r_u, u_norm),
         (v_star, d_v, r_v, v_norm)) = solve_momentum_pair(
            u, v, p_star, dx=dx, dy=dy, rho=rho, mu=mu,
            alpha=cfg.alpha_u, bc=bc, cfg=mom_cfg,
        )

        b = pressure_rhs(u_star, v_star, dx=dx, dy=dy, rho=rho, pin=pin)
        pc = poisson_coefficients(d_u, d_v, dx=dx, dy=dy, rho=rho,
                                  variant=cfg.poisson_variant)
        if lagged:
            coarse = (lg.rebuild(d_u, d_v) if coarse_mode == "rebuild"
                      else mg_extra[1])
            p_prime, pinfo = lg.solve(b, pc, d_u, d_v, p, coarse)
        else:
            p_prime, pinfo = dispatch_pressure_solve(
                b, pc, jnp.zeros_like(p), pres_cfg,
                d_u=d_u, d_v=d_v, dx=dx, dy=dy, rho=rho,
                variant=cfg.poisson_variant, pin=pin,
            )

        p_new = p_star + cfg.alpha_p * p_prime
        if cfg.overwrite_boundary_pressure:
            p_new = enforce_pressure_bcs(p_new, bc)

        u_new, v_new = update_velocity(u_star, v_star, p_prime, d_u, d_v, bc)

        # Pressure relative norm: interior L2 scaled by its running maximum
        # (reference ``gauss_seidel.py:189-200``).
        p_l2 = jnp.linalg.norm(pinfo.residual_field[1:-1, 1:-1])
        p_max_l2 = jnp.maximum(p_max_l2, p_l2)
        p_rel = jnp.where(p_max_l2 > 0, p_l2 / p_max_l2, jnp.ones_like(p_l2))

        info = StepInfo(
            u_norm=u_norm, v_norm=v_norm, p_norm=p_rel,
            inner_iterations=pinfo.iterations,
            r_u=r_u, r_v=r_v, r_p=pinfo.residual_field,
        )
        if lagged:
            extra_out = (p_max_l2, (mg_extra[0] + 1, coarse))
        else:
            extra_out = p_max_l2
        return u_new, v_new, p_new, extra_out, info

    return step


@functools.lru_cache(maxsize=64)
def _build_solve(mesh, fluid, bc, cfg, mom_cfg, pres_cfg, loop):
    dx, dy = mesh.get_cell_sizes()
    rho, mu = fluid.get_density(), fluid.get_viscosity()
    nx, ny = mesh.get_dimensions()
    common = dict(dx=dx, dy=dy, rho=rho, mu=mu, bc=bc, cfg=cfg,
                  mom_cfg=mom_cfg, pres_cfg=pres_cfg)
    step = make_simple_step(**common)
    refresh_step, refresh_every = None, 0
    if uses_lagged_mg(pres_cfg):
        mg_extra0 = make_lagged_mg(
            pres_cfg, dx=dx, dy=dy, rho=rho, variant=cfg.poisson_variant
        ).extra0
        extra0_fn = lambda dt: (jnp.asarray(0.0, dt), mg_extra0(dt, nx, ny))
        refresh_step = make_simple_step(**common, coarse_mode="rebuild")
        refresh_every = pres_cfg.coarse_rebuild_every
    else:
        extra0_fn = lambda dt: jnp.asarray(0.0, dt)
    return build_solver(
        step, max_iterations=cfg.max_iterations, tolerance=cfg.tolerance,
        dx=dx, dy=dy, extra0_fn=extra0_fn, loop=loop,
        refresh_step=refresh_step, refresh_every=refresh_every,
    )


def simple_solve(
    mesh: StructuredMesh,
    fluid: FluidProperties,
    bc: BoundaryConditions,
    state: FlowState,
    cfg: SIMPLEConfig = SIMPLEConfig(),
    momentum: object = JacobiMomentumConfig(),
    pressure: object = RBGSPressureConfig(),
    loop: str = "auto",
    on_chunk=None,
) -> Tuple[FlowState, SolveDiagnostics]:
    """Run SIMPLE to convergence (or ``max_iterations``).

    All configuration objects are static: each distinct combination compiles
    one specialized XLA program (cached across calls).  ``loop``: 'fused'
    or 'auto' (single while-loop program), 'host' (jitted step driven from
    the host), or 'chunked[:K]' (fused chunks with a host hook between).
    """
    fn = _build_solve(mesh, fluid, bc, cfg, momentum, pressure, loop)
    return fn(state.u, state.v, state.p, on_chunk=on_chunk)
