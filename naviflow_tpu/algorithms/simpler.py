"""SIMPLER (SIMPLE-Revised, Patankar).

JAX rebuild of the reference ``SimplerSolver``
(``naviflow_oo/solver/Algorithms/simpler.py:95-211``).  Per outer iteration:

1. momentum prediction with the current p (relaxed);
2. intermediate pressure p̄ from the starred field; ``p += p̄``;
3. momentum re-solve with the updated p (relaxed);
4. correction pressure p' from the new starred field;
5. ``p += alpha_p p'`` and velocity correction with p'.

Convergence on ``max(u_rel, v_rel)`` of the unrelaxed momentum residuals from
step 1; the pressure residual is ``||p - p_old|| / sqrt(n_cells)``
(reference :200-204).
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
from .simple import SIMPLEConfig


@dataclasses.dataclass(frozen=True)
class SIMPLERConfig(SIMPLEConfig):
    pass


def make_simpler_step(*, dx, dy, rho, mu, bc, cfg: SIMPLERConfig, mom_cfg, pres_cfg,
                      coarse_mode: str = "carry"):
    pin = cfg.poisson_variant == "reference"
    lagged = uses_lagged_mg(pres_cfg)
    if lagged:
        lg = make_lagged_mg(
            pres_cfg, dx=dx, dy=dy, rho=rho, variant=cfg.poisson_variant
        )

    def solve_momentum(u, v, p):
        ((u_star, d_u, r_u, u_norm),
         (v_star, d_v, r_v, v_norm)) = solve_momentum_pair(
            u, v, p, dx=dx, dy=dy, rho=rho, mu=mu, alpha=cfg.alpha_u,
            bc=bc, cfg=mom_cfg)
        return u_star, v_star, d_u, d_v, r_u, r_v, u_norm, v_norm

    def pressure_solve(u_star, v_star, d_u, d_v, p, coarse=None):
        b = pressure_rhs(u_star, v_star, dx=dx, dy=dy, rho=rho, pin=pin)
        pc = poisson_coefficients(d_u, d_v, dx=dx, dy=dy, rho=rho,
                                  variant=cfg.poisson_variant)
        if lagged:
            return lg.solve(b, pc, d_u, d_v, p, coarse)
        return dispatch_pressure_solve(
            b, pc, jnp.zeros_like(p), pres_cfg,
            d_u=d_u, d_v=d_v, dx=dx, dy=dy, rho=rho,
            variant=cfg.poisson_variant, pin=pin,
        )

    def step(u, v, p, extra):
        if lagged:
            p_max_l2, mg_extra = extra
        else:
            p_max_l2 = extra

        p_old = p
        # 1. momentum prediction (old p)
        u_star, v_star, d_u, d_v, r_u, r_v, u_norm, v_norm = solve_momentum(u, v, p)
        # one coarse hierarchy per outer iteration, shared by both pressure
        # solves (the d-fields barely change between them; the fine operator
        # is always current so both fixed points stay exact)
        coarse = ((lg.rebuild(d_u, d_v) if coarse_mode == "rebuild"
                   else mg_extra[1]) if lagged else None)
        # 2. intermediate pressure p_bar
        p_bar, info1 = pressure_solve(u_star, v_star, d_u, d_v, p, coarse)
        p = p + p_bar
        if cfg.overwrite_boundary_pressure:
            p = enforce_pressure_bcs(p, bc)
        # 3. momentum with p_bar-updated pressure
        u_star, v_star, d_u, d_v, _, _, _, _ = solve_momentum(u, v, p)
        # 4. correction pressure p'
        p_prime, info2 = pressure_solve(u_star, v_star, d_u, d_v, p, coarse)
        # 5. final pressure & velocity
        p = p + cfg.alpha_p * p_prime
        if cfg.overwrite_boundary_pressure:
            p = enforce_pressure_bcs(p, bc)
        u, v = update_velocity(u_star, v_star, p_prime, d_u, d_v, bc)

        n_cells = p.shape[0] * p.shape[1]
        p_rel = jnp.linalg.norm(p - p_old) / (jnp.sqrt(jnp.asarray(n_cells, p.dtype)) + 1e-30)

        info = StepInfo(
            u_norm=u_norm, v_norm=v_norm, p_norm=p_rel,
            inner_iterations=info1.iterations + info2.iterations,
            r_u=r_u, r_v=r_v, r_p=info2.residual_field,
        )
        extra_out = (p_max_l2, (mg_extra[0] + 1, coarse)) if lagged else p_max_l2
        return u, v, p, extra_out, info

    return step


@functools.lru_cache(maxsize=64)
def _build_solve(mesh, fluid, bc, cfg, mom_cfg, pres_cfg, loop):
    dx, dy = mesh.get_cell_sizes()
    rho, mu = fluid.get_density(), fluid.get_viscosity()
    common = dict(dx=dx, dy=dy, rho=rho, mu=mu, bc=bc, cfg=cfg,
                  mom_cfg=mom_cfg, pres_cfg=pres_cfg)
    step = make_simpler_step(**common)
    refresh_step, refresh_every = None, 0
    if uses_lagged_mg(pres_cfg):
        nx, ny = mesh.get_dimensions()
        mg_extra0 = make_lagged_mg(
            pres_cfg, dx=dx, dy=dy, rho=rho, variant=cfg.poisson_variant
        ).extra0
        extra0_fn = lambda dt: (jnp.asarray(0.0, dt), mg_extra0(dt, nx, ny))
        refresh_step = make_simpler_step(**common, coarse_mode="rebuild")
        refresh_every = pres_cfg.coarse_rebuild_every
    else:
        extra0_fn = lambda dt: jnp.asarray(0.0, dt)
    return build_solver(
        step, max_iterations=cfg.max_iterations, tolerance=cfg.tolerance,
        dx=dx, dy=dy, extra0_fn=extra0_fn, loop=loop,
        refresh_step=refresh_step, refresh_every=refresh_every,
    )


def simpler_solve(
    mesh: StructuredMesh,
    fluid: FluidProperties,
    bc: BoundaryConditions,
    state: FlowState,
    cfg: SIMPLERConfig = SIMPLERConfig(),
    momentum: object = JacobiMomentumConfig(),
    pressure: object = RBGSPressureConfig(),
    loop: str = "auto",
    on_chunk=None,
) -> Tuple[FlowState, SolveDiagnostics]:
    fn = _build_solve(mesh, fluid, bc, cfg, momentum, pressure, loop)
    return fn(state.u, state.v, state.p, on_chunk=on_chunk)
