"""SIMPLEC (SIMPLE-Consistent).

JAX rebuild of the reference ``SimplecSolver``
(``naviflow_oo/solver/Algorithms/simplec.py``).  Deltas from SIMPLE, all
preserved:

* d-coefficient modification ``d / (1 - (1 - alpha_u)) = d / alpha_u``
  (reference :125-126) used in both the pressure equation and the velocity
  correction;
* pressure-correction smoothing with the 0.6/0.1 five-point stencil
  (reference :141-147);
* dynamic alpha_p backoff: multiply by 0.95 whenever the residual increased
  (reference :150-154) — alpha_p is therefore a *traced* carry value here;
* residuals are max-abs field changes (``max|u - u_old|``), not algebraic
  norms (reference :118-121, :168-172).
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
class SIMPLECConfig(SIMPLEConfig):
    alpha_p: float = 0.2  # reference SimplecSolver default (simplec.py:21)
    # The reference smooths p' with a 0.6/0.1 stencil (:141-147) — a
    # stabilization hack for its inconsistent pressure operator.  Under the
    # consistent operator the smoothing *breaks* the exact continuity
    # annihilation and the outer loop diverges, so it is off by default and
    # available only for reference-parity studies.
    smooth_p_prime: bool = False
    dynamic_alpha_p: bool = True


def _smooth_p_prime(p_prime):
    """0.6 center / 0.1 neighbors smoothing, zeroing the boundary ring
    (reference ``simplec.py:141-147``)."""
    sm = jnp.zeros_like(p_prime)
    sm = sm.at[1:-1, 1:-1].set(
        0.6 * p_prime[1:-1, 1:-1]
        + 0.1 * (
            p_prime[2:, 1:-1] + p_prime[:-2, 1:-1]
            + p_prime[1:-1, 2:] + p_prime[1:-1, :-2]
        )
    )
    return sm


def make_simplec_step(*, dx, dy, rho, mu, bc, cfg: SIMPLECConfig, mom_cfg, pres_cfg,
                      coarse_mode: str = "carry"):
    pin = cfg.poisson_variant == "reference"
    lagged = uses_lagged_mg(pres_cfg)
    if lagged:
        lg = make_lagged_mg(
            pres_cfg, dx=dx, dy=dy, rho=rho, variant=cfg.poisson_variant
        )

    def step(u, v, p, extra):
        if lagged:
            alpha_p, prev_res, mg_extra = extra
        else:
            alpha_p, prev_res = extra

        p_star = p
        ((u_star, d_u, r_u, _),
         (v_star, d_v, r_v, _)) = solve_momentum_pair(
            u, v, p_star, dx=dx, dy=dy, rho=rho, mu=mu,
            alpha=cfg.alpha_u, bc=bc, cfg=mom_cfg,
        )

        # SIMPLEC d-coefficient modification (reference :125-126)
        d_u_c = d_u / cfg.alpha_u
        d_v_c = d_v / cfg.alpha_u

        b = pressure_rhs(u_star, v_star, dx=dx, dy=dy, rho=rho, pin=pin)
        pc = poisson_coefficients(d_u_c, d_v_c, dx=dx, dy=dy, rho=rho,
                                  variant=cfg.poisson_variant)
        if lagged:
            coarse = (lg.rebuild(d_u_c, d_v_c) if coarse_mode == "rebuild"
                      else mg_extra[1])
            p_prime, pinfo = lg.solve(b, pc, d_u_c, d_v_c, p, coarse)
        else:
            p_prime, pinfo = dispatch_pressure_solve(
                b, pc, jnp.zeros_like(p), pres_cfg,
                d_u=d_u_c, d_v=d_v_c, dx=dx, dy=dy, rho=rho,
                variant=cfg.poisson_variant, pin=pin,
            )
        if cfg.smooth_p_prime:
            p_prime = _smooth_p_prime(p_prime)

        p_new = p_star + alpha_p * p_prime
        if cfg.overwrite_boundary_pressure:
            p_new = enforce_pressure_bcs(p_new, bc)

        u_new, v_new = update_velocity(u_star, v_star, p_prime, d_u_c, d_v_c, bc)

        # max-abs field-change residuals (reference :118-121, :168-172)
        u_res = jnp.max(jnp.abs(u_new - u))
        v_res = jnp.max(jnp.abs(v_new - v))
        p_res = jnp.max(jnp.abs(p_new - p))
        total = jnp.maximum(u_res, v_res)

        # dynamic alpha_p backoff (reference :150-154)
        if cfg.dynamic_alpha_p:
            alpha_p = jnp.where(total > prev_res, alpha_p * 0.95, alpha_p)

        info = StepInfo(
            u_norm=u_res, v_norm=v_res, p_norm=p_res,
            inner_iterations=pinfo.iterations,
            r_u=r_u, r_v=r_v, r_p=pinfo.residual_field,
        )
        if lagged:
            extra_out = (alpha_p, total, (mg_extra[0] + 1, coarse))
        else:
            extra_out = (alpha_p, total)
        return u_new, v_new, p_new, extra_out, info

    return step


@functools.lru_cache(maxsize=64)
def _build_solve(mesh, fluid, bc, cfg, mom_cfg, pres_cfg, loop):
    dx, dy = mesh.get_cell_sizes()
    rho, mu = fluid.get_density(), fluid.get_viscosity()
    common = dict(dx=dx, dy=dy, rho=rho, mu=mu, bc=bc, cfg=cfg,
                  mom_cfg=mom_cfg, pres_cfg=pres_cfg)
    step = make_simplec_step(**common)
    refresh_step, refresh_every = None, 0
    if uses_lagged_mg(pres_cfg):
        nx, ny = mesh.get_dimensions()
        mg_extra0 = make_lagged_mg(
            pres_cfg, dx=dx, dy=dy, rho=rho, variant=cfg.poisson_variant
        ).extra0
        extra0_fn = lambda dt: (jnp.asarray(cfg.alpha_p, dt),
                                jnp.asarray(jnp.inf, dt), mg_extra0(dt, nx, ny))
        refresh_step = make_simplec_step(**common, coarse_mode="rebuild")
        refresh_every = pres_cfg.coarse_rebuild_every
    else:
        extra0_fn = lambda dt: (jnp.asarray(cfg.alpha_p, dt),
                                jnp.asarray(jnp.inf, dt))
    return build_solver(
        step, max_iterations=cfg.max_iterations, tolerance=cfg.tolerance,
        dx=dx, dy=dy, extra0_fn=extra0_fn, loop=loop,
        refresh_step=refresh_step, refresh_every=refresh_every,
    )


def simplec_solve(
    mesh: StructuredMesh,
    fluid: FluidProperties,
    bc: BoundaryConditions,
    state: FlowState,
    cfg: SIMPLECConfig = SIMPLECConfig(),
    momentum: object = JacobiMomentumConfig(),
    pressure: object = RBGSPressureConfig(),
    loop: str = "auto",
    on_chunk=None,
) -> Tuple[FlowState, SolveDiagnostics]:
    fn = _build_solve(mesh, fluid, bc, cfg, momentum, pressure, loop)
    return fn(state.u, state.v, state.p, on_chunk=on_chunk)
