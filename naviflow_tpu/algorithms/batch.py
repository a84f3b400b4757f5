"""Data-parallel case batching: many independent cavity cases in ONE
vmapped XLA program.

The reference's only data parallelism is a shell-script job farm that runs
independent simulations as separate processes
(``main_scripts/07 AMG_CG/run_m3_optimized.sh``).  The JAX
equivalent (SURVEY §2.3 "DP" row) is ``jax.vmap`` over the case axis:
viscosity is the one per-case scalar (cavity Re = rho·U·L/mu with U = L = 1),
so a sweep over Reynolds numbers at a fixed grid is a single batched solve —
the device sees batched stencil algebra instead of ``len(cases)`` sequential
kernel launches.

Semantics of a vmapped ``lax.while_loop``: the program runs until *every*
case's convergence predicate is false, but each case's carry updates are
masked by its own predicate — early-converging cases freeze at their true
iteration count (verified: a batched Re=100/400 sweep records different
per-case ``iterations``).  Device time is bounded by the slowest case, so
batch cases with similar expected iteration counts for best utilization.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp

from ..core.bc import BoundaryConditions
from ..core.mesh import StructuredMesh
from ..core.state import FlowState, initialize_state
from .base import SolveDiagnostics, run_outer_loop
from .lagged import make_lagged_mg, uses_lagged_mg
from .piso import make_piso_step
from .simple import make_simple_step
from .simplec import make_simplec_step
from .simpler import make_simpler_step

_STEP_MAKERS = {
    "simple": make_simple_step,
    "simplec": make_simplec_step,
    "simpler": make_simpler_step,
    "piso": make_piso_step,
}


def _extra0(algorithm, cfg, pres_cfg, dt, nx, ny, *, dx, dy, rho):
    """Initial ``extra`` carry per algorithm (mirrors each module's
    ``_build_solve``)."""
    if algorithm == "simplec":
        base = (jnp.asarray(cfg.alpha_p, dt), jnp.asarray(jnp.inf, dt))
    else:
        base = (jnp.asarray(0.0, dt),)
    if uses_lagged_mg(pres_cfg):
        mg0 = make_lagged_mg(pres_cfg, dx=dx, dy=dy, rho=rho,
                             variant=cfg.poisson_variant).extra0
        return base + (mg0(dt, nx, ny),)
    return base[0] if len(base) == 1 else base


def batched_cavity_solve(
    mesh: StructuredMesh,
    reynolds: Sequence[float],
    bc: BoundaryConditions,
    cfg,
    momentum,
    pressure,
    *,
    algorithm: str = "simple",
    rho: float = 1.0,
    dtype=jnp.float32,
) -> List[Tuple[FlowState, SolveDiagnostics]]:
    """Solve one cavity grid for a batch of Reynolds numbers in a single
    vmapped+jitted program.  Returns per-case (state, diagnostics)."""
    if algorithm not in _STEP_MAKERS:
        raise ValueError(f"Unknown algorithm: {algorithm}")
    make_step = _STEP_MAKERS[algorithm]
    dx, dy = mesh.get_cell_sizes()
    nx, ny = mesh.get_dimensions()
    mus = jnp.asarray([rho * 1.0 * 1.0 / re for re in reynolds], dtype)

    def one(u0, v0, p0, mu):
        common = dict(dx=dx, dy=dy, rho=rho, mu=mu, bc=bc, cfg=cfg,
                      mom_cfg=momentum, pres_cfg=pressure)
        step = make_step(**common)
        refresh_step, refresh_every = None, 0
        if uses_lagged_mg(pressure):
            refresh_step = make_step(**common, coarse_mode="rebuild")
            refresh_every = pressure.coarse_rebuild_every
        extra0 = _extra0(algorithm, cfg, pressure, dtype, nx, ny,
                         dx=dx, dy=dy, rho=rho)
        return run_outer_loop(
            step, u0, v0, p0, extra0,
            max_iterations=cfg.max_iterations, tolerance=cfg.tolerance,
            dx=dx, dy=dy,
            refresh_step=refresh_step, refresh_every=refresh_every,
        )

    s0 = initialize_state(mesh, bc, dtype=dtype)
    n = len(reynolds)
    tile = lambda x: jnp.broadcast_to(x, (n,) + x.shape)
    states, diags = jax.jit(jax.vmap(one))(
        tile(s0.u), tile(s0.v), tile(s0.p), mus
    )
    out = []
    for i in range(n):
        take = lambda t: jax.tree_util.tree_map(lambda x: x[i], t)
        out.append((take(states), take(diags)))
    return out
