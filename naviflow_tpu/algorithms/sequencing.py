"""Grid sequencing (nonlinear full multigrid over the outer SIMPLE problem).

SIMPLE needs O(nx) outer iterations for the flow to develop from rest — at
1024^2 that is tens of thousands of iterations.  Grid sequencing solves the
cavity on a ladder of coarser grids first and warm-starts each finer level
from the interpolated coarse solution, cutting fine-grid iterations by an
order of magnitude.  The reference has no analog (its FMG bootstraps only
the *linear* pressure solve, ``multigrid.py:562-688``); this is the
nonlinear counterpart, with one compiled program per level.

Staggered warm-start interpolation uses bilinear ``jax.image.resize`` per
field — the reference's ``dx = L/(nx-1)`` convention makes grid ladders
non-nested, and a warm start only needs an O(h^2) approximation.
"""

from __future__ import annotations

from typing import List, Tuple

import jax
import jax.numpy as jnp

from ..core.bc import BoundaryConditions, apply_velocity_bcs
from ..core.fluid import FluidProperties
from ..core.mesh import StructuredMesh
from ..core.state import FlowState, initialize_state


def coarsen_size(nx: int) -> int:
    """One ladder step preserving grid parity: 2^k -> 2^(k-1),
    2^k - 1 -> 2^(k-1) - 1."""
    return nx // 2 if nx % 2 == 0 else (nx - 1) // 2


def build_ladder(nx: int, *, coarsest: int = 32, max_levels: int = 6) -> List[int]:
    """Fine-to-coarse ladder [nx, nx/2, ...] down to ~``coarsest``."""
    ladder = [nx]
    while len(ladder) < max_levels and coarsen_size(ladder[-1]) >= coarsest:
        ladder.append(coarsen_size(ladder[-1]))
    return ladder


def prolong_state(state: FlowState, mesh_fine: StructuredMesh,
                  bc: BoundaryConditions) -> FlowState:
    """Interpolate a staggered state to a finer mesh (bilinear), then
    re-apply velocity BCs."""
    u = jax.image.resize(state.u, mesh_fine.u_shape, method="linear")
    v = jax.image.resize(state.v, mesh_fine.v_shape, method="linear")
    p = jax.image.resize(state.p, mesh_fine.p_shape, method="linear")
    u, v = apply_velocity_bcs(u, v, bc)
    return FlowState(u=u, v=v, p=p)


def reynolds_continuation_solve(
    mesh: StructuredMesh,
    reynolds_schedule,
    bc: BoundaryConditions,
    solve_fn,
    cfg,
    *,
    momentum,
    pressure,
    loop: str = "auto",
    state: FlowState = None,
    density: float = 1.0,
    per_re_cfg=None,
) -> Tuple[FlowState, object, list]:
    """Continuation in Reynolds number: solve at each Re in the schedule,
    warm-starting from the previous converged state.

    High-Re cavity states are hard to reach from rest (the reference's
    Re=7500/10000 runs at 511^2 never converged —
    ``results/notConverged/511/``); tracking the solution branch upward in
    Re converges where cold starts stall.  ``per_re_cfg`` optionally maps
    Re -> algorithm config (e.g. smaller relaxation factors at high Re).
    """
    summaries = []
    diag = None
    for re in reynolds_schedule:
        fluid = FluidProperties(density=density, reynolds_number=re)
        level_cfg = per_re_cfg(re) if per_re_cfg else cfg
        if state is None:
            state = initialize_state(mesh, bc)
        state, diag = solve_fn(mesh, fluid, bc, state, level_cfg,
                               momentum=momentum, pressure=pressure, loop=loop)
        summaries.append(
            dict(reynolds=re, iterations=int(diag.iterations),
                 converged=bool(diag.converged),
                 final_residual=float(diag.final_residual))
        )
    return state, diag, summaries


def sequenced_continuation_solve(
    mesh: StructuredMesh,
    reynolds_schedule,
    bc: BoundaryConditions,
    solve_fn,
    cfg,
    *,
    momentum,
    pressure,
    loop: str = "auto",
    coarsest: int = 32,
    max_levels: int = 6,
    dtype=jnp.float32,
    per_re_cfg=None,
    per_level_cfg=None,
) -> Tuple[FlowState, object, list]:
    """Grid sequencing composed with Reynolds continuation (ROADMAP #8).

    The full Reynolds schedule is walked at the *coarsest* ladder level
    (continuation there is nearly free), then each finer level solves only
    at the target (final) Re, warm-started from the prolonged coarse state.
    This is the high-Re envelope strategy: cold starts at Re >= 7500
    stall/diverge (the reference's ``results/notConverged/511/``), while
    the tracked branch converges level by level.

    ``per_re_cfg(re) -> cfg`` customizes the coarsest-level continuation;
    ``per_level_cfg(nx) -> cfg`` customizes the refinement levels.
    """
    ladder = build_ladder(mesh.nx, coarsest=coarsest, max_levels=max_levels)
    summaries = []
    re_target = reynolds_schedule[-1]

    # coarsest level: walk the Re schedule from rest
    nx_c = ladder[-1]
    coarse_mesh = StructuredMesh(nx=nx_c, ny=nx_c, length=mesh.length,
                                 height=mesh.height)
    state = initialize_state(coarse_mesh, bc, dtype)
    state, diag, cont_summ = reynolds_continuation_solve(
        coarse_mesh, reynolds_schedule, bc, solve_fn, cfg,
        momentum=momentum, pressure=pressure, loop=loop, state=state,
        per_re_cfg=per_re_cfg,
    )
    summaries.append(dict(nx=nx_c, continuation=cont_summ))

    # finer levels: target Re only, warm-started
    fluid = FluidProperties(density=1.0, reynolds_number=re_target)
    for nx in reversed(ladder[:-1]):
        level_mesh = StructuredMesh(nx=nx, ny=nx, length=mesh.length,
                                    height=mesh.height)
        state = prolong_state(state, level_mesh, bc)
        level_cfg = per_level_cfg(nx) if per_level_cfg else cfg
        state, diag = solve_fn(level_mesh, fluid, bc, state, level_cfg,
                               momentum=momentum, pressure=pressure, loop=loop)
        summaries.append(
            dict(nx=nx, reynolds=re_target, iterations=int(diag.iterations),
                 converged=bool(diag.converged),
                 final_residual=float(diag.final_residual))
        )
    return state, diag, summaries


def grid_sequence_solve(
    mesh: StructuredMesh,
    fluid: FluidProperties,
    bc: BoundaryConditions,
    solve_fn,
    cfg,
    *,
    momentum,
    pressure,
    loop: str = "auto",
    coarsest: int = 32,
    max_levels: int = 6,
    dtype=jnp.float32,
    per_level_momentum=None,
) -> Tuple[FlowState, object, list]:
    """Solve on a coarse-to-fine mesh ladder, warm-starting each level.

    ``solve_fn`` is one of the algorithm entry points (e.g.
    ``algorithms.simple.simple_solve``); ``cfg`` applies at every level
    (coarse levels are cheap).  ``per_level_momentum`` optionally maps
    nx -> momentum config — after a warm start the fine-level momentum
    system barely changes, so a lighter inner solve (fewer Krylov
    iterations / looser tolerance) can be used there (ROADMAP "momentum-
    lite").  Returns the fine state, the fine-level diagnostics, and a
    per-level summary list.
    """
    ladder = build_ladder(mesh.nx, coarsest=coarsest, max_levels=max_levels)
    summaries = []
    state = None
    diag = None
    for nx in reversed(ladder):
        level_mesh = StructuredMesh(nx=nx, ny=nx, length=mesh.length,
                                    height=mesh.height)
        if state is None:
            state = initialize_state(level_mesh, bc, dtype)
        else:
            state = prolong_state(state, level_mesh, bc)
        mom = per_level_momentum(nx) if per_level_momentum else momentum
        state, diag = solve_fn(level_mesh, fluid, bc, state, cfg,
                               momentum=mom, pressure=pressure, loop=loop)
        summaries.append(
            dict(nx=nx, iterations=int(diag.iterations),
                 converged=bool(diag.converged),
                 final_residual=float(diag.final_residual))
        )
    return state, diag, summaries
