"""Lagged Galerkin coarse-hierarchy carry, shared by all SIMPLE-family
algorithms.

With ``MultigridConfig(coarse_rebuild_every=K > 1)`` the coarse Galerkin
operators (the RAP build) are rebuilt only every K outer iterations and
carried across iterations in the algorithm's ``extra`` pytree.  The *fine*
operator is always assembled from the current d-coefficients, so the
pressure solve's fixed point is the exact solution of the current system;
staleness only affects the coarse-grid error-correction rate (and in
practice barely that — the d-fields drift slowly near convergence).

The rebuild is not a per-step ``lax.cond`` on ``age % K``: a conditional
inside the while loop can cost much of the untaken branch.  The cadence is
static, so the harness runs an
unconditional *refresh step* (built with ``coarse_mode='rebuild'``) as the
first iteration of every K-iteration block and the plain step
(``coarse_mode='carry'``) for the rest — same trajectories (the rebuild
still uses the refresh iteration's own d-coefficients), no conditional.
See ``base.run_outer_loop(refresh_step=..., refresh_every=K)``.

Not applicable to ``smoother='chebyshev'`` (its per-level spectral bounds
are not carried); those configs silently rebuild every iteration.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp


class LaggedMG(NamedTuple):
    """``rebuild(d_u, d_v) -> coarse`` unconditionally builds the coarse
    stencil tuple; ``solve(b, pc, d_u, d_v, p_like, coarse)`` runs the
    multigrid solve on [fresh fine level] + [given coarse levels];
    ``extra0(dtype, nx, ny) -> (age0, coarse0)`` is the structural
    placeholder carry (the harness's refresh step replaces it on the first
    iteration)."""

    rebuild: Callable
    solve: Callable
    extra0: Callable


def uses_lagged_mg(pres_cfg) -> bool:
    return (
        getattr(pres_cfg, "kind", "") == "multigrid"
        and getattr(pres_cfg, "coarse_rebuild_every", 1) > 1
        and getattr(pres_cfg, "smoother", "gs") != "chebyshev"
    )


def make_lagged_mg(pres_cfg, *, dx, dy, rho, variant) -> LaggedMG:
    """Build the lagged-hierarchy protocol pieces (see :class:`LaggedMG`).

    ``mg_extra`` convention: ``(age: int32, coarse: tuple[Stencil9, ...])``;
    algorithms advance it as ``(age + 1, coarse)`` where ``coarse`` is
    ``rebuild(d_u, d_v)`` in a refresh step and the carried tuple otherwise.
    (``age`` is retained for diagnostics; the rebuild cadence is owned by
    the loop harness.)
    """
    from ..ops.stencil9 import from_poisson
    from ..solvers.multigrid import build_levels, coarse_stencils, multigrid_solve

    def rebuild(d_u, d_v):
        return coarse_stencils(
            build_levels(d_u, d_v, pres_cfg, dx=dx, dy=dy, rho=rho,
                         variant=variant)
        )

    def solve(b, pc, d_u, d_v, p_like, coarse):
        fine_st = from_poisson(pc)
        levels = [(fine_st, fine_st.c.shape, True, None)] + [
            (st, st.c.shape, False, None) for st in coarse
        ]
        return multigrid_solve(
            b, d_u, d_v, jnp.zeros_like(p_like), pres_cfg,
            dx=dx, dy=dy, rho=rho, variant=variant, levels=levels,
        )

    def extra0(dt, nx, ny):
        d_u0 = jnp.ones((nx + 1, ny), dt) * dy
        d_v0 = jnp.ones((nx, ny + 1), dt) * dx
        # jit: run eagerly, the RAP chain is hundreds of op-by-op
        # dispatch compiles, against one program (inlines when traced)
        return (jnp.asarray(0, jnp.int32), jax.jit(rebuild)(d_u0, d_v0))

    return LaggedMG(rebuild=rebuild, solve=solve, extra0=extra0)
