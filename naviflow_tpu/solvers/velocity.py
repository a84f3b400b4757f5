"""Velocity corrector: u = u* + d_u (p'_W - p'_P), v = v* + d_v (p'_S - p'_P).

JAX rebuild of the reference ``StandardVelocityUpdater``
(``naviflow_oo/solver/velocity_solver/standard.py:10-69``): interior staggered
nodes are corrected with the pressure-correction gradient scaled by the
momentum d-coefficients, then velocity BCs are re-applied.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..core.bc import BoundaryConditions, apply_velocity_bcs
from ..ops.stencil import interior_mask


def update_velocity(u_star, v_star, p_prime, d_u, d_v, bc: BoundaryConditions):
    nxp1, ny = u_star.shape
    nx = nxp1 - 1

    # u correction on i in [1, nx-1], j in [1, ny-2]
    grad_u = jnp.pad(p_prime[:-1, :] - p_prime[1:, :], ((1, 1), (0, 0)))
    u = jnp.where(
        interior_mask(u_star.shape, 1, 1, 1, 1), u_star + d_u * grad_u, u_star
    )

    # v correction on i in [1, nx-2], j in [1, ny-1]
    grad_v = jnp.pad(p_prime[:, :-1] - p_prime[:, 1:], ((0, 0), (1, 1)))
    v = jnp.where(
        interior_mask(v_star.shape, 1, 1, 1, 1), v_star + d_v * grad_v, v_star
    )

    return apply_velocity_bcs(u, v, bc)
