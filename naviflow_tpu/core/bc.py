"""Boundary-condition registry and functional application.

JAX rebuild of ``naviflow_oo/constructor/boundary_conditions.py``.
The typed registry (``BoundaryType`` x ``BoundaryLocation``) is preserved, but
the imperative in-place mutation (``apply_velocity_boundary_conditions``,
reference :164-260) becomes a *pure function* ``apply_velocity_bcs(u, v, bc)``
suitable for use inside ``jax.jit`` / ``lax.while_loop`` bodies.

The configuration itself is a frozen, hashable dataclass: it is trace-time
static, so each distinct BC set compiles its own specialized program with the
boundary constants folded in (no runtime branching).

Semantics preserved exactly (for staggered shapes u=(nx+1,ny), v=(nx,ny+1)):
1. every boundary is first zeroed (wall default);
2. sides registered with a VELOCITY condition overwrite their boundary slab
   with the given (u, v) values:  top -> u[:, ny-1], v[:, ny];
   bottom -> u[:, 0], v[:, 0]; left -> u[0, :], v[0, :];
   right -> u[nx, :], v[nx-1, :].
"""

from __future__ import annotations

import dataclasses
from enum import Enum
from typing import Optional, Tuple

import jax.numpy as jnp

from ..ops.stencil import where_set


class BoundaryType(Enum):
    WALL = "wall"
    VELOCITY = "velocity"
    PRESSURE = "pressure"
    INFLOW = "inflow"
    OUTFLOW = "outflow"
    SYMMETRY = "symmetry"


class BoundaryLocation(Enum):
    TOP = "top"
    BOTTOM = "bottom"
    LEFT = "left"
    RIGHT = "right"


_SIDES = ("top", "bottom", "left", "right")


@dataclasses.dataclass(frozen=True)
class SideCondition:
    """Condition on one side of the domain (static)."""

    kind: BoundaryType = BoundaryType.WALL
    u: float = 0.0
    v: float = 0.0


@dataclasses.dataclass(frozen=True)
class BoundaryConditions:
    """Immutable set of conditions for all four sides.

    Mirrors the reference ``BoundaryConditionManager`` but as a value type.
    Use :meth:`with_condition` to derive modified copies (the OO facade's
    ``set_boundary_condition`` builds these incrementally).
    """

    top: SideCondition = SideCondition()
    bottom: SideCondition = SideCondition()
    left: SideCondition = SideCondition()
    right: SideCondition = SideCondition()

    # ---- construction helpers ---------------------------------------------
    def with_condition(
        self, location, bc_type, values: Optional[dict] = None
    ) -> "BoundaryConditions":
        if isinstance(location, BoundaryLocation):
            location = location.value
        location = location.lower()
        if location not in _SIDES:
            raise ValueError(f"Unknown boundary location: {location}")
        if isinstance(bc_type, str):
            bc_type = BoundaryType(bc_type.lower())
        values = values or {}
        side = SideCondition(
            kind=bc_type, u=float(values.get("u", 0.0)), v=float(values.get("v", 0.0))
        )
        return dataclasses.replace(self, **{location: side})

    def side(self, name: str) -> SideCondition:
        return getattr(self, name)

    def get_boundary_types(self) -> dict:
        """Parity with reference ``get_boundary_types`` (:266-288)."""
        return {s: self.side(s).kind.value for s in _SIDES}

    # ---- functional application -------------------------------------------
    def apply_to_velocity(self, u: jnp.ndarray, v: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
        return apply_velocity_bcs(u, v, self)


def lid_driven_cavity(lid_velocity: float = 1.0) -> BoundaryConditions:
    """Standard lid-driven cavity: moving top lid, no-slip walls elsewhere."""
    return BoundaryConditions().with_condition(
        "top", BoundaryType.VELOCITY, {"u": lid_velocity}
    )


def apply_velocity_bcs(u, v, bc: BoundaryConditions):
    """Pure-functional equivalent of the reference
    ``BoundaryConditionManager.apply_velocity_boundary_conditions``
    (``boundary_conditions.py:164-260``).

    All boundaries are zeroed, then VELOCITY sides are overwritten.  Returns
    new arrays; never mutates.
    """
    nxp1, ny = u.shape
    nx = nxp1 - 1
    dtype = u.dtype

    zero = jnp.asarray(0.0, dtype)

    # Phase 1 — zero every boundary slab (wall default), matching the
    # reference's unconditional zeroing (:180-203).
    u = where_set(where_set(u, zero, cols=0), zero, cols=ny - 1)
    u = where_set(where_set(u, zero, rows=0), zero, rows=nx)
    v = where_set(where_set(v, zero, cols=0), zero, cols=ny)
    v = where_set(where_set(v, zero, rows=0), zero, rows=nx - 1)

    # Phase 2 — sides registered with a VELOCITY condition overwrite their
    # full slab *including corners* (:206-232): e.g. the cavity lid value owns
    # u[0, ny-1] and u[nx, ny-1].
    for name in _SIDES:
        s = bc.side(name)
        if s.kind != BoundaryType.VELOCITY:
            continue
        su = jnp.asarray(s.u, dtype)
        sv = jnp.asarray(s.v, dtype)
        if name == "top":
            u = where_set(u, su, cols=ny - 1)
            v = where_set(v, sv, cols=ny)
        elif name == "bottom":
            u = where_set(u, su, cols=0)
            v = where_set(v, sv, cols=0)
        elif name == "left":
            u = where_set(u, su, rows=0)
            v = where_set(v, sv, rows=0)
        elif name == "right":
            u = where_set(u, su, rows=nx)
            v = where_set(v, sv, rows=nx - 1)
    return u, v


def apply_velocity_bcs_window(u_loc, v_loc, bc: BoundaryConditions, *, gi0, gj0, nx, ny):
    """Window form of :func:`apply_velocity_bcs` for domain-decomposed
    blocks: boundary slabs become masks over global indices.

    ``u_loc``: (nxl+1, nyl) faces gi0.. x cells gj0..; ``v_loc``:
    (nxl, nyl+1).  Identical semantics to the global function (zero all
    boundary slabs, then VELOCITY sides overwrite in top/bottom/left/right
    order, corners owned by the velocity side).
    """
    import jax

    dtype = u_loc.dtype
    GIu = gi0 + jax.lax.broadcasted_iota(jnp.int32, u_loc.shape, 0)
    GJu = gj0 + jax.lax.broadcasted_iota(jnp.int32, u_loc.shape, 1)
    GIv = gi0 + jax.lax.broadcasted_iota(jnp.int32, v_loc.shape, 0)
    GJv = gj0 + jax.lax.broadcasted_iota(jnp.int32, v_loc.shape, 1)

    u_masks = {
        "top": GJu == ny - 1,
        "bottom": GJu == 0,
        "left": GIu == 0,
        "right": GIu == nx,
    }
    v_masks = {
        "top": GJv == ny,
        "bottom": GJv == 0,
        "left": GIv == 0,
        "right": GIv == nx - 1,
    }
    zero = jnp.asarray(0.0, dtype)
    u, v = u_loc, v_loc
    for name in _SIDES:
        u = jnp.where(u_masks[name], zero, u)
        v = jnp.where(v_masks[name], zero, v)
    for name in _SIDES:
        s = bc.side(name)
        if s.kind != BoundaryType.VELOCITY:
            continue
        u = jnp.where(u_masks[name], jnp.asarray(s.u, dtype), u)
        v = jnp.where(v_masks[name], jnp.asarray(s.v, dtype), v)
    return u, v


def enforce_pressure_bcs(p, bc: BoundaryConditions):
    """Zero-gradient (Neumann) pressure boundary enforcement.

    Parity with ``BaseAlgorithm._enforce_pressure_boundary_conditions``
    (``base_algorithm.py:161-197``): each boundary slab copies its first
    interior neighbor.  Applied in top, bottom, left, right order (the
    reference iterates its registry dict; the cavity drivers register 'top'
    first and the remaining walls are appended in this order).
    """
    nx, ny = p.shape
    p = where_set(p, p[:, ny - 2], cols=ny - 1)
    p = where_set(p, p[:, 1], cols=0)
    p = where_set(p, p[1, :], rows=0)
    p = where_set(p, p[nx - 2, :], rows=nx - 1)
    return p
