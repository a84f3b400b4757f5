"""naviflow_tpu — a JAX structured-grid finite-volume CFD framework.

A ground-up JAX/XLA rebuild of the capabilities of the reference NaviFlow
package (steady incompressible Navier–Stokes on a 2-D staggered grid,
SIMPLE-family pressure–velocity coupling, a matrix-free linear-solver zoo,
geometric multigrid, and Ghia et al. (1982) lid-driven-cavity validation) —
architected for accelerators: functional pytree state, whole-solve
``jax.jit`` + ``lax.while_loop`` stepping, fused stencil kernels, and
``shard_map`` spatial domain decomposition over device meshes.
"""

from .core.mesh import StructuredMesh
from .core.fluid import FluidProperties
from .core.bc import (
    BoundaryConditions,
    BoundaryLocation,
    BoundaryType,
    SideCondition,
    lid_driven_cavity,
)
from .core.state import FlowState, ScalarField, VectorField, initialize_state

__version__ = "0.1.0"

__all__ = [
    "StructuredMesh",
    "FluidProperties",
    "BoundaryConditions",
    "BoundaryLocation",
    "BoundaryType",
    "SideCondition",
    "lid_driven_cavity",
    "FlowState",
    "ScalarField",
    "VectorField",
    "initialize_state",
]
