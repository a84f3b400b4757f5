"""Spatial domain decomposition over a device mesh.

The reference has no distributed computing (SURVEY §2.3 — a shell-script job
farm at most).  Here large grids shard across devices:

* a 2-D ``jax.sharding.Mesh`` with axes ``('x', 'y')``;
* staggered fields placed with ``NamedSharding(P('x', 'y'))`` — u, v, p all
  split along both spatial axes;
* the solver code is *unchanged*: every stencil is written as whole-array
  shifted reads (``ops/stencil.py``), so XLA's SPMD partitioner inserts the
  1-cell halo exchanges (collective-permutes over the device interconnect)
  automatically, and every ``jnp.linalg.norm`` / ``jnp.vdot`` reduction
  becomes a cross-device ``psum``.  This is the GSPMD formulation of the
  halo-exchange domain decomposition described in SURVEY §7 step 7.

Tests run on ``--xla_force_host_platform_device_count=8`` virtual CPU
devices; the driver's ``dryrun_multichip`` uses the same entry points.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.state import FlowState


def initialize_pod(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Multi-process (multi-host) bring-up — ROADMAP #11.

    On a multi-host cluster each host runs one process; ``jax.distributed
    .initialize`` wires them into one JAX runtime, after which
    ``jax.devices()`` spans every host and every entry point here
    (``make_device_mesh``, ``distributed_simple_solve``) works unchanged —
    the shard_map code is topology-agnostic.

    Arguments default to the standard env vars
    (``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` /
    ``JAX_PROCESS_ID``).  Returns ``True`` when a
    multi-process runtime was initialized, ``False`` for the single-process
    (single-host) case, where this is a no-op.
    """
    import os

    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if coordinator_address is None and (num_processes or 1) <= 1:
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def make_device_mesh(
    n_devices: Optional[int] = None, shape: Optional[Tuple[int, int]] = None
) -> Mesh:
    """Build a 2-D ('x', 'y') device mesh from the available devices.

    ``shape`` defaults to the most-square factorization of ``n_devices`` so
    halo surface area (interconnect traffic) is minimized.
    """
    devices = jax.devices()[: (n_devices or len(jax.devices()))]
    n = len(devices)
    if shape is None:
        px = int(np.floor(np.sqrt(n)))
        while n % px:
            px -= 1
        shape = (px, n // px)
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} != device count {n}")
    dev_array = np.asarray(devices).reshape(shape)
    return Mesh(dev_array, axis_names=("x", "y"))


def field_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P("x", "y"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(None, None))


def best_effort_sharding(shape, mesh: Mesh) -> NamedSharding:
    """Largest ('x', 'y') spec whose axes divide the array shape.

    Staggered fields have off-by-one shapes ((nx+1, ny) vs (nx, ny+1)), so a
    uniform 2-D NamedSharding cannot apply to all of them at once; axes that
    don't divide are replicated.  The fully sharded multi-chip path is the
    explicit halo-exchange decomposition in ``parallel/decompose.py``."""
    mx, my = mesh.shape["x"], mesh.shape["y"]
    spec = P(
        "x" if shape[0] % mx == 0 else None,
        "y" if shape[1] % my == 0 else None,
    )
    return NamedSharding(mesh, spec)


def shard_state(state: FlowState, mesh: Mesh) -> FlowState:
    """Place the staggered fields with the best dividing ('x', 'y') spec."""
    return FlowState(
        u=jax.device_put(state.u, best_effort_sharding(state.u.shape, mesh)),
        v=jax.device_put(state.v, best_effort_sharding(state.v.shape, mesh)),
        p=jax.device_put(state.p, best_effort_sharding(state.p.shape, mesh)),
    )
