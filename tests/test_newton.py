"""Steady Newton–Krylov (JFNK) tests: convergence past the SIMPLE
fixed-point iteration, agreement with the SIMPLE steady state (same
discrete system => same root), and the QUICK scheme path.

Small grids, CPU, f64 (conftest).  The Re >= 7500 capability itself is a
hardware/scale run (benchmarks/scale_runs.py newton mode); these tests pin
the algorithmic contract.
"""

import jax.numpy as jnp
import pytest

import naviflow_tpu as nf
from naviflow_tpu.algorithms import (NewtonConfig, SIMPLEConfig,
                                     newton_solve, simple_solve)
from naviflow_tpu.solvers import KrylovMomentumConfig, RBGSPressureConfig
from naviflow_tpu.solvers.multigrid import MultigridConfig


def _setup(nx=31, re=100):
    mesh = nf.StructuredMesh(nx=nx, ny=nx)
    fluid = nf.FluidProperties(density=1.0, reynolds_number=re)
    bc = nf.lid_driven_cavity(1.0)
    state = nf.initialize_state(mesh, bc, dtype=jnp.float64)
    return mesh, fluid, bc, state


MOM = KrylovMomentumConfig(tolerance=1e-10, max_iterations=100)
PRES = MultigridConfig(tolerance=1e-8, max_cycles=40)


def test_newton_converges_and_matches_simple_fixed_point():
    """From a 30-iteration SIMPLE warm start, Newton must converge the SAME
    discrete system (power-law) far below SIMPLE's stopping point, and land
    on the same steady state."""
    mesh, fluid, bc, state = _setup()

    warm, _ = simple_solve(
        mesh, fluid, bc, state,
        SIMPLEConfig(max_iterations=30, tolerance=0.0),
        momentum=MOM, pressure=PRES, loop="fused")

    final, diag = newton_solve(
        mesh, fluid, bc, warm,
        NewtonConfig(tolerance=1e-10, scheme="power_law", max_newton=25),
    )
    assert diag.converged, diag.residual_history
    # quadratic-phase sanity: far fewer Newton steps than the ~150 SIMPLE
    # iterations this case needs
    assert diag.iterations <= 20, diag.iterations

    # same root as the fully converged SIMPLE run
    ref, rdiag = simple_solve(
        mesh, fluid, bc, state,
        SIMPLEConfig(max_iterations=4000, tolerance=1e-10),
        momentum=MOM, pressure=PRES, loop="fused")
    assert bool(rdiag.converged)
    assert float(jnp.max(jnp.abs(final.u - ref.u))) < 5e-8
    assert float(jnp.max(jnp.abs(final.v - ref.v))) < 5e-8


def test_newton_quick_scheme_converges():
    """QUICK (9-pt) assembly is differentiable end-to-end: Newton drives the
    unrelaxed QUICK momentum norms below tolerance."""
    mesh, fluid, bc, state = _setup(re=400)

    warm, _ = simple_solve(
        mesh, fluid, bc, state,
        SIMPLEConfig(max_iterations=60, tolerance=0.0),
        momentum=KrylovMomentumConfig(tolerance=1e-10, max_iterations=100,
                                      scheme="quick"),
        pressure=PRES, loop="fused")

    final, diag = newton_solve(
        mesh, fluid, bc, warm,
        NewtonConfig(tolerance=1e-9, scheme="quick", max_newton=25),
    )
    assert diag.converged, diag.residual_history
    assert jnp.all(jnp.isfinite(final.u))
    # monotone tail: the line search never accepts an increase
    hist = diag.residual_history
    assert hist[-1] < hist[0]


def test_newton_chunked_gmres_matches_monolithic():
    """``gmres_chunk > 0`` splits the GMRES restart cycles across host
    calls (the bounded-program path for 1023^2+).  A restart cycle is a fresh Arnoldi from the current residual,
    so the chunked solve IS the monolithic solve: same Newton trajectory
    to roundoff, same step count."""
    mesh, fluid, bc, state = _setup()

    warm, _ = simple_solve(
        mesh, fluid, bc, state,
        SIMPLEConfig(max_iterations=30, tolerance=0.0),
        momentum=MOM, pressure=PRES, loop="fused")

    base = NewtonConfig(tolerance=1e-10, scheme="power_law", max_newton=12,
                        gmres_restart=20, gmres_maxiter=60)
    out = {}
    for chunk in (0, 1):
        cfg = NewtonConfig(**{**base.__dict__, "gmres_chunk": chunk})
        _, diag = newton_solve(mesh, fluid, bc, warm, cfg)
        out[chunk] = diag
    assert out[0].converged and out[1].converged
    assert out[0].iterations == out[1].iterations, (
        out[0].residual_history, out[1].residual_history)
    h0 = jnp.asarray(out[0].residual_history)
    h1 = jnp.asarray(out[1].residual_history)
    assert jnp.allclose(h0, h1, rtol=1e-8), (h0, h1)


def test_newton_step_runs_sharded():
    """The Newton residual/Jacobian/preconditioner build composes with the
    distributed path (round-4 verdict #6): the same jitted Newton-step
    program runs on a sharded ``w`` over the full 8-device CPU mesh (GSPMD
    partitions the stencil assembly, the linearization, and the GMRES
    reductions), and must agree with the single-device step."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from naviflow_tpu.algorithms.newton import (_build_newton_step,
                                                _flatten)
    from naviflow_tpu.core.bc import apply_velocity_bcs
    from naviflow_tpu.parallel.sharding import make_device_mesh

    # nx=32 (not 31): device_put rejects uneven 1-D shardings, and the
    # flattened state length 3*nx^2 + 2*nx is 8-divisible for even nx
    mesh, fluid, bc, state = _setup(nx=32)
    warm, _ = simple_solve(
        mesh, fluid, bc, state,
        SIMPLEConfig(max_iterations=30, tolerance=0.0),
        momentum=MOM, pressure=PRES, loop="fused")

    dx, dy = mesh.get_cell_sizes()
    cfg = NewtonConfig(tolerance=1e-10, scheme="power_law",
                       gmres_restart=20, gmres_maxiter=40)
    pres_cfg = MultigridConfig(tolerance=1e-3, max_cycles=12, check_every=4)
    step, _, _ = _build_newton_step(
        warm.u.shape, warm.v.shape, warm.p.shape, dx, dy,
        fluid.get_density(), fluid.get_viscosity(), bc, cfg, pres_cfg)

    u, v = apply_velocity_bcs(warm.u, warm.v, bc)
    w = _flatten(u, v, warm.p)
    damping = jnp.asarray(1.0, w.dtype)
    inv_dtau = jnp.asarray(2.0, w.dtype)

    w1_ref, norm_ref, *_ = step(w, damping, inv_dtau)

    dmesh = make_device_mesh(8, shape=(8, 1))
    w_sh = jax.device_put(w, NamedSharding(dmesh, P("x")))
    w1_sh, norm_sh, *_ = step(w_sh, damping, inv_dtau)

    assert float(jnp.max(jnp.abs(w1_sh - w1_ref))) < 1e-9 * float(
        jnp.max(jnp.abs(w1_ref)) + 1.0)
    assert abs(float(norm_sh) - float(norm_ref)) < 1e-10
