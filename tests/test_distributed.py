"""Distributed SIMPLE on an 8-device virtual CPU mesh vs single-device."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import naviflow_tpu as nf
from naviflow_tpu.algorithms import SIMPLEConfig, simple_solve
from naviflow_tpu.parallel.decompose import (
    Decomp,
    from_blocked_u,
    from_blocked_v,
    to_blocked_u,
    to_blocked_v,
)
from naviflow_tpu.parallel.dist_simple import (
    DistributedConfig,
    distributed_simple_solve,
)
from naviflow_tpu.parallel.sharding import make_device_mesh
from naviflow_tpu.postprocessing.validation import infinity_norm_error
from naviflow_tpu.solvers import JacobiMomentumConfig, CGPressureConfig

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


def test_blocked_layout_roundtrip():
    nx = ny = 16
    u = jnp.asarray(np.random.default_rng(0).normal(size=(nx + 1, ny)))
    v = jnp.asarray(np.random.default_rng(1).normal(size=(nx, ny + 1)))
    ub = to_blocked_u(u, 4)
    assert ub.shape == (4 * 5, ny)
    np.testing.assert_array_equal(np.asarray(from_blocked_u(ub, 4)), np.asarray(u))
    vb = to_blocked_v(v, 2)
    assert vb.shape == (nx, 2 * 9)
    np.testing.assert_array_equal(np.asarray(from_blocked_v(vb, 2)), np.asarray(v))


def test_distributed_simple_matches_single_device():
    """One full solve on a 2x4 mesh must converge to the single-device
    solution (same discrete problem, same physics)."""
    nx = ny = 32  # divisible by the mesh; MG not needed here
    mesh = nf.StructuredMesh(nx=nx, ny=ny)
    fluid = nf.FluidProperties(density=1.0, reynolds_number=100)
    bc = nf.lid_driven_cavity(1.0)
    state = nf.initialize_state(mesh, bc, dtype=jnp.float64)

    dmesh = make_device_mesh(8)  # (2, 4)
    final_d, diag_d = distributed_simple_solve(
        mesh, fluid, bc, state, dmesh,
        DistributedConfig(max_iterations=3000, tolerance=1e-5,
                          momentum_sweeps=2, pressure_solver="cg",
                          pressure_tol=1e-8, pressure_max_iter=4000),
    )
    assert diag_d["converged"], diag_d["final_residual"]

    final_s, diag_s = simple_solve(
        mesh, fluid, bc, state,
        SIMPLEConfig(max_iterations=3000, tolerance=1e-5),
        momentum=JacobiMomentumConfig(n_sweeps=2),
        pressure=CGPressureConfig(tolerance=1e-8, max_iterations=4000),
        loop="fused",
    )
    assert bool(diag_s.converged)

    # same converged flow field (both stopped at outer tol 1e-5, so the
    # fields each sit O(tol) from the common fixed point)
    du = float(jnp.max(jnp.abs(final_d.u - final_s.u)))
    dv = float(jnp.max(jnp.abs(final_d.v - final_s.v)))
    assert du < 3e-4 and dv < 3e-4, (du, dv)

    # physics sanity on the distributed result
    assert infinity_norm_error(final_d.u, final_d.v, mesh, 100) < 0.15


def test_distributed_mgcg_pressure_converges():
    """Fully distributed multigrid-CG: sharded Galerkin levels down to the
    gather cutoff + replicated tail (parallel/dist_mg.py)."""
    nx = ny = 32
    mesh = nf.StructuredMesh(nx=nx, ny=ny)
    fluid = nf.FluidProperties(density=1.0, reynolds_number=100)
    bc = nf.lid_driven_cavity(1.0)
    state = nf.initialize_state(mesh, bc, dtype=jnp.float64)
    dmesh = make_device_mesh(8)
    final, diag = distributed_simple_solve(
        mesh, fluid, bc, state, dmesh,
        DistributedConfig(max_iterations=2500, tolerance=1e-4,
                          pressure_solver="mgcg",
                          pressure_tol=1e-8, pressure_max_iter=40),
    )
    assert diag["converged"], diag["final_residual"]
    assert infinity_norm_error(final.u, final.v, mesh, 100) < 0.15


def test_distributed_rbgs_pressure_converges():
    nx = ny = 16
    mesh = nf.StructuredMesh(nx=nx, ny=ny)
    fluid = nf.FluidProperties(density=1.0, reynolds_number=100)
    bc = nf.lid_driven_cavity(1.0)
    state = nf.initialize_state(mesh, bc, dtype=jnp.float64)
    dmesh = make_device_mesh(4, shape=(2, 2))
    final, diag = distributed_simple_solve(
        mesh, fluid, bc, state, dmesh,
        DistributedConfig(max_iterations=4000, tolerance=1e-4,
                          momentum_sweeps=2, pressure_solver="rbgs",
                          pressure_tol=1e-7, pressure_max_iter=20000),
    )
    assert diag["converged"], diag["final_residual"]


def test_distributed_quick_coefficients_match_global():
    """Windowed 9-point QUICK assembly through the real 2-ring halo
    exchange == the global assembly."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from naviflow_tpu.ops.highorder import (
        u_momentum_coefficients9, v_momentum_coefficients9)
    from naviflow_tpu.ops.windowed import (
        u_coefficients9_window, v_coefficients9_window)
    from naviflow_tpu.parallel.decompose import (
        extend_p2, extend_u2, extend_v2)

    nx = ny = 16
    rng = np.random.default_rng(21)
    u = rng.normal(size=(nx + 1, ny))
    v = rng.normal(size=(nx, ny + 1))
    u[0, :] = u[nx, :] = 0.0
    u[:, 0] = 0.0
    u[:, ny - 1] = 1.0
    v[0, :] = v[nx - 1, :] = 0.0
    v[:, 0] = v[:, ny] = 0.0
    p = rng.normal(size=(nx, ny))
    u, v, p = map(jnp.asarray, (u, v, p))
    kw = dict(dx=1.0 / (nx - 1), dy=1.0 / (ny - 1), rho=1.0, mu=0.01)

    dmesh = make_device_mesh(8)  # (2, 4)
    mx, my = dmesh.shape["x"], dmesh.shape["y"]
    dec = Decomp(nx=nx, ny=ny, mx=mx, my=my)

    def local(u_blk, v_blk, p_blk):
        gi0 = jax.lax.axis_index("x") * dec.nxl
        gj0 = jax.lax.axis_index("y") * dec.nyl
        u2 = extend_u2(u_blk, dec)
        v2 = extend_v2(v_blk, dec)
        p2 = extend_p2(p_blk, dec)
        cu = u_coefficients9_window(u2, v2, p2, gi0=gi0, gj0=gj0,
                                    nx=nx, ny=ny, scheme="quick", **kw)
        cv = v_coefficients9_window(u2, v2, p2, gi0=gi0, gj0=gj0,
                                    nx=nx, ny=ny, scheme="quick", **kw)
        return cu, cv

    fn = jax.jit(shard_map(
        local, mesh=dmesh, in_specs=(P("x", "y"),) * 3,
        out_specs=(P("x", "y"), P("x", "y")), check_vma=False,
    ))
    cu_blk, cv_blk = fn(to_blocked_u(u, mx), to_blocked_v(v, my), p)

    gu = u_momentum_coefficients9(u, v, p, scheme="quick", **kw)
    gv = v_momentum_coefficients9(u, v, p, scheme="quick", **kw)
    names = ("a_e", "a_w", "a_n", "a_s", "a_ee", "a_ww", "a_nn", "a_ss",
             "a_p", "src")
    for name in names:
        np.testing.assert_allclose(
            np.asarray(from_blocked_u(getattr(cu_blk, name), mx)),
            np.asarray(getattr(gu, name)),
            rtol=1e-13, atol=1e-15, err_msg=f"u {name}")
        np.testing.assert_allclose(
            np.asarray(from_blocked_v(getattr(cv_blk, name), my)),
            np.asarray(getattr(gv, name)),
            rtol=1e-13, atol=1e-15, err_msg=f"v {name}")


@pytest.mark.slow
def test_distributed_quick_solve_matches_single_device():
    """End-to-end distributed SIMPLE with QUICK momentum (2-ring halos)."""
    from naviflow_tpu.algorithms import SIMPLEConfig, simple_solve

    nx = ny = 32
    mesh = nf.StructuredMesh(nx=nx, ny=ny)
    fluid = nf.FluidProperties(density=1.0, reynolds_number=100)
    bc = nf.lid_driven_cavity(1.0)
    state = nf.initialize_state(mesh, bc, dtype=jnp.float64)

    dmesh = make_device_mesh(8)
    final_d, diag_d = distributed_simple_solve(
        mesh, fluid, bc, state, dmesh,
        DistributedConfig(max_iterations=4000, tolerance=1e-5,
                          momentum_sweeps=2, scheme="quick",
                          pressure_solver="cg",
                          pressure_tol=1e-8, pressure_max_iter=4000),
    )
    assert diag_d["converged"], diag_d["final_residual"]

    final_s, diag_s = simple_solve(
        mesh, fluid, bc, state,
        SIMPLEConfig(max_iterations=4000, tolerance=1e-5),
        momentum=JacobiMomentumConfig(n_sweeps=2, scheme="quick"),
        pressure=CGPressureConfig(tolerance=1e-8, max_iterations=4000),
        loop="fused",
    )
    assert bool(diag_s.converged)
    du = float(jnp.max(jnp.abs(final_d.u - final_s.u)))
    dv = float(jnp.max(jnp.abs(final_d.v - final_s.v)))
    assert du < 3e-4 and dv < 3e-4, (du, dv)
    assert infinity_norm_error(final_d.u, final_d.v, mesh, 100) < 0.15


def test_initialize_pod_single_process_noop():
    """ROADMAP #11: single-process bring-up is a no-op returning False;
    the mesh entry points work unchanged after it."""
    from naviflow_tpu.parallel.sharding import initialize_pod, make_device_mesh

    assert initialize_pod() is False
    mesh = make_device_mesh(8)
    assert mesh.shape["x"] * mesh.shape["y"] == 8


def test_distributed_bicgstab_momentum_matches_single_device():
    """momentum_solver='bicgstab' (distributed Krylov predictor, psum dots
    with once-counted shared faces) reaches the same fixed point as the
    single-device KrylovMomentumConfig solve."""
    from naviflow_tpu.solvers import KrylovMomentumConfig

    nx = ny = 32
    mesh = nf.StructuredMesh(nx=nx, ny=ny)
    fluid = nf.FluidProperties(density=1.0, reynolds_number=100)
    bc = nf.lid_driven_cavity(1.0)
    state = nf.initialize_state(mesh, bc, dtype=jnp.float64)

    dmesh = make_device_mesh(8)
    final_d, diag_d = distributed_simple_solve(
        mesh, fluid, bc, state, dmesh,
        DistributedConfig(max_iterations=3000, tolerance=1e-5,
                          momentum_solver="bicgstab", momentum_tol=1e-8,
                          momentum_max_iter=30, pressure_solver="cg",
                          pressure_tol=1e-8, pressure_max_iter=4000),
    )
    assert diag_d["converged"], diag_d["final_residual"]

    final_s, diag_s = simple_solve(
        mesh, fluid, bc, state,
        SIMPLEConfig(max_iterations=3000, tolerance=1e-5),
        momentum=KrylovMomentumConfig(tolerance=1e-8, max_iterations=30),
        pressure=CGPressureConfig(tolerance=1e-8, max_iterations=4000),
        loop="fused",
    )
    assert bool(diag_s.converged)
    du = float(jnp.max(jnp.abs(final_d.u - final_s.u)))
    dv = float(jnp.max(jnp.abs(final_d.v - final_s.v)))
    assert du < 3e-4 and dv < 3e-4, (du, dv)
    # Krylov predictor should need fewer outer iterations than 2-sweep
    # Jacobi to hit the same tolerance
    assert diag_d["iterations"] <= diag_s.iterations * 1.2


@pytest.mark.slow
def test_distributed_nondivisible_grid_matches_single_device():
    """30^2 on a (2, 4) mesh — 30 % 4 != 0, so the y layout is zero-padded
    to 32 and masked (round-2 verdict item #7: grids no longer need to
    divide the device mesh).  Padded cells must not perturb the solution:
    same fixed point as the single-device solve."""
    nx = ny = 30
    mesh = nf.StructuredMesh(nx=nx, ny=ny)
    fluid = nf.FluidProperties(density=1.0, reynolds_number=100)
    bc = nf.lid_driven_cavity(1.0)
    state = nf.initialize_state(mesh, bc, dtype=jnp.float64)

    dmesh = make_device_mesh(8)  # (2, 4)
    final_d, diag_d = distributed_simple_solve(
        mesh, fluid, bc, state, dmesh,
        DistributedConfig(max_iterations=3000, tolerance=1e-5,
                          momentum_sweeps=2, pressure_solver="cg",
                          pressure_tol=1e-8, pressure_max_iter=4000),
    )
    assert diag_d["converged"], diag_d["final_residual"]
    assert final_d.u.shape == (nx + 1, ny)
    assert final_d.v.shape == (nx, ny + 1)
    assert final_d.p.shape == (nx, ny)

    final_s, diag_s = simple_solve(
        mesh, fluid, bc, state,
        SIMPLEConfig(max_iterations=3000, tolerance=1e-5),
        momentum=JacobiMomentumConfig(n_sweeps=2),
        pressure=CGPressureConfig(tolerance=1e-8, max_iterations=4000),
        loop="fused",
    )
    assert bool(diag_s.converged)
    du = float(jnp.max(jnp.abs(final_d.u - final_s.u)))
    dv = float(jnp.max(jnp.abs(final_d.v - final_s.v)))
    assert du < 3e-4 and dv < 3e-4, (du, dv)


@pytest.mark.slow
def test_distributed_nondivisible_multigrid_pressure():
    """Multigrid pressure solvers on a padded (non-divisible) grid: the
    hierarchy runs on the padded tiling with the fine stencil's padded
    rows zeroed, so padding stays exactly zero down the whole Galerkin
    ladder (ROADMAP open #3).  30^2 on the (2,4) mesh, mgcg and
    FMG-bootstrapped standalone multigrid."""
    nx = ny = 30
    mesh = nf.StructuredMesh(nx=nx, ny=ny)
    fluid = nf.FluidProperties(density=1.0, reynolds_number=100)
    bc = nf.lid_driven_cavity(1.0)
    state = nf.initialize_state(mesh, bc, dtype=jnp.float64)
    dmesh = make_device_mesh(8)
    for solver, inner in (("mgcg", 60), ("fmg", 40)):
        final, diag = distributed_simple_solve(
            mesh, fluid, bc, state, dmesh,
            DistributedConfig(max_iterations=3000, tolerance=1e-4,
                              momentum_sweeps=2, pressure_solver=solver,
                              pressure_tol=1e-8, pressure_max_iter=inner,
                              gather_cutoff=8),
        )
        assert diag["converged"], (solver, diag["final_residual"])
        assert infinity_norm_error(final.u, final.v, mesh, 100) < 0.15


@pytest.mark.slow
def test_distributed_simplec_matches_single_device():
    """algorithm='simplec' (consistent d-coefficients, max-abs change
    residuals, dynamic alpha_p aux carry) reaches the single-device
    SIMPLEC fixed point (round-2 verdict item #7)."""
    from naviflow_tpu.algorithms import SIMPLECConfig, simplec_solve

    nx = ny = 32
    mesh = nf.StructuredMesh(nx=nx, ny=ny)
    fluid = nf.FluidProperties(density=1.0, reynolds_number=100)
    bc = nf.lid_driven_cavity(1.0)
    state = nf.initialize_state(mesh, bc, dtype=jnp.float64)

    dmesh = make_device_mesh(8)
    final_d, diag_d = distributed_simple_solve(
        mesh, fluid, bc, state, dmesh,
        DistributedConfig(max_iterations=3000, tolerance=1e-5,
                          algorithm="simplec", alpha_p=0.2,
                          momentum_sweeps=2, pressure_solver="cg",
                          pressure_tol=1e-8, pressure_max_iter=4000),
    )
    assert diag_d["converged"], diag_d["final_residual"]

    final_s, diag_s = simplec_solve(
        mesh, fluid, bc, state,
        SIMPLECConfig(max_iterations=3000, tolerance=1e-5),
        momentum=JacobiMomentumConfig(n_sweeps=2),
        pressure=CGPressureConfig(tolerance=1e-8, max_iterations=4000),
        loop="fused",
    )
    assert bool(diag_s.converged)
    du = float(jnp.max(jnp.abs(final_d.u - final_s.u)))
    dv = float(jnp.max(jnp.abs(final_d.v - final_s.v)))
    assert du < 3e-4 and dv < 3e-4, (du, dv)
    assert infinity_norm_error(final_d.u, final_d.v, mesh, 100) < 0.15


@pytest.mark.slow
def test_distributed_piso_matches_single_device():
    """algorithm='piso' (n_corrections pressure passes with Jacobi
    corrector re-solves) reaches the single-device PISO fixed point."""
    from naviflow_tpu.algorithms import PISOConfig, piso_solve

    nx = ny = 32
    mesh = nf.StructuredMesh(nx=nx, ny=ny)
    fluid = nf.FluidProperties(density=1.0, reynolds_number=100)
    bc = nf.lid_driven_cavity(1.0)
    state = nf.initialize_state(mesh, bc, dtype=jnp.float64)

    dmesh = make_device_mesh(8)
    final_d, diag_d = distributed_simple_solve(
        mesh, fluid, bc, state, dmesh,
        DistributedConfig(max_iterations=3000, tolerance=1e-5,
                          algorithm="piso", n_corrections=2,
                          corrector_sweeps=1,
                          momentum_sweeps=2, pressure_solver="cg",
                          pressure_tol=1e-8, pressure_max_iter=4000),
    )
    assert diag_d["converged"], diag_d["final_residual"]

    final_s, diag_s = piso_solve(
        mesh, fluid, bc, state,
        PISOConfig(max_iterations=3000, tolerance=1e-5, n_corrections=2,
                   corrector_sweeps=1),
        momentum=JacobiMomentumConfig(n_sweeps=2),
        pressure=CGPressureConfig(tolerance=1e-8, max_iterations=4000),
        loop="fused",
    )
    assert bool(diag_s.converged)
    du = float(jnp.max(jnp.abs(final_d.u - final_s.u)))
    dv = float(jnp.max(jnp.abs(final_d.v - final_s.v)))
    assert du < 3e-4 and dv < 3e-4, (du, dv)
    assert infinity_norm_error(final_d.u, final_d.v, mesh, 100) < 0.15


def test_chunked_fused_loop_matches_per_step():
    """``loop='chunked'`` (check_every steps fused into one program with
    donated carries, round-2 verdict weak #4) must produce the SAME
    trajectory as the round-2 one-program-per-step loop: identical
    iteration counts and bit-level-identical fields (the shard-local step
    body is the same trace, merely wrapped in a ``lax.fori_loop``)."""
    nx = ny = 32
    mesh = nf.StructuredMesh(nx=nx, ny=ny)
    fluid = nf.FluidProperties(density=1.0, reynolds_number=100)
    bc = nf.lid_driven_cavity(1.0)
    state = nf.initialize_state(mesh, bc, dtype=jnp.float64)
    dmesh = make_device_mesh(8)
    cfg = DistributedConfig(max_iterations=60, tolerance=1e-5,
                            momentum_sweeps=2, pressure_solver="cg",
                            pressure_tol=1e-8, pressure_max_iter=2000,
                            check_every=20)
    out = {}
    for loop in ("chunked", "per-step"):
        final, diag = distributed_simple_solve(
            mesh, fluid, bc, state, dmesh, cfg, loop=loop)
        out[loop] = (final, diag)
    fc, dc = out["chunked"]
    fp, dp = out["per-step"]
    assert dc["iterations"] == dp["iterations"]
    assert dc["residual_history"] == pytest.approx(dp["residual_history"],
                                                   rel=1e-12)
    np.testing.assert_allclose(np.asarray(fc.u), np.asarray(fp.u),
                               rtol=0, atol=1e-13)
    np.testing.assert_allclose(np.asarray(fc.p), np.asarray(fp.p),
                               rtol=0, atol=1e-13)


def test_cli_distributed_run(capsys):
    """CLI --distributed surface: runs the shard_map solve over the local
    devices and prints the JSON summary with the device-mesh layout."""
    import json as _json

    from naviflow_tpu.cli import main

    rc = main(["run", "--nx", "24", "--re", "100", "--distributed",
               "--tolerance", "1e-3", "--pressure", "cg",
               "--momentum", "jacobi", "--max-iterations", "1500"])
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()[-1]
    summary = _json.loads(out)
    assert summary["distributed"] is True
    assert summary["converged"]
    assert summary["device_mesh"] == {"x": 2, "y": 4}


def test_distributed_chebyshev_momentum_matches_single_device():
    """momentum_solver='chebyshev' (halo'd applies, one pmax Gershgorin
    bound per solve) tracks the single-device ChebyshevMomentumConfig
    trajectory: same interval scalars, bit-compatible windowed applies."""
    from naviflow_tpu.solvers import ChebyshevMomentumConfig

    nx = ny = 32
    mesh = nf.StructuredMesh(nx=nx, ny=ny)
    fluid = nf.FluidProperties(density=1.0, reynolds_number=100)
    bc = nf.lid_driven_cavity(1.0)
    state = nf.initialize_state(mesh, bc, dtype=jnp.float64)

    dmesh = make_device_mesh(8)
    final_d, diag_d = distributed_simple_solve(
        mesh, fluid, bc, state, dmesh,
        DistributedConfig(max_iterations=3000, tolerance=1e-5,
                          momentum_solver="chebyshev", momentum_degree=6,
                          pressure_solver="cg",
                          pressure_tol=1e-8, pressure_max_iter=4000),
    )
    assert diag_d["converged"], diag_d["final_residual"]

    final_s, diag_s = simple_solve(
        mesh, fluid, bc, state,
        SIMPLEConfig(max_iterations=3000, tolerance=1e-5),
        momentum=ChebyshevMomentumConfig(degree=6),
        pressure=CGPressureConfig(tolerance=1e-8, max_iterations=4000),
        loop="fused",
    )
    assert bool(diag_s.converged)
    du = float(jnp.max(jnp.abs(final_d.u - final_s.u)))
    dv = float(jnp.max(jnp.abs(final_d.v - final_s.v)))
    assert du < 3e-4 and dv < 3e-4, (du, dv)
    # identical linear algebra on both sides -> iteration counts agree
    # closely (the pressure inner solves differ only in reduction order)
    assert abs(diag_d["iterations"] - diag_s.iterations) <= max(
        2, int(diag_s.iterations * 0.05)), (diag_d["iterations"],
                                            diag_s.iterations)
