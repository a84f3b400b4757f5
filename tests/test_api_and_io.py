"""OO facade, CLI, exporters, checkpoint, visualization smoke tests (CPU)."""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

import naviflow_tpu as nf
from naviflow_tpu.api import (
    AMGMomentumSolver,
    DirectPressureSolver,
    GaussSeidelSolver,
    JacobiSolver,
    MultiGridSolver,
    GeoMultigridPrecondCGSolver,
    SimpleSolver,
    SimplecSolver,
    StandardVelocityUpdater,
)
from naviflow_tpu import StructuredMesh, FluidProperties


def _reference_style_run(tmp_path, pressure_solver, tol=1e-3, max_it=2000):
    mesh = StructuredMesh(nx=31, ny=31)
    fluid = FluidProperties(density=1.0, reynolds_number=100)
    algo = SimpleSolver(mesh, fluid, pressure_solver, AMGMomentumSolver(),
                        StandardVelocityUpdater(), alpha_p=0.3, alpha_u=0.7)
    algo.set_boundary_condition("top", "velocity", {"u": 1.0})
    return algo, algo.solve(max_iterations=max_it, tolerance=tol,
                            save_profile=True, profile_dir=str(tmp_path))


def test_facade_reference_driver_pattern(tmp_path):
    algo, result = _reference_style_run(tmp_path, JacobiSolver(tolerance=1e-5))
    assert result.converged and result.iterations > 0
    assert algo.get_max_divergence() < 1e-4
    assert os.path.exists(tmp_path / "SIMPLE_Re100_mesh31x31_profile.h5")
    # histories present with reference names
    for name in ("u_rel_norm", "v_rel_norm", "p_rel_norm", "total_rel_norm"):
        assert result.get_history(name) is not None


@pytest.mark.parametrize("solver_fn", [
    lambda: GaussSeidelSolver(tolerance=1e-5),
    lambda: MultiGridSolver(tolerance=1e-4, cycle_type="v"),
    lambda: GeoMultigridPrecondCGSolver(tolerance=1e-7),
    lambda: DirectPressureSolver(),
])
def test_facade_pressure_solver_zoo(tmp_path, solver_fn):
    _, result = _reference_style_run(tmp_path, solver_fn(), tol=1e-3, max_it=1200)
    assert result.converged


def test_simplec_facade(tmp_path):
    mesh = StructuredMesh(nx=15, ny=15)
    fluid = FluidProperties(density=1.0, reynolds_number=100)
    algo = SimplecSolver(mesh, fluid, GaussSeidelSolver(tolerance=1e-6),
                         AMGMomentumSolver(), alpha_p=0.2)
    algo.set_boundary_condition("top", "velocity", {"u": 1.0})
    result = algo.solve(max_iterations=2500, tolerance=1e-5)
    assert result.converged


def test_exporters_and_plots(tmp_path):
    from naviflow_tpu.io import exporters
    from naviflow_tpu.postprocessing.visualization import (
        plot_combined_results_matrix,
        plot_final_residuals,
        plot_streamlines,
        plot_velocity_field,
    )

    algo, result = _reference_style_run(tmp_path, JacobiSolver(tolerance=1e-5),
                                        tol=1e-3, max_it=800)
    f1 = exporters.export_vtk(result, str(tmp_path / "out.vtk"))
    assert "STRUCTURED_POINTS" in open(f1).read()[:200]
    f2 = exporters.export_hdf5(result, str(tmp_path / "out.h5"))
    import h5py

    with h5py.File(f2) as f:
        assert f["p"].shape == (31, 31)
    assert os.path.exists(
        plot_combined_results_matrix(result, str(tmp_path / "combined.png"))
    )
    assert os.path.exists(plot_final_residuals(result, str(tmp_path / "resid.png")))
    assert os.path.exists(
        plot_velocity_field(result.u, result.v, result.mesh, str(tmp_path / "vel.png"))
    )
    assert os.path.exists(
        plot_streamlines(result.u, result.v, result.mesh, str(tmp_path / "stream.png"))
    )


def test_checkpoint_roundtrip(tmp_path):
    from naviflow_tpu.io.checkpoint import load_checkpoint, save_checkpoint

    mesh = nf.StructuredMesh(nx=15, ny=15)
    bc = nf.lid_driven_cavity(1.0)
    state = nf.initialize_state(mesh, bc)
    path = save_checkpoint(str(tmp_path / "ckpt"), state, iteration=42,
                           histories={"total": np.arange(5.0)})
    state2, it, hist, _ = load_checkpoint(path)
    assert it == 42
    np.testing.assert_array_equal(np.asarray(state2.u), np.asarray(state.u))
    np.testing.assert_array_equal(np.asarray(hist["total"]), np.arange(5.0))


def test_cli_run(tmp_path):
    # the child pins the CPU through the config update as well, so the
    # test is hermetic whatever accelerators the machine has
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    argv = ["run", "--nx", "15",
            "--re", "100", "--pressure", "rbgs", "--momentum", "jacobi",
            "--tolerance", "1e-3", "--max-iterations", "2000",
            "--pressure-tol", "1e-6", "--loop", "fused",
            "--save", str(tmp_path / "sol.npz")]
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys, jax; jax.config.update('jax_platforms', 'cpu'); "
         "from naviflow_tpu.cli import main; sys.exit(main(sys.argv[1:]))",
         *argv],
        capture_output=True, text=True, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert out.returncode == 0, out.stderr[-2000:]
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["converged"] is True
    assert os.path.exists(tmp_path / "sol.npz")
