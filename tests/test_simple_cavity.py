"""End-to-end SIMPLE lid-driven-cavity tests (CPU, small grids).

The physics oracle is convergence itself plus mass conservation and the Ghia
et al. (1982) benchmark — the reference's integration-test strategy
(SURVEY.md §4; drivers in ``main_scripts/``).
"""

import jax.numpy as jnp
import numpy as np
import pytest

import naviflow_tpu as nf
from naviflow_tpu.algorithms import SIMPLEConfig, simple_solve
from naviflow_tpu.postprocessing.validation import (
    infinity_norm_error,
    l2_norm_error,
    validate_against_benchmark,
)
from naviflow_tpu.solvers import (
    JacobiMomentumConfig,
    KrylovMomentumConfig,
    RBGSPressureConfig,
)


def _run(nx=31, re=100, tol=1e-5, max_it=2000, dtype=jnp.float64,
         momentum=None, pressure=None, **cfg_kw):
    mesh = nf.StructuredMesh(nx=nx, ny=nx)
    fluid = nf.FluidProperties(density=1.0, reynolds_number=re)
    bc = nf.lid_driven_cavity(1.0)
    state = nf.initialize_state(mesh, bc, dtype=dtype)
    final, diag = simple_solve(
        mesh, fluid, bc, state,
        SIMPLEConfig(max_iterations=max_it, tolerance=tol, **cfg_kw),
        momentum=momentum or KrylovMomentumConfig(tolerance=1e-10, max_iterations=100),
        pressure=pressure or RBGSPressureConfig(tolerance=1e-7, max_iterations=50000, omega=1.5),
    )
    return mesh, final, diag


def test_cavity_re100_converges_and_conserves_mass():
    mesh, final, diag = _run(nx=31, re=100, tol=1e-5)
    assert bool(diag.converged), f"not converged: {float(diag.final_residual)}"
    assert float(diag.max_divergence) < 1e-8  # consistent operator: machine-level
    # residual histories are monotone-ish decaying
    hist = np.asarray(diag.total_res_history[: int(diag.iterations)])
    assert hist[-1] < 1e-5 and hist[0] > hist[-1]


def test_cavity_re100_ghia_error_reasonable_at_31():
    mesh, final, diag = _run(nx=31, re=100, tol=1e-5)
    # 31^2 power-law: ~12% max centerline error (lid gradient underresolved);
    # the 10% pass threshold is reached at 63^2.
    err = infinity_norm_error(final.u, final.v, mesh, 100)
    assert err < 0.15
    assert l2_norm_error(final.u, final.v, mesh, 100) < 0.06


@pytest.mark.slow
def test_cavity_re100_ghia_passes_at_63():
    mesh, final, diag = _run(nx=63, re=100, tol=1e-4, max_it=1500,
                             dtype=jnp.float64)
    assert bool(diag.converged)
    result = validate_against_benchmark(final.u, final.v, mesh, 100)
    assert result["passed"], result


def test_jacobi_momentum_variant_converges():
    mesh, final, diag = _run(nx=15, re=100, tol=1e-4, max_it=4000,
                             momentum=JacobiMomentumConfig(n_sweeps=2))
    assert bool(diag.converged)


def test_chebyshev_momentum_variant_converges_like_krylov():
    """The reduction-light Chebyshev momentum solve (the large-grid default
    lever, round-5) must reproduce the Krylov-momentum solution: SIMPLE
    re-linearizes every outer step, so an inner solve accurate to ~2 digits
    converges to the same fixed point; we pin both the convergence and the
    final fields."""
    from naviflow_tpu.solvers import ChebyshevMomentumConfig

    mesh, f_cheb, d_cheb = _run(nx=31, re=100, tol=1e-5, max_it=4000,
                                momentum=ChebyshevMomentumConfig(degree=6))
    _, f_kry, d_kry = _run(nx=31, re=100, tol=1e-5, max_it=4000)
    assert bool(d_cheb.converged)
    assert float(jnp.max(jnp.abs(f_cheb.u - f_kry.u))) < 1e-4
    assert float(jnp.max(jnp.abs(f_cheb.v - f_kry.v))) < 1e-4
    # inner-iteration economy must not distort the outer trajectory much
    assert abs(int(d_cheb.iterations) - int(d_kry.iterations)) \
        <= 0.15 * int(d_kry.iterations) + 5


def test_reference_parity_mode_stalls_like_reference():
    """The reference operator + boundary-pressure overwrite floor the outer
    residual near 1e-3 (documented quirk) — verify we reproduce that mode."""
    mesh, final, diag = _run(
        nx=15, re=100, tol=1e-6, max_it=800,
        poisson_variant="reference", overwrite_boundary_pressure=True,
    )
    final_res = float(diag.final_residual)
    assert not bool(diag.converged)
    assert 1e-5 < final_res < 5e-2
