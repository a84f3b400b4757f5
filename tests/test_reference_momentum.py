"""Momentum solvers and whole outer steps against float64 references.

* every momentum inner solver — and the pair-batched BiCGSTAB — against a
  dense solve of the masked relaxed system, assembled here by loops;
* one SIMPLE, SIMPLEC, SIMPLER and PISO outer iteration in float32 against
  the same iteration in float64, on an odd (vertex multigrid) and an even
  (cell-centred multigrid) grid.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import naviflow_tpu as nf
from naviflow_tpu.algorithms import (PISOConfig, SIMPLECConfig, SIMPLEConfig,
                                     SIMPLERConfig, piso_solve, simple_solve,
                                     simplec_solve, simpler_solve)
from naviflow_tpu.core.bc import apply_velocity_bcs
from naviflow_tpu.ops.powerlaw import (relax_coefficients,
                                       u_momentum_coefficients,
                                       v_momentum_coefficients)
from naviflow_tpu.solvers import (ChebyshevMomentumConfig,
                                  GMRESMomentumConfig, IDRSMomentumConfig,
                                  JacobiMomentumConfig, KrylovMomentumConfig,
                                  MultigridConfig, RBGSMomentumConfig)
from naviflow_tpu.solvers.momentum import (_bicgstab_masked,
                                           _bicgstab_pair_masked,
                                           _inner_solve, _u_interior_mask,
                                           _v_interior_mask)

NX = 15


def _systems():
    """Relaxed u and v systems of a perturbed cavity state, with the
    velocity boundary values applied.  Diffusion dominates (cell Peclet
    ~0.2): Chebyshev's Gershgorin interval assumes eigenvalues near the
    real axis, and the other solvers converge on any of these systems."""
    mesh = nf.StructuredMesh(nx=NX, ny=NX)
    bc = nf.lid_driven_cavity(1.0)
    rng = np.random.default_rng(5)
    u = jnp.asarray(rng.uniform(-0.3, 0.3, mesh.u_shape))
    v = jnp.asarray(rng.uniform(-0.3, 0.3, mesh.v_shape))
    p = jnp.asarray(rng.uniform(-0.1, 0.1, mesh.p_shape))
    u, v = apply_velocity_bcs(u, v, bc)
    dx, dy = mesh.get_cell_sizes()
    kw = dict(dx=dx, dy=dy, rho=1.0, mu=0.1)
    cu = relax_coefficients(u_momentum_coefficients(u, v, p, **kw), u, 0.7)
    cv = relax_coefficients(v_momentum_coefficients(u, v, p, **kw), v, 0.7)
    return {"u": (u, cu, _u_interior_mask(u.shape)),
            "v": (v, cv, _v_interior_mask(v.shape))}


def _dense_solve(x0, c, mask):
    """Solve a_p x_P - sum(a_nb x_nb) = src on the masked nodes, the others
    held at x0 — assembled node by node."""
    x0 = np.asarray(x0)
    mask = np.asarray(mask)
    a = {k: np.asarray(getattr(c, k)) for k in ("a_e", "a_w", "a_n", "a_s",
                                                 "a_p", "src")}
    nodes = list(zip(*np.nonzero(mask)))
    index = {n: k for k, n in enumerate(nodes)}
    A = np.zeros((len(nodes), len(nodes)))
    b = np.zeros(len(nodes))
    for k, (i, j) in enumerate(nodes):
        A[k, k] = a["a_p"][i, j]
        b[k] = a["src"][i, j]
        for name, (ni, nj) in (("a_e", (i + 1, j)), ("a_w", (i - 1, j)),
                               ("a_n", (i, j + 1)), ("a_s", (i, j - 1))):
            if (ni, nj) in index:
                A[k, index[(ni, nj)]] -= a[name][i, j]
            else:
                b[k] += a[name][i, j] * x0[ni, nj]
    x = x0.copy()
    for n, value in zip(nodes, np.linalg.solve(A, b)):
        x[n] = value
    return x


SOLVERS = {
    "jacobi": JacobiMomentumConfig(n_sweeps=600),
    "rbgs": RBGSMomentumConfig(n_sweeps=300),
    "chebyshev": ChebyshevMomentumConfig(degree=120),
    "bicgstab": KrylovMomentumConfig(tolerance=1e-13, max_iterations=200),
    "gmres": GMRESMomentumConfig(tolerance=1e-13, max_iterations=400,
                                 restart=20),
    "idrs": IDRSMomentumConfig(tolerance=1e-13, max_iterations=200),
}


@pytest.mark.parametrize("field", ["u", "v"])
@pytest.mark.parametrize("kind", sorted(SOLVERS))
def test_momentum_solver_matches_dense(kind, field):
    x0, c, mask = _systems()[field]
    want = _dense_solve(x0, c, mask)
    got = np.asarray(_inner_solve(x0, c, mask, SOLVERS[kind]))
    np.testing.assert_allclose(got, want, atol=1e-9 * np.max(np.abs(want)))


def test_pair_bicgstab_matches_dense_and_sequential():
    s = _systems()
    (xu0, cu, mu), (xv0, cv, mv) = s["u"], s["v"]
    pu, pv = _bicgstab_pair_masked(xu0, cu, mu, xv0, cv, mv, 1e-13, 200)
    for got, (x0, c, m) in ((pu, s["u"]), (pv, s["v"])):
        want = _dense_solve(x0, c, m)
        scale = np.max(np.abs(want))
        np.testing.assert_allclose(np.asarray(got), want, atol=1e-9 * scale)
        seq = _bicgstab_masked(x0, c, m, 1e-13, 200)
        np.testing.assert_allclose(np.asarray(got), np.asarray(seq),
                                   atol=1e-9 * scale)


ALGORITHMS = {
    "simple": (simple_solve, SIMPLEConfig),
    "simplec": (simplec_solve, SIMPLECConfig),
    "simpler": (simpler_solve, SIMPLERConfig),
    "piso": (piso_solve, PISOConfig),
}


@pytest.mark.parametrize("nx", [31, 32])
@pytest.mark.parametrize("algorithm", sorted(ALGORITHMS))
def test_outer_step_float32_matches_float64(algorithm, nx):
    solve, cfg_cls = ALGORITHMS[algorithm]
    mesh = nf.StructuredMesh(nx=nx, ny=nx)
    fluid = nf.FluidProperties(density=1.0, reynolds_number=100)
    bc = nf.lid_driven_cavity(1.0)
    if nx % 2:
        mom = KrylovMomentumConfig(tolerance=1e-6, max_iterations=20)
        pres = MultigridConfig(tolerance=1e-2, max_cycles=6, check_every=2,
                               coarsest_sweeps=8)
    else:
        mom = ChebyshevMomentumConfig(degree=4)
        pres = MultigridConfig(tolerance=0.0, max_cycles=1, pre_smoothing=1,
                               post_smoothing=1, coarsest_sweeps=32)
    out = {}
    for dtype in (jnp.float32, jnp.float64):
        final, _ = solve(mesh, fluid, bc, nf.initialize_state(mesh, bc, dtype),
                         cfg_cls(max_iterations=1, tolerance=0.0),
                         momentum=mom, pressure=pres, loop="fused")
        assert final.u.dtype == dtype
        out[dtype] = final
    for name in ("u", "v", "p"):
        a = np.asarray(getattr(out[jnp.float32], name), np.float64)
        b = np.asarray(getattr(out[jnp.float64], name))
        # float32 roundoff through the Krylov and multigrid recurrences
        np.testing.assert_allclose(a, b, atol=1e-5 * np.max(np.abs(b)))
