"""The XLA multigrid pressure path against independent float64 references.

* ``multigrid_solve`` on odd (vertex) and even (cell-centred) grids, for
  every cycle type and smoother, against a dense least-squares solve of the
  loop-assembled symmetric pressure matrix (``tests/golden.py``);
* each Galerkin coarse operator against the explicit dense product R·A·P
  of the level's transfer matrices.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from golden import fortran_flatten, golden_pressure_matrix
from naviflow_tpu.ops.poisson import poisson_coefficients
from naviflow_tpu.ops.stencil9 import apply9, from_poisson
from naviflow_tpu.solvers.multigrid import (MultigridConfig, _level_transfers,
                                            build_levels, multigrid_solve)


def _d_fields(nx, seed):
    rng = np.random.default_rng(seed)
    d_u = rng.uniform(0.5, 1.5, (nx + 1, nx))
    d_v = rng.uniform(0.5, 1.5, (nx, nx + 1))
    return d_u, d_v


def _dense(fn, shape_in, n_out):
    """Dense matrix of a linear map of 2-D fields (Fortran numbering)."""
    n_in = shape_in[0] * shape_in[1]
    cols = []
    for k in range(n_in):
        e = np.zeros(n_in)
        e[k] = 1.0
        x = e.reshape(shape_in, order="F")
        cols.append(fortran_flatten(np.asarray(fn(jnp.asarray(x)))))
    out = np.stack(cols, axis=1)
    assert out.shape == (n_out, n_in)
    return out


@pytest.mark.parametrize("nx", [31, 32])
@pytest.mark.parametrize("cycle", ["v", "w", "fmg"])
@pytest.mark.parametrize("smoother", ["gs", "jacobi", "chebyshev"])
def test_multigrid_solve_matches_dense(nx, cycle, smoother):
    d_u, d_v = _d_fields(nx, seed=nx)
    h = 1.0 / nx
    A = golden_pressure_matrix(d_u, d_v, h, h, 1.0, pin=False,
                               variant="symmetric")
    rng = np.random.default_rng(7)
    b = A @ rng.standard_normal(nx * nx)  # compatible right-hand side
    want = np.linalg.lstsq(A, b, rcond=None)[0]  # minimum norm = zero mean
    cfg = MultigridConfig(tolerance=1e-11, max_cycles=400, cycle_type=cycle,
                          smoother=smoother, coarsest_sweeps=64)
    p, info = multigrid_solve(
        jnp.asarray(b.reshape(nx, nx, order="F")), jnp.asarray(d_u),
        jnp.asarray(d_v), jnp.zeros((nx, nx)), cfg, dx=h, dy=h, rho=1.0,
        variant="symmetric")
    assert p.dtype == jnp.float64
    assert float(info.rel_residual) < 1e-11
    got = fortran_flatten(np.asarray(p))
    np.testing.assert_allclose(got, want, atol=1e-8 * np.max(np.abs(want)))


@pytest.mark.parametrize("nx,level", [(15, 1), (31, 1), (31, 2),
                                      (16, 1), (32, 1), (32, 2)])
def test_galerkin_level_is_dense_rap(nx, level):
    d_u, d_v = _d_fields(nx, seed=3)
    h = 1.0 / nx
    cfg = MultigridConfig()
    levels = build_levels(jnp.asarray(d_u), jnp.asarray(d_v), cfg, dx=h,
                          dy=h, rho=1.0, variant="symmetric")
    fine = from_poisson(poisson_coefficients(
        jnp.asarray(d_u), jnp.asarray(d_v), dx=h, dy=h, rho=1.0,
        variant="symmetric"))
    A = golden_pressure_matrix(d_u, d_v, h, h, 1.0, pin=False,
                               variant="symmetric")
    np.testing.assert_allclose(_dense(lambda x: apply9(x, fine), (nx, nx),
                                      nx * nx), A, atol=1e-12)
    shape = (nx, nx)
    for lvl in range(level):
        rf, pf, shape_c = _level_transfers(*shape, cfg)
        n, nc = shape[0] * shape[1], shape_c[0] * shape_c[1]
        R = _dense(rf, shape, nc)
        P = _dense(pf, shape_c, n)
        A = R @ A @ P
        shape = shape_c
    st, lvl_shape, five, _ = levels[level]
    assert lvl_shape == shape and not five
    got = _dense(lambda x: apply9(x, st), shape, shape[0] * shape[1])
    np.testing.assert_allclose(got, A, atol=1e-11 * np.max(np.abs(A)))
