"""Color-plane (checkerboard) smoothing layout vs the standard forms."""

import jax.numpy as jnp
import numpy as np
import pytest

from naviflow_tpu.ops.plane import (
    PlaneStencil5,
    merge_planes,
    plane_prolong_cc,
    plane_rb_sweep,
    plane_residual,
    plane_restrict_cc,
    split_planes,
)
from naviflow_tpu.ops.poisson import poisson_coefficients
from naviflow_tpu.ops.stencil9 import apply5, from_poisson
from naviflow_tpu.ops.transfer_cc import prolong_cc, restrict_cc
from naviflow_tpu.solvers.multigrid import _rb2_sweep

NX = 64


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(7)
    d_u = jnp.asarray(rng.uniform(0.5, 1.5, (NX + 1, NX)), jnp.float32)
    d_v = jnp.asarray(rng.uniform(0.5, 1.5, (NX, NX + 1)), jnp.float32)
    pc = poisson_coefficients(d_u, d_v, dx=1.0 / NX, dy=1.0 / NX, rho=1.0,
                              variant="consistent")
    st = from_poisson(pc)
    p = jnp.asarray(rng.normal(size=(NX, NX)), jnp.float32)
    b = jnp.asarray(rng.normal(size=(NX, NX)), jnp.float32)
    return st, p, b


def test_split_merge_roundtrip(problem):
    _, p, _ = problem
    R, B = split_planes(p)
    np.testing.assert_array_equal(np.asarray(merge_planes(R, B)),
                                  np.asarray(p))
    # red plane really holds the (i+j)-even cells
    pn = np.asarray(p)
    for i in (0, 1, 5):
        for jc in (0, 1, 7):
            assert float(R[i, jc]) == pn[i, 2 * jc + (i % 2)]
            assert float(B[i, jc]) == pn[i, 2 * jc + 1 - (i % 2)]


def test_plane_sweep_matches_rb2(problem):
    """One plane-space sweep == one standard red-black sweep (up to the
    diagonal-normalization re-association, hence a roundoff tolerance)."""
    st, p, b = problem
    want = _rb2_sweep(p, b, st, 1.0)
    ps = PlaneStencil5(st, b)
    R, B = split_planes(p)
    R, B = plane_rb_sweep(R, B, ps)
    got = merge_planes(R, B)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-4)


def test_plane_sweep_chain_matches(problem):
    st, p, b = problem
    ps = PlaneStencil5(st, b)
    R, B = split_planes(p)
    want = p
    for _ in range(3):
        want = _rb2_sweep(want, b, st, 1.0)
        R, B = plane_rb_sweep(R, B, ps)
    np.testing.assert_allclose(np.asarray(merge_planes(R, B)),
                               np.asarray(want), rtol=1e-5, atol=3e-4)


def test_plane_residual_restrict(problem):
    st, p, b = problem
    from naviflow_tpu.ops.plane import PlaneStencil5 as PS
    R, B = split_planes(p)
    rR, rB = plane_residual(R, B, PS(st, b))
    want_r = b - apply5(p, st)
    np.testing.assert_allclose(np.asarray(merge_planes(rR, rB)),
                               np.asarray(want_r), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(plane_restrict_cc(rR, rB)),
                               np.asarray(restrict_cc(want_r)),
                               rtol=1e-5, atol=1e-5)


def test_plane_prolong(problem):
    rng = np.random.default_rng(3)
    ec = jnp.asarray(rng.normal(size=(NX // 2, NX // 2)), jnp.float32)
    efR, efB = plane_prolong_cc(ec)
    want = prolong_cc(ec)
    np.testing.assert_allclose(np.asarray(merge_planes(efR, efB)),
                               np.asarray(want), rtol=1e-5, atol=1e-6)


def test_plane_fine_layout_solve_matches(problem):
    """multigrid_solve with fine_layout='plane' == the interleaved solve:
    same cycle counts and matching solutions (the plane path is the
    re-associated same algorithm)."""
    import dataclasses

    from naviflow_tpu.solvers.multigrid import MultigridConfig, multigrid_solve

    st, p, b = problem
    # SMOOTH coefficient fields: cell-to-cell random d defeats multigrid
    # itself (rough-coefficient problem, both layouts stall identically);
    # realistic d fields are smooth
    iu = jnp.arange(NX + 1)[:, None] / NX
    ju = jnp.arange(NX)[None, :] / NX
    d_u = jnp.asarray(1.0 + 0.4 * jnp.sin(2 * jnp.pi * iu)
                      * jnp.cos(2 * jnp.pi * ju), jnp.float32)
    iv = jnp.arange(NX)[:, None] / NX
    jv = jnp.arange(NX + 1)[None, :] / NX
    d_v = jnp.asarray(1.0 + 0.4 * jnp.cos(2 * jnp.pi * iv)
                      * jnp.sin(2 * jnp.pi * jv), jnp.float32)
    # manufactured COMPATIBLE rhs: a random b generally has a component in
    # the left-nullspace of the (nonsymmetric-boundary) singular operator,
    # which no solver can remove — physical continuity defects are
    # compatible by construction, so build b = A x_true
    from naviflow_tpu.ops.poisson import poisson_coefficients
    from naviflow_tpu.ops.stencil9 import from_poisson as _fp

    st_t = _fp(poisson_coefficients(d_u, d_v, dx=1.0 / NX, dy=1.0 / NX,
                                    rho=1.0, variant="consistent"))
    rngb = np.random.default_rng(12)
    x_true = jnp.asarray(rngb.normal(size=(NX, NX)), jnp.float32)
    b0 = apply5(x_true, st_t)
    cfg = MultigridConfig(tolerance=1e-5, max_cycles=60, check_every=2,
                          pre_smoothing=2, post_smoothing=2, smoother="gs")
    kw = dict(dx=1.0 / NX, dy=1.0 / NX, rho=1.0)
    p_i, info_i = multigrid_solve(b0, d_u, d_v, jnp.zeros_like(b0), cfg, **kw)
    cfg_p = dataclasses.replace(cfg, fine_layout="plane")
    p_p, info_p = multigrid_solve(b0, d_u, d_v, jnp.zeros_like(b0), cfg_p, **kw)
    assert int(info_i.iterations) == int(info_p.iterations)
    assert float(info_p.rel_residual) < 1e-5
    # the singular (gauge-free) system is ill-conditioned: two solvers at
    # rel-residual 1e-6 may differ by ~cond * 1e-6 in the low modes, so
    # compare relative to the solution scale
    scale = float(jnp.max(jnp.abs(p_i)))
    diff = float(jnp.max(jnp.abs(p_p - p_i)))
    assert diff < 2e-3 * scale, (diff, scale)
