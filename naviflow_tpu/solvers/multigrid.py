"""Geometric multigrid for the pressure-correction equation.

JAX rebuild of the reference GMG
(``naviflow_oo/solver/pressure_solver/multigrid.py``): V-cycle (:304-432),
W-cycle (:434-560), and FMG (:562-688) on the ``2**k - 1`` grid hierarchy
with full-weighting residual restriction and bilinear correction
prolongation.

Design decisions (documented deviations from the reference):

* **Galerkin coarse operators.**  The reference rediscretizes coarse levels
  from harmonically restricted d-coefficients
  (``multigrid_helpers.py:196-329``).  Measured against the true Galerkin
  operator that construction is ~2x too strong for the consistent boundary
  treatment, capping the V-cycle factor near 0.5.  We form exact
  ``A_c = R A P`` per level (9-point stencils, computed by the comb trick in
  ``ops/stencil9.py``) — with an exact coarse solve the coarse-grid
  correction is then an A-orthogonal projection and cannot diverge.  The
  reference's rediscretization scheme remains available as
  ``coarsening='rediscretize'`` for parity studies.
* **Static hierarchy**: level shapes derive from nx at trace time, so the
  whole cycle unrolls into one fused XLA program.
* **Coarsest solve**: the reference calls SuperLU ``spsolve``
  (``multigrid.py:268-302``); dense factorization of a <=7^2 system is host
  logic, so we run a fixed block of 4-color GS sweeps on the device, which
  also handles the singular (gauge-free) operator gracefully.
* **Smoothers**: red-black SOR on the 5-point finest level, 4-color GS on
  the 9-point Galerkin levels (every neighbor of a cell has a different
  color, so each masked quarter-sweep is a true GS update).  The reference's
  sequential lexicographic/symmetric GS smoothers have no parallel analog
  (SURVEY §7); red-black is the variant its own multigrid study settled on
  (``GS_vcycle.py:53``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from ..ops.poisson import poisson_coefficients
from ..ops.stencil9 import (
    Stencil9,
    apply5,
    apply9,
    apply_five,
    from_poisson,
    galerkin_coarsen,
    gs4_sweep,
    jacobi9_sweep,
    stencil9_diagonal,
)
from ..ops.transfer import (
    coarse_size,
    prolong_cubic,
    prolong_linear,
    restrict_d_coefficients,
    restrict_full_weighting,
    restrict_inject,
)
from ..ops.transfer_cc import prolong_cc, restrict_cc
from .chebyshev import chebyshev_smooth, estimate_lambda_max
from .pressure import PressureSolveInfo


@dataclasses.dataclass(frozen=True)
class MultigridConfig:
    """Parity with the reference ``MultiGridSolver`` constructor knobs
    (``multigrid.py:21-119``) where they survive the redesign."""

    tolerance: float = 1e-3
    max_cycles: int = 100
    pre_smoothing: int = 2
    post_smoothing: int = 2
    cycle_type: str = "v"  # 'v' | 'w' | 'fmg'
    smoother: str = "gs"  # 'gs' (red-black / 4-color) | 'jacobi' | 'chebyshev'
    omega: float = 1.0
    cheby_degree: int = 4
    cheby_theta: float = 30.0
    coarsest_grid_size: int = 7
    coarsest_sweeps: int = 64
    restriction: str = "full_weighting"  # 'full_weighting' | 'inject'
    # 'bfloat16': run the smoothing sweeps on the f32 ERROR equation in
    # bf16 (residuals/transfers/corrections stay f32) — halves the
    # smoother's bytes.  Exactly the same affine iteration when dtypes
    # match, so convergence degrades only by bf16 rounding of the
    # per-level corrections.
    smoother_dtype: str = "float32"
    # correction prolongation on odd (vertex) grids: 'linear' | 'cubic'
    # (reference multigrid_helpers.py:333-391; cubic requires
    # coarsening='rediscretize' — see ops/transfer.prolong_cubic)
    prolongation: str = "linear"
    coarsening: str = "galerkin"  # 'galerkin' | 'rediscretize'
    check_every: int = 1
    # Rebuild the *coarse* Galerkin operators only every K outer iterations
    # (the fine operator is always current, so the V-cycle's fixed point is
    # the exact solution of the current system; stale coarse ops only affect
    # the error-correction rate).  1 = rebuild every iteration (no lagging).
    # Only the algorithm layer acts on this (it owns the cross-iteration
    # carry).
    coarse_rebuild_every: int = 1
    # 'plane': hold the (even, five-point) finest level as red/black color
    # planes across the whole solve (ops/plane.py) — every smoothing
    # half-sweep then touches half-size arrays with no color-masked waste;
    # the split/merge conversions amortize to once per solve.  'auto'
    # (default) resolves to 'interleaved': inside the SIMPLE step each
    # pressure solve converts against interleaved-form assembly/momentum
    # neighbours, and whether the half-width sweeps pay for those
    # conversions on the GPU is not measured yet.
    fine_layout: str = "auto"  # 'auto' | 'interleaved' | 'plane'
    kind: str = "multigrid"


def _rb2_sweep(p, b, st: Stencil9, omega: float):
    """Two-color red-black SOR — valid when the stencil's diagonal-corner
    entries are zero (the 5-point finest level).  Uses the 5-point
    ``apply5`` fast path: the corner arrays are runtime zeros that would
    otherwise be streamed from device memory every half-sweep (4 of the 9
    stencil arrays of a bandwidth-bound sweep)."""
    shape = p.shape
    ii = jax.lax.broadcasted_iota(jnp.int32, shape, 0)
    jj = jax.lax.broadcasted_iota(jnp.int32, shape, 1)
    red = (ii + jj) % 2 == 0
    inv_c = 1.0 / stencil9_diagonal(st)

    def half(p, color):
        off = apply5(p, st) - st.c * p
        p_new = (b - off) * inv_c
        return jnp.where(color, p + omega * (p_new - p), p)

    p = half(p, red)
    return half(p, jnp.logical_not(red))


def _smooth(p, b, st: Stencil9, cfg, n, five_point: bool, lam=None):
    if (getattr(cfg, "smoother_dtype", "float32") in ("bfloat16", "bf16")
            and p.dtype == jnp.float32 and n > 0):
        # error form: n sweeps on A e = r from e=0 are the same affine map
        # as n sweeps on A p = b from p — but e can live in bf16 without
        # quantizing the accumulated solution
        r = b - apply_five(p, st, five_point)
        st16 = jax.tree_util.tree_map(
            lambda a: a.astype(jnp.bfloat16) if hasattr(a, "astype") else a, st)
        e = jnp.zeros(p.shape, jnp.bfloat16)
        e = _smooth_core(e, r.astype(jnp.bfloat16), st16, cfg, n, five_point,
                         lam)
        return p + e.astype(p.dtype)
    return _smooth_core(p, b, st, cfg, n, five_point, lam)


def _smooth_core(p, b, st: Stencil9, cfg, n, five_point: bool, lam=None):
    if cfg.smoother == "chebyshev":
        # one Chebyshev application of degree ~n*2 replaces n sweeps
        return chebyshev_smooth(p, b, st, lam, degree=max(cfg.cheby_degree, n),
                                theta=cfg.cheby_theta)
    if cfg.smoother == "jacobi":
        fn = lambda q: jacobi9_sweep(q, b, st, min(cfg.omega, 0.9))
    elif five_point:
        fn = lambda q: _rb2_sweep(q, b, st, cfg.omega)
    else:
        fn = lambda q: gs4_sweep(q, b, st, cfg.omega)
    return jax.lax.fori_loop(0, n, lambda _, q: fn(q), p)


def _restrict(r, cfg):
    if cfg.restriction == "full_weighting":
        return restrict_full_weighting(r)
    return restrict_inject(r)


def _level_transfers(nx, ny, cfg):
    """Pick the coarsening flavor per level by grid parity.

    Odd (2^k - 1) grids use the reference's vertex-style transfers; even
    (2^k) grids — the distributed/large-grid layout — use cell-centered
    2x2-average restriction + bilinear CC prolongation.  Returns
    (restrict_fn, prolong_fn, (nxc, nyc)).
    """
    if nx % 2 == 1 and ny % 2 == 1:
        if cfg.prolongation == "cubic":
            if cfg.coarsening != "rediscretize":
                raise ValueError(
                    "prolongation='cubic' requires coarsening='rediscretize' "
                    "(its 4-wide support breaks the Galerkin comb recovery)"
                )
            pf = functools.partial(prolong_cubic, mx=nx, my=ny)
        else:
            pf = functools.partial(prolong_linear, mx=nx, my=ny)
        return (
            lambda r: _restrict(r, cfg),
            pf,
            (coarse_size(nx), coarse_size(ny)),
        )
    if nx % 2 == 0 and ny % 2 == 0:
        return restrict_cc, prolong_cc, (nx // 2, ny // 2)
    raise ValueError(f"mixed-parity grid ({nx}, {ny}) cannot be coarsened")


def build_levels(d_u, d_v, cfg: MultigridConfig, *, dx, dy, rho, variant):
    """Static list of (Stencil9, (nx, ny), five_point, lam_max) finest ->
    coarsest (lam_max only populated for the Chebyshev smoother)."""
    nx, ny = d_u.shape[0] - 1, d_v.shape[1] - 1
    need_lam = cfg.smoother == "chebyshev"

    def lam_of(st, shape):
        return estimate_lambda_max(st, shape) if need_lam else None

    fine = from_poisson(
        poisson_coefficients(d_u, d_v, dx=dx, dy=dy, rho=rho, variant=variant)
    )
    levels = [(fine, (nx, ny), True, lam_of(fine, (nx, ny)))]
    if cfg.coarsening == "galerkin":
        shapes = [(nx, ny)]
        while min(shapes[-1]) > cfg.coarsest_grid_size:
            _, _, (nxc, nyc) = _level_transfers(*shapes[-1], cfg)
            shapes.append((nxc, nyc))
        st = fine
        for cur in range(len(shapes) - 1):
            rf, pf, _ = _level_transfers(*shapes[cur], cfg)
            st = galerkin_coarsen(st, rf, pf, *shapes[cur + 1])
            levels.append((st, shapes[cur + 1], False,
                           lam_of(st, shapes[cur + 1])))
    elif cfg.coarsening == "rediscretize":
        while min(nx, ny) > cfg.coarsest_grid_size:
            d_u, d_v = restrict_d_coefficients(d_u, d_v)
            nx, ny = coarse_size(nx), coarse_size(ny)
            dx, dy = 2 * dx, 2 * dy
            st = from_poisson(
                poisson_coefficients(d_u, d_v, dx=dx, dy=dy, rho=rho, variant=variant)
            )
            levels.append((st, (nx, ny), True, lam_of(st, (nx, ny))))
    else:
        raise ValueError(f"Unknown coarsening: {cfg.coarsening}")
    return levels


def levels_from_stencil(st: Stencil9, nx: int, ny: int, cfg: MultigridConfig):
    """Continue Galerkin coarsening from an arbitrary 9-point operator.

    Used by the distributed multigrid (``parallel/dist_mg.py``): the fine
    levels are coarsened block-locally on the device mesh; the stencil
    gathered at the cutoff enters here as level 0 of the replicated tail.
    ``five_point`` is False throughout (Galerkin levels are 9-point).
    """
    need_lam = cfg.smoother == "chebyshev"

    def lam_of(s, shape):
        return estimate_lambda_max(s, shape) if need_lam else None

    levels = [(st, (nx, ny), False, lam_of(st, (nx, ny)))]
    while min(nx, ny) > cfg.coarsest_grid_size:
        if (nx % 2) != (ny % 2):
            # mixed parity (padded rectangular tails, e.g. 30x32 -> 15x16):
            # no transfer factorization — stop here; the extra coarsest
            # sweeps absorb the shallower ladder
            break
        rf, pf, (nxc, nyc) = _level_transfers(nx, ny, cfg)
        st = galerkin_coarsen(st, rf, pf, nxc, nyc)
        levels.append((st, (nxc, nyc), False, lam_of(st, (nxc, nyc))))
        nx, ny = nxc, nyc
    return levels


def _cycle(p, b, levels, lvl, cfg):
    """One V/W cycle at level ``lvl`` (unrolled at trace time)."""
    st, (nx, ny), five, lam = levels[lvl]
    if lvl == len(levels) - 1:
        return _smooth(p, b, st, cfg, cfg.coarsest_sweeps, five, lam)

    rf, pf, _ = _level_transfers(nx, ny, cfg)
    p = _smooth(p, b, st, cfg, cfg.pre_smoothing, five, lam)
    r = b - apply_five(p, st, five)
    rc = rf(r)
    ec = jnp.zeros_like(rc)
    ec = _cycle(ec, rc, levels, lvl + 1, cfg)
    if cfg.cycle_type == "w" and lvl + 1 < len(levels) - 1:
        ec = _cycle(ec, rc, levels, lvl + 1, cfg)
    p = p + pf(ec)
    return _smooth(p, b, st, cfg, cfg.post_smoothing, five, lam)


def _fmg(b, levels, cfg):
    """Full-multigrid bootstrap (reference ``_fmg_cycle``, :562-688)."""
    rhs = [b]
    for lvl in range(len(levels) - 1):
        rf, _, _ = _level_transfers(*levels[lvl][1], cfg)
        rhs.append(rf(rhs[-1]))
    st, _, five, lam = levels[-1]
    p = jnp.zeros_like(rhs[-1])
    p = _smooth(p, rhs[-1], st, cfg, cfg.coarsest_sweeps, five, lam)
    for lvl in range(len(levels) - 2, -1, -1):
        _, pf, _ = _level_transfers(*levels[lvl][1], cfg)
        p = pf(p)
        p = _cycle(p, rhs[lvl], levels, lvl, cfg)
    return p


def coarse_stencils(levels):
    """The carryable pytree part of a hierarchy: coarse-level Stencil9 tuple."""
    return tuple(st for st, _, _, _ in levels[1:])


def multigrid_solve(
    b, d_u, d_v, p0, cfg: MultigridConfig, *, dx, dy, rho, variant="consistent",
    levels=None,
) -> Tuple[jax.Array, PressureSolveInfo]:
    """Solve A(d_u, d_v) p = b to ``cfg.tolerance`` by repeated cycles.

    Same return contract as :func:`..solvers.pressure.solve_pressure`.
    Gauge-free: the returned correction is mean-normalized.  ``levels``
    optionally supplies a prebuilt (possibly lagged-coarse) hierarchy.
    """
    if levels is None:
        levels = build_levels(d_u, d_v, cfg, dx=dx, dy=dy, rho=rho, variant=variant)
    st_fine = levels[0][0]
    five_fine = levels[0][2]
    bnorm = jnp.linalg.norm(b)
    safe_bnorm = jnp.where(bnorm > 0, bnorm, jnp.ones_like(bnorm))

    p_start = _fmg(b, levels, cfg) if cfg.cycle_type == "fmg" else p0

    def cond(carry):
        p, k, rel = carry
        return (k < cfg.max_cycles) & (rel >= cfg.tolerance)

    layout = getattr(cfg, "fine_layout", "auto")
    if layout == "auto":
        # see the MultigridConfig.fine_layout comment
        layout = "interleaved"
    use_plane = (
        layout == "plane"
        and five_fine and len(levels) > 1
        and cfg.cycle_type in ("v", "fmg") and cfg.smoother == "gs"
        and cfg.omega == 1.0
        and getattr(cfg, "smoother_dtype", "float32") == "float32"
        and b.shape[0] % 2 == 0 and b.shape[1] % 2 == 0
    )
    big = jnp.asarray(jnp.inf, b.dtype)
    if use_plane:
        from ..ops.plane import (PlaneStencil5, merge_planes,
                                 plane_fine_down, plane_fine_up,
                                 plane_residual_norm, split_planes)

        ps = PlaneStencil5(st_fine, b)
        R0, B0 = split_planes(p_start)

        def cond_p(carry):
            _, _, k, rel = carry
            return (k < cfg.max_cycles) & (rel >= cfg.tolerance)

        def one_cycle(RB):
            R, B = RB
            R, B, rc = plane_fine_down(R, B, ps, cfg.pre_smoothing)
            ec = _cycle(jnp.zeros_like(rc), rc, levels[1:], 0, cfg)
            return plane_fine_up(R, B, ps, ec, cfg.post_smoothing)

        if cfg.tolerance <= 0.0:
            # fixed-cycle fast path: no per-check residual apply+norm, no
            # while-loop carry plumbing — exactly max_cycles cycles.  The
            # final residual (computed below for the diagnostics anyway)
            # supplies rel.
            R, B = jax.lax.fori_loop(
                0, cfg.max_cycles, lambda _, q: one_cycle(q), (R0, B0))
            cycles = jnp.asarray(cfg.max_cycles, jnp.int32)
            rel = None
        else:
            def body_p(carry):
                R, B, k, _ = carry
                R, B = jax.lax.fori_loop(
                    0, cfg.check_every, lambda _, q: one_cycle(q), (R, B))
                rel = plane_residual_norm(R, B, ps) / safe_bnorm
                return (R, B, k + cfg.check_every, rel)

            R, B, cycles, rel = jax.lax.while_loop(
                cond_p, body_p, (R0, B0, jnp.asarray(0, jnp.int32), big))
        p = merge_planes(R, B)
    else:
        if cfg.tolerance <= 0.0:
            p = jax.lax.fori_loop(
                0, cfg.max_cycles,
                lambda _, q: _cycle(q, b, levels, 0, cfg), p_start)
            cycles = jnp.asarray(cfg.max_cycles, jnp.int32)
            rel = None
        else:
            def body(carry):
                p, k, _ = carry
                p = jax.lax.fori_loop(
                    0, cfg.check_every,
                    lambda _, q: _cycle(q, b, levels, 0, cfg), p
                )
                rel = jnp.linalg.norm(
                    b - apply_five(p, st_fine, five_fine)) / safe_bnorm
                return (p, k + cfg.check_every, rel)

            p, cycles, rel = jax.lax.while_loop(
                cond, body, (p_start, jnp.asarray(0, jnp.int32), big)
            )
    if variant != "reference":
        # Gauge-free (singular) operator: remove the constant mode.  The
        # 'reference' variant folds boundary faces into the diagonal, making
        # A nonsingular (A·1 != 0); shifting would leave a spurious boundary
        # residual in the returned diagnostics.
        p = p - jnp.mean(p)
    r = b - apply_five(p, st_fine, five_fine)
    if rel is None:  # fixed-cycle fast path: rel from the final residual
        rel = jnp.linalg.norm(r) / safe_bnorm
    return p, PressureSolveInfo(iterations=cycles, residual_field=r, rel_residual=rel)


def make_preconditioner(levels, cfg: MultigridConfig, n_cycles: int = 1):
    """M^{-1} r ~= ``n_cycles`` multigrid cycles from a zero guess — the
    reference's GMG-preconditioned-CG setup (``geo_multigrid_cg.py:119-172``)."""

    def apply_M(r):
        e = jnp.zeros_like(r)
        for _ in range(n_cycles):
            e = _cycle(e, r, levels, 0, cfg)
        return e

    return apply_M
