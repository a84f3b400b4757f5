"""Large-scale single-chip demonstration runs (BASELINE config 5 et al.).

Usage (on the GPU; each prints one JSON line naming the device, and
appends it to SCALE_RUNS.jsonl):

    python benchmarks/scale_runs.py re1000-4096    # 4096^2 Re=1000 -> 1e-5
    python benchmarks/scale_runs.py re5000-1024    # Re continuation @1024^2
    python benchmarks/scale_runs.py re5000-2048
    python benchmarks/scale_runs.py re10000-511    # high-Re envelope (odd grid)
    python benchmarks/scale_runs.py re8500-511

BASELINE.json config 5 is "Re=5000, 1024^2-4096^2, spatially sharded"; the
runs here demonstrate the resolution/Re envelope on one card (the sharded step itself is validated on the 8-device CPU mesh
in tests/test_distributed.py and tests/test_dist_mg.py).
"""

import json
import os
import sys
import time

# runnable as `python benchmarks/scale_runs.py` from the repository root
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _common():
    from naviflow_tpu.utils.jaxcache import enable_persistent_cache

    enable_persistent_cache()
    import naviflow_tpu as nf
    from naviflow_tpu.algorithms import (
        SIMPLEConfig, grid_sequence_solve, sequenced_continuation_solve,
        simple_solve)
    from naviflow_tpu.solvers import KrylovMomentumConfig
    from naviflow_tpu.solvers.multigrid import MultigridConfig
    from naviflow_tpu.postprocessing.validation import infinity_norm_error

    return (nf, SIMPLEConfig, grid_sequence_solve,
            sequenced_continuation_solve, simple_solve, KrylovMomentumConfig,
            MultigridConfig, infinity_norm_error)


def _emit(row):
    import jax

    dev = jax.devices()[0]
    line = json.dumps(dict(row, platform=dev.platform,
                           device_kind=dev.device_kind,
                           device_count=jax.device_count()))
    print(line, flush=True)
    with open(os.path.join(os.path.dirname(__file__), "SCALE_RUNS.jsonl"),
              "a") as f:
        f.write(line + "\n")


def run_re1000_4096():
    (nf, SIMPLEConfig, grid_sequence_solve, _, simple_solve,
     KrylovMomentumConfig, MultigridConfig, inf_err) = _common()

    nx = 4096
    mesh = nf.StructuredMesh(nx=nx, ny=nx)
    fluid = nf.FluidProperties(density=1.0, reynolds_number=1000)
    bc = nf.lid_driven_cavity(1.0)
    cfg = SIMPLEConfig(max_iterations=20000, tolerance=1e-5)
    mom = KrylovMomentumConfig(tolerance=1e-6, max_iterations=25)
    pres = MultigridConfig(tolerance=1e-2, max_cycles=8, cycle_type="v",
                           check_every=2, coarsest_sweeps=32,
                           coarse_rebuild_every=8)
    t0 = time.perf_counter()
    final, diag, summ = grid_sequence_solve(
        mesh, fluid, bc, simple_solve, cfg, momentum=mom, pressure=pres,
        loop="chunked:100", max_levels=7, coarsest=64,
    )
    wall = time.perf_counter() - t0
    err = inf_err(final.u, final.v, mesh, 1000)
    _emit(dict(run="re1000-4096", nx=nx, re=1000, tolerance=1e-5,
               wall_seconds=round(wall, 1), levels=summ,
               converged=all(s["converged"] for s in summ),
               fine_iterations=summ[-1]["iterations"],
               ghia_infinity_error=round(float(err), 5)))


def run_re5000(nx, scheme="power_law"):
    (nf, SIMPLEConfig, _, sequenced_continuation_solve, simple_solve,
     KrylovMomentumConfig, MultigridConfig, inf_err) = _common()

    mesh = nf.StructuredMesh(nx=nx, ny=nx)
    bc = nf.lid_driven_cavity(1.0)
    schedule = [1000.0, 2000.0, 3200.0, 5000.0]
    cfg = SIMPLEConfig(max_iterations=30000, tolerance=1e-5,
                       alpha_p=0.2, alpha_u=0.6)
    mom = KrylovMomentumConfig(tolerance=1e-6, max_iterations=25,
                               scheme=scheme)
    pres = MultigridConfig(tolerance=1e-2, max_cycles=8, cycle_type="v",
                           check_every=2, coarsest_sweeps=32,
                           coarse_rebuild_every=8)
    t0 = time.perf_counter()
    final, diag, summ = sequenced_continuation_solve(
        mesh, schedule, bc, simple_solve, cfg, momentum=mom, pressure=pres,
        loop="chunked:100", coarsest=128, max_levels=5,
    )
    wall = time.perf_counter() - t0
    err = inf_err(final.u, final.v, mesh, 5000)
    tag = "" if scheme == "power_law" else f"-{scheme}"
    _emit(dict(run=f"re5000-{nx}{tag}", nx=nx, re=5000, tolerance=1e-5,
               scheme=scheme,
               wall_seconds=round(wall, 1), levels=summ,
               converged=bool(diag.converged),
               ghia_infinity_error=round(float(err), 5)))


def run_highre_511(re_target, scheme="power_law"):
    """High-Re envelope at 511^2.  ``scheme='quick'``/'luds' runs the
    9-point higher-order momentum discretization (ops/highorder.py) through
    the same sequencing+continuation pipeline — the round-2 verdict's
    accuracy item: power-law's numerical diffusion fails the 10% Ghia gate
    above Re~5000; QUICK exists precisely to cut it."""
    (nf, SIMPLEConfig, _, sequenced_continuation_solve, simple_solve,
     KrylovMomentumConfig, MultigridConfig, inf_err) = _common()

    nx = 511
    mesh = nf.StructuredMesh(nx=nx, ny=nx)
    bc = nf.lid_driven_cavity(1.0)
    schedule = [1000.0, 3200.0, 5000.0, 6500.0, 7500.0, 8500.0]
    if re_target > 8500:
        schedule += [9200.0, 10000.0]
    schedule = [r for r in schedule if r <= re_target]
    if schedule[-1] != re_target:
        schedule.append(re_target)

    def per_re(re):
        # back off relaxation near the steady branch's stability limit;
        # QUICK/LUDS (sharper profiles, less numerical damping) need one
        # extra notch — the round-3 quick runs with the power-law alphas
        # stalled in limit cycles just above tolerance (7500: 5.5e-5,
        # 10000: 1.0e-4; SCALE_RUNS.jsonl)
        damp = 1.0 if scheme == "power_law" else 0.6
        if re >= 8500:
            return SIMPLEConfig(max_iterations=40000, tolerance=1e-5,
                                alpha_p=0.12 * damp, alpha_u=0.5)
        if re >= 6500:
            return SIMPLEConfig(max_iterations=30000, tolerance=1e-5,
                                alpha_p=0.18 * damp, alpha_u=0.6)
        return SIMPLEConfig(max_iterations=20000, tolerance=1e-5,
                            alpha_p=0.25 * damp, alpha_u=0.7)

    cfg = per_re(re_target)
    mom = KrylovMomentumConfig(tolerance=1e-6, max_iterations=30,
                               scheme=scheme)
    pres = MultigridConfig(tolerance=1e-2, max_cycles=10, cycle_type="v",
                           check_every=2, coarsest_sweeps=48)
    t0 = time.perf_counter()
    final, diag, summ = sequenced_continuation_solve(
        mesh, schedule, bc, simple_solve, cfg, momentum=mom, pressure=pres,
        loop="chunked:200", coarsest=63, max_levels=4,
        per_re_cfg=per_re, per_level_cfg=lambda nx_: per_re(re_target),
    )
    wall = time.perf_counter() - t0
    err = inf_err(final.u, final.v, mesh, re_target)
    tag = "" if scheme == "power_law" else f"-{scheme}"
    _emit(dict(run=f"re{int(re_target)}-511{tag}", nx=nx, re=re_target,
               tolerance=1e-5, scheme=scheme,
               wall_seconds=round(wall, 1), levels=summ,
               converged=bool(diag.converged),
               final_residual=float(diag.final_residual),
               ghia_infinity_error=round(float(err), 5)))


def run_newton_511(re_target, scheme="quick", nx=511):
    """Round-4 verdict #4: a CONVERGED, Ghia-passing solution past the
    Hopf point.  The fixed-point SIMPLE iteration limit-cycles at ~5e-5
    for QUICK at Re>=7500 (the steady branch is unstable to the iteration
    dynamics); Newton–Krylov has no such restriction.  Pipeline:
    sequencing+continuation to a bounded warm start near the cycle, then
    ``algorithms/newton.newton_solve`` (AD-exact JFNK, SIMPLE-preconditioned
    GMRES) to 1e-5 on the same unrelaxed momentum norms."""
    (nf, SIMPLEConfig, _, sequenced_continuation_solve, simple_solve,
     KrylovMomentumConfig, MultigridConfig, inf_err) = _common()
    from naviflow_tpu.algorithms import NewtonConfig, newton_solve

    mesh = nf.StructuredMesh(nx=nx, ny=nx)
    bc = nf.lid_driven_cavity(1.0)
    schedule = [1000.0, 3200.0, 5000.0, 6500.0, 7500.0]
    if re_target > 7500:
        schedule += [8500.0, 9200.0, 10000.0]
    schedule = [r for r in schedule if r <= re_target]
    if schedule[-1] != re_target:
        schedule.append(re_target)

    def per_re(re):
        # bounded budgets: the warm start only needs to LAND NEAR the
        # limit cycle (the round-3 stall levels ~5e-5 are reached long
        # before the 30-40k budgets those runs burned); Newton closes
        # from there
        damp = 1.0 if scheme == "power_law" else 0.6
        if re >= re_target:
            return SIMPLEConfig(max_iterations=8000, tolerance=1e-5,
                                alpha_p=0.18 * damp, alpha_u=0.6)
        return SIMPLEConfig(max_iterations=12000, tolerance=3e-5,
                            alpha_p=0.2 * damp, alpha_u=0.65)

    cfg = per_re(re_target)
    mom = KrylovMomentumConfig(tolerance=1e-6, max_iterations=30,
                               scheme=scheme)
    pres = MultigridConfig(tolerance=1e-2, max_cycles=10, cycle_type="v",
                           check_every=2, coarsest_sweeps=48)
    t0 = time.perf_counter()
    state, diag0, summ = sequenced_continuation_solve(
        mesh, schedule, bc, simple_solve, cfg, momentum=mom, pressure=pres,
        loop="chunked:200", coarsest=63, max_levels=4,
        per_re_cfg=per_re, per_level_cfg=lambda nx_: per_re(re_target),
    )
    warm_wall = time.perf_counter() - t0
    warm_res = float(diag0.final_residual)
    print(json.dumps({"phase": "warmstart", "re": re_target,
                      "residual": warm_res,
                      "wall_seconds": round(warm_wall, 1)}), flush=True)

    fluid = nf.FluidProperties(density=1.0, reynolds_number=re_target)
    t1 = time.perf_counter()
    final, ndiag = newton_solve(
        mesh, fluid, bc, state,
        NewtonConfig(tolerance=1e-5, scheme=scheme, max_newton=30,
                     gmres_tol=1e-2, gmres_restart=60, gmres_maxiter=240),
        pressure=MultigridConfig(tolerance=1e-3, max_cycles=12,
                                 check_every=4, coarsest_sweeps=48),
        verbose=True,
    )
    newton_wall = time.perf_counter() - t1
    err = inf_err(final.u, final.v, mesh, re_target)
    _emit(dict(run=f"newton-re{int(re_target)}-{nx}-{scheme}", nx=nx,
               re=re_target, tolerance=1e-5, scheme=scheme,
               warmstart_residual=warm_res,
               warmstart_wall_seconds=round(warm_wall, 1),
               newton_wall_seconds=round(newton_wall, 1),
               newton_iterations=ndiag.iterations,
               gmres_iterations=ndiag.gmres_iterations,
               newton_history=[round(float(h), 9)
                               for h in ndiag.residual_history],
               converged=bool(ndiag.converged),
               final_residual=float(ndiag.final_residual),
               ghia_infinity_error=round(float(err), 5)))
    return final


def run_newton_up(re_target=10000.0, scheme="quick", nx_fine=1023,
                  nx_coarse=511):
    """Round-4 verdict #2: Re=10000 under the 10% Ghia gate needs the
    QUICK discretization at 1023^2 (the 511^2 QUICK limit is 26.3% on a
    converged steady state).  Pipeline: the converged 511^2 Newton state
    (run_newton_511) -> bilinear prolongation to ``nx_fine`` -> a bounded
    fixed-point smoothing pass (kill prolongation artifacts; it will
    stall at the post-Hopf limit cycle, which is fine) -> chunked
    PTC-Newton (``gmres_chunk=1``: one GMRES(60) restart cycle per jitted
    program)."""
    (nf, SIMPLEConfig, _, _, simple_solve,
     KrylovMomentumConfig, MultigridConfig, inf_err) = _common()
    from naviflow_tpu.algorithms import NewtonConfig, newton_solve
    from naviflow_tpu.algorithms.sequencing import prolong_state

    t_all = time.perf_counter()
    coarse_state = run_newton_511(re_target, scheme=scheme, nx=nx_coarse)

    mesh = nf.StructuredMesh(nx=nx_fine, ny=nx_fine)
    bc = nf.lid_driven_cavity(1.0)
    fluid = nf.FluidProperties(density=1.0, reynolds_number=re_target)
    state = prolong_state(coarse_state, mesh, bc)

    smooth_iters = int(os.environ.get("NEWTON_UP_SMOOTH", 600))
    t0 = time.perf_counter()
    if smooth_iters:
        mom = KrylovMomentumConfig(tolerance=1e-6, max_iterations=30,
                                   scheme=scheme)
        pres = MultigridConfig(tolerance=1e-2, max_cycles=10,
                               cycle_type="v", check_every=2,
                               coarsest_sweeps=48)
        state, diag0 = simple_solve(
            mesh, fluid, bc, state,
            SIMPLEConfig(max_iterations=smooth_iters, tolerance=1e-5,
                         alpha_p=0.1, alpha_u=0.6),
            momentum=mom, pressure=pres, loop="chunked:100")
        print(json.dumps({"phase": "fine-smooth", "nx": nx_fine,
                          "residual": float(diag0.final_residual),
                          "wall_seconds": round(time.perf_counter() - t0,
                                                1)}), flush=True)

    t1 = time.perf_counter()
    final, ndiag = newton_solve(
        mesh, fluid, bc, state,
        NewtonConfig(tolerance=1e-5, scheme=scheme, max_newton=30,
                     gmres_tol=1e-2, gmres_restart=60, gmres_maxiter=240,
                     gmres_chunk=1),
        pressure=MultigridConfig(tolerance=1e-3, max_cycles=12,
                                 check_every=4, coarsest_sweeps=48),
        verbose=True,
    )
    newton_wall = time.perf_counter() - t1
    err = inf_err(final.u, final.v, mesh, re_target)
    _emit(dict(run=f"newton-re{int(re_target)}-{nx_fine}-{scheme}",
               nx=nx_fine, re=re_target, tolerance=1e-5, scheme=scheme,
               warmstart_wall_seconds=round(t1 - t_all, 1),
               newton_wall_seconds=round(newton_wall, 1),
               newton_iterations=ndiag.iterations,
               gmres_iterations=ndiag.gmres_iterations,
               newton_history=[round(float(h), 9)
                               for h in ndiag.residual_history],
               converged=bool(ndiag.converged),
               final_residual=float(ndiag.final_residual),
               ghia_infinity_error=round(float(err), 5),
               ghia_passed=bool(float(err) < 0.1)))
    return final


def run_newton_chain(re_target=10000.0, scheme="quick", nx=511,
                     nx_fine=1023):
    """Branch-tracking Newton continuation in Re (round-5 diagnosis of
    the Re=10000 26% plateau).

    The sequence-up pipeline (run_newton_up) warm-starts from a SIMPLE
    stall AT the target Re; at Re=10000 that stall orbits a state whose
    Newton limit sits 26% off the Ghia table at BOTH 511^2 and 1023^2 —
    i.e. the landing point is grid-converged but on the wrong steady
    solution (published steady solutions, e.g. Erturk et al. 2005, agree
    with Ghia at Re=10000).  This runner instead tracks the KNOWN-GOOD
    branch: Newton-converge Re=7500 (Ghia 9.1%, under the gate), then
    re-Newton at each higher Re from the previous CONVERGED state — each
    step starts inside the true branch's basin instead of wherever the
    fixed-point dynamics stalled.  Per-stage Ghia errors (with u/v
    centerline breakdown) land in SCALE_RUNS.jsonl; converged states are
    saved under benchmarks/states/ for profile diagnostics."""
    (nf, SIMPLEConfig, _, _, simple_solve,
     KrylovMomentumConfig, MultigridConfig, inf_err) = _common()
    import numpy as np

    from naviflow_tpu.algorithms import NewtonConfig, newton_solve
    from naviflow_tpu.algorithms.sequencing import prolong_state
    from naviflow_tpu.postprocessing.validation import _interp_to_benchmark

    sdir = os.path.join(os.path.dirname(__file__), "states")
    os.makedirs(sdir, exist_ok=True)

    def save(state, tag):
        np.savez(os.path.join(sdir, f"newton_chain_{tag}.npz"),
                 u=np.asarray(state.u), v=np.asarray(state.v),
                 p=np.asarray(state.p))

    def ghia_row(state, mesh, re):
        du, dv, _ = _interp_to_benchmark(state.u, state.v, mesh, re)
        return dict(ghia_infinity_error=round(float(
            max(np.max(np.abs(du)), np.max(np.abs(dv)))), 5),
            ghia_max_du=round(float(np.max(np.abs(du))), 5),
            ghia_max_dv=round(float(np.max(np.abs(dv))), 5))

    mesh = nf.StructuredMesh(nx=nx, ny=nx)
    bc = nf.lid_driven_cavity(1.0)
    state = run_newton_511(7500.0, scheme=scheme, nx=nx)
    save(state, f"re7500_{nx}")

    schedule = [r for r in (8500.0, 9200.0, re_target) if r <= re_target]
    if schedule[-1] != re_target:
        schedule.append(re_target)
    ncfg = NewtonConfig(tolerance=1e-5, scheme=scheme, max_newton=40,
                        gmres_tol=1e-2, gmres_restart=60, gmres_maxiter=240)
    pres_n = MultigridConfig(tolerance=1e-3, max_cycles=12, check_every=4,
                             coarsest_sweeps=48)
    for re in schedule:
        fluid = nf.FluidProperties(density=1.0, reynolds_number=re)
        t0 = time.perf_counter()
        state, ndiag = newton_solve(mesh, fluid, bc, state, ncfg,
                                    pressure=pres_n, verbose=True)
        _emit(dict(run=f"newton-chain-re{int(re)}-{nx}-{scheme}", nx=nx,
                   re=re, scheme=scheme,
                   newton_wall_seconds=round(time.perf_counter() - t0, 1),
                   newton_iterations=ndiag.iterations,
                   gmres_iterations=ndiag.gmres_iterations,
                   converged=bool(ndiag.converged),
                   final_residual=float(ndiag.final_residual),
                   **ghia_row(state, mesh, re)))
        save(state, f"re{int(re)}_{nx}")
        if not ndiag.converged:
            return state

    # fine level: prolong the chain's target-Re state, short smoothing
    # pass only (prolongation artifacts are high-frequency; a LONG smooth
    # at an unstable Re risks drifting off-branch), chunked PTC-Newton
    mesh_f = nf.StructuredMesh(nx=nx_fine, ny=nx_fine)
    fluid = nf.FluidProperties(density=1.0, reynolds_number=re_target)
    fine = prolong_state(state, mesh_f, bc)
    smooth_iters = int(os.environ.get("NEWTON_CHAIN_SMOOTH", 150))
    if smooth_iters:
        mom = KrylovMomentumConfig(tolerance=1e-6, max_iterations=30,
                                   scheme=scheme)
        pres = MultigridConfig(tolerance=1e-2, max_cycles=10,
                               cycle_type="v", check_every=2,
                               coarsest_sweeps=48)
        fine, diag0 = simple_solve(
            mesh_f, fluid, bc, fine,
            SIMPLEConfig(max_iterations=smooth_iters, tolerance=1e-6,
                         alpha_p=0.1, alpha_u=0.6),
            momentum=mom, pressure=pres, loop="chunked:75")
        print(json.dumps({"phase": "fine-smooth", "nx": nx_fine,
                          "residual": float(diag0.final_residual)}),
              flush=True)
    t1 = time.perf_counter()
    fine, ndiag = newton_solve(
        mesh_f, fluid, bc, fine,
        NewtonConfig(tolerance=1e-5, scheme=scheme, max_newton=30,
                     gmres_tol=1e-2, gmres_restart=60, gmres_maxiter=240,
                     gmres_chunk=1),
        pressure=pres_n, verbose=True)
    row = ghia_row(fine, mesh_f, re_target)
    _emit(dict(run=f"newton-chain-re{int(re_target)}-{nx_fine}-{scheme}",
               nx=nx_fine, re=re_target, scheme=scheme, tolerance=1e-5,
               newton_wall_seconds=round(time.perf_counter() - t1, 1),
               newton_iterations=ndiag.iterations,
               gmres_iterations=ndiag.gmres_iterations,
               converged=bool(ndiag.converged),
               final_residual=float(ndiag.final_residual),
               ghia_passed=bool(row["ghia_infinity_error"] < 0.1), **row))
    save(fine, f"re{int(re_target)}_{nx_fine}")
    return fine


def run_config4_257():
    """BASELINE config 4 on the accelerator: 257^2 Re=1000 to 1e-7 in f32.

    The f32 floor previously measured ~2.3e-7 with the PLAIN residual
    evaluation; with the compensated (error-free) evaluation of the outer
    unrelaxed momentum residual (``ops/compensated.py``) the
    measurement resolves the exact residual, so this run records either
    1e-7 convergence on-device or the true f32 fixed-point floor.
    """
    (nf, SIMPLEConfig, grid_sequence_solve, _, simple_solve,
     KrylovMomentumConfig, MultigridConfig, inf_err) = _common()
    import numpy as np

    nx = 257
    mesh = nf.StructuredMesh(nx=nx, ny=nx)
    fluid = nf.FluidProperties(density=1.0, reynolds_number=1000)
    bc = nf.lid_driven_cavity(1.0)
    mom = KrylovMomentumConfig(tolerance=1e-8, max_iterations=40,
                               compensated_residual=True)
    pres = MultigridConfig(tolerance=1e-4, max_cycles=10, cycle_type="v",
                           check_every=2, coarsest_sweeps=48)

    t0 = time.perf_counter()
    # warm start: sequence to 1e-5 first (cheap), then push to 1e-7
    state, _, summ = grid_sequence_solve(
        mesh, fluid, bc, simple_solve, SIMPLEConfig(
            max_iterations=20000, tolerance=1e-5),
        momentum=mom, pressure=pres, loop="chunked:500", coarsest=65)
    state, diag = simple_solve(mesh, fluid, bc, state,
                               SIMPLEConfig(max_iterations=30000,
                                            tolerance=1e-7),
                               momentum=mom, pressure=pres,
                               loop="chunked:500")
    wall = time.perf_counter() - t0
    hist = np.asarray(diag.total_res_history)[: int(diag.iterations)]
    err = inf_err(state.u, state.v, mesh, 1000)
    _emit(dict(run="config4-257-tol1e-7-f32", nx=nx, re=1000,
               tolerance=1e-7, wall_seconds=round(wall, 1),
               warmstart_levels=summ,
               converged=bool(diag.converged),
               iterations=int(diag.iterations),
               final_residual=float(diag.final_residual),
               min_residual=float(hist.min()) if hist.size else None,
               compensated_residual=True,
               ghia_infinity_error=round(float(err), 5)))


if __name__ == "__main__":
    import warnings

    warnings.filterwarnings("ignore")
    which = sys.argv[1] if len(sys.argv) > 1 else "re1000-4096"
    if which == "re1000-4096":
        run_re1000_4096()
    elif which == "re5000-1024":
        run_re5000(1024)
    elif which == "re5000-2048":
        run_re5000(2048)
    elif which == "re10000-511":
        run_highre_511(10000.0)
    elif which == "re8500-511":
        run_highre_511(8500.0)
    elif which == "config4-257":
        run_config4_257()
    elif which == "re5000-4096":
        run_re5000(4096)
    elif which.startswith("quick-re"):
        # quick-re5000-511, quick-re7500-511, quick-re10000-511, ...
        parts = which.split("-")
        re_t = float(parts[1][2:])
        nx_t = int(parts[2])
        if nx_t == 511:
            run_highre_511(re_t, scheme="quick")
        else:
            run_re5000(nx_t, scheme="quick")
    elif which.startswith("luds-re"):
        parts = which.split("-")
        run_highre_511(float(parts[1][2:]), scheme="luds")
    elif which.startswith("newton-chain"):
        # newton-chain-re10000-quick (511^2 branch tracking + 1023^2 up)
        parts = which.split("-")
        run_newton_chain(float(parts[2][2:]), scheme=parts[3])
    elif which.startswith("newton-re"):
        # newton-re7500-511-quick, newton-re10000-511-quick, ...
        # newton-re10000-1023-quick routes through the sequence-up
        # pipeline (511^2 Newton state -> prolong -> chunked PTC-Newton)
        parts = which.split("-")
        if int(parts[2]) > 515:
            run_newton_up(float(parts[1][2:]), scheme=parts[3],
                          nx_fine=int(parts[2]))
        else:
            run_newton_511(float(parts[1][2:]), scheme=parts[3],
                           nx=int(parts[2]))
    else:
        raise SystemExit(f"unknown run: {which}")
