"""Benchmark: SIMPLE + Galerkin-multigrid lid-driven cavity on one GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...extras},
with the platform, ``device_kind``, device count, card name and power limit
and ``XLA_FLAGS`` it ran under.  Runs in one process and refuses any device
but a GPU: a CPU time is never reported as a device time.

Rows of the line:

* headline — the reference's only published number (BASELINE.md: GMG
  V-cycle SIMPLE, Re=100 cavity 63^2, 4.98 s wall to residual ~1e-3 on an
  Apple M3 Pro, ``main_scripts/05 geo_multigrid/README.md``): same physics,
  same grid, same tolerance; ``vs_baseline`` = baseline_seconds / ours.
  This tolerance does NOT pass the reference's own 10% Ghia gate
  (``simulation_result.py:262-264``), hence the companion row below.
* ``validated`` — the same case converged to 1e-5, with the Ghia
  infinity-norm error and the explicit ``ghia_passed`` 10%-gate verdict.
* ``large_grid*`` — warm ms per outer iteration of the full SIMPLE step at
  1024^2, 2048^2 and 4096^2 (one fused fixed-count loop; MLUPS and GLUPS).

Env overrides: BENCH_NX (grid, default 63), BENCH_RE (default 100),
BENCH_TOL (headline tolerance, default 1e-3), BENCH_MAXIT, BENCH_BIG_NX,
BENCH_BIG2_NX, BENCH_BIG3_NX (large grids; 0 skips one), and BENCH_MODE=seq
for the grid-sequenced 1024^2 Re=1000 cavity to 1e-5 (the BASELINE.json
headline metric).

Times are host wall clock around work that ends in ``block_until_ready``;
each timed call follows a warm call of the same program.
"""

import json
import os
import subprocess
import time

REFERENCE_WALL_S = 4.98  # reference 05 geo_multigrid/README.md:22-26 (63^2 Re=100)
GHIA_GATE = 0.1  # reference simulation_result.py:262-264


def card_info() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them (a
    child process that does not import JAX)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({type(e).__name__})"
    return out.stdout.strip() or f"unavailable (rc={out.returncode})"


def device_info() -> dict:
    import jax

    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()), "card": card_info(),
            "xla_flags": os.environ.get("XLA_FLAGS", "")}


def require_gpu():
    import jax

    platform = jax.devices()[0].platform
    if platform != "gpu":
        raise RuntimeError(f"no GPU: JAX found platform {platform!r}")


def headline_solvers():
    """63^2 headline configuration: BiCGSTAB momentum, adaptive Galerkin
    V-cycles with the coarse hierarchy rebuilt every 8 outer iterations."""
    from naviflow_tpu.solvers import KrylovMomentumConfig, MultigridConfig

    mom = KrylovMomentumConfig(tolerance=1e-6, max_iterations=20)
    pres = MultigridConfig(tolerance=1e-2, max_cycles=6, cycle_type="v",
                           check_every=2, coarsest_sweeps=8,
                           coarse_rebuild_every=8)
    return mom, pres


def large_grid_solvers():
    """Large-grid configuration: degree-4 Chebyshev momentum (no reductions
    inside the iteration) and ONE fixed 1/1-smoothing V-cycle per outer step
    (``tolerance=0`` -> the fixed-count path).  SIMPLE re-linearizes every
    outer step, so more pressure accuracy within a step buys nothing: the
    long trajectories of this and the adaptive configuration agree to six
    digits (PERF.md, numerics carried over)."""
    from naviflow_tpu.solvers import ChebyshevMomentumConfig, MultigridConfig

    mom = ChebyshevMomentumConfig(degree=4)
    pres = MultigridConfig(tolerance=0.0, max_cycles=1, cycle_type="v",
                           pre_smoothing=1, post_smoothing=1,
                           coarsest_sweeps=32, coarse_rebuild_every=8)
    return mom, pres


def sequenced_solvers():
    """Grid-sequenced 1024^2 Re=1000 configuration (BASELINE.json)."""
    from naviflow_tpu.solvers import KrylovMomentumConfig, MultigridConfig

    mom = KrylovMomentumConfig(tolerance=1e-6, max_iterations=25)
    pres = MultigridConfig(tolerance=1e-2, max_cycles=8, cycle_type="v",
                           check_every=2, coarsest_sweeps=32,
                           coarse_rebuild_every=8)
    return mom, pres


def cavity(nx, re):
    import naviflow_tpu as nf

    return (nf.StructuredMesh(nx=nx, ny=nx),
            nf.FluidProperties(density=1.0, reynolds_number=re),
            nf.lid_driven_cavity(1.0))


def timed(fn, *args):
    """(seconds, result) of ``fn(*args)``, the clock closed only after the
    device finished."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return time.perf_counter() - t0, out


def compile_fused(mesh, fluid, bc, cfg, mom, pres, solve=None):
    """The whole fused solve (``simple_solve`` unless ``solve`` names
    another algorithm) as one compiled program of the initial state, and
    its compile seconds (tracing and lowering included)."""
    import jax
    import naviflow_tpu as nf
    from naviflow_tpu.algorithms import simple_solve

    solve = solve or simple_solve
    fn = jax.jit(lambda s: solve(mesh, fluid, bc, s, cfg, momentum=mom,
                                 pressure=pres, loop="fused"))
    t0 = time.perf_counter()
    compiled = fn.lower(nf.initialize_state(mesh, bc)).compile()
    return compiled, time.perf_counter() - t0


def compile_large_grid(nx, n_iters, re=100.0):
    """The large-grid configuration at ``nx^2`` for ``n_iters`` fixed outer
    iterations: ``(nx, n_iters, compiled program, compile seconds)``."""
    from naviflow_tpu.algorithms import SIMPLEConfig

    mesh, fluid, bc = cavity(nx, re)
    mom, pres = large_grid_solvers()
    cfg = SIMPLEConfig(max_iterations=n_iters, tolerance=0.0)
    return (nx, n_iters) + compile_fused(mesh, fluid, bc, cfg, mom, pres)


def time_large_grid(nx, n_iters, compiled, compile_s):
    """Warm ms per outer iteration of a :func:`compile_large_grid` program,
    with its memory analysis and the device's peak memory."""
    import jax
    import numpy as np
    import naviflow_tpu as nf

    mesh, _, bc = cavity(nx, 100.0)
    state = jax.block_until_ready(nf.initialize_state(mesh, bc))
    timed(compiled, state)  # first execution
    wall, (_, diag) = timed(compiled, state)
    hist = np.asarray(diag.total_res_history)[:n_iters]
    ms = wall / n_iters * 1e3
    mem = compiled.memory_analysis()
    stats = jax.devices()[0].memory_stats() or {}
    return {
        "nx": nx, "iterations_timed": n_iters,
        "ms_per_iteration": ms,
        "mlups": nx * nx / ms / 1e3,
        "glups": nx * nx / ms / 1e6,
        "compile_seconds": compile_s,
        "residual_first": float(hist[0]), "residual_last": float(hist[-1]),
        "finite": bool(np.all(np.isfinite(hist))),
        "temp_bytes": getattr(mem, "temp_size_in_bytes", None),
        "argument_bytes": getattr(mem, "argument_size_in_bytes", None),
        "output_bytes": getattr(mem, "output_size_in_bytes", None),
        "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
    }


def main():
    from naviflow_tpu.utils.jaxcache import enable_persistent_cache

    enable_persistent_cache()
    require_gpu()
    if os.environ.get("BENCH_MODE") == "seq":
        return bench_sequenced()
    import jax
    import naviflow_tpu as nf
    from naviflow_tpu.algorithms import SIMPLEConfig, simple_solve
    from naviflow_tpu.postprocessing.validation import infinity_norm_error

    nx = int(os.environ.get("BENCH_NX", 63))
    re = float(os.environ.get("BENCH_RE", 100))
    tol = float(os.environ.get("BENCH_TOL", 1e-3))
    maxit = int(os.environ.get("BENCH_MAXIT", 4000))
    mesh, fluid, bc = cavity(nx, re)
    mom, pres = headline_solvers()

    def run(cfg, n_runs):
        solve = lambda s: simple_solve(mesh, fluid, bc, s, cfg,
                                       momentum=mom, pressure=pres)
        state = jax.block_until_ready(nf.initialize_state(mesh, bc))
        timed(solve, state)  # compile + first execution
        walls, out = [], None
        for _ in range(n_runs):
            w, out = timed(solve, state)
            walls.append(w)
        return sorted(walls)[len(walls) // 2], out

    wall, (final, diag) = run(SIMPLEConfig(max_iterations=maxit,
                                           tolerance=tol), 3)
    iters = int(diag.iterations)
    err = infinity_norm_error(final.u, final.v, mesh, re)
    row = {
        "metric": f"wall_clock_to_{tol:g}_residual_{nx}x{nx}_Re{int(re)}_GMG_SIMPLE",
        "value": wall,
        "unit": "s",
        "vs_baseline": REFERENCE_WALL_S / wall if nx == 63 else None,
        "outer_iterations": iters,
        "converged": bool(diag.converged),
        "final_residual": float(diag.final_residual),
        "max_divergence": float(diag.max_divergence),
        "ghia_infinity_error": err,
        "mlups_outer": iters * nx * nx / wall / 1e6,
        "device": device_info(),
    }
    wall_v, (final_v, diag_v) = run(SIMPLEConfig(max_iterations=maxit,
                                                 tolerance=1e-5), 1)
    err_v = infinity_norm_error(final_v.u, final_v.v, mesh, re)
    row["validated"] = {
        "tolerance": 1e-5,
        "wall_seconds": wall_v,
        "outer_iterations": int(diag_v.iterations),
        "converged": bool(diag_v.converged),
        "ghia_infinity_error": err_v,
        "ghia_passed": bool(err_v < GHIA_GATE),
    }
    for key, env, default, n in (("large_grid", "BENCH_BIG_NX", 1024, 100),
                                 ("large_grid_2", "BENCH_BIG2_NX", 2048, 40),
                                 ("large_grid_3", "BENCH_BIG3_NX", 4096, 20)):
        big = int(os.environ.get(env, default))
        if big:
            row[key] = time_large_grid(*compile_large_grid(big, n, re))
    print(json.dumps(row))


def bench_sequenced():
    """Grid-sequenced 1024^2 cavity to 1e-5 (the BASELINE headline metric)."""
    from naviflow_tpu.algorithms import (SIMPLEConfig, grid_sequence_solve,
                                         simple_solve)
    from naviflow_tpu.postprocessing.validation import infinity_norm_error

    nx = int(os.environ.get("BENCH_NX", 1024))
    re = float(os.environ.get("BENCH_RE", 1000))
    tol = float(os.environ.get("BENCH_TOL", 1e-5))
    mesh, fluid, bc = cavity(nx, re)
    cfg = SIMPLEConfig(max_iterations=int(os.environ.get("BENCH_MAXIT", 20000)),
                       tolerance=tol)
    mom, pres = sequenced_solvers()
    # cold: the wall includes compiling each level's program
    wall, (final, diag, summ) = timed(
        lambda: grid_sequence_solve(mesh, fluid, bc, simple_solve, cfg,
                                    momentum=mom, pressure=pres))
    err = infinity_norm_error(final.u, final.v, mesh, re)
    total_updates = sum(s["iterations"] * s["nx"] ** 2 for s in summ)
    print(json.dumps({
        "metric": f"wall_clock_to_{tol:g}_residual_{nx}x{nx}_Re{int(re)}_sequenced_GMG_SIMPLE",
        "value": wall,
        "unit": "s",
        "vs_baseline": None,  # the reference cannot run this configuration
        "converged": all(s["converged"] for s in summ),
        "fine_level_iterations": summ[-1]["iterations"],
        "levels": summ,
        "ghia_infinity_error": err,
        "ghia_passed": bool(err < GHIA_GATE),
        "mlups_outer": total_updates / wall / 1e6,
        "device": device_info(),
    }))


if __name__ == "__main__":
    main()
