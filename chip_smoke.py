"""Smoke test of the solver's main path on the GPU.

    python chip_smoke.py              # phases 1-7 on one card
    python chip_smoke.py --devices 4  # only the four-card phase and its comparison

Everything runs in this one process: a second JAX process could not open
the card while this one holds it.  Each phase prints one line with its wall
seconds, its compile seconds (lowering and XLA compilation, as JAX reports
them, summed over the programs; a phase that compiles independent programs
side by side can report more compile seconds than wall seconds) and its
result.  The last line is one JSON object,
``{"ok": ..., "device": {"platform", "kind", "count"}}``.  The script exits
non-zero with ``"ok": false`` when any phase fails, when JAX finds no GPU,
or when the repository is not beside it; it never falls back to the CPU.

Phases (one card):

1. device      — the GPU, the card's name and power limit, JAX version,
                 ``XLA_FLAGS`` and the compile-cache directory;
2. headline    — 63^2 Re=100 cavity, SIMPLE + BiCGSTAB momentum + Galerkin
                 multigrid pressure (bench.py's configuration) to 1e-5;
3. cli         — ``naviflow_tpu.cli.main(["run", ...])`` in this process;
4. reference   — 20 outer iterations in float32 against float64 on the card,
                 at 255^2 (vertex multigrid) and 256^2 (cell-centred
                 multigrid, Chebyshev momentum, one fixed V-cycle);
5. large       — the large-grid configuration at 1024^2, 2048^2, 4096^2:
                 warm ms per iteration, memory analysis, peak device memory;
6. sequenced   — grid-sequenced 1024^2 Re=1000 cavity to 1e-5;
7. algorithms  — SIMPLEC, SIMPLER, PISO to 1e-4 at 127^2, then a Newton
                 finish.
"""

import argparse
import concurrent.futures
import contextlib
import io
import json
import math
import os
import sys
import tempfile
import time
import traceback

GHIA_GATE = 0.1
# float32 against float64 after 20 outer iterations.  float32 carries ~7
# digits; on the CPU the two agree to ~3e-7 (fields) and ~1e-6 (residual
# histories) at 63^2-128^2.  The bounds leave 30-100x for the GPU's other
# summation order, and still catch a contraction that silently ran in TF32
# (~3 digits).
REF_FIELD_RTOL = 1e-5
REF_HISTORY_RTOL = 1e-4
# lowering and XLA compilation; tracing is left out because JAX reports a
# nested jit's trace inside its caller's, which would count it twice
COMPILE_EVENTS = ("/jax/core/compile/jaxpr_to_mlir_module_duration",
                  "/jax/core/compile/backend_compile_duration")


class PhaseFailed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseFailed(msg)


class CompileClock:
    """Sums the compile durations JAX reports through ``jax.monitoring``."""

    def __init__(self):
        import jax

        self.seconds = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event, duration, **_):
        if event in COMPILE_EVENTS:
            self.seconds += duration


def run_phase(name, fn, clock):
    """Run one phase; print its line; return whether it passed."""
    c0, t0 = clock.seconds, time.perf_counter()
    try:
        detail, ok = fn(), True
    except Exception as e:  # a failed phase is reported, and fails the run
        detail, ok = f"{type(e).__name__}: {e}", False
        traceback.print_exc(file=sys.stderr)
    wall, comp = time.perf_counter() - t0, clock.seconds - c0
    print(f"phase {name}: wall {wall:.3f} s, compile {comp:.3f} s, "
          f"{'PASS' if ok else 'FAIL'} {json.dumps(detail, default=str)}",
          flush=True)
    return ok


def concurrently(*calls):
    """Run independent ``(fn, *args)`` calls in threads and return their
    results in order.  XLA compiles outside the interpreter lock, so the
    compilations of independent programs overlap; the first failure
    raises."""
    with concurrent.futures.ThreadPoolExecutor(len(calls)) as pool:
        futures = [pool.submit(*call) for call in calls]
        return [f.result() for f in futures]


def _relerr(a, b):
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


# --------------------------------------------------------------------------
# phases


def phase_device():
    import jax
    import bench
    from naviflow_tpu.utils.jaxcache import enable_persistent_cache

    dev = jax.devices()[0]
    check(dev.platform == "gpu", f"JAX found platform {dev.platform!r}, no GPU")
    card = bench.card_info()
    print(f"card: {card}", flush=True)
    return {"kind": dev.device_kind, "count": len(jax.devices()),
            "card": card, "jax": jax.__version__,
            "XLA_FLAGS": os.environ.get("XLA_FLAGS", ""),
            "compile_cache": enable_persistent_cache()}


def phase_headline(nx=63, re=100.0, tol=1e-5, gate=GHIA_GATE):
    import bench
    import naviflow_tpu as nf
    from naviflow_tpu.algorithms import SIMPLEConfig, simple_solve
    from naviflow_tpu.postprocessing.validation import infinity_norm_error

    mesh, fluid, bc = bench.cavity(nx, re)
    mom, pres = bench.headline_solvers()
    args = (mesh, fluid, bc, nf.initialize_state(mesh, bc),
            SIMPLEConfig(max_iterations=4000, tolerance=tol), mom, pres)
    bench.timed(simple_solve, *args)  # compile + first execution
    warm, (final, diag) = bench.timed(simple_solve, *args)
    err = infinity_norm_error(final.u, final.v, mesh, re)
    div = float(diag.max_divergence)
    out = {"outer_iterations": int(diag.iterations),
           "final_residual": float(diag.final_residual),
           "warm_seconds": warm,
           "warm_ms_per_iteration": warm / int(diag.iterations) * 1e3,
           "ghia_infinity_error": err, "max_divergence": div}
    check(bool(diag.converged), f"not converged: {out}")
    check(err < gate, f"Ghia error {err:.4f} >= {gate}")
    check(math.isfinite(div) and div < 1e-3, f"max divergence {div}")
    return out


def phase_cli(nx=127, re=1000.0, max_iterations=20000, gate=GHIA_GATE):
    import numpy as np
    import naviflow_tpu as nf
    from naviflow_tpu.cli import main as cli_main
    from naviflow_tpu.postprocessing.validation import infinity_norm_error

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cavity.npz")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli_main(["run", "--nx", str(nx), "--re", str(re),
                           "--pressure", "multigrid",
                           "--max-iterations", str(max_iterations),
                           "--save", path])
        check(rc == 0, f"cli returned {rc}")
        summary = json.loads(buf.getvalue().strip().splitlines()[-1])
        sol = np.load(path)
        err = infinity_norm_error(sol["u"], sol["v"],
                                  nf.StructuredMesh(nx=nx, ny=nx), re)
    out = {k: summary.get(k) for k in ("iterations", "converged",
                                       "final_residual", "wall_seconds")}
    out["ghia_infinity_error"] = err
    check(summary.get("converged") is True, f"not converged: {out}")
    check(err < gate, f"Ghia error {err:.4f} >= {gate}")
    return out


def _reference_run(nx, n_iters, dtype):
    """``n_iters`` fixed outer iterations at ``nx^2`` in ``dtype``: odd
    grids take the vertex hierarchy with the headline solvers, even grids
    the cell-centred one with the large-grid solvers."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import bench
    import naviflow_tpu as nf
    from naviflow_tpu.algorithms import SIMPLEConfig, simple_solve

    mesh, fluid, bc = bench.cavity(nx, 100.0)
    mom, pres = (bench.headline_solvers() if nx % 2
                 else bench.large_grid_solvers())
    cfg = SIMPLEConfig(max_iterations=n_iters, tolerance=0.0)
    x64 = (jax.enable_x64(True) if dtype == jnp.float64
           else contextlib.nullcontext())
    with x64:  # thread-local: the float32 runs beside it are unaffected
        state = nf.initialize_state(mesh, bc, dtype)
        run = lambda: simple_solve(mesh, fluid, bc, state, cfg, momentum=mom,
                                   pressure=pres, loop="fused")
        final, diag = jax.block_until_ready(run())
    check(final.u.dtype == dtype, f"{nx}^2 ran in {final.u.dtype}, not {dtype}")
    return final, np.asarray(diag.total_res_history, np.float64), run


def phase_reference(sizes=(255, 256), n_iters=20):
    """float32 on the card against float64 on the card, same algorithm."""
    import jax.numpy as jnp
    import numpy as np
    import bench

    runs = [(nx, dt) for nx in sizes for dt in (jnp.float32, jnp.float64)]
    out = dict(zip(runs, concurrently(
        *[(_reference_run, nx, n_iters, dt) for nx, dt in runs])))
    rows = []
    for nx in sizes:
        (f32, h32, run32), (f64, h64, _) = (out[(nx, jnp.float32)],
                                            out[(nx, jnp.float64)])
        warm32, _ = bench.timed(run32)  # alone on the card, compiled
        row = {"nx": nx,
               "uv_rel_linf": max(_relerr(f32.u, f64.u), _relerr(f32.v, f64.v)),
               "history_rel": float(np.max(np.abs(h32 - h64) / np.abs(h64))),
               "residual_last": float(h64[-1]),
               "f32_warm_ms_per_iteration": warm32 / n_iters * 1e3}
        rows.append(row)
        check(row["uv_rel_linf"] <= REF_FIELD_RTOL,
              f"{nx}^2 fields differ: {row}")
        check(row["history_rel"] <= REF_HISTORY_RTOL,
              f"{nx}^2 histories differ: {row}")
    return {"tolerance": {"uv_rel_linf": REF_FIELD_RTOL,
                          "history_rel": REF_HISTORY_RTOL}, "cases": rows}


def phase_large(sizes=((1024, 100), (2048, 40), (4096, 20))):
    import bench

    programs = concurrently(*[(bench.compile_large_grid, nx, n)
                              for nx, n in sizes])
    rows = []
    for program in programs:  # timed one after another, alone on the card
        row = bench.time_large_grid(*program)
        nx = row["nx"]
        rows.append(row)
        print(f"  large {nx}^2: {row['ms_per_iteration']:.4f} ms/iter, "
              f"compile {row['compile_seconds']:.1f} s, temp "
              f"{row['temp_bytes']} B, peak {row['peak_bytes_in_use']} B",
              flush=True)
        check(row["finite"], f"{nx}^2 residual not finite: {row}")
        check(row["residual_last"] < row["residual_first"],
              f"{nx}^2 residual did not decrease: {row}")
    return rows


def phase_sequenced(nx=1024, re=1000.0, tol=1e-5, gate=GHIA_GATE):
    import bench
    from naviflow_tpu.algorithms import SIMPLEConfig, grid_sequence_solve
    from naviflow_tpu.algorithms.sequencing import build_ladder
    from naviflow_tpu.postprocessing.validation import infinity_norm_error

    mesh, fluid, bc = bench.cavity(nx, re)
    mom, pres = bench.sequenced_solvers()
    cfg = SIMPLEConfig(max_iterations=20000, tolerance=tol)
    # every level's fused solve compiled up front, side by side; the
    # sequence then runs them coarse to fine
    ladder = build_ladder(nx)
    programs = dict(zip(ladder, concurrently(*[
        (bench.compile_fused, *bench.cavity(n, re), cfg, mom, pres)
        for n in ladder])))

    def level_solve(level_mesh, level_fluid, level_bc, state, level_cfg,
                    **_):
        check(level_cfg == cfg and level_fluid == fluid,
              "level configuration differs from the compiled one")
        return programs[level_mesh.nx][0](state)

    final, _, summ = grid_sequence_solve(mesh, fluid, bc, level_solve, cfg,
                                         momentum=mom, pressure=pres)
    err = infinity_norm_error(final.u, final.v, mesh, re)
    out = {"levels": {s["nx"]: s["iterations"] for s in summ},
           "compile_seconds": {n: p[1] for n, p in programs.items()},
           "ghia_infinity_error": err}
    check(all(s["converged"] for s in summ), f"a level did not converge: {summ}")
    check(err < gate, f"Ghia error {err:.4f} >= {gate}")
    return out


def _algorithm_run(name, nx, re, tol, newton_tol):
    import bench
    import naviflow_tpu as nf
    from naviflow_tpu import algorithms as alg

    solve, cfg_cls = {"simplec": (alg.simplec_solve, alg.SIMPLECConfig),
                      "simpler": (alg.simpler_solve, alg.SIMPLERConfig),
                      "piso": (alg.piso_solve, alg.PISOConfig)}[name]
    mesh, fluid, bc = bench.cavity(nx, re)
    mom, pres = bench.headline_solvers()
    state, diag = solve(mesh, fluid, bc, nf.initialize_state(mesh, bc),
                        cfg_cls(max_iterations=5000, tolerance=tol),
                        momentum=mom, pressure=pres)
    out = {name: {"iterations": int(diag.iterations),
                  "final_residual": float(diag.final_residual)}}
    check(bool(diag.converged), f"{name} not converged: {out}")
    if newton_tol is not None:  # a Newton finish from this fixed point
        _, ndiag = alg.newton_solve(mesh, fluid, bc, state,
                                    alg.NewtonConfig(tolerance=newton_tol,
                                                     max_newton=10))
        out["newton"] = {"iterations": ndiag.iterations,
                         "final_residual": float(ndiag.final_residual)}
        check(bool(ndiag.converged), f"newton not converged: {out}")
    return out


def phase_algorithms(nx=127, re=100.0, tol=1e-4, newton_tol=1e-6):
    """SIMPLEC (then Newton), SIMPLER and PISO side by side."""
    out = {}
    for part in concurrently(
            (_algorithm_run, "simplec", nx, re, tol, newton_tol),
            (_algorithm_run, "simpler", nx, re, tol, None),
            (_algorithm_run, "piso", nx, re, tol, None)):
        out.update(part)
    return out


def phase_four_cards(nx=1024, n_iters=20, invariance_nx=256):
    """The distributed SIMPLE path on a 2x2 mesh against one card, and the
    same solve on (1, 4) and (2, 2) meshes."""
    import jax
    import naviflow_tpu as nf
    from naviflow_tpu.parallel.dist_simple import (DistributedConfig,
                                                   distributed_simple_solve)
    from naviflow_tpu.parallel.sharding import make_device_mesh

    devices = jax.devices()
    check(len(devices) >= 4, f"{len(devices)} devices, need 4")
    cfg = DistributedConfig(max_iterations=n_iters, tolerance=0.0,
                            check_every=n_iters, pressure_solver="mgcg",
                            pressure_tol=1e-6, pressure_max_iter=60)

    def solve(n, dmesh):
        mesh = nf.StructuredMesh(nx=n, ny=n)
        fluid = nf.FluidProperties(density=1.0, reynolds_number=100.0)
        bc = nf.lid_driven_cavity(1.0)
        final, diag = distributed_simple_solve(
            mesh, fluid, bc, nf.initialize_state(mesh, bc), dmesh, cfg)
        return jax.block_until_ready(final), diag

    one, _ = solve(nx, make_device_mesh(1))
    four, diag4 = solve(nx, make_device_mesh(4, shape=(2, 2)))
    cards = sorted(d.id for d in four.p.sharding.device_set)
    print(f"  2x2 p on devices {cards}, u on "
          f"{sorted(d.id for d in four.u.sharding.device_set)}", flush=True)
    err = max(_relerr(four.u, one.u), _relerr(four.v, one.v))
    inv = {}
    for shape in ((1, 4), (2, 2)):
        f, _ = solve(invariance_nx, make_device_mesh(4, shape=shape))
        inv[shape] = f
    err_inv = max(_relerr(inv[(1, 4)].u, inv[(2, 2)].u),
                  _relerr(inv[(1, 4)].v, inv[(2, 2)].v))
    peaks = {d.id: (d.memory_stats() or {}).get("peak_bytes_in_use")
             for d in devices[:4]}
    out = {"uv_rel_linf_2x2_vs_1": err, "uv_rel_linf_1x4_vs_2x2": err_inv,
           "final_residual": diag4["final_residual"], "p_devices": cards,
           "peak_bytes_in_use": peaks, "tolerance": REF_FIELD_RTOL}
    check(len(cards) == 4, f"shards on {cards}, not four cards")
    check(err <= REF_FIELD_RTOL, f"2x2 against one card: {err}")
    check(err_inv <= REF_FIELD_RTOL, f"(1,4) against (2,2): {err_inv}")
    return out


ONE_CARD_PHASES = (("headline", phase_headline), ("cli", phase_cli),
                   ("reference", phase_reference), ("large", phase_large),
                   ("sequenced", phase_sequenced),
                   ("algorithms", phase_algorithms))


def select_phases(devices: int):
    """The phases a run on ``devices`` (1 or 4) cards runs after phase 1."""
    if devices == 4:
        return (("four_cards", phase_four_cards),)
    return ONE_CARD_PHASES


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--devices", type=int, default=1, choices=(1, 4))
    args = parser.parse_args(argv)
    device = None
    try:
        import jax

        dev = jax.devices()[0]
        device = {"platform": dev.platform, "kind": dev.device_kind,
                  "count": len(jax.devices())}
        clock = CompileClock()
        ok = run_phase("device", phase_device, clock)
        if ok:
            for name, fn in select_phases(args.devices):
                ok = run_phase(name, fn, clock) and ok
    except Exception as e:  # no JAX backend, or the repository is missing
        print(f"chip_smoke: {type(e).__name__}: {e}", flush=True)
        ok = False
    line = {"ok": ok}
    if device is not None:
        line["device"] = device
    print(json.dumps(line), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
