"""Shared outer-iteration harness for the SIMPLE-family algorithms.

The reference's ``BaseAlgorithm`` (``solver/Algorithms/base_algorithm.py``)
holds mutable fields and a Python while-loop per algorithm; here the shared
machinery is a generic ``lax.while_loop`` driver over an algorithm-provided
step function.  Each algorithm module supplies

    step(u, v, p, extra) -> (u, v, p, extra, StepInfo)

where ``extra`` is an algorithm-specific carried pytree (e.g. SIMPLEC's
dynamic alpha_p) and ``StepInfo`` carries the per-iteration residual norms,
inner-iteration count, and residual fields.  The driver owns convergence
(``max(u_norm, v_norm) <= tol``, reference ``simple.py:174``), fixed-size
history buffers, and the final diagnostics.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.state import FlowState
from ..ops.poisson import max_interior_divergence


class StepInfo(NamedTuple):
    u_norm: jax.Array
    v_norm: jax.Array
    p_norm: jax.Array
    inner_iterations: jax.Array
    r_u: jax.Array
    r_v: jax.Array
    r_p: jax.Array


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SolveDiagnostics:
    """Per-iteration histories (fixed-size buffers, valid up to ``iterations``)."""

    iterations: jax.Array  # int32: outer iterations executed
    converged: jax.Array  # bool
    final_residual: jax.Array
    u_res_history: jax.Array  # (max_iterations,)
    v_res_history: jax.Array
    p_res_history: jax.Array
    total_res_history: jax.Array
    inner_iters_history: jax.Array  # (max_iterations,) int32 pressure inner iters
    u_residual_field: jax.Array
    v_residual_field: jax.Array
    p_residual_field: jax.Array
    max_divergence: jax.Array
    # Failure-detection hooks (reference ``simple.py:108-208`` stall detector
    # and SURVEY §5 divergence-handling): ``diverged`` = non-finite residual;
    # ``stalled`` = <0.1% relative residual change over a 50-iteration window
    # (host loop only; the reference logs the stall without breaking).
    diverged: jax.Array
    stalled: jax.Array


def default_loop_mode() -> str:
    """'fused' everywhere: one XLA program for the whole solve, zero host
    syncs until completion.  The host-driven and chunked loops exist for
    mid-run callbacks: stall detection, checkpointing, live logging."""
    return "fused"


def build_solver(step, *, max_iterations, tolerance, dx, dy, extra0_fn, loop: str,
                 refresh_step=None, refresh_every: int = 0):
    """Return solve(u0, v0, p0) for the requested loop mode.

    ``refresh_step``/``refresh_every``: optional periodic-variant step (the
    lagged-multigrid rebuild, ``algorithms.lagged``) run unconditionally as
    the first iteration of every ``refresh_every``-iteration block — the
    conditional-free form of a per-step ``lax.cond`` cadence, so no
    untaken rebuild branch sits inside the while loop."""
    if loop == "auto":
        loop = default_loop_mode()
    periodic = dict(refresh_step=refresh_step, refresh_every=refresh_every)
    if loop == "fused":
        jitted = jax.jit(
            lambda u0, v0, p0: run_outer_loop(
                step, u0, v0, p0, extra0_fn(u0.dtype),
                max_iterations=max_iterations, tolerance=tolerance, dx=dx, dy=dy,
                **periodic,
            )
        )

        def solve(u0, v0, p0, on_chunk=None):
            if on_chunk is not None:
                raise ValueError("on_chunk requires loop='chunked[:K]'")
            return jitted(u0, v0, p0)
        return solve
    if loop == "host":
        def solve(u0, v0, p0, on_chunk=None):
            if on_chunk is not None:
                raise ValueError("on_chunk requires loop='chunked[:K]'")
            return run_outer_loop_host(
                step, u0, v0, p0, extra0_fn(u0.dtype),
                max_iterations=max_iterations, tolerance=tolerance, dx=dx, dy=dy,
                **periodic,
            )
        return solve
    if loop.startswith("chunked"):
        chunk = int(loop.split(":")[1]) if ":" in loop else 400
        def solve(u0, v0, p0, on_chunk=None):
            return run_outer_loop_chunked(
                step, u0, v0, p0, extra0_fn(u0.dtype),
                max_iterations=max_iterations, tolerance=tolerance, dx=dx, dy=dy,
                chunk=chunk, on_chunk=on_chunk, **periodic,
            )
        return solve
    raise ValueError(f"Unknown loop mode: {loop}")


def init_carry(u0, v0, p0, extra0, n: int):
    dtype = u0.dtype
    return dict(
        u=u0,
        v=v0,
        p=p0,
        extra=extra0,
        it=jnp.asarray(0, jnp.int32),
        total=jnp.asarray(jnp.inf, dtype),
        hist_u=jnp.zeros((n,), dtype),
        hist_v=jnp.zeros((n,), dtype),
        hist_p=jnp.zeros((n,), dtype),
        hist_total=jnp.zeros((n,), dtype),
        hist_inner=jnp.zeros((n,), jnp.int32),
        r_u=jnp.zeros_like(u0),
        r_v=jnp.zeros_like(v0),
        r_p=jnp.zeros_like(p0),
    )


def make_body(step: Callable):
    """Carry -> carry body shared by the fused and host-driven loops."""

    def body(c):
        u, v, p, extra, info = step(c["u"], c["v"], c["p"], c["extra"])
        dtype = c["total"].dtype
        total = jnp.maximum(info.u_norm, info.v_norm)
        it = c["it"]
        return dict(
            u=u,
            v=v,
            p=p,
            extra=extra,
            it=it + 1,
            total=total.astype(dtype),
            hist_u=c["hist_u"].at[it].set(info.u_norm.astype(dtype)),
            hist_v=c["hist_v"].at[it].set(info.v_norm.astype(dtype)),
            hist_p=c["hist_p"].at[it].set(info.p_norm.astype(dtype)),
            hist_total=c["hist_total"].at[it].set(total.astype(dtype)),
            hist_inner=c["hist_inner"].at[it].set(info.inner_iterations),
            r_u=info.r_u,
            r_v=info.r_v,
            r_p=info.r_p,
        )

    return body


def finalize(c, *, tolerance, dx, dy):
    diag = SolveDiagnostics(
        iterations=c["it"],
        converged=c["total"] <= tolerance,
        final_residual=c["total"],
        u_res_history=c["hist_u"],
        v_res_history=c["hist_v"],
        p_res_history=c["hist_p"],
        total_res_history=c["hist_total"],
        inner_iters_history=c["hist_inner"],
        u_residual_field=c["r_u"],
        v_residual_field=c["r_v"],
        p_residual_field=c["r_p"],
        max_divergence=max_interior_divergence(c["u"], c["v"], dx=dx, dy=dy),
        diverged=jnp.logical_not(jnp.isfinite(c["total"])),
        stalled=jnp.asarray(False),
    )
    return FlowState(u=c["u"], v=c["v"], p=c["p"]), diag


def run_outer_loop(
    step: Callable,
    u0,
    v0,
    p0,
    extra0: Any,
    *,
    max_iterations: int,
    tolerance: float,
    dx: float,
    dy: float,
    refresh_step=None,
    refresh_every: int = 0,
):
    """Run ``step`` to convergence inside a single ``lax.while_loop``
    (the fully fused form — one XLA program for the whole solve).

    With ``refresh_step``: nested loops — every outer trip runs one
    ``refresh_step`` iteration followed by up to ``refresh_every - 1``
    plain iterations, preserving the per-iteration convergence check."""
    n = max_iterations
    carry0 = init_carry(u0, v0, p0, extra0, n)
    body = make_body(step)

    def cond(c):
        return (c["it"] < n) & (c["total"] > tolerance)

    if refresh_step is None:
        c = jax.lax.while_loop(cond, body, carry0)
        return finalize(c, tolerance=tolerance, dx=dx, dy=dy)

    body_r = make_body(refresh_step)

    def outer_body(c):
        c = body_r(c)
        limit = jnp.minimum(c["it"] + (refresh_every - 1), n)

        def icond(c):
            return (c["it"] < limit) & (c["total"] > tolerance)

        return jax.lax.while_loop(icond, body, c)

    c = jax.lax.while_loop(cond, outer_body, carry0)
    return finalize(c, tolerance=tolerance, dx=dx, dy=dy)


class _StallDetector:
    """Reference ``simple.py:194-208``: residual change < 0.1% over a
    ~``window``-iteration span ⇒ stalled (the reference logs without
    breaking; we record the flag in the diagnostics).

    The host-side loops sample the residual once per ``sample_every``
    iterations, so the window is tracked in *samples*:
    ``ceil(window / sample_every) + 1`` of them span >= ``window``
    iterations.  ``update`` returns the current verdict (re-evaluated every
    sample, matching the reference's per-iteration log semantics).
    """

    def __init__(self, window: int = 50, sample_every: int = 10):
        self.n_samples = max(2, -(-window // max(sample_every, 1)) + 1)
        self.recent: list = []
        self.stalled = False

    def update(self, total: float) -> bool:
        self.recent.append(total)
        if len(self.recent) > self.n_samples:
            self.recent = self.recent[-self.n_samples:]
        if len(self.recent) == self.n_samples:
            lo, hi = min(self.recent), max(self.recent)
            avg = sum(self.recent) / len(self.recent)
            self.stalled = avg > 0 and (hi - lo) / avg < 1e-3
        return self.stalled


def run_outer_loop_chunked(
    step: Callable,
    u0,
    v0,
    p0,
    extra0: Any,
    *,
    max_iterations: int,
    tolerance: float,
    dx: float,
    dy: float,
    chunk: int = 400,
    on_chunk=None,
    refresh_step=None,
    refresh_every: int = 0,
):
    """Fused chunks of up to ``chunk`` iterations with a host convergence
    check in between.

    Each chunk is one fused while-loop program; the per-chunk host sync is
    amortized over ``chunk`` iterations.  Loop mode string: ``"chunked"``
    or ``"chunked:<K>"``.

    ``on_chunk(iteration, total, carry)`` runs on the host at each chunk
    boundary — the hook for periodic checkpointing, live logging, and
    Ghia-error tracking (the reference's ``track_infinity_norm`` cadence,
    ``simple.py:180-187``).  Returning ``False`` stops the solve early.
    """
    n = max_iterations
    body = make_body(step)
    body_r = make_body(refresh_step) if refresh_step is not None else None

    # the carry is donated: at 2048^2 it is ~20 fields' worth of device
    # memory, and every chunk would otherwise copy all of them
    @functools.partial(jax.jit, donate_argnums=0)
    def run_chunk(c):
        start = c["it"]
        limit = jnp.minimum(start + chunk, n)

        def cond(c):
            return (c["it"] < limit) & (c["total"] > tolerance)

        if body_r is None:
            return jax.lax.while_loop(cond, body, c)

        # refresh at the chunk start and every refresh_every iterations
        # within it (chunks not divisible by the cadence refresh slightly
        # more often than every K — never less)
        def outer_body(c):
            c = body_r(c)
            ilimit = jnp.minimum(c["it"] + (refresh_every - 1), limit)

            def icond(c):
                return (c["it"] < ilimit) & (c["total"] > tolerance)

            return jax.lax.while_loop(icond, body, c)

        return jax.lax.while_loop(cond, outer_body, c)

    fin = jax.jit(lambda c: finalize(c, tolerance=tolerance, dx=dx, dy=dy))
    c = init_carry(u0, v0, p0, extra0, n)
    detector = _StallDetector(sample_every=chunk)
    while True:
        c = run_chunk(c)
        total = float(c["total"])
        it = int(c["it"])
        detector.update(total)
        if on_chunk is not None:
            if on_chunk(it, total, c) is False:
                break
        if total <= tolerance or it >= n or not np.isfinite(total):
            break
    state, diag = fin(c)
    if detector.stalled:
        diag = dataclasses.replace(diag, stalled=jnp.asarray(True))
    return state, diag


def run_outer_loop_host(
    step: Callable,
    u0,
    v0,
    p0,
    extra0: Any,
    *,
    max_iterations: int,
    tolerance: float,
    dx: float,
    dy: float,
    check_every: int = 10,
    refresh_step=None,
    refresh_every: int = 0,
):
    """Host-driven outer loop: the per-iteration body is one jitted program;
    the host enqueues ``check_every`` steps at a time (JAX async dispatch
    keeps the device busy) and syncs only on the periodic convergence check.
    It compiles only the step, not the whole while-loop program, and trades
    one scalar fetch per ``check_every`` iterations for that.  Numerics are
    identical to :func:`run_outer_loop`.
    """
    n = max_iterations
    body = jax.jit(make_body(step), donate_argnums=0)
    body_r = (jax.jit(make_body(refresh_step), donate_argnums=0)
              if refresh_step is not None else None)
    fin = jax.jit(
        lambda c: finalize(c, tolerance=tolerance, dx=dx, dy=dy)
    )

    c = init_carry(u0, v0, p0, extra0, n)
    done = 0
    detector = _StallDetector(sample_every=check_every)
    while done < n:
        k = min(check_every, n - done)
        for i in range(k):
            if body_r is not None and (done + i) % refresh_every == 0:
                c = body_r(c)
            else:
                c = body(c)
        done += k
        total = float(c["total"])
        if total <= tolerance:
            break
        if not np.isfinite(total):
            break  # diverged — stop burning device time
        detector.update(total)
    state, diag = fin(c)
    if detector.stalled:
        diag = dataclasses.replace(diag, stalled=jnp.asarray(True))
    return state, diag
