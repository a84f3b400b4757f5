"""Momentum predictor solvers (u*, v* from the linearized momentum equations).

JAX rebuild of the reference momentum-solver family.  The reference
delegates its inner linear solves to native libraries (PyAMG C++, PETSc C,
SuperLU ILU — ``AMG_solver.py``, ``matrix_momentum_solver.py``,
``matrix_free_momentum.py``); here each solver is a fused, jit-compiled
matrix-free iteration on the 5-point stencil.

Contract preserved from the reference
(``base_momentum_solver.py:144-204``): each solve returns
``(star_field, d_coefficient, residual_field, residual_norm)`` where

* the linear system solved is the *relaxed* one (``a_p/alpha``,
  ``src + (1-alpha)(a_p/alpha) u_old`` — ``matrix_free_momentum.py:429-430``),
* ``d = spacing / a_p_relaxed`` (``matrix_free_momentum.py:449``),
* the residual is the *unrelaxed* algebraic residual
  ``r = src_un - A_un x`` with its L2 norm over interior nodes
  (``AMG_solver.py:240-296``, ``matrix_free_momentum.py:380-400``).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..core.bc import BoundaryConditions, apply_velocity_bcs
from ..ops.highorder import (
    MomentumCoeffs9,
    apply_momentum9,
    neighbor_sum9,
    relax_coefficients9,
    u_momentum_coefficients9,
    v_momentum_coefficients9,
)
from ..ops.powerlaw import (
    d_coefficient,
    relax_coefficients,
    u_momentum_coefficients,
    v_momentum_coefficients,
)
from ..ops.stencil import (
    apply_stencil,
    interior_mask,
    neighbor_sum,
    shift_e,
    shift_n,
    shift_s,
    shift_w,
)


def _apply(x, c):
    return apply_momentum9(x, c) if isinstance(c, MomentumCoeffs9) else apply_stencil(x, c)


def _nbsum(x, c):
    return neighbor_sum9(x, c) if isinstance(c, MomentumCoeffs9) else neighbor_sum(x, c)


def _assemble_coeffs(u, v, p, *, dx, dy, rho, mu, scheme, is_u):
    if scheme == "power_law":
        fn = u_momentum_coefficients if is_u else v_momentum_coefficients
        return fn(u, v, p, dx=dx, dy=dy, rho=rho, mu=mu)
    fn = u_momentum_coefficients9 if is_u else v_momentum_coefficients9
    return fn(u, v, p, dx=dx, dy=dy, rho=rho, mu=mu, scheme=scheme)


def _relax(coeffs, field, alpha):
    if isinstance(coeffs, MomentumCoeffs9):
        return relax_coefficients9(coeffs, field, alpha)
    return relax_coefficients(coeffs, field, alpha)


@dataclasses.dataclass(frozen=True)
class JacobiMomentumConfig:
    """Fixed-sweep weighted-Jacobi momentum solve
    (reference ``jacobi_solver.JacobiMomentumSolver``)."""

    n_sweeps: int = 1
    scheme: str = "power_law"  # 'power_law' | 'quick' | 'luds' | 'upwind'
    # error-free residual evaluation (ops/compensated.py) — enables 1e-7
    # outer targets on the f32 path (one bandwidth-bound pass)
    compensated_residual: bool = False
    kind: str = "jacobi"


@dataclasses.dataclass(frozen=True)
class RBGSMomentumConfig:
    """Fixed-sweep red-black Gauss-Seidel momentum solve — a parallel
    stand-in for the reference's sequential-GS options."""

    n_sweeps: int = 2
    omega: float = 1.0
    scheme: str = "power_law"
    kind: str = "rbgs"


@dataclasses.dataclass(frozen=True)
class ChebyshevMomentumConfig:
    """Reduction-LIGHT momentum inner solve: fixed-degree Chebyshev
    iteration on the Jacobi-preconditioned relaxed momentum system.

    The momentum BiCGSTAB spends each Krylov iteration on 4 dots + 2
    norms, each a full-array reduction that serializes the step.  The
    relaxed momentum system is strongly diagonally dominant (Patankar
    relaxation divides the diagonal by ``alpha``: the Jacobi iteration
    ratio is bounded by ~``alpha`` + flux-imbalance), so a fixed-degree
    Chebyshev polynomial in ``D^-1 A`` — ``degree`` fused stencil
    applies, ZERO global reductions in the iteration — reaches BiCGSTAB-
    grade error reduction for this inner role.  Eigenvalue bounds come
    from one Gershgorin max-reduction per solve (2 barriers/solve total
    vs BiCGSTAB's 6/iteration); cf. the reference's own fixed-sweep
    ``jacobi_solver.JacobiMomentumSolver`` (the role model) and its
    omega-tuning studies (``spectral_radius_damping.py``), whose
    reduction-free upgrade this is (SURVEY §7)."""

    degree: int = 6
    # spectral-bound safety margin on the Gershgorin radius (the momentum
    # operator is nonsymmetric; a slightly inflated interval keeps the
    # complex convection eigenvalues inside the Chebyshev ellipse)
    bound_margin: float = 1.05
    scheme: str = "power_law"
    compensated_residual: bool = False
    kind: str = "chebyshev"


@dataclasses.dataclass(frozen=True)
class IDRSMomentumConfig:
    """IDR(s) momentum solve (reference ``matrix_free_momentum._idrs``,
    :175-340 — the Sonneveld & van Gijzen induced-dimension-reduction
    method).  We implement the biorthogonal variant with van Gijzen's
    basis update ``U_k = U_{k:s} c + om*v`` (the reference overwrites U_k
    before the product, a translation slip); the shadow-space loop is
    statically unrolled (s is small), so the whole solve is one
    ``lax.while_loop`` of fused stencil ops."""

    tolerance: float = 1e-7
    max_iterations: int = 30  # outer G-space builds (~(s+1) matvecs each)
    s: int = 4
    angle: float = 0.7
    scheme: str = "power_law"
    kind: str = "idrs"


@dataclasses.dataclass(frozen=True)
class GMRESMomentumConfig:
    """Matrix-free restarted GMRES(m) momentum solve (the reference exposes
    GMRES via SciPy ``gmres`` in ``BiCGSTAB_solver.py:317-390`` /
    ``matrix_free_momentum.py:175`` and as a PETSc KSP type; the ILU
    preconditioner becomes Jacobi scaling — the relaxed momentum system is
    strongly diagonally dominant)."""

    tolerance: float = 1e-7
    max_iterations: int = 40  # total Arnoldi steps
    restart: int = 10
    scheme: str = "power_law"
    compensated_residual: bool = False
    kind: str = "gmres"


@dataclasses.dataclass(frozen=True)
class KrylovMomentumConfig:
    """Matrix-free Krylov momentum solve (reference
    ``matrix_free_momentum.py`` BiCGSTAB path, sans ILU — the relaxed
    momentum system is strongly diagonally dominant, so Jacobi-preconditioned
    BiCGSTAB converges in a handful of iterations)."""

    tolerance: float = 1e-7
    max_iterations: int = 50
    scheme: str = "power_law"
    compensated_residual: bool = False
    # 'auto': batch the u and v solves of five-point power-law systems
    # into one Krylov loop — half the serialized reduction rounds
    # (_bicgstab_pair_masked).  'off' forces sequential solves.
    batch_pair: str = "auto"
    kind: str = "bicgstab"


def _u_interior_mask(shape):
    # u solved nodes: i in [1, nx-1], j in [1, ny-2]
    return interior_mask(shape, lo_i=1, hi_i=1, lo_j=1, hi_j=1)


def _v_interior_mask(shape):
    return interior_mask(shape, lo_i=1, hi_i=1, lo_j=1, hi_j=1)


def _jacobi_sweeps(x0, c, mask, n_sweeps: int):
    """n weighted-Jacobi sweeps on interior nodes of the (relaxed) system.

    x_new = (sum(a_nb x_nb) + src) / a_p on masked nodes
    (reference ``jacobi_solver.py:68-77``, omega=1).
    """
    safe_ap = jnp.where(c.a_p == 0, jnp.ones_like(c.a_p), c.a_p)

    def body(_, x):
        x_new = (_nbsum(x, c) + c.src) / safe_ap
        return jnp.where(mask, x_new, x)

    return jax.lax.fori_loop(0, n_sweeps, body, x0)


def _rbgs_sweeps(x0, c, mask, n_sweeps: int, omega: float):
    """Red-black Gauss-Seidel with SOR on interior nodes.

    For 9-point (second-neighbor) schemes the two-color split is only an
    approximate Gauss-Seidel (the +-2 links connect same-color nodes), which
    is fine as a relaxation method."""
    shape = x0.shape
    ii = jax.lax.broadcasted_iota(jnp.int32, shape, 0)
    jj = jax.lax.broadcasted_iota(jnp.int32, shape, 1)
    red = ((ii + jj) % 2 == 0) & mask
    black = ((ii + jj) % 2 == 1) & mask
    safe_ap = jnp.where(c.a_p == 0, jnp.ones_like(c.a_p), c.a_p)

    def half(x, color):
        x_new = x + omega * ((_nbsum(x, c) + c.src) / safe_ap - x)
        return jnp.where(color, x_new, x)

    def body(_, x):
        return half(half(x, red), black)

    return jax.lax.fori_loop(0, n_sweeps, body, x0)


def _chebyshev_bounds(c, mask, margin: float = 1.05):
    """Spectral interval for ``D^-1 A`` from Gershgorin: every disk is
    centered at 1 with radius ``sum(a_nb)/a_p`` (power-law neighbor
    coefficients are nonnegative), so the spectrum lies in
    ``[1 - rho, 1 + rho]`` with ``rho = max_masked ratio`` — ONE global
    reduction per solve.  Returns ``(theta, delta, sigma1)`` scalars."""
    safe_ap = jnp.where(c.a_p == 0, jnp.ones_like(c.a_p), c.a_p)
    if isinstance(c, MomentumCoeffs9):
        from ..ops.highorder import _OFFSETS

        nb_abs = sum(jnp.abs(getattr(c, name)) for name in _OFFSETS)
    else:
        nb_abs = (jnp.abs(c.a_e) + jnp.abs(c.a_w)
                  + jnp.abs(c.a_n) + jnp.abs(c.a_s))
    ratio = jnp.where(mask, nb_abs / safe_ap, 0.0)
    rho = jnp.minimum(jnp.max(ratio) * margin, 0.999)
    lmin = 1.0 - rho
    lmax = 1.0 + rho
    theta = (lmax + lmin) / 2.0
    delta = (lmax - lmin) / 2.0
    sigma1 = theta / delta
    return theta, delta, sigma1


def _chebyshev_masked(x0, c, mask, degree: int, margin: float = 1.05):
    """Fixed-degree Chebyshev iteration on the masked momentum system,
    preconditioned by the diagonal (see :class:`ChebyshevMomentumConfig`):
    ``degree`` fused stencil applies + axpys (standard D'Azevedo/hypre
    three-term recurrence) after one Gershgorin bound."""
    theta, delta, sigma1 = _chebyshev_bounds(c, mask, margin)
    dtype = x0.dtype
    mask_f = mask.astype(dtype)
    safe_ap = jnp.where(c.a_p == 0, jnp.ones_like(c.a_p), c.a_p)
    inv_d = mask_f / safe_ap

    def A(x):
        return _apply(x, c) * mask_f

    b = c.src * mask_f
    x = x0 * mask_f
    r = b - A(x)
    d = (r * inv_d) / theta
    x = x + d
    rho_k = 1.0 / sigma1
    for _ in range(degree - 1):
        r = b - A(x)
        rho_next = 1.0 / (2.0 * sigma1 - rho_k)
        d = (rho_next * rho_k) * d + (2.0 * rho_next / delta) * (r * inv_d)
        x = x + d
        rho_k = rho_next
    return jnp.where(mask, x, x0)


def _bicgstab_masked(x0, c, mask, tol: float, maxiter: int):
    """Matrix-free BiCGSTAB restricted to masked nodes (boundary nodes are
    held fixed; Practice-B folding makes the masked system self-contained)."""
    mask_f = mask.astype(x0.dtype)
    dot = lambda a, b: jnp.sum(a * b)

    def A(x):
        return _apply(x, c) * mask_f

    b = c.src * mask_f
    r0 = b - A(x0 * mask_f)
    x = x0 * mask_f
    rhat = r0
    rho = alpha = omega_ = jnp.asarray(1.0, x0.dtype)
    v = p = jnp.zeros_like(x0)
    bnorm = jnp.sqrt(dot(b, b))
    tol2 = (tol * jnp.maximum(bnorm, 1e-30)) ** 2
    eps = jnp.asarray(jnp.finfo(x0.dtype).tiny * 1e6, x0.dtype)

    def cond(carry):
        x, r, rhat, rho, alpha, omega_, v, p, k, ok = carry
        return ok & (k < maxiter) & (dot(r, r) > tol2)

    def body(carry):
        x, r, rhat, rho, alpha, omega_, v, p, k, ok = carry
        rho_new = dot(rhat, r)
        good = (jnp.abs(rho) > eps) & (jnp.abs(omega_) > eps)
        beta = jnp.where(good, (rho_new / jnp.where(rho == 0, 1.0, rho))
                         * (alpha / jnp.where(omega_ == 0, 1.0, omega_)), 0.0)
        p = r + beta * (p - omega_ * v)
        v = A(p)
        denom = dot(rhat, v)
        good = good & (jnp.abs(denom) > eps)
        alpha = jnp.where(good, rho_new / jnp.where(denom == 0, 1.0, denom), 0.0)
        s = r - alpha * v
        t = A(s)
        tt = dot(t, t)
        omega_new = jnp.where(tt > eps, dot(t, s) / jnp.where(tt == 0, 1.0, tt), 0.0)
        x = x + alpha * p + omega_new * s
        r = s - omega_new * t
        return (x, r, rhat, rho_new, alpha, omega_new, v, p, k + 1, good)

    carry = (x, r0, rhat, rho, alpha, omega_, v, p, jnp.asarray(0, jnp.int32),
             jnp.asarray(True))
    x, *_ = jax.lax.while_loop(cond, body, carry)
    return jnp.where(mask, x, x0)


def _shift_e3(x):
    return jnp.pad(x[:, 1:, :], ((0, 0), (0, 1), (0, 0)))


def _shift_w3(x):
    return jnp.pad(x[:, :-1, :], ((0, 0), (1, 0), (0, 0)))


def _shift_n3(x):
    return jnp.pad(x[:, :, 1:], ((0, 0), (0, 0), (0, 1)))


def _shift_s3(x):
    return jnp.pad(x[:, :, :-1], ((0, 0), (0, 0), (1, 0)))


def _bicgstab_pair_masked(xu0, cu, mask_u, xv0, cv, mask_v,
                          tol: float, maxiter: int):
    """The u and v momentum solves BATCHED into one Krylov loop.

    The two predictor systems are independent, but running them sequentially
    doubles the serialized reduction rounds: each iteration's 4 dots + 2
    norms are full-array reductions that the next operation waits on.
    Stacking the padded systems into a ``(2, nx+1, ny+1)`` batch halves the
    number of barriers: every dot becomes one fused reduction to a ``(2,)``
    vector and every scalar of the recurrence becomes a 2-vector broadcast.

    Per-system arithmetic is IDENTICAL to :func:`_bicgstab_masked`
    (padded cells are masked out of the operator and carry zeros through
    every reduction); each system freezes — its whole carry held — once
    ITS residual passes tolerance, so iteration counts and iterates
    match the sequential solves to reduction-reassociation roundoff.
    The loop runs until both systems are done.
    """
    nxp1, ny = xu0.shape
    nx, nyp1 = xv0.shape
    M, N = max(nxp1, nx), max(ny, nyp1)

    def pad2(x, fill=0.0):
        return jnp.pad(x, ((0, M - x.shape[0]), (0, N - x.shape[1])),
                       constant_values=fill)

    def stack(fu, fv, fill=0.0):
        return jnp.stack([pad2(fu, fill), pad2(fv, fill)])

    mask = stack(mask_u.astype(xu0.dtype), mask_v.astype(xv0.dtype))
    a_e = stack(cu.a_e, cv.a_e)
    a_w = stack(cu.a_w, cv.a_w)
    a_n = stack(cu.a_n, cv.a_n)
    a_s = stack(cu.a_s, cv.a_s)
    a_p = stack(cu.a_p, cv.a_p, fill=1.0)
    b = stack(cu.src, cv.src) * mask
    x0 = stack(xu0, xv0)

    def A(x):
        return (a_p * x - a_e * _shift_e3(x) - a_w * _shift_w3(x)
                - a_n * _shift_n3(x) - a_s * _shift_s3(x)) * mask

    def dot(a, bb):
        return jnp.sum(a * bb, axis=(1, 2))

    x = x0 * mask
    r0 = b - A(x)
    rhat = r0
    ones = jnp.ones((2,), x0.dtype)
    rho = alpha = omega_ = ones
    v = p = jnp.zeros_like(x)
    bnorm = jnp.sqrt(dot(b, b))
    tol2 = (tol * jnp.maximum(bnorm, 1e-30)) ** 2
    eps = jnp.asarray(jnp.finfo(x0.dtype).tiny * 1e6, x0.dtype)

    def sel(act, new, old):
        return jnp.where(act[:, None, None], new, old)

    def cond(carry):
        x, r, rhat, rho, alpha, omega_, v, p, k, ok = carry
        return (k < maxiter) & jnp.any(ok & (dot(r, r) > tol2))

    def body(carry):
        x, r, rhat, rho, alpha, omega_, v, p, k, ok = carry
        act = ok & (dot(r, r) > tol2)
        rho_new = dot(rhat, r)
        good = (jnp.abs(rho) > eps) & (jnp.abs(omega_) > eps)
        beta = jnp.where(good, (rho_new / jnp.where(rho == 0, 1.0, rho))
                         * (alpha / jnp.where(omega_ == 0, 1.0, omega_)), 0.0)
        p_new = r + beta[:, None, None] * (p - omega_[:, None, None] * v)
        v_new = A(p_new)
        denom = dot(rhat, v_new)
        good = good & (jnp.abs(denom) > eps)
        alpha_new = jnp.where(good, rho_new / jnp.where(denom == 0, 1.0, denom),
                              0.0)
        s = r - alpha_new[:, None, None] * v_new
        t = A(s)
        tt = dot(t, t)
        omega_new = jnp.where(tt > eps, dot(t, s) / jnp.where(tt == 0, 1.0, tt),
                              0.0)
        x_new = x + alpha_new[:, None, None] * p_new \
            + omega_new[:, None, None] * s
        r_new = s - omega_new[:, None, None] * t
        return (sel(act, x_new, x), sel(act, r_new, r), rhat,
                jnp.where(act, rho_new, rho), jnp.where(act, alpha_new, alpha),
                jnp.where(act, omega_new, omega_), sel(act, v_new, v),
                sel(act, p_new, p), k + 1, jnp.where(act, good, ok))

    carry = (x, r0, rhat, rho, alpha, omega_, v, p,
             jnp.asarray(0, jnp.int32), jnp.ones((2,), bool))
    x, *_ = jax.lax.while_loop(cond, body, carry)
    xu = jnp.where(mask_u, x[0, :nxp1, :ny], xu0)
    xv = jnp.where(mask_v, x[1, :nx, :nyp1], xv0)
    return xu, xv


def _gmres_masked(x0, c, mask, tol: float, maxiter: int, restart: int):
    """Restarted GMRES(m) on the masked momentum system with Jacobi right
    preconditioning (see GMRESMomentumConfig)."""
    from .krylov import gmres_solve

    mask_f = mask.astype(x0.dtype)

    def A(x):
        return _apply(x, c) * mask_f

    inv_d = jnp.where(c.a_p == 0, jnp.zeros_like(c.a_p), 1.0 / c.a_p) * mask_f
    M = lambda r: r * inv_d
    b = c.src * mask_f
    x, _, _ = gmres_solve(b, A, M, x0 * mask_f, tol, maxiter, restart)
    return jnp.where(mask, x, x0)


def _idrs_masked(x0, c, mask, tol: float, max_outer: int, s: int, angle: float):
    """IDR(s) on the masked momentum system (see IDRSMomentumConfig)."""
    dtype = x0.dtype
    mask_f = mask.astype(dtype)

    def A(x):
        return _apply(x, c) * mask_f

    b = c.src * mask_f
    x = x0 * mask_f
    r = b - A(x)
    P = jax.random.normal(jax.random.PRNGKey(0), (s,) + x0.shape, dtype)
    # HIGHEST: a float32 contraction may otherwise run in TF32 on the GPU
    hi = jax.lax.Precision.HIGHEST
    pdot = lambda a, w: jnp.einsum("ij,ij->", a, w, precision=hi)

    U = jnp.zeros((s,) + x0.shape, dtype)
    G = jnp.zeros((s,) + x0.shape, dtype)
    Ms = jnp.eye(s, dtype=dtype)
    om = jnp.asarray(1.0, dtype)
    bnorm = jnp.linalg.norm(b)
    tolb = tol * jnp.maximum(bnorm, 1e-30)

    def cond(carry):
        x, r, U, G, Ms, om, it = carry
        return (it < max_outer) & (jnp.linalg.norm(r) >= tolb)

    def body(carry):
        x, r, U, G, Ms, om, it = carry
        f = jnp.stack([pdot(P[i], r) for i in range(s)])
        for k in range(s):  # static unroll
            ck = jnp.linalg.solve(Ms[k:, k:], f[k:])
            v = r - jnp.einsum("m,mij->ij", ck, G[k:], precision=hi)
            u_new = jnp.einsum("m,mij->ij", ck, U[k:], precision=hi) + om * v
            g_new = A(u_new)
            for i in range(k):
                alpha = pdot(P[i], g_new) / jnp.where(Ms[i, i] == 0, 1e-30, Ms[i, i])
                g_new = g_new - alpha * G[i]
                u_new = u_new - alpha * U[i]
            col = jnp.stack(
                [pdot(P[i], g_new) if i >= k else jnp.asarray(0.0, dtype)
                 for i in range(s)]
            )
            Ms = Ms.at[:, k].set(col)
            beta = f[k] / jnp.where(Ms[k, k] == 0, 1e-30, Ms[k, k])
            x = x + beta * u_new
            r = r - beta * g_new
            U = U.at[k].set(u_new)
            G = G.at[k].set(g_new)
            if k < s - 1:
                f = f.at[k + 1 :].add(-beta * Ms[k + 1 :, k])
        # dimension-reduction omega step (reference :309-330)
        t = A(r)
        nr = jnp.linalg.norm(r)
        nt = jnp.linalg.norm(t)
        ts = pdot(t, r)
        rho = jnp.abs(ts / jnp.maximum(nt * nr, 1e-30))
        om = ts / jnp.maximum(nt * nt, 1e-30)
        om = jnp.where(rho < angle, om * angle / jnp.maximum(rho, 1e-30), om)
        x = x + om * r
        r = r - om * t
        return (x, r, U, G, Ms, om, it + 1)

    carry = (x, r, U, G, Ms, om, jnp.asarray(0, jnp.int32))
    x, *_ = jax.lax.while_loop(cond, body, carry)
    return jnp.where(mask, x, x0)


def _inner_solve(x0, c_rel, mask, cfg):
    if cfg.kind == "jacobi":
        return _jacobi_sweeps(x0, c_rel, mask, cfg.n_sweeps)
    if cfg.kind == "rbgs":
        return _rbgs_sweeps(x0, c_rel, mask, cfg.n_sweeps, cfg.omega)
    if cfg.kind == "chebyshev":
        return _chebyshev_masked(x0, c_rel, mask, cfg.degree,
                                 cfg.bound_margin)
    if cfg.kind == "bicgstab":
        return _bicgstab_masked(x0, c_rel, mask, cfg.tolerance,
                                cfg.max_iterations)
    if cfg.kind == "gmres":
        return _gmres_masked(x0, c_rel, mask, cfg.tolerance, cfg.max_iterations,
                             cfg.restart)
    if cfg.kind == "idrs":
        return _idrs_masked(x0, c_rel, mask, cfg.tolerance, cfg.max_iterations,
                            cfg.s, cfg.angle)
    raise ValueError(f"Unknown momentum solver kind: {cfg.kind}")


def _unrelaxed_residual(x_star, c_un, *, is_u: bool, compensated: bool = False):
    """r = src_un - A_un x, border-zeroed field + interior L2 norm
    (reference ``AMG_solver._calculate_unrelaxed_residual``).

    ``compensated=True`` evaluates the residual as an error-free
    transformation (``ops/compensated.py``): in f32 the plain evaluation
    floors near 2e-7 relative (cancellation of O(1) stencil terms), the
    compensated one resolves the exact residual to f32 roundoff — the
    float32 path to the reference's 1e-7 convergence regime.
    """
    if compensated:
        from ..ops.compensated import compensated_linear_combination, compensated_norm

        if isinstance(c_un, MomentumCoeffs9):
            from ..ops.highorder import _OFFSETS, shift

            terms = [c_un.src] + [
                (getattr(c_un, name), shift(x_star, di, dj))
                for name, (di, dj) in _OFFSETS.items()
            ] + [(-c_un.a_p, x_star)]
        else:
            terms = [
                c_un.src,
                (c_un.a_e, shift_e(x_star)),
                (c_un.a_w, shift_w(x_star)),
                (c_un.a_n, shift_n(x_star)),
                (c_un.a_s, shift_s(x_star)),
                (-c_un.a_p, x_star),
            ]
        r, _ = compensated_linear_combination(terms)
    else:
        r = c_un.src - _apply(x_star, c_un)
    ni, nj = r.shape
    if is_u:
        nx, ny = ni - 1, nj
        interior = r[1:nx, 1 : ny - 1]
        rf = jnp.where(interior_mask(r.shape, 2, 2, 1, 1), r, 0.0)
    else:
        nx, ny = ni, nj - 1
        interior = r[1 : nx - 1, 1:ny]
        rf = jnp.where(interior_mask(r.shape, 1, 1, 2, 2), r, 0.0)
    if compensated:
        from ..ops.compensated import compensated_norm

        norm = compensated_norm(interior)
    else:
        norm = jnp.linalg.norm(interior)
    return rf, norm


def solve_u_momentum(u, v, p, *, dx, dy, rho, mu, alpha, bc: BoundaryConditions, cfg):
    """u-momentum predictor.  Returns (u_star, d_u, r_field, r_norm)."""
    u, v = apply_velocity_bcs(u, v, bc)
    c_un = _assemble_coeffs(u, v, p, dx=dx, dy=dy, rho=rho, mu=mu,
                            scheme=getattr(cfg, "scheme", "power_law"),
                            is_u=True)
    c_rel = _relax(c_un, u, alpha)
    mask = _u_interior_mask(u.shape)
    d_u = d_coefficient(c_rel.a_p, dy, is_u=True)
    u_star = _inner_solve(u, c_rel, mask, cfg)
    u_star, _ = apply_velocity_bcs(u_star, v, bc)
    r_field, r_norm = _unrelaxed_residual(
        u_star, c_un, is_u=True,
        compensated=getattr(cfg, "compensated_residual", False))
    return u_star, d_u, r_field, r_norm


def solve_v_momentum(u, v, p, *, dx, dy, rho, mu, alpha, bc: BoundaryConditions, cfg):
    """v-momentum predictor.  Returns (v_star, d_v, r_field, r_norm)."""
    u, v = apply_velocity_bcs(u, v, bc)
    c_un = _assemble_coeffs(u, v, p, dx=dx, dy=dy, rho=rho, mu=mu,
                            scheme=getattr(cfg, "scheme", "power_law"),
                            is_u=False)
    c_rel = _relax(c_un, v, alpha)
    mask = _v_interior_mask(v.shape)
    d_v = d_coefficient(c_rel.a_p, dx, is_u=False)
    v_star = _inner_solve(v, c_rel, mask, cfg)
    _, v_star = apply_velocity_bcs(u, v_star, bc)
    r_field, r_norm = _unrelaxed_residual(
        v_star, c_un, is_u=False,
        compensated=getattr(cfg, "compensated_residual", False))
    return v_star, d_v, r_field, r_norm


def solve_momentum_pair(u, v, p, *, dx, dy, rho, mu, alpha,
                        bc: BoundaryConditions, cfg):
    """Both momentum predictors.  BiCGSTAB on five-point power-law systems
    runs the two solves as one batched Krylov loop
    (:func:`_bicgstab_pair_masked`) unless ``cfg.batch_pair == 'off'``;
    every other configuration runs :func:`solve_u_momentum` and
    :func:`solve_v_momentum`.  Returns ``((u_star, d_u, r_u, u_norm),
    (v_star, d_v, r_v, v_norm))``."""
    kw = dict(dx=dx, dy=dy, rho=rho, mu=mu)
    scheme = getattr(cfg, "scheme", "power_law")
    if not _pair_krylov_applicable(cfg, scheme):
        return (solve_u_momentum(u, v, p, alpha=alpha, bc=bc, cfg=cfg, **kw),
                solve_v_momentum(u, v, p, alpha=alpha, bc=bc, cfg=cfg, **kw))
    ub, vb = apply_velocity_bcs(u, v, bc)
    cu_un = _assemble_coeffs(ub, vb, p, scheme=scheme, is_u=True, **kw)
    cu_rel = _relax(cu_un, ub, alpha)
    cv_un = _assemble_coeffs(ub, vb, p, scheme=scheme, is_u=False, **kw)
    cv_rel = _relax(cv_un, vb, alpha)
    u_star, v_star = _bicgstab_pair_masked(
        ub, cu_rel, _u_interior_mask(ub.shape),
        vb, cv_rel, _v_interior_mask(vb.shape),
        cfg.tolerance, cfg.max_iterations)
    u_star, v_star = apply_velocity_bcs(u_star, v_star, bc)
    comp = getattr(cfg, "compensated_residual", False)
    r_u, u_norm = _unrelaxed_residual(u_star, cu_un, is_u=True,
                                      compensated=comp)
    r_v, v_norm = _unrelaxed_residual(v_star, cv_un, is_u=False,
                                      compensated=comp)
    return ((u_star, d_coefficient(cu_rel.a_p, dy, is_u=True), r_u, u_norm),
            (v_star, d_coefficient(cv_rel.a_p, dx, is_u=False), r_v, v_norm))


def _pair_krylov_applicable(cfg, scheme) -> bool:
    """Batched-pair BiCGSTAB gate: five-point power-law systems (the
    9-point QUICK/LUDS systems use MomentumCoeffs9), unless
    ``batch_pair='off'`` forces the sequential path."""
    return (getattr(cfg, "kind", None) == "bicgstab"
            and getattr(cfg, "batch_pair", "auto") != "off"
            and scheme == "power_law")
