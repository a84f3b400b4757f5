"""Chebyshev polynomial smoothing + spectral-radius estimation.

The reference tunes its Jacobi/red-black-GS smoother relaxation factors by
power-iteration spectral-radius studies
(``pressure_solver/helpers/spectral_radius_damping.py`` and the SR_*.pdf
artifacts).  On a data-parallel device the natural upgrade (SURVEY §7) is
the Chebyshev smoother: a fixed-degree polynomial in D^-1 A needs no
sequential sweeps or color masking at all — ``degree`` fused matvecs per
application — and its optimal coefficients follow directly from the same
spectral bounds the reference estimated empirically.

* :func:`estimate_lambda_max` — power iteration on D^-1 A (the jitted analog
  of the reference's ``find_optimal_gauss_seidel_omega_matrix_free``).
* :func:`chebyshev_smooth` — first-kind Chebyshev smoother targeting the
  upper eigenvalue band [lambda_max/theta, lambda_max] (the standard
  multigrid smoothing band; recurrence as in hypre/PyAMG).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ops.stencil9 import Stencil9, apply9, stencil9_diagonal


def estimate_lambda_max(st: Stencil9, shape, *, iterations: int = 25, seed: int = 7):
    """Largest eigenvalue of D^-1 A by power iteration (jit-safe)."""
    inv_d = 1.0 / stencil9_diagonal(st)
    key = jax.random.PRNGKey(seed)
    x = jax.random.normal(key, shape, st.c.dtype)
    x = x / jnp.linalg.norm(x)

    def body(_, carry):
        x, lam = carry
        y = inv_d * apply9(x, st)
        lam = jnp.linalg.norm(y)
        return (y / jnp.maximum(lam, 1e-30), lam)

    _, lam = jax.lax.fori_loop(0, iterations, body, (x, jnp.asarray(1.0, st.c.dtype)))
    return lam


def optimal_jacobi_omega(lam_max, lam_min=0.0):
    """Damped-Jacobi weight minimizing the smoothing radius over
    [lam_min, lam_max]: omega* = 2 / (lam_min + lam_max).

    The jitted counterpart of the reference's empirical omega studies
    (``spectral_radius_damping.find_optimal_gauss_seidel_omega_matrix_free``
    and the SR_*.pdf artifacts)."""
    return 2.0 / (lam_min + lam_max)


def estimate_smoother_spectral_radius(st: Stencil9, shape, omega: float,
                                      *, iterations: int = 40, seed: int = 11):
    """Spectral radius of the damped-Jacobi iteration matrix I - omega D^-1 A
    by power iteration — the reference's tuning quantity, jit-safe."""
    import jax as _jax

    inv_d = 1.0 / stencil9_diagonal(st)
    key = _jax.random.PRNGKey(seed)
    x = _jax.random.normal(key, shape, st.c.dtype)
    x = x / jnp.linalg.norm(x)

    def body(_, carry):
        x, rho = carry
        y = x - omega * inv_d * apply9(x, st)
        rho = jnp.linalg.norm(y)
        return (y / jnp.maximum(rho, 1e-30), rho)

    _, rho = _jax.lax.fori_loop(0, iterations, body,
                                (x, jnp.asarray(1.0, st.c.dtype)))
    return rho


def chebyshev_smooth(p, b, st: Stencil9, lam_max, *, degree: int = 4,
                     theta: float = 30.0):
    """``degree`` Chebyshev iterations on A p = b, preconditioned by D^-1.

    Eigenvalue band [lam_max/theta, 1.05*lam_max]; three-term recurrence:

        z_0 = D^-1 r / d;   rho_0 = 1/sigma
        p <- p + z;  r = D^-1 (b - A p)
        rho_k = 1/(2 sigma - rho_{k-1})
        z <- rho_k rho_{k-1} z + (2 rho_k / delta) r
    """
    dtype = p.dtype
    inv_d = 1.0 / stencil9_diagonal(st)
    lmax = 1.05 * lam_max
    lmin = lam_max / theta
    d = (lmax + lmin) / 2.0
    delta = (lmax - lmin) / 2.0
    sigma = d / delta
    rho = jnp.asarray(1.0 / sigma, dtype)

    r = inv_d * (b - apply9(p, st))
    z = r / d

    def body(_, carry):
        p, z, rho = carry
        p = p + z
        r = inv_d * (b - apply9(p, st))
        rho_new = 1.0 / (2.0 * sigma - rho)
        z = rho_new * rho * z + (2.0 * rho_new / delta) * r
        return (p, z, rho_new)

    p, z, _ = jax.lax.fori_loop(0, degree - 1, body, (p, z, rho))
    return p + z
