"""Full-precision contractions in the Krylov solvers, and the persistent
compilation cache's directory."""

import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest

from naviflow_tpu.ops.poisson import poisson_coefficients
from naviflow_tpu.ops.stencil import StencilCoeffs
from naviflow_tpu.solvers import momentum
from naviflow_tpu.solvers.krylov import (BiCGSTABPressureConfig,
                                         CGPressureConfig, GMRESPressureConfig,
                                         MGCGPressureConfig,
                                         solve_pressure_krylov)
from naviflow_tpu.utils import jaxcache

N = 12
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _coeffs(n=N):
    ones = jnp.ones((n, n), jnp.float32)
    return StencilCoeffs(a_e=ones, a_w=ones, a_n=ones, a_s=ones,
                         a_p=5 * ones, src=ones)


def _pressure_case(kind):
    d_u = jnp.ones((N + 1, N), jnp.float32)
    d_v = jnp.ones((N, N + 1), jnp.float32)
    kw = dict(dx=0.1, dy=0.1, rho=1.0)
    pc = poisson_coefficients(d_u, d_v, **kw)
    cfg = {"cg": CGPressureConfig(max_iterations=5),
           "bicgstab": BiCGSTABPressureConfig(max_iterations=5),
           "gmres": GMRESPressureConfig(max_iterations=10, restart=5),
           "mgcg": MGCGPressureConfig(max_iterations=5)}[kind]
    return lambda b: solve_pressure_krylov(b, pc, jnp.zeros_like(b), cfg,
                                           d_u=d_u, d_v=d_v, **kw)[0]


def _lowered(kind):
    x = jnp.ones((N, N), jnp.float32)
    mask = jnp.ones((N, N), bool)
    c = _coeffs()
    fns = {
        "idrs": lambda x: momentum._idrs_masked(x, c, mask, 1e-6, 5, 4, 0.7),
        "gmres_momentum": lambda x: momentum._gmres_masked(x, c, mask, 1e-6,
                                                           10, 5),
    }
    fn = fns[kind] if kind in fns else _pressure_case(kind)
    return jax.jit(fn).lower(x).as_text()


@pytest.mark.parametrize("kind", ["idrs", "gmres_momentum", "mgcg", "cg",
                                  "bicgstab", "gmres"])
def test_krylov_contractions_are_highest_precision(kind):
    text = _lowered(kind)
    dots = re.findall(r"stablehlo\.dot_general[^\n]*", text)
    assert dots, "no contraction found"
    for d in dots:
        assert "HIGHEST" in d, d


def test_cache_honours_environment_variable(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert jaxcache.enable_persistent_cache() == str(tmp_path)
    # the variable is JAX's own: the module sets no directory in code
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_default_is_the_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = jaxcache.enable_persistent_cache()
        assert path == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_cache_path_independent_of_host_process_and_time(tmp_path):
    """A child process, later and with another pid, resolves the same
    directory; compiled programs land in the directory the variable names."""
    code = (
        "import os, jax; jax.config.update('jax_platforms', 'cpu');"
        "from naviflow_tpu.utils import jaxcache;"
        "print(jaxcache.DEFAULT_CACHE_DIR, os.getpid());"
        "jaxcache.enable_persistent_cache();"
        "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0);"
        "jax.jit(lambda x: x * 2 + 1)(jax.numpy.ones(3)).block_until_ready()"
    )
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(tmp_path / "c"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    child_dir, child_pid = out.stdout.split()
    assert child_dir == jaxcache.DEFAULT_CACHE_DIR
    assert int(child_pid) != os.getpid()
    assert os.listdir(tmp_path / "c"), "no compiled program in the cache"
