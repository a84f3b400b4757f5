"""Simulation result container.

JAX rebuild of the reference ``SimulationResult``
(``naviflow_oo/postprocessing/simulation_result.py``): holds the final
fields, named residual histories (``add_history``/``get_history``, reference
:67-94), divergence diagnostics (:152-184), Ghia validation (:186-264) and
``.npz`` export (:296-314).  Device arrays are materialized to NumPy once on
construction — everything downstream is host-side post-processing.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from ..core.mesh import StructuredMesh
from .validation import (
    infinity_norm_error,
    l2_norm_error,
    validate_against_benchmark,
)


class SimulationResult:
    def __init__(
        self,
        u,
        v,
        p,
        mesh: StructuredMesh,
        iterations: int = 0,
        residuals=None,
        reynolds: Optional[float] = None,
        u_residual_field=None,
        v_residual_field=None,
        p_residual_field=None,
        converged: Optional[bool] = None,
    ):
        self.u = np.asarray(u)
        self.v = np.asarray(v)
        self.p = np.asarray(p)
        self.mesh = mesh
        self.iterations = int(iterations)
        self.residuals = np.asarray(residuals) if residuals is not None else np.zeros(0)
        self.reynolds = reynolds
        self.converged = converged
        self.u_residual_field = (
            np.asarray(u_residual_field) if u_residual_field is not None else None
        )
        self.v_residual_field = (
            np.asarray(v_residual_field) if v_residual_field is not None else None
        )
        self.p_residual_field = (
            np.asarray(p_residual_field) if p_residual_field is not None else None
        )
        self._history: Dict[str, np.ndarray] = {}

    # -- histories (reference :67-94) ----------------------------------------
    def add_history(self, name: str, values) -> None:
        self._history[name] = np.asarray(values)

    def get_history(self, name: str):
        return self._history.get(name)

    @property
    def history_names(self):
        return sorted(self._history)

    # -- physics diagnostics (reference :152-184) ----------------------------
    def calculate_divergence(self) -> np.ndarray:
        dx, dy = self.mesh.get_cell_sizes()
        return (self.u[1:, :] - self.u[:-1, :]) / dx + (
            self.v[:, 1:] - self.v[:, :-1]
        ) / dy

    def get_max_divergence(self) -> float:
        div = self.calculate_divergence()
        return float(np.max(np.abs(div[1:-1, 1:-1])))

    # -- Ghia validation (reference :186-264) ---------------------------------
    def calculate_infinity_norm_error(self) -> float:
        return infinity_norm_error(self.u, self.v, self.mesh, self.reynolds)

    def calculate_l2_norm_error(self) -> float:
        return l2_norm_error(self.u, self.v, self.mesh, self.reynolds)

    def validate_against_benchmark(self, threshold: float = 0.10) -> dict:
        return validate_against_benchmark(
            self.u, self.v, self.mesh, self.reynolds, threshold
        )

    # -- persistence (reference :296-314) -------------------------------------
    def save_solution(self, filename: str) -> str:
        os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
        np.savez(
            filename,
            u=self.u,
            v=self.v,
            p=self.p,
            x=self.mesh.x,
            y=self.mesh.y,
            reynolds=self.reynolds,
            iterations=self.iterations,
            residuals=self.residuals,
        )
        return filename

    @staticmethod
    def load_solution(filename: str, mesh: Optional[StructuredMesh] = None):
        data = np.load(filename, allow_pickle=True)
        nx, ny = data["p"].shape
        mesh = mesh or StructuredMesh(nx=nx, ny=ny)
        return SimulationResult(
            data["u"], data["v"], data["p"], mesh,
            iterations=int(data["iterations"]),
            residuals=data["residuals"],
            reynolds=float(data["reynolds"]),
        )

    # -- plotting shims (implemented in visualization.py) ---------------------
    def plot_combined_results(self, **kw):
        from .visualization import plot_combined_results_matrix

        return plot_combined_results_matrix(self, **kw)

    def plot_final_residuals(self, **kw):
        from .visualization import plot_final_residuals

        return plot_final_residuals(self, **kw)


def result_from_solve(mesh, fluid, state, diag, algorithm: str = "SIMPLE") -> SimulationResult:
    """Build a SimulationResult from ``(FlowState, SolveDiagnostics)``."""
    n = int(diag.iterations)
    res = SimulationResult(
        state.u, state.v, state.p, mesh,
        iterations=n,
        residuals=np.asarray(diag.total_res_history)[:n],
        reynolds=fluid.get_reynolds_number(),
        u_residual_field=diag.u_residual_field,
        v_residual_field=diag.v_residual_field,
        p_residual_field=diag.p_residual_field,
        converged=bool(diag.converged),
    )
    res.add_history("u_rel_norm", np.asarray(diag.u_res_history)[:n])
    res.add_history("v_rel_norm", np.asarray(diag.v_res_history)[:n])
    res.add_history("p_rel_norm", np.asarray(diag.p_res_history)[:n])
    res.add_history("total_rel_norm", np.asarray(diag.total_res_history)[:n])
    res.add_history("pressure_inner_iterations", np.asarray(diag.inner_iters_history)[:n])
    res.algorithm = algorithm
    return res
