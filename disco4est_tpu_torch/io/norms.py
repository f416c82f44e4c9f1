"""Norms and convergence logging.

Port of `disco4est_tpu/io/norms.py` (role of the reference's
`IO/d4est_norms.c`): L2 / L∞ / DG-energy norms, per-level log rows with the
reference's line format ("num_quadrants num_nodes num_quad_nodes <value>",
`%.13g`), and log-log convergence fits.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from disco4est_tpu_torch.mesh.builder import MeshData


def norm_L2(mesh: MeshData, err) -> float:
    """sqrt of globally-summed ∫err² (`d4est_norms_fcn_L2`)."""
    return float(torch.sqrt(torch.sum(mesh.l2_norm_sqr(err))))


def norm_Linfty(err) -> float:
    return float(torch.max(torch.abs(err)))


def norm_energy(mesh: MeshData, err, apply_A) -> float:
    """DG energy norm sqrt(eᵀ A e) with the operator `apply_A(mesh, e)`,
    e.g. `laplacian.sipg.apply_sipg` (the JAX `norm_energy`; the
    reference's interior-penalty norm, `dGMath/d4est_ip_energy_norm.c`,
    is `io/ip_energy_norm.py`)."""
    Ae = apply_A(mesh, err)
    return float(torch.sqrt(torch.dot(err.reshape(-1), Ae.reshape(-1))))


@dataclasses.dataclass
class NormLog:
    """Accumulates per-AMR-level norms and fits convergence rates."""

    rows: list = dataclasses.field(default_factory=list)

    def add(self, mesh: MeshData, **norms):
        self.rows.append(
            {
                "num_quadrants": mesh.n_elements,
                "num_nodes": mesh.local_nodes,
                "num_quad_nodes": mesh.n_elements * mesh.nq**mesh.dim,
                **norms,
            }
        )

    def lines(self, key: str):
        """Reference-format log lines: 'num_quadrants num_nodes
        num_quad_nodes <value>' (`d4est_norms.c:328`)."""
        return [
            f"{r['num_quadrants']} {r['num_nodes']} {r['num_quad_nodes']} "
            f"{r[key]:.13g}"
            for r in self.rows
        ]

    def convergence_fit(self, key: str):
        """log(err) = C1 + C2·log(DOF) linear fit (`d4est_norms.c:358`)."""
        dofs = np.array([r["num_nodes"] for r in self.rows], float)
        errs = np.array([r[key] for r in self.rows], float)
        mask = errs > 0
        if mask.sum() < 2:
            return None
        slope, intercept = np.polyfit(
            np.log(dofs[mask]), np.log(errs[mask]), 1
        )
        return {"slope": slope, "intercept": intercept}
