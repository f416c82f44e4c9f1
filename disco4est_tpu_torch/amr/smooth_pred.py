"""smooth_pred hp-AMR scheme: γ-predictor based h-vs-p choice.

Port of `disco4est_tpu/amr/smooth_pred.py` (host numpy; role of the
reference's `hpAMR/d4est_amr_smooth_pred.c`):

- mark element if η² ≥ percentile threshold
  (`amr_mark_element` in the problem files, e.g.
  `Problems/TwoPunctures/two_punctures_cactus.c:183-199`);
- marked & η² ≤ predictor ⇒ p-refine (deg+1, capped);  predictor ← γ_p·η²
- marked & η² > predictor  ⇒ h-refine;                 predictor ←
  γ_h·η²·(½)^{2·deg}/2^dim  (per child, `smooth_pred.c:260`)
- unmarked ⇒ predictor ← γ_n·predictor
- elements split by the 2:1 balance get the h-refine predictor update
  (`compute_post_h_balance_predictor`, `smooth_pred.c:74-163`).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from disco4est_tpu_torch.estimators.stats import estimator_stats, percentile
from disco4est_tpu_torch.mesh.tree import Forest


@dataclasses.dataclass
class SmoothPredParams:
    gamma_h: float = 10.0
    gamma_p: float = 0.1
    gamma_n: float = 1.0
    percentile: float = 25.0  # mark the top X percent ([amr] sigma-style)
    max_degree: int = 7
    initial_pred: float = 0.0
    # marker rule: "percentile" (CDS/TwoPunctures style: η² ≥ value at
    # percentile, with the reference's tie epsilon) or "mean" (Stamm's
    # `amr_mark_element`: η² ≥ sigma·mean(η²),
    # `stamm_multigrid_pc.c:35-50`)
    marker: str = "percentile"
    sigma: float = 0.25  # [amr] sigma for the mean marker


@dataclasses.dataclass
class SmoothPredState:
    predictor: np.ndarray  # [E]

    @staticmethod
    def fresh(n_elements: int, params: SmoothPredParams) -> "SmoothPredState":
        return SmoothPredState(
            np.full(n_elements, params.initial_pred, np.float64)
        )


def smooth_pred_mark(
    eta2: np.ndarray,
    deg: np.ndarray | int,
    state: SmoothPredState,
    params: SmoothPredParams,
    dim: int,
):
    """Returns (refinement_log[E], new predictor[E]).

    refinement_log follows the reference protocol: <0 h-refine, >0 set
    degree (p-refine), == deg no-op.  The tie band of the percentile
    marker (1e-4 relative) absorbs rounding between elements that are
    equal by symmetry, so the marks do not depend on the summation order
    of the device that computed η².
    """
    eta2 = np.asarray(eta2)
    E = len(eta2)
    deg_arr = np.full(E, deg) if np.isscalar(deg) else np.asarray(deg)
    if params.marker == "mean":
        marked = eta2 >= params.sigma * eta2.mean()
    else:
        thresh = float(percentile(estimator_stats(eta2), params.percentile))
        marked = (eta2 >= thresh) | (np.abs(eta2 - thresh) < eta2 * 1e-4)

    pred = state.predictor.copy()
    log = deg_arr.astype(np.int64).copy()  # default: no-op

    p_refine = marked & (eta2 <= pred) & (deg_arr < params.max_degree)
    h_refine = marked & ~p_refine

    log[p_refine] = np.minimum(deg_arr[p_refine] + 1, params.max_degree)
    log[h_refine] = -deg_arr[h_refine]

    pred[p_refine] = params.gamma_p * eta2[p_refine]
    pred[h_refine] = (
        params.gamma_h
        * eta2[h_refine]
        * 0.5 ** (2 * deg_arr[h_refine])
        / (1 << dim)
    )
    pred[~marked] = params.gamma_n * pred[~marked]
    return log, pred


def transfer_predictor(
    old: Forest,
    new: Forest,
    pred: np.ndarray,
    deg: np.ndarray | int,
    params: SmoothPredParams,
    refinement_log: np.ndarray,
):
    """Carry the predictor to the new forest
    (`compute_post_h_balance_predictor`, `smooth_pred.c:74-163`):

    - children of MARKED parents copy the parent's slot (the h-refine
      formula was already applied at marking time, `smooth_pred.c:260`);
    - splits forced by the 2:1 balance apply pred ← γ_h·(½)^{2p}/2^dim ·
      pred once per extra level;
    - untouched elements copy.
    """
    from disco4est_tpu_torch.amr.amr import element_lineage

    src, _, dl = element_lineage(old, new)
    marked_h = np.asarray(refinement_log) < 0
    deg_arr = (
        np.full(old.n_elements, deg) if np.isscalar(deg) else np.asarray(deg)
    )
    c = params.gamma_h * 0.5 ** (2 * deg_arr[src]) / (1 << old.dim)
    n_extra = np.maximum(dl - marked_h[src].astype(np.int64), 0)
    return pred[src] * c**n_extra
