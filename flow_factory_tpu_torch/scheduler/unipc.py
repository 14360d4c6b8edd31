"""UniPC multistep scheduler with SDE support (Wan family).

Port of ``flow_factory_tpu/scheduler/unipc.py``. During RL rollout and
training the SDE step math is the FlowMatch-Euler one, so those paths are
inherited from :class:`FlowMatchEulerSDE` unchanged (and with them the
replay ratio of exactly 1.0). Only the eval rollout differs: the UniPC(bh2)
predictor-corrector of diffusers' ``UniPCMultistepScheduler.step`` for flow
matching (``predict_x0``: x0 = x − σ·v, α = 1 − σ, λ = log(α/σ),
B_h = expm1(−h)), with ``solver_order`` 1-3 and the ``lower_order_final``
taper.

The JAX package threads an explicit carry through ``lax.scan`` and picks the
order branch with ``lax.switch``; here :func:`unipc_eval_step` takes the same
carry (:class:`UniPCCarry`, history most-recent-first) and Python ints for
the orders, which :func:`compute_unipc_orders` computes on the host. The
step coefficients are fp32 scalar tensors on the sample's device, as the
JAX function computes them.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .flow_match_euler import FlowMatchEulerSDE


class UniPCCarry(NamedTuple):
    """The multistep state of the eval loop; ``ms[0]``/``lams[0]`` belong to
    the step just taken."""

    x: torch.Tensor            # current sample (fp32)
    last_sample: torch.Tensor  # corrected sample at the previous point (uni_c input)
    ms: torch.Tensor           # (3, *x.shape) x0-prediction history
    lams: torch.Tensor         # (3,) λ history


def _lam(sigma: torch.Tensor) -> torch.Tensor:
    sigma = torch.clamp(sigma, 1e-6, 1.0 - 1e-6)
    return torch.log((1.0 - sigma) / sigma)


def compute_unipc_orders(num_steps: int, solver_order: int = 2, lower_order_final: bool = True
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-step (predictor_orders, corrector_orders), diffusers' schedule:
    ``min(solver_order, i + 1[, N − i])``; the corrector at step i runs at the
    order the predictor used at step i − 1, 0 (none) at step 0."""
    pred = []
    for i in range(num_steps):
        o = min(solver_order, i + 1)
        if lower_order_final:
            o = min(o, num_steps - i)
        pred.append(max(1, o))
    corr = [0] + pred[:-1]
    return np.asarray(pred, np.int32), np.asarray(corr, np.int32)


def _bh2_coeffs(h: torch.Tensor):
    """(h_phi_1, B_h, b1, b2, b3) for bh2 / predict_x0 (hh = −h)."""
    hh = -h
    h_phi_1 = torch.expm1(hh)
    B_h = h_phi_1
    h_phi_k1 = h_phi_1 / hh - 1.0
    b1 = h_phi_k1 * 1.0 / B_h
    h_phi_k2 = h_phi_k1 / hh - 1.0 / 2.0
    b2 = h_phi_k2 * 2.0 / B_h
    h_phi_k3 = h_phi_k2 / hh - 1.0 / 6.0
    b3 = h_phi_k3 * 6.0 / B_h
    return h_phi_1, B_h, b1, b2, b3


def _solve2(a11, a12, a21, a22, y1, y2):
    det = a11 * a22 - a12 * a21
    det = torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12), det)
    return (y1 * a22 - y2 * a12) / det, (a11 * y2 - a21 * y1) / det


def _safe_ratio(r: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.abs(r) < 1e-8, torch.ones_like(r), r)


def unipc_eval_step(carry: UniPCCarry, v: torch.Tensor, sigma, sigma_next, pred_order: int = 1,
                    corr_order: int = 0) -> Tuple[UniPCCarry, torch.Tensor]:
    """One UniPC(bh2) predictor-corrector step, deterministic, fp32.

    The corrector (uni_c, order ``corr_order``; 0 skips it) first refines
    the current sample with the fresh x0 prediction, then the history takes
    the (uncorrected-sample) prediction and the predictor (uni_p, order
    ``pred_order``) gives the next sample at ``sigma_next``."""
    x = carry.x.float()
    v = v.float()
    f32 = lambda s: torch.as_tensor(s, dtype=torch.float32, device=x.device)
    sigma, sigma_next = f32(sigma), f32(sigma_next)
    m_t = x - sigma * v
    lam_cur = _lam(sigma)
    m1, m2, m3 = carry.ms[0], carry.ms[1], carry.ms[2]
    lam1, lam2, lam3 = carry.lams[0], carry.lams[1], carry.lams[2]

    x_used = x
    if corr_order > 0:
        h = lam_cur - lam1
        h_phi_1, B_h, b1, b2, b3 = _bh2_coeffs(h)
        sig_prev = torch.exp(-lam1) / (1.0 + torch.exp(-lam1))
        alpha_cur = 1.0 - sigma
        x_t_ = (sigma / torch.clamp(sig_prev, min=1e-6)) * carry.last_sample - alpha_cur * h_phi_1 * m1
        D1_t = m_t - m1
        order = min(int(corr_order), 3)
        if order == 1:
            x_used = x_t_ - alpha_cur * B_h * (0.5 * D1_t)
        elif order == 2:
            r1 = _safe_ratio((lam2 - lam1) / h)
            D1_1 = (m2 - m1) / r1
            rho1, rho2 = _solve2(f32(1.0), f32(1.0), r1, f32(1.0), b1, b2)
            x_used = x_t_ - alpha_cur * B_h * (rho1 * D1_1 + rho2 * D1_t)
        else:
            r1 = _safe_ratio((lam2 - lam1) / h)
            r2 = _safe_ratio((lam3 - lam1) / h)
            D1_1 = (m2 - m1) / r1
            D1_2 = (m3 - m1) / r2
            one = f32(1.0)
            R = torch.stack([torch.stack([one, one, one]), torch.stack([r1, r2, one]),
                             torch.stack([r1 * r1, r2 * r2, one])])
            rhos = torch.linalg.solve(R, torch.stack([b1, b2, b3]))
            x_used = x_t_ - alpha_cur * B_h * (rhos[0] * D1_1 + rhos[1] * D1_2 + rhos[2] * D1_t)

    ms = torch.cat([m_t[None], carry.ms[:-1]], dim=0)
    lams = torch.cat([lam_cur[None], carry.lams[:-1]], dim=0)

    lam_t = _lam(sigma_next)
    h = lam_t - lam_cur
    h_phi_1, B_h, b1, b2, b3 = _bh2_coeffs(h)
    alpha_t = 1.0 - sigma_next
    sigma_t = torch.clamp(sigma_next, min=1e-6)
    sigma_s0 = torch.clamp(sigma, min=1e-6)
    x_t_ = (sigma_t / sigma_s0) * x_used - alpha_t * h_phi_1 * m_t
    order = min(max(int(pred_order), 1), 3)
    if order == 1:
        x_next = x_t_
    elif order == 2:
        r1 = _safe_ratio((lams[1] - lam_cur) / h)
        D1_1 = (ms[1] - m_t) / r1
        x_next = x_t_ - alpha_t * B_h * (0.5 * D1_1)  # diffusers' simplified order 2
    else:
        r1 = _safe_ratio((lams[1] - lam_cur) / h)
        r2 = _safe_ratio((lams[2] - lam_cur) / h)
        D1_1 = (ms[1] - m_t) / r1
        D1_2 = (ms[2] - m_t) / r2
        rho1, rho2 = _solve2(f32(1.0), f32(1.0), r1, r2, b1, b2)
        x_next = x_t_ - alpha_t * B_h * (rho1 * D1_1 + rho2 * D1_2)
    return UniPCCarry(x=x_next, last_sample=x_used, ms=ms, lams=lams), x_next


def init_unipc_carry(x0: torch.Tensor) -> UniPCCarry:
    x0 = x0.float()
    return UniPCCarry(x=x0, last_sample=torch.zeros_like(x0),
                      ms=torch.zeros((3, *x0.shape), dtype=torch.float32, device=x0.device),
                      lams=torch.zeros((3,), dtype=torch.float32, device=x0.device))


class UniPCSDEScheduler(FlowMatchEulerSDE):
    """UniPC schedule with the FlowMatch-Euler SDE rollout and training steps;
    eval rollouts run :func:`unipc_eval_step` (the adapter's
    ``rollout_compute`` dispatches on ``use_unipc_eval``). Wan uses the flow
    sigma schedule with a static shift."""

    use_unipc_eval = True
