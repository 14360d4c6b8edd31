"""FlowMatch-Euler SDE scheduler (port of ``flow_factory_tpu/scheduler/flow_match_euler.py``).

One function, `sde_step`, serves the rollout loop *and* the replay forward,
so the train-inference consistency invariant (replayed ratio == 1) holds by
construction: both phases run the same fp32 math and the same storage-dtype
round trip.

Dynamics (sigma = t/1000, dt = sigma_next - sigma < 0, v = noise_pred):

  ODE:       x' = x + v*dt
  Flow-SDE:  s_t = sqrt(sigma/(1-sigma))*eta ;
             mean = x*(1 + s_t^2/(2 sigma)*dt) + v*(1 + s_t^2 (1-sigma)/(2 sigma))*dt ;
             x' = mean + s_t*sqrt(-dt)*eps                     (Flow-GRPO Eq. 9)
  Dance-SDE: s_t = eta; mean = x + (v + eta^2/2*(x - x0(1-sigma))/sigma^2)*dt ; x0 = x - sigma v
  CPS:       s_t = sigma'*sin(eta*pi/2); x0 = x - sigma v; x1 = x + v(1-sigma);
             mean = x0(1-sigma') + x1*sqrt(sigma'^2 - s_t^2); x' = mean + s_t*eps

Noise comes from a ``torch.Generator``, or from an explicit ``noise`` tensor
(tests feed the noise the JAX package drew: a JAX key stream cannot be
reproduced in torch).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import numpy as np
import torch

from .abc import DynamicsType, SDEStepOutput

LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)

Scalar = Union[float, np.ndarray, torch.Tensor]


# ---------------------------------------------------------------------------
# Sigma schedule construction (host-side, numpy)
# ---------------------------------------------------------------------------

def calculate_shift(
    seq_len: int,
    base_seq_len: int = 256,
    max_seq_len: int = 4096,
    base_shift: float = 0.5,
    max_shift: float = 1.15,
) -> float:
    """Resolution-dependent mu for exponential timestep shifting."""
    m = (max_shift - base_shift) / (max_seq_len - base_seq_len)
    b = base_shift - m * base_seq_len
    return seq_len * m + b


def build_flow_match_sigmas(
    num_inference_steps: int,
    shift: float = 1.0,
    use_dynamic_shifting: bool = False,
    mu: Optional[float] = None,
    sigmas: Optional[np.ndarray] = None,
    shift_terminal: Optional[float] = None,
    num_train_timesteps: int = 1000,
) -> np.ndarray:
    """The (T+1,) sigma schedule incl. terminal 0 (diffusers semantics)."""
    if sigmas is None:
        sigmas = np.linspace(1.0, 1.0 / num_inference_steps, num_inference_steps, dtype=np.float64)
    else:
        sigmas = np.asarray(sigmas, dtype=np.float64)

    if use_dynamic_shifting:
        if mu is None:
            raise ValueError("`mu` must be provided when use_dynamic_shifting=True")
        sigmas = math.exp(mu) / (math.exp(mu) + (1.0 / sigmas - 1.0))
    else:
        sigmas = shift * sigmas / (1.0 + (shift - 1.0) * sigmas)

    if shift_terminal is not None:
        one_minus = 1.0 - sigmas
        scale = one_minus[-1] / (1.0 - shift_terminal)
        sigmas = 1.0 - one_minus / scale

    return np.concatenate([sigmas, [0.0]]).astype(np.float32)


# ---------------------------------------------------------------------------
# Step math (device-side)
# ---------------------------------------------------------------------------

def _bcast(x: Scalar, ref: torch.Tensor) -> torch.Tensor:
    """A scalar or (B,)-vector as fp32 on ref's device, shaped (B, 1, ..., 1)."""
    x = torch.as_tensor(x, dtype=torch.float32, device=ref.device)
    if x.ndim == 0:
        return x
    return x.reshape(x.shape[0], *([1] * (ref.ndim - 1)))


def _row_sums(x: torch.Tensor) -> torch.Tensor:
    """(B,) the sum of each row over its non-batch dims, each row reduced
    on its own: a reduction kernel's configuration (how it splits the work
    across threads and blocks) follows how many outputs it has, so rows
    reduced together would round by how many rows stand beside them, and a
    replay at another micro-batch size than the rollout's would not give
    the rollout's log-prob bit for bit."""
    return torch.stack([row.sum() for row in x.reshape(x.shape[0], -1)])


def _mean_over_nonbatch(x: torch.Tensor) -> torch.Tensor:
    return _row_sums(x) / float(x[0].numel())


def _gaussian_log_prob(out, mean, std_dev_t, dt):
    # clamp the scale so zero-noise steps give finite (meaningless) values
    scale = torch.clamp(std_dev_t * torch.sqrt(-dt), min=1e-12)
    return -((out.detach() - mean) ** 2) / (2.0 * scale**2) - torch.log(scale) - LOG_SQRT_2PI


def sde_step(
    noise_pred: torch.Tensor,
    latents: torch.Tensor,
    sigma: Scalar,
    sigma_next: Scalar,
    *,
    dynamics_type: DynamicsType = "Flow-SDE",
    noise_level: Scalar = 0.0,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
    next_latents: Optional[torch.Tensor] = None,
    compute_log_prob: bool = True,
    storage_dtype: torch.dtype = torch.bfloat16,
    sigma_max: Scalar = 0.999,
    token_mask: Optional[torch.Tensor] = None,
) -> SDEStepOutput:
    """One (possibly stochastic) Euler step of the flow ODE/SDE with log-prob.

    Sampling mode (``next_latents=None``) draws the transition noise (from
    ``noise`` if given, else ``generator``) and round-trips the result through
    ``storage_dtype``; replay mode evaluates the log-prob of the stored
    transition. All math is fp32 regardless of input dtypes.

    ``token_mask`` (broadcastable to ``latents``; 1.0 = generated, 0.0 =
    hard-conditioned) freezes conditioned tokens: they never step and
    contribute nothing to the log-prob.
    """
    in_dtype = latents.dtype
    v = noise_pred.float()
    x = latents.float()
    stored = None if next_latents is None else next_latents.float()

    sigma = _bcast(sigma, x)
    sigma_next = _bcast(sigma_next, x)
    noise_level = _bcast(noise_level, x)
    dt = sigma_next - sigma  # negative

    def fresh_noise():
        if noise is not None:
            if tuple(noise.shape) != tuple(v.shape):
                raise ValueError(f"noise shape {tuple(noise.shape)} != latents {tuple(v.shape)}")
            return noise.to(device=v.device, dtype=torch.float32)
        if generator is None:
            raise ValueError("`generator` or `noise` is required when sampling (next_latents=None)")
        return torch.randn(v.shape, generator=generator, device=v.device, dtype=torch.float32)

    def _reduce_lp(lp):
        if token_mask is None:
            return _mean_over_nonbatch(lp)
        tm = token_mask.float().expand(lp.shape)
        return _row_sums(lp * tm) / torch.clamp(_row_sums(tm), min=1.0)

    def _store(t):
        return t.to(storage_dtype).float()

    log_prob = None

    if dynamics_type == "ODE":
        mean = x + v * dt
        std_dev_t = torch.zeros_like(sigma)
        out = _store(mean) if stored is None else stored
        if compute_log_prob:
            log_prob = torch.zeros((x.shape[0],), dtype=torch.float32, device=x.device)

    elif dynamics_type == "Flow-SDE":
        sigma_max_b = _bcast(sigma_max, x)
        sigma_eff = torch.where(sigma == 1.0, sigma_max_b, sigma)
        std_dev_t = torch.sqrt(sigma / (1.0 - sigma_eff)) * noise_level
        mean = x * (1.0 + std_dev_t**2 / (2.0 * sigma) * dt) + v * (
            1.0 + std_dev_t**2 * (1.0 - sigma) / (2.0 * sigma)
        ) * dt
        if stored is None:
            out = _store(mean + std_dev_t * torch.sqrt(-dt) * fresh_noise())
        else:
            out = stored
        if compute_log_prob:
            log_prob = _reduce_lp(_gaussian_log_prob(out, mean, std_dev_t, dt))

    elif dynamics_type == "Dance-SDE":
        x0 = x - sigma * v
        std_dev_t = noise_level
        log_term = 0.5 * noise_level**2 * (x - x0 * (1.0 - sigma)) / sigma**2
        mean = x + (v + log_term) * dt
        if stored is None:
            out = _store(mean + std_dev_t * torch.sqrt(-dt) * fresh_noise())
        else:
            out = stored
        if compute_log_prob:
            log_prob = _reduce_lp(_gaussian_log_prob(out, mean, std_dev_t, dt))

    elif dynamics_type == "CPS":
        std_dev_t = sigma_next * torch.sin(noise_level * math.pi / 2.0)
        x0 = x - sigma * v
        x1 = x + v * (1.0 - sigma)
        mean = x0 * (1.0 - sigma_next) + x1 * torch.sqrt(sigma_next**2 - std_dev_t**2)
        if stored is None:
            out = _store(mean + std_dev_t * fresh_noise())
        else:
            out = stored
        if compute_log_prob:
            log_prob = _reduce_lp(-((out.detach() - mean) ** 2))

    else:
        raise ValueError(f"Unknown dynamics_type: {dynamics_type!r}")

    if token_mask is not None:
        tm = token_mask.float()
        out = tm * out + (1.0 - tm) * x
        mean = tm * mean + (1.0 - tm) * x

    if not compute_log_prob:
        log_prob = None

    return SDEStepOutput(
        next_latents=out.to(in_dtype) if in_dtype != torch.float32 else out,
        next_latents_mean=mean,
        std_dev_t=std_dev_t,
        dt=dt,
        log_prob=log_prob,
        noise_pred=v,
    )


def convert_velocity_to_x0(v: torch.Tensor, latents: torch.Tensor, sigma: Scalar) -> torch.Tensor:
    """x0 = x − σ·v in fp32 (the flow-matching data prediction; LTX-2 mixes
    its guidance terms in x0 space)."""
    return latents.float() - _bcast(sigma, latents) * v.float()


def convert_x0_to_velocity(x0: torch.Tensor, latents: torch.Tensor, sigma: Scalar) -> torch.Tensor:
    """v = (x − x0) / σ, σ clamped at 1e-6: the inverse of :func:`convert_velocity_to_x0`."""
    return (latents.float() - x0.float()) / torch.clamp(_bcast(sigma, latents), min=1e-6)


# ---------------------------------------------------------------------------
# Host-side schedule wrapper
# ---------------------------------------------------------------------------

class FlowMatchEulerSDE:
    """Host-side schedule state: the sigma/timestep grid, the SDE-step subset
    drawn per epoch seed, and train/eval mode. Device math goes through
    :func:`sde_step`."""

    def __init__(
        self,
        noise_level: float = 0.7,
        sde_steps: Optional[Sequence[int]] = None,
        num_sde_steps: Optional[int] = None,
        seed: int = 42,
        dynamics_type: DynamicsType = "Flow-SDE",
        num_train_timesteps: int = 1000,
        shift: float = 1.0,
        use_dynamic_shifting: bool = False,
        base_image_seq_len: int = 256,
        max_image_seq_len: int = 4096,
        base_shift: float = 0.5,
        max_shift: float = 1.15,
        shift_terminal: Optional[float] = None,
    ):
        if noise_level < 0:
            raise ValueError("Noise level must be non-negative.")
        self.noise_level = noise_level
        self._sde_steps = None if sde_steps is None else np.asarray(sde_steps, dtype=np.int64)
        self._num_sde_steps = num_sde_steps
        self.seed = seed
        self.dynamics_type: DynamicsType = dynamics_type
        self.num_train_timesteps = num_train_timesteps
        self.shift = shift
        self.use_dynamic_shifting = use_dynamic_shifting
        self.base_image_seq_len = base_image_seq_len
        self.max_image_seq_len = max_image_seq_len
        self.base_shift = base_shift
        self.max_shift = max_shift
        self.shift_terminal = shift_terminal
        self._is_eval = False

        self.sigmas: Optional[np.ndarray] = None  # (T+1,) incl. terminal 0
        self.timesteps: Optional[np.ndarray] = None  # (T,) in [0, num_train_timesteps]

    # -- mode management ---------------------------------------------------
    @property
    def is_eval(self) -> bool:
        return self._is_eval

    def eval(self):
        self._is_eval = True

    def train(self, mode: bool = True):
        self._is_eval = not mode

    def rollout(self, mode: bool = True):
        self.train(mode=mode)

    def set_seed(self, seed: int):
        self.seed = seed

    # -- schedule ------------------------------------------------------------
    def set_timesteps(
        self,
        num_inference_steps: int,
        seq_len: Optional[int] = None,
        mu: Optional[float] = None,
        sigmas: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Set the sigma/timestep grid; returns timesteps (T,) float32. With
        dynamic shifting and no ``mu``, mu comes from ``seq_len``."""
        if self.use_dynamic_shifting and mu is None:
            if seq_len is None:
                raise ValueError("`seq_len` must be provided if `mu` is not given.")
            mu = calculate_shift(
                seq_len,
                self.base_image_seq_len,
                self.max_image_seq_len,
                self.base_shift,
                self.max_shift,
            )
        self.sigmas = build_flow_match_sigmas(
            num_inference_steps,
            shift=self.shift,
            use_dynamic_shifting=self.use_dynamic_shifting,
            mu=mu,
            sigmas=sigmas,
            shift_terminal=self.shift_terminal,
            num_train_timesteps=self.num_train_timesteps,
        )
        self.timesteps = (self.sigmas[:-1] * self.num_train_timesteps).astype(np.float32)
        return self.timesteps

    @property
    def num_inference_steps(self) -> int:
        return 0 if self.timesteps is None else len(self.timesteps)

    # -- SDE step subset ------------------------------------------------------
    @property
    def sde_steps(self) -> np.ndarray:
        if self._sde_steps is not None:
            return self._sde_steps
        return np.arange(0, max(self.num_inference_steps - 1, 0), dtype=np.int64)

    @property
    def num_sde_steps(self) -> int:
        if self._num_sde_steps is not None:
            return self._num_sde_steps
        return len(self.sde_steps)

    @property
    def current_sde_steps(self) -> np.ndarray:
        """SDE step indices under the current seed (redrawn each epoch)."""
        pool = self.sde_steps
        if self.num_sde_steps >= len(pool):
            return pool
        rng = np.random.default_rng(self.seed)
        return pool[rng.permutation(len(pool))[: self.num_sde_steps]]

    @property
    def train_timesteps(self) -> np.ndarray:
        """Timestep **indices** to train on this epoch."""
        return self.current_sde_steps

    def get_train_timesteps(self) -> np.ndarray:
        return self.timesteps[self.train_timesteps]

    def get_train_sigmas(self) -> np.ndarray:
        return self.sigmas[self.train_timesteps]

    def get_noise_levels(self) -> np.ndarray:
        """(T,) noise level per step — non-zero only inside the SDE window."""
        levels = np.zeros((self.num_inference_steps,), dtype=np.float32)
        if not self._is_eval and self.dynamics_type != "ODE":
            levels[self.current_sde_steps] = self.noise_level
        return levels

    def index_for_timestep(self, t: float) -> int:
        idx = np.nonzero(np.isclose(self.timesteps, t, atol=1e-3))[0]
        if len(idx) == 0:
            raise ValueError(f"Timestep {t} not in schedule")
        return int(idx[0])

    # -- step dispatch ---------------------------------------------------------
    def step(
        self,
        noise_pred: torch.Tensor,
        timestep_index: int,
        latents: torch.Tensor,
        *,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
        next_latents: Optional[torch.Tensor] = None,
        noise_level: Optional[Scalar] = None,
        compute_log_prob: bool = True,
        storage_dtype: torch.dtype = torch.bfloat16,
        dynamics_type: Optional[DynamicsType] = None,
    ) -> SDEStepOutput:
        """Single-step convenience wrapper (tests / loop callers)."""
        dynamics_type = dynamics_type or self.dynamics_type
        if self._is_eval:
            dynamics_type = "ODE"
            noise_level = 0.0
        elif noise_level is None:
            noise_level = float(self.get_noise_levels()[timestep_index])
        return sde_step(
            noise_pred,
            latents,
            float(self.sigmas[timestep_index]),
            float(self.sigmas[timestep_index + 1]),
            dynamics_type=dynamics_type,
            noise_level=noise_level,
            generator=generator,
            noise=noise,
            next_latents=next_latents,
            compute_log_prob=compute_log_prob,
            storage_dtype=storage_dtype,
            sigma_max=float(self.sigmas[1]) if len(self.sigmas) > 1 else 0.999,
        )
