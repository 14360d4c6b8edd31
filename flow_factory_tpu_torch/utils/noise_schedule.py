"""Time sampling for flow-matching RL training (host-side, numpy).

The port's copy of ``flow_factory_tpu/utils/noise_schedule.py`` (kept apart
so the port never imports the JAX package); the same seed gives the same
timesteps bit for bit. It re-implements the reference ``TimeSampler``
semantics (``src/flow_factory/utils/noise_schedule.py:79-259``):

``timestep_range=(frac_lo, frac_hi)`` is a **fraction along the denoising
axis** from scheduler time 1000 (noisy) toward 0 (clean):

    t_scheduler = TIMESTEP_MAX * (1 - frac)

All samplers return scheduler-scale timesteps in ``[0, TIMESTEP_MAX]`` as
numpy float32 arrays of shape ``(num_timesteps, batch_size)``.
``flow_match_sigma(t) = t/1000`` maps to the linear interpolation
``x_t = (1-σ) x0 + σ ε``.

Determinism contract: every sampler takes a ``seed`` (int); the same seed
produces byte-identical draws on every host.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
from scipy.special import ndtri  # inverse normal CDF

TIMESTEP_MAX = 1000.0


def flow_match_sigma(t_scheduler):
    """Map scheduler timestep in [0, TIMESTEP_MAX] to σ in [0, 1]."""
    return np.clip(np.asarray(t_scheduler) / TIMESTEP_MAX, 0.0, 1.0)


def fraction_range_to_t_bounds(frac_lo: float, frac_hi: float) -> Tuple[float, float]:
    """(t_min, t_max) in scheduler scale for fraction range [frac_lo, frac_hi]."""
    return TIMESTEP_MAX * (1.0 - frac_hi), TIMESTEP_MAX * (1.0 - frac_lo)


def _normalize_timestep_range(timestep_range: Union[float, Tuple[float, float]]) -> Tuple[float, float]:
    if isinstance(timestep_range, (list, tuple)):
        return float(timestep_range[0]), float(timestep_range[1])
    return 0.0, float(timestep_range)


def _rng(seed: Optional[int]) -> np.random.Generator:
    return np.random.default_rng(seed)


class TimeSampler:
    """Continuous and discrete time samplers for flow-matching training."""

    @staticmethod
    def _raw_logit_normal_unit(
        num_rows: int,
        stratified: bool,
        logit_mean: float,
        logit_std: float,
        time_shift: float,
        rng: np.random.Generator,
    ) -> np.ndarray:
        if stratified:
            u_base = rng.random(num_rows)
            base = (np.arange(num_rows) + u_base) / num_rows
            u_standard = ndtri(np.clip(base, 1e-7, 1 - 1e-7))
            u_standard = u_standard[rng.permutation(num_rows)]
        else:
            u_standard = rng.standard_normal(num_rows)
        u = u_standard * logit_std + logit_mean
        raw = 1.0 / (1.0 + np.exp(-u))
        raw = time_shift * raw / (1 + (time_shift - 1) * raw)
        return np.clip(raw, 0.01, 1.0 - 1e-6)

    @staticmethod
    def logit_normal_shifted(
        batch_size: int,
        num_timesteps: int,
        timestep_range: Union[float, Tuple[float, float]],
        logit_mean: float = 0.0,
        logit_std: float = 1.0,
        time_shift: float = 3.0,
        stratified: bool = True,
        seed: Optional[int] = None,
    ) -> np.ndarray:
        """Logit-normal (optionally stratified) time sampling with shift warp."""
        frac_lo, frac_hi = _normalize_timestep_range(timestep_range)
        raw = TimeSampler._raw_logit_normal_unit(
            num_timesteps, stratified, logit_mean, logit_std, time_shift, _rng(seed)
        )
        frac = frac_lo + raw * (frac_hi - frac_lo)
        t = TIMESTEP_MAX * (1.0 - frac)
        return np.broadcast_to(t[:, None], (num_timesteps, batch_size)).astype(np.float32).copy()

    @staticmethod
    def uniform(
        batch_size: int,
        num_timesteps: int,
        timestep_range: Union[float, Tuple[float, float]],
        time_shift: float = 1.0,
        seed: Optional[int] = None,
    ) -> np.ndarray:
        """Stratified uniform sampling over the fraction interval."""
        frac_lo, frac_hi = _normalize_timestep_range(timestep_range)
        rng = _rng(seed)
        rand_u = rng.random(num_timesteps)
        normalized = (np.arange(num_timesteps) + rand_u) / num_timesteps
        f = frac_lo + normalized * (frac_hi - frac_lo)
        f = f[rng.permutation(num_timesteps)]
        if abs(time_shift - 1.0) > 1e-6:
            f = time_shift * f / (1 + (time_shift - 1) * f)
        t = TIMESTEP_MAX * (1.0 - f)
        return np.broadcast_to(t[:, None], (num_timesteps, batch_size)).astype(np.float32).copy()

    @staticmethod
    def discrete(
        batch_size: int,
        num_train_timesteps: int,
        scheduler_timesteps: np.ndarray,
        timestep_range: Union[float, Tuple[float, float]] = 1.0,
        include_init: bool = True,
        force_init: bool = False,
        seed: Optional[int] = None,
    ) -> np.ndarray:
        """Discrete stratified sampling from the scheduler's timestep grid.

        Keeps indices whose timestep lies inside the fraction window, then
        stratifies over the contiguous index span among those matches.
        ``force_init`` always includes the first (noisiest) index;
        ``include_init=False`` excludes it from the candidate span.
        """
        ts = np.asarray(scheduler_timesteps, dtype=np.float64)
        num_steps = len(ts)
        rng = _rng(seed)

        frac_start, frac_end = _normalize_timestep_range(timestep_range)
        t_min, t_max = fraction_range_to_t_bounds(frac_start, frac_end)
        valid = np.where((ts >= t_min - 1e-3) & (ts <= t_max + 1e-3))[0]
        min_idx, max_idx = int(valid.min()), int(valid.max())

        if force_init:
            if num_train_timesteps == 1:
                t_indices = np.array([min_idx], dtype=np.int64)
            else:
                rest = TimeSampler._stratified_sample(num_train_timesteps - 1, min_idx + 1, max_idx, rng)
                t_indices = np.concatenate([np.array([min_idx], dtype=np.int64), rest])
        else:
            start_idx = min_idx if include_init else min_idx + 1
            t_indices = TimeSampler._stratified_sample(num_train_timesteps, start_idx, max_idx, rng)

        t_indices = np.clip(t_indices, 0, num_steps - 1)
        timesteps = ts[t_indices]
        return np.broadcast_to(timesteps[:, None], (num_train_timesteps, batch_size)).astype(np.float32).copy()

    @staticmethod
    def _stratified_sample(
        num_samples: int, start_idx: int, end_idx: int, rng: np.random.Generator
    ) -> np.ndarray:
        boundaries = np.linspace(start_idx, end_idx, num_samples + 1)
        lower, upper = boundaries[:-1].astype(np.int64), boundaries[1:].astype(np.int64)
        rand_u = rng.random(num_samples)
        return lower + (rand_u * (upper - lower)).astype(np.int64)
