"""EMA of a trainable tree and its decay schedules.

Port of ``flow_factory_tpu/ema/ema.py``: the EMA is another tree of fp32
tensors (for LoRA, a copy of the small LoRA tree), updated as
``e·decay + p·(1 − decay)`` every ``update_interval`` steps; with
``update_interval=0`` it never updates and serves as a frozen snapshot (the
reference policy of full finetuning, and the adapter's named parameter
snapshots, which :meth:`EMA.blend` and :meth:`EMA.copy_from` move by hand).
``offload=True`` keeps the tree in host memory (JAX ``ema/ema.py:112-141``):
each update copies the live tree to the host and blends there.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Optional

import torch

DecayFn = Callable[[int], float]


# ---------------------------------------------------------------------------
# Decay schedules (step → decay in [0, 1])
# ---------------------------------------------------------------------------

def constant_decay(decay: float = 0.999) -> DecayFn:
    return lambda step: decay


def power_decay(gamma: float = 1.0, power: float = 2.0 / 3.0, max_decay: float = 0.9999) -> DecayFn:
    def fn(step: int) -> float:
        if step <= 0:
            return 0.0
        return min(max_decay, 1.0 - (1.0 + step / gamma) ** (-power))

    return fn


def linear_decay(start: float = 0.9, end: float = 0.9999, num_steps: int = 10000) -> DecayFn:
    def fn(step: int) -> float:
        if step >= num_steps:
            return end
        return start + (end - start) * (step / max(num_steps, 1))

    return fn


def piecewise_linear_decay(boundaries, values) -> DecayFn:
    """boundaries: [s1, s2, ...]; values: [v0, v1, ...] (len = len(boundaries)+1)."""

    def fn(step: int) -> float:
        for b, v in zip(boundaries, values):
            if step < b:
                return v
        return values[len(boundaries)]

    return fn


def cosine_decay(start: float = 0.9, end: float = 0.9999, num_steps: int = 10000) -> DecayFn:
    def fn(step: int) -> float:
        if step >= num_steps:
            return end
        cos = 0.5 * (1.0 + math.cos(math.pi * (1.0 - step / max(num_steps, 1))))
        return start + (end - start) * cos

    return fn


def warmup_cosine_decay(
    warmup_steps: int = 1000, start: float = 0.0, end: float = 0.9999, num_steps: int = 10000
) -> DecayFn:
    cos = cosine_decay(start, end, max(num_steps - warmup_steps, 1))

    def fn(step: int) -> float:
        if step < warmup_steps:
            return start
        return cos(step - warmup_steps)

    return fn


_SCHEDULES = {
    "constant": constant_decay,
    "power": power_decay,
    "linear": linear_decay,
    "piecewise_linear": piecewise_linear_decay,
    "cosine": cosine_decay,
    "warmup_cosine": warmup_cosine_decay,
}


def get_decay_schedule(name: str, **kwargs) -> DecayFn:
    if name not in _SCHEDULES:
        raise KeyError(f"Unknown EMA decay schedule {name!r}; have {sorted(_SCHEDULES)}")
    return _SCHEDULES[name](**kwargs)


# ---------------------------------------------------------------------------
# EMA holder
# ---------------------------------------------------------------------------

def tree_map(fn, tree, *rest):
    """``fn`` over the tensor leaves of nested dicts (matching structures)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


class EMA:
    """EMA over a trainable tree; ``update_interval=0`` never updates;
    ``offload=True`` holds it on the host."""

    def __init__(self, params: Any, decay_fn: Optional[DecayFn] = None, update_interval: int = 1,
                 offload: bool = False):
        self.decay_fn = decay_fn or constant_decay(0.999)
        self.update_interval = update_interval
        self.offload = offload
        self.step = 0
        self.params = self._place(params)

    def _place(self, tree: Any) -> Any:
        """A detached fp32 copy of ``tree``, on the host when offloaded."""
        if self.offload:
            return tree_map(lambda x: x.detach().to("cpu", torch.float32, copy=True), tree)
        return tree_map(lambda x: x.detach().float().clone(), tree)

    @torch.no_grad()
    def update(self, params: Any, step: Optional[int] = None) -> None:
        self.step = self.step + 1 if step is None else step
        if self.update_interval <= 0 or self.step % self.update_interval != 0:
            return
        self.blend(params, self.decay_fn(self.step))

    @torch.no_grad()
    def blend(self, params: Any, decay: float) -> None:
        """``e·decay + p·(1 − decay)`` in the store's dtype, with decay and
        1 − decay rounded to fp32 as the JAX update computes them (not
        ``lerp``, which rounds otherwise); new tensors, so a tree taken
        before the blend keeps its values."""
        d = torch.tensor(decay, dtype=torch.float32)
        keep, take = d.item(), (1.0 - d).item()
        self.params = tree_map(lambda e, p: e * keep + p.detach().to(e.device, e.dtype) * take,
                               self.params, params)

    def copy_from(self, params: Any) -> None:
        """A hard reset to a detached fp32 copy of ``params``."""
        self.params = self._place(params)

    def state_dict(self) -> dict:
        return {"step": self.step, "params": self.params}

    def load_state_dict(self, state: dict) -> None:
        """The step and the params of ``state``, each param on the device and
        in the dtype of the live one it replaces."""
        self.step = int(state["step"])
        self.params = tree_map(lambda live, saved: saved.to(device=live.device, dtype=live.dtype),
                               self.params, state["params"])
