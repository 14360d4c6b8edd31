"""BaseTrainer: the sample → feedback → optimize epoch loop.

Port of ``flow_factory_tpu/trainers/abc.py``:

* the optimizer is global-norm clipping with optax's semantics
  (``g·max_norm/‖g‖`` once ‖g‖ ≥ max_norm — not ``clip_grad_norm_``, which
  adds 1e-6) followed by ``torch.optim.AdamW`` with the configured betas,
  epsilon and weight decay passed explicitly, over the trainable leaves only;
* gradient accumulation is an explicit fp32 sum, divided by the count
  before the step;
* every ``eval_freq`` epochs, before the epoch's rollout, :meth:`evaluate`
  rolls out the test split under the EMA weights, each prompt from its own
  generator, and scores it pointwise;
* the loop runs on one process; checkpoint saving (``save_freq > 0``) and
  logging backends other than ``none`` are not ported and raise at
  construction.
"""
from __future__ import annotations

import logging
import time
from abc import ABC, abstractmethod
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..advantage import AdvantageProcessor
from ..data import get_dataloader
from ..logger import load_logger
from ..models.abc import BaseAdapter
from ..parallel.dist import get_num_processes, get_world_size, host_allgather_objects
from ..rewards import MultiRewardLoader, RewardBuffer
from ..samples import BaseSample
from ..utils.base import generators_for_prompts

logger = logging.getLogger(__name__)


def gather_eval_reward_metrics(samples: List[BaseSample]) -> Dict[str, float]:
    """Eval reward statistics over every process's samples, per reward model
    (JAX ``gather_eval_reward_metrics``, ``trainers/abc.py:41``): the mean
    and std of the weighted reward, the sample count, and each model's mean
    and std."""
    local_rows = [(float(s.extra_kwargs.get("reward", 0.0)),
                   {k: float(v) for k, v in s.extra_kwargs.get("rewards", {}).items()}) for s in samples]
    rows = [r for lst in host_allgather_objects(local_rows) for r in lst]
    rewards = np.asarray([r[0] for r in rows])
    metrics = {
        "eval/reward_mean": float(rewards.mean()) if len(rewards) else 0.0,
        "eval/reward_std": float(rewards.std()) if len(rewards) else 0.0,
        "eval/num_samples": float(len(rewards)),
    }
    for name in sorted({k for _, d in rows for k in d}):
        vals = np.asarray([d.get(name, 0.0) for _, d in rows])
        metrics[f"eval/reward/{name}/mean"] = float(vals.mean())
        metrics[f"eval/reward/{name}/std"] = float(vals.std())
    return metrics


def make_optimizer(params: Sequence[torch.Tensor], training_args) -> torch.optim.AdamW:
    """AdamW over ``params`` with every hyperparameter passed explicitly
    (PyTorch's defaults differ from optax's)."""
    ta = training_args
    return torch.optim.AdamW(params, lr=ta.learning_rate, betas=tuple(ta.adam_betas),
                             eps=ta.adam_epsilon, weight_decay=ta.adam_weight_decay)


@torch.no_grad()
def apply_updates(optimizer: torch.optim.Optimizer, params: Sequence[torch.Tensor],
                  grads: Sequence[torch.Tensor], max_norm: float) -> torch.Tensor:
    """One optimizer step on averaged ``grads`` (JAX ``_apply_updates_jit``,
    ``trainers/abc.py:545``): the global norm, optax's ``clip_by_global_norm``
    (unchanged below ``max_norm``, else ``g / norm * max_norm``), then the
    AdamW update in place. Returns the pre-clip norm (a device scalar)."""
    gnorm = torch.sqrt(sum(torch.sum(g.float() * g.float()) for g in grads))
    keep = gnorm < max_norm  # a device flag: no host sync
    for p, g in zip(params, grads):
        p.grad = torch.where(keep, g, g / gnorm * max_norm).to(p.dtype)
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)
    return gnorm


class BaseTrainer(ABC):
    def __init__(self, config, adapter: BaseAdapter):
        self.config = config
        self.adapter = adapter
        self.training_args = config.training_args
        self.eval_args = config.eval_args
        self.log_args = config.log_args
        self.scheduler = adapter.scheduler
        self.epoch = 0
        self.global_step = 0
        if self.log_args.save_freq:
            raise NotImplementedError("checkpoint saving (log.save_freq > 0) is not ported yet; set save_freq: 0")

        self.local_replicas = max(1, get_world_size() // get_num_processes())
        #: per-process micro-batch = per-replica batch × local replicas
        self.micro_batch_size = self.training_args.per_device_batch_size * self.local_replicas

        self._init_dataloader()
        self._init_optimizer()
        self._init_rewards()
        self.logger_backend = load_logger(config.log_args, config.log_args.run_name)
        self.adapter.post_init()

    # ------------------------------------------------------------------
    # Init stages
    # ------------------------------------------------------------------
    def _init_dataloader(self) -> None:
        self.train_loader, self.test_loader = get_dataloader(self.config, self.adapter.preprocess_func)

    def _init_optimizer(self) -> None:
        self.optimizer = make_optimizer(self.adapter.trainable_leaves(), self.training_args)
        self._accum_grads: Optional[List[torch.Tensor]] = None
        self._accum_count = 0

    def _init_rewards(self) -> None:
        ta = self.training_args
        ra, era = self.config.reward_args, self.config.eval_reward_args
        weights = ra.reward_weights if ra else None
        distributed_groups = self.config.data_args.sampler_type == "distributed_k_repeat"
        loader = MultiRewardLoader()
        train_models = loader.load(ra)
        self.reward_buffer = RewardBuffer(train_models, reward_weights=weights)
        # the eval rewards default to the training ones; a RewardBuffer takes
        # pointwise models only, which is what the JAX evaluate's
        # finalize(split="pointwise") scores
        self.eval_reward_buffer = RewardBuffer(loader.load(era) if era else train_models,
                                               reward_weights=era.reward_weights if era else weights)
        self.advantage_processor = AdvantageProcessor(
            group_size=ta.group_size,
            aggregation=getattr(ta, "advantage_aggregation", "sum"),
            std_mode="global" if getattr(ta, "global_std", True) else "per_group",
            reward_weights=weights,
            distributed_groups=distributed_groups,
        )

    # ------------------------------------------------------------------
    # Optimizer mechanics
    # ------------------------------------------------------------------
    def accumulate_grads(self, grads: Sequence[torch.Tensor]) -> None:
        """Add one grad step's gradients (ordered as ``trainable_leaves``) to
        the fp32 sums."""
        if self._accum_grads is None:
            self._accum_grads = [g.float().clone() for g in grads]
        else:
            for a, g in zip(self._accum_grads, grads):
                a.add_(g.float())
        self._accum_count += 1

    def apply_accumulated(self) -> Optional[torch.Tensor]:
        """Average the accumulated gradients and step the optimizer; returns
        the gradient norm as a device scalar (read once per epoch)."""
        if self._accum_grads is None or self._accum_count == 0:
            return None
        grads = [a / self._accum_count for a in self._accum_grads]
        gnorm = apply_updates(self.optimizer, self.adapter.trainable_leaves(), grads,
                              self.training_args.max_grad_norm)
        self._accum_grads = None
        self._accum_count = 0
        self.global_step += 1
        return gnorm

    # ------------------------------------------------------------------
    # Epoch loop
    # ------------------------------------------------------------------
    #: batch keys the trainers pass explicitly; the rest of a preprocessed
    #: batch forwards to inference
    _STD_BATCH_KEYS = frozenset({
        "prompt", "prompt_embeds", "pooled_prompt_embeds",
        "negative_prompt_embeds", "negative_pooled_prompt_embeds",
    })
    #: trainer-controlled inference kwargs a dataset column must not override
    _RESERVED_BATCH_KEYS = frozenset({
        "seed", "generator", "trainable", "compute_log_prob",
        "trajectory_indices", "store_means", "num_inference_steps", "decode",
    })

    def condition_kwargs(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        def is_path_field(v) -> bool:
            # raw media columns are file paths, already folded in by preprocessing
            if isinstance(v, str):
                return True
            if isinstance(v, (list, tuple)):
                inner = next((x for x in v if x is not None), None)
                return is_path_field(inner) if inner is not None else False
            return False

        return {k: v for k, v in batch.items()
                if k not in self._STD_BATCH_KEYS and k not in self._RESERVED_BATCH_KEYS
                and v is not None and not is_path_field(v)}

    def start(self) -> None:
        ta = self.training_args
        for epoch in range(self.epoch, ta.max_epochs or 1):
            self.epoch = epoch
            t0 = time.time()
            self.scheduler.set_seed(ta.seed + epoch)
            if self.eval_args.eval_freq and epoch % self.eval_args.eval_freq == 0 and self.test_loader:
                self.evaluate(epoch)
            samples, metrics, loss_info = self._run_epoch_phases(epoch)
            self.adapter.ema_step(epoch)
            self.logger_backend.log_data({**metrics, **loss_info, "time/epoch_s": time.time() - t0}, epoch)

    def _run_epoch_phases(self, epoch: int):
        samples = self.sample(epoch)
        metrics = self.prepare_feedback(samples)
        loss_info = self.optimize(samples, epoch)
        return samples, metrics, loss_info

    @abstractmethod
    def sample(self, epoch: int) -> List[BaseSample]: ...

    def prepare_feedback(self, samples: List[BaseSample]) -> Dict[str, float]:
        self.reward_buffer.finalize()
        return self.advantage_processor.compute_advantages(samples)

    @abstractmethod
    def optimize(self, samples: List[BaseSample], epoch: int) -> Dict[str, float]: ...

    def evaluate(self, epoch: int) -> Dict[str, float]:
        """One eval rollout of the test split under the EMA weights (JAX
        ``evaluate``, ``trainers/abc.py:380-469``): the eval geometry, no
        log-probs or trajectory, each prompt's x0 from its own generator; the
        loader's tail padding dropped; pointwise scoring; the metrics logged
        at ``epoch``. Synchronous, batch after batch (no ``PendingRollout``
        yet); media are not logged (the port's backends take scalars)."""
        if self.test_loader is None:
            return {}
        self.adapter.eval()
        ea = self.eval_args
        samples: List[BaseSample] = []
        for batch in self.test_loader:
            out = self.adapter.inference(
                prompt=batch["prompt"],
                prompt_embeds=batch.get("prompt_embeds"),
                pooled_prompt_embeds=batch.get("pooled_prompt_embeds"),
                negative_prompt_embeds=batch.get("negative_prompt_embeds"),
                negative_pooled_prompt_embeds=batch.get("negative_pooled_prompt_embeds"),
                height=ea.height,
                width=ea.width,
                num_inference_steps=ea.num_inference_steps,
                guidance_scale=ea.guidance_scale,
                compute_log_prob=False,
                trajectory_indices=None,
                generator=generators_for_prompts(batch["prompt"], ea.seed or 0, self.adapter.device),
                trainable=self.adapter.ema_trainable,
                **{k: v for k, v in self.condition_kwargs(batch).items()
                   if k not in ("height", "width", "guidance_scale")},
            )
            samples.extend(out[: len(out) - int(batch.get("_num_pad") or 0)])
        self.eval_reward_buffer.add_samples(samples)
        self.eval_reward_buffer.finalize()
        metrics = gather_eval_reward_metrics(samples)
        self.logger_backend.log_data(metrics, epoch)
        self.eval_reward_buffer.clear()
        self.adapter.train()
        return metrics

    def cleanup(self) -> None:
        self.reward_buffer.cleanup()
        self.eval_reward_buffer.cleanup()
