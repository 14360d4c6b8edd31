"""BaseTrainer: the sample → feedback → optimize epoch loop.

Port of ``flow_factory_tpu/trainers/abc.py``:

* the optimizer is global-norm clipping with optax's semantics
  (``g·max_norm/‖g‖`` once ‖g‖ ≥ max_norm — not ``clip_grad_norm_``, which
  adds 1e-6) followed by ``torch.optim.AdamW`` with the configured betas,
  epsilon and weight decay passed explicitly, over the trainable leaves only;
* gradient accumulation is an fp32 sum in each trainable leaf's ``.grad``,
  which the backward of every grad step adds into (one gradient tree),
  divided by the count in place before the step; the clip runs in place a
  leaf at a time, and AdamW's parameters are split into groups of bounded
  size, so that its temporaries are one group's;
* every ``eval_freq`` epochs, before the epoch's rollout, :meth:`evaluate`
  rolls out the test split under the EMA weights, each prompt from its own
  generator, scores it with the pointwise rewards and logs its media;
* every ``save_freq`` epochs a checkpoint is saved at the head of the epoch,
  and at the end a ``final`` one; ``model.resume_path`` resumes (the
  adapter reads the checkpoint, the trainer takes the optimizer state, epoch
  and global step);
* SIGTERM sets a flag that :meth:`check_preempt` turns into a full-state save
  under ``<save_dir>/<run>/preempt`` at the next rollout-batch or
  micro-batch boundary, and a clean exit;
* ``log.profile_dir`` profiles epoch 1, ``FFT_MEMORY_PROFILE=1`` snapshots
  device memory around each phase;
* over a mesh (several processes, one GPU each) every process runs the
  loop on its own rows: before the clip the gradient sums are averaged over
  the data axes (``parallel.mesh.GradSync``; an fsdp-sharded leaf's backward
  already reduce-scattered its gradient), the clip's global norm sums the
  slices' squares over the fsdp group, AdamW steps each rank's slices, and
  the loss statistics go through ``reduce_loss_info`` across processes.
  Every rank calls the collectives in the same order: the micro-batch
  schedules are the same length on every rank by construction.
"""
from __future__ import annotations

import logging
import os
import threading
import time
from abc import ABC, abstractmethod
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..advantage import AdvantageProcessor
from ..data import get_dataloader
from ..logger import load_logger
from ..logger.formatting import condition_result_table, samples_to_media_payload
from ..models.abc import BaseAdapter
from ..parallel.dist import get_num_processes, get_rank, get_world_size, host_allgather_objects
from ..rewards import MultiRewardLoader, RewardBuffer
from ..samples import BaseSample
from ..utils.base import generators_for_prompts

logger = logging.getLogger(__name__)


class PreemptionRequested(Exception):
    """Raised at a safe step boundary after a preemption signal arrived."""


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


#: the most bytes of one AdamW parameter group (:func:`make_optimizer`)
GROUP_BYTES = 256 * 2**20


def make_optimizer(params: Sequence[torch.Tensor], training_args) -> torch.optim.AdamW:
    """AdamW over ``params`` with every hyperparameter passed explicitly
    (PyTorch's defaults differ from optax's), the leaves split, in order,
    into parameter groups of at most ``GROUP_BYTES`` (a larger leaf alone in
    its group): the grouped (``foreach``) path that the card takes by
    default holds its temporaries (the square root of the second moments)
    for one group at a time, not for every leaf at once, with the same
    arithmetic on every element, so the same θ as one group
    (``chip_smoke.py`` ``[full-grad]`` checks it bit for bit; the per-tensor
    and fused paths round otherwise)."""
    ta = training_args
    groups: List[List[torch.Tensor]] = [[]]
    size = 0
    for p in params:
        nbytes = p.numel() * p.element_size()
        if groups[-1] and size + nbytes > GROUP_BYTES:
            groups.append([])
            size = 0
        groups[-1].append(p)
        size += nbytes
    return torch.optim.AdamW([{"params": g} for g in groups], lr=ta.learning_rate, betas=tuple(ta.adam_betas),
                             eps=ta.adam_epsilon, weight_decay=ta.adam_weight_decay)


@torch.no_grad()
def apply_updates(optimizer: torch.optim.Optimizer, params: Sequence[torch.Tensor], max_norm: float,
                  count: int = 1, sync=None) -> torch.Tensor:
    """One optimizer step on the gradient sums of ``count`` grad steps held
    in each leaf's ``.grad`` (JAX ``_apply_updates_jit``,
    ``trainers/abc.py:545``), with no full-size temporary: each sum divided
    by ``count`` in place (a leaf with no gradient gets zeros, as under
    ``jax.grad``), the global norm, optax's ``clip_by_global_norm`` in place
    a leaf at a time (``g / norm * max_norm`` from ``max_norm`` on; below
    it ``g / 1 * 1``, the same bits), then the AdamW update, after which
    the gradients are freed. ``sync`` (a ``parallel.mesh.GradSync``)
    averages the sums over the mesh's data axes before the norm and gives
    the norm of a tree whose slices lie on several ranks. Returns the
    pre-clip norm (a device scalar)."""
    grads = []
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads.append(p.grad.div_(count))
    if sync is not None:
        sync.average(grads)
    if sync is not None and sync.any_sharded:
        gnorm = torch.sqrt(sync.squared_norm(grads))
    else:
        gnorm = torch.sqrt(sum(torch.sum(g.float() * g.float()) for g in grads))
    keep = gnorm < max_norm  # a device flag: no host sync
    div = torch.where(keep, torch.ones_like(gnorm), gnorm)
    mul = torch.where(keep, torch.ones_like(gnorm), torch.full_like(gnorm, max_norm))
    for g in grads:
        g.div_(div).mul_(mul)
    del grads
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)
    return gnorm


class BaseTrainer(ABC):
    #: grad steps summed into the trainable leaves' ``.grad`` since the last update
    _accum_count = 0

    def __init__(self, config, adapter: BaseAdapter):
        self.config = config
        self.adapter = adapter
        self.training_args = config.training_args
        self.eval_args = config.eval_args
        self.log_args = config.log_args
        self.scheduler = adapter.scheduler
        self.epoch = 0
        self.global_step = 0

        #: 1: one process drives one GPU (a tensor group's ranks share one replica's rows)
        self.local_replicas = max(1, get_world_size() // get_num_processes())
        #: per-process micro-batch = per-replica batch × local replicas
        self.micro_batch_size = self.training_args.per_device_batch_size * self.local_replicas

        self._init_dataloader()
        self._init_optimizer()
        self._init_rewards()
        self.logger_backend = load_logger(config.log_args, config.log_args.run_name, is_main_process=get_rank() == 0)
        self.adapter.post_init()
        self._restore_state_if_any()

        self._preempt_event = threading.Event()
        if getattr(self.log_args, "save_on_preempt", True):
            self._install_preempt_handler()

    # ------------------------------------------------------------------
    # Init stages
    # ------------------------------------------------------------------
    def _init_dataloader(self) -> None:
        self.train_loader, self.test_loader = get_dataloader(self.config, self.adapter.preprocess_func)

    def _init_optimizer(self) -> None:
        self.optimizer = make_optimizer(self.adapter.trainable_leaves(), self.training_args)
        self._accum_count = 0
        self.grad_sync = None
        if getattr(self.adapter, "mesh", None) is not None:
            from ..parallel.mesh import GradSync

            self.grad_sync = GradSync(self.adapter.mesh, [d is not None for d in self.adapter.trainable_leaf_dims()])

    def _init_rewards(self) -> None:
        ta = self.training_args
        ra, era = self.config.reward_args, self.config.eval_reward_args
        weights = ra.reward_weights if ra else None
        distributed_groups = self.config.data_args.sampler_type == "distributed_k_repeat"
        loader = MultiRewardLoader()
        train_models = loader.load(ra)
        self.reward_buffer = RewardBuffer(train_models, group_size=ta.group_size,
                                          distributed_groups=distributed_groups, reward_weights=weights)
        # the eval rewards default to the training ones (JAX trainers/abc.py:139-152)
        self.eval_reward_buffer = RewardBuffer(loader.load(era) if era else train_models, group_size=ta.group_size,
                                               distributed_groups=False,
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
    def backward_step(self, batch: Dict[str, Any], ref_trainable=None) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One grad step on the live tree: the trainer's ``loss_fn`` of
        ``batch``, its gradient added by the backward into each trainable
        leaf's ``.grad`` (the one accumulation tree: a leaf's step gradient
        is added as it is made and freed, and no second tree is held).
        Returns (loss, aux); this is what ``optimize`` runs."""
        loss, aux = self.loss_fn(self.adapter.trainable, batch, ref_trainable)
        torch.autograd.backward(loss, inputs=self.adapter.trainable_leaves())
        self._accum_count += 1
        return loss.detach(), aux

    def loss_and_grads(self, batch: Dict[str, Any], ref_trainable=None):
        """((loss, aux), one grad step's gradients in ``trainable_leaves``
        order): :meth:`backward_step` with no accumulation pending, its
        ``.grad`` taken off the leaves. A leaf the loss does not reach gets
        zeros, as under ``jax.grad``: LTX-2's last block updates the audio
        stream after the video stream's last read of it, and a Wan2.2 step
        routes to one expert."""
        leaves = self.adapter.trainable_leaves()
        if any(p.grad is not None for p in leaves):
            raise RuntimeError("loss_and_grads with accumulated gradients not yet applied")
        loss, aux = self.backward_step(batch, ref_trainable)
        self._accum_count -= 1
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in leaves]
        for p in leaves:
            p.grad = None
        return (loss, aux), grads

    def apply_accumulated(self) -> Optional[torch.Tensor]:
        """Average the accumulated gradients and step the optimizer; returns
        the gradient norm as a device scalar (read once per epoch)."""
        if self._accum_count == 0:
            return None
        gnorm = apply_updates(self.optimizer, self.adapter.trainable_leaves(), self.training_args.max_grad_norm,
                              self._accum_count, self.grad_sync)
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

    # ------------------------------------------------------------------
    # Preemption-safe checkpointing: the SIGTERM handler only sets a flag;
    # the trainers poll ``check_preempt()`` at rollout-batch and micro-batch
    # boundaries, so the step in flight always completes and the saved state
    # is a step boundary. The handler holds the flag alone, not the trainer, so
    # a handler still installed keeps no trainer (and its device memory) alive.
    # ------------------------------------------------------------------
    def _install_preempt_handler(self) -> None:
        import signal

        event = self._preempt_event

        def _handler(signum, frame):
            event.set()
            logger.warning("Signal %d received — will checkpoint and exit at the next step boundary", signum)

        try:
            self._prev_sigterm = signal.signal(signal.SIGTERM, _handler)
        except ValueError:  # not the main thread
            self._prev_sigterm = None

    def _uninstall_preempt_handler(self) -> None:
        import signal

        prev = getattr(self, "_prev_sigterm", None)
        if prev is not None:
            try:
                signal.signal(signal.SIGTERM, prev)
            except ValueError:
                pass
            self._prev_sigterm = None

    def request_preempt(self) -> None:
        """What the SIGTERM handler does, for callers that learn of a
        preemption another way."""
        self._preempt_event.set()

    def check_preempt(self) -> None:
        if self._preempt_event.is_set():
            raise PreemptionRequested()

    def _preempt_save(self, save_dir: str) -> str:
        """Full-state save that redoes the interrupted epoch: the recorded
        epoch is ``self.epoch - 1``, the last one completed, so a resume runs
        the interrupted epoch again from its start (the samplers and the
        scheduler are seeded by epoch, and its rollouts are drawn again)."""
        path = os.path.join(save_dir, "preempt")
        self.save_checkpoint(path, model_only=False, completed_epoch=self.epoch - 1)
        logger.warning("Preemption checkpoint written to %s — exiting", path)
        return path

    def start(self) -> None:
        ta = self.training_args
        save_dir = os.path.join(self.log_args.save_dir, self.log_args.run_name)
        for epoch in range(self.epoch, ta.max_epochs or 1):
            self.epoch = epoch
            t0 = time.time()
            self.scheduler.set_seed(ta.seed + epoch)

            if self.log_args.save_freq and epoch > 0 and epoch % self.log_args.save_freq == 0:
                self.save_checkpoint(os.path.join(save_dir, f"epoch_{epoch}"))
            try:
                self.check_preempt()
                if self.eval_args.eval_freq and epoch % self.eval_args.eval_freq == 0 and self.test_loader:
                    self.evaluate(epoch)
                profile_dir = getattr(self.log_args, "profile_dir", None)
                if profile_dir and epoch == 1:  # the second epoch: the first builds the kernels
                    from ..utils.memory_tracker import trace

                    with trace(profile_dir, annotate=f"epoch_{epoch}"):
                        samples, metrics, loss_info = self._run_epoch_phases(epoch)
                else:
                    samples, metrics, loss_info = self._run_epoch_phases(epoch)
            except PreemptionRequested:
                self._preempt_save(save_dir)
                self.cleanup()
                return
            self.adapter.ema_step(epoch)

            if self.logger_backend:
                self.logger_backend.log_data({**metrics, **loss_info, "time/epoch_s": time.time() - t0}, epoch)
                n_media = getattr(self.log_args, "log_train_samples", 0)
                if n_media:
                    self._log_media("train/samples", samples_to_media_payload(samples, n_media), epoch)
        if self.log_args.save_freq:
            self.save_checkpoint(os.path.join(save_dir, "final"))
        if self.logger_backend:
            self.logger_backend.finish()
        self._uninstall_preempt_handler()

    def _log_media(self, tag: str, media: Dict[str, Any], step: int) -> None:
        if media["images"]:
            self.logger_backend.log_images(tag, media["images"], media["captions"], step=step)
        if media["videos"]:
            self.logger_backend.log_videos(tag, media["videos"], media["captions"], step=step)

    def _run_epoch_phases(self, epoch: int):
        """sample → feedback → optimize, with device-memory snapshots around
        each phase when ``FFT_MEMORY_PROFILE`` or ``log.memory_profile`` is
        set (``FFT_MEMORY_PROFILE_DIR`` adds the allocator's snapshots)."""
        mem = None
        if os.environ.get("FFT_MEMORY_PROFILE") or getattr(self.log_args, "memory_profile", False):
            if not hasattr(self, "_memory_profiler"):
                from ..utils.memory_tracker import MemoryProfiler

                self._memory_profiler = MemoryProfiler()
            mem = self._memory_profiler
        if mem is None:
            samples = self.sample(epoch)
            metrics = self.prepare_feedback(samples)
            loss_info = self.optimize(samples, epoch)
            return samples, metrics, loss_info
        with mem.stage(f"epoch{epoch}/sample"):
            samples = self.sample(epoch)
        mem.tensors.track_samples(f"epoch{epoch}/samples", samples)
        with mem.stage(f"epoch{epoch}/feedback"):
            metrics = self.prepare_feedback(samples)
        with mem.stage(f"epoch{epoch}/optimize"):
            loss_info = self.optimize(samples, epoch)
        mem.log_report()
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
        loader's tail padding dropped; the pointwise rewards' scores (the
        groupwise ones sit out: no group completes); the metrics logged
        at ``epoch`` with up to 16 samples' media and, for conditioned tasks,
        their condition images. Synchronous, batch after batch (no
        ``PendingRollout`` yet)."""
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
        # one sample a prompt: no group completes, so the groupwise models sit out
        self.eval_reward_buffer.finalize(split="pointwise")
        metrics = gather_eval_reward_metrics(samples)
        if self.logger_backend:
            self.logger_backend.log_data(metrics, epoch)
            self._log_media("eval/samples", samples_to_media_payload(samples, 16), epoch)
            cond_imgs, cond_caps = [], []
            for r in condition_result_table(samples, 16):
                conds = r["conditions"]
                if conds is None:
                    continue
                for c in conds if isinstance(conds, (list, tuple)) else [conds]:
                    if isinstance(c, np.ndarray) and c.ndim == 3:
                        cond_imgs.append(c)
                        cond_caps.append(f"{r['prompt']} | r={r['reward']}")
            if cond_imgs:
                self.logger_backend.log_images("eval/conditions", cond_imgs, cond_caps, step=epoch)
        self.eval_reward_buffer.clear()
        self.adapter.train()
        return metrics

    # ------------------------------------------------------------------
    # Checkpointing
    # ------------------------------------------------------------------
    def save_checkpoint(self, save_dir: str, model_only: Optional[bool] = None,
                        completed_epoch: Optional[int] = None) -> None:
        t0 = time.perf_counter()
        model_only = self.log_args.save_model_only if model_only is None else model_only
        self.adapter.save_checkpoint(
            save_dir,
            model_only=model_only,
            extra_state=None if model_only else {"opt_state": self._optimizer_state(),
                         "epoch": self.epoch if completed_epoch is None else completed_epoch,
                         "global_step": self.global_step},
        )
        logger.info("Saved checkpoint to %s in %.3f s", save_dir, time.perf_counter() - t0)

    def _optimizer_state(self) -> Dict[str, Any]:
        """The AdamW state with every fsdp-sharded state tensor gathered
        whole (a collective: every rank calls it), so that the saved state
        is the one-process layout."""
        sd = self.optimizer.state_dict()
        plan = self.adapter.fsdp_plan
        if plan is None:
            return sd
        from ..parallel.mesh import all_gather_dim

        dims = self.adapter.trainable_leaf_dims()
        state = {}
        for i, st in sorted(sd["state"].items()):
            st = dict(st)  # the live optimizer's own dicts are not touched
            if dims[i] is not None:
                for k, t in st.items():
                    if torch.is_tensor(t) and t.ndim:
                        st[k] = all_gather_dim(t, dims[i], plan.group, plan.size)
            state[i] = st
        return {**sd, "state": state}

    def _placed_optimizer_state(self, saved: Dict[str, Any]) -> Dict[str, Any]:
        """A saved (whole) AdamW state as this rank holds it: its slices of
        every fsdp-sharded state tensor."""
        plan = self.adapter.fsdp_plan
        if plan is None:
            return saved
        dims = self.adapter.trainable_leaf_dims()
        state = {}
        for i, st in saved.get("state", {}).items():
            d = dims[int(i)] if int(i) < len(dims) else None
            state[i] = {k: (t.chunk(plan.size, d)[plan.rank].contiguous()
                            if d is not None and torch.is_tensor(t) and t.ndim else t) for k, t in st.items()}
        return {**saved, "state": state}

    def _restore_state_if_any(self) -> None:
        """The optimizer state, epoch and global step of a ``train_state``
        the adapter read: the AdamW state by ``load_state_dict`` (which moves
        it to the parameters' device) when it fits the live optimizer, else a
        warning and a fresh optimizer; training resumes at the epoch after
        the recorded one."""
        state = getattr(self.adapter, "_restored_state", None)
        if state:
            if "opt_state" in state:
                opt_state = self._placed_optimizer_state(state["opt_state"])
                if _optimizer_state_fits(self.optimizer, opt_state):
                    self.optimizer.load_state_dict(opt_state)
                else:
                    logger.warning("Checkpoint optimizer state does not fit the live optimizer (%d parameters) — "
                                   "optimizer state NOT restored (weights/epoch still are)",
                                   sum(len(g["params"]) for g in self.optimizer.param_groups))
            self.epoch = int(state.get("epoch", 0)) + 1
            self.global_step = int(state.get("global_step", 0))
            logger.info("Resumed at epoch %d (global step %d)", self.epoch, self.global_step)
            self.adapter._restored_state = {}  # the optimizer holds its own copy now

    def cleanup(self) -> None:
        self._uninstall_preempt_handler()
        self.reward_buffer.cleanup()
        self.eval_reward_buffer.cleanup()
        if self.logger_backend:
            self.logger_backend.finish()


def _optimizer_state_fits(optimizer: torch.optim.Optimizer, saved: Dict[str, Any]) -> bool:
    """Whether ``saved`` (an optimizer ``state_dict``) has the live
    optimizer's groups and parameter counts, and every per-parameter state
    tensor of more than one element the shape of its parameter."""
    groups = saved.get("param_groups", [])
    if [len(g["params"]) for g in groups] != [len(g["params"]) for g in optimizer.param_groups]:
        return False
    live = [p for g in optimizer.param_groups for p in g["params"]]
    ids = [i for g in groups for i in g["params"]]
    for i, p in zip(ids, live):
        for t in saved.get("state", {}).get(i, {}).values():
            if torch.is_tensor(t) and t.numel() > 1 and tuple(t.shape) != tuple(p.shape):
                return False
    return True
