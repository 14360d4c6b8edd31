"""Adapter base: rollout loop and no-grad replay shared by every model family.

Port of ``flow_factory_tpu/models/abc.py``. An adapter holds ``nn.Module``
components on one explicit device, the host-side scheduler, and two device
paths that run the SAME math:

* :meth:`BaseAdapter._rollout_impl` — the denoise loop: velocity, then
  :func:`sde_step`, writing each step into preallocated slot-mapped buffers
  (one extra garbage slot takes the positions that are not stored);
  :meth:`BaseAdapter.rollout_compute` sends an eval rollout of a UniPC
  scheduler to :meth:`BaseAdapter._unipc_eval_impl` instead;
* :meth:`BaseAdapter._forward_impl` — one stored transition replayed without
  gradients, through the same velocity and step math and the same
  storage-dtype round trip, so ``exp(new_lp - old_lp) == 1`` exactly;
* :meth:`BaseAdapter.training_forward` — the same replay, differentiable in
  the trainable tree (LoRA or full weights, master dtype).

The velocity runs on the effective weights of :meth:`merged_params` through
``torch.func.functional_call``: the rollout and the no-grad replay merge the
LoRA once per call, the training forward once per step with gradients; one
merge code path, so all three see the same bits. A model that routes each
step to one of several trained components (Wan2.2's two experts) picks them
in :meth:`step_params` from the step's timestep as the host knows it.
"""
from __future__ import annotations

import json
import logging
import os
import re
from abc import ABC, abstractmethod
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ema import EMA, constant_decay, get_decay_schedule, tree_map
from ..parallel.dist import barrier, get_rank
from ..samples import BaseSample
from ..scheduler.flow_match_euler import FlowMatchEulerSDE, sde_step
from ..scheduler.registry import get_scheduler_class
from ..scheduler.unipc import compute_unipc_orders, init_unipc_carry, unipc_eval_step
from ..utils.base import make_generator, resolve_device
from ..utils.checkpoint import ComponentImport, import_state_dict, load_safetensors_dir, safetensors_files
from ..utils.safetensors_io import load_file, save_file
from ..utils.weights import ModuleMap, RawMap, load_component, lora_from_flax
from .lora import DEFAULT_TARGET_PATTERNS, init_lora, lora_param_count, merge_lora, zero_like_lora

logger = logging.getLogger(__name__)

#: {component: {name: tensor}} — LoRA ``{path: {lora_A, lora_B}}`` or full weights
Trainable = Dict[str, Dict[str, Any]]
#: effective weights a velocity runs on (:meth:`BaseAdapter.merged_params`):
#: {name: tensor} for ``functional_call``, ``{}`` the frozen weights; a model
#: that routes each step to one of several components gives its own type
#: (Wan2.2's ``WanExperts``), which :meth:`BaseAdapter.step_params` routes
Params = Any


class BaseAdapter(ABC):
    """Adapter = model modules + scheduler + the rollout and replay paths."""

    sample_class = BaseSample
    #: components whose weights are trained (LoRA'd or fully)
    default_trainable_components: Tuple[str, ...] = ("transformer",)
    #: LoRA target patterns (regex over parameter names) for 'default'
    default_target_patterns: Tuple[str, ...] = DEFAULT_TARGET_PATTERNS
    #: the component that predicts the velocity
    velocity_component: str = "transformer"
    #: embedding keys the velocity reads from a batch (a sample's field or
    #: ``extra_kwargs`` entry of that name)
    embed_keys: Tuple[str, ...] = ("prompt_embeds", "negative_prompt_embeds")
    #: scheduler registry key used when the config names none (Wan: 'unipc')
    default_scheduler: str = "flow_match_euler"
    #: further latent streams a stored transition replays with, {batch key:
    #: sample key}, indexed by the stored-latent slot of the transition
    #: (LTX-2's audio latents beside its video latents); the velocity reads
    #: them among its embeds, the trainers stage them per grad step
    trajectory_batch_keys: Dict[str, str] = {}

    def __init__(self, config, device=None, mesh=None):
        self.config = config
        self.model_args = config.model_args
        self.scheduler_args = config.scheduler_args
        self.training_args = config.training_args
        self.device = resolve_device(device)
        #: the ``DeviceMesh`` of a multi-process run (``parallel/mesh.py``), else None
        self.mesh = mesh
        #: the fsdp sharding of the trainable tree (:meth:`place_on_mesh`); None: every leaf whole
        self.fsdp_plan = None
        self.master_dtype = getattr(torch, self.model_args.master_dtype)
        self.inference_dtype = getattr(torch, self.model_args.inference_dtype)
        self._mode = "train"
        #: the model's ``nn.Module`` components, e.g. {'transformer': SD3Transformer}
        self.modules: Dict[str, torch.nn.Module] = {}
        #: configs per component
        self.component_configs: Dict[str, Any] = {}
        #: components whose module parameters were released (:meth:`_release_module_copy`)
        self._released: set = set()
        self.load_models()
        # before the LoRA, the reference and snapshot stores, the EMA and a
        # resume read the weights
        self.import_pretrained_weights()
        self.scheduler = self.load_scheduler()
        self._setup_trainable()
        if self.mesh is not None:
            self.place_on_mesh()
        self.ema: Optional[EMA] = None
        self._ref_store: Optional[EMA] = None
        #: the named parameter snapshots (DGPO's ``ema_ref``, CRD's old and
        #: sampling policies); no checkpoint holds them
        self._named_stores: Dict[str, EMA] = {}
        #: what a ``train_state`` load read besides the weights: the
        #: optimizer state, epoch and global step (the trainer takes them),
        #: and the EMA state until :meth:`init_ema` builds the EMA
        self._restored_state: Dict[str, Any] = {}
        self._restored_ema: Optional[dict] = None
        if self.model_args.resume_path:
            self.load_checkpoint(self.model_args.resume_path, self.model_args.resume_type)

    # ------------------------------------------------------------------
    # Model surface
    # ------------------------------------------------------------------
    @abstractmethod
    def load_models(self) -> None:
        """Populate ``self.modules`` / ``self.component_configs``."""

    @abstractmethod
    def _velocity(self, latents, t, embeds, guidance_scale, do_cfg, params=None) -> torch.Tensor:
        """Velocity prediction (fp32) for latents (B, ...) at timesteps t (B,),
        on the effective weights ``params`` (:meth:`merged_params`) when given."""

    def token_mask(self, embeds: Dict[str, torch.Tensor]) -> Optional[torch.Tensor]:
        """The :func:`sde_step` token mask of a batch (1 = generated, 0 =
        conditioned and frozen); None when every token steps."""
        return None

    def scheduler_defaults(self) -> Dict[str, Any]:
        """Per-model sigma-schedule knobs (shift, dynamic shifting...)."""
        return {}

    def weight_maps(self) -> Dict[str, Tuple[ModuleMap, RawMap]]:
        """The weight bridge's maps from the JAX package's parameter paths to
        this adapter's, per component (families override)."""
        raise NotImplementedError(f"{type(self).__name__} has no weight bridge to the JAX package's names")

    def pretrained_component_maps(self) -> Dict[str, ComponentImport]:
        """How each component imports from a local diffusers-layout
        checkpoint (:meth:`import_pretrained_weights`; families override)."""
        return {}

    def import_pretrained_weights(self) -> None:
        """Copy ``<model_name_or_path>/<subfolder>/*.safetensors`` into each
        built component that has a map (JAX ``models/abc.py:312-341``): a
        component whose subfolder is absent or holds no safetensors keeps its
        init; ``strict_import`` raises on any tensor left at init or key left
        unread. Without a preprocess the files are read one at a time."""
        path = self.model_args.model_name_or_path
        if not path or not os.path.isdir(path):
            return
        strict = bool(getattr(self.model_args, "strict_import", False))
        for comp, spec in self.pretrained_component_maps().items():
            d = os.path.join(path, spec.subfolder)
            files = safetensors_files(d) if comp in self.modules and os.path.isdir(d) else []
            if not files:
                continue
            sd = (spec.preprocess(load_safetensors_dir(d)) if spec.preprocess is not None
                  else (load_file(f) for f in files))
            report = import_state_dict(self.modules[comp], sd, spec.renames, strict=strict, component=comp,
                                       unmatched_scope=spec.scope)
            logger.info("Imported pretrained %s weights from %s (%s)", comp, d, report.summary())

    def load_scheduler(self) -> FlowMatchEulerSDE:
        """The scheduler class of ``scheduler_type`` or the adapter's
        ``default_scheduler``; the UniPC eval knobs ride as attributes."""
        sa = self.scheduler_args
        cls = get_scheduler_class(sa.scheduler_type or self.default_scheduler)
        sched = cls(
            noise_level=sa.noise_level,
            sde_steps=sa.sde_steps,
            num_sde_steps=sa.num_sde_steps,
            seed=sa.seed,
            dynamics_type=sa.dynamics_type,
            **self.scheduler_defaults(),
        )
        sched.solver_order = int(getattr(sa, "solver_order", 2))
        sched.lower_order_final = bool(getattr(sa, "lower_order_final", True))
        return sched

    def load_state_dicts(self, state_dicts: Dict[str, Dict[str, torch.Tensor]]) -> None:
        """Load per-component state dicts (e.g. from :mod:`..utils.weights`),
        strictly; a component whose module copy was released for full
        finetuning takes its parameters into the master tree."""
        for comp, sd in state_dicts.items():
            if comp in self._released:
                module = self.modules[comp]
                names = {name for name, _ in module.named_parameters()}
                missing = sorted(names - set(sd))
                if missing:
                    raise KeyError(f"{comp}: the state dict misses parameters {missing[:5]}")
                self.trainable[comp] = self._place_component(comp, {
                    name: sd[name].to(device=self.device, dtype=self.master_dtype).detach().clone().requires_grad_()
                    for name, _ in module.named_parameters()})
                module.load_state_dict({k: v for k, v in sd.items() if k not in names}, strict=False)
            else:
                load_component(self.modules[comp], sd)

    def preprocess_func(self, batch: Dict[str, Any], **kwargs) -> Dict[str, Any]:
        """Stage-1 preprocessing: prompt encoding (families override)."""
        out: Dict[str, Any] = {}
        if "prompt" in batch:
            out.update(self.encode_prompt(batch["prompt"], **kwargs))
        return out

    # ------------------------------------------------------------------
    # Trainable parameters: LoRA or full
    # ------------------------------------------------------------------
    @property
    def trainable_components(self) -> Tuple[str, ...]:
        tm = self.model_args.target_modules
        if isinstance(tm, str) and tm not in ("default", "all"):
            return (tm.split(".")[0],)
        if isinstance(tm, (list, tuple)):
            comps = []
            for t in tm:
                comp = t.split(".")[0]
                if comp in self.modules and comp not in comps:
                    comps.append(comp)
            if comps:
                return tuple(comps)
        return self.default_trainable_components

    @property
    def is_lora(self) -> bool:
        return self.model_args.finetune_type == "lora"

    @property
    def lora_scale(self) -> float:
        return self.model_args.lora_alpha / max(1, self.model_args.lora_rank)

    def _lora_patterns(self) -> Tuple[str, ...]:
        tm = self.model_args.target_modules
        if isinstance(tm, (list, tuple)):
            return tuple(rf".*\.{re.escape(t.split('.')[-1])}\.weight$" for t in tm)
        return self.default_target_patterns

    def _setup_trainable(self) -> None:
        """LoRA trees (``lora_A`` drawn from a generator seeded by (seed,
        component)) or full master-dtype copies, for every trainable
        component that was loaded."""
        seed = self.training_args.seed
        trainable: Trainable = {}
        for comp in self.trainable_components:
            if comp not in self.modules:
                continue
            module = self.modules[comp]
            if self.is_lora:
                trainable[comp] = init_lora(module, self.model_args.lora_rank,
                                            make_generator(self.device, "lora_init", seed, comp),
                                            self._lora_patterns(), dtype=self.master_dtype)
                logger.info("LoRA[%s]: %d params (rank %d)", comp, lora_param_count(trainable[comp]),
                            self.model_args.lora_rank)
            else:
                trainable[comp] = {name: p.detach().to(self.master_dtype).clone().requires_grad_()
                                   for name, p in module.named_parameters()}
        self.trainable: Trainable = trainable
        if not self.is_lora and self.velocity_component in trainable:
            self._release_module_copy(self.velocity_component)

    def _release_module_copy(self, component: str) -> None:
        """Full finetuning: the fp32 master tree becomes the component's only
        copy on the device. Every forward of the velocity component runs on
        :meth:`merged_params` through ``functional_call``, which never reads
        the module's own parameters then, so they are replaced by meta
        tensors of their shapes and dtypes (the buffers stay)."""
        module = self.modules[component]
        with torch.no_grad():
            for sub in module.modules():
                for name, p in list(sub._parameters.items()):
                    if p is not None:
                        sub._parameters[name] = torch.nn.Parameter(p.to("meta"), requires_grad=False)
        self._released.add(component)
        logger.info("Released the module copy of %s: its fp32 master tree is its only copy", component)

    # ------------------------------------------------------------------
    # Component device management (JAX models/abc.py:1200-1212)
    # ------------------------------------------------------------------
    def offload_component(self, name: str) -> None:
        """Move a frozen component's weights to host RAM (frees device memory)."""
        if name in self._released or name in self.trainable:
            raise ValueError(f"{name} is trained: only a frozen component is offloaded")
        self.modules[name].to("cpu")

    def onload_component(self, name: str) -> None:
        """Move a component's weights back to the adapter's device."""
        self.modules[name].to(self.device)

    def load_lora(self, component: str, tree: Dict[str, Dict[str, torch.Tensor]]) -> None:
        """Replace a component's LoRA tree (e.g. from ``weights.lora_from_flax``),
        strictly: the same paths and shapes as the live tree."""
        live = self.trainable[component]
        if set(tree) != set(live):
            raise KeyError(f"LoRA paths differ: missing {sorted(set(live) - set(tree))[:5]}, "
                           f"unexpected {sorted(set(tree) - set(live))[:5]}")
        for path, ab in tree.items():
            for k, v in ab.items():
                want = self._full_shape(component, f"{path}/{k}", live[path][k])
                if tuple(v.shape) != want:
                    raise ValueError(f"{path}.{k}: shape {tuple(v.shape)} != {want}")
        self.trainable[component] = self._place_component(component, {
            path: {k: v.to(device=self.device, dtype=self.master_dtype).detach().clone().requires_grad_()
                   for k, v in ab.items()} for path, ab in tree.items()})

    # ------------------------------------------------------------------
    # The mesh (JAX models/abc.py:1273-1291)
    # ------------------------------------------------------------------
    def place_on_mesh(self) -> None:
        """The trainable tree on the mesh: with fsdp above 1 each leaf keeps
        this rank's slice by the JAX leaf rule (``parallel/mesh.py``), so the
        optimizer, the EMA, the reference and the named snapshots, all built
        from it, hold slices too; the frozen components stay whole on every
        rank. ``attn_backend: ring`` installs the ring of the ``tensor`` axis
        (JAX :258-261); ``tensor_size`` above 1 under another backend is
        tensor parallelism, which is not ported."""
        from ..ops.attention import set_ring_context
        from ..parallel.mesh import FSDP_AXIS, TENSOR_AXIS, mesh_shape, refuse_tensor_parallelism, shard_params

        shape = mesh_shape(self.mesh)
        refuse_tensor_parallelism(shape[TENSOR_AXIS], self.model_args.attn_backend)
        if self.model_args.attn_backend == "ring":
            set_ring_context(self.mesh.get_group(TENSOR_AXIS), shape[TENSOR_AXIS])
        if shape[FSDP_AXIS] > 1:
            self.trainable, self.fsdp_plan = shard_params(self.trainable, self.mesh)

    def full_component(self, component: str, trainable: Optional[Trainable] = None, differentiable: bool = True):
        """A component's whole trainable tree: under fsdp its slices gathered
        over the fsdp group (differentiable in the slices when grad is on),
        else the tree itself."""
        trainable = self.trainable if trainable is None else trainable
        if self.fsdp_plan is None:
            return trainable[component]
        return self.fsdp_plan.gather(trainable[component], prefix=component, differentiable=differentiable)

    def full_tree(self, trainable: Optional[Trainable] = None) -> Trainable:
        """Every component's whole tree, without gradients (a collective
        under fsdp: every rank calls it)."""
        trainable = self.trainable if trainable is None else trainable
        with torch.no_grad():
            return {comp: self.full_component(comp, trainable, differentiable=False) for comp in trainable}

    def _place_component(self, component: str, tree) -> Dict[str, Any]:
        """A whole component tree as this rank holds it: its slices under
        fsdp, else the tree."""
        return tree if self.fsdp_plan is None else self.fsdp_plan.shard(tree, prefix=component)

    def _full_shape(self, component: str, path: str, leaf: torch.Tensor) -> Tuple[int, ...]:
        """The whole shape of a live leaf at ``<component>/<path>``."""
        return tuple(leaf.shape) if self.fsdp_plan is None else self.fsdp_plan.shapes[f"{component}/{path}"]

    def trainable_leaf_dims(self) -> List[Optional[int]]:
        """The fsdp-sharded dimension of each leaf in :meth:`trainable_leaves`
        order (None: whole on every rank)."""
        if self.fsdp_plan is None:
            return [None] * len(self.trainable_leaves())
        return self.trainable_leaves(self.fsdp_plan.spec_tree(self.trainable))

    def trainable_leaves(self, trainable: Optional[Trainable] = None) -> List[torch.Tensor]:
        """Every tensor of the trainable tree, in a fixed order."""
        trainable = self.trainable if trainable is None else trainable
        return [v for comp in sorted(trainable) for name in sorted(trainable[comp])
                for v in _leaves(trainable[comp][name])]

    def merged_params(self, component: str, trainable: Optional[Trainable] = None) -> Params:
        """Effective weights the velocity of ``component`` runs on (families
        with several trained components per velocity override: Wan2.2's MoE
        gives both experts); by default :meth:`merge_component`."""
        return self.merge_component(component, trainable)

    def step_params(self, params, t_host: Optional[float]):
        """The effective weights of one step at the host timestep ``t_host``
        (None where the caller has no single one): ``params`` by default;
        Wan2.2's MoE picks its expert here, with no device read."""
        return params

    def merge_component(self, component: str, trainable: Optional[Trainable] = None) -> Dict[str, torch.Tensor]:
        """Effective weights of ``component`` for ``functional_call`` (empty when
        it is not trained): LoRA merged into the frozen weights, or the full
        trainable weights. Differentiable in ``trainable`` when grad is on."""
        trainable = self.trainable if trainable is None else trainable
        if component not in trainable:
            return {}
        tree = self.full_component(component, trainable)  # under fsdp: the slices gathered
        if self.is_lora:
            return merge_lora(self.modules[component], tree, self.lora_scale)
        return dict(tree)

    # ------------------------------------------------------------------
    # EMA and the reference policy
    # ------------------------------------------------------------------
    def init_ema(self) -> None:
        ta = self.training_args
        if getattr(ta, "ema_decay", 0.0) and ta.ema_decay > 0:
            schedule = getattr(ta, "ema_decay_schedule", "constant")
            decay_fn = constant_decay(ta.ema_decay) if schedule == "constant" else get_decay_schedule(schedule)
            self.ema = EMA(self.trainable, decay_fn=decay_fn,
                           update_interval=max(1, getattr(ta, "ema_update_interval", 1)))
            logger.info("EMA enabled: decay=%s interval=%s", ta.ema_decay, ta.ema_update_interval)
            if self._restored_ema is not None:  # a train_state read at construction, before the EMA existed
                self.ema.load_state_dict(self._restored_ema)
                self._restored_ema = None

    def ema_step(self, step: Optional[int] = None) -> None:
        if self.ema is not None:
            self.ema.update(self.trainable, step=step)

    @property
    def ema_trainable(self) -> Trainable:
        """EMA weights if enabled, else the live trainable tree."""
        return self.trainable if self.ema is None else self.ema.params

    def init_ref_parameters(self) -> None:
        if self.is_lora:
            return  # the zero LoRA needs no storage
        self._ref_store = EMA(self.trainable, update_interval=0)

    def ref_trainable(self) -> Trainable:
        """Trainable tree of the frozen reference policy."""
        if self.is_lora:
            return {c: zero_like_lora(t) for c, t in self.trainable.items()}
        if self._ref_store is None:
            raise RuntimeError("init_ref_parameters() was not called for full finetuning")
        return self._ref_store.params

    # ------------------------------------------------------------------
    # Named parameter snapshots (DGPO, CRD; JAX models/abc.py:636-669): a
    # detached fp32 copy of the trainable tree each, moved only by hand. No
    # checkpoint holds them: a resumed run rebuilds them from the restored
    # tree when the trainer registers them, as the JAX package does.
    # ------------------------------------------------------------------
    def add_named_parameters(self, name: str, decay: float = 0.0, update_interval: int = 0) -> None:
        self._named_stores[name] = EMA(self.trainable, decay_fn=constant_decay(decay),
                                       update_interval=update_interval)

    def get_named_parameters(self, name: str) -> Trainable:
        return self._named_stores[name].params

    def update_named_parameters(self, name: str, blend: Optional[float] = None, step: Optional[int] = None) -> None:
        """Blend the snapshot toward the live tree, s ← s·b + θ·(1−b); without
        ``blend`` an EMA update at ``step`` with the store's own decay."""
        store = self._named_stores[name]
        if blend is None:
            store.update(self.trainable, step=step)
        else:
            store.blend(self.trainable, blend)

    def set_named_parameters(self, name: str) -> None:
        self._named_stores[name].copy_from(self.trainable)

    def remove_named_parameters(self, name: str) -> None:
        self._named_stores.pop(name, None)

    def has_named_parameters(self, name: str) -> bool:
        return name in self._named_stores

    def post_init(self) -> None:
        """EMA and reference init once the trainer is wired."""
        self.init_ema()
        if self.training_args.requires_ref_model:
            self.init_ref_parameters()

    # ------------------------------------------------------------------
    # Checkpointing (JAX models/abc.py:671-905)
    # ------------------------------------------------------------------
    #: size cap of a full-checkpoint shard file
    MAX_SHARD_BYTES = int(os.environ.get("FFT_MAX_SHARD_BYTES", 4 * 1024**3))
    #: the one file of ``train_state/``
    TRAIN_STATE_FILE = "state.pt"

    def save_checkpoint(self, save_dir: str, model_only: bool = True, save_ema: bool = True,
                        extra_state: Optional[Dict[str, Any]] = None) -> None:
        """The weights — the EMA's when EMA is on and ``save_ema`` — as LoRA
        or full files, and unless ``model_only`` the training state with
        ``extra_state`` (the trainer's optimizer state, epoch, global step).
        Every process calls it: under fsdp the slices are gathered
        collectively, and rank 0 alone writes."""
        os.makedirs(save_dir, exist_ok=True)
        trainable = self.full_tree(self.ema_trainable if (save_ema and self.ema is not None) else self.trainable)
        if self.is_lora:
            self._save_lora(save_dir, trainable)
        else:
            self._save_full(save_dir, trainable)
        if not model_only:
            self._save_state(save_dir, extra_state or {})

    @staticmethod
    def _is_write_process() -> bool:
        """One process, rank 0, writes checkpoint files."""
        return get_rank() == 0

    @staticmethod
    def _sync_processes(tag: str) -> None:
        """Wait until the writer has flushed a save (a no-op for one process)."""
        barrier(tag)

    def _save_lora(self, save_dir: str, trainable: Trainable) -> None:
        write = self._is_write_process()
        for comp, tree in trainable.items():
            if write:
                save_file({f"{path}.{k}.weight": v for path, ab in tree.items() for k, v in ab.items()},
                          os.path.join(save_dir, f"lora_{comp}.safetensors"))
        if write:
            with open(os.path.join(save_dir, "adapter_config.json"), "w") as f:
                json.dump({"finetune_type": "lora", "lora_rank": self.model_args.lora_rank,
                           "lora_alpha": self.model_args.lora_alpha, "components": list(trainable),
                           "model_type": self.model_args.model_type}, f, indent=2)
        self._sync_processes(f"save_lora:{save_dir}")

    def _save_full(self, save_dir: str, trainable: Trainable) -> None:
        """Each component's weights in shards of at most ``MAX_SHARD_BYTES``
        (greedy, in the tree's order; a larger tensor alone in its shard),
        indexed by ``model_index.json``."""
        write = self._is_write_process()
        index: Dict[str, Any] = {"weight_map": {}, "components": list(trainable)}
        for comp, tensors in trainable.items():
            shards: List[Dict[str, torch.Tensor]] = [{}]
            nbytes = 0
            for name, t in tensors.items():
                size = t.numel() * t.element_size()
                if nbytes and nbytes + size > self.MAX_SHARD_BYTES:
                    shards.append({})
                    nbytes = 0
                shards[-1][name] = t
                nbytes += size
            n = len(shards)
            for i, shard in enumerate(shards, start=1):
                fname = f"{comp}.safetensors" if n == 1 else f"{comp}-{i:05d}-of-{n:05d}.safetensors"
                if write:
                    save_file(shard, os.path.join(save_dir, fname))
                for name in shard:
                    index["weight_map"][f"{comp}/{name}"] = fname
        if write:
            with open(os.path.join(save_dir, "model_index.json"), "w") as f:
                json.dump(index, f, indent=2)
        self._sync_processes(f"save_full:{save_dir}")

    def export_merged(self, save_dir: str, save_ema: bool = True) -> None:
        """Deployment export: the LoRA merged into the frozen weights, saved in
        the full layout (loadable by a full finetune's ``resume_type:
        full``); for full finetuning a plain full save."""
        os.makedirs(save_dir, exist_ok=True)
        trainable = self.ema_trainable if (save_ema and self.ema is not None) else self.trainable
        if not self.is_lora:
            trainable = self.full_tree(trainable)
        else:
            with torch.no_grad():
                trainable = {comp: {**dict(self.modules[comp].named_parameters()),
                                    **self.merge_component(comp, trainable)} for comp in trainable}
        self._save_full(save_dir, trainable)
        logger.info("Exported merged weights to %s", save_dir)

    def _save_state(self, save_dir: str, extra_state: Dict[str, Any]) -> None:
        state: Dict[str, Any] = {"trainable": self.full_tree()}
        if self.ema is not None:
            state["ema"] = {"step": self.ema.step, "params": self.full_tree(self.ema.params)}
        state.update(extra_state)
        path = os.path.join(save_dir, "train_state")
        os.makedirs(path, exist_ok=True)
        if self._is_write_process():
            torch.save(state, os.path.join(path, self.TRAIN_STATE_FILE))
        self._sync_processes(f"save_state:{save_dir}")

    def load_checkpoint(self, path: str, resume_type: Optional[str] = None) -> None:
        """Load a checkpoint, its kind found from the directory's contents
        unless ``resume_type`` names it: ``train_state/`` (weights, EMA,
        optimizer, epoch) wins over ``adapter_config.json`` (LoRA), which wins
        over full weights."""
        if resume_type is None:
            if os.path.exists(os.path.join(path, "train_state")):
                resume_type = "state"
            elif os.path.exists(os.path.join(path, "adapter_config.json")):
                resume_type = "lora"
            else:
                resume_type = "full"
        if resume_type == "lora":
            self._load_lora(path)
        elif resume_type == "full":
            self._load_full(path)
        elif resume_type == "state":
            self._load_state(path)
        else:
            raise ValueError(f"Unknown resume_type {resume_type!r}")

    def _lora_tree(self, component: str, tensors: Dict[str, torch.Tensor]) -> Dict[str, Dict[str, torch.Tensor]]:
        """A LoRA file's tensors as the port's tree: the port's names
        (``<path>.lora_A.weight``), or the JAX package's (``<flax
        path>/kernel/a``, ``.../b``) mapped through the weight bridge."""
        tree: Dict[str, Dict[str, Any]] = {}
        if tensors and all(k.endswith(("/a", "/b")) for k in tensors):
            for key, t in tensors.items():
                path, leaf = key.rsplit("/", 1)
                tree.setdefault(path, {})[leaf] = t.float().numpy()
            return lora_from_flax(tree, self.weight_maps()[component][0])
        for key, t in tensors.items():
            path, leaf, _ = key.rsplit(".", 2)
            tree.setdefault(path, {})[leaf] = t
        return tree

    def _load_lora(self, path: str) -> None:
        for comp in list(self.trainable):
            f = os.path.join(path, f"lora_{comp}.safetensors")
            if not os.path.exists(f):
                logger.warning("LoRA checkpoint has no file for component %s", comp)
                continue
            self.load_lora(comp, self._lora_tree(comp, load_file(f)))
        logger.info("Loaded LoRA checkpoint from %s", path)

    def _load_full(self, path: str) -> None:
        index_path = os.path.join(path, "model_index.json")
        weight_map: Dict[str, str] = {}
        if os.path.exists(index_path):
            with open(index_path) as f:
                weight_map = json.load(f).get("weight_map", {})
        for comp in list(self.trainable):
            files = sorted({v for k, v in weight_map.items() if k.startswith(f"{comp}/")}) or [f"{comp}.safetensors"]
            tensors: Dict[str, torch.Tensor] = {}
            for fname in files:
                f = os.path.join(path, fname)
                if not os.path.exists(f):
                    logger.warning("Full checkpoint missing %s for component %s", fname, comp)
                    tensors = {}
                    break
                tensors.update(load_file(f))
            if not tensors:
                continue
            live = self.trainable[comp]
            for name, leaf in live.items():
                if name not in tensors:
                    raise KeyError(f"Checkpoint missing tensor {comp}/{name!r}")
                want = self._full_shape(comp, name, leaf)
                if tuple(tensors[name].shape) != want:
                    raise ValueError(f"Shape mismatch for {comp}/{name}: ckpt {tuple(tensors[name].shape)} "
                                     f"vs model {want}")
            self.trainable[comp] = self._place_component(comp, {
                name: tensors[name].to(device=leaf.device, dtype=leaf.dtype).requires_grad_(leaf.requires_grad)
                for name, leaf in live.items()})
        logger.info("Loaded full checkpoint from %s", path)

    def _load_state(self, path: str) -> None:
        state = torch.load(os.path.join(path, "train_state", self.TRAIN_STATE_FILE), map_location="cpu",
                           weights_only=True)
        self.trainable = {comp: self._place_component(comp, tree_map(
            lambda t: t.detach().to(self.device).requires_grad_(), tree)) for comp, tree in state["trainable"].items()}
        if "ema" in state and self.fsdp_plan is not None:
            state["ema"] = {"step": state["ema"]["step"], "params": {
                comp: self._place_component(comp, tree) for comp, tree in state["ema"]["params"].items()}}
        if "ema" in state:
            if self.ema is not None:
                self.ema.load_state_dict(state["ema"])
            else:
                self._restored_ema = state["ema"]
        self._restored_state = {k: v for k, v in state.items() if k not in ("trainable", "ema")}
        logger.info("Loaded training state from %s", path)

    # ------------------------------------------------------------------
    # Mode management
    # ------------------------------------------------------------------
    @property
    def mode(self) -> str:
        return self._mode

    def train(self) -> None:
        self._mode = "train"
        self.scheduler.train()

    def eval(self) -> None:
        self._mode = "eval"
        self.scheduler.eval()

    def rollout(self) -> None:
        self._mode = "rollout"
        self.scheduler.rollout()

    # ------------------------------------------------------------------
    # Rollout + replay
    # ------------------------------------------------------------------
    @property
    def storage_dtype(self) -> torch.dtype:
        return self.training_args.storage_dtype

    def _on_device(self, x) -> torch.Tensor:
        """Host numpy or a tensor → fp32 on the adapter's device."""
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                               dtype=torch.float32).to(self.device)

    def cast_latents(self, latents: torch.Tensor) -> torch.Tensor:
        """Storage-dtype round trip — the train-inference consistency guard."""
        return latents.to(self.storage_dtype).float()

    def initial_latents(self, shape, generator, x0=None) -> Tuple[torch.Tensor, torch.Generator]:
        """A rollout's x0 of ``shape`` (B, ...) — ``x0`` when given, else
        drawn — through the storage-dtype round trip, and the generator of its
        step noise. ``generator`` is one generator (one draw for the batch) or
        one per row (an eval prompt's own, ``generators_for_prompts``): row i
        then comes from generator i and the step noise from the first, as the
        JAX adapters draw x0 from per-row keys and fold the scan's key from
        the first (``wan/t2v.py:413-419``)."""
        rows = generator if isinstance(generator, (list, tuple)) else None
        if rows is not None and len(rows) != shape[0]:
            raise ValueError(f"{len(rows)} generators for a batch of {shape[0]}")
        if x0 is None and rows is None:
            x0 = torch.randn(shape, generator=generator, device=self.device, dtype=torch.float32)
        elif x0 is None:
            x0 = torch.stack([torch.randn(shape[1:], generator=g, device=self.device, dtype=torch.float32)
                              for g in rows])
        return self.cast_latents(self._on_device(x0)), (generator if rows is None else rows[0])

    @torch.no_grad()
    def _rollout_impl(
        self,
        x0: torch.Tensor,
        embeds: Dict[str, torch.Tensor],
        guidance_scale: float,
        sigmas: np.ndarray,
        timesteps: np.ndarray,
        noise_levels: np.ndarray,
        latent_store_slot: np.ndarray,
        logprob_store_slot: np.ndarray,
        generator: Optional[torch.Generator] = None,
        noise: Optional[Sequence[torch.Tensor]] = None,
        params: Optional[Params] = None,
        *,
        do_cfg: bool,
        compute_log_prob: bool,
        dynamics_type: str,
        num_latent_slots: int,
        num_logprob_slots: int,
        store_means: bool = False,
    ):
        """The denoise loop with selective storage into slot-mapped buffers.

        ``noise`` (one tensor per step) replaces the generator's draws — the
        tests feed the noise the JAX package drew. Returns
        (x_final, latent buffer, log-prob buffer, mean buffer or None), the
        garbage slot dropped."""
        B = x0.shape[0]
        st = self.storage_dtype
        sigma_max = float(sigmas[1]) if len(sigmas) > 1 else 0.999
        lat_buf = torch.zeros((num_latent_slots + 1, *x0.shape), dtype=st, device=x0.device)
        lat_buf[int(latent_store_slot[0])] = x0.to(st)
        lp_buf = torch.zeros((num_logprob_slots + 1, B), dtype=torch.float32, device=x0.device)
        mean_buf = torch.zeros_like(lat_buf) if store_means else None

        x = x0
        for i in range(len(timesteps)):
            t = torch.full((B,), float(timesteps[i]), dtype=torch.float32, device=x.device)
            v = self._velocity(x, t, embeds, guidance_scale, do_cfg, self.step_params(params, timesteps[i]))
            out = sde_step(
                v, x, float(sigmas[i]), float(sigmas[i + 1]),
                dynamics_type=dynamics_type,
                noise_level=float(noise_levels[i]),
                generator=generator,
                noise=None if noise is None else noise[i],
                compute_log_prob=compute_log_prob,
                storage_dtype=st,
                sigma_max=sigma_max,
            )
            slot = int(latent_store_slot[i + 1])
            lat_buf[slot] = out.next_latents.to(st)
            if compute_log_prob:
                lp_buf[int(logprob_store_slot[i])] = out.log_prob
            if mean_buf is not None:
                mean_buf[slot] = out.next_latents_mean.to(st)
            x = out.next_latents
        return x, lat_buf[:-1], lp_buf[:-1], (mean_buf[:-1] if store_means else None)

    def rollout_compute(self, *args, **kwargs):
        """The rollout: the SDE step loop, or in eval mode the UniPC
        predictor-corrector when the scheduler provides it (Wan)."""
        if getattr(self.scheduler, "use_unipc_eval", False) and self.scheduler.is_eval:
            return self._unipc_eval_impl(*args, **kwargs)
        return self._rollout_impl(*args, **kwargs)

    @torch.no_grad()
    def _unipc_eval_impl(
        self,
        x0: torch.Tensor,
        embeds: Dict[str, torch.Tensor],
        guidance_scale: float,
        sigmas: np.ndarray,
        timesteps: np.ndarray,
        noise_levels: np.ndarray,
        latent_store_slot: np.ndarray,
        logprob_store_slot: np.ndarray,
        generator: Optional[torch.Generator] = None,
        noise: Optional[Sequence[torch.Tensor]] = None,
        params: Optional[Params] = None,
        *,
        do_cfg: bool,
        compute_log_prob: bool,
        dynamics_type: str,
        num_latent_slots: int,
        num_logprob_slots: int,
        store_means: bool = False,
    ):
        """Eval-mode UniPC(bh2) rollout with :meth:`_rollout_impl`'s signature
        (the noise arguments are unused: it is deterministic); the carry is
        explicit, the orders come from the host schedule, log-probs are
        zeros. Returns (x_final fp32, latent buffer, log-prob buffer, None)."""
        B = x0.shape[0]
        st = self.storage_dtype
        lat_buf = torch.zeros((num_latent_slots + 1, *x0.shape), dtype=st, device=x0.device)
        lat_buf[int(latent_store_slot[0])] = x0.to(st)
        lp_buf = torch.zeros((num_logprob_slots + 1, B), dtype=torch.float32, device=x0.device)
        pred_orders, corr_orders = compute_unipc_orders(
            len(timesteps), self.scheduler.solver_order, self.scheduler.lower_order_final)
        carry = init_unipc_carry(x0)
        for i in range(len(timesteps)):
            t = torch.full((B,), float(timesteps[i]), dtype=torch.float32, device=x0.device)
            v = self._velocity(carry.x, t, embeds, guidance_scale, do_cfg, self.step_params(params, timesteps[i]))
            carry, x_next = unipc_eval_step(carry, v, float(sigmas[i]), float(sigmas[i + 1]),
                                            int(pred_orders[i]), int(corr_orders[i]))
            lat_buf[int(latent_store_slot[i + 1])] = x_next.to(st)
        return carry.x, lat_buf[:-1], lp_buf[:-1], None

    @torch.no_grad()
    def _forward_impl(
        self,
        latents: torch.Tensor,
        next_latents: Optional[torch.Tensor],
        timestep: torch.Tensor,
        sigma,
        sigma_next,
        noise_level,
        embeds: Dict[str, torch.Tensor],
        guidance_scale: float,
        sigma_max,
        generator: Optional[torch.Generator] = None,
        params: Optional[Params] = None,
        *,
        do_cfg: bool,
        compute_log_prob: bool,
        dynamics_type: str,
    ):
        """Single-step replay (or sample) forward — the rollout's math path.
        ``embeds`` carries the transition's :attr:`trajectory_batch_keys`
        streams too."""
        v = self._velocity(latents, timestep, embeds, guidance_scale, do_cfg, params)
        return sde_step(
            v, latents, sigma, sigma_next,
            dynamics_type=dynamics_type,
            noise_level=noise_level,
            generator=generator,
            next_latents=next_latents,
            compute_log_prob=compute_log_prob,
            storage_dtype=self.storage_dtype,
            sigma_max=sigma_max,
            token_mask=self.token_mask(embeds),
        )

    def replay_log_probs(self, samples: List[BaseSample], steps: Optional[Sequence[int]] = None
                         ) -> Dict[int, torch.Tensor]:
        """Replay stored transitions of a rollout batch without gradients.

        Every sample must come from one rollout (shared schedule and index
        maps); the batch is replayed whole, step by step, as it was rolled
        out. ``steps`` defaults to every step with a stored log-prob and
        both latents. Returns {step: (B,) new log-probs}."""
        first = samples[0]
        lat_map, lp_map = first.latent_index_map, first.log_prob_index_map
        if steps is None:
            steps = [i for i in range(len(first.timesteps))
                     if lp_map[i] >= 0 and lat_map[i] >= 0 and lat_map[i + 1] >= 0]
        dev = self.device
        embeds = {}
        for key in self.embed_keys:  # a sample field, or an extra_kwargs entry
            values = [getattr(s, key, None) for s in samples]
            if all(v is not None for v in values):
                embeds[key] = torch.from_numpy(np.stack(values)).to(dev)
        do_cfg = "negative_prompt_embeds" in embeds
        sigmas = first.extra_kwargs["sigmas"]
        noise_levels = first.extra_kwargs["noise_levels"]
        latents = torch.from_numpy(np.stack([s.all_latents for s in samples])).to(dev)
        streams = {bk: torch.from_numpy(np.stack([s.extra_kwargs[sk] for s in samples])).to(dev)
                   for bk, sk in self.trajectory_batch_keys.items()}
        B = len(samples)
        full = lambda value: torch.full((B,), float(value), dtype=torch.float32, device=dev)
        with torch.no_grad():
            params = self.merged_params(self.velocity_component)
        out: Dict[int, torch.Tensor] = {}
        for i in steps:
            # contiguous like the rollout's own tensors: equal layouts keep
            # every reduction in the same order, hence the same bits
            res = self._forward_impl(
                latents[:, lat_map[i]].contiguous(), latents[:, lat_map[i + 1]].contiguous(),
                full(first.timesteps[i]),
                full(sigmas[i]), full(sigmas[i + 1]), full(noise_levels[i]),
                {**embeds, **{bk: t[:, lat_map[i]].contiguous() for bk, t in streams.items()}},
                float(first.extra_kwargs["guidance_scale"]),
                full(sigmas[1] if len(sigmas) > 1 else 0.999), params=self.step_params(params, first.timesteps[i]),
                do_cfg=do_cfg, compute_log_prob=True,
                dynamics_type=self.scheduler.dynamics_type,
            )
            out[int(i)] = res.log_prob
        return out

    @property
    def decoupled_latent_keys(self) -> Dict[str, str]:
        """Latent streams the decoupled trainers train on: {batch key:
        sample key} (JAX ``models/abc.py:356``); one image or video stream
        here."""
        return {"latents": "all_latents"}

    def training_velocity(self, trainable: Optional[Trainable], batch: Dict[str, Any],
                          params: Optional[Params] = None) -> torch.Tensor:
        """Velocity at arbitrary (latents, timestep), the decoupled trainers'
        forward (JAX ``models/abc.py:1152``), differentiable in ``trainable``
        when grad is on. ``params`` are effective weights the caller merged
        already (:meth:`merged_params`; one merge serves several forwards of
        a step); the merge of the empty tree runs the frozen weights, which
        the zero LoRA of the reference policy merges into bit for bit. ``batch["timestep_host"]``,
        where the caller has one, is the step's timestep as a host float."""
        embeds = {k: batch[k] for k in self.embed_keys if k in batch}
        do_cfg = "negative_prompt_embeds" in embeds and bool(batch.get("do_cfg", True))
        if params is None:
            params = self.merged_params(self.velocity_component, trainable)
        return self._velocity(batch["latents"], batch["timestep"], embeds,
                              float(batch.get("guidance_scale", self.training_args.guidance_scale)),
                              do_cfg, self.step_params(params, batch.get("timestep_host")))

    def training_velocity_tree(self, trainable: Optional[Trainable], batch: Dict[str, Any],
                               params: Optional[Params] = None) -> Dict[str, torch.Tensor]:
        """Velocity for every stream of :attr:`decoupled_latent_keys`, keyed
        like the batch's streams (JAX ``training_velocity_tree``)."""
        return {"latents": self.training_velocity(trainable, batch, params)}

    def training_forward(
        self,
        trainable: Trainable,
        batch: Dict[str, Any],
        *,
        compute_log_prob: bool = True,
        generator: Optional[torch.Generator] = None,
        dynamics_type: Optional[str] = None,
    ):
        """Replay (or re-sample) one stored transition, differentiable in
        ``trainable``: the LoRA is merged with gradients, then the velocity
        and :func:`sde_step` run exactly as in the rollout. ``batch`` holds
        device tensors (``latents``, ``next_latents``, ``timestep``, ``sigma``,
        ``sigma_next``, ``noise_level``, ``sigma_max``: (B,) fp32, embeds) and
        the float ``guidance_scale``, the step's host timestep
        ``timestep_host`` where the trainer has it, and the transition's
        :attr:`trajectory_batch_keys` streams, which the velocity reads."""
        embeds = {k: batch[k] for k in (*self.embed_keys, *self.trajectory_batch_keys) if k in batch}
        do_cfg = "negative_prompt_embeds" in embeds and bool(batch.get("do_cfg", True))
        params = self.merged_params(self.velocity_component, trainable)
        v = self._velocity(batch["latents"], batch["timestep"], embeds,
                           float(batch.get("guidance_scale", self.training_args.guidance_scale)),
                           do_cfg, self.step_params(params, batch.get("timestep_host")))
        return sde_step(
            v, batch["latents"], batch["sigma"], batch["sigma_next"],
            dynamics_type=dynamics_type or self.scheduler.dynamics_type,
            noise_level=batch.get("noise_level", 0.0),
            generator=generator,
            next_latents=batch.get("next_latents"),
            compute_log_prob=compute_log_prob,
            storage_dtype=self.storage_dtype,
            sigma_max=batch.get("sigma_max", 0.999),
            token_mask=self.token_mask(embeds),
        )


def _leaves(node) -> List[torch.Tensor]:
    return [node[k] for k in sorted(node)] if isinstance(node, dict) else [node]
