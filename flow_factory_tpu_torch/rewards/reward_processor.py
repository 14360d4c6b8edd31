"""Reward scoring: batching, group handling, async buffering (port of
``flow_factory_tpu/rewards/reward_processor.py``).

Samples handed to rewards are host-resident numpy (the rollout copies its
results to the host once), so asynchrony is plain ``ThreadPoolExecutor``
futures: a reward that scores on the card (:mod:`.clip_native`) launches from
its worker thread onto the same device. Group handling follows the sampler
contracts: ``group_contiguous`` groups are local to the process; under
``distributed_k_repeat`` the groups span processes, and a groupwise model
scores them after one host gather of the samples' fields (the local path
at one process).
"""
from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..parallel.dist import get_data_rank, get_world_size, host_allgather_objects
from ..samples import BaseSample
from .abc import BaseRewardModel, GroupwiseRewardModel, PointwiseRewardModel


class RewardProcessor:
    """Synchronous scoring of a list of reward models over samples."""

    def __init__(self, reward_models: Sequence[BaseRewardModel],
                 reward_weights: Optional[Dict[str, float]] = None):
        self.reward_models = list(reward_models)
        self.reward_weights = reward_weights or {}
        self._setup_done = False
        self._setup_lock = threading.Lock()

    def _ensure_setup(self) -> None:
        with self._setup_lock:  # the async workers and the caller may get here together
            if not self._setup_done:
                for m in self.reward_models:
                    m.setup()
                self._setup_done = True

    # -- pointwise -------------------------------------------------------------
    def _score_pointwise(self, model: PointwiseRewardModel, samples: List[BaseSample]) -> np.ndarray:
        self._ensure_setup()
        scores = np.zeros(len(samples), np.float64)
        for start in range(0, len(samples), model.batch_size):
            chunk = samples[start : start + model.batch_size]
            fields = model.extract_fields(chunk)
            out = np.asarray(model.compute_reward(**fields), np.float64).reshape(-1)
            scores[start : start + len(chunk)] = out
        return scores

    # -- groupwise -------------------------------------------------------------
    @staticmethod
    def _group_by_uid(samples: Sequence[BaseSample]) -> Dict[str, List[int]]:
        groups: Dict[str, List[int]] = {}
        for i, s in enumerate(samples):
            groups.setdefault(s.unique_id, []).append(i)
        return groups

    def _score_one_group(self, model: GroupwiseRewardModel, group: List[BaseSample]) -> np.ndarray:
        self._ensure_setup()
        fields = model.extract_fields(group)
        return np.asarray(model.compute_group_reward(**fields), np.float64).reshape(-1)

    def _score_groupwise_local(self, model: GroupwiseRewardModel, samples: List[BaseSample],
                               group_size: int) -> np.ndarray:
        """Every group of the process scored as one call; a group of another
        size than ``group_size`` raises."""
        groups = self._group_by_uid(samples)
        bad = {u: len(ix) for u, ix in groups.items() if len(ix) != group_size}
        if bad:
            raise ValueError(f"groupwise reward {model.name!r} needs complete local groups of {group_size}; "
                             f"got {bad}")
        scores = np.zeros(len(samples), np.float64)
        for idxs in groups.values():
            scores[np.asarray(idxs)] = self._score_one_group(model, [samples[i] for i in idxs])
        return scores

    # -- wire encoding for the distributed groupwise gather (JAX :83-119) -----
    # float media in [0, 1] rides the wire as uint8 (the 8-bit pixels a
    # PNG-fed judge would see), repeated media blobs dedup by content hash
    # into a per-rank blob table, and only ``model.required_fields`` go.
    @staticmethod
    def _encode_field(v, blobs: Dict[str, np.ndarray]):
        import hashlib

        if isinstance(v, (list, tuple)):
            return [RewardProcessor._encode_field(x, blobs) for x in v]
        if isinstance(v, np.ndarray) and v.ndim >= 3 and v.dtype in (np.float32, np.float64, np.float16):
            packed = (np.clip(v, 0.0, 1.0) * 255.0).round().astype(np.uint8)
            h = hashlib.sha1(packed.tobytes()).hexdigest()[:16]
            blobs.setdefault(h, packed)
            return {"__blob__": h}
        return v

    @staticmethod
    def _decode_field(v, blobs: Dict[str, np.ndarray]):
        if isinstance(v, list):
            return [RewardProcessor._decode_field(x, blobs) for x in v]
        if isinstance(v, dict) and "__blob__" in v:
            return blobs[v["__blob__"]].astype(np.float32) / 255.0
        return v

    def _score_groupwise_distributed(self, model: GroupwiseRewardModel, samples: List[BaseSample],
                                     group_size: int) -> np.ndarray:
        """Groups spread over processes (``distributed_k_repeat``; JAX
        :121-181): one host gather of every sample's encoded fields, each
        complete group scored by the rank its sorted position strides to,
        then one gather of the scores back to their owners. One process
        takes the local path."""
        self._ensure_setup()
        world, rank = get_world_size(), get_data_rank()
        if world <= 1:
            return self._score_groupwise_local(model, samples, group_size)
        blobs: Dict[str, np.ndarray] = {}
        local_payload = []
        for i, s in enumerate(samples):
            fields = model.extract_fields([s])
            enc = {k: self._encode_field(v[0], blobs) for k, v in fields.items()}
            local_payload.append({"uid": s.unique_id, "fields": enc, "origin": (rank, i)})
        all_payloads = host_allgather_objects([{"samples": local_payload, "blobs": blobs}])
        merged_blobs: Dict[str, np.ndarray] = {}
        flat: List[dict] = []
        for rank_list in all_payloads:
            for payload in rank_list:
                merged_blobs.update(payload["blobs"])
                flat.extend(payload["samples"])
        groups: Dict[str, List[dict]] = {}
        for p in flat:
            groups.setdefault(p["uid"], []).append(p)
        my_scores: Dict[Tuple[int, int], float] = {}
        for gi, uid in enumerate(sorted(groups)):
            if gi % world != rank:
                continue
            members = groups[uid]
            fields = {k: [self._decode_field(m["fields"][k], merged_blobs) for m in members]
                      for k in members[0]["fields"]}
            out = np.asarray(model.compute_group_reward(**fields), np.float64).reshape(-1)
            for m, sc in zip(members, out):
                my_scores[tuple(m["origin"])] = float(sc)
        scores = np.zeros(len(samples), np.float64)
        for rank_list in host_allgather_objects([my_scores]):
            for d in rank_list:
                for (r, i), sc in d.items():
                    if r == rank:
                        scores[i] = sc
        return scores

    # -- public ----------------------------------------------------------------
    def score(self, samples: List[BaseSample], group_size: int, distributed_groups: bool,
              models: Optional[Sequence[BaseRewardModel]] = None) -> Dict[str, np.ndarray]:
        """{model name: (N,) float64 scores} of every model (or of ``models``)."""
        results: Dict[str, np.ndarray] = {}
        for model in self.reward_models if models is None else models:
            if model.reward_type == "pointwise":  # by type, so reward aliases pass
                results[model.name] = self._score_pointwise(model, samples)
            elif model.reward_type == "groupwise":
                score = self._score_groupwise_distributed if distributed_groups else self._score_groupwise_local
                results[model.name] = score(model, samples, group_size)
            else:
                raise TypeError(f"Unknown reward model type: {type(model)}")
        return results

    def score_and_attach(self, samples: List[BaseSample]) -> Dict[str, np.ndarray]:
        """Score in groups of one sample (the serving slices' pointwise
        rewards), then attach ``extra_kwargs['rewards']`` (per model) and the
        weighted ``extra_kwargs['reward']`` as the trainer's reward buffer does."""
        per_model = self.score(samples, group_size=1, distributed_groups=False)
        attach(samples, per_model, self.reward_weights)
        return per_model


def attach(samples: Sequence[BaseSample], per_model: Dict[str, np.ndarray], weights: Dict[str, float]) -> None:
    """Each sample's ``rewards`` {model: score} and weighted ``reward``."""
    for i, s in enumerate(samples):
        rewards = {name: float(scores[i]) for name, scores in per_model.items()}
        s.extra_kwargs["rewards"] = rewards
        s.extra_kwargs["reward"] = sum(weights.get(k, 1.0) * v for k, v in rewards.items())


class RewardBuffer:
    """Accumulates a rollout's samples; scores the async models as their
    inputs arrive (JAX ``RewardBuffer``, ``reward_processor.py:204``):

    * an async pointwise model gets a task a full ``batch_size`` of pending
      samples, from :meth:`add_samples`; the tail flushes at :meth:`finalize`;
    * an async groupwise model gets a task a completed group (``group_size``
      samples of one ``unique_id``); with ``distributed_groups`` the groups
      span processes, so groupwise models stay synchronous;
    * :meth:`finalize` scores the synchronous models, collects the futures,
      and attaches ``rewards`` / ``reward``. ``split="pointwise"`` (the
      evaluation: one sample a prompt, no complete group) leaves the
      groupwise models out; under ``"all"`` an incomplete group raises.
    """

    def __init__(self, reward_models: Sequence[BaseRewardModel], group_size: int, distributed_groups: bool,
                 reward_weights: Optional[Dict[str, float]] = None):
        self.processor = RewardProcessor(reward_models)
        self.group_size = group_size
        self.distributed_groups = distributed_groups
        self.reward_weights = reward_weights or {m.name: m.weight for m in reward_models}
        is_async = lambda m: bool(getattr(m.args, "async_reward", False))
        self.async_pointwise = [m for m in reward_models if is_async(m) and m.reward_type == "pointwise"]
        self.async_groupwise = [m for m in reward_models
                                if is_async(m) and m.reward_type == "groupwise" and not distributed_groups]
        self.async_models = self.async_pointwise + self.async_groupwise
        self.sync_models = [m for m in reward_models if m not in self.async_models]
        workers = sum(max(1, getattr(m.args, "num_workers", 1)) for m in self.async_models)
        self._pool = ThreadPoolExecutor(max_workers=max(1, workers)) if self.async_models else None
        self._samples: List[BaseSample] = []
        #: (model name, reward type, sample indices, future)
        self._futures: List[Tuple[str, str, List[int], Future]] = []
        self._pointwise_pending: Dict[str, List[int]] = {m.name: [] for m in self.async_pointwise}
        self._groupwise_pending: Dict[str, List[int]] = {}
        self._lock = threading.Lock()

    # -- dispatch ---------------------------------------------------------------
    def _submit_pointwise(self, model: PointwiseRewardModel, indices: List[int]) -> None:
        chunk = [self._samples[i] for i in indices]
        fut = self._pool.submit(self.processor._score_pointwise, model, chunk)
        self._futures.append((model.name, "pointwise", list(indices), fut))

    def _submit_ready_tasks(self) -> None:
        for model in self.async_pointwise:
            bs = max(1, model.batch_size)
            pending = self._pointwise_pending[model.name]
            while len(pending) >= bs:
                batch, pending = pending[:bs], pending[bs:]
                self._pointwise_pending[model.name] = pending
                self._submit_pointwise(model, batch)
        for uid, indices in list(self._groupwise_pending.items()):
            if len(indices) >= self.group_size:
                group = [self._samples[i] for i in indices]
                for model in self.async_groupwise:
                    fut = self._pool.submit(self.processor._score_one_group, model, group)
                    self._futures.append((model.name, "groupwise", list(indices), fut))
                del self._groupwise_pending[uid]

    def add_samples(self, samples: Sequence[BaseSample]) -> None:
        with self._lock:
            lo = len(self._samples)
            self._samples.extend(samples)
            new = list(range(lo, len(self._samples)))
            for model in self.async_pointwise:
                self._pointwise_pending[model.name].extend(new)
            if self.async_groupwise:
                for i, s in zip(new, samples):
                    self._groupwise_pending.setdefault(s.unique_id, []).append(i)
            self._submit_ready_tasks()

    @property
    def samples(self) -> List[BaseSample]:
        return self._samples

    def finalize(self, split: str = "all") -> List[BaseSample]:
        """Score the synchronous models, flush the pointwise tails, collect
        every future of ``split`` (a worker's exception re-raises here) and
        attach ``rewards`` / ``reward`` to the samples."""
        assert split in ("pointwise", "groupwise", "all"), split
        n = len(self._samples)
        take = lambda m: split == "all" or m.reward_type == split
        sync_models = [m for m in self.sync_models if take(m)]
        per_model = {m.name: np.zeros(n, np.float64) for m in sync_models + self.async_models if take(m)}
        per_model.update(self.processor.score(self._samples, self.group_size, self.distributed_groups,
                                              models=sync_models))
        if split in ("pointwise", "all"):  # the pointwise tails (< batch_size) no trigger sent
            for model in self.async_pointwise:
                pending = self._pointwise_pending[model.name]
                if pending:
                    self._pointwise_pending[model.name] = []
                    self._submit_pointwise(model, pending)
        if split == "all" and self._groupwise_pending:
            incomplete = {u: len(ix) for u, ix in self._groupwise_pending.items()}
            raise ValueError(f"incomplete groups at finalize: {incomplete}")
        leftover = []
        for name, rtype, indices, fut in self._futures:
            if split != "all" and rtype != split:
                leftover.append((name, rtype, indices, fut))
                continue
            per_model[name][np.asarray(indices)] = fut.result()
        self._futures = leftover
        attach(self._samples, per_model, self.reward_weights)
        return self._samples

    def clear(self) -> None:
        self._samples = []
        self._futures = []
        self._pointwise_pending = {m.name: [] for m in self.async_pointwise}
        self._groupwise_pending = {}

    def cleanup(self) -> None:
        for _, _, _, fut in self._futures:
            fut.cancel()
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
        for m in self.processor.reward_models:
            m.cleanup()
