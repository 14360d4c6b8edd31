"""Datasets and the fingerprint-cached stage-1 preprocessing.

Port of ``flow_factory_tpu/data/dataset.py``. Preprocessed tensor fields
(prompt and pooled embeddings) are stored as memory-mapped ``.npy`` stacks and
ragged or string fields in a side pickle, in a cache directory keyed by a
content fingerprint (dataset | split | cutoff | preprocess-source hash |
kwargs | model id), so any change preprocesses anew. Builds go through
per-process part files and a sentinel, published atomically; one process
only until the multi-GPU slice (the barrier raises above one).
"""
from __future__ import annotations

import hashlib
import inspect
import json
import logging
import os
import pickle
import shutil
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from ..parallel.dist import barrier, get_num_processes, get_rank

logger = logging.getLogger(__name__)


def load_raw_records(path: str, cutoff: Optional[int] = None) -> List[Dict[str, Any]]:
    """jsonl (field dicts) or txt (one prompt per line) → list of records."""
    records: List[Dict[str, Any]] = []
    if path.endswith(".jsonl"):
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                records.append({"prompt": rec} if isinstance(rec, str) else rec)
    elif path.endswith(".json"):
        with open(path) as f:
            data = json.load(f)
        for rec in data:
            records.append({"prompt": rec} if isinstance(rec, str) else dict(rec))
    else:  # txt: one prompt per line
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    records.append({"prompt": line})
    if cutoff is not None:
        records = records[:cutoff]
    if not records:
        raise ValueError(f"No records loaded from {path}")
    return records


def _load_media_fields(rec: Dict[str, Any], base_dir: str) -> Dict[str, Any]:
    """Resolve image path fields to canonical (C, H, W) arrays and a
    ``video`` path to ``condition_video`` (T, C, H, W)."""
    from ..utils.media import to_image_array, to_video_array

    out = dict(rec)
    for key in ("image", "images", "condition_image", "condition_images"):
        if key in rec and isinstance(rec[key], (str, list)):
            from PIL import Image

            paths = rec[key] if isinstance(rec[key], list) else [rec[key]]
            out["images"] = [to_image_array(Image.open(os.path.join(base_dir, p))) if isinstance(p, str)
                             else to_image_array(p) for p in paths]
            if key != "images":
                out.pop(key, None)
    if "video" in rec and isinstance(rec["video"], str):
        try:  # imageio is optional: a clip that cannot be read is warned about and left out, as in JAX
            import imageio.v3 as iio

            out["condition_video"] = to_video_array(iio.imread(os.path.join(base_dir, rec["video"])))
        except Exception as e:
            logger.warning("Failed to load video %s: %s", rec["video"], e)
    return out


def compute_fingerprint(
    dataset_path: str,
    split: str,
    cutoff: Optional[int],
    preprocess_func: Optional[Callable],
    func_kwargs: Optional[Dict[str, Any]] = None,
    extra: Sequence[str] = (),
) -> str:
    """md5 over everything that affects the preprocessed content."""
    h = hashlib.md5()
    h.update(dataset_path.encode())
    h.update(str(split).encode())
    h.update(str(cutoff).encode())
    if preprocess_func is not None:
        try:
            src = inspect.getsource(preprocess_func)
        except (OSError, TypeError):
            src = repr(preprocess_func)
        h.update(hashlib.md5(src.encode()).hexdigest().encode())
    for k in sorted(func_kwargs or {}):
        h.update(f"{k}={func_kwargs[k]!r}".encode())
    for s in extra:
        h.update(str(s).encode())
    return h.hexdigest()[:16]


def _filter_kwargs(func: Callable, kwargs: Dict[str, Any]) -> Dict[str, Any]:
    """The kwargs ``func`` accepts (all of them if it takes ``**kwargs``)."""
    params = inspect.signature(func).parameters
    if any(p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values()):
        return kwargs
    return {k: v for k, v in kwargs.items() if k in params}


class PreprocessedDataset:
    """Raw records + memory-mapped preprocessed tensor fields."""

    def __init__(self, records: List[Dict[str, Any]], cache_path: str):
        self.records = records
        self.cache_path = cache_path
        self.arrays: Dict[str, np.ndarray] = {}
        self.lists: Dict[str, List[Any]] = {}
        if cache_path and os.path.isdir(cache_path):
            for fname in sorted(os.listdir(cache_path)):
                if fname.endswith(".npy"):
                    self.arrays[fname[:-4]] = np.load(os.path.join(cache_path, fname), mmap_mode="r")
                elif fname == "lists.pkl":
                    with open(os.path.join(cache_path, fname), "rb") as f:
                        self.lists = pickle.load(f)

    def __len__(self) -> int:
        return len(self.records)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        item = dict(self.records[idx])
        for k, arr in self.arrays.items():
            item[k] = np.asarray(arr[idx])
        for k, lst in self.lists.items():
            item[k] = lst[idx]
        return item

    def get_batch(self, indices) -> Dict[str, Any]:
        """Batched fetch: array fields gather their rows in one indexing op
        (host numpy)."""
        rows = np.asarray(indices, dtype=np.int64)
        out: Dict[str, Any] = {k: np.ascontiguousarray(arr[rows]) for k, arr in self.arrays.items()}
        for k, lst in self.lists.items():
            out[k] = [lst[i] for i in indices]
        record_keys = set()
        for i in indices:
            record_keys |= set(self.records[i])
        for k in record_keys:
            if k not in out:
                out[k] = [self.records[i].get(k) for i in indices]
        return out


class GeneralDataset:
    """Raw dataset + cached preprocessing (part files per process, then one
    process consolidates them into the final stacks and renames atomically;
    completed part files are reused after a crash)."""

    def __init__(self, dataset_path: str, split: str = "train", cutoff: Optional[int] = None):
        self.dataset_path = dataset_path
        self.split = split
        self.cutoff = cutoff
        self.base_dir = os.path.dirname(os.path.abspath(dataset_path))
        self.records = load_raw_records(dataset_path, cutoff)

    def __len__(self) -> int:
        return len(self.records)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        return dict(self.records[idx])

    def preprocess(
        self,
        preprocess_func: Optional[Callable],
        cache_dir: str,
        func_kwargs: Optional[Dict[str, Any]] = None,
        model_id: str = "",
        batch_size: int = 16,
        load_media: bool = True,
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
    ) -> PreprocessedDataset:
        if preprocess_func is None:
            return PreprocessedDataset(self.records, "")
        if process_index is None or process_count is None:
            process_index, process_count = get_rank(), get_num_processes()

        fp = compute_fingerprint(self.dataset_path, self.split, self.cutoff, preprocess_func,
                                 func_kwargs, (model_id,))
        name = os.path.splitext(os.path.basename(self.dataset_path))[0]
        cache_path = os.path.join(cache_dir, f"{name}-{self.split}-{fp}")
        if os.path.isdir(cache_path) and os.path.exists(os.path.join(cache_path, "_done")):
            logger.info("Preprocess cache hit: %s", cache_path)
            return PreprocessedDataset(self.records, cache_path)

        tmp_dir = cache_path + ".tmp"
        os.makedirs(tmp_dir, exist_ok=True)
        meta_file = os.path.join(tmp_dir, "_build_meta.json")
        if os.path.exists(meta_file):
            # a peer may be mid-write: a torn read counts as no meta
            try:
                with open(meta_file) as f:
                    old = json.load(f)
            except (json.JSONDecodeError, OSError):
                old = {}
            if old and old.get("num_shards") != process_count:
                logger.warning("Shard-count mismatch in %s; rebuilding", tmp_dir)
                shutil.rmtree(tmp_dir)
                os.makedirs(tmp_dir)
        tmp_meta = f"{meta_file}.{process_index}.writing"
        with open(tmp_meta, "w") as f:
            json.dump({"num_shards": process_count, "fingerprint": fp}, f)
        os.replace(tmp_meta, meta_file)

        part_file = os.path.join(tmp_dir, f"part_{process_index:04d}_of_{process_count:04d}.pkl")
        if not os.path.exists(part_file):
            self._build_part(preprocess_func, part_file, func_kwargs or {}, batch_size, load_media,
                             process_index, process_count)
        barrier("preprocess parts")
        if process_index == 0:
            self._consolidate(tmp_dir, cache_path, process_count)
        barrier("preprocess consolidated")
        return PreprocessedDataset(self.records, cache_path)

    def _build_part(self, preprocess_func: Callable, part_file: str, func_kwargs: Dict[str, Any],
                    batch_size: int, load_media: bool, process_index: int, process_count: int) -> None:
        my_indices = list(range(process_index, len(self.records), process_count))
        results: Dict[int, Dict[str, Any]] = {}
        for start in range(0, len(my_indices), batch_size):
            idxs = my_indices[start : start + batch_size]
            recs = [_load_media_fields(self.records[i], self.base_dir) if load_media else dict(self.records[i])
                    for i in idxs]
            batch = {k: [r.get(k) for r in recs] for k in recs[0]}
            out = preprocess_func(batch, **_filter_kwargs(preprocess_func, func_kwargs))
            for j, i in enumerate(idxs):
                results[i] = {k: np.asarray(v[j]) if isinstance(v, (np.ndarray, list)) or hasattr(v, "shape")
                              else v[j] for k, v in out.items()}
            logger.info("preprocess shard %d/%d: %d/%d", process_index, process_count,
                        min(start + batch_size, len(my_indices)), len(my_indices))
        tmp = part_file + ".writing"
        with open(tmp, "wb") as f:
            pickle.dump(results, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, part_file)

    def _consolidate(self, tmp_dir: str, cache_path: str, process_count: int) -> None:
        merged: Dict[int, Dict[str, Any]] = {}
        for p in range(process_count):
            with open(os.path.join(tmp_dir, f"part_{p:04d}_of_{process_count:04d}.pkl"), "rb") as f:
                merged.update(pickle.load(f))
        if len(merged) != len(self.records):
            raise RuntimeError(f"Consolidation incomplete: {len(merged)}/{len(self.records)} records")
        build_dir = cache_path + ".building"
        os.makedirs(build_dir, exist_ok=True)
        lists: Dict[str, List[Any]] = {}
        for k in sorted(merged[0].keys()):
            values = [merged[i][k] for i in range(len(self.records))]
            first = values[0]
            if isinstance(first, np.ndarray) and all(
                    isinstance(v, np.ndarray) and v.shape == first.shape for v in values):
                np.save(os.path.join(build_dir, f"{k}.npy"), np.stack(values))
            else:
                lists[k] = values
        if lists:
            with open(os.path.join(build_dir, "lists.pkl"), "wb") as f:
                pickle.dump(lists, f, protocol=pickle.HIGHEST_PROTOCOL)
        with open(os.path.join(build_dir, "_done"), "w") as f:
            f.write("ok")
        if os.path.isdir(cache_path):
            shutil.rmtree(cache_path)
        os.replace(build_dir, cache_path)
        shutil.rmtree(tmp_dir, ignore_errors=True)
        logger.info("Preprocess cache built: %s", cache_path)
