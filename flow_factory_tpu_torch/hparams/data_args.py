"""Data configuration group (reference schema: ``hparams/data_args.py``)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Literal, Optional

from .abc import ArgABC


@dataclass(kw_only=True)
class DataArguments(ArgABC):
    dataset_dir: str = field(default="dataset/pickscore")
    preprocessing_batch_size: int = field(default=8)
    dataloader_num_workers: int = field(default=0)
    force_reprocess: bool = field(default=False)
    cache_dir: str = field(default="~/.cache/flow_factory_tpu/datasets")
    max_dataset_size: Optional[int] = field(default=None)
    sampler_type: Literal[
        "auto", "distributed_k_repeat", "group_contiguous", "group_distributed"
    ] = field(default="auto")
    preprocess_parallelism: Literal["local", "global"] = field(default="global")
