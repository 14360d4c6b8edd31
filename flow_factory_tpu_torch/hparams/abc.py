"""Config dataclass base with unknown-key capture.

Same contract as the reference ``hparams/abc.py`` (ArgABC): YAML keys that
don't match declared fields land in ``extra_kwargs`` (warned), are readable
as attributes, and re-flatten on export — this is what lets adapter-specific
kwargs (``num_frames``, ``flow_shift``, ``stg_scale``, ...) flow from YAML
through ``**training_args`` + ``filter_kwargs`` into adapter signatures.
"""
from __future__ import annotations

import logging
from dataclasses import asdict, dataclass, field, fields
from typing import Any, Dict, Iterator

logger = logging.getLogger(__name__)


@dataclass(kw_only=True)
class ArgABC:
    extra_kwargs: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, args_dict: Dict[str, Any]):
        known = {f.name for f in fields(cls)}
        init_data, extras = {}, {}
        for k, v in (args_dict or {}).items():
            (init_data if k in known else extras)[k] = v
        if extras:
            logger.warning(
                "%s: %d unknown key(s) captured into extra_kwargs: %s",
                cls.__name__, len(extras), sorted(extras),
            )
        if "extra_kwargs" in init_data:
            extras.update(init_data["extra_kwargs"])
        init_data["extra_kwargs"] = extras
        return cls(**init_data)

    def to_dict(self) -> Dict[str, Any]:
        d = asdict(self)
        extras = d.pop("extra_kwargs", {})
        d.update(extras)
        return d

    def __getattr__(self, name: str) -> Any:
        extras = self.__dict__.get("extra_kwargs")
        if extras and name in extras:
            return extras[name]
        raise AttributeError(f"{type(self).__name__} has no attribute {name!r}")

    # Mapping-style access so trainers can splat ``{**training_args, **batch}``.
    def keys(self) -> Iterator[str]:
        return iter(self.to_dict().keys())

    def __getitem__(self, key: str) -> Any:
        return self.to_dict()[key]
