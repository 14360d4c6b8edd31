"""Trainer factory: the mesh, the adapter on its device, then the trainer."""
from __future__ import annotations

from ..models import load_adapter
from .registry import resolve_trainer_class


def build_mesh(config):
    """The ``DeviceMesh`` of ``model.fsdp_size`` and ``model.tensor_size``
    (JAX ``trainers/loader.py:26-27``) when either is above 1 or a process
    group exists (several processes, or a launcher at one), else None."""
    import torch.distributed as dist

    from ..parallel.mesh import MeshConfig, create_mesh, refuse_tensor_parallelism

    ma = config.model_args
    fsdp, tensor = int(getattr(ma, "fsdp_size", 1) or 1), int(getattr(ma, "tensor_size", 1) or 1)
    refuse_tensor_parallelism(tensor, ma.attn_backend)
    if max(fsdp, tensor) <= 1 and not (dist.is_available() and dist.is_initialized()):
        return None
    return create_mesh(MeshConfig(fsdp_size=fsdp, tensor_size=tensor))


def load_trainer(config, device=None):
    """The trainer of ``config.training_args.trainer_type`` over the adapter
    of ``config.model_args.model_type``, on ``device``, else on the config's
    ``model.device``, else on ``cuda`` (a CUDA request without a card raises),
    over the mesh of :func:`build_mesh`."""
    device = device or getattr(config.model_args, "device", None)
    adapter = load_adapter(config, device=device, mesh=build_mesh(config))
    return resolve_trainer_class(config.training_args.trainer_type)(config, adapter)
