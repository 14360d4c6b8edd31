"""Device mesh and fsdp sharding over ``torch.distributed`` (JAX
``parallel/mesh.py``).

A 3-axis ``DeviceMesh`` ``("replica", "fsdp", "tensor")`` over the
processes, one GPU each, ranks laid out replica-major (the tensor rank
innermost):

* ``replica`` and ``fsdp`` are the data axes: each process rolls out and
  replays its own rows, and a "global" quantity is gathered from every data
  rank's rows in rank order (``parallel/dist.py``);
* ``fsdp`` also shards the trainable tree: each leaf's largest dimension that
  the fsdp size divides (JAX's ``_default_leaf_spec``) is cut into one slice a
  rank. A forward gathers the slices (``all_gather_into_tensor``, an autograd
  function whose backward reduce-scatters the gradient, :meth:`FsdpPlan.gather`);
  the optimizer, the EMA, the reference and the named snapshots hold slices;
* ``tensor`` carries ring attention's sequence shards (``attn_backend:
  ring``, ``ops/ring_attention.py``); the ranks of one tensor group hold the
  same rows. Tensor parallelism of heads and FFNs is not ported.

The port's leaves are the flax layout's dimensions in reverse order (a Linear
(out, in) for flax's (in, out), a LoRA ``lora_A`` (r, in) for ``a`` (in, r),
a conv (out, in, *k) for (*k, in, out)), so the leaf rule reads a leaf's shape
reversed and picks the dimension JAX picks for the same leaf (an embedding
table, in the same order in both, may shard its other dimension).
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from . import dist as pdist

REPLICA_AXIS = "replica"
FSDP_AXIS = "fsdp"
TENSOR_AXIS = "tensor"
AXES = (REPLICA_AXIS, FSDP_AXIS, TENSOR_AXIS)
DATA_AXES = (REPLICA_AXIS, FSDP_AXIS)

#: a leaf's spec: one entry a dimension, an axis name or None (JAX's PartitionSpec)
Spec = Tuple[Optional[str], ...]


@dataclass(frozen=True)
class MeshConfig:
    """Declarative parallelism selection (the YAML-visible knobs)."""

    fsdp_size: int = 1
    tensor_size: int = 1
    replica_size: Optional[int] = None  # derived when None

    def resolve(self, num_devices: int) -> Tuple[int, int, int]:
        fsdp = max(1, self.fsdp_size)
        tensor = max(1, self.tensor_size)
        if num_devices % (fsdp * tensor) != 0:
            raise ValueError(f"num_devices={num_devices} not divisible by fsdp_size*tensor_size={fsdp * tensor}")
        replica = self.replica_size or num_devices // (fsdp * tensor)
        if replica * fsdp * tensor != num_devices:
            raise ValueError(f"mesh {replica}x{fsdp}x{tensor} != num_devices {num_devices}")
        return replica, fsdp, tensor


def refuse_tensor_parallelism(tensor_size: int, attn_backend: str) -> None:
    """``tensor_size`` above 1 is the ring's sequence axis under
    ``attn_backend: ring``; under any other backend it would be tensor
    parallelism of heads and FFNs, which is not ported: raise."""
    if int(tensor_size or 1) > 1 and attn_backend != "ring":
        raise NotImplementedError(
            f"tensor_size {tensor_size} under attn_backend {attn_backend!r}: tensor parallelism of heads and FFNs "
            "is not ported (ROADMAP Queue 1 item 22); attn_backend 'ring' takes the tensor axis as the sequence "
            "axis")


def create_mesh(mesh_config: Optional[MeshConfig] = None, device_type: Optional[str] = None):
    """The 3-axis ``DeviceMesh`` over every process of the process group
    (``parallel.dist.initialize_multihost`` first), on the group's device
    type unless ``device_type`` names one. Installs the data-parallel
    topology for the host collectives and the loaders: the data rank is the
    rank over (replica, fsdp), and one gloo group a tensor slot."""
    from torch.distributed.device_mesh import init_device_mesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("create_mesh needs a process group: call parallel.dist.initialize_multihost() first")
    world = dist.get_world_size()
    replica, fsdp, tensor = (mesh_config or MeshConfig()).resolve(world)
    device_type = device_type or pdist.collective_device() or "cpu"
    mesh = init_device_mesh(device_type, (replica, fsdp, tensor), mesh_dim_names=AXES)
    rank = dist.get_rank()
    host = pdist._STATE["host"]
    if tensor > 1:  # every process makes every group, in the same order
        groups = [dist.new_group([r for r in range(world) if r % tensor == t], backend="gloo")
                  for t in range(tensor)]
        host = groups[rank % tensor]
    pdist.install_data_topology(replica * fsdp, rank // tensor, host)
    return mesh


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis: size} of a mesh."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


# ---------------------------------------------------------------------------
# Batches: each process keeps its own rows
# ---------------------------------------------------------------------------

def batch_pspec() -> Spec:
    """The batch dimension sharded over both data axes."""
    return (DATA_AXES,)


def shard_batch(batch: Any, mesh=None) -> Any:
    """A host batch as the mesh holds it: each process keeps its own rows
    (JAX assembles them into one global ``jax.Array``; the port's collectives
    gather them where a global quantity is needed), so the batch passes
    through unchanged."""
    return batch


def fetch_local_batch(arr: Any, batch_axis: int = 0) -> np.ndarray:
    """This process's rows of an output on the host (they are all it holds)."""
    if torch.is_tensor(arr):
        return arr.detach().cpu().numpy()
    return np.asarray(arr)


# ---------------------------------------------------------------------------
# Parameter sharding: the JAX leaf rule
# ---------------------------------------------------------------------------

def _spec_fits(spec: Spec, shape, axis_sizes: Dict[str, int]) -> bool:
    """A spec applies only when every named dim divides evenly."""
    if len(spec) > len(shape):
        return False
    for dim, names in enumerate(spec):
        if names is None:
            continue
        group = names if isinstance(names, tuple) else (names,)
        total = int(np.prod([axis_sizes.get(n, 1) for n in group]))
        if total > 1 and shape[dim] % total != 0:
            return False
    return True


def _default_leaf_spec(path: str, shape: Sequence[int], fsdp: int, rules=(), axis_sizes=None) -> Spec:
    """FSDP default (JAX ``_default_leaf_spec``, :167): a matching rule
    whose spec fits, else the largest dimension the fsdp size divides and
    that is at least twice it, ties going to the last dimension; ``()``
    replicates."""
    axis_sizes = axis_sizes or {}
    for pattern, spec in rules:
        if re.search(pattern, path) and _spec_fits(spec, shape, axis_sizes):
            return tuple(spec)
    if fsdp <= 1 or len(shape) == 0:
        return ()
    best_dim, best_size = None, 0
    for d, s in enumerate(shape):
        if s % fsdp == 0 and s >= best_size and s >= 2 * fsdp:
            best_dim, best_size = d, s
    if best_dim is None:
        return ()
    spec: List[Optional[str]] = [None] * len(shape)
    spec[best_dim] = FSDP_AXIS
    return tuple(spec)


def param_sharding_rules(extra: Optional[Dict[str, Spec]] = None):
    """Compose model-provided regex rules with the FSDP default."""
    return list((extra or {}).items())


def leaf_shard_dim(path: str, shape: Sequence[int], fsdp: int, rules=()) -> Optional[int]:
    """The port dimension of a leaf that the fsdp axis shards, or None: the
    JAX rule on the shape read in flax order (reversed)."""
    spec = _default_leaf_spec(path, tuple(shape)[::-1], fsdp, rules, {FSDP_AXIS: fsdp})
    if FSDP_AXIS not in spec:
        return None
    return len(shape) - 1 - spec.index(FSDP_AXIS)


def _tree_paths(tree, prefix: str = ""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tree_paths(v, f"{prefix}/{k}" if prefix else str(k))
    else:
        yield prefix, tree


def _tree_build(tree, fn, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _tree_build(v, fn, f"{prefix}/{k}" if prefix else str(k)) for k, v in tree.items()}
    return fn(prefix, tree)


class FsdpPlan:
    """The fsdp sharding of a trainable tree: each leaf's sharded dimension
    (None: replicated) and full shape by path, the fsdp group, its size and
    this rank's place in it."""

    def __init__(self, tree, mesh, rules=()):
        self.size = mesh_shape(mesh)[FSDP_AXIS]
        self.group = mesh.get_group(FSDP_AXIS)
        self.rank = mesh.get_local_rank(FSDP_AXIS)
        self.dims: Dict[str, Optional[int]] = {}
        self.shapes: Dict[str, Tuple[int, ...]] = {}
        for path, leaf in _tree_paths(tree):
            self.dims[path] = leaf_shard_dim(path, leaf.shape, self.size, rules)
            self.shapes[path] = tuple(leaf.shape)

    def spec_tree(self, tree):
        """The sharded dimension of each leaf of ``tree`` (None: replicated)."""
        return _tree_build(tree, lambda path, _: self.dims[path])

    def shard(self, tree, prefix: str = ""):
        """This rank's slices of a full tree (detached copies; a leaf that
        requires grad keeps requiring it). ``prefix`` places a subtree."""
        def cut(path, leaf):
            dim = self.dims[path]
            if tuple(leaf.shape) != self.shapes[path]:
                raise ValueError(f"fsdp shard {path}: shape {tuple(leaf.shape)} != {self.shapes[path]}")
            out = leaf.detach() if dim is None else leaf.detach().chunk(self.size, dim)[self.rank]
            return out.contiguous().clone().requires_grad_(leaf.requires_grad)

        return _tree_build(tree, cut, prefix)

    def gather(self, tree, prefix: str = "", differentiable: bool = True):
        """The full leaves of a sharded tree: sharded leaves all-gathered over
        the fsdp group (under grad, through :class:`_GatherShard`, whose
        backward reduce-scatters the gradient), replicated ones as they are."""
        def full(path, leaf):
            dim = self.dims[path]
            if dim is None:
                return leaf
            if differentiable and torch.is_grad_enabled() and leaf.requires_grad:
                return _GatherShard.apply(leaf, dim, self.group, self.size)
            return all_gather_dim(leaf.detach(), dim, self.group, self.size)

        return _tree_build(tree, full, prefix)


def all_gather_dim(x: torch.Tensor, dim: int, group, size: int) -> torch.Tensor:
    """The slices of every rank of ``group`` concatenated on ``dim`` in rank
    order (``all_gather_into_tensor``), contiguous."""
    src = x.movedim(dim, 0).contiguous()
    out = torch.empty((size * src.shape[0],) + tuple(src.shape[1:]), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, src, group=group)
    pdist.COLLECTIVE_CALLS["all_gather"] += 1
    return out.movedim(0, dim).contiguous()


def reduce_scatter_dim(x: torch.Tensor, dim: int, group, size: int) -> torch.Tensor:
    """This rank's slice on ``dim`` of the sum of ``x`` over ``group``."""
    src = x.movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // size,) + tuple(src.shape[1:]), dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, src, op=dist.ReduceOp.SUM, group=group)
    pdist.COLLECTIVE_CALLS["reduce_scatter"] += 1
    return out.movedim(0, dim).contiguous()


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """Sum ``x`` over ``group`` in place."""
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    pdist.COLLECTIVE_CALLS["all_reduce"] += 1
    return x


def data_all_reduce_(x: torch.Tensor, mesh) -> torch.Tensor:
    """Sum ``x`` over the data axes (replica, then fsdp) in place."""
    shape = mesh_shape(mesh)
    for axis in DATA_AXES:
        if shape[axis] > 1:
            all_reduce_(x, mesh.get_group(axis))
    return x


class _GatherShard(torch.autograd.Function):
    """All-gather of a leaf's slices for a forward; the backward sums the
    full gradient over the fsdp group and keeps this rank's slice."""

    @staticmethod
    def forward(ctx, shard, dim: int, group, size: int):
        ctx.dim, ctx.group, ctx.size = dim, group, size
        return all_gather_dim(shard, dim, group, size)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter_dim(grad, ctx.dim, ctx.group, ctx.size), None, None, None


class GradSync:
    """The cross-process part of one optimizer step over a mesh: the sum of
    the trainable leaves' gradients over the data axes (over ``replica``;
    over ``fsdp`` too for a leaf the fsdp axis does not shard, since a
    sharded leaf's backward already reduce-scattered it), divided by the data
    size, and the squared global norm of the sharded gradients summed over
    the fsdp group."""

    def __init__(self, mesh, sharded: Sequence[bool]):
        shape = mesh_shape(mesh)
        self.replica_group = mesh.get_group(REPLICA_AXIS)
        self.fsdp_group = mesh.get_group(FSDP_AXIS)
        self.fsdp = shape[FSDP_AXIS]
        self.data_size = shape[REPLICA_AXIS] * shape[FSDP_AXIS]
        self.sharded = list(sharded)

    def average(self, grads: Sequence[torch.Tensor]) -> None:
        for g, sharded in zip(grads, self.sharded):
            all_reduce_(g, self.replica_group)
            if not sharded and self.fsdp > 1:
                all_reduce_(g, self.fsdp_group)
            if self.data_size > 1:
                g.div_(self.data_size)

    @property
    def any_sharded(self) -> bool:
        return any(self.sharded)

    def squared_norm(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """Σ‖g‖² of the whole tree: the replicated leaves' here, the slices'
        summed over the fsdp group."""
        sq = lambda gs: sum(torch.sum(g.float() * g.float()) for g in gs)
        shards = [g for g, s in zip(grads, self.sharded) if s]
        total = sq([g for g, s in zip(grads, self.sharded) if not s])
        return total + all_reduce_(sq(shards), self.fsdp_group) if shards else total


def shard_params(tree, mesh, rules=None):
    """(this rank's slices of ``tree``, its :class:`FsdpPlan`)."""
    plan = FsdpPlan(tree, mesh, param_sharding_rules(rules))
    return plan.shard(tree), plan
