"""Ring flash attention: sequence parallelism over the mesh's ``tensor`` axis
(port of ``flow_factory_tpu/ops/ring_attention.py``).

Each rank of the ring holds a (B, H, S/n, D) shard of q, k and v. The
forward keeps q local and rotates the K/V shards: n hops, each one K3 launch
(:func:`hop_forward`) on the shard at hand, merged into a running fp32
output by the natural-log lse combine (:func:`_merge`). The backward
re-rings K/V together with their fp32 dK/dV accumulators for n hops, so that
each shard's gradient is summed while it sits beside its keys and arrives
back at its owner; every hop is one K2a and one K2b launch
(:func:`hop_backward`) under the GLOBAL (merged) O and lse — the flash
decomposition of the full softmax's gradient. Δ = rowsum(dO∘O) and the
base-2 lse are computed once a backward (``attention._bwd_prologue``); the
JAX package recomputes them every hop from the same inputs, so the bits are
the same.

The ring loops (:func:`ring_forward`, :func:`ring_backward`) run over lists
of the shards this process holds and a transport that rotates them one
place: :class:`P2PRing` over a process group (``dist.batch_isend_irecv``
to the next rank, from the previous one; the next shard's exchange is
posted before the current hop's compute), or :class:`Loopback`, n virtual
ranks in one process, which is how a test or the card's smoke check drives
the same code on one device. On a CPU tensor the hops take the kernels'
plain versions; on CUDA they launch K3 and K2 or raise.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .attention import _bwd_prologue, flash_bwd_dkv, flash_bwd_dq, flash_forward


def _merge(out_a, lse_a, out_b, lse_b):
    """Combine two attention partials over disjoint key sets (fp32 outputs,
    natural-log lse)."""
    m = torch.maximum(lse_a, lse_b)
    wa = torch.exp(lse_a - m)
    wb = torch.exp(lse_b - m)
    denom = wa + wb
    out = (out_a * wa[..., None] + out_b * wb[..., None]) / denom[..., None]
    return out, m + torch.log(denom)


def hop_forward(q, k, v, scale: float):
    """One hop's forward: K3 on the shard at hand, (O in q's dtype, lse fp32)."""
    return flash_forward(q, k, v, scale)


def hop_backward(q, k, v, dout, lse2, delta, scale: float):
    """One hop's backward under the global base-2 lse and Δ: K2a's dq and
    K2b's (dk, dv) for the shard at hand, in the operands' dtype."""
    dq = flash_bwd_dq(q, k, v, dout, lse2, delta, scale)
    dk, dv = flash_bwd_dkv(q, k, v, dout, lse2, delta, scale)
    return dq, dk, dv


class Loopback:
    """n virtual ranks in one process: rotating their shards one place is a
    list rotation (virtual rank r receives what r − 1 held)."""

    def __init__(self, size: int):
        self.size = size

    def start(self, per_rank: List[Tuple[torch.Tensor, ...]]):
        return [per_rank[(r - 1) % self.size] for r in range(self.size)]

    def finish(self, pending):
        return pending


class P2PRing:
    """One rank of a ring over ``group``: :meth:`start` posts the sends of
    this rank's tensors to the next rank and the receives from the previous
    one (``dist.batch_isend_irecv``, into contiguous buffers), :meth:`finish`
    waits for them."""

    def __init__(self, group):
        self.group = group
        self.size = dist.get_world_size(group)
        rank = dist.get_rank(group)
        self.next = dist.get_global_rank(group, (rank + 1) % self.size)
        self.prev = dist.get_global_rank(group, (rank - 1) % self.size)

    def start(self, per_rank: List[Tuple[torch.Tensor, ...]]):
        from ..parallel.dist import COLLECTIVE_CALLS

        (tensors,) = per_rank
        sends = [t.contiguous() for t in tensors]
        bufs = [torch.empty_like(t) for t in sends]
        ops = ([dist.P2POp(dist.isend, t, self.next, self.group) for t in sends]
               + [dist.P2POp(dist.irecv, b, self.prev, self.group) for b in bufs])
        COLLECTIVE_CALLS["p2p"] += 1
        return dist.batch_isend_irecv(ops), sends, bufs

    def finish(self, pending):
        reqs, _sends, bufs = pending
        for r in reqs:
            r.wait()
        return [tuple(bufs)]


def ring_forward(qs: Sequence[torch.Tensor], ks: Sequence[torch.Tensor], vs: Sequence[torch.Tensor],
                 scale: float, ring) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """The forward of every local rank (JAX ``_ring_forward``): its own
    shard's hop, then n − 1 hops on the shards the ring brings, each merged
    into the fp32 output. Returns (O in q's dtype, the global lse) a rank."""
    n = ring.size
    kv = [(k, v) for k, v in zip(ks, vs)]
    pending = ring.start(kv) if n > 1 else None
    outs, lses = [], []
    for q, (k, v) in zip(qs, kv):
        o, lse = hop_forward(q, k, v, scale)
        outs.append(o.float())
        lses.append(lse)
    for hop in range(1, n):
        kv = ring.finish(pending)
        if hop < n - 1:  # the next exchange in flight while this hop computes
            pending = ring.start(kv)
        for r, (q, (k, v)) in enumerate(zip(qs, kv)):
            o, lse = hop_forward(q, k, v, scale)
            outs[r], lses[r] = _merge(outs[r], lses[r], o.float(), lse)
    return [o.to(q.dtype) for o, q in zip(outs, qs)], lses


def ring_backward(qs, ks, vs, outs, lses, douts, scale: float, ring):
    """(dq, dk, dv) of every local rank (JAX ``_ring_attention_bwd``): n hops,
    each K2a and K2b on the K/V shard at hand under the rank's global O and
    lse; the fp32 dK/dV accumulators travel with their shard and are home
    after the n-th rotation."""
    n = ring.size
    pro = [_bwd_prologue(q, o, lse, do) for q, o, lse, do in zip(qs, outs, lses, douts)]
    dqs = [torch.zeros(q.shape, dtype=torch.float32, device=q.device) for q in qs]
    kv = [(k, v) for k, v in zip(ks, vs)]
    acc = [(torch.zeros(k.shape, dtype=torch.float32, device=k.device),
            torch.zeros(v.shape, dtype=torch.float32, device=v.device)) for k, v in zip(ks, vs)]
    for hop in range(n):
        pending_kv = ring.start(kv) if n > 1 and hop < n - 1 else None
        for r, (q, (k, v), (dout, delta, lse2)) in enumerate(zip(qs, kv, pro)):
            dq, dk, dv = hop_backward(q, k, v, dout, lse2, delta, scale)
            dqs[r] += dq.float()
            acc[r][0].add_(dk.float())
            acc[r][1].add_(dv.float())
        if n > 1:
            pending_acc = ring.start(acc)
            if pending_kv is not None:
                kv = ring.finish(pending_kv)
            acc = ring.finish(pending_acc)
    return ([dq.to(q.dtype) for dq, q in zip(dqs, qs)], [a[0].to(k.dtype) for a, k in zip(acc, ks)],
            [a[1].to(v.dtype) for a, v in zip(acc, vs)])


class _RingAttention(torch.autograd.Function):
    """Ring attention of this rank's shards (JAX ``_ring_attention`` custom
    VJP): the forward keeps q, k, v, O and the global lse."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, ring):
        (out,), (lse,) = ring_forward([q], [k], [v], scale, ring)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.ring = scale, ring
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        (dq,), (dk,), (dv,) = ring_backward([q], [k], [v], [out], [lse], [dout], ctx.scale, ctx.ring)
        return dq, dk, dv, None, None


def ring_flash_attention(q, k, v, group, scale: Optional[float] = None):
    """Full (non-causal) attention of this rank's (B, H, S/n, D) shards with
    K/V ring-rotated over ``group`` (JAX ``ring_flash_attention``);
    differentiable. Returns this rank's shard of the output."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _RingAttention.apply(q, k, v, float(scale), P2PRing(group))


def loopback_ring_attention(q, k, v, n: int, scale: Optional[float] = None):
    """The ring of n virtual ranks in one process on the whole (B, H, S, D)
    tensors (S divisible by n): (O, lse) and a ``backward(dout)`` closure
    giving (dq, dk, dv), each the concatenation of the virtual ranks'
    shards. Every hop is one K3 launch forward and one K2a and K2b launch
    backward: n² of each."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    shards = lambda t: list(t.chunk(n, dim=2))
    qs, ks, vs = shards(q), shards(k), shards(v)
    ring = Loopback(n)
    outs, lses = ring_forward(qs, ks, vs, scale, ring)

    def backward(dout):
        dq, dk, dv = ring_backward(qs, ks, vs, outs, lses, shards(dout), scale, ring)
        return torch.cat(dq, dim=2), torch.cat(dk, dim=2), torch.cat(dv, dim=2)

    return torch.cat(outs, dim=2), torch.cat(lses, dim=2), backward


class _ShardSequence(torch.autograd.Function):
    """This rank's sequence shard of a tensor every rank of ``group`` holds
    whole; the backward all-gathers the shards' gradients, so each rank's
    gradient of the whole tensor is complete."""

    @staticmethod
    def forward(ctx, x, group, size: int, rank: int):
        ctx.group, ctx.size = group, size
        return x.chunk(size, dim=2)[rank]

    @staticmethod
    def backward(ctx, grad):
        from ..parallel.mesh import all_gather_dim

        return all_gather_dim(grad, 2, ctx.group, ctx.size), None, None, None


class _GatherSequence(torch.autograd.Function):
    """Every rank's sequence shard concatenated in rank order; the backward
    keeps this rank's shard of the (identical on every rank) gradient."""

    @staticmethod
    def forward(ctx, x, group, size: int, rank: int):
        from ..parallel.mesh import all_gather_dim

        ctx.size, ctx.rank = size, rank
        return all_gather_dim(x, 2, group, size)

    @staticmethod
    def backward(ctx, grad):
        return grad.chunk(ctx.size, dim=2)[ctx.rank].contiguous(), None, None, None


def ring_self_attention(q, k, v, group, scale: Optional[float] = None):
    """Self-attention of (B, H, S, D) tensors that every rank of ``group``
    holds whole (the ranks of a tensor group compute the same rows): each
    rank runs the ring on its sequence shard and the shards of the output
    are gathered; every rank's output and gradients are the same bits."""
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    qs, ks, vs = (_ShardSequence.apply(t, group, size, rank) for t in (q, k, v))
    out = ring_flash_attention(qs, ks, vs, group, scale)
    return _GatherSequence.apply(out, group, size, rank)
