"""PyTorch port, ring attention (``ops/ring_attention.py``) against the JAX
package's, fp32 on the CPU, where every hop takes K3's and K2's plain
versions:

* two gloo processes, one ring rank each (the mesh's tensor axis 2), through
  the ``ring`` route of ``dot_product_attention``: O and dq/dk/dv against
  JAX ``make_ring_attention`` on two host devices and against full
  attention; the lse merge alone against JAX's ``_merge``;
* the loopback ring, four virtual ranks in one process (what
  ``chip_smoke.py`` drives on the card), against full attention, with n²
  hops each way;
* the tiny Wan with ``attn_backend: ring`` on two processes (JAX
  ``phase_wan_ring``): the rollout against the one-process ``flash``
  rollout, then one GRPO epoch at replay ratio exactly 1.0.

The file runs itself as the worker (``tests/test_torch_port_multiprocess.py``
spawns it).
"""
import os
import pickle
import sys

import numpy as np
import pytest
from torch_port_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPROCS = 2
SHAPE = (2, 2, 128, 64)  # B, H, S, D
RING_ATOL = 2e-5
#: the trajectory bar of the port's rollout tests
TRAJ_ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _isolated():
    """The JAX package's world-size override is process-wide: reset it before
    and after this module (another module on the worker may have left it
    set)."""
    from flow_factory_tpu.parallel.dist import set_world_size_override

    set_world_size_override(None)
    yield
    set_world_size_override(None)


def _inputs():
    rng = np.random.default_rng(11)
    return [rng.standard_normal(SHAPE).astype(np.float32) for _ in range(4)]  # q, k, v, cotangent


# ---------------------------------------------------------------------------
# The worker's phases
# ---------------------------------------------------------------------------

def w_ring(rank, workdir):
    """The ring route on whole tensors every rank holds: O and the gradients
    of sum(O·cotangent)."""
    import torch
    from flow_factory_tpu_torch.ops import attention as A
    from flow_factory_tpu_torch.parallel import dist as pd
    from flow_factory_tpu_torch.parallel.mesh import MeshConfig, create_mesh

    mesh = create_mesh(MeshConfig(tensor_size=NPROCS))
    A.set_ring_context(mesh.get_group("tensor"), NPROCS)
    q, k, v, cot = (torch.from_numpy(x) for x in _inputs())
    q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
    pd.COLLECTIVE_CALLS.clear()
    out = A.dot_product_attention(q, k, v, backend="ring")
    torch.sum(out * cot).backward()
    A.set_ring_context(None, 1)
    return dict(out=out.detach().numpy(), dq=q.grad.numpy(), dk=k.grad.numpy(), dv=v.grad.numpy(),
                calls=dict(pd.COLLECTIVE_CALLS))


def _wan_raw(workdir, backend, tensor):
    import yaml

    with open(os.path.join(REPO, "tests", "fixtures", "smoke_grpo_wan.yaml")) as f:
        raw = yaml.safe_load(f)
    raw["model"].update(attn_backend=backend, tensor_size=tensor)
    raw["train"]["max_epochs"] = 1
    raw["eval"]["eval_freq"] = 0
    raw["data"].update(dataset_dir=os.path.join(REPO, "tests", "fixtures", "tiny_prompts"),
                       cache_dir=os.path.join(workdir, f"cache_{backend}"))
    raw["log"]["save_dir"] = os.path.join(workdir, f"saves_{backend}")
    return raw


def _wan_epoch(raw, optimize: bool):
    from flow_factory_tpu_torch.hparams import Arguments
    from flow_factory_tpu_torch.trainers import load_trainer

    trainer = load_trainer(Arguments.from_dict(raw), device="cpu")
    steps, loss_fn = [], trainer.loss_fn

    def recorded(*args, **kwargs):
        loss, aux = loss_fn(*args, **kwargs)
        steps.append({k: float(v) for k, v in aux.items()})
        return loss, aux

    trainer.loss_fn = recorded
    trainer.scheduler.set_seed(trainer.training_args.seed)
    samples = trainer.sample(epoch=0)
    out = dict(latents=np.stack([s.all_latents for s in samples]), uids=[s.unique_id for s in samples])
    if optimize:
        trainer.prepare_feedback(samples)
        out.update(info=trainer.optimize(samples, epoch=0), steps=steps)
    trainer.cleanup()
    return out


def w_wan_ring(rank, workdir):
    from flow_factory_tpu_torch.ops import attention as A
    from flow_factory_tpu_torch.parallel import dist as pd

    pd.COLLECTIVE_CALLS.clear()
    out = _wan_epoch(_wan_raw(workdir, "ring", NPROCS), optimize=True)
    out.update(calls=dict(pd.COLLECTIVE_CALLS), data_world=pd.get_world_size(), data_rank=pd.get_data_rank())
    A.set_ring_context(None, 1)
    return out


def worker(rank: int, nprocs: int, port: str, phases, workdir: str) -> None:
    import torch

    torch.set_num_threads(1)
    from flow_factory_tpu_torch.parallel import dist as pd

    pd.initialize_multihost(f"127.0.0.1:{port}", nprocs, rank, device="cpu")
    for phase in phases:
        out = globals()[f"w_{phase}"](rank, workdir)
        with open(os.path.join(workdir, f"{phase}-{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        print(f"PHASE_OK {phase}", flush=True)
    pd.shutdown()


# ---------------------------------------------------------------------------
# The tests
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from test_torch_port_multiprocess import run_workers

    workdir = str(tmp_path_factory.mktemp("ring"))
    runs, _ = run_workers(os.path.abspath(__file__), ["ring", "wan_ring"], workdir, timeout=300)
    return workdir, runs


def _jax_ring():
    """JAX ``make_ring_attention`` on two of the host devices and full
    attention: O and the gradients of sum(O·cotangent)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from flow_factory_tpu.ops import native_attention
    from flow_factory_tpu.ops.ring_attention import make_ring_attention

    q, k, v, cot = (jnp.asarray(x) for x in _inputs())
    mesh = Mesh(np.asarray(jax.devices()[:NPROCS]), ("tensor",))
    ring = make_ring_attention(mesh, axis_name="tensor")
    spec = NamedSharding(mesh, P(None, None, "tensor", None))
    qs, ks, vs, cs = (jax.device_put(x, spec) for x in (q, k, v, cot))
    out = jax.jit(ring)(qs, ks, vs)
    grads = jax.jit(jax.grad(lambda a, b, c: jnp.sum(ring(a, b, c) * cs), argnums=(0, 1, 2)))(qs, ks, vs)
    full = native_attention(q, k, v)
    full_grads = jax.grad(lambda a, b, c: jnp.sum(native_attention(a, b, c) * cot), argnums=(0, 1, 2))(q, k, v)
    as_np = lambda o, g: dict(out=np.asarray(o), dq=np.asarray(g[0]), dk=np.asarray(g[1]), dv=np.asarray(g[2]))
    return as_np(out, grads), as_np(full, full_grads)


def test_ring_on_two_processes_equals_jax_ring_and_full_attention(world):
    """The ring route over a tensor axis of 2, one rank a process (the K/V
    shards cross the process boundary by ``batch_isend_irecv``): O and
    dq/dk/dv of fp32 (B2 H2 S128 D64) within ``RING_ATOL`` of JAX's ring on
    two host devices and of full attention; both ranks the same bits."""
    from test_torch_port_multiprocess import phase_results

    res = phase_results(world, "ring")
    jring, jfull = _jax_ring()
    for r in res:
        for name in ("out", "dq", "dk", "dv"):
            np.testing.assert_allclose(r[name], jring[name], atol=RING_ATOL, rtol=0, err_msg=f"{name} vs JAX ring")
            np.testing.assert_allclose(r[name], jfull[name], atol=RING_ATOL, rtol=0, err_msg=f"{name} vs full")
            assert np.array_equal(r[name], res[0][name]), name
        # the forward's one exchange a hop, the backward's K/V then dK/dV: n - 1 + 2n - 1 posts
        assert r["calls"]["p2p"] == (NPROCS - 1) + (2 * NPROCS - 1)


def test_merge_equals_jax_merge():
    """The natural-log lse combine of two partials, against JAX ``_merge``."""
    import jax.numpy as jnp
    import torch
    from flow_factory_tpu.ops.ring_attention import _merge as jmerge
    from flow_factory_tpu_torch.ops.ring_attention import _merge

    rng = np.random.default_rng(3)
    oa, ob = (rng.standard_normal((2, 3, 16, 8)).astype(np.float32) for _ in range(2))
    la, lb = (rng.standard_normal((2, 3, 16)).astype(np.float32) * 4 for _ in range(2))
    out, lse = _merge(*(torch.from_numpy(x) for x in (oa, la, ob, lb)))
    jout, jlse = jmerge(*(jnp.asarray(x) for x in (oa, la, ob, lb)))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-6, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=1e-6, rtol=0)


def test_loopback_ring_of_four_equals_full_attention(monkeypatch):
    """Four virtual ranks in one process through the module's own hop and
    merge functions (the code ``chip_smoke.py`` drives on the card): O, the
    lse and dq/dk/dv within ``RING_ATOL`` of full attention (K3's plain
    version and the plain backward on the whole sequence); 16 forward hops
    and 16 backward hops."""
    import torch
    from flow_factory_tpu_torch.ops import attention as A
    from flow_factory_tpu_torch.ops import ring_attention as R

    hops = {"fwd": 0, "bwd": 0}
    fwd, bwd = R.hop_forward, R.hop_backward
    monkeypatch.setattr(R, "hop_forward", lambda *a: (hops.__setitem__("fwd", hops["fwd"] + 1), fwd(*a))[1])
    monkeypatch.setattr(R, "hop_backward", lambda *a: (hops.__setitem__("bwd", hops["bwd"] + 1), bwd(*a))[1])
    q, k, v, cot = (torch.from_numpy(x) for x in _inputs())
    out, lse, backward = R.loopback_ring_attention(q, k, v, 4)
    dq, dk, dv = backward(cot)
    scale = SHAPE[-1] ** -0.5
    ref, ref_lse = A.flash_attention_plain(q, k, v, scale, return_lse=True)
    rq, rk, rv = A.flash_backward_plain(q, k, v, ref, ref_lse, cot, scale)
    assert hops == {"fwd": 16, "bwd": 16}
    for got, want, name in ((out, ref, "out"), (lse, ref_lse, "lse"), (dq, rq, "dq"), (dk, rk, "dk"), (dv, rv, "dv")):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=RING_ATOL, rtol=0, err_msg=name)
    ref_n = A.native_attention(q, k, v)
    np.testing.assert_allclose(out.numpy(), ref_n.numpy(), atol=RING_ATOL, rtol=0)


def test_wan_ring_rollout_and_grpo_epoch_on_two_processes(world, tmp_path):
    """JAX ``phase_wan_ring``: the tiny Wan with ``attn_backend: ring`` and a
    tensor axis of 2 spanning both processes (every self-attention of 8
    tokens rides the ring; the text cross-attention runs K3's plain
    version): both ranks roll out the same rows (one data replica), their
    latents within ``TRAJ_ATOL`` of the one-process ``flash`` rollout; one
    GRPO epoch replays at ratio exactly 1.0 on every grad step."""
    from test_torch_port_multiprocess import phase_results

    res = phase_results(world, "wan_ring")
    ref = _wan_epoch(_wan_raw(str(tmp_path), "flash", 1), optimize=False)
    for r in res:
        assert (r["data_world"], r["data_rank"]) == (1, 0) and r["calls"]["p2p"] > 0
        assert r["uids"] == ref["uids"]
        np.testing.assert_allclose(r["latents"], ref["latents"], atol=TRAJ_ATOL, rtol=0)
        assert r["steps"] and all(s["train/ratio_min"] == s["train/ratio_max"] == 1.0 for s in r["steps"])
        assert np.isfinite(r["info"]["train/loss"])
    assert np.array_equal(res[0]["latents"], res[1]["latents"]) and res[0]["info"] == res[1]["info"]


if __name__ == "__main__" and len(sys.argv) > 1 and sys.argv[1] == "worker":
    sys.path.insert(0, REPO)
    worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5].split(","), sys.argv[6])
