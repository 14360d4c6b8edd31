"""PyTorch port on several processes: two gloo processes on the CPU, one
rank each, against the JAX package at one process on the global batch.

The file runs itself as the worker (``python tests/test_torch_port_multiprocess.py
worker RANK N PORT PHASES DIR``): each worker joins the process group with
``parallel.dist.initialize_multihost(device="cpu")``, runs the phases in
order and pickles each phase's result to ``DIR/<phase>-<rank>.pkl``. One
spawn a module (``world``) runs every phase; the JAX references are computed
here, in the test process, while the workers run. A spawn that outlives its
timeout is killed and fails the tests.

* collectives: ``host_allgather``, ``host_allgather_objects``,
  ``global_tensor_stats_batch``, ``reduce_loss_info``, ``global_stats``;
* groupwise rewards, the ``RewardBuffer``, advantages and the eval gather
  with groups split across the ranks;
* one GRPO step of the tiny SD3.5 at replica 2 and at fsdp 2 against the
  JAX ``_grad_fn`` and optax on the global batch; the fsdp shards against
  JAX's leaf rule; the fsdp checkpoint and export;
* a GRPO epoch under ``distributed_k_repeat``, DPO's cross-rank pairs, NFT
  and DGPO epochs with their step-0 invariants.
"""
import copy
import os
import pickle
import socket
import subprocess
import sys
import time
import types

import numpy as np
import pytest
from torch_port_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPROCS = 2
B = 4  # the global batch of the GRPO step: 2 rows a rank
SMOKE = os.path.join(REPO, "tests", "fixtures", "smoke_grpo.yaml")

STEP_CONFIG = {
    "data": {"dataset_dir": "tests/fixtures/tiny_prompts"},
    "model": {"model_type": "sd3-5", "model_name_or_path": "tiny", "variant": "tiny",
              "finetune_type": "lora", "lora_rank": 4, "lora_alpha": 8, "attn_backend": "auto",
              "master_dtype": "float32", "inference_dtype": "float32"},
    "scheduler": {"dynamics_type": "Flow-SDE", "noise_level": 0.7, "num_sde_steps": 2,
                  "sde_steps": [0, 1, 2]},
    "train": {"trainer_type": "grpo", "resolution": 32, "num_inference_steps": 4, "guidance_scale": 2.0,
              "per_device_batch_size": B // NPROCS, "group_size": B, "unique_sample_num_per_epoch": 1,
              "latent_storage_dtype": "fp32", "ema_decay": 0, "clip_range": 0.2, "adv_clip_range": 1.5,
              "learning_rate": 1e-3},
    "eval": {}, "log": {}, "rewards": [],
}
@pytest.fixture(autouse=True, scope="module")
def _isolated():
    """The JAX package's world-size override is process-wide: reset it before
    and after this module (another module on the worker may have left it
    set)."""
    from flow_factory_tpu.parallel.dist import set_world_size_override

    set_world_size_override(None)
    yield
    set_world_size_override(None)


PHASES = ("collectives", "groupwise", "advantages", "eval_gather", "grpo_replica", "grpo_fsdp",
          "grpo_epoch", "dpo_pairs", "nft", "awm", "crd", "dgpo")


# ---------------------------------------------------------------------------
# Spawning (also used by tests/test_torch_port_ring.py)
# ---------------------------------------------------------------------------

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_workers(script: str, phases, workdir: str, timeout: float, meanwhile=None, nprocs: int = NPROCS):
    """Run ``script worker RANK N PORT PHASES DIR`` in ``nprocs`` processes
    and ``meanwhile()`` here while they run; kill the workers if they outlive
    ``timeout``. Returns ([(returncode, output)] a rank, ``meanwhile``'s
    result)."""
    port = free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen([sys.executable, script, "worker", str(r), str(nprocs), str(port), ",".join(phases),
                               workdir], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
                              cwd=REPO) for r in range(nprocs)]
    deadline = time.monotonic() + timeout
    try:
        extra = meanwhile() if meanwhile is not None else None
        outs = [p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0] for p in procs]
    except subprocess.TimeoutExpired:
        pytest.fail(f"workers timed out after {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, out) for p, out in zip(procs, outs)], extra


def phase_results(world, phase):
    """Each rank's pickled result of ``phase``; fails with the workers' output
    when a rank did not finish it."""
    workdir, runs = world
    for rank, (rc, out) in enumerate(runs):
        assert f"PHASE_OK {phase}" in out, f"rank {rank} (rc {rc}) did not finish {phase}:\n{out[-4000:]}"
    return [pickle.load(open(os.path.join(workdir, f"{phase}-{r}.pkl"), "rb")) for r in range(len(runs))]


# ---------------------------------------------------------------------------
# The worker's phases (no JAX here)
# ---------------------------------------------------------------------------

def _smoke_raw(workdir, trainer_type="grpo", fixture=SMOKE, **train):
    import yaml

    with open(fixture) as f:
        raw = yaml.safe_load(f)
    raw["train"].update(trainer_type=trainer_type, max_epochs=1, **train)
    raw["data"].update(dataset_dir=os.path.join(REPO, "tests", "fixtures", "tiny_prompts"),
                       cache_dir=os.path.join(workdir, f"cache_{trainer_type}"))
    raw["log"]["save_dir"] = os.path.join(workdir, f"saves_{trainer_type}")
    return raw


def _recording(trainer):
    """Record every grad step's aux as floats."""
    steps, loss_fn = [], trainer.loss_fn

    def recorded(*args, **kwargs):
        loss, aux = loss_fn(*args, **kwargs)
        steps.append({k: float(v) for k, v in aux.items()})
        return loss, aux

    trainer.loss_fn = recorded
    return steps


def _epoch(raw):
    from flow_factory_tpu_torch.hparams import Arguments
    from flow_factory_tpu_torch.trainers import load_trainer

    trainer = load_trainer(Arguments.from_dict(raw), device="cpu")
    steps = _recording(trainer)
    trainer.scheduler.set_seed(trainer.training_args.seed)
    samples = trainer.sample(epoch=0)
    metrics = trainer.prepare_feedback(samples)
    return trainer, samples, metrics, steps


def w_collectives(rank, workdir):
    from flow_factory_tpu_torch.parallel import dist as pd

    rng = np.random.default_rng(100 + rank)
    inputs = dict(rows=rng.standard_normal((2 + rank, 3)),
                  metrics={"m": rng.standard_normal(3 + rank), "s": rng.standard_normal(1 + rank)},
                  loss={"train/loss": rng.standard_normal(4), "train/kl": rng.standard_normal(4)},
                  vals=rng.standard_normal(5 + rank))
    return dict(inputs=inputs, allgather=pd.host_allgather(inputs["rows"]),
                objects=pd.host_allgather_objects([{"rank": rank, "blob": np.arange(3) + rank}]),
                stats=pd.global_tensor_stats_batch(inputs["metrics"]),
                loss_info=pd.reduce_loss_info(inputs["loss"]), global_stats=pd.global_stats(inputs["vals"]))


def _group_samples(rank):
    """Two groups of four, two members of each on each rank, the brightness
    growing with (rank, member)."""
    return [types.SimpleNamespace(unique_id=uid, prompt=uid, extra_kwargs={},
                                  image=np.full((3, 4, 4), (rank * 2 + j + (0.5 if uid == "ub" else 0.0)) / 10.0,
                                                np.float32))
            for uid in ("ua", "ub") for j in range(2)]


def w_groupwise(rank, workdir):
    from flow_factory_tpu_torch.hparams.reward_args import RewardArguments
    from flow_factory_tpu_torch.rewards import MyGroupReward, RewardBuffer, RewardProcessor

    model = MyGroupReward(RewardArguments(name="rank", reward_model="MyGroupReward"))
    samples = _group_samples(rank)
    scores = RewardProcessor([model])._score_groupwise_distributed(model, samples, 2 * NPROCS)
    buf = RewardBuffer([model], group_size=2 * NPROCS, distributed_groups=True)
    buf.add_samples(_group_samples(rank))
    buffered = [s.extra_kwargs["reward"] for s in buf.finalize()]
    buf.cleanup()
    return dict(scores=scores, buffered=buffered)


def _reward_rows(rank):
    rng = np.random.default_rng(7 + rank)
    return [(uid, {"a": float(rng.standard_normal()), "b": float(rng.standard_normal())})
            for uid in ("u0", "u1", "u0", "u1")]


def w_advantages(rank, workdir):
    from flow_factory_tpu_torch.advantage import AdvantageProcessor

    out = {}
    for agg in ("sum", "gdpo"):
        samples = [types.SimpleNamespace(unique_id=u, extra_kwargs={"rewards": dict(r)}) for u, r in _reward_rows(rank)]
        proc = AdvantageProcessor(group_size=2 * NPROCS, aggregation=agg, reward_weights={"a": 1.0, "b": 0.5},
                                  distributed_groups=True)
        metrics = proc.compute_advantages(samples)
        out[agg] = dict(adv=[s.extra_kwargs["advantage"] for s in samples], metrics=metrics)
    return out


def _eval_rows(rank):
    return [{"reward": float(rank * 2 + j), "rewards": {"pick": float(rank * 2 + j) / 3.0, "clip": 1.0}}
            for j in range(2)]


def w_eval_gather(rank, workdir):
    from flow_factory_tpu_torch.trainers.abc import gather_eval_reward_metrics

    return gather_eval_reward_metrics([types.SimpleNamespace(extra_kwargs=r) for r in _eval_rows(rank)])


def _step_adapter(workdir, fsdp):
    """The port adapter of the step config on the mesh, on the JAX pair's
    weights and LoRA (``inputs.pkl``)."""
    from flow_factory_tpu_torch.hparams import Arguments
    from flow_factory_tpu_torch.models import load_adapter
    from flow_factory_tpu_torch.trainers.loader import build_mesh
    from flow_factory_tpu_torch.utils import weights

    inputs = pickle.load(open(os.path.join(workdir, "inputs.pkl"), "rb"))
    cfg = copy.deepcopy(STEP_CONFIG)
    cfg["model"]["fsdp_size"] = fsdp
    args = Arguments.from_dict(cfg)
    pa = load_adapter(args, device="cpu", mesh=build_mesh(args))
    pa.load_state_dicts(weights.sd35_state_dicts(inputs["flax_params"], pa.component_configs))
    tcfg = pa.component_configs["transformer"]
    module_map = weights.sd3_transformer_map(tcfg.depth, tcfg.dual_attention_layers)[0]
    pa.load_lora("transformer", weights.lora_from_flax(inputs["lora"], module_map))
    return pa, module_map, inputs


def _grpo_step(rank, workdir, fsdp):
    """One GRPO grad step on this rank's half of the global batch, then the
    update; the whole LoRA after it in flax layout."""
    import torch
    from flow_factory_tpu_torch.trainers.grpo import GRPOTrainer
    from flow_factory_tpu_torch.utils import weights

    pa, module_map, inputs = _step_adapter(workdir, fsdp)
    trainer = object.__new__(GRPOTrainer)
    trainer.training_args, trainer.use_guard, trainer.adapter, trainer.global_step = \
        pa.training_args, False, pa, 0
    trainer._init_optimizer()
    averaged = []  # the gradients as the update takes them, averaged over the ranks
    average = trainer.grad_sync.average
    trainer.grad_sync.average = lambda grads: (average(grads), averaged.extend(g.clone() for g in grads))
    rows = slice(rank * (B // NPROCS), (rank + 1) * (B // NPROCS))
    batch = {k: torch.from_numpy(np.ascontiguousarray(v[rows])) for k, v in inputs["batch"].items()}
    loss, _ = trainer.backward_step({**batch, "guidance_scale": 2.0})
    gnorm = float(trainer.apply_accumulated())
    it = iter(averaged)
    grads = {"transformer": {p: {k: next(it) for k in sorted(ab)}
                             for p, ab in sorted(pa.trainable["transformer"].items())}}
    as_flax = lambda tree: weights.lora_to_flax({p: {k: v.detach() for k, v in ab.items()}
                                                 for p, ab in tree["transformer"].items()}, module_map)
    out = dict(loss=float(loss), gnorm=gnorm, lora=as_flax(pa.full_tree()), grads=as_flax(pa.full_tree(grads)))
    return pa, trainer, module_map, out


def w_grpo_replica(rank, workdir):
    return _grpo_step(rank, workdir, fsdp=1)[3]


def w_grpo_fsdp(rank, workdir):
    import torch
    from flow_factory_tpu_torch.utils.safetensors_io import load_file

    pa, trainer, module_map, out = _grpo_step(rank, workdir, fsdp=NPROCS)
    inverse = {port: flax for flax, port in module_map.items()}
    out["dims"] = {f"{inverse[path.split('/')[1]]}/{path.split('/')[2]}": d
                   for path, d in pa.fsdp_plan.dims.items()}
    out["shard_shapes"] = {f"{p}/{k}": tuple(v.shape) for p, ab in pa.trainable["transformer"].items()
                           for k, v in ab.items()}
    # the optimizer state gathered whole and cut again gives each rank's own bits
    live = trainer.optimizer.state_dict()["state"]
    placed = trainer._placed_optimizer_state(trainer._optimizer_state())["state"]
    out["opt_state_round_trip"] = all(torch.equal(placed[i][k], t) for i, st in live.items()
                                      for k, t in st.items())
    # the sharded LoRA checkpoint: gathered, written by rank 0, read back into fresh shards
    ckpt = os.path.join(workdir, "ckpt_fsdp")
    pa.save_checkpoint(ckpt, model_only=True, save_ema=False)
    out["written"] = sorted(os.listdir(ckpt))
    fresh, _, _ = _step_adapter(workdir, NPROCS)
    fresh.load_checkpoint(ckpt, resume_type="lora")
    out["ckpt_round_trip"] = all(torch.equal(a, b) for a, b in zip(fresh.trainable_leaves(), pa.trainable_leaves()))
    # the size-capped export: its shards and index reassemble the merged weights
    pa.MAX_SHARD_BYTES = 4096
    export = os.path.join(workdir, "export_fsdp")
    pa.export_merged(export, save_ema=False)
    with torch.no_grad():
        merged = {**dict(pa.modules["transformer"].named_parameters()), **pa.merge_component("transformer")}
    if rank == 0:
        import json

        index = json.load(open(os.path.join(export, "model_index.json")))
        files = sorted(set(index["weight_map"].values()))
        got = {}
        for fn in files:
            got.update(load_file(os.path.join(export, fn)))
        out["export_files"] = len(files)
        out["export_equal"] = (set(got) == {f"{n}" for n in merged}
                               and all(torch.equal(got[n], merged[n].detach()) for n in merged))
    return out


def w_grpo_epoch(rank, workdir):
    raw = _smoke_raw(workdir, group_size=4, unique_sample_num_per_epoch=2, per_device_batch_size=1)
    raw["data"]["sampler_type"] = "distributed_k_repeat"
    raw["rewards"].append({"name": "group_rank", "reward_model": "MyGroupReward", "weight": 0.5, "batch_size": 8})
    trainer, samples, metrics, steps = _epoch(raw)
    info = trainer.optimize(samples, epoch=0)
    out = dict(steps=steps, info=info, reward_mean=metrics["reward/mean"], uids=[s.unique_id for s in samples],
               group_rewards=[s.extra_kwargs["rewards"]["group_rank"] for s in samples])
    trainer.cleanup()
    return out


def w_dpo_pairs(rank, workdir):
    raw = _smoke_raw(workdir, "dpo", group_size=4, unique_sample_num_per_epoch=2, per_device_batch_size=1)
    raw["data"]["sampler_type"] = "distributed_k_repeat"
    trainer, samples, _, steps = _epoch(raw)
    for i, s in enumerate(samples):
        s.extra_kwargs["_origin"] = (rank, i)
    pairs = trainer._form_pairs(samples)
    info = trainer.optimize(samples, epoch=0)
    out = dict(samples=[(s.unique_id, float(s.extra_kwargs["advantage"])) for s in samples],
               pairs=[(c.extra_kwargs["_origin"], r.extra_kwargs["_origin"]) for c, r in pairs],
               steps=steps, info=info)
    trainer.cleanup()
    return out


def w_nft(rank, workdir):
    raw = _smoke_raw(workdir, "nft", group_size=4, unique_sample_num_per_epoch=2, per_device_batch_size=1,
                     nft_beta=1.0)
    raw["data"]["sampler_type"] = "distributed_k_repeat"
    trainer, samples, _, steps = _epoch(raw)
    out = dict(info=trainer.optimize(samples, epoch=0), steps=steps)
    trainer.cleanup()
    return out


def w_awm(rank, workdir):
    raw = _smoke_raw(workdir, "awm", group_size=4, unique_sample_num_per_epoch=2, per_device_batch_size=1)
    raw["data"]["sampler_type"] = "distributed_k_repeat"
    trainer, samples, _, steps = _epoch(raw)
    out = dict(info=trainer.optimize(samples, epoch=0), steps=steps)
    trainer.cleanup()
    return out


def w_crd(rank, workdir):
    raw = _smoke_raw(workdir, "crd", group_size=4, unique_sample_num_per_epoch=2, per_device_batch_size=1)
    raw["data"]["sampler_type"] = "distributed_k_repeat"
    try:
        _epoch(raw)
    except NotImplementedError as e:
        return str(e)
    return None


def w_dgpo(rank, workdir):
    raw = _smoke_raw(workdir, "dgpo", os.path.join(REPO, "tests", "fixtures", "smoke_dgpo.yaml"),
                     per_device_batch_size=2)
    trainer, samples, _, steps = _epoch(raw)
    out = dict(info=trainer.optimize(samples, epoch=0), steps=steps, uids=[s.unique_id for s in samples],
               sampler=trainer.config.data_args.sampler_type)
    trainer.cleanup()
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
# The tests (the JAX references at one process)
# ---------------------------------------------------------------------------

def _jax_step_pair():
    """The JAX adapter of the step config, its LoRA drawn with a non-zero
    ``b``, and the global batch of 4 with old log-probs that make the clip
    bind on two rows (as ``tests/test_torch_port_train.py``)."""
    import jax
    import jax.numpy as jnp
    import torch
    from flow_factory_tpu.hparams.args import Arguments as JArgs
    from flow_factory_tpu.models import load_adapter as jax_load
    from flow_factory_tpu.parallel.dist import set_world_size_override
    from flow_factory_tpu_torch.hparams import Arguments
    from flow_factory_tpu_torch.models import load_adapter

    cfg = copy.deepcopy(STEP_CONFIG)
    cfg["train"]["per_device_batch_size"] = B
    set_world_size_override(1)
    try:
        ja = jax_load(JArgs.from_dict(cfg))
    finally:
        set_world_size_override(None)
    flax_params = jax.tree.map(np.asarray, jax.device_get(ja.params))
    rng = np.random.default_rng(5)
    lora = {path: {"a": np.asarray(ab["a"]), "b": (0.05 * rng.standard_normal(ab["b"].shape)).astype(np.float32)}
            for path, ab in jax.device_get(ja.trainable["transformer"]).items()}
    ja.trainable = {"transformer": jax.tree.map(jnp.asarray, lora)}
    pa = load_adapter(Arguments.from_dict(copy.deepcopy(cfg)), device="cpu")
    with torch.no_grad():
        enc = pa.encode_prompt(["a photo of a red fox in the snow"] * B)
        neg = pa.encode_prompt([""] * B)
    h, w, c = pa.latent_shape(32, 32)
    full = lambda v: np.full((B,), v, np.float32)
    batch = dict(
        latents=rng.standard_normal((B, h, w, c)).astype(np.float32),
        next_latents=rng.standard_normal((B, h, w, c)).astype(np.float32),
        timestep=full(750.0), sigma=full(0.75), sigma_next=full(0.5), noise_level=full(0.7), sigma_max=full(0.9),
        advantage=np.asarray([1.2, -0.7, 2.5, -3.0], np.float32),
        prompt_embeds=enc["prompt_embeds"].numpy(), pooled_prompt_embeds=enc["pooled_prompt_embeds"].numpy(),
        negative_prompt_embeds=neg["prompt_embeds"].numpy(),
        negative_pooled_prompt_embeds=neg["pooled_prompt_embeds"].numpy(),
    )
    jb = lambda b: {**{k: jnp.asarray(v) for k, v in b.items()}, "guidance_scale": jnp.float32(2.0)}
    mean = np.asarray(ja.training_forward(ja.trainable, jb(batch), compute_log_prob=False).next_latents_mean)
    batch["next_latents"] = (mean + 0.3 * batch["next_latents"]).astype(np.float32)
    new_lp = np.asarray(ja.training_forward(ja.trainable, jb(batch)).log_prob)
    batch["old_log_prob"] = (new_lp + np.asarray([-0.05, 0.5, -0.4, -0.1], np.float32)).astype(np.float32)
    return ja, flax_params, lora, batch, jb, pa.training_args


def _optax(ta):
    """The trainer's update in optax: the global-norm clip, then AdamW."""
    import optax

    return optax.chain(optax.clip_by_global_norm(ta.max_grad_norm),
                       optax.adamw(learning_rate=ta.learning_rate, b1=ta.adam_betas[0], b2=ta.adam_betas[1],
                                   eps=ta.adam_epsilon, weight_decay=ta.adam_weight_decay))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every phase on two gloo workers, and the JAX step's expectation."""
    import jax
    from flow_factory_tpu.trainers import abc as jabc
    from flow_factory_tpu.trainers.grpo import GRPOTrainer as JGRPO

    workdir = str(tmp_path_factory.mktemp("mp"))
    ja, flax_params, lora, batch, jb, ta = _jax_step_pair()
    with open(os.path.join(workdir, "inputs.pkl"), "wb") as f:
        pickle.dump(dict(flax_params=flax_params, lora=lora, batch=batch), f)

    def jax_step():
        """The JAX step on the global batch, while the workers run."""
        jt = object.__new__(JGRPO)
        jt.training_args, jt.use_guard, jt.adapter = ja.training_args, False, ja
        (j_loss, _), j_grads = jt._grad_fn(ja.trainable, ja.frozen_velocity_params(), jb(batch), None)
        opt = _optax(ta)
        _, _, j_gnorm = jabc._apply_updates_jit(opt, ja.trainable, opt.init(ja.trainable), j_grads, 1)
        return dict(loss=float(j_loss), gnorm=float(j_gnorm), grads=jax.tree.map(np.asarray, j_grads)["transformer"],
                    before=lora, ta=ta)

    runs, expect = run_workers(os.path.abspath(__file__), PHASES, workdir, 400, meanwhile=jax_step)
    return workdir, runs, expect


def _res(world, phase):
    workdir, runs, _ = world
    return phase_results((workdir, runs), phase)


def test_collectives_equal_jax_at_one_process_on_the_concatenated_rows(world):
    """Over two ranks, each with its own rows: ``host_allgather`` and
    ``host_allgather_objects`` give every rank's rows in rank order, and the
    statistics are the bits the JAX functions give at one process on the
    concatenation (the stds within 1e-12)."""
    from flow_factory_tpu.parallel import dist as jdist

    res = _res(world, "collectives")
    inputs = [r["inputs"] for r in res]
    rows = np.concatenate([i["rows"] for i in inputs])
    cat = lambda key: {k: np.concatenate([i[key][k] for i in inputs]) for k in inputs[0][key]}
    j_stats = jdist.global_tensor_stats_batch(cat("metrics"))
    j_loss = jdist.reduce_loss_info(cat("loss"))
    j_global = jdist.global_stats(np.concatenate([i["vals"] for i in inputs]))
    for r in res:
        np.testing.assert_array_equal(r["allgather"], rows)
        assert [o[0]["rank"] for o in r["objects"]] == [0, 1]
        assert all(np.array_equal(o[0]["blob"], np.arange(3) + k) for k, o in enumerate(r["objects"]))
        for name, s in j_stats.items():
            assert (r["stats"][name]["mean"], r["stats"][name]["min"], r["stats"][name]["max"]) == \
                (s["mean"], s["min"], s["max"]), name
            assert abs(r["stats"][name]["std"] - s["std"]) <= 1e-12
        assert sorted(r["loss_info"]) == sorted(j_loss)
        for k, v in j_loss.items():
            assert (abs(r["loss_info"][k] - v) <= 1e-12) if k.endswith("_std") else r["loss_info"][k] == v, k
        assert r["global_stats"][0] == j_global[0] and abs(r["global_stats"][1] - j_global[1]) <= 1e-12


def test_groupwise_reward_and_reward_buffer_across_processes(world):
    """Groups of four with two members on each rank (JAX ``phase_groupwise``):
    the distributed groupwise scores and the ``RewardBuffer`` under
    ``distributed_groups`` give each rank the scores the JAX processor gives
    at one process on every group whole."""
    from flow_factory_tpu.hparams.reward_args import RewardArguments
    from flow_factory_tpu.rewards import MyGroupReward, RewardProcessor

    res = _res(world, "groupwise")
    model = MyGroupReward(RewardArguments(name="rank", reward_model="MyGroupReward"))
    samples = [s for r in range(NPROCS) for s in _group_samples(r)]
    want = RewardProcessor([model])._score_groupwise_local(model, samples, 2 * NPROCS)
    for r, got in enumerate(res):
        np.testing.assert_array_equal(got["scores"], want[4 * r : 4 * r + 4])
        np.testing.assert_array_equal(got["buffered"], want[4 * r : 4 * r + 4])
    assert sorted(set(want)) == [0.0, 1 / 3, 2 / 3, 1.0]


@pytest.mark.parametrize("agg", ["sum", "gdpo"])
def test_advantages_gather_rows_by_unique_id_across_processes(world, agg):
    """Rows of two groups split across the ranks: each rank's advantages and
    the metrics equal the JAX processor's at one process on all rows."""
    from flow_factory_tpu.advantage import AdvantageProcessor

    res = _res(world, "advantages")
    samples = [types.SimpleNamespace(unique_id=u, extra_kwargs={"rewards": dict(d)})
               for r in range(NPROCS) for u, d in _reward_rows(r)]
    metrics = AdvantageProcessor(group_size=2 * NPROCS, aggregation=agg, reward_weights={"a": 1.0, "b": 0.5},
                                 distributed_groups=True).compute_advantages(samples)
    want = [s.extra_kwargs["advantage"] for s in samples]
    for r, got in enumerate(res):
        np.testing.assert_array_equal(got[agg]["adv"], want[4 * r : 4 * r + 4])
        assert got[agg]["metrics"] == metrics


def test_eval_gather_is_global_on_every_process(world):
    """JAX ``phase_eval_gather``: the eval reward metrics over both ranks'
    samples equal the JAX function's at one process on all of them."""
    from flow_factory_tpu.trainers.abc import gather_eval_reward_metrics

    res = _res(world, "eval_gather")
    want = gather_eval_reward_metrics([types.SimpleNamespace(extra_kwargs=r)
                                       for k in range(NPROCS) for r in _eval_rows(k)])
    assert res[0] == res[1] == want and want["eval/num_samples"] == 4.0


#: the bars of tests/test_torch_port_train.py: the gradients against the JAX
#: ``_grad_fn``'s, 1e-4 of each leaf's max magnitude; the update against
#: optax's on the same gradients (its AdamW parity), 1e-6 absolute on the
#: updated weights and the norm 1e-6 relative. The update is held to optax
#: on the port's averaged gradients, not on JAX's: Adam's first step is
#: lr·g/(|g| + ε), so a gradient element near 0 turns an fp32 difference
#: of the gradients into one of up to 2·lr in the weight.
GRAD_REL, UPDATE_ATOL, GNORM_RTOL = 1e-4, 1e-6, 1e-6


def _check_step(world, phase):
    import jax
    import jax.numpy as jnp
    from flow_factory_tpu.trainers import abc as jabc

    res = _res(world, phase)
    expect = world[2]
    opt = _optax(expect["ta"])
    before = {"transformer": jax.tree.map(jnp.asarray, expect["before"])}
    for r in res:
        for path, ab in expect["grads"].items():
            for k in ("a", "b"):
                err = np.abs(r["grads"][path][k] - ab[k]).max()
                assert err <= GRAD_REL * np.abs(ab[k]).max(), (phase, path, k, err)
        want, _, gnorm = jabc._apply_updates_jit(opt, before, opt.init(before),
                                                 {"transformer": jax.tree.map(jnp.asarray, r["grads"])}, 1)
        np.testing.assert_allclose(r["gnorm"], float(gnorm), rtol=GNORM_RTOL)
        np.testing.assert_allclose(r["gnorm"], expect["gnorm"], rtol=GRAD_REL)
        for path, ab in jax.tree.map(np.asarray, want)["transformer"].items():
            for k in ("a", "b"):
                np.testing.assert_allclose(r["lora"][path][k], ab[k], atol=UPDATE_ATOL, rtol=0,
                                           err_msg=f"{phase} {path}/{k}")

    # the two ranks' trees after the update: the same bits
    for path, ab in res[0]["lora"].items():
        for k in ("a", "b"):
            assert np.array_equal(ab[k], res[1]["lora"][path][k]), (phase, path, k)
    # the step moved the LoRA
    assert any(not np.array_equal(res[0]["lora"][p]["b"], expect["before"][p]["b"]) for p in expect["before"])
    # each rank's mean loss over its rows averages to the global mean
    np.testing.assert_allclose(np.mean([r["loss"] for r in res]), expect["loss"], rtol=1e-5)
    return res


def test_grpo_step_at_replica_2_equals_jax_on_the_global_batch(world):
    """One GRPO grad step of the tiny SD3.5 at replica 2, two rows a rank,
    the gradients averaged across the replicas before the clip, then AdamW:
    the averaged gradients within ``GRAD_REL`` of the JAX ``_grad_fn``'s on
    the global batch of 4, the update within ``UPDATE_ATOL`` of optax's,
    both ranks' LoRA the same bits."""
    _check_step(world, "grpo_replica")


def test_grpo_step_at_fsdp_2_shards_by_the_jax_rule_and_matches_replica_2(world):
    """The same step at fsdp 2: each rank holds the slice of each LoRA leaf
    on the dimension JAX's ``_default_leaf_spec`` picks for the same leaf
    (``lora_A`` (r, in) is flax's ``a`` (in, r) transposed), the gathered
    LoRA after the update equals the replica-2 step's within
    ``UPDATE_ATOL``, and AdamW's state gathered whole and cut again is each
    rank's own."""
    from flow_factory_tpu.parallel.mesh import FSDP_AXIS, _default_leaf_spec

    res = _check_step(world, "grpo_fsdp")
    replica = _res(world, "grpo_replica")[0]["lora"]
    sharded = 0
    for path, ab in world[2]["before"].items():
        for k, port_key in (("a", "lora_A"), ("b", "lora_B")):
            spec = _default_leaf_spec(f"transformer/{path}/{k}", ab[k], NPROCS, [])
            want = None if FSDP_AXIS not in spec else 1 - list(spec).index(FSDP_AXIS)
            assert res[0]["dims"][f"{path[: -len('/kernel')]}/{port_key}"] == want, (path, k)
            sharded += want is not None
            np.testing.assert_allclose(res[0]["lora"][path][k], replica[path][k], atol=UPDATE_ATOL, rtol=0)
    assert sharded > 0
    assert all(r["opt_state_round_trip"] for r in res)


def test_fsdp_checkpoint_saves_from_rank_0_and_round_trips(world):
    """JAX ``phase_ckpt`` on the fsdp-2 tree: the slices gathered and written
    once; a fresh fsdp-2 adapter reads back each rank's slices bit for bit,
    and so does a one-process adapter the whole tree; the size-capped export
    of the merged weights spans several files that reassemble them."""
    import torch
    from flow_factory_tpu_torch.hparams import Arguments
    from flow_factory_tpu_torch.models import load_adapter

    res = _res(world, "grpo_fsdp")
    assert res[0]["written"] == ["adapter_config.json", "lora_transformer.safetensors"]
    assert all(r["ckpt_round_trip"] for r in res)
    assert res[0]["export_files"] > 1 and res[0]["export_equal"]
    one = load_adapter(Arguments.from_dict(copy.deepcopy(STEP_CONFIG)), device="cpu")
    one.load_checkpoint(os.path.join(world[0], "ckpt_fsdp"), resume_type="lora")
    from flow_factory_tpu_torch.utils import weights

    tcfg = one.component_configs["transformer"]
    module_map = weights.sd3_transformer_map(tcfg.depth, tcfg.dual_attention_layers)[0]
    with torch.no_grad():
        got = weights.lora_to_flax(one.trainable["transformer"], module_map)
    for path, ab in res[0]["lora"].items():
        for k in ("a", "b"):
            assert np.array_equal(got[path][k], ab[k]), (path, k)


def test_grpo_epoch_with_distributed_k_repeat(world):
    """JAX ``phase_grpo``: one GRPO epoch over ``distributed_k_repeat`` groups
    that span the ranks, with a groupwise reward beside the brightness one:
    every group has its four members across the two ranks, the ratio is
    exactly 1.0 on every grad step of each rank, and the reduced metrics are
    the same on both."""
    res = _res(world, "grpo_epoch")
    uids = [u for r in res for u in r["uids"]]
    assert sorted(uids.count(u) for u in set(uids)) == [4, 4]
    assert all(len(set(r["uids"])) == 2 for r in res)
    for r in res:
        assert r["steps"] and all(s["train/ratio_min"] == s["train/ratio_max"] == 1.0 for s in r["steps"])
    assert res[0]["info"] == res[1]["info"] and res[0]["reward_mean"] == res[1]["reward_mean"]
    assert np.isfinite(res[0]["info"]["train/loss"])


def test_dpo_pairs_across_ranks_equal_jax_form_pairs(world):
    """JAX ``phase_dpo``: the groups span the ranks; each rank's pairs are the
    JAX ``_pairs_from_advantages`` of every rank's samples at one process,
    strided by rank and cycle-padded, and both ranks run as many grad steps
    with the same reduced metrics."""
    from flow_factory_tpu.trainers.dpo import DPOTrainer as JDPO

    res = _res(world, "dpo_pairs")
    allsamples = [types.SimpleNamespace(unique_id=u, extra_kwargs={"advantage": a, "_origin": (r, i)})
                  for r in range(NPROCS) for i, (u, a) in enumerate(res[r]["samples"])]
    pairs = [(c.extra_kwargs["_origin"], l.extra_kwargs["_origin"]) for c, l in JDPO._pairs_from_advantages(allsamples)]
    target = -(-len(pairs) // NPROCS)
    assert pairs
    for r in range(NPROCS):
        mine = pairs[r::NPROCS]
        mine = (mine * target)[:target]
        assert [tuple(map(tuple, p)) for p in res[r]["pairs"]] == [tuple(map(tuple, p)) for p in mine]
    assert len(res[0]["steps"]) == len(res[1]["steps"]) > 0
    assert res[0]["info"] == res[1]["info"] and res[0]["info"]["train/dpo_num_pairs"] == len(pairs)
    assert all(np.isfinite(s["train/loss"]) for r in res for s in r["steps"])


def test_nft_epoch_at_replica_2_keeps_the_step_0_invariant(world):
    """JAX ``phase_nft``: one NFT epoch (β 1, every grad step before the one
    optimizer step, so θ is the old policy on each): positive and negative
    losses equal on every grad step of each rank; the reduced losses finite
    and the same on both."""
    res = _res(world, "nft")
    for r in res:
        assert len(r["steps"]) == len(res[0]["steps"]) > 0
        assert all(s["train/positive_loss"] == s["train/negative_loss"] for s in r["steps"]), r["steps"]
    assert res[0]["info"] == res[1]["info"]
    assert all(np.isfinite(v) for v in res[0]["info"].values())


def test_awm_epoch_at_replica_2_and_crd_refused_by_name(world):
    """AWM runs at replica 2 (JAX ``phase_awm``): every grad step before the
    one optimizer step, so each row's weighted log-prob equals the old one:
    ratio exactly 1.0 and no clipping on every grad step of each rank, the
    reduced losses the same on both. CRD's centering is a softmax over the
    global micro-batch: above one replica it raises by name, naming its
    ROADMAP item, on both ranks."""
    res = _res(world, "awm")
    for r in res:
        assert r["steps"] and len(r["steps"]) == len(res[0]["steps"])
        assert all(s["train/ratio_mean"] == 1.0 and s["train/clip_frac"] == 0.0 for s in r["steps"]), r["steps"]
    assert res[0]["info"] == res[1]["info"] and all(np.isfinite(v) for v in res[0]["info"].values())
    crd = _res(world, "crd")
    assert all(msg and "CRD over 2 data-parallel replicas" in msg and "item 24" in msg for msg in crd), crd


def test_dgpo_epoch_at_replica_2_keeps_the_step_0_invariants(world):
    """JAX ``phase_dgpo`` on ``tests/fixtures/smoke_dgpo.yaml`` at 2 rows a
    rank: ``group_distributed`` puts one member of each group on each rank,
    the group sums run over both, and at θ = ``ema_ref`` = the reference
    pref_mean is exactly 0, group_weight_mean exactly 0.5, kl and
    clip_ratio exactly 0 on every grad step; the reduced losses the same."""
    res = _res(world, "dgpo")
    assert res[0]["sampler"] == "group_distributed" and res[0]["uids"] == res[1]["uids"]
    for r in res:
        assert r["steps"]
        for s in r["steps"]:
            assert (s["train/pref_mean"], s["train/group_weight_mean"], s["train/kl"], s["train/clip_ratio"]) == \
                (0.0, 0.5, 0.0, 0.0), s
    assert res[0]["info"] == res[1]["info"]
    assert all(np.isfinite(v) for v in res[0]["info"].values())


if __name__ == "__main__" and len(sys.argv) > 1 and sys.argv[1] == "worker":
    sys.path.insert(0, REPO)
    worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5].split(","), sys.argv[6])
