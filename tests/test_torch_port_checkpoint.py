"""PyTorch port, checkpoints and resume: the port's own safetensors reader and
writer against the ``safetensors`` package; LoRA, full and training-state
saves that load back bit-equal; a LoRA file the JAX package wrote, loaded
through the weight bridge; full checkpoints split into the JAX package's
shards; ``model.resume_path``; SIGTERM preemption with the JAX package's
"redo the interrupted epoch" rule; and a resumed epoch bit-equal to the
same epoch of an uninterrupted run. On the CPU, on the smoke config
(tests/fixtures/smoke_grpo.yaml) with EMA on.

The JAX package's periodic ``epoch_{n}`` save records epoch n although
epoch n has not run, so a resume from it skips an epoch (F7), and its resume
drops the EMA state, which the port restores (F8): both are pinned here.
"""
import copy
import gc
import json
import os
import signal
import struct
import weakref

import jax
import numpy as np
import pytest
import torch
from torch_port_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests/fixtures/smoke_grpo.yaml")
STATE = os.path.join("train_state", "state.pt")


@pytest.fixture(autouse=True, scope="module")
def _isolated():
    """The JAX package's world-size override is process-wide: reset it before
    and after this module (another module on the worker may have left it
    set). ``_restore_sigterm`` puts SIGTERM back after each test."""
    from flow_factory_tpu.parallel.dist import set_world_size_override

    set_world_size_override(None)
    yield
    set_world_size_override(None)


@pytest.fixture(autouse=True)
def _restore_sigterm():
    prev = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, prev)


# ---------------------------------------------------------------------------
# safetensors I/O
# ---------------------------------------------------------------------------

def _tensors(dtype):
    g = torch.Generator().manual_seed(3)
    return {"w": torch.randn(5, 3, generator=g).to(dtype), "b": torch.randn(7, generator=g).to(dtype),
            "s": torch.randn((), generator=g).to(dtype), "empty": torch.zeros(0, 4, dtype=dtype),
            "i": torch.arange(6).reshape(2, 3)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
@pytest.mark.parametrize("metadata", [None, {}, {"format": "pt"}])
def test_safetensors_round_trip_both_ways(tmp_path, dtype, metadata):
    """The port's file is byte-equal to the safetensors package's for the
    same tensors; each reads the other's back bit-equal (numpy's reader too,
    where numpy has the dtype)."""
    import safetensors
    import safetensors.numpy
    import safetensors.torch

    from flow_factory_tpu_torch.utils.safetensors_io import load_file, save_file

    ts = _tensors(dtype)
    ours, theirs = tmp_path / "ours.safetensors", tmp_path / "theirs.safetensors"
    save_file(ts, ours, metadata=metadata)
    safetensors.torch.save_file(ts, str(theirs), metadata=metadata)
    assert ours.read_bytes() == theirs.read_bytes()
    with safetensors.safe_open(str(ours), framework="pt") as f:
        assert f.metadata() == metadata
    for got in (safetensors.torch.load_file(str(ours)), load_file(theirs), load_file(ours)):
        assert list(got) == list(safetensors.torch.load_file(str(theirs)))
        for k, t in ts.items():
            assert got[k].dtype == t.dtype and torch.equal(got[k], t), k
    if dtype != torch.bfloat16:
        arrays = {k: t.numpy() for k, t in ts.items()}
        np_path = tmp_path / "np.safetensors"
        safetensors.numpy.save_file(arrays, str(np_path))
        back = safetensors.numpy.load_file(str(ours))
        for k, a in arrays.items():
            assert back[k].dtype == a.dtype and np.array_equal(back[k], a)
            assert torch.equal(load_file(np_path)[k], ts[k])


def test_safetensors_reads_an_odd_header_length_and_no_tensors(tmp_path):
    """A header whose length is not a multiple of 8 (another writer's) reads
    in both readers; a file of no tensors round-trips; metadata of several
    keys reads back in both (the package orders them as it likes); a
    truncated file raises."""
    import safetensors
    import safetensors.torch

    from flow_factory_tpu_torch.utils.safetensors_io import load_file, save_file

    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    header = json.dumps({"x": {"dtype": "F32", "shape": [2, 3], "data_offsets": [0, 24]}}).encode()
    if len(header) % 8 == 0:
        header += b" "
    assert len(header) % 8
    path = tmp_path / "odd.safetensors"
    path.write_bytes(struct.pack("<Q", len(header)) + header + t.numpy().tobytes())
    assert torch.equal(load_file(path)["x"], t)
    assert torch.equal(safetensors.torch.load_file(str(path))["x"], t)
    meta = {"format": "pt", "note": "x", "epoch": "3"}
    save_file({"x": t}, tmp_path / "meta.safetensors", metadata=meta)
    with safetensors.safe_open(str(tmp_path / "meta.safetensors"), framework="pt") as f:
        assert f.metadata() == meta
    save_file({}, tmp_path / "none.safetensors")
    assert load_file(tmp_path / "none.safetensors") == safetensors.torch.load_file(str(tmp_path / "none.safetensors")) == {}
    path.write_bytes(path.read_bytes()[:-4])
    with pytest.raises(ValueError):
        load_file(path)


# ---------------------------------------------------------------------------
# Adapter saves and loads
# ---------------------------------------------------------------------------

TINY = {
    "data": {"dataset_dir": "tests/fixtures/tiny_prompts"},
    "model": {"model_type": "sd3-5", "model_name_or_path": "tiny", "variant": "tiny",
              "finetune_type": "lora", "lora_rank": 4, "lora_alpha": 8, "attn_backend": "auto",
              "master_dtype": "float32", "inference_dtype": "float32"},
    "scheduler": {"dynamics_type": "Flow-SDE", "noise_level": 0.7, "num_sde_steps": 2, "sde_steps": [0, 1, 2]},
    "train": {"trainer_type": "grpo", "resolution": 32, "num_inference_steps": 4, "guidance_scale": 2.0,
              "per_device_batch_size": 2, "group_size": 2, "unique_sample_num_per_epoch": 1,
              "latent_storage_dtype": "fp32", "ema_decay": 0},
    "eval": {}, "log": {}, "rewards": [],
}


def _port_adapter(**model):
    from flow_factory_tpu_torch.hparams import Arguments
    from flow_factory_tpu_torch.models import load_adapter

    cfg = copy.deepcopy(TINY)
    cfg["model"].update(model)
    return load_adapter(Arguments.from_dict(cfg), device="cpu")


def _randomize(tree, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for t in (v for node in tree.values() for v in (node.values() if isinstance(node, dict) else [node])):
            t.copy_(torch.randn(t.shape, generator=g))


def _assert_trees_equal(a, b):
    assert list(a) == list(b)
    for k in a:
        if isinstance(a[k], dict):
            _assert_trees_equal(a[k], b[k])
        else:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k].detach(), b[k].detach()), k


def test_lora_save_load_bit_equal_with_the_port_names(tmp_path):
    """``lora_transformer.safetensors`` holds ``<module path>.lora_A.weight``
    / ``.lora_B.weight``; ``adapter_config.json`` the JAX package's five
    fields; the tree loads back bit-equal, found by the directory's contents."""
    pa = _port_adapter()
    _randomize(pa.trainable["transformer"], 0)
    pa.save_checkpoint(str(tmp_path))
    cfg = json.load(open(tmp_path / "adapter_config.json"))
    assert cfg == {"finetune_type": "lora", "lora_rank": 4, "lora_alpha": 8, "components": ["transformer"],
                   "model_type": "sd3-5"}
    from flow_factory_tpu_torch.utils.safetensors_io import load_file

    names = set(load_file(tmp_path / "lora_transformer.safetensors"))
    assert names == {f"{p}.{k}.weight" for p in pa.trainable["transformer"] for k in ("lora_A", "lora_B")}
    fresh = _port_adapter()
    fresh.load_checkpoint(str(tmp_path))
    _assert_trees_equal(fresh.trainable, pa.trainable)
    assert all(v.requires_grad for ab in fresh.trainable["transformer"].values() for v in ab.values())


def test_full_save_splits_in_shards_and_loads_back(tmp_path, monkeypatch):
    """Full weights under a forced small shard cap: several shards, indexed
    by ``model_index.json``, each within the cap unless it is one tensor, and
    a bit-equal load."""
    from flow_factory_tpu_torch.models.abc import BaseAdapter

    monkeypatch.setattr(BaseAdapter, "MAX_SHARD_BYTES", 64 * 1024)
    pa = _port_adapter(finetune_type="full")
    _randomize(pa.trainable["transformer"], 1)
    pa.save_checkpoint(str(tmp_path))
    index = json.load(open(tmp_path / "model_index.json"))
    files = sorted(set(index["weight_map"].values()))
    assert len(files) > 3 and all(f.startswith("transformer-") for f in files)
    assert set(index["weight_map"]) == {f"transformer/{n}" for n in pa.trainable["transformer"]}
    from flow_factory_tpu_torch.utils.safetensors_io import load_file

    for f in files:
        shard = load_file(tmp_path / f)
        assert len(shard) == 1 or sum(t.nbytes for t in shard.values()) <= 64 * 1024
    fresh = _port_adapter(finetune_type="full")
    fresh.load_checkpoint(str(tmp_path))
    _assert_trees_equal(fresh.trainable, pa.trainable)


def test_export_merged_loads_into_a_full_finetune(tmp_path):
    """``export_merged`` of a LoRA adapter writes every transformer weight,
    the targeted ones merged; a full-finetune adapter reads them back."""
    pa = _port_adapter()
    _randomize(pa.trainable["transformer"], 2)
    pa.export_merged(str(tmp_path))
    full = _port_adapter(finetune_type="full", resume_path=str(tmp_path), resume_type="full")
    merged = pa.merged_params("transformer")
    for name, w in full.trainable["transformer"].items():
        want = merged.get(name, pa.modules["transformer"].get_parameter(name))
        assert torch.equal(w.detach(), want.detach()), name


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """One JAX GRPO run of the smoke config: EMA on, a full-state save every
    epoch (``epoch_1`` at the head of epoch 1, then ``final``)."""
    from flow_factory_tpu.hparams.args import Arguments
    from flow_factory_tpu.trainers import load_trainer

    root = tmp_path_factory.mktemp("jax_run")
    cfg = Arguments.load_from_yaml(FIXTURE)
    cfg.data_args.cache_dir = str(root / "cache")
    cfg.log_args.save_dir = str(root / "saves")
    cfg.log_args.save_freq = 1
    cfg.log_args.save_model_only = False
    cfg.training_args.ema_decay = 0.9
    cfg.training_args.ema_update_interval = 1
    trainer = load_trainer(cfg)
    trainer.start()
    return cfg, trainer, root / "saves" / cfg.log_args.run_name


def test_jax_lora_file_loads_through_the_bridge(jax_run, tmp_path):
    """The JAX package's LoRA file (``<flax path>/kernel/a``, ``/b``) read by
    the port at construction (``resume_path``): on the JAX adapter's frozen
    weights the merged weights equal the JAX merge (fp32, 1e-6), and the
    port's own save of it holds the JAX file's tensors under the bridge's
    names, transposed, bit-equal."""
    from safetensors.numpy import load_file as np_load

    from flow_factory_tpu.models.lora import merge_lora as jmerge
    from flow_factory_tpu_torch.utils import weights
    from flow_factory_tpu_torch.utils.safetensors_io import load_file

    _, jt, run_dir = jax_run
    jax_file = np_load(str(run_dir / "final" / "lora_transformer.safetensors"))
    assert all(k.endswith(("/kernel/a", "/kernel/b")) for k in jax_file)
    pa = _port_adapter(resume_path=str(run_dir / "final"), resume_type="lora")
    flax_params = jax.tree.map(np.asarray, jax.device_get(jt.adapter.params))
    pa.load_state_dicts(weights.sd35_state_dicts(flax_params, pa.component_configs))
    module_map = pa.weight_maps()["transformer"][0]

    pa.save_checkpoint(str(tmp_path), save_ema=False)
    ours = load_file(tmp_path / "lora_transformer.safetensors")
    assert len(ours) == len(jax_file)
    for key, arr in jax_file.items():
        path, leaf = key.rsplit("/", 1)
        port_key = f"{module_map[path[: -len('/kernel')]]}.lora_{'A' if leaf == 'a' else 'B'}.weight"
        assert np.array_equal(ours[port_key].numpy(), arr.T), key

    ema = jax.tree.map(np.asarray, jax.device_get(jt.adapter.ema_trainable["transformer"]))
    theirs = weights.convert(jax.tree.map(np.asarray, jmerge(jt.adapter.params["transformer"], ema,
                                                             jt.adapter.lora_scale)),
                             *pa.weight_maps()["transformer"])
    merged = pa.merged_params("transformer")
    assert merged
    for name, w in merged.items():
        np.testing.assert_allclose(w.detach().numpy(), theirs[name].numpy(), atol=1e-6, rtol=0, err_msg=name)


def test_full_shards_match_the_jax_split(tmp_path, monkeypatch):
    """The same tensors in the same order split into the same shards as the
    JAX package's full save, at several forced caps (the JAX transformer's
    tree, carried to the port's names by the bridge)."""
    from flow_factory_tpu.hparams.args import Arguments as JArgs
    from flow_factory_tpu.models import load_adapter as jax_load
    from flow_factory_tpu.models.abc import BaseAdapter as JBase
    from flow_factory_tpu_torch.models.abc import BaseAdapter
    from flow_factory_tpu_torch.utils import weights

    cfg = copy.deepcopy(TINY)
    cfg["model"]["finetune_type"] = "full"
    ja = jax_load(JArgs.from_dict(cfg))
    pa = _port_adapter(finetune_type="full")
    flat = ja._flat_numpy(ja.trainable["transformer"])
    tree = {"transformer": weights.convert(flat, *pa.weight_maps()["transformer"])}
    assert len(tree["transformer"]) == len(flat)
    for cap in (20_000, 100_000, 300_000):
        monkeypatch.setattr(JBase, "MAX_SHARD_BYTES", cap)
        monkeypatch.setattr(BaseAdapter, "MAX_SHARD_BYTES", cap)
        os.makedirs(tmp_path / f"jax{cap}")
        os.makedirs(tmp_path / f"port{cap}")
        ja._save_full(str(tmp_path / f"jax{cap}"), ja.trainable)
        pa._save_full(str(tmp_path / f"port{cap}"), tree)
        jmap = json.load(open(tmp_path / f"jax{cap}" / "model_index.json"))["weight_map"]
        pmap = json.load(open(tmp_path / f"port{cap}" / "model_index.json"))["weight_map"]
        assert len(set(jmap.values())) == len(set(pmap.values())) > 1
        assert sorted(os.listdir(tmp_path / f"jax{cap}")) == sorted(os.listdir(tmp_path / f"port{cap}"))
        assert list(jmap.values()) == list(pmap.values())


# ---------------------------------------------------------------------------
# Trainer: resume, preemption
# ---------------------------------------------------------------------------

def _port_config(root, run, **log):
    from flow_factory_tpu_torch.hparams import Arguments

    cfg = Arguments.load_from_yaml(FIXTURE)
    cfg.data_args.cache_dir = str(root / "cache")
    cfg.log_args.save_dir = str(root / "saves")
    cfg.log_args.run_name = run
    cfg.training_args.ema_decay = 0.9
    cfg.training_args.ema_update_interval = 1
    for k, v in log.items():
        setattr(cfg.log_args, k, v)
    return cfg


def _port_trainer(cfg):
    from flow_factory_tpu_torch.trainers import load_trainer

    return load_trainer(cfg, device="cpu")


def _rows(cfg):
    path = os.path.join(cfg.log_args.save_dir, cfg.log_args.run_name, "metrics.jsonl")
    return [r for r in map(json.loads, open(path)) if "media_tag" not in r]


@pytest.fixture(scope="module")
def port_root(tmp_path_factory):
    return tmp_path_factory.mktemp("port")


@pytest.fixture(scope="module")
def uninterrupted(port_root):
    """Two epochs without a break: the reference the resumed runs match."""
    cfg = _port_config(port_root, "whole")
    trainer = _port_trainer(cfg)
    trainer.start()
    return cfg, trainer


@pytest.fixture(scope="module")
def preempted_after_epoch_0(port_root):
    """Epoch 0 completes, then a preemption request cuts epoch 1 at its head."""
    cfg = _port_config(port_root, "after_epoch_0")
    trainer = _port_trainer(cfg)
    optimize = trainer.optimize

    def hooked(samples, epoch):
        out = optimize(samples, epoch)
        trainer.request_preempt()
        return out

    trainer.optimize = hooked
    trainer.start()
    return cfg, trainer, os.path.join(cfg.log_args.save_dir, cfg.log_args.run_name, "preempt")


def test_preempt_after_epoch_0_records_epoch_0(preempted_after_epoch_0):
    cfg, trainer, pdir = preempted_after_epoch_0
    assert trainer.epoch == 1 and trainer.global_step == 1
    assert sorted(os.listdir(pdir)) == ["adapter_config.json", "lora_transformer.safetensors", "train_state"]
    state = torch.load(os.path.join(pdir, STATE), weights_only=True)
    assert state["epoch"] == 0 and state["global_step"] == 1
    assert set(state) == {"trainable", "ema", "opt_state", "epoch", "global_step"}
    assert [r["step"] for r in _rows(cfg)] == [0]


def test_resume_restores_the_state_bit_equal(preempted_after_epoch_0, port_root):
    """``resume_path`` at construction: the trainable tree, the EMA params
    and step, and every AdamW state tensor equal the file's; epoch 1 next."""
    _, trainer, pdir = preempted_after_epoch_0
    state = torch.load(os.path.join(pdir, STATE), weights_only=True)
    cfg = _port_config(port_root, "resumed_check")
    cfg.model_args.resume_path = pdir
    resumed = _port_trainer(cfg)
    assert resumed.epoch == 1 and resumed.global_step == 1
    _assert_trees_equal(resumed.adapter.trainable, state["trainable"])
    _assert_trees_equal(resumed.adapter.ema.params, state["ema"]["params"])
    assert resumed.adapter.ema.step == state["ema"]["step"] == trainer.adapter.ema.step == 0
    live = resumed.optimizer.state_dict()
    assert live["param_groups"] == state["opt_state"]["param_groups"]
    assert len(live["state"]) == len(state["opt_state"]["state"]) == len(resumed.adapter.trainable_leaves())
    for i, s in state["opt_state"]["state"].items():
        assert set(live["state"][i]) == set(s)
        for k, t in s.items():
            assert torch.equal(live["state"][i][k], t), (i, k)
    # the optimizer steps the resumed leaves themselves
    assert [p for g in resumed.optimizer.param_groups for p in g["params"]] == resumed.adapter.trainable_leaves()
    # and holds the state alone: the adapter drops the copy it read
    assert resumed.adapter._restored_state == {}
    resumed.cleanup()


def test_resumed_epoch_is_bit_equal_to_the_uninterrupted_one(preempted_after_epoch_0, uninterrupted, port_root):
    """Resumed at epoch 1, the epoch's rewards, advantages, losses, ratios and
    grad norm, and the LoRA and EMA after its update, equal the
    uninterrupted run's bit for bit."""
    _, _, pdir = preempted_after_epoch_0
    whole_cfg, whole = uninterrupted
    cfg = _port_config(port_root, "resumed")
    cfg.model_args.resume_path = pdir
    resumed = _port_trainer(cfg)
    resumed.start()
    (row,) = _rows(cfg)
    want = _rows(whole_cfg)[1]
    assert row["step"] == want["step"] == 1
    drop = ("time", "time/epoch_s")
    assert {k: v for k, v in row.items() if k not in drop} == {k: v for k, v in want.items() if k not in drop}
    assert row["train/ratio_min"] == row["train/ratio_max"] == 1.0
    _assert_trees_equal(resumed.adapter.trainable, whole.adapter.trainable)
    _assert_trees_equal(resumed.adapter.ema.params, whole.adapter.ema.params)
    assert resumed.global_step == whole.global_step == 2
    assert not os.path.exists(os.path.join(cfg.log_args.save_dir, "resumed", "preempt"))


def test_sigterm_mid_epoch_saves_redoes_the_epoch_and_restores_the_handler(port_root, uninterrupted):
    """A real SIGTERM during epoch 0's feedback: the handler absorbs it, the
    first micro-batch converts it into a state save recording epoch −1 (no
    optimizer step ran), ``start`` returns, and the previous handler is back.
    The resume redoes epoch 0 and matches the uninterrupted run."""
    seen = []

    def outer(signum, frame):
        seen.append(signum)

    prev = signal.signal(signal.SIGTERM, outer)
    cfg = _port_config(port_root, "mid_epoch")
    trainer = _port_trainer(cfg)
    feedback = trainer.prepare_feedback

    def hooked(samples):
        os.kill(os.getpid(), signal.SIGTERM)  # absorbed: the process lives on
        return feedback(samples)

    trainer.prepare_feedback = hooked
    trainer.start()
    assert signal.getsignal(signal.SIGTERM) is outer and not seen
    signal.signal(signal.SIGTERM, prev)
    pdir = os.path.join(cfg.log_args.save_dir, "mid_epoch", "preempt")
    state = torch.load(os.path.join(pdir, STATE), weights_only=True)
    assert state["epoch"] == -1 and state["global_step"] == 0 and trainer.global_step == 0
    assert not os.path.exists(os.path.join(cfg.log_args.save_dir, "mid_epoch", "metrics.jsonl")) or not _rows(cfg)

    cfg2 = _port_config(port_root, "mid_epoch_resumed")
    cfg2.model_args.resume_path = pdir
    resumed = _port_trainer(cfg2)
    assert resumed.epoch == 0 and resumed.global_step == 0
    resumed.start()
    assert resumed.epoch == 1 and resumed.global_step == 2
    _assert_trees_equal(resumed.adapter.trainable, uninterrupted[1].adapter.trainable)


def test_cleanup_restores_the_handler_and_an_installed_handler_holds_no_trainer(port_root):
    """``cleanup`` without ``start`` puts the previous SIGTERM handler back;
    a trainer whose handler is still installed is freed once dropped (the
    handler holds the preemption flag, not the trainer), and its handler
    still turns a signal into a request, absorbed."""
    def outer(signum, frame):
        pass

    signal.signal(signal.SIGTERM, outer)
    trainer = _port_trainer(_port_config(port_root, "cleanup_only"))
    assert signal.getsignal(signal.SIGTERM) is not outer
    trainer.cleanup()
    assert signal.getsignal(signal.SIGTERM) is outer

    trainer = _port_trainer(_port_config(port_root, "dropped"))
    handler, event, ref = signal.getsignal(signal.SIGTERM), trainer._preempt_event, weakref.ref(trainer)
    del trainer
    gc.collect()
    assert ref() is None and signal.getsignal(signal.SIGTERM) is handler
    os.kill(os.getpid(), signal.SIGTERM)
    assert event.is_set()


def test_unfitting_optimizer_state_warns_and_is_skipped(preempted_after_epoch_0, port_root, caplog):
    """An optimizer state of other parameter counts or shapes is not loaded
    (the JAX package's warning path); the epoch and step still are."""
    from flow_factory_tpu_torch.trainers.abc import _optimizer_state_fits

    _, _, pdir = preempted_after_epoch_0
    trainer = _port_trainer(_port_config(port_root, "unfit"))
    state = torch.load(os.path.join(pdir, STATE), weights_only=True)
    assert _optimizer_state_fits(trainer.optimizer, state["opt_state"])
    bad = copy.deepcopy(state["opt_state"])
    bad["param_groups"][0]["params"] = bad["param_groups"][0]["params"][:-1]
    assert not _optimizer_state_fits(trainer.optimizer, bad)
    bad = copy.deepcopy(state["opt_state"])
    bad["state"][0]["exp_avg"] = torch.zeros(3, 3)
    assert not _optimizer_state_fits(trainer.optimizer, bad)
    before = {i: {k: v.clone() for k, v in s.items()} for i, s in trainer.optimizer.state_dict()["state"].items()}
    trainer.adapter._restored_state = {"opt_state": bad, "epoch": 4, "global_step": 9}
    with caplog.at_level("WARNING"):
        trainer._restore_state_if_any()
    assert "NOT restored" in caplog.text and trainer.epoch == 5 and trainer.global_step == 9
    for i, s in trainer.optimizer.state_dict()["state"].items():
        assert all(torch.equal(v, before[i][k]) for k, v in s.items())


def test_periodic_save_records_its_own_epoch_in_both_packages(jax_run, port_root):
    """F7, pinned: ``epoch_1`` is saved at the head of epoch 1, before it
    runs, and records epoch 1, so a resume from it starts at epoch 2 — in
    the JAX package and in the port alike. The final save records the last
    epoch."""
    from flow_factory_tpu.trainers import load_trainer as jax_load_trainer

    jcfg, jt, jdir = jax_run
    cfg = _port_config(port_root, "periodic", save_freq=1, save_model_only=False)
    trainer = _port_trainer(cfg)
    trainer.start()
    pdir = os.path.join(cfg.log_args.save_dir, "periodic")
    assert sorted(os.listdir(pdir)) == sorted(os.listdir(jdir)) == ["epoch_1", "final", "media", "metrics.jsonl"]
    for sub in ("epoch_1", "final"):
        assert sorted(os.listdir(os.path.join(pdir, sub))) == sorted(os.listdir(jdir / sub))
    assert torch.load(os.path.join(pdir, "epoch_1", STATE), weights_only=True)["epoch"] == 1
    assert torch.load(os.path.join(pdir, "final", STATE), weights_only=True)["epoch"] == 1

    jres = copy.deepcopy(jcfg)
    jres.log_args.run_name = "jax_resumed"
    jres.model_args.resume_path = str(jdir / "epoch_1")
    j_resumed = jax_load_trainer(jres)
    pres = _port_config(port_root, "periodic_resumed")
    pres.model_args.resume_path = os.path.join(pdir, "epoch_1")
    p_resumed = _port_trainer(pres)
    assert j_resumed.epoch == p_resumed.epoch == 2
    assert j_resumed.global_step == p_resumed.global_step == 1
    # F8, pinned: the JAX resume starts the EMA afresh from the weights (step
    # 0); the port restores the saved EMA
    jl = jax.tree.leaves(j_resumed.adapter.ema.params)
    assert j_resumed.adapter.ema.step == 0
    assert all(np.array_equal(np.asarray(a), np.asarray(b))
               for a, b in zip(jl, jax.tree.leaves(j_resumed.adapter.trainable)))
    saved = torch.load(os.path.join(pdir, "epoch_1", STATE), weights_only=True)["ema"]
    assert p_resumed.adapter.ema.step == saved["step"] == 0  # epoch 0's update is the EMA's step 0
    _assert_trees_equal(p_resumed.adapter.ema.params, saved["params"])
    p_resumed.cleanup()
    j_resumed.cleanup()
