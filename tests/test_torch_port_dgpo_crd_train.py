"""PyTorch port, the adapter's named parameter snapshots and the DGPO and CRD
trainers end to end, on the CPU: the snapshot API (add, get, blend, set,
remove, has) against the JAX adapter's on a LoRA tree (tiny SD3.5) and a
full tree (tiny Wan, full finetuning); two epochs of each trainer through
``load_trainer`` on tests/fixtures/smoke_dgpo.yaml and smoke_crd_wan.yaml
with the exact step-0 invariants that the card checks, each epoch's
rollout policy, and the grad steps' timesteps against the JAX package's
bit for bit, then a save and a resume, after which the snapshots are
rebuilt from the restored weights, in both packages (no checkpoint holds
them, ROADMAP F14); and the trainer registry over all seven JAX trainer
types."""
import copy
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_threads import one_torch_thread  # noqa: F401

from test_torch_port_train import CONFIG as SD35_CONFIG
from test_torch_port_wan_train import CONFIG as WAN_CONFIG

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _isolated():
    """The JAX package's world-size override is process-wide: reset it before
    and after this module (F0)."""
    from flow_factory_tpu.parallel.dist import set_world_size_override

    set_world_size_override(None)
    yield
    set_world_size_override(None)


@pytest.fixture(autouse=True)
def _restore_sigterm():
    prev = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, prev)


def _host(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _jax_adapter(config):
    from flow_factory_tpu.hparams.args import Arguments as JArgs
    from flow_factory_tpu.models import load_adapter as jax_load
    from flow_factory_tpu.parallel.dist import set_world_size_override

    set_world_size_override(1)
    try:
        return jax_load(JArgs.from_dict(copy.deepcopy(config)))
    finally:
        set_world_size_override(None)


def _port_adapter(config):
    from flow_factory_tpu_torch.hparams import Arguments
    from flow_factory_tpu_torch.models import load_adapter

    return load_adapter(Arguments.from_dict(copy.deepcopy(config)), device="cpu")


def _lora_bridge(pa):
    from flow_factory_tpu_torch.utils import weights

    cfg = pa.component_configs["transformer"]
    module_map = weights.sd3_transformer_map(cfg.depth, cfg.dual_attention_layers)[0]
    return (lambda tree: weights.lora_from_flax(tree, module_map)), module_map


def _full_bridge(pa):
    from flow_factory_tpu_torch.utils import weights

    maps = weights.wan_transformer_map(pa.component_configs["transformer"].num_layers)
    return lambda tree: weights.full_from_flax(tree, maps)


def _flat(tree):
    """{path: fp32 numpy} of a port tree (LoRA ``{path: {lora_A, lora_B}}`` or
    full ``{name: tensor}``)."""
    out = {}
    for name, v in tree.items():
        for k, t in (v.items() if isinstance(v, dict) else [("", v)]):
            out[f"{name}.{k}"] = t.detach().float().numpy()
    return out


def _max_diff(a, b):
    fa, fb = _flat(a), _flat(b)
    assert set(fa) == set(fb)
    return max(float(np.abs(fa[k] - fb[k]).max()) for k in fa)


@pytest.mark.parametrize("kind", ["lora", "full"])
def test_named_snapshots_match_jax(kind):
    """On the tiny SD3.5 LoRA tree and the tiny Wan full tree, both adapters
    on the same θ: ``add`` copies θ (fp32, detached), ``get`` returns it;
    after θ moves, ``update(blend=0.3)`` gives s·0.3 + θ·0.7 equal to the
    JAX adapter's within 1e-7 (and to the expression in fp32 bit for bit);
    a store added with decay 0.5 and interval 1 blends at 0.5 on
    ``update(step=1)``; ``set`` copies θ again; a tree taken before a blend
    keeps its values; ``remove`` and ``has`` agree with JAX's."""
    if kind == "lora":
        ja = _jax_adapter(SD35_CONFIG)
        pa = _port_adapter(SD35_CONFIG)
        to_port = _lora_bridge(pa)[0]
        rng = np.random.default_rng(3)
        theta0 = {p: {"a": ab["a"], "b": (0.05 * rng.standard_normal(ab["b"].shape)).astype(np.float32)}
                  for p, ab in _host(ja.trainable["transformer"]).items()}
        move = lambda tree: {p: {"a": ab["a"] + np.float32(0.01), "b": ab["b"] * np.float32(1.7)}
                             for p, ab in tree.items()}
        set_port = lambda tree: pa.load_lora("transformer", to_port(tree))
    else:
        config = copy.deepcopy(WAN_CONFIG)
        config["model"]["finetune_type"] = "full"
        ja = _jax_adapter(config)
        pa = _port_adapter(config)
        to_port = _full_bridge(pa)
        theta0 = _host(ja.trainable["transformer"])
        rng = np.random.default_rng(4)
        move = lambda tree: jax.tree.map(
            lambda x: (x + 0.01 * rng.standard_normal(x.shape)).astype(np.float32), tree)

        def set_port(tree):
            pa.trainable = {"transformer": {k: v.clone().requires_grad_() for k, v in to_port(tree).items()}}

    ja.trainable = {"transformer": jax.tree.map(jnp.asarray, theta0)}
    set_port(theta0)
    for ad in (ja, pa):
        ad.add_named_parameters("s")
        ad.add_named_parameters("e", decay=0.5, update_interval=1)
        assert ad.has_named_parameters("s") and not ad.has_named_parameters("t")
    snap = pa.get_named_parameters("s")["transformer"]
    assert _max_diff(snap, pa.trainable["transformer"]) == 0.0
    assert all(not t.requires_grad for t in pa.trainable_leaves(pa.get_named_parameters("s")))
    assert _max_diff(to_port(_host(ja.get_named_parameters("s")["transformer"])), snap) == 0.0

    theta1 = move(theta0)
    ja.trainable = {"transformer": jax.tree.map(jnp.asarray, theta1)}
    set_port(theta1)
    before = pa.get_named_parameters("s")
    for ad in (ja, pa):
        ad.update_named_parameters("s", blend=0.3)
        ad.update_named_parameters("e", step=1)
    keep, take = np.float32(0.3), np.float32(1.0) - np.float32(0.3)
    want = {k: v * keep + t * take for (k, v), t in zip(_flat(before["transformer"]).items(),
                                                       _flat(pa.trainable["transformer"]).values())}
    got = _flat(pa.get_named_parameters("s")["transformer"])
    assert all(np.array_equal(got[k], want[k]) for k in want)
    assert _max_diff(before["transformer"], snap) == 0.0  # the tree taken before the blend
    for name in ("s", "e"):
        ours = pa.get_named_parameters(name)["transformer"]
        assert _max_diff(to_port(_host(ja.get_named_parameters(name)["transformer"])), ours) <= 1e-7
    assert _max_diff(pa.get_named_parameters("s")["transformer"], snap) > 0

    for ad in (ja, pa):
        ad.set_named_parameters("s")
        ad.remove_named_parameters("e")
        ad.remove_named_parameters("never-added")
        assert ad.has_named_parameters("s") and not ad.has_named_parameters("e")
        with pytest.raises(KeyError):
            ad.get_named_parameters("e")
    assert _max_diff(pa.get_named_parameters("s")["transformer"], pa.trainable["transformer"]) == 0.0


# ---------------------------------------------------------------------------
# Two epochs through load_trainer
# ---------------------------------------------------------------------------

def _config(name, tmp_path, **train):
    from flow_factory_tpu_torch.hparams import Arguments

    cfg = Arguments.load_from_yaml(os.path.join(REPO, "tests", "fixtures", f"{name}.yaml"))
    cfg.data_args.cache_dir = str(tmp_path / "cache")
    cfg.log_args.save_dir = str(tmp_path / "saves")
    for k, v in train.items():
        setattr(cfg.training_args, k, v)
    return cfg


def _jax_trainer(cls_path, name):
    """A bare JAX trainer of ``cls_path`` on the fixture's config, for its
    timestep functions."""
    import importlib

    from flow_factory_tpu.hparams.args import Arguments as JArgs

    module, cls = cls_path.split(":")
    tr = object.__new__(getattr(importlib.import_module(module), cls))
    tr.config = JArgs.load_from_yaml(os.path.join(REPO, "tests", "fixtures", f"{name}.yaml"))
    tr.training_args = tr.config.training_args
    return tr


def _recorded_run(trainer, snapshot):
    """Run ``trainer`` for its epochs, recording each grad step's aux metrics
    and timesteps and, per rollout, the policy it ran under ("live" for the
    live tree, ``snapshot`` when it is that store's tree, else "other") and,
    for the snapshot, whether it equals the live tree bit for bit."""
    from flow_factory_tpu_torch import ops

    ad = trainer.adapter
    steps, rollouts = [], []
    loss_fn, inference = trainer.loss_fn, ad.inference

    def recording_loss_fn(trainable, batch, ref_trainable=None):
        loss, aux = loss_fn(trainable, batch, ref_trainable)
        steps.append(({k: float(v) for k, v in aux.items()}, batch["timestep"].clone()))
        return loss, aux

    def recording_inference(*args, **kwargs):
        tr = kwargs.get("trainable")
        live = tr is None or tr is ad.trainable
        if not live and ad.has_named_parameters(snapshot) and tr is ad.get_named_parameters(snapshot):
            equal = all(torch.equal(a, b) for a, b in zip(ad.trainable_leaves(tr), ad.trainable_leaves()))
            rollouts.append((snapshot, equal))
        else:
            rollouts.append(("live" if live else "other", None))
        return inference(*args, **kwargs)

    trainer.loss_fn, ad.inference = recording_loss_fn, recording_inference
    ops.reset_launch_counts()
    try:
        trainer.start()
    finally:
        trainer.cleanup()
    assert ops.launch_counts() == {name: 0 for name in ops.KERNEL_WRAPPERS}  # CPU: the plain versions only
    return steps, rollouts


def _resume_rebuilds_the_snapshots(first, name, snapshots, tmp_path):
    """After ``first``'s epochs, a full-state save, then ``load_trainer``
    with ``model.resume_path``: the trainable tree comes back bit-equal, the
    state file holds no snapshot, and every snapshot of the resumed trainer
    is the restored θ bit for bit (the first of ``snapshots``, blended in
    the saved run, was not θ there), as in the JAX package (F14)."""
    from flow_factory_tpu_torch.trainers import load_trainer

    path = str(tmp_path / "ckpt")
    first.save_checkpoint(path, model_only=False)
    state = torch.load(os.path.join(path, "train_state", "state.pt"), weights_only=True)
    assert sorted(state) == ["epoch", "global_step", "opt_state", "trainable"]
    blended = first.adapter.trainable_leaves(first.adapter.get_named_parameters(snapshots[0]))
    cfg = _config(name, tmp_path)
    cfg.model_args.resume_path = path
    resumed = load_trainer(cfg, device="cpu")
    try:
        ad = resumed.adapter
        assert resumed.epoch == 2 and resumed.global_step == 2
        assert all(torch.equal(a, b) for a, b in zip(ad.trainable_leaves(), first.adapter.trainable_leaves()))
        for snapshot in snapshots:
            snap = ad.trainable_leaves(ad.get_named_parameters(snapshot))
            assert all(torch.equal(a, b) for a, b in zip(snap, ad.trainable_leaves())), snapshot
        assert any(not torch.equal(a, b) for a, b in zip(blended, ad.trainable_leaves()))
    finally:
        resumed.cleanup()


def test_dgpo_runs_two_epochs_with_the_step_0_invariants(tmp_path):
    """``load_trainer(cfg, device="cpu").start()`` on smoke_dgpo.yaml (tiny
    SD3.5, CFG 2.0 rollout, 2 groups of 2, T 2, clip_dsm, KL 0.01): epoch
    0's grad steps run at θ = ``ema_ref`` = the zero LoRA = the reference,
    so pref_mean is exactly 0, group_weight_mean exactly 0.5, kl and
    clip_ratio exactly 0; epoch 0 rolls out under the live tree, epoch 1
    (one optimizer step later, past ``switch_ema_ref`` 0) under ``ema_ref``,
    which the step moved to 0.999·0 + 0.001·θ; every grad step's rows share
    the JAX package's shared timestep of that (epoch, index) bit for bit;
    the LoRA moves and epoch 1's metrics leave the invariants. A resume
    from a full-state save rebuilds ``ema_ref`` from the restored θ (F14)."""
    from flow_factory_tpu_torch.trainers import load_trainer

    trainer = load_trainer(_config("smoke_dgpo", tmp_path), device="cpu")
    assert type(trainer).__name__ == "DGPOTrainer" and trainer.requires_ema_ref
    assert trainer.training_args.gradient_accumulation_steps == 2
    steps, rollouts = _recorded_run(trainer, "ema_ref")
    assert len(steps) == 4 and trainer.global_step == 2
    for aux, _ in steps[:2]:
        assert (aux["train/pref_mean"], aux["train/group_weight_mean"], aux["train/kl"],
                aux["train/clip_ratio"]) == (0.0, 0.5, 0.0, 0.0), aux
    assert all(np.isfinite(v) for aux, _ in steps for v in aux.values())
    assert any(aux["train/kl"] > 0 and aux["train/pref_mean"] != 0.0 for aux, _ in steps[2:]), steps
    assert rollouts == [("live", None), ("ema_ref", False)]
    jt = _jax_trainer("flow_factory_tpu.trainers.dgpo:DGPOTrainer", "smoke_dgpo")
    for i, (_, t) in enumerate(steps):
        shared = np.float32(jt._shared_timesteps(i // 2, 0)[i % 2])
        assert t.shape == (4,) and t.dtype == torch.float32 and bool((t == float(shared)).all())
    ema_ref = trainer.adapter.get_named_parameters("ema_ref")["transformer"]
    live = trainer.adapter.trainable["transformer"]
    assert any(not torch.equal(ema_ref[p]["lora_B"], live[p]["lora_B"]) for p in live)
    assert any(ema_ref[p]["lora_B"].abs().max() > 0 for p in live)
    _resume_rebuilds_the_snapshots(trainer, "smoke_dgpo", ("ema_ref",), tmp_path)


def test_crd_runs_two_epochs_with_the_step_0_invariants(tmp_path):
    """``load_trainer(cfg, device="cpu").start()`` on smoke_crd_wan.yaml
    (tiny Wan, CFG 5 rollout, hard pools, KL 0.01, T 2): epoch 0's grad steps
    run at θ = ``_crd_old`` = the zero LoRA = the reference, so r_theta_mean,
    old_deviate and kl are exactly 0; both rollouts run under
    ``_crd_sampling``, which the end of epoch 0 set to θ (decay 0: equal bit
    for bit at epoch 1's rollout); the micro-batch's timesteps (in sample
    order, seeded by its first index 0) equal the JAX package's bit for bit.
    A resume from a full-state save rebuilds both snapshots from the
    restored θ (F14)."""
    from flow_factory_tpu.utils.base import derive_seed as j_derive
    from flow_factory_tpu_torch.trainers import load_trainer

    trainer = load_trainer(_config("smoke_crd_wan", tmp_path), device="cpu")
    assert type(trainer).__name__ == "CRDTrainer"
    steps, rollouts = _recorded_run(trainer, "_crd_sampling")
    assert len(steps) == 4 and trainer.global_step == 2
    for aux, _ in steps[:2]:
        assert (aux["train/r_theta_mean"], aux["train/old_deviate"], aux["train/kl"]) == (0.0, 0.0, 0.0), aux
    assert all(np.isfinite(v) for aux, _ in steps for v in aux.values())
    assert any(aux["train/kl"] > 0 and aux["train/r_theta_mean"] != 0.0 for aux, _ in steps[2:]), steps
    assert rollouts == [("_crd_sampling", True), ("_crd_sampling", True)]
    jt = _jax_trainer("flow_factory_tpu.trainers.crd:CRDTrainer", "smoke_crd_wan")
    for i, (_, t) in enumerate(steps):
        theirs = jt.sample_timesteps(4, j_derive("crd_t", 42, i // 2, 0, 0))[i % 2]
        assert np.array_equal(t.numpy(), theirs), (i, t, theirs)
    old = trainer.adapter.get_named_parameters("_crd_old")["transformer"]
    live = trainer.adapter.trainable["transformer"]
    assert any(not torch.equal(old[p]["lora_B"], live[p]["lora_B"]) for p in live)
    assert any(old[p]["lora_B"].abs().max() > 0 for p in live)
    _resume_rebuilds_the_snapshots(trainer, "smoke_crd_wan", ("_crd_old", "_crd_sampling"), tmp_path)


def test_jax_resume_rebuilds_the_snapshots_too(tmp_path):
    """The JAX package's behaviour that the port keeps (F14): its full-state
    save holds no snapshot, and a snapshot registered after a resume (as its
    DGPO and CRD trainers register theirs, after the adapter loaded the
    checkpoint) is the restored θ."""
    ja = _jax_adapter(SD35_CONFIG)
    rng = np.random.default_rng(6)
    ja.trainable = jax.tree.map(lambda x: jnp.asarray(x + 0.1 * rng.standard_normal(x.shape).astype(np.float32)),
                                ja.trainable)
    ja.add_named_parameters("ema_ref")
    ja.update_named_parameters("ema_ref", blend=0.5)
    ja.trainable = jax.tree.map(lambda x: x * 2.0, ja.trainable)
    ja.save_checkpoint(str(tmp_path / "ckpt"), model_only=False, extra_state={"epoch": 0, "global_step": 1})

    config = copy.deepcopy(SD35_CONFIG)
    config["model"]["resume_path"] = str(tmp_path / "ckpt")
    jb = _jax_adapter(config)
    assert not jb.has_named_parameters("ema_ref") and set(jb._restored_state) == {"epoch", "global_step"}
    jb.add_named_parameters("ema_ref")
    for a, b, c in zip(jax.tree.leaves(jb.get_named_parameters("ema_ref")), jax.tree.leaves(jb.trainable),
                       jax.tree.leaves(ja.trainable)):
        assert np.array_equal(np.asarray(a), np.asarray(b)) and np.array_equal(np.asarray(b), np.asarray(c))


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("trainer_type", ["grpo", "grpo_guard", "grpo-guard", "dpo", "nft", "awm", "dgpo", "crd"])
def test_registry_resolves_every_jax_trainer_type(trainer_type):
    """Every trainer type of the JAX registry resolves in the port, to the
    class of the same name."""
    from flow_factory_tpu.trainers.registry import available_trainers
    from flow_factory_tpu.trainers.registry import resolve_trainer_class as jax_resolve
    from flow_factory_tpu_torch.trainers.registry import resolve_trainer_class

    assert trainer_type in available_trainers()
    ours, theirs = resolve_trainer_class(trainer_type), jax_resolve(trainer_type)
    assert ours.__name__ == theirs.__name__ and ours.__module__.startswith("flow_factory_tpu_torch.trainers.")
