"""PyTorch port, the GRPO training step: the LoRA merge, the training
forward and its LoRA gradients, the GRPO / GRPO-Guard / KL losses and their
gradients, and one clipped AdamW step, against the JAX package on the same
weights (the JAX adapter's random init and a LoRA with a non-zero ``b``,
carried across by the weight bridge) and the same numpy batch; then the
port's whole training slice for two epochs on the smoke config. fp32 on the
CPU."""
import copy
import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 4

CONFIG = {
    "data": {"dataset_dir": "tests/fixtures/tiny_prompts"},
    "model": {"model_type": "sd3-5", "model_name_or_path": "tiny", "variant": "tiny",
              "finetune_type": "lora", "lora_rank": 4, "lora_alpha": 8, "attn_backend": "auto",
              "master_dtype": "float32", "inference_dtype": "float32"},
    "scheduler": {"dynamics_type": "Flow-SDE", "noise_level": 0.7, "num_sde_steps": 2,
                  "sde_steps": [0, 1, 2]},
    "train": {"trainer_type": "grpo", "resolution": 32, "num_inference_steps": 4, "guidance_scale": 2.0,
              "per_device_batch_size": B, "group_size": B, "unique_sample_num_per_epoch": 1,
              "latent_storage_dtype": "fp32", "ema_decay": 0, "clip_range": 0.2, "adv_clip_range": 1.5},
    "eval": {}, "log": {}, "rewards": [],
}


def _leaf_close(ours, theirs, rel, what):
    """Every leaf within ``rel`` of that leaf's max magnitude."""
    assert set(ours) == set(theirs), what
    for path in theirs:
        for k in ("a", "b"):
            ref = np.asarray(theirs[path][k])
            err = np.abs(ours[path][k] - ref).max()
            assert err <= rel * max(np.abs(ref).max(), 1e-30), f"{what} {path}/{k}: {err} vs max {np.abs(ref).max()}"


@pytest.fixture(scope="module")
def pair():
    """The JAX and the port adapters on the same frozen weights and the same
    LoRA (``b`` drawn non-zero: at b = 0 the gradient of ``a`` vanishes), and
    one fixed batch for each."""
    from flow_factory_tpu.hparams.args import Arguments as JArgs
    from flow_factory_tpu.models import load_adapter as jax_load
    from flow_factory_tpu.parallel.dist import set_world_size_override
    from flow_factory_tpu_torch.hparams import Arguments
    from flow_factory_tpu_torch.models import load_adapter
    from flow_factory_tpu_torch.utils import weights

    set_world_size_override(1)
    try:
        ja = jax_load(JArgs.from_dict(copy.deepcopy(CONFIG)))
    finally:
        set_world_size_override(None)
    flax_params = jax.tree.map(np.asarray, jax.device_get(ja.params))
    rng = np.random.default_rng(5)
    lora = {path: {"a": np.asarray(ab["a"]),
                   "b": (0.05 * rng.standard_normal(ab["b"].shape)).astype(np.float32)}
            for path, ab in jax.device_get(ja.trainable["transformer"]).items()}
    ja.trainable = {"transformer": jax.tree.map(jnp.asarray, lora)}

    pa = load_adapter(Arguments.from_dict(copy.deepcopy(CONFIG)), device="cpu")
    pa.load_state_dicts(weights.sd35_state_dicts(flax_params, pa.component_configs))
    module_map = weights.sd3_transformer_map(*_depth(pa))[0]
    pa.load_lora("transformer", weights.lora_from_flax(lora, module_map))

    with torch.no_grad():
        enc = pa.encode_prompt(["a photo of a red fox in the snow"] * B)
        neg = pa.encode_prompt([""] * B)
    h, w, c = pa.latent_shape(32, 32)
    full = lambda v: np.full((B,), v, np.float32)
    batch = dict(
        latents=rng.standard_normal((B, h, w, c)).astype(np.float32),
        next_latents=rng.standard_normal((B, h, w, c)).astype(np.float32),
        rollout_mean=rng.standard_normal((B, h, w, c)).astype(np.float32),
        timestep=full(750.0), sigma=full(0.75), sigma_next=full(0.5), noise_level=full(0.7),
        sigma_max=full(0.9), advantage=np.asarray([1.2, -0.7, 2.5, -3.0], np.float32),
        prompt_embeds=enc["prompt_embeds"].numpy(), pooled_prompt_embeds=enc["pooled_prompt_embeds"].numpy(),
        negative_prompt_embeds=neg["prompt_embeds"].numpy(),
        negative_pooled_prompt_embeds=neg["pooled_prompt_embeds"].numpy(),
    )
    # the next latents near the step's mean, so the log-probs are moderate
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    mean = np.asarray(ja.training_forward(ja.trainable, {**jbatch, "guidance_scale": jnp.float32(2.0)},
                                          compute_log_prob=False).next_latents_mean)
    batch["next_latents"] = (mean + 0.3 * batch["next_latents"]).astype(np.float32)
    return ja, pa, batch, module_map


def _depth(pa):
    cfg = pa.component_configs["transformer"]
    return cfg.depth, cfg.dual_attention_layers


def _jbatch(batch, **extra):
    return {**{k: jnp.asarray(v) for k, v in batch.items()}, "guidance_scale": jnp.float32(2.0), **extra}


def _tbatch(batch, **extra):
    return {**{k: torch.from_numpy(v) for k, v in batch.items()}, "guidance_scale": 2.0, **extra}


def _port_grads_as_flax(pa, grads, module_map):
    from flow_factory_tpu_torch.utils import weights

    tree, it = {}, iter(grads)
    for path in sorted(pa.trainable["transformer"]):
        ab = pa.trainable["transformer"][path]
        tree[path] = {k: next(it) for k in sorted(ab)}
    return weights.lora_to_flax(tree, module_map)


def test_lora_bridge_round_trips_and_merge_matches_jax(pair):
    """The LoRA bridge is exact both ways, and the port's merge
    ``(W + (α/r)·B@A)`` equals the JAX merge ``(W + (α/r)·a@b)`` through the
    weight bridge: fp32, 1e-6."""
    from flow_factory_tpu.models.lora import merge_lora as jmerge
    from flow_factory_tpu_torch.utils import weights

    ja, pa, _, module_map = pair
    lora = jax.tree.map(np.asarray, jax.device_get(ja.trainable["transformer"]))
    back = weights.lora_to_flax(pa.trainable["transformer"], module_map)
    _leaf_close(back, lora, 0.0, "round trip")
    merged = pa.merged_params("transformer")
    theirs = weights.convert(jax.tree.map(np.asarray, jmerge(ja.params["transformer"], ja.trainable["transformer"],
                                                             ja.lora_scale)),
                             *weights.sd3_transformer_map(*_depth(pa)))
    assert len(merged) == len(lora) and pa.lora_scale == ja.lora_scale == 2.0
    for name, w in merged.items():
        np.testing.assert_allclose(w.detach().numpy(), theirs[name].numpy(), atol=1e-6, rtol=0, err_msg=name)


def test_training_forward_log_prob_and_lora_grads_match_jax(pair):
    """The training forward's log-prob on the tiny SD3.5 (CFG, Flow-SDE) and
    the gradient of its sum in every LoRA leaf, against jax.grad of the JAX
    ``training_forward``: log-probs 1e-5 relative, gradients 1e-4 relative to
    each leaf's max."""
    ja, pa, batch, module_map = pair
    jfn = lambda tr: ja.training_forward(tr, _jbatch(batch)).log_prob
    j_lp = np.asarray(jfn(ja.trainable))
    j_grads = jax.tree.map(np.asarray, jax.grad(lambda tr: jfn(tr).sum())(ja.trainable))["transformer"]

    out = pa.training_forward(pa.trainable, _tbatch(batch))
    grads = torch.autograd.grad(out.log_prob.sum(), pa.trainable_leaves())
    np.testing.assert_allclose(out.log_prob.detach().numpy(), j_lp, rtol=1e-5, atol=0)
    _leaf_close(_port_grads_as_flax(pa, grads, module_map), j_grads, 1e-4, "d log_prob")


def test_gradient_checkpointing_recomputes_blocks_and_keeps_the_gradients(pair):
    """``enable_gradient_checkpointing`` (the JAX package's per-block
    ``nn.remat``): each block runs again in the backward, on the LoRA-merged
    weights, and the LoRA gradients are bit-identical to the run without it."""
    from flow_factory_tpu_torch.hparams import Arguments
    from flow_factory_tpu_torch.models import load_adapter
    from flow_factory_tpu_torch.utils import weights

    ja, pa, batch, module_map = pair
    cfg = copy.deepcopy(CONFIG)
    cfg["train"]["enable_gradient_checkpointing"] = True
    ra = load_adapter(Arguments.from_dict(cfg), device="cpu")
    assert ra.component_configs["transformer"].remat and not pa.component_configs["transformer"].remat
    ra.load_state_dicts({"transformer": pa.modules["transformer"].state_dict()})
    ra.load_lora("transformer", weights.lora_from_flax(weights.lora_to_flax(pa.trainable["transformer"],
                                                                            module_map), module_map))
    grads, calls = [], []
    for adapter in (pa, ra):
        blocks = adapter.modules["transformer"].transformer_blocks
        n = [0]  # pre-hooks: the recompute stops once it has rebuilt what the backward needs
        hooks = [b.register_forward_pre_hook(lambda *_: n.__setitem__(0, n[0] + 1)) for b in blocks]
        try:
            out = adapter.training_forward(adapter.trainable, _tbatch(batch))
            grads.append(torch.autograd.grad(out.log_prob.sum(), adapter.trainable_leaves()))
        finally:
            for h in hooks:
                h.remove()
        calls.append(n[0])
    assert calls == [len(blocks), 2 * len(blocks)]
    assert all(torch.equal(a, b) for a, b in zip(*grads))


@pytest.mark.parametrize("case", ["grpo", "grpo-guard", "grpo-kl-v"])
def test_grpo_loss_and_grads_match_jax(pair, case):
    """One micro-batch at one timestep through the JAX trainer's own
    ``_grad_fn`` (an object with only ``training_args``, ``use_guard`` and
    ``adapter`` set) and the port's ``loss_and_grads``: old log-probs chosen
    so that the clip binds on two samples and not on the other two; GRPO-Guard's
    σ-normalised ratio with the mean drift; the v-based KL against the
    zero-LoRA reference. Loss and aux metrics 1e-5, gradients 1e-4 relative
    to each leaf's max."""
    from flow_factory_tpu.trainers.grpo import GRPOTrainer as JGRPO
    from flow_factory_tpu_torch.trainers.grpo import GRPOTrainer

    ja, pa, batch, module_map = pair
    j_ta, t_ta = copy.copy(ja.training_args), copy.copy(pa.training_args)
    for ta in (j_ta, t_ta):
        ta.kl_beta, ta.kl_type = (0.5, "v-based") if case == "grpo-kl-v" else (0.0, "x-based")
    guard = case == "grpo-guard"
    new_lp = np.asarray(ja.training_forward(ja.trainable, _jbatch(batch)).log_prob)
    # ratios ~1.05, 0.61, 1.49, 1.11 against advantages +, -, +, -: the clip
    # binds on the second (below 1 - 0.2) and the third (above 1 + 0.2)
    batch = {**batch, "old_log_prob": (new_lp + np.asarray([-0.05, 0.5, -0.4, -0.1], np.float32))}

    jt = object.__new__(JGRPO)
    jt.training_args, jt.use_guard, jt.adapter = j_ta, guard, ja
    j_ref = ja.ref_trainable() if case == "grpo-kl-v" else None
    (j_loss, j_aux), j_grads = jt._grad_fn(ja.trainable, ja.frozen_velocity_params(), _jbatch(batch), j_ref)

    pt = object.__new__(GRPOTrainer)
    pt.training_args, pt.use_guard, pt.adapter = t_ta, guard, pa
    p_ref = pa.ref_trainable() if case == "grpo-kl-v" else None
    (loss, aux), grads = pt.loss_and_grads(_tbatch(batch), p_ref)

    assert sorted(aux) == sorted(j_aux)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5, atol=1e-7)
    for k in j_aux:
        np.testing.assert_allclose(float(aux[k]), float(j_aux[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    assert 0.0 < float(aux["train/clip_frac"]) < 1.0 or guard
    _leaf_close(_port_grads_as_flax(pa, grads, module_map),
                jax.tree.map(np.asarray, j_grads)["transformer"], 1e-4, case)


class _LeafAdapter:
    """What the optimizer mechanics read of an adapter: its trainable leaves."""

    def __init__(self, leaves):
        self.leaves = leaves

    def trainable_leaves(self):
        return self.leaves


@pytest.mark.parametrize("max_norm", [100.0, 0.05], ids=["no-clip", "clip-bites"])
def test_optimizer_steps_match_optax(max_norm):
    """Two accumulated grad steps then an update, twice: the port's sums in
    each leaf's ``.grad`` (as ``backward_step`` leaves them) and
    ``apply_accumulated`` (fp32 sums / count, optax's global-norm clip,
    AdamW with the configured betas, epsilon and decay)
    against the JAX trainer's jitted accumulate and ``_apply_updates_jit``
    over ``optax.chain(clip_by_global_norm, adamw)``: updated weights 1e-6,
    grad norms 1e-6 relative."""
    import optax
    from flow_factory_tpu.trainers import abc as jabc
    from flow_factory_tpu_torch.trainers.grpo import GRPOTrainer

    ta = types.SimpleNamespace(learning_rate=3e-2, adam_betas=(0.9, 0.99), adam_epsilon=1e-6,
                               adam_weight_decay=1e-2, max_grad_norm=max_norm)
    rng = np.random.default_rng(0)
    shapes = {"w1": (8, 5), "w2": (3,), "w3": (4, 4)}
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    steps = [[{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()} for _ in range(2)]
             for _ in range(2)]

    opt = optax.chain(optax.clip_by_global_norm(max_norm),
                      optax.adamw(learning_rate=ta.learning_rate, b1=ta.adam_betas[0], b2=ta.adam_betas[1],
                                  eps=ta.adam_epsilon, weight_decay=ta.adam_weight_decay))
    j_params = {k: jnp.asarray(v) for k, v in init.items()}
    j_state, j_norms = opt.init(j_params), []
    leaves = [torch.from_numpy(init[k].copy()).requires_grad_() for k in sorted(shapes)]
    trainer = object.__new__(GRPOTrainer)
    trainer.training_args, trainer.adapter, trainer.global_step = ta, _LeafAdapter(leaves), 0
    trainer._init_optimizer()
    norms = []
    for micro in steps:
        acc = jabc._accum_init_jit(jax.tree.map(jnp.asarray, micro[0]))
        acc = jabc._accum_add_jit(acc, jax.tree.map(jnp.asarray, micro[1]))
        j_params, j_state, gnorm = jabc._apply_updates_jit(opt, j_params, j_state, acc, 2)
        j_norms.append(float(gnorm))
        for g in micro:
            for leaf, k in zip(leaves, sorted(shapes)):
                step = torch.from_numpy(g[k])
                leaf.grad = step.clone() if leaf.grad is None else leaf.grad.add_(step)
            trainer._accum_count += 1
        norms.append(float(trainer.apply_accumulated()))
    assert trainer.global_step == 2
    np.testing.assert_allclose(norms, j_norms, rtol=1e-6)
    assert (max(j_norms) > max_norm) == (max_norm < 1.0)
    for k, leaf in zip(sorted(shapes), leaves):
        np.testing.assert_allclose(leaf.detach().numpy(), np.asarray(j_params[k]), atol=1e-6, rtol=0, err_msg=k)


@pytest.mark.parametrize("schedule,interval", [("constant", 4), ("power", 1)])
def test_ema_matches_jax(schedule, interval):
    """The EMA of a LoRA-shaped tree over six steps (the trainer steps it once
    per epoch): the same decay schedule and update interval as the JAX
    ``EMA``, fp32 within one ulp of the leaf's max per update so far (XLA
    fuses the update into an fma, eager PyTorch rounds the product and the
    sum, as F3)."""
    from flow_factory_tpu.ema.ema import EMA as JEMA, constant_decay as jconst, get_decay_schedule as jsched
    from flow_factory_tpu_torch.ema import EMA, constant_decay, get_decay_schedule

    rng = np.random.default_rng(3)
    tree = lambda: {"t": {"blk.attn.to_q": {"lora_A": rng.standard_normal((4, 8)).astype(np.float32),
                                            "lora_B": rng.standard_normal((8, 4)).astype(np.float32)}}}
    start = tree()
    decay = (constant_decay(0.99), jconst(0.99)) if schedule == "constant" else \
        (get_decay_schedule(schedule), jsched(schedule))
    ours = EMA(jax.tree.map(torch.from_numpy, start), decay_fn=decay[0], update_interval=interval)
    theirs = JEMA(jax.tree.map(jnp.asarray, start), decay_fn=decay[1], update_interval=interval)
    updates = 0
    for step in range(6):
        params = tree()
        ours.update(jax.tree.map(torch.from_numpy, params), step=step)
        theirs.update(jax.tree.map(jnp.asarray, params), step=step)
        updates += step % interval == 0
        for k in ("lora_A", "lora_B"):
            ref = np.asarray(theirs.params["t"]["blk.attn.to_q"][k])
            np.testing.assert_allclose(ours.params["t"]["blk.attn.to_q"][k].numpy(), ref, rtol=0,
                                       atol=max(updates, 1) * np.spacing(np.abs(ref).max()))


def _smoke_config(tmp_path, trainer_type="grpo"):
    from flow_factory_tpu_torch.hparams import Arguments

    cfg = Arguments.load_from_yaml(os.path.join(REPO, "tests/fixtures/smoke_grpo.yaml"))
    cfg.training_args.trainer_type = trainer_type
    cfg.data_args.cache_dir = str(tmp_path / "cache")
    cfg.log_args.save_dir = str(tmp_path / "saves")
    return cfg


@pytest.mark.parametrize("trainer_type", ["grpo", "grpo_guard"])
def test_training_slice_runs_two_epochs_on_the_smoke_config(tmp_path, trainer_type):
    """``load_trainer(...).start()`` on tests/fixtures/smoke_grpo.yaml (two
    epochs): the asserts of tests/test_e2e_grpo.py with the ratio held to the
    port's own invariant — ``train/ratio_mean`` exactly 1.0 and no clipping
    in both epochs (epoch 1 rolls out with the LoRA the first update moved,
    so rollout and training merge it alike), a grad norm > 0, a finite loss,
    an optimizer step per epoch, and the LoRA ``B`` moved."""
    from flow_factory_tpu_torch import ops
    from flow_factory_tpu_torch.trainers import load_trainer

    cfg = _smoke_config(tmp_path, trainer_type)
    if trainer_type == "grpo":
        trainer = load_trainer(cfg, device="cpu")  # the caller asks for the CPU
    else:
        cfg.model_args.extra_kwargs["device"] = "cpu"  # the config asks (``model.device``)
        trainer = load_trainer(cfg)
    b0 = {p: ab["lora_B"].detach().clone() for p, ab in trainer.adapter.trainable["transformer"].items()}
    ops.reset_launch_counts()
    try:
        trainer.start()
    finally:
        trainer.cleanup()
    rows = [json.loads(line) for line in open(tmp_path / "saves" / cfg.log_args.run_name / "metrics.jsonl")]
    rows = [r for r in rows if "media_tag" not in r]  # each epoch also logs its samples' image grid
    assert [r["step"] for r in rows] == [0, 1]
    ta = cfg.training_args
    for row in rows:
        assert row["train/ratio_mean"] == 1.0 and row["train/ratio_min"] == row["train/ratio_max"] == 1.0
        assert row["train/clip_frac"] == 0.0
        assert row["train/grad_norm"] > 0 and np.isfinite(row["train/loss"])
        assert np.isfinite(row["reward/mean"])
    assert trainer.global_step == 2
    moved = max((trainer.adapter.trainable["transformer"][p]["lora_B"] - b).abs().max().item()
                for p, b in b0.items())
    assert moved > 0
    assert ops.launch_counts() == {name: 0 for name in ops.KERNEL_WRAPPERS}  # CPU: plain versions only
    assert len(trainer.reward_buffer.samples) == ta.unique_sample_num_per_epoch * ta.group_size


def test_unported_paths_raise(tmp_path):
    """What the port does not know raises instead of being skipped: an
    unknown trainer type (every trainer type of the JAX package resolves,
    DGPO among them). Evaluation, checkpoint saving
    and the logging backends are ported: ``eval_freq > 0`` builds a trainer
    with an eval reward buffer, ``save_freq > 0`` and ``logging_backend:
    tensorboard`` build one, and a backend whose package is missing (wandb here) is
    skipped with a warning, as in the JAX package."""
    from flow_factory_tpu_torch.trainers import load_trainer
    from flow_factory_tpu_torch.trainers.registry import resolve_trainer_class

    cfg = _smoke_config(tmp_path)
    cfg.eval_args.eval_freq = 1
    trainer = load_trainer(cfg, device="cpu")
    assert trainer.test_loader is not None and trainer.eval_reward_buffer.samples == []
    trainer.cleanup()
    for field, value, backends in (("log_args.save_freq", 1, ["ConsoleLogger", "JSONLLogger"]),
                                   ("log_args.logging_backend", "tensorboard",
                                    ["ConsoleLogger", "JSONLLogger", "TensorboardLogger"]),
                                   ("log_args.logging_backend", "wandb", ["ConsoleLogger", "JSONLLogger"])):
        cfg = _smoke_config(tmp_path)
        section, name = field.split(".")
        setattr(getattr(cfg, section), name, value)
        trainer = load_trainer(cfg, device="cpu")
        assert [type(b).__name__ for b in trainer.logger_backend.backends] == backends
        trainer.cleanup()
        trainer._uninstall_preempt_handler()
    assert resolve_trainer_class("dgpo").__name__ == "DGPOTrainer"
    with pytest.raises(KeyError):
        resolve_trainer_class("no-such-trainer")


def test_train_entry_point_runs_one_epoch_on_the_cpu(tmp_path):
    """``python -m flow_factory_tpu_torch.train <yaml> --device cpu`` trains
    one epoch and writes its metrics."""
    text = open(os.path.join(REPO, "tests/fixtures/smoke_grpo.yaml")).read()
    text = (text.replace('"/tmp/fft_cache"', f'"{tmp_path}/cache"').replace('"/tmp/fft_saves"', f'"{tmp_path}/saves"')
            .replace("max_epochs: 2", "max_epochs: 1"))
    path = tmp_path / "smoke.yaml"
    path.write_text(text)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-m", "flow_factory_tpu_torch.train", str(path), "--device", "cpu"],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    rows = [json.loads(line) for line in open(tmp_path / "saves" / "smoke_grpo" / "metrics.jsonl")]
    rows = [r for r in rows if "media_tag" not in r]  # the epoch also logs its samples' image grid
    assert len(rows) == 1 and rows[0]["train/ratio_mean"] == 1.0
