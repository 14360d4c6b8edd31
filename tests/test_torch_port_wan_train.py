"""PyTorch port, the Wan2.1 T2V GRPO training step against the JAX package,
fp32 on the CPU: the training forward's log-prob and LoRA gradients on the
tiny Wan (the JAX adapter's random init and a LoRA with a non-zero ``b``,
carried across by the weight bridge), the GRPO and GRPO-Guard losses and
gradients against the JAX trainer's ``_grad_fn``, gradient checkpointing
against none, the per-prompt eval generators, and two epochs of the port's
trainer with an evaluation before each."""
import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 4
PROMPT = "a paper boat drifting down a rainy gutter stream"

CONFIG = {
    "data": {"dataset_dir": "tests/fixtures/tiny_prompts"},
    "model": {"model_type": "wan2-t2v", "model_name_or_path": "tiny", "finetune_type": "lora",
              "lora_rank": 4, "lora_alpha": 8, "attn_backend": "native",
              "master_dtype": "float32", "inference_dtype": "float32"},
    "scheduler": {"dynamics_type": "Flow-SDE", "noise_level": 0.7, "num_sde_steps": 2,
                  "sde_steps": [0, 1, 2]},
    "train": {"trainer_type": "grpo", "resolution": 32, "num_inference_steps": 4, "guidance_scale": 5.0,
              "per_device_batch_size": B, "group_size": B, "unique_sample_num_per_epoch": 1,
              "latent_storage_dtype": "fp32", "num_frames": 5, "ema_decay": 0, "clip_range": 0.2,
              "adv_clip_range": 1.5},
    "eval": {}, "log": {}, "rewards": [],
}


def _leaf_close(ours, theirs, rel, what):
    """Every LoRA leaf within ``rel`` of that leaf's max magnitude."""
    assert set(ours) == set(theirs), what
    for path in theirs:
        for k in ("a", "b"):
            ref = np.asarray(theirs[path][k])
            err = np.abs(ours[path][k] - ref).max()
            assert err <= rel * max(np.abs(ref).max(), 1e-30), f"{what} {path}/{k}: {err} vs max {np.abs(ref).max()}"


def _port_grads_as_flax(pa, grads, module_map):
    from flow_factory_tpu_torch.utils import weights

    tree, it = {}, iter(grads)
    for path in sorted(pa.trainable["transformer"]):
        tree[path] = {k: next(it) for k in sorted(pa.trainable["transformer"][path])}
    return weights.lora_to_flax(tree, module_map)


def _jbatch(batch):
    return {**{k: jnp.asarray(v) for k, v in batch.items()}, "guidance_scale": jnp.float32(5.0)}


def _tbatch(batch):
    return {**{k: torch.from_numpy(v) for k, v in batch.items()}, "guidance_scale": 5.0}


def _port_adapter(**train):
    from flow_factory_tpu_torch.hparams import Arguments
    from flow_factory_tpu_torch.models import load_adapter

    cfg = copy.deepcopy(CONFIG)
    cfg["train"].update(train)
    return load_adapter(Arguments.from_dict(cfg), device="cpu")


@pytest.fixture(scope="module")
def pair():
    """Both tiny Wan adapters on the same frozen weights and LoRA, and one
    CFG batch of 4 at one Flow-SDE step, its next latents near the step's
    mean so the log-probs are moderate."""
    from flow_factory_tpu.hparams.args import Arguments as JArgs
    from flow_factory_tpu.models import load_adapter as jax_load
    from flow_factory_tpu.parallel.dist import set_world_size_override
    from flow_factory_tpu_torch.utils import weights

    set_world_size_override(1)
    try:
        ja = jax_load(JArgs.from_dict(copy.deepcopy(CONFIG)))
    finally:
        set_world_size_override(None)
    flax_params = jax.tree.map(np.asarray, jax.device_get(ja.params))
    rng = np.random.default_rng(7)
    lora = {path: {"a": np.asarray(ab["a"]),
                   "b": (0.05 * rng.standard_normal(ab["b"].shape)).astype(np.float32)}
            for path, ab in jax.device_get(ja.trainable["transformer"]).items()}
    ja.trainable = {"transformer": jax.tree.map(jnp.asarray, lora)}

    pa = _port_adapter()
    pa.load_state_dicts(weights.wan_t2v_state_dicts(flax_params, pa.component_configs))
    module_map = weights.wan_transformer_map(pa.component_configs["transformer"].num_layers)[0]
    pa.load_lora("transformer", weights.lora_from_flax(lora, module_map))

    with torch.no_grad():
        enc = pa.encode_prompt([PROMPT] * B)["prompt_embeds"].numpy()
        neg = pa.encode_prompt([""] * B)["prompt_embeds"].numpy()
    shape = (B, *pa.latent_shape(32, 32, 5))
    full = lambda v: np.full((B,), v, np.float32)
    batch = dict(
        latents=rng.standard_normal(shape).astype(np.float32),
        next_latents=rng.standard_normal(shape).astype(np.float32),
        rollout_mean=rng.standard_normal(shape).astype(np.float32),
        timestep=full(750.0), sigma=full(0.75), sigma_next=full(0.5), noise_level=full(0.7),
        sigma_max=full(0.9), advantage=np.asarray([1.2, -0.7, 2.5, -3.0], np.float32),
        prompt_embeds=enc, negative_prompt_embeds=neg,
    )
    mean = np.asarray(ja.training_forward(ja.trainable, _jbatch(batch), compute_log_prob=False).next_latents_mean)
    batch["next_latents"] = (mean + 0.3 * batch["next_latents"]).astype(np.float32)
    return ja, pa, batch, module_map


def test_wan_training_forward_log_prob_and_lora_grads_match_jax(pair):
    """The training forward's log-prob on the tiny Wan (CFG 5, Flow-SDE)
    and the gradient of its sum in every LoRA leaf (self- and
    cross-attention projections, both FFN linears), against jax.grad of the
    JAX ``training_forward``: log-probs 1e-5 relative, gradients 1e-4
    relative to each leaf's max."""
    ja, pa, batch, module_map = pair
    jfn = lambda tr: ja.training_forward(tr, _jbatch(batch)).log_prob
    j_lp = np.asarray(jfn(ja.trainable))
    j_grads = jax.tree.map(np.asarray, jax.grad(lambda tr: jfn(tr).sum())(ja.trainable))["transformer"]

    out = pa.training_forward(pa.trainable, _tbatch(batch))
    grads = torch.autograd.grad(out.log_prob.sum(), pa.trainable_leaves())
    np.testing.assert_allclose(out.log_prob.detach().numpy(), j_lp, rtol=1e-5, atol=0)
    assert len(grads) == 2 * 20 and all(g.abs().max() > 0 for g in grads)
    _leaf_close(_port_grads_as_flax(pa, grads, module_map), j_grads, 1e-4, "d log_prob")


@pytest.mark.parametrize("case", ["grpo", "grpo-guard"])
def test_wan_grpo_loss_and_grads_match_jax(pair, case):
    """One micro-batch at one timestep through the JAX trainer's own
    ``_grad_fn`` and the port's ``loss_and_grads``, old log-probs chosen so
    that the clip binds on two samples (GRPO) or GRPO-Guard's σ-normalised
    ratio with the mean drift: loss and aux metrics 1e-5, gradients 1e-4
    relative to each leaf's max."""
    from flow_factory_tpu.trainers.grpo import GRPOTrainer as JGRPO
    from flow_factory_tpu_torch.trainers.grpo import GRPOTrainer

    ja, pa, batch, module_map = pair
    guard = case == "grpo-guard"
    new_lp = np.asarray(ja.training_forward(ja.trainable, _jbatch(batch)).log_prob)
    batch = {**batch, "old_log_prob": (new_lp + np.asarray([-0.05, 0.5, -0.4, -0.1], np.float32))}

    jt = object.__new__(JGRPO)
    jt.training_args, jt.use_guard, jt.adapter = copy.copy(ja.training_args), guard, ja
    (j_loss, j_aux), j_grads = jt._grad_fn(ja.trainable, ja.frozen_velocity_params(), _jbatch(batch), None)

    pt = object.__new__(GRPOTrainer)
    pt.training_args, pt.use_guard, pt.adapter = copy.copy(pa.training_args), guard, pa
    (loss, aux), grads = pt.loss_and_grads(_tbatch(batch))

    assert sorted(aux) == sorted(j_aux)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5, atol=1e-7)
    for k in j_aux:
        np.testing.assert_allclose(float(aux[k]), float(j_aux[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    assert 0.0 < float(aux["train/clip_frac"]) < 1.0 or guard
    _leaf_close(_port_grads_as_flax(pa, grads, module_map),
                jax.tree.map(np.asarray, j_grads)["transformer"], 1e-4, case)


def test_wan_gradient_checkpointing_recomputes_blocks_and_keeps_every_gradient_bit(pair):
    """``enable_gradient_checkpointing`` (the JAX ``nn.remat(WanBlock)``):
    the adapter's DiT gets ``remat``, each block runs again in the backward
    on the LoRA-merged weights, and every LoRA gradient is bit-identical to
    the run without it."""
    _, pa, batch, _ = pair
    ra = _port_adapter(enable_gradient_checkpointing=True)
    assert ra.component_configs["transformer"].remat and not pa.component_configs["transformer"].remat
    ra.load_state_dicts({"transformer": pa.modules["transformer"].state_dict()})
    ra.load_lora("transformer", {p: {k: v.detach() for k, v in ab.items()}
                                 for p, ab in pa.trainable["transformer"].items()})
    grads, calls = [], []
    for adapter in (pa, ra):
        blocks = adapter.modules["transformer"].blocks
        n = [0]
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


def test_wan_eval_generators_give_a_prompt_the_same_video_in_any_batch(pair):
    """``generators_for_prompts`` (the JAX ``keys_for_prompts``): in an eval
    rollout a prompt draws the same x0, bit for bit, and decodes to the same
    video (1e-5: its batch partner may change the CPU kernels' blocking)
    whether it comes first or second in its batch; another prompt draws
    other noise."""
    from flow_factory_tpu_torch.utils.base import generators_for_prompts

    _, pa, _, _ = pair
    other = "a border collie catching a frisbee"
    pa.eval()
    try:
        runs = [pa.inference(prompt=ps, generator=generators_for_prompts(ps, 42, "cpu"), num_inference_steps=3,
                             compute_log_prob=False) for ps in ([PROMPT, other], [other, PROMPT])]
    finally:
        pa.train()
    (a, b), (c, d) = runs
    np.testing.assert_array_equal(a.all_latents[0], d.all_latents[0])
    np.testing.assert_array_equal(b.all_latents[0], c.all_latents[0])
    np.testing.assert_allclose(a.video, d.video, atol=1e-5, rtol=0)
    assert not np.allclose(a.all_latents[0], b.all_latents[0])


def test_wan_training_slice_runs_two_epochs_with_evaluation(tmp_path):
    """``load_trainer(...).start()`` on tests/fixtures/smoke_grpo_wan.yaml
    (the tiny Wan, CFG 5, EMA 0.9 every epoch, ``eval_freq: 1``): in both epochs the
    ratio is exactly 1.0 with no clipping, the grad norm > 0 and the loss
    finite; the LoRA ``B`` moved; an evaluation of the 2 test prompts under
    the EMA weights precedes each epoch and logs the metric keys of the JAX
    ``gather_eval_reward_metrics``, whose values the port's function
    reproduces on the same samples."""
    from flow_factory_tpu.trainers.abc import gather_eval_reward_metrics as jax_gather
    from flow_factory_tpu_torch import ops
    from flow_factory_tpu_torch.hparams import Arguments
    from flow_factory_tpu_torch.trainers import load_trainer
    from flow_factory_tpu_torch.trainers.abc import gather_eval_reward_metrics

    cfg = Arguments.load_from_yaml(os.path.join(REPO, "tests/fixtures/smoke_grpo_wan.yaml"))
    cfg.data_args.cache_dir = str(tmp_path / "cache")
    cfg.log_args.save_dir = str(tmp_path / "saves")
    trainer = load_trainer(cfg, device="cpu")
    b0 = {p: ab["lora_B"].detach().clone() for p, ab in trainer.adapter.trainable["transformer"].items()}
    ops.reset_launch_counts()
    try:
        trainer.start()
        again = trainer.evaluate(2)
    finally:
        trainer.cleanup()
    rows = [json.loads(line) for line in open(tmp_path / "saves" / cfg.log_args.run_name / "metrics.jsonl")]
    train_rows = [r for r in rows if "train/ratio_mean" in r]
    eval_rows = [r for r in rows if "eval/reward_mean" in r]
    assert [r["step"] for r in train_rows] == [0, 1] and [r["step"] for r in eval_rows] == [0, 1, 2]
    for row in train_rows:
        assert row["train/ratio_mean"] == 1.0 and row["train/ratio_min"] == row["train/ratio_max"] == 1.0
        assert row["train/clip_frac"] == 0.0
        assert row["train/grad_norm"] > 0 and np.isfinite(row["train/loss"])
    assert trainer.global_step == 2 and trainer.adapter.ema is not None
    moved = max((trainer.adapter.trainable["transformer"][p]["lora_B"] - b).abs().max().item()
                for p, b in b0.items())
    assert moved > 0
    assert ops.launch_counts() == {name: 0 for name in ops.KERNEL_WRAPPERS}  # CPU: plain versions only

    samples = trainer.reward_buffer.samples
    theirs = jax_gather(samples)
    assert gather_eval_reward_metrics(samples) == pytest.approx(theirs, rel=1e-12)
    assert sorted(again) == sorted(theirs) and again["eval/num_samples"] == 2.0
    assert all(np.isfinite(v) for v in again.values()) and trainer.eval_reward_buffer.samples == []


def _tiny_fp32_fixture(tmp_path) -> dict:
    """tests/fixtures/wan21_fp32_grpo.yaml (the card's [wan-fp32]) at the tiny
    preset: its trainer settings as they stand, the model ``tiny`` at 32 px
    over the tiny prompts, with the LoRA rank of ``pair`` (4 / 8) so that the
    pair's LoRA loads."""
    import yaml

    with open(os.path.join(REPO, "tests/fixtures/wan21_fp32_grpo.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["model"].pop("variant")
    cfg["model"].update(model_name_or_path="tiny", lora_rank=4, lora_alpha=8)
    cfg["data"].update(dataset_dir="tests/fixtures/tiny_prompts", cache_dir=str(tmp_path / "cache"))
    cfg["train"]["resolution"] = cfg["eval"]["resolution"] = 32
    cfg["log"]["save_dir"] = str(tmp_path / "saves")
    return cfg


def test_wan21_fp32_grpo_fixture_trains_an_epoch_held_to_jax(pair, tmp_path):
    """The [wan-fp32] fixture's trainer at the tiny preset on the CPU, fp32
    under ``attn_backend: auto`` (native off the accelerator, as in JAX; the
    plain versions, no kernel), 4 steps, one train timestep, remat, on the
    weights and LoRA of ``pair``, for one epoch through ``load_trainer``:
    one grad step with ratio exactly 1.0 and clip_frac 0, finite log-probs,
    the LoRA moved. Its grad step's batch, through the JAX trainer's
    ``_grad_fn`` at the fixture's clip ranges on the same weights and LoRA,
    gives the port's loss and aux metrics within 1e-5 and every LoRA
    gradient within 1e-4 of its leaf's max (the bars of the GRPO parity
    test above)."""
    from flow_factory_tpu.hparams.args import Arguments as JArgs
    from flow_factory_tpu.trainers.grpo import GRPOTrainer as JGRPO
    from flow_factory_tpu_torch.hparams import Arguments
    from flow_factory_tpu_torch.trainers import load_trainer

    ja, pa, _, module_map = pair
    cfg = _tiny_fp32_fixture(tmp_path)
    args = Arguments.from_dict(cfg)
    assert (args.mixed_precision, args.model_args.attn_backend, args.model_args.inference_dtype) == \
        ("no", "auto", "float32")
    trainer = load_trainer(args, device="cpu")
    ad = trainer.adapter
    assert ad.component_configs["transformer"].remat
    ad.load_state_dicts({"transformer": pa.modules["transformer"].state_dict()})
    with torch.no_grad():  # in place: the trainer's optimizer holds these leaves
        for p, ab in pa.trainable["transformer"].items():
            for k, v in ab.items():
                ad.trainable["transformer"][p][k].copy_(v)
    steps = []
    real = trainer.backward_step

    def spy(batch, ref_trainable=None):
        loss, aux = real(batch, ref_trainable)
        steps.append((batch, {k: float(v) for k, v in aux.items()},
                      [p.grad.clone() for p in ad.trainable_leaves()]))
        return loss, aux

    trainer.backward_step = spy
    b0 = {p: ab["lora_B"].detach().clone() for p, ab in ad.trainable["transformer"].items()}
    try:
        trainer.epoch = 0
        samples = trainer.sample(0)
        trainer.prepare_feedback(samples)
        info = trainer.optimize(samples, 0)
    finally:
        trainer.cleanup()
    assert len(steps) == 1 and trainer.global_step == 1
    assert info["train/ratio_min"] == info["train/ratio_max"] == 1.0 and info["train/clip_frac"] == 0.0
    assert all(np.isfinite(s.log_probs).all() for s in samples)
    assert max((ad.trainable["transformer"][p]["lora_B"] - b).abs().max().item() for p, b in b0.items()) > 0

    batch, aux, grads = steps[0]
    jt = object.__new__(JGRPO)
    jt.training_args, jt.use_guard, jt.adapter = JArgs.from_dict(copy.deepcopy(cfg)).training_args, False, ja
    jbatch = {k: jnp.asarray(v.numpy() if torch.is_tensor(v) else np.float32(v)) for k, v in batch.items()
              if k != "timestep_host"}
    (j_loss, j_aux), j_grads = jt._grad_fn(ja.trainable, ja.frozen_velocity_params(), jbatch, None)
    assert sorted(aux) == sorted(j_aux)
    for k in j_aux:
        np.testing.assert_allclose(aux[k], float(j_aux[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    _leaf_close(_port_grads_as_flax(ad, grads, module_map), jax.tree.map(np.asarray, j_grads)["transformer"],
                1e-4, "the fixture's grad step")
