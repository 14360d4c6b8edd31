"""PyTorch port, Wan2.2 under GRPO on the CPU: each step's expert on the
card fixture's own 10-step schedule in both packages (one timestep lands on
the boundary, 875.0), then ``load_trainer(...).start()`` on the tiny MoE
(both experts trained, the untaken expert's LoRA given exact zeros on each
grad step, replay ratio exactly 1.0) and on the tiny TI2V I2V
(``expand_timesteps``) over the images of dataset/sharegpt4o_image_mini."""
import copy
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _isolated():
    """The JAX package's world-size override is process-wide: reset it before
    and after this module (F0). One intra-op torch thread: the tiny models
    run as fast on it, and the parallel test workers then do not
    oversubscribe the CPUs they share (with every worker's torch on all
    cores, the tiny GRPO epochs here ran 50-90x slower)."""
    from flow_factory_tpu.parallel.dist import set_world_size_override

    set_world_size_override(None)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    set_world_size_override(None)


def spy_on_grad_steps(trainer, record):
    """Wrap ``trainer.backward_step``: after each grad step ``record(batch,
    aux, live)``, ``live`` the sorted trainable components whose leaves the
    step's gradient reached (their ``.grad``, where the trainer accumulates,
    changed)."""
    real = trainer.backward_step

    def reached(grad, before) -> bool:
        if grad is None:
            return False
        return bool(grad.abs().max() > 0) if before is None else not torch.equal(grad, before)

    def spy(batch, ref_trainable=None):
        ad = trainer.adapter
        leaves = {c: ad.trainable_leaves({c: ad.trainable[c]}) for c in sorted(ad.trainable)}
        before = {c: [None if p.grad is None else p.grad.clone() for p in ls] for c, ls in leaves.items()}
        out = real(batch, ref_trainable)
        live = [c for c, ls in leaves.items() if any(reached(p.grad, b) for p, b in zip(ls, before[c]))]
        record(batch, out[1], live)
        return out

    trainer.backward_step = spy


def test_moe_routes_on_the_card_fixtures_schedule_match_jax():
    """tests/fixtures/wan22_a14b_grpo.yaml's schedule (10 steps, flow shift
    3): the two packages' timesteps are equal bit for bit, step 3 is 875.0
    exactly, and the port's host rule routes every step as JAX's fp32
    comparison does: the first four steps (875.0 included) to the
    high-noise expert."""
    import jax.numpy as jnp
    import yaml

    from flow_factory_tpu.scheduler.registry import get_scheduler_class as jax_scheduler
    from flow_factory_tpu_torch.models.wan.t2v import WanT2VAdapter
    from flow_factory_tpu_torch.scheduler.registry import get_scheduler_class

    with open(os.path.join(REPO, "tests/fixtures/wan22_a14b_grpo.yaml")) as f:
        cfg = yaml.safe_load(f)
    steps, s = cfg["train"]["num_inference_steps"], cfg["scheduler"]
    kw = dict(noise_level=s["noise_level"], sde_steps=s["sde_steps"], num_sde_steps=s["num_sde_steps"],
              seed=s["seed"], dynamics_type=s["dynamics_type"], shift=3.0)
    ours = np.asarray(get_scheduler_class("unipc")(**kw).set_timesteps(steps), np.float32)
    theirs = np.asarray(jax_scheduler("unipc")(**kw).set_timesteps(steps), np.float32)
    np.testing.assert_array_equal(ours, theirs)
    assert ours[3] == np.float32(875.0)
    adapter = SimpleNamespace(boundary_ratio=0.875)
    routes = [WanT2VAdapter.routes_high(adapter, t) for t in ours]
    assert routes == [bool(jnp.float32(t) >= jnp.float32(0.875 * 1000.0)) for t in theirs]
    assert routes == [True] * 4 + [False] * 6


def _config(model_type, tmp_path, model=None, train=None, data=None):
    from flow_factory_tpu_torch.hparams import Arguments

    cfg = {
        "data": {"dataset_dir": os.path.join(REPO, "tests/fixtures/tiny_prompts"), "sampler_type": "group_contiguous",
                 "cache_dir": str(tmp_path / "cache"), **(data or {})},
        "model": {"model_type": model_type, "model_name_or_path": "tiny", "finetune_type": "lora",
                  "lora_rank": 4, "lora_alpha": 8, "attn_backend": "native", "master_dtype": "float32",
                  "inference_dtype": "float32", **(model or {})},
        "scheduler": {"dynamics_type": "Flow-SDE", "noise_level": 0.7, "num_sde_steps": 3, "sde_steps": [0, 1, 2],
                      "seed": 42},
        "train": {"trainer_type": "grpo", "resolution": 32, "num_inference_steps": 4, "guidance_scale": 5.0,
                  "per_device_batch_size": 2, "group_size": 2, "unique_sample_num_per_epoch": 2,
                  "gradient_step_per_epoch": 1, "max_epochs": 2, "learning_rate": 1e-3, "clip_range": 1e-4,
                  "adv_clip_range": 5.0, "latent_storage_dtype": "fp32", "num_frames": 5, "ema_decay": 0,
                  "seed": 42, **(train or {})},
        "eval": {"eval_freq": 0}, "log": {"run_name": "run", "logging_backend": "none",
                                          "save_dir": str(tmp_path / "saves"), "save_freq": 0},
        "rewards": [{"name": "brightness", "reward_model": "MyReward", "batch_size": 8}],
    }
    return Arguments.from_dict(copy.deepcopy(cfg))


def _start(trainer, tmp_path):
    """Run the trainer with a spy on each grad step: its host timestep, the
    trainable components whose LoRA got a non-zero gradient, and the batch
    keys; returns the records and the train rows of metrics.jsonl."""
    seen = []
    spy_on_grad_steps(trainer, lambda batch, aux, live: seen.append((batch["timestep_host"], live, batch)))
    try:
        trainer.start()
    finally:
        trainer.cleanup()
    with open(tmp_path / "saves" / "run" / "metrics.jsonl") as f:
        rows = [r for r in map(json.loads, f) if "train/ratio_mean" in r]
    return seen, rows


def _assert_ratio_one(rows, epochs):
    assert [r["step"] for r in rows] == list(range(epochs))
    for row in rows:
        assert row["train/ratio_min"] == row["train/ratio_max"] == 1.0 and row["train/clip_frac"] == 0.0
        assert row["train/grad_norm"] > 0 and np.isfinite(row["train/loss"])


def test_moe_grpo_trains_each_expert_on_its_own_steps(tmp_path):
    """Two GRPO epochs of the tiny MoE (boundary 0.8: steps 0-1 high, 2
    low; ``guidance_scale_2`` 3) through ``load_trainer``: on every grad
    step exactly the routed expert's LoRA gets a non-zero gradient and the
    other expert's exact zeros; ratio exactly 1.0; both LoRAs moved."""
    from flow_factory_tpu_torch.trainers import load_trainer

    trainer = load_trainer(_config("wan22", tmp_path, {"boundary_ratio": 0.8}, {"guidance_scale_2": 3.0}),
                           device="cpu")
    ad = trainer.adapter
    b0 = {c: {p: ab["lora_B"].detach().clone() for p, ab in t.items()} for c, t in ad.trainable.items()}
    seen, rows = _start(trainer, tmp_path)
    _assert_ratio_one(rows, 2)
    assert len(seen) == 2 * 2 * 3  # epochs x micro-batches x train steps
    for t, live, _ in seen:
        assert live == (["transformer_2"] if t >= 800.0 else ["transformer"]), (t, live)
    assert {t >= 800.0 for t, _, _ in seen} == {True, False}
    for comp, tree in b0.items():
        assert max((ad.trainable[comp][p]["lora_B"] - b).abs().max().item() for p, b in tree.items()) > 0, comp


def test_ti2v_i2v_grpo_epoch_on_the_image_dataset(tmp_path):
    """One GRPO epoch of the tiny TI2V I2V (``expand_timesteps``) on two
    records of dataset/sharegpt4o_image_mini (64 px): the preprocessing
    encodes each image to its clean frame-0 latent, every grad step stages
    the ``cond_latents``, ratio exactly 1.0; finite videos (their frame-0
    composite is held to JAX in tests/test_torch_port_wan22.py)."""
    from flow_factory_tpu_torch.trainers import load_trainer

    cfg = _config("wan2-i2v", tmp_path, {"expand_timesteps": True}, {"resolution": 64, "max_epochs": 1},
                  {"dataset_dir": os.path.join(REPO, "dataset/sharegpt4o_image_mini")})
    trainer = load_trainer(cfg, device="cpu")
    seen, rows = _start(trainer, tmp_path)
    _assert_ratio_one(rows, 1)
    assert seen and all(b["cond_latents"].shape == (2, 3, 32, 32, 16) for _, _, b in seen)
    samples = trainer.reward_buffer.samples
    assert len(samples) == 4 and all(s.video.shape == (5, 3, 64, 64) for s in samples)
    cond = np.stack([s.extra_kwargs["cond_latents"] for s in samples])
    assert np.any(cond[:, 0]) and not np.any(cond[:, 1:])
    assert all(np.isfinite(s.video).all() for s in samples)


def test_nft_on_the_moe_gives_the_untaken_expert_zeros(tmp_path):
    """A decoupled trainer on the MoE (one DiffusionNFT epoch of the tiny
    MoE through ``load_trainer``): each grad step routes on row 0's t, as
    JAX does (the trainer gives it from the host as ``timestep_host``); it
    adds a gradient to the routed expert's LoRA and nothing to the other
    expert's, which the update then takes as exact zeros, as under
    ``jax.grad``."""
    from flow_factory_tpu_torch.models.wan.t2v import WanT2VAdapter
    from flow_factory_tpu_torch.trainers import load_trainer

    cfg = _config("wan22", tmp_path, {"boundary_ratio": 0.3},  # logit-normal t fall on both sides of 300
                  {"trainer_type": "nft", "nft_beta": 1.0, "num_train_timesteps": 4, "max_epochs": 1,
                   "time_sampling_strategy": "logit_normal"})
    trainer = load_trainer(cfg, device="cpu")
    assert isinstance(trainer.adapter, WanT2VAdapter)
    seen = []
    spy_on_grad_steps(trainer, lambda batch, aux, live: seen.append((float(batch["timestep"][0]), live)))
    try:
        trainer.start()
    finally:
        trainer.cleanup()
    assert len(seen) == 2 * 4 and {tuple(live) for _, live in seen} == {("transformer",), ("transformer_2",)}
    for t, live in seen:
        assert live == (["transformer_2"] if trainer.adapter.routes_high(t) else ["transformer"]), (t, live)
