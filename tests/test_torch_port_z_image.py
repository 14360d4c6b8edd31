"""PyTorch port, the Z-Image slice against the JAX package, fp32 on the CPU
at tiny size: the single-stream transformer (sandwich RMS norms, tanh
gates, per-head qk-norm, RoPE, the final K5 modulation to fp32) with and
without remat; a true-CFG rollout (guidance 4, the negative prompt "") and
the Turbo rollout (guidance 0, no negatives, no CFG) from the same x0 and
noise, with their decodes and replays (ratio exactly 1.0); the GRPO loss
and LoRA gradients against the JAX ``_grad_fn``; one GRPO epoch through
``load_trainer``.

One tiny JAX adapter is built once for the module; the port's twin runs on
its weights through the bridge and a LoRA with a non-zero ``b``; the
velocities take the JAX timestep features (``shared_time_features``). Bars:
a single forward 2e-5, a trajectory 1e-4."""
import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_threads import one_torch_thread  # noqa: F401

from test_torch_port_flux import _config_dict, _host, shared_time_features  # noqa: F401
from test_torch_port_qwen_image import _jax_noise, _port_rollout, _step_batch

REPO = os.path.dirname(os.path.abspath(__file__)).rsplit(os.sep, 1)[0]
SMOKE = os.path.join(REPO, "tests", "fixtures", "smoke_grpo_z_image.yaml")
SEED = 15  # the seed of test_torch_port_qwen_image's noise helpers
PROMPTS = ["a photo of a red fox in the snow", "a watercolor painting of a lighthouse"]


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


def _cfg(**train):
    return _config_dict(data={"dataset_dir": "tests/fixtures/tiny_prompts"}, model={"model_type": "z-image"},
                        train={"trainer_type": "grpo", "clip_range": 0.2, "adv_clip_range": 1.5,
                               "guidance_scale": 4.0, **train})


@pytest.fixture(scope="module")
def z():
    """The tiny Z-Image pair, the prompts' and "" negatives' embeddings, and
    each package's 4-step CFG rollout and Turbo rollout (guidance 0, no
    negatives) on the JAX embeddings, x0 and noise."""
    from flow_factory_tpu.hparams.args import Arguments as JArgs
    from flow_factory_tpu.models import load_adapter as jax_load
    from flow_factory_tpu.parallel.dist import set_world_size_override
    from flow_factory_tpu_torch.hparams import Arguments
    from flow_factory_tpu_torch.models import load_adapter
    from flow_factory_tpu_torch.utils import weights

    set_world_size_override(1)
    try:
        ja = jax_load(JArgs.from_dict(_cfg()))
        rng = np.random.default_rng(9)
        lora = {p: {"a": ab["a"], "b": (0.05 * rng.standard_normal(ab["b"].shape)).astype(np.float32)}
                for p, ab in _host(ja.trainable["transformer"]).items()}
        ja.trainable = {"transformer": jax.tree.map(jnp.asarray, lora)}
        j_pre = ja.preprocess_func({"prompt": PROMPTS})
        ja.rollout()
        j_cfg = ja.inference(prompt=PROMPTS, seed=SEED, **j_pre)
        j_turbo = ja.inference(prompt=PROMPTS, seed=SEED, prompt_embeds=j_pre["prompt_embeds"], guidance_scale=0.0)
        ja.train()
    finally:
        set_world_size_override(None)
    pa = load_adapter(Arguments.from_dict(_cfg()), device="cpu")
    pa.load_state_dicts(weights.z_image_state_dicts(_host(ja.params), pa.component_configs))
    module_map = weights.z_image_component_maps(pa.component_configs)["transformer"][0]
    pa.load_lora("transformer", weights.lora_from_flax(lora, module_map))
    p_pre = pa.preprocess_func({"prompt": PROMPTS})
    p_cfg = _port_rollout(pa, 2, prompt=PROMPTS, **j_pre)
    p_turbo = _port_rollout(pa, 2, prompt=PROMPTS, prompt_embeds=j_pre["prompt_embeds"], guidance_scale=0.0)
    return dict(ja=ja, pa=pa, j_pre=j_pre, p_pre=p_pre, module_map=module_map,
                samples={"cfg": (j_cfg, p_cfg), "turbo": (j_turbo, p_turbo)})


@pytest.mark.parametrize("remat", [False, True])
def test_z_image_transformer_matches_jax(remat, shared_time_features):
    """The tiny transformer (3 blocks, width 64, 4 heads of 16, SwiGLU 128)
    through the bridge, 16 image + 6 text tokens: the image tokens' fp32
    velocity (2, 16, 16) within 2e-5 of the JAX ``ZImageTransformer``; under
    remat the output and the input gradient equal the un-rematted ones bit
    for bit."""
    from flow_factory_tpu.models.z_image.transformer import ZImageConfig as JCfg, ZImageTransformer as JZ
    from flow_factory_tpu_torch.models.z_image.transformer import ZImageConfig, ZImageTransformer
    from flow_factory_tpu_torch.utils import weights

    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 16, 16)).astype(np.float32)
    ctx = (3.0 * rng.standard_normal((2, 6, 32))).astype(np.float32)
    t = np.asarray([800.0, 120.0], np.float32)
    img_ids = np.stack([np.zeros(16), np.repeat(np.arange(4), 4), np.tile(np.arange(4), 4)], 1).astype(np.float32)
    txt_ids = np.zeros((6, 3), np.float32)
    jm = JZ(JCfg.tiny(dtype="float32", attn_backend="native"))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), x, t, ctx, img_ids, txt_ids)["params"]
    params = jax.tree.map(lambda a: a + 0.02 * jax.random.normal(jax.random.PRNGKey(3), a.shape), params)
    theirs = np.asarray(jax.jit(jm.apply)({"params": params}, x, t, ctx, img_ids, txt_ids))
    sd = weights.convert(_host(params), *weights.z_image_transformer_map(3))
    outs = []
    for r in sorted({False, remat}):
        pm = ZImageTransformer(ZImageConfig.tiny(dtype="float32", remat=r))
        pm.load_state_dict(sd, strict=True)
        xt = torch.from_numpy(x).requires_grad_()
        out = pm(xt, *(torch.from_numpy(a) for a in (t, ctx, img_ids, txt_ids)))
        out.square().sum().backward()
        outs.append((out.detach().numpy(), xt.grad.numpy()))
    assert outs[0][0].shape == theirs.shape == (2, 16, 16) and outs[0][0].dtype == np.float32
    np.testing.assert_allclose(outs[0][0], theirs, atol=2e-5, rtol=0)
    assert all(np.array_equal(a, b) for a, b in zip(outs[0], outs[-1]))


def test_lora_targets_and_bridge_match_jax(z):
    """The seven LoRA targets a block (to_q/k/v/out, w1/w2/w3) are the JAX
    ``Z_IMAGE_LORA_TARGETS``' paths through the bridge; every flax leaf of
    the three components maps onto every port parameter, values equal."""
    from flow_factory_tpu_torch.utils import weights

    ja, pa = z["ja"], z["pa"]
    assert len(pa.trainable["transformer"]) == 7 * 3
    assert set(weights.lora_to_flax(pa.trainable["transformer"], z["module_map"])) == set(ja.trainable["transformer"])
    flax = _host(ja.params)
    for comp, sd in weights.z_image_state_dicts(flax, pa.component_configs).items():
        live = pa.modules[comp].state_dict()
        assert set(sd) == set(live) and all(torch.equal(sd[k], live[k]) for k in sd), comp


@pytest.mark.parametrize("mode", ["cfg", "turbo"])
def test_rollout_matches_jax_and_replays_with_ratio_one(mode, z, shared_time_features):
    """The 4-step Flow-SDE rollout, true CFG at guidance 4 (negatives "") or
    Turbo's guidance 0 with no negatives and no CFG batch: every stored
    latent and the SDE steps' log-probs within the trajectory bar 1e-4,
    images 1e-4; the samples keep the negatives only under CFG; the port's
    no-grad replay of every stored step gives exp(new − old) == 1.0 exactly;
    the prompts' and negatives' embeddings 1e-5 of JAX's."""
    for key in ("prompt_embeds", "negative_prompt_embeds"):
        np.testing.assert_allclose(z["p_pre"][key], z["j_pre"][key], atol=1e-5, rtol=0)
    j_samples, p_samples = z["samples"][mode]
    sde = np.nonzero(p_samples[0].extra_kwargs["noise_levels"])[0]
    for i, (js, ps) in enumerate(zip(j_samples, p_samples)):
        assert ps.all_latents.shape == js.all_latents.shape == (5, 64, 16)
        np.testing.assert_allclose(ps.all_latents, js.all_latents, atol=1e-4, rtol=0)
        np.testing.assert_allclose(ps.log_probs[sde], js.log_probs[sde], atol=1e-4, rtol=0)
        np.testing.assert_allclose(ps.image, js.image, atol=1e-4, rtol=0)
        if mode == "cfg":
            np.testing.assert_array_equal(ps.negative_prompt_embeds, z["j_pre"]["negative_prompt_embeds"][i])
        else:
            assert ps.negative_prompt_embeds is None and js.negative_prompt_embeds is None
    if mode == "turbo":  # CFG changes the trajectory
        assert np.abs(p_samples[0].all_latents[-1] - z["samples"]["cfg"][1][0].all_latents[-1]).max() > 1e-3
    new = z["pa"].replay_log_probs(p_samples)
    old = np.stack([s.log_probs for s in p_samples], axis=1)
    assert sorted(new) == [0, 1, 2, 3]
    for i, lp in new.items():
        assert np.all(np.exp(lp.numpy().astype(np.float64) - old[i]) == 1.0), i


@pytest.mark.parametrize("threads", [4, 8])
def test_shuffled_replay_is_exact_at_several_threads(threads, z):
    """F19: at ``threads`` intra-op threads, a CFG rollout of four prompts
    and the no-grad replay of its rows in another order (the shuffled
    micro-batch of a grad step) give exp(new − old) == 1.0 exactly on every
    stored step, as the JAX package's replay does (the SDE steps' ratio and
    the zero-noise steps' log-prob, which a velocity an ulp off moves by
    ~1e10). The thread count is restored afterwards."""
    pa = z["pa"]
    embeds = {k: np.concatenate([v, v]) for k, v in z["p_pre"].items()
              if k in ("prompt_embeds", "negative_prompt_embeds")}
    perm = [3, 0, 2, 1]
    n = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        pa.rollout()
        samples = pa.inference(prompt=PROMPTS * 2, seed=SEED, **embeds)
        pa.train()
        new = pa.replay_log_probs([samples[i] for i in perm])
    finally:
        torch.set_num_threads(n)
        pa.train()
    assert len(samples) == 4 and samples[0].negative_prompt_embeds is not None
    old = np.stack([samples[i].log_probs for i in perm], axis=1)
    assert sorted(new) == [0, 1, 2, 3]
    for i, lp in new.items():
        assert np.all(np.exp(lp.numpy().astype(np.float64) - old[i]) == 1.0), (i, lp.numpy() - old[i])


def test_grpo_loss_and_lora_grads_match_jax(z, shared_time_features):
    """The CFG rollout's batch at its first SDE step through the JAX GRPO
    ``_grad_fn`` and the port's ``loss_and_grads``, the old log-probs moved
    so that the clip (0.2) binds on one row: loss and every aux metric 1e-5
    (relative, absolute below 1e-7), every LoRA gradient leaf 1e-4 of its
    max."""
    from flow_factory_tpu.trainers.grpo import GRPOTrainer as JGRPO
    from flow_factory_tpu_torch.trainers.grpo import GRPOTrainer
    from test_torch_port_train import _leaf_close, _port_grads_as_flax

    ja, pa = z["ja"], z["pa"]
    samples = z["samples"]["cfg"][1]
    step = int(np.nonzero(samples[0].extra_kwargs["noise_levels"])[0][0])
    shift, adv = np.asarray([-0.05, 0.5], np.float32), np.asarray([1.2, -0.7], np.float32)
    keys = list(pa.embed_keys)
    jt, pt = object.__new__(JGRPO), object.__new__(GRPOTrainer)
    for trainer, adapter in ((jt, ja), (pt, pa)):
        trainer.training_args, trainer.use_guard, trainer.adapter = adapter.training_args, False, adapter
    (j_loss, j_aux), j_grads = jt._grad_fn(ja.trainable, ja.frozen_velocity_params(),
                                           _step_batch(samples, step, jnp.asarray, keys, shift, adv), None)
    (loss, aux), grads = pt.loss_and_grads(_step_batch(samples, step, torch.from_numpy, keys, shift, adv))
    assert sorted(aux) == sorted(j_aux)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5, atol=1e-7)
    for k in j_aux:
        np.testing.assert_allclose(float(aux[k]), float(j_aux[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    assert float(aux["train/clip_frac"]) == 0.5
    _leaf_close(_port_grads_as_flax(pa, grads, z["module_map"]),
                jax.tree.map(np.asarray, j_grads)["transformer"], 1e-4, "z-image grpo")


def test_z_image_grpo_epoch_through_load_trainer(tmp_path):
    """``load_trainer(cfg, device="cpu").start()`` on
    tests/fixtures/smoke_grpo_z_image.yaml (remat on): one epoch of CFG
    rollouts whose samples keep their "" negatives, finite metrics, one
    optimizer step, a moved LoRA, and no kernel launch on the CPU. The grad
    steps replay the rollout's rows shuffled, with every ratio exactly 1.0
    (F19: the CPU forward runs one sample a call, so a row's bits do not
    follow its place in the batch; at several threads:
    ``test_shuffled_replay_is_exact_at_several_threads``)."""
    from flow_factory_tpu_torch import ops
    from flow_factory_tpu_torch.hparams import Arguments
    from flow_factory_tpu_torch.models.z_image import ZImageAdapter
    from flow_factory_tpu_torch.trainers import load_trainer

    cfg = Arguments.load_from_yaml(SMOKE)
    cfg.data_args.cache_dir = str(tmp_path / "cache")
    cfg.log_args.save_dir = str(tmp_path / "saves")
    trainer = load_trainer(cfg, device="cpu")
    assert isinstance(trainer.adapter, ZImageAdapter)
    assert trainer.adapter.component_configs["transformer"].remat
    b0 = {p: ab["lora_B"].detach().clone() for p, ab in trainer.adapter.trainable["transformer"].items()}
    ops.reset_launch_counts()
    try:
        trainer.start()
    finally:
        trainer.cleanup()
    rows = [json.loads(line) for line in open(tmp_path / "saves" / "smoke_grpo_z_image" / "metrics.jsonl")]
    train = [r for r in rows if "train/loss" in r]
    assert len(train) == 1 and trainer.global_step == 1
    assert all(np.isfinite(v) for k, v in train[0].items() if k.startswith(("train/", "reward/")))
    stat = lambda key, how: train[0].get(f"{key}_{how}", train[0].get(key))
    assert stat("train/ratio_min", "min") == stat("train/ratio_max", "max") == 1.0
    assert all(s.negative_prompt_embeds.shape == (16, 32) for s in trainer.reward_buffer.samples)
    assert max((trainer.adapter.trainable["transformer"][p]["lora_B"] - b).abs().max().item()
               for p, b in b0.items()) > 0
    assert ops.launch_counts() == {name: 0 for name in ops.KERNEL_WRAPPERS}
