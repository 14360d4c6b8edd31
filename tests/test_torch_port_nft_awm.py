"""PyTorch port, the DiffusionNFT and AWM trainers against the JAX package,
fp32 on the CPU: ``weighted_log_prob`` in all five weightings; the NFT and
AWM losses, their aux metrics and LoRA gradients against the JAX trainers'
own ``_grad_fn`` at the same (t, ε), with the KL terms off and on, over the
tiny FLUX.1-Kontext adapter (condition tokens) and the tiny SD3.5 adapter
(the CFG-doubled decoupled velocity); two epochs of each trainer through
``load_trainer`` on the tiny Kontext smoke configs, where the optimizer
steps once an epoch, so that on every grad step the current policy is the
sampling policy bit for bit; and the trainer registry.

Both packages run on the JAX adapter's weights and a LoRA with a non-zero
``b`` through the weight bridge, and get the same noise and the same old
policy's quantities (the port draws its noise from torch generators, the
JAX package from its keys); the FLUX velocities take the JAX timestep
features (``shared_time_features``, tests/test_torch_port_flux.py)."""
import copy
import json
import os
import signal
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_threads import one_torch_thread  # noqa: F401

from test_torch_port_flux import _config_dict, _host, shared_time_features  # noqa: F401 (a fixture)
from test_torch_port_train import CONFIG as SD35_CONFIG, _leaf_close, _port_grads_as_flax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 4


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


# ---------------------------------------------------------------------------
# weighted_log_prob
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weighting", ["Uniform", "t", "t**2", "huber", "ghuber", "bogus"])
def test_weighted_log_prob_matches_jax(weighting):
    """The (B,) weighted matching log-prob of the port against JAX's on the
    same fp32 inputs (timesteps past 1000 clipped to σ 1), ghuber at power
    0.7: 1e-6 relative; an unknown weighting raises ``ValueError`` in both."""
    from flow_factory_tpu.trainers.awm import weighted_log_prob as J
    from flow_factory_tpu_torch.trainers.awm import weighted_log_prob as T

    rng = np.random.default_rng(1)
    v, target = (rng.standard_normal((3, 6, 5)).astype(np.float32) for _ in range(2))
    t = np.asarray([980.0, 250.0, 1200.0], np.float32)
    if weighting == "bogus":
        for fn, lib in ((J, jnp.asarray), (T, torch.from_numpy)):
            with pytest.raises(ValueError):
                fn(lib(v), lib(target), lib(t), weighting, 0.7)
        return
    ours = T(torch.from_numpy(v), torch.from_numpy(target), torch.from_numpy(t), weighting, 0.7).numpy()
    theirs = np.asarray(J(jnp.asarray(v), jnp.asarray(target), jnp.asarray(t), weighting, 0.7))
    assert ours.shape == theirs.shape == (3,) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, theirs, rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# The losses against the JAX _grad_fn
# ---------------------------------------------------------------------------

def _pair(config, state_dicts, module_map_of):
    """The JAX adapter of ``config``, the port's on its weights, a LoRA with
    non-zero ``b`` on both, and the bridge's module map."""
    from flow_factory_tpu.hparams.args import Arguments as JArgs
    from flow_factory_tpu.models import load_adapter as jax_load
    from flow_factory_tpu.parallel.dist import set_world_size_override
    from flow_factory_tpu_torch.hparams import Arguments
    from flow_factory_tpu_torch.models import load_adapter
    from flow_factory_tpu_torch.utils import weights

    set_world_size_override(1)
    try:
        ja = jax_load(JArgs.from_dict(copy.deepcopy(config)))
    finally:
        set_world_size_override(None)
    rng = np.random.default_rng(5)
    lora = {p: {"a": ab["a"], "b": (0.05 * rng.standard_normal(ab["b"].shape)).astype(np.float32)}
            for p, ab in _host(ja.trainable["transformer"]).items()}
    ja.trainable = {"transformer": jax.tree.map(jnp.asarray, lora)}
    pa = load_adapter(Arguments.from_dict(copy.deepcopy(config)), device="cpu")
    pa.load_state_dicts(state_dicts(_host(ja.params), pa.component_configs))
    module_map = module_map_of(pa)
    pa.load_lora("transformer", weights.lora_from_flax(lora, module_map))
    return ja, pa, lora, module_map


@pytest.fixture(scope="module")
def pairs():
    """{adapter: (JAX adapter, port adapter, LoRA, module map, the numpy
    batch without the old policy's quantity)} for the tiny Kontext adapter
    (64 target tokens, 32 condition tokens of two references, guidance 3.5)
    and the tiny SD3.5 adapter (CFG 2.0 over negative prompt embeddings)."""
    from flow_factory_tpu_torch.utils import weights

    out = {}
    kontext = _config_dict(model={"model_type": "flux1-kontext"}, train={"trainer_type": "nft"})
    out["kontext"] = _pair(kontext, weights.flux1_state_dicts,
                           lambda pa: weights.flux1_component_maps(pa.component_configs)["transformer"][0])
    sd35 = {**SD35_CONFIG, "train": {**SD35_CONFIG["train"], "trainer_type": "nft"}}
    out["sd35"] = _pair(sd35, weights.sd35_state_dicts, lambda pa: weights.sd3_transformer_map(
        pa.component_configs["transformer"].depth, pa.component_configs["transformer"].dual_attention_layers)[0])
    rng = np.random.default_rng(8)
    for name, (ja, pa, lora, module_map) in out.items():
        h, w, c = pa.latent_shape(32, 32)
        with torch.no_grad():
            enc = {k: v.numpy() for k, v in pa.encode_prompt(["a red fox in fresh snow"] * B).items()}
        if name == "kontext":
            shape = (B, (h // 2) * (w // 2), 4 * c)
            ids = np.concatenate([pa.latent_image_ids(8, 8)] * 2)
            ids[:16, 0], ids[16:, 0] = 1.0, 2.0
            embeds = dict(img_ids=pa.latent_image_ids(h, w), txt_ids=np.zeros((enc["prompt_embeds"].shape[1], 3),
                                                                              np.float32),
                          cond_latents=rng.standard_normal((B, 32, 4 * c)).astype(np.float32),
                          cond_ids=np.stack([ids] * B), guidance_scale=np.float32(3.5), **enc)
        else:
            with torch.no_grad():
                neg = pa.encode_prompt([""] * B)
            shape = (B, h, w, c)
            embeds = dict(negative_prompt_embeds=neg["prompt_embeds"].numpy(),
                          negative_pooled_prompt_embeds=neg["pooled_prompt_embeds"].numpy(),
                          guidance_scale=np.float32(2.0), **enc)
        batch = dict(clean={"latents": rng.standard_normal(shape).astype(np.float32)},
                     noise={"latents": rng.standard_normal(shape).astype(np.float32)},
                     timestep=np.asarray([640.0, 210.0, 880.0, 450.0], np.float32),
                     advantage=np.asarray([1.2, -0.7, 1.4, -1.0], np.float32), **embeds)
        out[name] = (ja, pa, lora, module_map, batch)
    return out


def _lib(batch, fn):
    return {k: ({kk: fn(vv) for kk, vv in v.items()} if isinstance(v, dict) else fn(v)) for k, v in batch.items()}


def _jbatch(batch):
    return {**_lib({k: v for k, v in batch.items() if k != "guidance_scale"}, jnp.asarray),
            "guidance_scale": jnp.float32(batch["guidance_scale"])}


def _tbatch(batch):
    return {**_lib({k: v for k, v in batch.items() if k != "guidance_scale"}, torch.from_numpy),
            "guidance_scale": float(batch["guidance_scale"])}


def _scaled_lora(lora, s):
    return {"transformer": {p: {"a": jnp.asarray(ab["a"]), "b": jnp.asarray(s * ab["b"])} for p, ab in lora.items()}}


@pytest.mark.parametrize("kl", [False, True], ids=["no_kl", "kl"])
@pytest.mark.parametrize("adapter", ["kontext", "sd35"])
@pytest.mark.parametrize("trainer", ["nft", "awm"])
def test_nft_and_awm_loss_aux_and_lora_grads_match_jax(pairs, trainer, adapter, kl, shared_time_features):
    """One micro-batch of 4 at one fresh timestep each through the JAX
    trainer's ``_grad_fn`` and the port's ``loss_and_grads``. NFT at β 0.7
    with the old velocity of the LoRA with ``b`` x 0.8; AWM (weighting ``t``,
    clip 0.01) with the old log-probs moved off the current ones so that the
    clip binds on two rows. ``kl``: the v-space KL against the reference (the
    zero LoRA: in the port the frozen weights, bit for bit), and for AWM the
    EMA KL against the LoRA with ``b`` x 0.5. Loss and every aux metric 1e-5
    (relative, absolute below 1e-7), every LoRA gradient leaf 1e-4 of its max."""
    import importlib

    from flow_factory_tpu.trainers.awm import weighted_log_prob as jwlp
    from flow_factory_tpu.trainers.decoupled import DecoupledTrainer as JDecoupled
    from flow_factory_tpu_torch.ema import EMA
    from flow_factory_tpu_torch.utils import weights

    ja, pa, lora, module_map, batch = pairs[adapter]
    ta = types.SimpleNamespace(nft_beta=0.7, adv_clip_range=(-1.5, 1.5), clip_range=(-0.01, 0.01),
                               kl_beta=0.5 if kl else 0.0, ema_kl_beta=0.3 if kl and trainer == "awm" else 0.0,
                               awm_weighting="t", ghuber_power=1.0, guidance_scale=float(batch["guidance_scale"]))
    jb = _jbatch(batch)
    x_t = JDecoupled.tree_noised(jb["clean"], jb["noise"], jb["timestep"])
    if trainer == "nft":
        old = np.array(ja.training_velocity(_scaled_lora(lora, 0.8), {**jb, **x_t}))
        batch = {**batch, "old_v": {"latents": old}}
    else:
        v = np.asarray(ja.training_velocity(ja.trainable, {**jb, **x_t}))
        target = batch["noise"]["latents"] - batch["clean"]["latents"]
        lp = np.asarray(jwlp(jnp.asarray(v.reshape(B, -1)), jnp.asarray(target.reshape(B, -1)), jb["timestep"], "t",
                             1.0))
        # ratios e^0.005, e^-0.02, e^0.03, e^-0.004 against advantages +, -, +, -: the clip binds on rows 2 and 3
        batch = {**batch, "old_log_prob": (lp - np.asarray([0.005, -0.02, 0.03, -0.004], np.float32))}

    jcls = importlib.import_module(f"flow_factory_tpu.trainers.{trainer}")
    tcls = importlib.import_module(f"flow_factory_tpu_torch.trainers.{trainer}")
    jt = object.__new__(getattr(jcls, f"{trainer.upper()}Trainer"))
    pt = object.__new__(getattr(tcls, f"{trainer.upper()}Trainer"))
    jt.training_args, jt.adapter, pt.training_args, pt.adapter = ta, ja, ta, pa
    args = [ja.trainable, ja.frozen_velocity_params(), _jbatch(batch), ja.ref_trainable() if kl else None]
    if trainer == "awm":
        args.append(_scaled_lora(lora, 0.5) if kl else None)
    (j_loss, j_aux), j_grads = jt._grad_fn(*args)

    if ta.ema_kl_beta:
        ema_lora = {p: {"a": ab["a"], "b": 0.5 * ab["b"]} for p, ab in lora.items()}
        pa.ema = EMA({"transformer": weights.lora_from_flax(ema_lora, module_map)})
    try:
        (loss, aux), grads = pt.loss_and_grads(_tbatch(batch), pt.reference_trainable() if kl else None)
    finally:
        pa.ema = None
    assert sorted(aux) == sorted(j_aux)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5, atol=1e-7)
    for k in j_aux:
        np.testing.assert_allclose(float(aux[k]), float(j_aux[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    if trainer == "nft":
        assert float(aux["train/positive_loss"]) != float(aux["train/negative_loss"])
    else:
        assert float(aux["train/clip_frac"]) == 0.5
    _leaf_close(_port_grads_as_flax(pa, grads, module_map), jax.tree.map(np.asarray, j_grads)["transformer"], 1e-4,
                f"{trainer} {adapter}")


# ---------------------------------------------------------------------------
# Two epochs through load_trainer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("trainer_type", ["nft", "awm"])
def test_nft_and_awm_run_two_epochs_with_the_sampling_policy_bit_for_bit(tmp_path, monkeypatch, trainer_type):
    """``load_trainer(cfg, device="cpu").start()`` on
    tests/fixtures/smoke_{nft,awm}_kontext.yaml: two micro-batches x 2 fresh
    timesteps an epoch, the optimizer once an epoch after all four grad
    steps, so each grad step's current policy is the sampling policy: NFT's
    positive and negative losses are equal on every grad step (at β 1, v⁺ =
    v⁻ = v when v = v_old), AWM's weighted log-prob equals the precomputed
    one bit for bit on every row of every grad step (ratio exactly 1.0, no
    clipping). The rollouts keep only the final latent with the condition
    tokens, the LoRA moves, the metrics are finite, and nothing launches a
    kernel on the CPU."""
    from flow_factory_tpu_torch import ops
    from flow_factory_tpu_torch.hparams import Arguments
    from flow_factory_tpu_torch.trainers import awm, load_trainer

    cfg = Arguments.load_from_yaml(os.path.join(REPO, f"tests/fixtures/smoke_{trainer_type}_kontext.yaml"))
    cfg.data_args.cache_dir = str(tmp_path / "cache")
    cfg.log_args.save_dir = str(tmp_path / "saves")
    trainer = load_trainer(cfg, device="cpu")
    assert type(trainer).__name__ == f"{trainer_type.upper()}Trainer"
    assert trainer.training_args.gradient_accumulation_steps == 4
    steps, lps = [], []
    loss_fn = trainer.loss_fn

    def recording_loss_fn(*args, **kwargs):
        loss, aux = loss_fn(*args, **kwargs)
        steps.append({k: float(v) for k, v in aux.items()})
        return loss, aux

    trainer.loss_fn = recording_loss_fn
    real_wlp = awm.weighted_log_prob

    def recording_wlp(*args):
        lp = real_wlp(*args)
        lps.append(lp.detach().clone())
        return lp

    monkeypatch.setattr(awm, "weighted_log_prob", recording_wlp)
    b0 = {p: ab["lora_B"].detach().clone() for p, ab in trainer.adapter.trainable["transformer"].items()}
    ops.reset_launch_counts()
    try:
        trainer.start()
    finally:
        trainer.cleanup()
    assert len(steps) == 8 and trainer.global_step == 2
    if trainer_type == "nft":
        assert all(s["train/positive_loss"] == s["train/negative_loss"] for s in steps), steps
        assert not lps
    else:
        assert all(s["train/ratio_mean"] == 1.0 and s["train/clip_frac"] == 0.0 for s in steps), steps
        # per micro-batch: the 2 precomputed log-probs, then the 2 grad steps'
        assert len(lps) == 16
        for mb in range(4):
            old, new = lps[4 * mb : 4 * mb + 2], lps[4 * mb + 2 : 4 * mb + 4]
            assert all(torch.equal(o, n) for o, n in zip(old, new))
    rows = [json.loads(line) for line in open(tmp_path / "saves" / f"smoke_{trainer_type}_kontext" / "metrics.jsonl")]
    train = [r for r in rows if "train/loss" in r]
    assert [r["step"] for r in train] == [0, 1]
    assert all(np.isfinite(v) for r in train for k, v in r.items() if k.startswith(("train/", "reward/")))
    assert all(r["train/grad_norm"] > 0 for r in train)
    samples = trainer.reward_buffer.samples
    assert len(samples) == 4 and all(s.all_latents.shape[0] == 1 and s.log_probs is None for s in samples)
    assert all(s.extra_kwargs["cond_latents"].shape == (512, 16) for s in samples)
    assert max((trainer.adapter.trainable["transformer"][p]["lora_B"] - b).abs().max().item()
               for p, b in b0.items()) > 0
    assert ops.launch_counts() == {name: 0 for name in ops.KERNEL_WRAPPERS}


def test_trainer_registry_resolves_nft_and_awm():
    """``nft`` and ``awm`` resolve to the port's trainers, on the shared
    old-policy base, as does ``crd``; ``dgpo`` resolves to its trainer on the
    decoupled base."""
    from flow_factory_tpu_torch.trainers.awm import AWMTrainer
    from flow_factory_tpu_torch.trainers.crd import CRDTrainer
    from flow_factory_tpu_torch.trainers.decoupled import DecoupledTrainer, OldPolicyTrainer
    from flow_factory_tpu_torch.trainers.dgpo import DGPOTrainer
    from flow_factory_tpu_torch.trainers.nft import NFTTrainer
    from flow_factory_tpu_torch.trainers.registry import resolve_trainer_class

    assert resolve_trainer_class("nft") is NFTTrainer and resolve_trainer_class("AWM") is AWMTrainer
    assert issubclass(NFTTrainer, OldPolicyTrainer) and issubclass(AWMTrainer, OldPolicyTrainer)
    assert resolve_trainer_class("crd") is CRDTrainer and issubclass(CRDTrainer, OldPolicyTrainer)
    assert resolve_trainer_class("DGPO") is DGPOTrainer and issubclass(DGPOTrainer, DecoupledTrainer)
