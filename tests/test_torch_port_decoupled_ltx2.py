"""PyTorch port, LTX-2 under the five decoupled trainers against the JAX
package, fp32 on the CPU: the latent tree of both streams (the video
latents and the audio latents, ``decoupled_latent_keys``) through one joint
forward a policy (``training_velocity_tree``), and the DiffusionNFT, AWM,
DPO, DGPO and CRD losses, aux metrics and LoRA gradients of the tiny T2AV
adapter (CFG 3 over the negative embeds) and of the I2AV adapter (the
planted first-frame tokens) against the JAX trainers' ``_grad_fn``
(tests/torch_port_decoupled_cases.py); each loss moves with the audio
stream's clean latents; ``clean_latent_tree`` raises on a stream the
samples lack; one NFT epoch through ``load_trainer``.

Both packages run on the JAX adapter's weights and LoRA through the weight
bridge, on the same embeddings, and the velocities take the JAX timestep
features (``shared_time_features``, tests/test_torch_port_flux.py)."""
import copy
import os

import jax
import numpy as np
import pytest
import torch
from torch_port_threads import one_torch_thread  # noqa: F401

import torch_port_decoupled_cases as C
from test_torch_port_flux import _host, shared_time_features  # noqa: F401
from test_torch_port_ltx2_train import IMAGES, PROMPTS, SMOKE, _ltx2_config

#: per-row timesteps of the cases (DGPO takes row 0's for every row)
T = (640.0, 210.0, 880.0, 450.0)


@pytest.fixture(autouse=True, scope="module")
def _isolated():
    """The JAX package's world-size override is process-wide: reset it before
    and after this module (F0)."""
    from flow_factory_tpu.parallel.dist import set_world_size_override

    set_world_size_override(None)
    yield
    set_world_size_override(None)


@pytest.fixture(scope="module")
def pairs():
    """{"t2av": Pair, "i2av": Pair}: one tiny JAX T2AV adapter (and the same
    weights under the JAX I2AV class, its own jit caches), the port's T2AV
    and I2AV adapters on its weights; a batch of 4 rows (2 prompts x 2) at
    16 px x 5 frames: 48 video tokens of 16 channels and 39 audio tokens of
    8, the JAX prompt and negative embeddings, the token ids; I2AV also the
    planted first-frame tokens of two dataset images and their mask."""
    from flow_factory_tpu.hparams.args import Arguments as JArgs
    from flow_factory_tpu.models import load_adapter as jax_load
    from flow_factory_tpu.models.ltx2 import LTX2I2AVAdapter as JI2AV
    from flow_factory_tpu.parallel.dist import set_world_size_override
    from flow_factory_tpu_torch.data.dataset import _load_media_fields, load_raw_records
    from flow_factory_tpu_torch.hparams import Arguments
    from flow_factory_tpu_torch.models import load_adapter
    from flow_factory_tpu_torch.utils import weights

    set_world_size_override(1)
    try:
        ja = jax_load(JArgs.from_dict(_ltx2_config(attn_backend="native")))
        pre = ja.preprocess_func({"prompt": PROMPTS})
    finally:
        set_world_size_override(None)
    ji = JI2AV.__new__(JI2AV)
    ji.__dict__.update(ja.__dict__)
    lora = C.unit_lora(ja, np.random.default_rng(6))
    flax_params = _host(ja.params)
    recs = [_load_media_fields(r, IMAGES) for r in load_raw_records(os.path.join(IMAGES, "train.jsonl"))[:2]]
    out = {}
    for kind, model_type, jad in (("t2av", "ltx2-t2av", ja), ("i2av", "ltx2-i2av", ji)):
        pa = load_adapter(Arguments.from_dict(_ltx2_config(model_type)), device="cpu")
        pa.load_state_dicts(weights.ltx2_state_dicts(flax_params, pa.component_configs))
        maps = {"transformer": weights.ltx2_component_maps(pa.component_configs)["transformer"][0]}
        tl, h, w = pa.video_token_geometry(16, 16, 5)
        La = pa.audio_token_count(5)
        rows = [0, 1, 0, 1]
        embeds = {k: pre[k][rows] for k in ("prompt_embeds", "negative_prompt_embeds")}
        embeds["video_ids"] = np.stack([pa._video_ids(tl, h, w)] * C.B)
        embeds["audio_ids"] = np.stack([pa._audio_ids(La, tl)] * C.B)
        if kind == "i2av":
            tokens, mask = pa.encode_first_frame([recs[r]["images"][0] for r in rows], 16, 16, 5)
            embeds.update(cond_tokens=tokens, cond_mask=mask)
        shapes = {"latents": (tl * h * w, pa.video_latent_channels), "audio_latents": (La, pa.audio_latent_channels)}
        out[kind] = C.Pair(jad, pa, lora, maps, C.random_batch(shapes, embeds, seed=7), guidance=3.0)
    return out


def test_both_streams_are_the_decoupled_latent_keys(pairs):
    """``decoupled_latent_keys`` names the video and the audio stream, as the
    JAX default does with the trajectory streams; the port's joint forward
    gives both leaves at their shapes."""
    for kind, pair in pairs.items():
        want = {"latents": "all_latents", "audio_latents": "audio_all_latents"}
        assert pair.pa.decoupled_latent_keys == want == pair.ja.decoupled_latent_keys, kind
    pair = pairs["t2av"]
    tb = {**{k: torch.from_numpy(v) for k, v in pair.batch["clean"].items()}, "timestep": torch.full((C.B,), 500.0),
          **{k: torch.from_numpy(v) for k, v in pair.batch.items() if k.endswith(("_embeds", "_ids"))}}
    with torch.no_grad():
        v = pair.pa.training_velocity_tree(pair.pa.trainable, tb)
    assert {k: tuple(x.shape) for k, x in v.items()} == {"latents": (C.B, 48, 16), "audio_latents": (C.B, 39, 8)}


@pytest.mark.parametrize("kind", C.TRAINERS)
def test_t2av_decoupled_loss_and_grads_match_jax(pairs, kind, shared_time_features):
    """Each trainer on the T2AV tree: loss, aux and every LoRA gradient
    (both streams' attentions and FFNs, the cross-modal ones) against the
    JAX ``_grad_fn``, at the module's bars."""
    _, _, grads = C.assert_case_matches(kind, pairs["t2av"], T, f"ltx2-t2av {kind}")
    assert C.live(grads)["transformer"] > 0


@pytest.mark.parametrize("kind", ["nft", "dpo"])
def test_i2av_decoupled_loss_and_grads_match_jax(pairs, kind, shared_time_features):
    """NFT and DPO on the I2AV tree, the first-frame tokens planted before
    every forward (DPO's chosen and rejected trees alike): against the JAX
    I2AV adapter's ``_grad_fn``."""
    C.assert_case_matches(kind, pairs["i2av"], T, f"ltx2-i2av {kind}")


@pytest.mark.parametrize("kind", C.TRAINERS)
def test_each_loss_reaches_the_audio_stream(pairs, kind):
    """The counterpart of JAX tests/test_ltx2_decoupled.py:63: the clean
    audio latents moved (by 0.5, the video kept), every trainer's loss
    moves."""
    pair = pairs["t2av"]
    clean = copy.deepcopy(pair.batch["clean"])
    clean["audio_latents"] = clean["audio_latents"] + 0.5
    base = C.port_loss(kind, pair, T, {})
    moved = C.port_loss(kind, pair, T, {"clean": clean})
    assert np.isfinite(base) and np.isfinite(moved) and moved != base, (kind, base, moved)


def test_clean_latent_tree_raises_on_a_missing_stream(pairs):
    """A stream of ``decoupled_latent_keys`` the stacked samples lack raises
    (dropped, it would take the audio out of every loss without a word);
    with both streams present both come back."""
    from flow_factory_tpu_torch.trainers.decoupled import DecoupledTrainer

    pt = object.__new__(DecoupledTrainer)
    pt.adapter = pairs["t2av"].pa
    full = {"all_latents": np.zeros((2, 1, 48, 16), np.float32),
            "audio_all_latents": np.ones((2, 1, 39, 8), np.float32)}
    tree = pt.clean_latent_tree(full)
    assert sorted(tree) == ["audio_latents", "latents"] and float(tree["audio_latents"].min()) == 1.0
    with pytest.raises(KeyError, match="audio_all_latents"):
        pt.clean_latent_tree({"all_latents": full["all_latents"]})
    with pytest.raises(KeyError, match="audio_all_latents"):
        pt.clean_latent_tree({**full, "audio_all_latents": None})


def test_nft_epoch_on_ltx2_through_load_trainer(tmp_path, monkeypatch):
    """One DiffusionNFT epoch on tests/fixtures/smoke_grpo_ltx2.yaml through
    ``load_trainer``: the rollouts keep each stream's final latent, every
    grad step's clean tree holds both streams, and NFT's positive and
    negative losses are equal on every grad step (the optimizer steps once,
    after all of them, so the current policy is the sampling policy)."""
    import yaml

    from flow_factory_tpu_torch.hparams import Arguments
    from flow_factory_tpu_torch.trainers import load_trainer

    with open(SMOKE) as f:
        raw = yaml.safe_load(f)
    raw["data"]["cache_dir"] = str(tmp_path / "cache")
    raw["log"]["save_dir"] = str(tmp_path / "saves")
    raw["train"] = {k: v for k, v in raw["train"].items() if k not in ("clip_range", "kl_beta", "global_std")}
    raw["train"].update(trainer_type="nft", max_epochs=1, nft_beta=1.0, num_train_timesteps=2, ema_decay=0,
                        time_sampling_strategy="logit_normal", gradient_step_per_epoch=1)
    trainer = load_trainer(Arguments.from_dict(raw), device="cpu")
    assert type(trainer).__name__ == "NFTTrainer"
    steps = []
    loss_fn = trainer.loss_fn

    def recording(trainable, batch, ref=None):
        loss, aux = loss_fn(trainable, batch, ref)
        steps.append((sorted(batch["clean"]), {k: float(v) for k, v in aux.items()}))
        return loss, aux

    monkeypatch.setattr(trainer, "loss_fn", recording)
    try:
        trainer.start()
    finally:
        trainer.cleanup()
    assert steps and all(keys == ["audio_latents", "latents"] for keys, _ in steps)
    assert all(aux["train/positive_loss"] == aux["train/negative_loss"] for _, aux in steps), steps
    samples = trainer.reward_buffer.samples
    assert all(s.all_latents.shape[0] == 1 and s.extra_kwargs["audio_all_latents"].shape[0] == 1 for s in samples)
    assert all(np.isfinite(aux["train/loss"]) for _, aux in steps)
    jax.clear_caches()
