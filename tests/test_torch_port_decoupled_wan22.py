"""PyTorch port, Wan2.2 under the five decoupled trainers against the JAX
package, fp32 on the CPU: the tiny two-expert MoE (``boundary_ratio`` 0.8,
``guidance_scale_2`` 3) under DiffusionNFT, AWM, DPO, DGPO and CRD with
row 0's timestep above the boundary and below it, and the tiny TI2V
(``expand_timesteps``: per-frame t, frame 0 the clean condition) under NFT
and DGPO: loss, aux and the LoRA gradients of both experts against the JAX
trainers' ``_grad_fn`` (tests/torch_port_decoupled_cases.py), the routed
expert alone with a gradient, and no read of the timestep from the device
(``WanT2VAdapter.route_reads``): the port's batches carry ``timestep_host``.
Then one AWM epoch of the tiny MoE through ``load_trainer`` with no device
read for routing, both experts trained over it.

Both packages run on the JAX adapter's weights and LoRA through the weight
bridge, on the same embeddings, and the velocities take the JAX timestep
features (``shared_time_features``, tests/test_torch_port_flux.py)."""
import copy

import numpy as np
import pytest
from torch_port_threads import one_torch_thread  # noqa: F401

import torch_port_decoupled_cases as C
from test_torch_port_flux import _host, shared_time_features  # noqa: F401
from test_torch_port_wan22 import KINDS, PROMPTS, _config_dict, _media
from test_torch_port_wan22_train import _config, spy_on_grad_steps

#: per-row timesteps: row 0 above the MoE's boundary (800) and below it
T_ROWS = {"row0_high": (900.0, 300.0, 650.0, 950.0), "row0_low": (600.0, 950.0, 820.0, 120.0)}


@pytest.fixture(autouse=True, scope="module")
def _isolated():
    """The JAX package's world-size override is process-wide: reset it before
    and after this module (F0)."""
    from flow_factory_tpu.parallel.dist import set_world_size_override

    set_world_size_override(None)
    yield
    set_world_size_override(None)


def _build(kind):
    """The tiny JAX adapter of ``kind`` (tests/test_torch_port_wan22.py's
    ``KINDS``) and the port's on its weights; 4 rows (2 prompts x 2) of 5
    frames at 32 px, the JAX prompt and negative embeddings, TI2V also its
    clean frame-0 condition latents."""
    from flow_factory_tpu.hparams.args import Arguments as JArgs
    from flow_factory_tpu.models import load_adapter as jax_load
    from flow_factory_tpu.parallel.dist import set_world_size_override
    from flow_factory_tpu_torch.hparams import Arguments
    from flow_factory_tpu_torch.models import load_adapter
    from flow_factory_tpu_torch.utils import weights

    model_type, model, train = KINDS[kind]
    cfg = _config_dict(model_type, model, train)
    set_world_size_override(1)
    try:
        ja = jax_load(JArgs.from_dict(copy.deepcopy(cfg)))
        pre = ja.preprocess_func({"prompt": PROMPTS})
    finally:
        set_world_size_override(None)
    pa = load_adapter(Arguments.from_dict(copy.deepcopy(cfg)), device="cpu")
    pa.load_state_dicts({c: weights.convert(tree, *pa.weight_maps()[c]) for c, tree in _host(ja.params).items()})
    maps = {comp: pa.weight_maps()[comp][0] for comp in ja.trainable}
    rows = [0, 1, 0, 1]
    embeds = {k: pre[k][rows] for k in ("prompt_embeds", "negative_prompt_embeds")}
    if kind == "ti2v":
        images = _media(kind)["images"]
        embeds["cond_latents"] = pa.build_condition([images[r] for r in rows], 5, 32, 32)
    shapes = {"latents": pa.latent_shape(32, 32, 5)}
    return C.Pair(ja, pa, C.unit_lora(ja, np.random.default_rng(5)), maps, C.random_batch(shapes, embeds, seed=12),
                  guidance=5.0)


@pytest.fixture(scope="module")
def pairs():
    """{"moe": Pair, "ti2v": Pair}, each built at its first use."""
    cache = {}

    def get(kind):
        if kind not in cache:
            cache[kind] = _build(kind)
        return cache[kind]

    return get


@pytest.mark.parametrize("t", sorted(T_ROWS))
@pytest.mark.parametrize("kind", C.TRAINERS)
def test_moe_decoupled_loss_and_grads_match_jax(pairs, kind, t, shared_time_features):
    """Each trainer on the tiny MoE, row 0 above the boundary (the
    high-noise expert at CFG 5) and below it (the low-noise expert at
    ``guidance_scale_2`` 3; DGPO's rows all at row 0's t): loss, aux and
    every LoRA leaf of both experts against JAX's ``lax.cond`` route, the
    routed expert's gradient non-zero and the other's exactly zero; every
    policy's forward (θ, the old policy, the reference, ``ema_ref``) routed
    from the host, with no read of the timestep from the device."""
    from flow_factory_tpu_torch.models.wan.t2v import WanT2VAdapter

    pair = pairs("moe")
    reads = WanT2VAdapter.route_reads
    _, _, grads = C.assert_case_matches(kind, pair, T_ROWS[t], f"moe {kind} {t}")
    assert WanT2VAdapter.route_reads == reads
    routed = "transformer_2" if T_ROWS[t][0] >= 800.0 else "transformer"
    assert {comp for comp, g in C.live(grads).items() if g > 0} == {routed}


@pytest.mark.parametrize("kind", ["nft", "dgpo"])
def test_ti2v_decoupled_loss_and_grads_match_jax(pairs, kind, shared_time_features):
    """NFT and DGPO (its ``ema_ref`` and reference forwards without CFG,
    the KL's teacher under CFG 3) on the tiny TI2V: the decoupled forward at
    per-frame t, frame 0 at 0 with the clean condition composited in;
    against the JAX ``_grad_fn``."""
    _, _, grads = C.assert_case_matches(kind, pairs("ti2v"), T_ROWS["row0_high"], f"ti2v {kind}")
    assert C.live(grads)["transformer"] > 0


def test_moe_velocity_without_a_host_timestep_reads_the_device_once(pairs):
    """The counter counts: a MoE velocity called with no ``timestep_host``
    routes on row 0's t read from the device (JAX's semantics, kept for such
    callers) and counts one read; with it, none."""
    import torch

    from flow_factory_tpu_torch.models.wan.t2v import WanT2VAdapter

    pair = pairs("moe")
    pa = pair.pa
    batch = {"latents": torch.from_numpy(pair.batch["clean"]["latents"]), "timestep": torch.full((C.B,), 900.0),
             "prompt_embeds": torch.from_numpy(pair.batch["prompt_embeds"]), "guidance_scale": 5.0}
    reads = WanT2VAdapter.route_reads
    with torch.no_grad():
        a = pa.training_velocity(pa.trainable, batch)
        assert WanT2VAdapter.route_reads == reads + 1
        b = pa.training_velocity(pa.trainable, {**batch, "timestep_host": 900.0})
    assert WanT2VAdapter.route_reads == reads + 1
    assert torch.equal(a, b)


def test_moe_awm_epoch_routes_from_the_host_and_trains_both_experts(tmp_path):
    """One AWM epoch of the tiny MoE through ``load_trainer`` (boundary 0.3,
    logit-normal timesteps, 4 a micro-batch, so that row 0's t falls on both
    sides): no read of the timestep from the device over the whole epoch
    (the rollout, the old-policy forwards, every grad step), each grad step's
    gradient on the expert of its ``timestep_host`` alone, both experts
    trained over the epoch, AWM's ratio exactly 1.0 on every row (one
    optimizer step after all of them)."""
    from flow_factory_tpu_torch.models.wan.t2v import WanT2VAdapter
    from flow_factory_tpu_torch.trainers import load_trainer

    cfg = _config("wan22", tmp_path, {"boundary_ratio": 0.3},
                  {"trainer_type": "awm", "num_train_timesteps": 4, "max_epochs": 1, "clip_range": [-0.01, 0.01],
                   "time_sampling_strategy": "logit_normal", "gradient_accumulation_steps": 8})
    trainer = load_trainer(cfg, device="cpu")
    seen = []
    spy_on_grad_steps(trainer, lambda batch, aux, live: seen.append(
        (batch["timestep_host"], float(batch["timestep"][0]), live, float(aux["train/ratio_mean"]),
         float(aux["train/clip_frac"]))))
    WanT2VAdapter.route_reads = 0
    try:
        trainer.start()
    finally:
        trainer.cleanup()
    assert WanT2VAdapter.route_reads == 0
    assert len(seen) == 2 * 4
    for t_host, t0, live, ratio, clip in seen:
        assert t_host == t0 and live == (["transformer_2"] if trainer.adapter.routes_high(t_host)
                                         else ["transformer"]), (t_host, live)
        assert ratio == 1.0 and clip == 0.0
    assert {tuple(live) for *_, live, _, _ in seen} == {("transformer",), ("transformer_2",)}
