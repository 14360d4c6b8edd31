"""PyTorch port, the LM-conditioned image families under the decoupled
trainers against the JAX package, fp32 on the CPU: tiny Qwen-Image (true
CFG over the negative embeds) under DiffusionNFT, AWM, DPO, DGPO and CRD;
Qwen-Image-Edit-Plus (condition tokens of one reference geometry) under
NFT and AWM; Z-Image (true CFG) under CRD and DPO; FLUX.2-Klein (embedded
guidance, condition tokens of one reference geometry) under NFT and DPO:
loss, aux and every LoRA gradient against the JAX trainers' ``_grad_fn``
(tests/torch_port_decoupled_cases.py).

Edit-Plus and Klein replay every row under row 0's condition ids in both
packages (F15, F13), so each batch here holds rows of one record's
reference geometry, as the card's micro-batches do. Both packages run on
the JAX adapter's weights and LoRA through the weight bridge, on the same
embeddings (a short port rollout's), and the velocities take the JAX
timestep features (``shared_time_features``, tests/test_torch_port_flux.py)."""
import copy
import signal

import numpy as np
import pytest
from torch_port_threads import one_torch_thread  # noqa: F401

import torch_port_decoupled_cases as C
from test_torch_port_flux import _host, shared_time_features  # noqa: F401

T = (640.0, 210.0, 880.0, 450.0)
PROMPTS = ["a sunflower field under a stormy sky", "a vintage car parked by the ocean"]
#: the pairs and the trainers each is held to
CASES = [("qwen-image", k) for k in C.TRAINERS] + [("qwen-edit", "nft"), ("qwen-edit", "awm"),
                                                   ("z-image", "crd"), ("z-image", "dpo"),
                                                   ("klein", "nft"), ("klein", "dpo")]


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


def _jax_adapter(cfg):
    from flow_factory_tpu.hparams.args import Arguments as JArgs
    from flow_factory_tpu.models import load_adapter as jax_load
    from flow_factory_tpu.parallel.dist import set_world_size_override

    set_world_size_override(1)
    try:
        return jax_load(JArgs.from_dict(copy.deepcopy(cfg)))
    finally:
        set_world_size_override(None)


def _port_adapter(cfg, state_dicts, ja):
    from flow_factory_tpu_torch.hparams import Arguments
    from flow_factory_tpu_torch.models import load_adapter

    pa = load_adapter(Arguments.from_dict(copy.deepcopy(cfg)), device="cpu")
    pa.load_state_dicts(state_dicts(_host(ja.params), pa.component_configs))
    return pa


def _build(name):
    """One tiny pair and its batch of 4 rows (2 prompts x 2; Edit-Plus and
    Klein: the one-reference record of dataset/multi_ref_image, 4 rows)."""
    from flow_factory_tpu_torch.utils import weights
    from test_torch_port_flux2 import _flux2_config
    from test_torch_port_qwen_image import _cfg as qwen_cfg, _records
    from test_torch_port_z_image import _cfg as z_cfg

    if name in ("qwen-image", "qwen-edit"):
        cfg = qwen_cfg("qwen-image" if name == "qwen-image" else "qwen-image-edit-plus",
                       **({"dataset_dir": "tests/fixtures/tiny_prompts"} if name == "qwen-image" else {}))
        state_dicts, maps_of = weights.qwen_image_state_dicts, weights.qwen_image_component_maps
        guidance = 4.0
    elif name == "z-image":
        cfg, guidance = z_cfg(), 4.0
        state_dicts, maps_of = weights.z_image_state_dicts, weights.z_image_component_maps
    else:
        cfg = _flux2_config({"model_type": "flux2-klein", "use_caption_upsampler": False})
        state_dicts, maps_of = weights.flux2_state_dicts, weights.flux2_component_maps
        guidance = float(cfg["train"]["guidance_scale"])
    # the JAX adapter of the transformer alone (Edit-Plus: and its LM, which
    # the vision tower's load needs): both packages take the same embeds, so
    # the port's other components keep their own random init
    comps = ["transformer"] + (["text_encoder"] if name == "qwen-edit" else [])
    ja = _jax_adapter({**cfg, "model": {**cfg["model"], "load_components": comps}})
    pa = _port_adapter(cfg, state_dicts, ja)
    maps = {"transformer": maps_of(pa.component_configs)["transformer"][0]}
    if name in ("qwen-edit", "klein"):
        recs = {k: v[1:2] for k, v in _records().items()}  # the one-reference record
        pre = pa.preprocess_func(copy.deepcopy(recs))
        rows = [0] * C.B
        inference = dict(prompt=[recs["prompt"][r] for r in rows], **{k: v[rows] for k, v in pre.items()})
    else:
        inference = dict(prompt=[PROMPTS[r] for r in (0, 1, 0, 1)])
    batch = C.rollout_batch(pa, 11, **inference)
    return C.Pair(ja, pa, C.unit_lora(ja, np.random.default_rng(4)), maps, batch, guidance=guidance,
                  dgpo_b=1.0 if name == "qwen-image" else 0.6)


@pytest.fixture(scope="module")
def pairs():
    cache = {}

    def get(name):
        if name not in cache:
            cache.clear()  # one pair alive at a time: the cases run pair by pair
            cache[name] = _build(name)
        return cache[name]

    return get


@pytest.mark.parametrize("name,kind", CASES)
def test_decoupled_loss_and_grads_match_jax(pairs, name, kind, shared_time_features):
    """The trainer's loss, aux and every LoRA gradient on the family against
    the JAX ``_grad_fn`` at the module's bars; a gradient reaches the LoRA.
    Qwen-Image's and Z-Image's batches carry the negative embeds: the
    velocity under true CFG (NFT, AWM, DPO, and the KL teachers of DGPO and
    CRD at CFG 3), DGPO's and CRD's own forwards without it."""
    pair = pairs(name)
    if name in ("qwen-image", "z-image"):
        assert "negative_prompt_embeds" in pair.batch
    if name in ("qwen-edit", "klein"):
        ids = pair.batch["cond_ids"]
        assert ids.shape[0] == C.B and all(np.array_equal(ids[0], x) for x in ids)
    _, _, grads = C.assert_case_matches(kind, pair, T, f"{name} {kind}")
    assert C.live(grads)["transformer"] > 0
