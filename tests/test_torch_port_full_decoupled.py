"""PyTorch port, full finetuning under the decoupled trainers and GRPO-Guard
against the JAX package on the tiny SD3.5, fp32 on the CPU: DiffusionNFT,
AWM, DGPO (``clip_dsm`` against ``ema_ref``) and GRPO-Guard, each with its KL
to the full reference store, which θ has moved off: the loss, the aux metrics
and every weight's gradient against the JAX trainer's own ``_grad_fn``;
DGPO's ``ema_ref`` and CRD's two snapshots after an update against the JAX
adapter's blend; ``evaluate`` under a full EMA that differs from θ against
the JAX rollout under that EMA.

Both packages start from one seeded numpy tree carried to the port by
``weights.full_from_flax`` (``tests/test_torch_port_full.py``'s ``Pair``);
the old-policy quantities are JAX's, fed to both. The bars are those of
``tests/test_torch_port_full.py`` and ``tests/torch_port_decoupled_cases.py``:
loss and aux 1e-5 relative (1e-7 absolute), every weight's gradient 1e-4 of
that leaf's largest magnitude in JAX, a snapshot 1e-7 of JAX's and bit for
bit the fp32 blend, images 1e-4 (the trajectory bar)."""
import copy
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_threads import one_torch_thread  # noqa: F401

from test_torch_port_full import B, PROMPT, SD3_CONFIG, Pair, _assert_close, _grpo_batch, _host, _moved
from torch_port_decoupled_cases import AWM_SHIFT, DGPO_FLOOR, GROUPS, OPTIONS, _lib, random_batch

#: per-row timesteps of a case (DGPO shares row 0's)
TIMESTEPS = np.asarray([640.0, 210.0, 880.0, 400.0], np.float32)
#: the std of the moves off θ: the old policy's (NFT), ``ema_ref`` (DGPO's
#: preference, a difference of two errors, then stands ≥ ``DGPO_FLOOR``
#: from 0), the EMA's (evaluate)
OLD_STD, EMA_STD = 0.2, 0.05


@pytest.fixture(autouse=True, scope="module")
def _isolated():
    """The JAX package's world-size override is process-wide: reset it before
    and after this module (F0)."""
    from flow_factory_tpu.parallel.dist import set_world_size_override

    set_world_size_override(None)
    yield
    set_world_size_override(None)


@pytest.fixture(scope="module")
def pair():
    """The tiny SD3.5 pair with the reference store at the pair's first θ in
    both adapters, then θ moved off it; the prompt's and "" embeds; a
    decoupled batch of ``B`` rows in two prompt groups; a tree further off
    θ for the old policies."""
    from flow_factory_tpu_torch.utils import weights

    p = Pair(SD3_CONFIG, weights.sd35_state_dicts, 31)
    for ad in (p.ja, p.pa):
        ad.init_ref_parameters()
    p.ref = p.theta
    p.theta = _moved(p.theta, p.rng)
    p.set_theta(p.theta)
    p.old = _moved(p.theta, p.rng, OLD_STD)
    with torch.no_grad():
        enc = {k: v.numpy() for k, v in p.pa.encode_prompt([PROMPT] * B).items()}
        neg = {f"negative_{k}": v.numpy() for k, v in p.pa.encode_prompt([""] * B).items()}
    p.embeds = {**enc, **neg}
    p.shape = p.pa.latent_shape(32, 32)
    p.batch = random_batch({"latents": p.shape}, p.embeds, 7)
    p.guidance = 2.0
    return p


def _port_tree(pair, flax_tree):
    from flow_factory_tpu_torch.utils import weights

    return {"transformer": weights.full_from_flax(flax_tree, pair.maps)}


def _jax_tree(flax_tree):
    return {"transformer": jax.tree.map(jnp.asarray, flax_tree)}


def _decoupled(kind, pair):
    """One micro-batch of ``kind`` (options ``OPTIONS[kind]``, DGPO with
    ``clip_dsm`` as its full example sets it) through the JAX trainer's
    ``_grad_fn`` and the port's ``loss_and_grads`` on the full tree, with
    the KL to the reference store: NFT's old velocity on ``pair.old`` under
    CFG, AWM's old log-probs JAX's at θ shifted by ``AWM_SHIFT``, DGPO's
    ``ema_ref`` ``pair.old``. Returns ((loss, aux, grads by port name) of
    JAX, then of the port)."""
    import importlib

    from flow_factory_tpu.trainers.awm import weighted_log_prob as jwlp
    from flow_factory_tpu.trainers.decoupled import DecoupledTrainer as JD

    ja, pa = pair.ja, pair.pa
    pair.set_theta(pair.theta)
    ta = types.SimpleNamespace(**{**OPTIONS[kind], **({"clip_dsm": True} if kind == "dgpo" else {})})
    t = np.full((B,), TIMESTEPS[0], np.float32) if kind == "dgpo" else TIMESTEPS
    batch = {k: v for k, v in pair.batch.items() if k != "rejected"}
    batch["timestep"] = t
    jb = lambda: {**_lib(batch, jnp.asarray), "guidance_scale": jnp.float32(pair.guidance)}
    frozen = ja.frozen_velocity_params()
    if kind in ("nft", "awm"):
        j = jb()
        fwd = {**j, **JD.tree_noised(j["clean"], j["noise"], j["timestep"])}
        if kind == "awm":
            v = JD.tree_flat(ja.training_velocity_tree(ja.trainable, fwd, frozen=frozen))
            target = JD.tree_flat(j["noise"]) - JD.tree_flat(j["clean"])
            lp = np.asarray(jwlp(v, target, j["timestep"], ta.awm_weighting, ta.ghuber_power))
            batch["old_log_prob"] = (lp - AWM_SHIFT).astype(np.float32)
        else:
            batch["old_v"] = _host(ja.training_velocity_tree(_jax_tree(pair.old), fwd, frozen=frozen))
    tb = {**_lib(batch, torch.from_numpy), "guidance_scale": float(pair.guidance), "timestep_host": float(t[0])}

    jcls = getattr(importlib.import_module(f"flow_factory_tpu.trainers.{kind}"), f"{kind.upper()}Trainer")
    pcls = getattr(importlib.import_module(f"flow_factory_tpu_torch.trainers.{kind}"), f"{kind.upper()}Trainer")
    jt, pt = object.__new__(jcls), object.__new__(pcls)
    jt.training_args, jt.adapter = ta, ja
    pt.training_args, pt.adapter = ta, pa
    if kind == "dgpo":
        jt.dpo_beta, pt.requires_ema_ref = ta.dpo_beta, True
        (jl, jaux), jg = jt._grad_fn(ja.trainable, frozen, {**jb(), "group_ids": jnp.asarray(GROUPS, jnp.int32)},
                                     ja.ref_trainable(), _jax_tree(pair.old), 2)
        tb.update(group_ids=torch.tensor(GROUPS), num_groups=2)
        with torch.no_grad():
            old = pa.merged_params(pa.velocity_component, _port_tree(pair, pair.old))
        (tl, taux), tg = pt.loss_and_grads(pt.with_frozen_velocities(tb, old))
    else:
        args = (ja.trainable, frozen, jb(), ja.ref_trainable()) + ((None,) if kind == "awm" else ())
        (jl, jaux), jg = jt._grad_fn(*args)
        (tl, taux), tg = pt.loss_and_grads(tb, pt.reference_trainable())
    return ((float(jl), {k: float(v) for k, v in jaux.items()}, pair.port_names(_host(jg)["transformer"])),
            (float(tl), {k: float(v) for k, v in taux.items()}, pair.named(tg)))


def _guard(pair):
    """GRPO-Guard's micro-batch (``_grpo_batch``, the rollout means a little
    off the step's) with the v-based KL to the reference store through the
    JAX ``_grad_fn`` and the port's ``loss_and_grads``."""
    from flow_factory_tpu.trainers.grpo import GRPOTrainer as JGRPO
    from flow_factory_tpu_torch.trainers.grpo import GRPOTrainer

    ja, pa = pair.ja, pair.pa
    pair.set_theta(pair.theta)
    batch = _grpo_batch(pair, pair.embeds, (B, *pair.shape), pair.guidance)
    tb = lambda: {**{k: torch.from_numpy(v) for k, v in batch.items()}, "guidance_scale": pair.guidance}
    with torch.no_grad():
        mean = pa.training_forward(pa.trainable, tb(), compute_log_prob=False).next_latents_mean.numpy()
    batch["rollout_mean"] = (mean + 0.02 * pair.rng.standard_normal(mean.shape)).astype(np.float32)
    jt, pt = object.__new__(JGRPO), object.__new__(GRPOTrainer)
    for trainer, ad in ((jt, ja), (pt, pa)):
        trainer.training_args, trainer.use_guard, trainer.adapter = copy.copy(ad.training_args), True, ad
        trainer.training_args.kl_beta, trainer.training_args.kl_type = 0.5, "v-based"
    jb = {**{k: jnp.asarray(v) for k, v in batch.items()}, "guidance_scale": jnp.float32(pair.guidance)}
    (jl, jaux), jg = jt._grad_fn(ja.trainable, ja.frozen_velocity_params(), jb, ja.ref_trainable())
    (tl, taux), tg = pt.loss_and_grads(tb(), pa.ref_trainable())
    return ((float(jl), {k: float(v) for k, v in jaux.items()}, pair.port_names(_host(jg)["transformer"])),
            (float(tl), {k: float(v) for k, v in taux.items()}, pair.named(tg)))


@pytest.mark.parametrize("kind", ["nft", "awm", "dgpo", "grpo-guard"])
def test_full_loss_aux_and_every_gradient_match_jax(kind, pair):
    """One micro-batch of ``kind`` on the full tree, its KL to the reference
    store (θ moved off it): the loss and every aux metric 1e-5, every
    weight's gradient 1e-4 of that leaf's max (the leaves JAX gives exact
    zeros exactly zero, the context-pre-only block's context queries among
    them); the KL non-zero, AWM's clip binding on two rows, NFT's two losses
    apart, DGPO's preference and loss ≥ ``DGPO_FLOOR`` from 0."""
    (jl, jaux, jg), (tl, taux, tg) = _guard(pair) if kind == "grpo-guard" else _decoupled(kind, pair)
    assert sorted(taux) == sorted(jaux)
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-7)
    for k in jaux:
        np.testing.assert_allclose(taux[k], jaux[k], rtol=1e-5, atol=1e-7, err_msg=k)
    _assert_close(jg, tg)
    assert jaux["train/kl"] > 0 and any(np.abs(g).max() > 0 for g in tg.values())
    if kind == "awm":
        assert taux["train/clip_frac"] == 0.5
    if kind == "nft":
        assert taux["train/positive_loss"] != taux["train/negative_loss"]
    if kind == "dgpo":
        assert min(abs(jaux["train/pref_mean"]), abs(jaux["train/loss"])) >= DGPO_FLOOR, jaux


def test_dgpo_ema_ref_and_crd_snapshots_after_an_update_match_the_jax_blend(pair):
    """Each package's DGPO ``ema_ref`` and CRD ``_crd_old``/``_crd_sampling``
    taken at θ, then θ moved (the update) and global step 1: DGPO's
    ``after_optimizer_step`` blends ``ema_ref`` at min(0.999, 1 x 1), CRD's
    ``update_snapshots`` blends ``_crd_old`` at "slow"'s 0.001 and sets
    ``_crd_sampling`` to θ (decay 0); each store within 1e-7 of the JAX
    trainers' and bit for bit the fp32 blend s·b + θ·(1 − b) (b and 1 − b
    rounded to fp32), ``_crd_sampling`` θ's bits, the reference unchanged."""
    from flow_factory_tpu.trainers.crd import CRDTrainer as JCRD
    from flow_factory_tpu.trainers.dgpo import DGPOTrainer as JDGPO
    from flow_factory_tpu_torch.trainers.crd import CRDTrainer
    from flow_factory_tpu_torch.trainers.dgpo import DGPOTrainer

    ja, pa = pair.ja, pair.pa
    pair.set_theta(pair.theta)
    before = {k: v.detach().clone() for k, v in pa.trainable["transformer"].items()}
    ref = {k: v.clone() for k, v in pa.ref_trainable()["transformer"].items()}
    names = (DGPOTrainer.EMA_REF, CRDTrainer.OLD, CRDTrainer.SAMPLING)
    for ad in (ja, pa):
        for name in names:
            ad.add_named_parameters(name)
    after = _moved(pair.theta, np.random.default_rng(17), 0.01)
    pair.set_theta(after)
    ta = types.SimpleNamespace(ema_ref_max_decay=0.999, ema_ref_ramp_rate=1.0, old_model_decay="slow",
                               sampling_model_decay=0)
    trainers = [object.__new__(cls) for cls in (JDGPO, JCRD, DGPOTrainer, CRDTrainer)]
    for t, ad in zip(trainers, (ja, ja, pa, pa)):
        t.adapter, t.training_args, t.global_step = ad, ta, 1
    trainers[0]._requires_ema_ref = trainers[2].requires_ema_ref = True
    trainers[0]._update_ema_ref()
    trainers[1].update_snapshots()
    trainers[2].after_optimizer_step()
    trainers[3].update_snapshots()
    try:
        theta = {k: v.detach() for k, v in pa.trainable["transformer"].items()}
        for name, decay in zip(names, (0.999, 0.001, 0.0)):
            got = pa.get_named_parameters(name)["transformer"]
            want = pair.port_names(_host(ja.get_named_parameters(name))["transformer"])
            assert max(float(np.abs(got[k].numpy() - want[k]).max()) for k in want) <= 1e-7, name
            d = torch.tensor(decay, dtype=torch.float32)
            blend = {k: theta[k].clone() if decay == 0.0 else before[k] * d + theta[k] * (1 - d) for k in theta}
            assert all(torch.equal(got[k], blend[k]) for k in theta), name
            assert decay == 0.0 or not any(torch.equal(got[k], theta[k]) for k in theta), name
        assert all(torch.equal(v, ref[k]) for k, v in pa.ref_trainable()["transformer"].items())
    finally:
        for ad in (ja, pa):
            for name in names:
                ad.remove_named_parameters(name)
        pair.set_theta(pair.theta)


def test_evaluate_under_a_full_ema_matches_jax(pair):
    """``evaluate`` of the port's trainer under an EMA tree that differs from
    θ (a full fp32 store): each prompt's own generator replaced by the x0
    the JAX eval draws from ``keys_for_prompts``, the EMA tree passed to
    ``inference(trainable=…)``, the images within 1e-4 of the JAX adapter's
    eval rollout under the same EMA; θ and the EMA unchanged bit for bit."""
    from flow_factory_tpu.ema.ema import EMA as JEMA
    from flow_factory_tpu.utils.base import keys_for_prompts
    from flow_factory_tpu_torch.ema import EMA
    from flow_factory_tpu_torch.rewards import RewardBuffer
    from flow_factory_tpu_torch.trainers.grpo import GRPOTrainer

    ja, pa = pair.ja, pair.pa
    pair.set_theta(pair.theta)
    prompts = [PROMPT, "a red fox in the snow"]
    ema_tree = _moved(pair.theta, np.random.default_rng(19), EMA_STD)
    ja.ema, pa.ema = JEMA(_jax_tree(ema_tree)), EMA(_port_tree(pair, ema_tree))
    ea = types.SimpleNamespace(height=32, width=32, num_inference_steps=4, guidance_scale=pair.guidance, seed=5)
    with torch.no_grad():
        embeds = {**{k: v.numpy() for k, v in pa.encode_prompt(prompts).items()},
                  **{f"negative_{k}": v.numpy() for k, v in pa.encode_prompt([""] * 2).items()}}
    keys = keys_for_prompts(prompts, ea.seed)
    x0 = np.asarray(jax.vmap(lambda k: jax.random.normal(k, pa.latent_shape(32, 32), jnp.float32))(keys))
    ja.eval()
    try:
        theirs = ja.inference(prompt=prompts, keys=keys, trainable=ja.ema_trainable, height=32, width=32,
                              num_inference_steps=4, guidance_scale=pair.guidance, compute_log_prob=False,
                              trajectory_indices=None, **{k: jnp.asarray(v) for k, v in embeds.items()})
    finally:
        ja.train()
        ja.ema = None

    trainer = object.__new__(GRPOTrainer)
    trainer.adapter, trainer.eval_args, trainer.logger_backend = pa, ea, None
    trainer.test_loader = [{"prompt": prompts, **embeds}]
    trainer.eval_reward_buffer = RewardBuffer([], group_size=1, distributed_groups=False)
    theta = {k: v.detach().clone() for k, v in pa.trainable["transformer"].items()}
    ema = {k: v.clone() for k, v in pa.ema.params["transformer"].items()}
    real, calls = pa.inference, []

    def spy(**kwargs):
        assert len(kwargs.pop("generator")) == len(prompts)  # one generator a prompt
        calls.append(kwargs["trainable"])
        out = real(**kwargs, x0=torch.from_numpy(x0))
        calls.append(out)
        return out

    store = pa.ema.params
    pa.inference = spy
    try:
        trainer.evaluate(0)
    finally:
        del pa.inference
        pa.ema = None
    assert calls[0] is store  # the EMA store itself, not θ and not a copy
    ours = calls[1]
    for s, j in zip(ours, theirs):
        np.testing.assert_allclose(s.image, j.image, atol=1e-4, rtol=0)
    assert all(torch.equal(v.detach(), theta[k]) for k, v in pa.trainable["transformer"].items())
    assert all(torch.equal(calls[0]["transformer"][k], v) for k, v in ema.items())
