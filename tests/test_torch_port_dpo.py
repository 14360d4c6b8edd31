"""PyTorch port, the decoupled trainers' base and the DPO trainer against
the JAX package, fp32 on the CPU: ``TimeSampler`` bit for bit, pair
formation and pair statistics, the DPO loss, its aux metrics and LoRA
gradients against the JAX ``_grad_fn`` on one shared batch (at the zero
LoRA, where both give log 2 exactly, and with a non-zero LoRA), the zero
LoRA's merge against the frozen weights bit for bit, and two epochs of the
tiny FLUX.1 DPO through ``load_trainer`` and through ``fft-train-torch``.
The JAX timestep features are fed to both packages, as in
tests/test_torch_port_flux.py."""
import copy
import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_threads import one_torch_thread  # noqa: F401

from test_torch_port_flux import _config_dict, shared_time_features  # noqa: F401 (a fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "tests/fixtures/smoke_dpo_flux.yaml")
PROMPT = "a red fox in fresh snow"
LOG2 = float(np.log(np.float32(2.0)))


@pytest.fixture(autouse=True)
def _restore_sigterm():
    prev = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, prev)


# ---------------------------------------------------------------------------
# TimeSampler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 12345])
def test_time_sampler_is_bit_equal_to_jax(seed):
    """Every sampler of the port's copy of ``utils/noise_schedule.py`` gives
    the JAX package's timesteps bit for bit from the same seed: logit-normal
    (stratified and not, with a shift and a fraction range), uniform (with
    and without a shift) and the three discrete forms on a FLUX schedule;
    and ``flow_match_sigma``."""
    from flow_factory_tpu.utils import noise_schedule as J
    from flow_factory_tpu_torch.utils import noise_schedule as T

    grid = np.linspace(1000.0, 100.0, 10).astype(np.float32)
    calls = [
        ("logit_normal_shifted", dict(batch_size=3, num_timesteps=5, timestep_range=0.99)),
        ("logit_normal_shifted", dict(batch_size=2, num_timesteps=1, timestep_range=(0.1, 0.9), logit_mean=0.3,
                                      logit_std=1.2, time_shift=3.0, stratified=False)),
        ("uniform", dict(batch_size=4, num_timesteps=6, timestep_range=0.99)),
        ("uniform", dict(batch_size=1, num_timesteps=3, timestep_range=(0.0, 0.8), time_shift=2.5)),
        ("discrete", dict(batch_size=2, num_train_timesteps=3, scheduler_timesteps=grid)),
        ("discrete", dict(batch_size=2, num_train_timesteps=3, scheduler_timesteps=grid, include_init=False)),
        ("discrete", dict(batch_size=2, num_train_timesteps=4, scheduler_timesteps=grid, force_init=True,
                          timestep_range=(0.0, 0.9))),
    ]
    for name, kw in calls:
        ours = getattr(T.TimeSampler, name)(seed=seed, **kw)
        theirs = getattr(J.TimeSampler, name)(seed=seed, **kw)
        assert ours.dtype == theirs.dtype == np.float32 and ours.shape == theirs.shape
        assert ours.tobytes() == theirs.tobytes(), (name, kw)
    t = np.asarray([0.0, 250.0, 1000.0, 1200.0])
    assert T.flow_match_sigma(t).tobytes() == J.flow_match_sigma(t).tobytes()


# ---------------------------------------------------------------------------
# Pairs
# ---------------------------------------------------------------------------

#: (prompt, advantage) of the samples: a group of 3, a tied group, a
#: singleton, a group of 4 whose max and min are not at its ends
GROUPS = [("p0", 0.5), ("p0", -1.0), ("p0", 0.7), ("p1", 0.2), ("p1", 0.2), ("p2", 1.0),
          ("p3", -0.1), ("p3", 2.0), ("p3", -3.0), ("p3", 0.4)]


def _samples(pkg):
    import importlib

    cls = importlib.import_module(f"{pkg}.samples").T2ISample
    return [cls(prompt=p, extra_kwargs={"advantage": a, "index": i}) for i, (p, a) in enumerate(GROUPS)]


def test_pair_formation_and_stats_equal_jax():
    """``_pairs_from_advantages`` forms the same (chosen, rejected) pairs
    as the JAX trainer (argmax/argmin per group, none from the tied group
    or the singleton), and ``_pair_stats`` gives the same statistics."""
    from flow_factory_tpu.trainers.dpo import DPOTrainer as J
    from flow_factory_tpu_torch.trainers.dpo import DPOTrainer as T

    idx = lambda pairs: [(c.extra_kwargs["index"], r.extra_kwargs["index"]) for c, r in pairs]
    ours, theirs = T._pairs_from_advantages(_samples("flow_factory_tpu_torch")), \
        J._pairs_from_advantages(_samples("flow_factory_tpu"))
    assert idx(ours) == idx(theirs) == [(2, 1), (7, 8)]
    assert T._pair_stats(ours, 1) == J._pair_stats(theirs, 1)
    assert T._pair_stats([], 1) == J._pair_stats([], 1) == {"train/dpo_num_pairs": 0.0}


def test_pairing_across_processes_raises(monkeypatch):
    """Above one process named by the environment, without a process group,
    the pairing's gathers raise in ``parallel/dist.py`` for both sampler
    types (the pairs across ranks: ``tests/test_torch_port_multiprocess.py``)."""
    from flow_factory_tpu_torch.trainers.dpo import DPOTrainer

    trainer = DPOTrainer.__new__(DPOTrainer)
    monkeypatch.setenv("WORLD_SIZE", "2")
    for sampler in ("group_contiguous", "distributed_k_repeat"):
        trainer.config = type("C", (), {"data_args": type("D", (), {"sampler_type": sampler})()})()
        with pytest.raises(RuntimeError, match="no process group"):
            trainer._form_pairs(_samples("flow_factory_tpu_torch"))


# ---------------------------------------------------------------------------
# The loss against the JAX _grad_fn
# ---------------------------------------------------------------------------

B = 2


@pytest.fixture(scope="module")
def pair():
    """Both tiny FLUX adapters on the JAX adapter's frozen weights and LoRA
    tree (``b`` zero, as initialised), and one shared pair batch: clean chosen/rejected
    latents, one noise draw, timesteps and the prompt embeddings."""
    from flow_factory_tpu.hparams.args import Arguments as JArgs
    from flow_factory_tpu.models import load_adapter as jax_load
    from flow_factory_tpu.parallel.dist import set_world_size_override
    from flow_factory_tpu_torch.hparams import Arguments
    from flow_factory_tpu_torch.models import load_adapter
    from flow_factory_tpu_torch.utils import weights

    cfg = _config_dict()
    set_world_size_override(1)
    try:
        ja = jax_load(JArgs.from_dict(copy.deepcopy(cfg)))
    finally:
        set_world_size_override(None)
    flax_params = jax.tree.map(np.asarray, jax.device_get(ja.params))
    lora = jax.tree.map(np.asarray, jax.device_get(ja.trainable["transformer"]))
    pa = load_adapter(Arguments.from_dict(copy.deepcopy(cfg)), device="cpu")
    pa.load_state_dicts(weights.flux1_state_dicts(flax_params, pa.component_configs))
    module_map = weights.flux1_component_maps(pa.component_configs)["transformer"][0]
    pa.load_lora("transformer", weights.lora_from_flax(lora, module_map))

    rng = np.random.default_rng(8)
    with torch.no_grad():
        enc = {k: v.numpy() for k, v in pa.encode_prompt([PROMPT] * B).items()}
    h, w, c = pa.latent_shape(32, 32)
    L = (h // 2) * (w // 2)
    lat = lambda: rng.standard_normal((B, L, 4 * c)).astype(np.float32)
    batch = dict(chosen={"latents": lat()}, rejected={"latents": lat()}, noise={"latents": lat()},
                 timestep=np.asarray([640.0, 210.0], np.float32), img_ids=pa.latent_image_ids(h, w),
                 txt_ids=np.zeros((enc["prompt_embeds"].shape[1], 3), np.float32), **enc)
    return ja, pa, lora, module_map, batch


def _tree(batch, fn):
    return {k: ({kk: fn(vv) for kk, vv in v.items()} if isinstance(v, dict) else fn(v)) for k, v in batch.items()}


def _both_losses(pair, lora_b, beta: float):
    """The JAX ``_grad_fn`` and the port's ``loss_and_grads`` at ``beta`` on
    the shared batch with LoRA ``b`` set to ``lora_b`` (None: zero): ((loss,
    aux, grads as flax trees) for JAX, then for the port)."""
    from flow_factory_tpu.trainers.dpo import DPOTrainer as JDPO
    from flow_factory_tpu_torch.trainers.dpo import DPOTrainer
    from flow_factory_tpu_torch.utils import weights

    ja, pa, lora, module_map, batch = pair
    jt, pt = JDPO.__new__(JDPO), DPOTrainer.__new__(DPOTrainer)
    for trainer, adapter in ((jt, ja), (pt, pa)):
        trainer.adapter, trainer.training_args = adapter, copy.copy(adapter.training_args)
        trainer.training_args.beta = beta
    tree = {p: {"a": ab["a"], "b": ab["b"] if lora_b is None else lora_b[p]} for p, ab in lora.items()}
    trainable = {"transformer": jax.tree.map(jnp.asarray, tree)}
    jbatch = {**_tree(batch, jnp.asarray), "guidance_scale": jnp.float32(3.5)}
    (jloss, jaux), jgrads = jt._grad_fn(trainable, ja.frozen_velocity_params(), jbatch, ja.ref_trainable())
    pa.load_lora("transformer", weights.lora_from_flax(tree, module_map))
    tbatch = {**_tree(batch, torch.from_numpy), "guidance_scale": 3.5}
    (loss, aux), grads = pt.loss_and_grads(tbatch, pt.reference_trainable())
    it = iter(grads)
    named = {p: {k: next(it) for k in sorted(pa.trainable["transformer"][p])}
             for p in sorted(pa.trainable["transformer"])}
    return ((float(jloss), {k: float(v) for k, v in jaux.items()}, jax.tree.map(np.asarray, jgrads)["transformer"]),
            (float(loss), {k: float(v) for k, v in aux.items()}, weights.lora_to_flax(named, module_map)))


def _grads_close(ours, theirs, rel):
    assert set(ours) == set(theirs)
    for path in theirs:
        for k in ("a", "b"):
            ref = theirs[path][k]
            err = np.abs(ours[path][k] - ref).max()
            assert err <= rel * max(np.abs(ref).max(), 1e-30), f"{path}/{k}: {err} vs max {np.abs(ref).max()}"


def test_dpo_loss_is_log_2_at_the_zero_lora_in_both(pair, shared_time_features):
    """At the initial LoRA (``b`` = 0, β 2000 as the FLUX.1 DPO config has
    it) θ is the reference: ``tw == rw`` and ``tl == rl`` bit for bit in both
    packages (the port's reference runs the frozen weights, the JAX one
    merges the zero LoRA), so the implicit margin is exactly 0 and the loss
    exactly −log σ(0) = log 2 in fp32; the θ errors within 1e-6 of JAX's
    (relative) and the LoRA gradients (``b``'s only: ``a``'s are exactly 0
    in both) within 1e-4 of each leaf's max."""
    (jl, jaux, jg), (tl, taux, tg) = _both_losses(pair, None, 2000.0)
    assert jl == tl == LOG2
    assert jaux["train/implicit_margin"] == taux["train/implicit_margin"] == 0.0
    for key in ("train/theta_w_err", "train/theta_l_err"):
        assert abs(taux[key] - jaux[key]) <= 1e-6 * abs(jaux[key])
    assert all(not np.any(g["a"]) for g in tg.values()) and all(not np.any(g["a"]) for g in jg.values())
    assert all(np.abs(g["b"]).max() > 0 for g in tg.values())
    _grads_close(tg, jg, 1e-4)


def _lora_b(pair, scale):
    rng = np.random.default_rng(9)
    return {p: (scale * rng.standard_normal(ab["b"].shape)).astype(np.float32) for p, ab in pair[2].items()}


def test_dpo_loss_aux_and_lora_grads_match_jax(pair, shared_time_features):
    """With a non-zero LoRA ``b`` (scale 0.2) at β 10: the loss within 1e-5
    of the JAX ``_grad_fn``'s, every aux metric within 1e-5 (relative above
    1), every LoRA gradient leaf, the fused ``linear1``/``linear2`` ones
    included, within 1e-4 of its max. β 10 because the loss moves by β/2
    times the θ and reference errors' differences: at β 2000 one fp32 ulp of
    an error (2.4e-7 at 3.2) is 2.4e-4 of margin, more than the bar (the
    next test holds β 2000 to that)."""
    (jl, jaux, jg), (tl, taux, tg) = _both_losses(pair, _lora_b(pair, 0.2), 10.0)
    assert 0.05 < abs(jaux["train/implicit_margin"]) < 20, jaux  # the sigmoid neither flat nor saturated
    assert abs(tl - jl) <= 1e-5 and tl != LOG2
    assert set(taux) == set(jaux)
    for key, ref in jaux.items():
        assert abs(taux[key] - ref) <= 1e-5 * max(1.0, abs(ref)), (key, taux[key], ref)
    _grads_close(tg, jg, 1e-4)


def test_dpo_margin_at_beta_2000_within_the_errors_ulps(pair, shared_time_features):
    """At the config's β 2000 with a small non-zero LoRA ``b`` (scale 2e-3):
    the θ errors within 1e-6 of JAX's (relative), and the implicit margin
    and loss within what four fp32 ulps of the errors allow, β/2 x 4 ulp."""
    (jl, jaux, jg), (tl, taux, tg) = _both_losses(pair, _lora_b(pair, 2e-3), 2000.0)
    errs = [jaux["train/theta_w_err"], jaux["train/theta_l_err"]]
    for key, ref in zip(("train/theta_w_err", "train/theta_l_err"), errs):
        assert abs(taux[key] - ref) <= 1e-6 * abs(ref)
    bar = 0.5 * 2000.0 * 4 * float(np.spacing(np.float32(max(errs))))
    assert 0.05 < abs(jaux["train/implicit_margin"]) < 20, jaux
    assert abs(taux["train/implicit_margin"] - jaux["train/implicit_margin"]) <= bar
    assert abs(tl - jl) <= bar


def test_zero_lora_merge_is_the_frozen_weight_bit_for_bit(pair):
    """The reference forward may run on the frozen weights: the zero LoRA's
    merge ``(W.float() + 0).to(W.dtype)`` equals W bit for bit, in fp32 and
    in bf16, for every targeted weight of the tiny FLUX."""
    from flow_factory_tpu_torch.models.lora import merge_lora, zero_like_lora

    pa = pair[1]
    module = pa.modules["transformer"]
    zero = zero_like_lora(pa.trainable["transformer"])
    for dtype in (torch.float32, torch.bfloat16):
        m = copy.deepcopy(module).to(dtype)
        merged = merge_lora(m, zero, pa.lora_scale)
        assert len(merged) == 28
        for name, w in merged.items():
            frozen = m.get_parameter(name)
            assert w.dtype == frozen.dtype and torch.equal(w.view(torch.int16 if dtype == torch.bfloat16
                                                                   else torch.int32),
                                                           frozen.view(torch.int16 if dtype == torch.bfloat16
                                                                       else torch.int32)), name


# ---------------------------------------------------------------------------
# The tiny FLUX.1 DPO, two epochs
# ---------------------------------------------------------------------------

def _rows(path):
    rows = [json.loads(line) for line in open(path)]
    return [r for r in rows if "media_tag" not in r]


def _check_two_epochs(rows):
    """Epoch 0's one grad step runs at the zero LoRA: loss log 2 exactly and
    margin 0; epoch 1's at the moved LoRA: another loss; both with a
    finite non-zero gradient norm and the two pairs."""
    assert [r["step"] for r in rows] == [0, 1]
    assert rows[0]["train/loss"] == LOG2 and rows[0]["train/implicit_margin"] == 0.0
    assert rows[1]["train/loss"] != LOG2 and np.isfinite(rows[1]["train/loss"])
    for r in rows:
        assert np.isfinite(r["train/grad_norm"]) and r["train/grad_norm"] > 0
        assert r["train/dpo_num_pairs"] == 2.0 and np.isfinite(r["reward/mean"])


def test_flux_dpo_runs_two_epochs_through_load_trainer(tmp_path):
    """``load_trainer(cfg, device="cpu").start()`` on
    tests/fixtures/smoke_dpo_flux.yaml: the rollouts keep only the final
    latent, the LoRA ``B`` moves, the optimizer steps once an epoch, no
    kernel launches on the CPU, and the epochs' metrics as
    ``_check_two_epochs`` wants them."""
    from flow_factory_tpu_torch import ops
    from flow_factory_tpu_torch.hparams import Arguments
    from flow_factory_tpu_torch.trainers import load_trainer
    from flow_factory_tpu_torch.trainers.dpo import DPOTrainer

    cfg = Arguments.load_from_yaml(SMOKE)
    cfg.data_args.cache_dir = str(tmp_path / "cache")
    cfg.log_args.save_dir = str(tmp_path / "saves")
    trainer = load_trainer(cfg, device="cpu")
    assert isinstance(trainer, DPOTrainer) and trainer.adapter.component_configs["transformer"].remat
    b0 = {p: ab["lora_B"].detach().clone() for p, ab in trainer.adapter.trainable["transformer"].items()}
    ops.reset_launch_counts()
    try:
        trainer.start()
    finally:
        trainer.cleanup()
    _check_two_epochs(_rows(tmp_path / "saves" / "smoke_dpo_flux" / "metrics.jsonl"))
    samples = trainer.reward_buffer.samples
    assert len(samples) == 4 and all(s.all_latents.shape[0] == 1 and s.log_probs is None for s in samples)
    assert trainer.global_step == 2
    assert max((trainer.adapter.trainable["transformer"][p]["lora_B"] - b).abs().max().item()
               for p, b in b0.items()) > 0
    assert ops.launch_counts() == {name: 0 for name in ops.KERNEL_WRAPPERS}


def test_flux_dpo_runs_two_epochs_through_the_cli(tmp_path):
    """``fft-train-torch tests/fixtures/smoke_dpo_flux.yaml --set
    model.device=cpu`` (the CLI's ``train_cli``) trains the same two epochs
    and writes the same metrics as ``load_trainer``."""
    from flow_factory_tpu_torch.cli import train_cli

    train_cli([SMOKE, "--set", "model.device=cpu", "--set", f"data.cache_dir={tmp_path / 'cache'}",
               "--set", f"log.save_dir={tmp_path / 'saves'}"])
    _check_two_epochs(_rows(tmp_path / "saves" / "smoke_dpo_flux" / "metrics.jsonl"))


def test_decoupled_tree_helpers():
    """``noised_latents`` is (1−σ)·x1 + σ·ε with σ = t/1000 per row,
    ``tree_flat`` concatenates the leaves in sorted-key order, and
    ``tree_normal`` draws each leaf from the generator in that order."""
    from flow_factory_tpu.trainers.decoupled import DecoupledTrainer as J
    from flow_factory_tpu_torch.trainers.decoupled import DecoupledTrainer as T

    rng = np.random.default_rng(10)
    clean, noise = (rng.standard_normal((2, 3, 4)).astype(np.float32) for _ in range(2))
    t = np.asarray([250.0, 900.0], np.float32)
    np.testing.assert_array_equal(T.noised_latents(*map(torch.from_numpy, (clean, noise, t))).numpy(),
                                  np.asarray(J.noised_latents(*map(jnp.asarray, (clean, noise, t)))))
    tree = {"b": torch.ones(2, 3), "a": torch.zeros(2, 2, 2)}
    assert torch.equal(T.tree_flat(tree), torch.cat([tree["a"].reshape(2, -1), tree["b"]], dim=1))
    drawn = T.tree_normal(torch.Generator().manual_seed(3), tree)
    again = torch.Generator().manual_seed(3)
    assert list(drawn) == ["a", "b"]
    assert torch.equal(drawn["a"], torch.randn((2, 2, 2), generator=again))
    assert torch.equal(drawn["b"], torch.randn((2, 3), generator=again))


def test_decoupled_micro_batches_follow_the_jax_shuffle(pair):
    """``iter_micro_batches`` takes the samples in the order of the JAX
    ``iter_micro_batches`` (the same ``derive_seed("shuffle", seed, epoch,
    inner)`` permutation, the remainder cycle-padded) and stages each
    micro-batch's final latents and embeds on the device."""
    from flow_factory_tpu.utils.base import derive_seed as jax_seed
    from flow_factory_tpu_torch.samples import T2ISample
    from flow_factory_tpu_torch.trainers.dpo import DPOTrainer

    pa = pair[1]
    trainer = DPOTrainer.__new__(DPOTrainer)
    trainer.adapter, trainer.training_args, trainer.micro_batch_size = pa, pa.training_args, 2
    trainer._preempt_event = type("E", (), {"is_set": staticmethod(lambda: False)})()
    rng = np.random.default_rng(11)
    samples = [T2ISample(prompt=PROMPT, all_latents=rng.standard_normal((1, 4, 8)).astype(np.float32),
                         prompt_embeds=rng.standard_normal((3, 5)).astype(np.float32),
                         extra_kwargs={"index": i, "img_ids": np.zeros((4, 3), np.float32)}) for i in range(5)]
    perm = np.random.default_rng(jax_seed("shuffle", pa.training_args.seed, 3, 1)).permutation(5)
    order = np.concatenate([perm, perm[:1]])
    batches = list(trainer.iter_micro_batches(samples, 3, 1))
    assert [[s.extra_kwargs["index"] for s in mb] for mb, _ in batches] == order.reshape(3, 2).tolist()
    for mb, bn in batches:
        clean = trainer.clean_latent_tree(bn)["latents"]
        assert torch.equal(clean, torch.from_numpy(np.stack([s.all_latents[-1] for s in mb])))
        assert set(trainer.batch_embeds(bn)) == {"prompt_embeds", "img_ids"}
