"""PyTorch port, full finetuning against the JAX package: the GRPO loss, aux
metrics and the gradient of every weight (SD3's position grid included, F9)
on the tiny SD3.5 and the tiny Wan2.1, the one-tree gradient accumulation and
one update (clip, AdamW, EMA) against optax and the JAX EMA, full DPO on the
tiny Wan (the reference store equal to θ, the loss ln 2), the component
offload round trip and the EMA host store, and the release of the module's
own copy of the trained component. Both packages start from one seeded numpy
tree (the JAX init moved by seeded noise, so that no weight sits at a
special value) carried to the port by ``weights.full_from_flax``. fp32 on
the CPU."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_threads import one_torch_thread  # noqa: F401

B = 4
SD3_CONFIG = {
    "data": {"dataset_dir": "tests/fixtures/tiny_prompts"},
    "model": {"model_type": "sd3-5", "model_name_or_path": "tiny", "variant": "tiny", "finetune_type": "full",
              "attn_backend": "auto", "master_dtype": "float32", "inference_dtype": "float32"},
    "scheduler": {"dynamics_type": "Flow-SDE", "noise_level": 0.7, "num_sde_steps": 2, "sde_steps": [0, 1, 2]},
    "train": {"trainer_type": "grpo", "resolution": 32, "num_inference_steps": 4, "guidance_scale": 2.0,
              "per_device_batch_size": B, "group_size": B, "unique_sample_num_per_epoch": 1,
              "latent_storage_dtype": "fp32", "ema_decay": 0, "clip_range": 0.2, "adv_clip_range": 1.5,
              "learning_rate": 1e-3, "max_grad_norm": 0.05},
    "eval": {}, "log": {}, "rewards": [],
}
WAN_CONFIG = copy.deepcopy(SD3_CONFIG)
WAN_CONFIG["model"].update(model_type="wan2-t2v", attn_backend="native")
WAN_CONFIG["model"].pop("variant")
WAN_CONFIG["train"].update(guidance_scale=5.0, num_frames=5)
#: the leaves whose gradient JAX's tiny SD3.5 gives exactly zero under the
#: GRPO loss (F4's kind): the last block is context-pre-only, so its context
#: queries and their qk-norm scale feed no output
SD3_ZERO_GRAD = ("transformer_blocks.1.attn.add_q_proj.bias", "transformer_blocks.1.attn.add_q_proj.weight",
                 "transformer_blocks.1.attn.norm_added_q.weight")
PROMPT = "a lighthouse on a cliff at dusk"


def _host(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _moved(tree, rng, std=0.02):
    """``tree`` + N(0, std²) noise drawn leaf by leaf from ``rng``."""
    return jax.tree.map(lambda x: (x + std * rng.standard_normal(x.shape)).astype(np.float32), tree)


class Pair:
    """A JAX adapter and the port's on one moved full tree (``theta``, flax
    layout) and the frozen weights, the bridge's maps, and a CFG batch of
    ``B`` rows at one Flow-SDE step."""

    def __init__(self, config, state_dicts, seed):
        from flow_factory_tpu.hparams.args import Arguments as JArgs
        from flow_factory_tpu.models import load_adapter as jax_load
        from flow_factory_tpu.parallel.dist import set_world_size_override
        from flow_factory_tpu_torch.hparams import Arguments
        from flow_factory_tpu_torch.models import load_adapter

        set_world_size_override(1)
        try:
            self.ja = jax_load(JArgs.from_dict(copy.deepcopy(config)))
        finally:
            set_world_size_override(None)
        self.config = config
        self.rng = np.random.default_rng(seed)
        self.pa = load_adapter(Arguments.from_dict(copy.deepcopy(config)), device="cpu")
        self.pa.load_state_dicts(state_dicts(_host(self.ja.params), self.pa.component_configs))
        self.maps = self.pa.weight_maps()["transformer"]
        #: the names of the port's own full tree (``_setup_trainable``'s)
        self.own_names = set(self.pa.trainable["transformer"])
        self.theta = _moved(_host(self.ja.trainable["transformer"]), self.rng)
        self.set_theta(self.theta)

    def set_theta(self, theta):
        from flow_factory_tpu_torch.utils import weights

        self.ja.trainable = {"transformer": jax.tree.map(jnp.asarray, theta)}
        self.pa.trainable = {"transformer": {k: v.requires_grad_()
                                             for k, v in weights.full_from_flax(theta, self.maps).items()}}

    def port_names(self, flax_tree):
        """A flax-layout tree of this component in the port's names."""
        from flow_factory_tpu_torch.utils import weights

        return {k: v.numpy() for k, v in weights.full_from_flax(flax_tree, self.maps).items()}

    def named(self, grads):
        """The port's gradients (``trainable_leaves`` order) by name."""
        return {k: g.detach().numpy() for k, g in zip(sorted(self.pa.trainable["transformer"]), grads)}


def _grpo_batch(pair, embeds, shape, guidance):
    """A CFG batch of ``B`` rows at one Flow-SDE step, its next latents near
    the step's mean (moderate log-probs) and its old log-probs set so that
    the clip binds on rows 1 and 2 (ratios ~1.05, 0.61, 1.49, 1.11 against
    advantages +, -, +, -); the port's forward places them (the data only:
    both packages then run on these numbers)."""
    rng = pair.rng
    full = lambda v: np.full((B,), v, np.float32)
    batch = dict(latents=rng.standard_normal(shape).astype(np.float32),
                 next_latents=rng.standard_normal(shape).astype(np.float32),
                 timestep=full(750.0), sigma=full(0.75), sigma_next=full(0.5), noise_level=full(0.7),
                 sigma_max=full(0.9), advantage=np.asarray([1.2, -0.7, 2.5, -3.0], np.float32), **embeds)
    tb = lambda: {**{k: torch.from_numpy(v) for k, v in batch.items()}, "guidance_scale": guidance}
    with torch.no_grad():
        mean = pair.pa.training_forward(pair.pa.trainable, tb(), compute_log_prob=False).next_latents_mean
        batch["next_latents"] = (mean.numpy() + 0.3 * batch["next_latents"]).astype(np.float32)
        new_lp = pair.pa.training_forward(pair.pa.trainable, tb()).log_prob.numpy()
    batch["old_log_prob"] = (new_lp + np.asarray([-0.05, 0.5, -0.4, -0.1], np.float32))
    return batch


@pytest.fixture(scope="module")
def sd3():
    from flow_factory_tpu_torch.utils import weights

    pair = Pair(SD3_CONFIG, weights.sd35_state_dicts, 11)
    with torch.no_grad():
        enc = {k: v.numpy() for k, v in pair.pa.encode_prompt([PROMPT] * B).items()}
        neg = {f"negative_{k}": v.numpy() for k, v in pair.pa.encode_prompt([""] * B).items()}
    pair.batch = _grpo_batch(pair, {**enc, **neg}, (B, *pair.pa.latent_shape(32, 32)), 2.0)
    pair.guidance = 2.0
    return pair


@pytest.fixture(scope="module")
def wan():
    from flow_factory_tpu_torch.utils import weights

    pair = Pair(WAN_CONFIG, weights.wan_t2v_state_dicts, 12)
    with torch.no_grad():
        enc = pair.pa.encode_prompt([PROMPT] * B)["prompt_embeds"].numpy()
        neg = pair.pa.encode_prompt([""] * B)["prompt_embeds"].numpy()
    pair.batch = _grpo_batch(pair, {"prompt_embeds": enc, "negative_prompt_embeds": neg},
                             (B, *pair.pa.latent_shape(32, 32, 5)), 5.0)
    pair.guidance = 5.0
    return pair


def _trainers(pair):
    """Bare GRPO trainers on the pair's adapters: the JAX one made once a
    pair (it keeps its jitted ``_grad_fn`` for the next case), the port's
    anew."""
    from flow_factory_tpu.trainers.grpo import GRPOTrainer as JGRPO
    from flow_factory_tpu_torch.trainers.grpo import GRPOTrainer

    if not hasattr(pair, "jt"):
        pair.jt = object.__new__(JGRPO)
        pair.jt.training_args, pair.jt.use_guard, pair.jt.adapter = copy.copy(pair.ja.training_args), False, pair.ja
    pt = object.__new__(GRPOTrainer)
    pt.training_args, pt.use_guard, pt.adapter, pt.global_step = copy.copy(pair.pa.training_args), False, pair.pa, 0
    return pair.jt, pt


def _both_grpo(pair, batch):
    """((loss, aux, grads by port name) of the JAX ``_grad_fn``, then of the
    port's ``loss_and_grads``)."""
    jt, pt = _trainers(pair)
    jb = {**{k: jnp.asarray(v) for k, v in batch.items()}, "guidance_scale": jnp.float32(pair.guidance)}
    (jl, jaux), jg = jt._grad_fn(pair.ja.trainable, pair.ja.frozen_velocity_params(), jb, None)
    tb = {**{k: torch.from_numpy(v) for k, v in batch.items()}, "guidance_scale": pair.guidance}
    (tl, taux), tg = pt.loss_and_grads(tb)
    return ((float(jl), {k: float(v) for k, v in jaux.items()}, pair.port_names(_host(jg)["transformer"])),
            (float(tl), {k: float(v) for k, v in taux.items()}, pair.named(tg)))


def _assert_close(theirs, ours, rel=1e-4):
    """Every leaf within ``rel`` of that leaf's largest magnitude in JAX (a
    leaf JAX gives zeros must be exactly zero)."""
    assert set(ours) == set(theirs)
    for k, ref in theirs.items():
        err = np.abs(ours[k] - ref).max()
        assert err <= rel * max(np.abs(ref).max(), 1e-30), f"{k}: {err} vs max {np.abs(ref).max()}"


@pytest.mark.parametrize("family", ["sd3", "wan"])
def test_full_grpo_loss_aux_and_every_gradient_match_jax(family, request):
    """The port's own full tree has the JAX tree's leaves, through the
    bridge (SD3's position grid among them: F9, as a buffer it was not
    trained); one micro-batch at one timestep through the JAX GRPO
    ``_grad_fn`` and the port's ``loss_and_grads`` on the full tree: the
    clip binding on two rows; loss and aux 1e-5, every weight's gradient
    1e-4 of that leaf's max, the position grid's non-zero; the leaves JAX
    gives exact zeros are the context-pre-only block's context queries
    (``SD3_ZERO_GRAD``), and Wan has none."""
    pair = request.getfixturevalue(family)
    assert pair.own_names == set(pair.port_names(pair.theta))
    (jl, jaux, jg), (tl, taux, tg) = _both_grpo(pair, pair.batch)
    assert sorted(taux) == sorted(jaux)
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-7)
    for k in jaux:
        np.testing.assert_allclose(taux[k], jaux[k], rtol=1e-5, atol=1e-7, err_msg=k)
    assert 0.0 < taux["train/clip_frac"] < 1.0
    _assert_close(jg, tg)
    zero = sorted(k for k, g in jg.items() if not np.any(g))
    assert zero == (sorted(SD3_ZERO_GRAD) if family == "sd3" else [])
    if family == "sd3":
        assert "pos_embed.pos_embed" in pair.own_names and np.abs(tg["pos_embed.pos_embed"]).max() > 0


def test_one_tree_accumulation_and_update_match_optax_and_the_jax_ema(sd3, monkeypatch):
    """Two grad steps through ``backward_step`` (the backward adding into
    each leaf's ``.grad``) give the sum of the two steps' ``loss_and_grads``
    bit for bit; then the update of the two JAX steps' gradients (the
    per-leaf clip, which binds at ``max_grad_norm`` 0.05, then AdamW over
    parameter groups of bounded size, here 64 KiB so that there are several)
    against the JAX trainer's accumulation and ``_apply_updates_jit`` over
    optax, and the EMA of the moved tree against the JAX ``EMA``, each
    within 1e-6; the host-held EMA gives the device EMA's bits."""
    import optax

    from flow_factory_tpu.ema.ema import EMA as JEMA, constant_decay as jconst
    from flow_factory_tpu.trainers import abc as jabc
    from flow_factory_tpu_torch.ema import EMA, constant_decay
    from flow_factory_tpu_torch.trainers import abc as trainer_abc

    pair = sd3
    pair.set_theta(pair.theta)
    jt, pt = _trainers(pair)
    ta = pt.training_args
    second = {**pair.batch, "advantage": np.asarray([-0.4, 1.1, 0.3, -2.0], np.float32)}
    tb = lambda b: {**{k: torch.from_numpy(v) for k, v in b.items()}, "guidance_scale": pair.guidance}
    jb = lambda b: {**{k: jnp.asarray(v) for k, v in b.items()}, "guidance_scale": jnp.float32(pair.guidance)}
    steps = [pt.loss_and_grads(tb(b))[1] for b in (pair.batch, second)]
    monkeypatch.setattr(trainer_abc, "GROUP_BYTES", 64 * 1024)
    pt._init_optimizer()
    sizes = [sum(p.numel() * 4 for p in g["params"]) for g in pt.optimizer.param_groups]
    assert len(sizes) > 4 and all(n <= 64 * 1024 or len(g["params"]) == 1
                                  for n, g in zip(sizes, pt.optimizer.param_groups))
    for b in (pair.batch, second):
        pt.backward_step(tb(b))
    leaves = pair.pa.trainable_leaves()
    assert all(torch.equal(p.grad, a.clone().add_(b)) for p, a, b in zip(leaves, *steps))

    j_grads = [jt._grad_fn(pair.ja.trainable, pair.ja.frozen_velocity_params(), jb(b), None)[1]
               for b in (pair.batch, second)]
    acc = jabc._accum_add_jit(jabc._accum_init_jit(j_grads[0]), j_grads[1])
    opt = optax.chain(optax.clip_by_global_norm(ta.max_grad_norm),
                      optax.adamw(learning_rate=ta.learning_rate, b1=ta.adam_betas[0], b2=ta.adam_betas[1],
                                  eps=ta.adam_epsilon, weight_decay=ta.adam_weight_decay))
    j_params, _, j_norm = jabc._apply_updates_jit(opt, pair.ja.trainable, opt.init(pair.ja.trainable), acc, 2)
    pt.optimizer.zero_grad(set_to_none=True)
    pt._accum_count = 0
    for g in j_grads:
        named = pair.port_names(_host(g)["transformer"])
        for p, k in zip(leaves, sorted(named)):
            step = torch.from_numpy(named[k])
            p.grad = step.clone() if p.grad is None else p.grad.add_(step)
        pt._accum_count += 1
    norm = float(pt.apply_accumulated())
    np.testing.assert_allclose(norm, float(j_norm), rtol=1e-5)
    assert norm > ta.max_grad_norm and all(p.grad is None for p in leaves)
    want = pair.port_names(_host(j_params)["transformer"])
    got = {k: v.detach().numpy() for k, v in pair.pa.trainable["transformer"].items()}
    assert max(float(np.abs(got[k] - want[k]).max()) for k in want) <= 1e-6
    assert any(not np.array_equal(got[k], v) for k, v in pair.port_names(pair.theta).items())

    theta0 = {"transformer": {k: torch.from_numpy(v) for k, v in pair.port_names(pair.theta).items()}}
    ema, host_ema = EMA(theta0, constant_decay(0.99), 1), EMA(theta0, constant_decay(0.99), 1, offload=True)
    jema = JEMA({"transformer": jax.tree.map(jnp.asarray, pair.theta)}, jconst(0.99), 1)
    for store in (ema, host_ema):
        store.update(pair.pa.trainable, step=1)
    jema.update(j_params, step=1)
    jema_named = pair.port_names(_host(jema.params)["transformer"])
    for k, v in ema.params["transformer"].items():
        assert np.abs(v.numpy() - jema_named[k]).max() <= 1e-6, k
        assert torch.equal(v, host_ema.params["transformer"][k]) and host_ema.params["transformer"][k].device.type == "cpu"
    pair.set_theta(pair.theta)


def test_full_dpo_on_wan_is_log_2_with_the_reference_store_equal_to_theta(wan):
    """Full DPO on the tiny Wan, β 2000: ``init_ref_parameters`` stores θ bit
    for bit (detached), so the port's reference errors equal θ's, its loss
    is exactly ln 2 and its implicit margin exactly 0. JAX's are not exact
    on the full tree: XLA compiles the reference forward (no gradient) and
    θ's (under the gradient) into other fusions, and the two errors differ
    by fp32 rounding (margin 1.03e-7 here); they are held to the DPO bar of
    ``tests/torch_port_decoupled_cases.py``, β/2 x 4 fp32 ulps of the larger
    error. The θ errors within 1e-6 of JAX's (relative), every weight's
    gradient 1e-4 of the leaf's max."""
    from flow_factory_tpu.trainers.dpo import DPOTrainer as JDPO
    from flow_factory_tpu_torch.trainers.dpo import DPOTrainer

    pair = wan
    pair.set_theta(pair.theta)
    for ad in (pair.ja, pair.pa):
        ad.init_ref_parameters()
    ref = pair.pa.ref_trainable()["transformer"]
    assert set(ref) == set(pair.pa.trainable["transformer"])
    assert all(torch.equal(ref[k], t.detach()) and not ref[k].requires_grad
               for k, t in pair.pa.trainable["transformer"].items())
    rng = np.random.default_rng(13)
    shape = (2, *pair.pa.latent_shape(32, 32, 5))
    lat = lambda: {"latents": rng.standard_normal(shape).astype(np.float32)}
    batch = dict(chosen=lat(), rejected=lat(), noise=lat(), timestep=np.asarray([640.0, 210.0], np.float32),
                 prompt_embeds=pair.batch["prompt_embeds"][:2])
    jt, pt = JDPO.__new__(JDPO), DPOTrainer.__new__(DPOTrainer)
    for t, ad in ((jt, pair.ja), (pt, pair.pa)):
        t.adapter, t.training_args = ad, copy.copy(ad.training_args)
        t.training_args.beta = 2000.0
    conv = lambda fn: {k: ({kk: fn(vv) for kk, vv in v.items()} if isinstance(v, dict) else fn(v))
                       for k, v in batch.items()}
    (jl, jaux), jg = jt._grad_fn(pair.ja.trainable, pair.ja.frozen_velocity_params(),
                                 {**conv(jnp.asarray), "guidance_scale": jnp.float32(5.0)}, pair.ja.ref_trainable())
    (tl, taux), tg = pt.loss_and_grads({**conv(torch.from_numpy), "guidance_scale": 5.0},
                                       pt.reference_trainable())
    assert float(tl) == float(np.log(np.float32(2.0))) and float(taux["train/implicit_margin"]) == 0.0
    bar = 1000.0 * 4 * float(np.spacing(np.float32(max(float(jaux["train/theta_w_err"]),
                                                       float(jaux["train/theta_l_err"])))))
    assert abs(float(jl) - float(tl)) <= bar and abs(float(jaux["train/implicit_margin"])) <= bar
    for key in ("train/theta_w_err", "train/theta_l_err"):
        assert abs(float(taux[key]) - float(jaux[key])) <= 1e-6 * abs(float(jaux[key]))
    theirs, ours = pair.port_names(_host(jg)["transformer"]), pair.named(tg)
    _assert_close(theirs, ours)
    assert all(np.abs(g).max() > 0 for g in ours.values())


def test_offload_round_trip_and_release_of_the_module_copy(wan):
    """``offload_component``/``onload_component`` keep a frozen component's
    weights bit for bit and refuse the trained one; the trained component's
    module parameters are released (meta tensors) while its buffers stay,
    and an adapter that keeps them gives the same training forward bit for
    bit; a state dict loaded into a released component lands in the fp32
    master tree."""
    from flow_factory_tpu_torch.hparams import Arguments
    from flow_factory_tpu_torch.models import load_adapter
    from flow_factory_tpu_torch.models.abc import BaseAdapter
    from flow_factory_tpu_torch.utils import weights

    pair = wan
    pa = pair.pa
    pair.set_theta(pair.theta)
    before = {k: v.clone() for k, v in pa.modules["text_encoder"].state_dict().items()}
    pa.offload_component("text_encoder")
    assert all(p.device.type == "cpu" for p in pa.modules["text_encoder"].parameters())
    pa.onload_component("text_encoder")
    assert all(torch.equal(v, before[k]) for k, v in pa.modules["text_encoder"].state_dict().items())
    with pytest.raises(ValueError):
        pa.offload_component("transformer")
    module = pa.modules["transformer"]
    assert "transformer" in pa._released and all(p.is_meta for p in module.parameters())
    assert all(not b.is_meta for b in module.buffers())

    original = BaseAdapter._release_module_copy
    BaseAdapter._release_module_copy = lambda self, component: None
    try:
        kept = load_adapter(Arguments.from_dict(copy.deepcopy(WAN_CONFIG)), device="cpu")
    finally:
        BaseAdapter._release_module_copy = original
    sds = weights.wan_t2v_state_dicts(_host(pair.ja.params), kept.component_configs)
    kept.load_state_dicts(sds)
    assert not kept._released and not any(p.is_meta for p in kept.modules["transformer"].parameters())
    kept.trainable = {"transformer": {k: v.detach().clone().requires_grad_()
                                      for k, v in pa.trainable["transformer"].items()}}
    tb = {**{k: torch.from_numpy(v) for k, v in pair.batch.items()}, "guidance_scale": pair.guidance}
    with torch.no_grad():
        outs = [ad.training_forward(ad.trainable, tb) for ad in (pa, kept)]
    assert torch.equal(outs[0].log_prob, outs[1].log_prob)
    assert torch.equal(outs[0].next_latents_mean, outs[1].next_latents_mean)

    pa.load_state_dicts({"transformer": sds["transformer"]})
    for k, t in pa.trainable["transformer"].items():
        assert t.dtype == torch.float32 and t.requires_grad and torch.equal(t.detach(), sds["transformer"][k])
    pair.set_theta(pair.theta)
