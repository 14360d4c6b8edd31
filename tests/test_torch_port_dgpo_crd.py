"""PyTorch port, the DGPO and CRD trainers against the JAX package, fp32 on
the CPU: the DGPO and CRD losses, every aux metric and the LoRA gradients
against the JAX trainers' own ``_grad_fn`` on the tiny SD3.5 adapter (CFG
over negative embeds) and the tiny Wan adapter, on the same numpy batch,
noise and LoRA; CRD's ``compute_decay`` against JAX's; DGPO's shared
timesteps and CRD's per-micro-batch timesteps bit for bit; DGPO's shared
noise and group numbering; and CRD at a micro-batch of one, where the
centered loss and its gradients are exactly 0 in both packages.

Both packages run on the JAX adapter's weights and a LoRA with a non-zero
``b`` through the weight bridge. DGPO's ``ema_ref`` snapshot is that LoRA
with ``b`` x 0.8, CRD's old policy the one with ``b`` x 0.2 (so that the
implicit reward, a difference of the two errors, is some 0.3). The ``b`` is drawn at 0.6 (not the
0.05 of the other parity tests) so that the DGPO errors of θ and of the
reference differ by some 0.3, far more than their fp32 rounding: the
preference is that difference. DGPO's clip range is set between the rows'
ratios so that it binds on one row of each advantage sign, well clear of
either edge."""
import copy
import signal
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_threads import one_torch_thread  # noqa: F401

from test_torch_port_train import CONFIG as SD35_CONFIG, _leaf_close, _port_grads_as_flax
from test_torch_port_wan_train import CONFIG as WAN_CONFIG

B = 4
T_SHARED = 640.0
#: per-row advantages (two positive, two negative) and unique ids: rows 0
#: and 2 one prompt group, rows 1 and 3 the other
ADVANTAGE = np.asarray([1.2, -0.4, 0.9, -0.3], np.float32)
#: CRD's per-row timesteps
CRD_T = np.asarray([640.0, 610.0, 670.0, 700.0], np.float32)


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


def _host(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _pair(config, state_dicts, module_map_of):
    """The JAX adapter of ``config``, the port's on its weights, a LoRA with
    ``b`` of std 0.6 on both, and the bridge's module map."""
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
    lora = {p: {"a": ab["a"], "b": (0.6 * rng.standard_normal(ab["b"].shape)).astype(np.float32)}
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
    batch)} for the tiny SD3.5 adapter (negative prompt embeds for CFG) and
    the tiny Wan adapter (5 frames): clean latents, noise shared by the rows
    of a group, one timestep for every row, the advantages."""
    from flow_factory_tpu_torch.utils import weights

    out = {
        "sd35": _pair(SD35_CONFIG, weights.sd35_state_dicts, lambda pa: weights.sd3_transformer_map(
            pa.component_configs["transformer"].depth,
            pa.component_configs["transformer"].dual_attention_layers)[0]),
        "wan": _pair(WAN_CONFIG, weights.wan_t2v_state_dicts,
                     lambda pa: weights.wan_transformer_map(pa.component_configs["transformer"].num_layers)[0]),
    }
    rng = np.random.default_rng(8)
    for name, (ja, pa, lora, module_map) in out.items():
        with torch.no_grad():
            enc = {k: v.numpy() for k, v in pa.encode_prompt(["a red fox in fresh snow"] * B).items()}
            neg = {f"negative_{k}": v.numpy() for k, v in pa.encode_prompt([""] * B).items()}
        shape = (B, *(pa.latent_shape(32, 32) if name == "sd35" else pa.latent_shape(32, 32, 5)))
        group_noise = rng.standard_normal((2, *shape[1:])).astype(np.float32)
        batch = dict(clean={"latents": rng.standard_normal(shape).astype(np.float32)},
                     noise={"latents": group_noise[[0, 1, 0, 1]]},
                     timestep=np.full((B,), T_SHARED, np.float32), advantage=ADVANTAGE, **enc, **neg)
        out[name] = (ja, pa, lora, module_map, batch)
    return out


@pytest.fixture(scope="module")
def shared():
    """JAX quantities that every case of one pair reads, computed by the
    first case that asks ({key: value})."""
    return {}


def _once(shared, key, compute):
    if key not in shared:
        shared[key] = compute()
    return shared[key]


def _jbatch(batch, guidance):
    tree = {k: ({kk: jnp.asarray(vv) for kk, vv in v.items()} if isinstance(v, dict) else jnp.asarray(v))
            for k, v in batch.items()}
    return {**tree, "guidance_scale": jnp.float32(guidance)}


def _tbatch(batch, guidance):
    tree = {k: ({kk: torch.from_numpy(vv) for kk, vv in v.items()} if isinstance(v, dict) else torch.from_numpy(v))
            for k, v in batch.items()}
    return {**tree, "guidance_scale": float(guidance)}


def _scaled(lora, s):
    return {p: {"a": ab["a"], "b": (s * ab["b"]).astype(np.float32)} for p, ab in lora.items()}


def _compare(loss, aux, grads, j_loss, j_aux, j_grads, pa, module_map, what):
    """Loss and every aux metric 1e-5 relative (1e-7 absolute), the same aux
    keys, every LoRA gradient leaf 1e-4 of its max."""
    assert sorted(aux) == sorted(j_aux), what
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5, atol=1e-7, err_msg=what)
    for k in j_aux:
        np.testing.assert_allclose(float(aux[k]), float(j_aux[k]), rtol=1e-5, atol=1e-7, err_msg=f"{what} {k}")
    _leaf_close(_port_grads_as_flax(pa, grads, module_map), jax.tree.map(np.asarray, j_grads)["transformer"], 1e-4,
                what)


def _jax_dsm(ja, batch, trainable):
    """(B,) the JAX velocity's error without CFG at the batch's timestep."""
    from flow_factory_tpu.trainers.decoupled import DecoupledTrainer as JD

    jb = _jbatch(batch, 1.0)
    fwd = {k: v for k, v in {**jb, **JD.tree_noised(jb["clean"], jb["noise"], jb["timestep"])}.items()
           if not k.startswith("negative_")}
    v = np.asarray(ja.training_velocity(trainable, fwd)).reshape(B, -1)
    return ((v - (batch["noise"]["latents"] - batch["clean"]["latents"]).reshape(B, -1)) ** 2).mean(-1)


def _clip_range_binding_once_a_sign(ja, batch, lora):
    """(lo, hi) between the rows' ratios exp(old_dsm − dsm) − 1 of each
    advantage sign (θ against the ``ema_ref`` LoRA), so that the clip binds
    on exactly one row of each sign, each row at least 1e-3 from its edge."""
    th = _jax_dsm(ja, batch, ja.trainable)
    old = _jax_dsm(ja, batch, {"transformer": jax.tree.map(jnp.asarray, _scaled(lora, 0.8))})
    d = np.exp(old.astype(np.float64) - th) - 1.0
    pos, neg = np.sort(d[ADVANTAGE > 0]), np.sort(d[ADVANTAGE < 0])
    assert pos[1] - pos[0] > 2e-3 and neg[1] - neg[0] > 2e-3, d
    return float((neg[0] + neg[1]) / 2), float((pos[0] + pos[1]) / 2)


DGPO_CASES = {
    "plain": dict(clip_dsm=False, kl_beta=0.0),
    "clip_dsm": dict(clip_dsm=True, kl_beta=0.0),
    "kl": dict(clip_dsm=False, kl_beta=0.5),
    "clip_dsm-kl": dict(clip_dsm=True, kl_beta=0.5),
    "ema_ref-clip_kl": dict(clip_dsm=True, clip_kl=True, use_ema_ref=True, kl_beta=0.5),
    "kl_cfg3": dict(clip_dsm=True, kl_beta=0.5, kl_cfg=3.0),
}


@pytest.mark.parametrize("adapter,case", [("sd35", c) for c in DGPO_CASES]
                         + [("wan", c) for c in ("ema_ref-clip_kl", "kl_cfg3")])
def test_dgpo_loss_aux_and_lora_grads_match_jax(pairs, shared, adapter, case):
    """One micro-batch of 4 (two prompt groups, rows 0/2 and 1/3, each
    group's rows on one noise draw) at one shared timestep through the JAX
    trainer's ``_grad_fn`` and the port's ``with_frozen_velocities`` +
    ``loss_and_grads``: β 5, K 2, ``ema_ref`` the LoRA with ``b`` x 0.8
    (when a clip or ``use_ema_ref`` asks for it), the reference the zero
    LoRA (in the port the frozen weights, bit for bit), the KL's teacher
    under CFG 3 over the negative embeds in ``kl_cfg3``. Loss and every aux
    metric 1e-5, every LoRA gradient leaf 1e-4 of its max; with a clip,
    ``clip_ratio`` exactly 0.5."""
    from flow_factory_tpu.trainers.dgpo import DGPOTrainer as JDGPO
    from flow_factory_tpu_torch.trainers.dgpo import DGPOTrainer
    from flow_factory_tpu_torch.utils import weights

    ja, pa, lora, module_map, batch = pairs[adapter]
    opts = {"clip_kl": False, "use_ema_ref": False, "kl_cfg": 1.0, **DGPO_CASES[case]}
    clip = (_once(shared, ("clip", adapter), lambda: _clip_range_binding_once_a_sign(ja, batch, lora))
            if opts["clip_dsm"] else (-0.01, 0.01))
    ta = types.SimpleNamespace(dpo_beta=5.0, group_size=2, clip_range=clip, **opts)
    needs_ema_ref = bool(ta.clip_dsm or ta.clip_kl or ta.use_ema_ref)
    jt, pt = object.__new__(JDGPO), object.__new__(DGPOTrainer)
    jt.training_args, jt.adapter, jt.dpo_beta = ta, ja, ta.dpo_beta
    pt.training_args, pt.adapter, pt.requires_ema_ref = ta, pa, needs_ema_ref
    ids, num_groups = DGPOTrainer.group_ids([types.SimpleNamespace(unique_id=u) for u in "abab"])
    assert (ids, num_groups) == ([0, 1, 0, 1], 2)

    jb = {**_jbatch(batch, 1.0), "group_ids": jnp.asarray(ids, jnp.int32)}
    ema_ref = _scaled(lora, 0.8)
    (j_loss, j_aux), j_grads = jt._grad_fn(
        ja.trainable, ja.frozen_velocity_params(), jb, ja.ref_trainable(),
        {"transformer": jax.tree.map(jnp.asarray, ema_ref)} if needs_ema_ref else None, num_groups)

    tb = {**_tbatch(batch, 1.0), "group_ids": torch.tensor(ids), "num_groups": num_groups}
    with torch.no_grad():
        old = (pa.merged_params("transformer", {"transformer": weights.lora_from_flax(ema_ref, module_map)})
               if needs_ema_ref else None)
    (loss, aux), grads = pt.loss_and_grads(pt.with_frozen_velocities(tb, old))
    _compare(loss, aux, grads, j_loss, j_aux, j_grads, pa, module_map, f"dgpo {adapter} {case}")
    if ta.clip_dsm:
        assert float(aux["train/clip_ratio"]) == 0.5
    assert 0.0 < float(aux["train/group_weight_mean"]) < 1.0 and float(aux["train/group_weight_mean"]) != 0.5


CRD_CASES = {
    **{f"{lt}-w{wt:g}": dict(crd_loss_type=lt, weight_temp=wt) for lt in ("mse", "bce") for wt in (-1.0, 0.0, 0.5)},
    "adaptive_logp": dict(crd_loss_type="mse", weight_temp=0.0, adaptive_logp=True),
    "kl": dict(crd_loss_type="mse", weight_temp=0.5, kl_beta=0.5),
    "kl-reward_adaptive-cfg3": dict(crd_loss_type="bce", weight_temp=0.0, kl_beta=0.5, reward_adaptive_kl=True,
                                    kl_cfg=3.0),
    "empty_pool": dict(crd_loss_type="mse", weight_temp=0.0, advantage=[1.2, 0.4, 0.9, 0.3]),
}


@pytest.mark.parametrize("adapter,case", [("sd35", c) for c in CRD_CASES]
                         + [("wan", c) for c in ("bce-w0.5", "kl-reward_adaptive-cfg3")])
def test_crd_loss_aux_and_lora_grads_match_jax(pairs, shared, adapter, case):
    """One micro-batch of 4 at four per-row timesteps through the JAX
    trainer's ``_grad_fn`` and the port's ``loss_and_grads``, the old
    velocity (the LoRA with ``b`` x 0.2, without CFG) the JAX one for both
    after the port's own old forward is held to it (1e-5 of its max): crd_β
    1.5, the advantages clipped to ±1.5; the MSE and BCE losses under the
    uniform (``weight_temp`` −1), hard-pool (0) and softmax (0.5) weights,
    ``adaptive_logp``, the KL with and without ``reward_adaptive_kl`` (its
    teacher under CFG 3), and a batch whose negative pool is empty (the
    uniform fallback). Loss and every aux metric 1e-5, every LoRA gradient
    leaf 1e-4 of its max."""
    from flow_factory_tpu.trainers.crd import CRDTrainer as JCRD
    from flow_factory_tpu.trainers.decoupled import DecoupledTrainer as JD
    from flow_factory_tpu_torch.trainers.crd import CRDTrainer
    from flow_factory_tpu_torch.trainers.decoupled import uncfg
    from flow_factory_tpu_torch.utils import weights

    ja, pa, lora, module_map, batch = pairs[adapter]
    opts = {"adaptive_logp": False, "kl_beta": 0.0, "kl_cfg": 1.0, "reward_adaptive_kl": False, **CRD_CASES[case]}
    adv = np.asarray(opts.pop("advantage", ADVANTAGE), np.float32)
    ta = types.SimpleNamespace(crd_beta=1.5, adv_clip_range=(-1.5, 1.5), **opts)
    batch = {**batch, "timestep": CRD_T, "advantage": adv}
    jb, tb = _jbatch(batch, 2.0), _tbatch(batch, 2.0)

    def old_velocity():  # the advantages do not reach it: one for every case of the pair
        fwd = {k: v for k, v in {**jb, **JD.tree_noised(jb["clean"], jb["noise"], jb["timestep"])}.items()
               if not k.startswith("negative_")}
        old_v = np.array(ja.training_velocity(_lora_tree(lora, 0.2), fwd))
        with torch.no_grad():
            params = pa.merged_params("transformer",
                                      {"transformer": weights.lora_from_flax(_scaled(lora, 0.2), module_map)})
            ours = pa.training_velocity(None, uncfg({**tb, "latents": CRDTrainer.noised_latents(
                tb["clean"]["latents"], tb["noise"]["latents"], tb["timestep"])}), params=params).numpy()
        assert np.abs(ours - old_v).max() <= 1e-5 * np.abs(old_v).max()
        return old_v

    old_v = _once(shared, ("crd_old_v", adapter), old_velocity)

    jt, pt = object.__new__(JCRD), object.__new__(CRDTrainer)
    jt.training_args, jt.adapter, pt.training_args, pt.adapter = ta, ja, ta, pa
    (j_loss, j_aux), j_grads = jt._grad_fn(ja.trainable, ja.frozen_velocity_params(),
                                           {**jb, "old_v": {"latents": jnp.asarray(old_v)}}, ja.ref_trainable())
    (loss, aux), grads = pt.loss_and_grads({**tb, "old_v": {"latents": torch.from_numpy(old_v)}},
                                           pt.reference_trainable())
    _compare(loss, aux, grads, j_loss, j_aux, j_grads, pa, module_map, f"crd {adapter} {case}")


def _lora_tree(lora, s):
    return {"transformer": jax.tree.map(jnp.asarray, _scaled(lora, s))}


def test_crd_micro_batch_of_one_gives_exactly_zero(pairs):
    """At a micro-batch of one the centered rewards are 0 − 0 under every
    weighting, so CRD's MSE loss and every LoRA gradient are exactly 0 in
    both packages (why the card runs CRD at a per-device batch of 8, not the
    example's 1)."""
    from flow_factory_tpu.trainers.crd import CRDTrainer as JCRD
    from flow_factory_tpu.trainers.decoupled import DecoupledTrainer as JD
    from flow_factory_tpu_torch.trainers.crd import CRDTrainer

    ja, pa, lora, module_map, batch = pairs["sd35"]
    one = {k: ({kk: vv[:1] for kk, vv in v.items()} if isinstance(v, dict) else v[:1]) for k, v in batch.items()}
    jb = _jbatch(one, 2.0)
    fwd = {k: v for k, v in {**jb, **JD.tree_noised(jb["clean"], jb["noise"], jb["timestep"])}.items()
           if not k.startswith("negative_")}
    old_v = np.array(ja.training_velocity(_lora_tree(lora, 0.2), fwd))
    ta = types.SimpleNamespace(crd_beta=1.0, adv_clip_range=(-1.5, 1.5), crd_loss_type="mse", weight_temp=0.0,
                               adaptive_logp=False, kl_beta=0.0, kl_cfg=1.0, reward_adaptive_kl=False)
    jt, pt = object.__new__(JCRD), object.__new__(CRDTrainer)
    jt.training_args, jt.adapter, pt.training_args, pt.adapter = ta, ja, ta, pa
    (j_loss, _), j_grads = jt._grad_fn(ja.trainable, ja.frozen_velocity_params(),
                                       {**jb, "old_v": {"latents": jnp.asarray(old_v)}}, ja.ref_trainable())
    (loss, _), grads = pt.loss_and_grads({**_tbatch(one, 2.0),
                                            "old_v": {"latents": torch.from_numpy(old_v)}})
    assert float(j_loss) == 0.0 and float(loss) == 0.0
    assert all(not np.asarray(g).any() for g in jax.tree.leaves(j_grads))
    assert all(not g.any() for g in grads)


# ---------------------------------------------------------------------------
# Schedules, timesteps, noise, groups
# ---------------------------------------------------------------------------

def test_compute_decay_matches_jax():
    """``compute_decay`` equals JAX's at every step for every preset (its int
    and name keys), a numeric string, a float and a schedule string, and
    raises ``ValueError`` where JAX's does."""
    from flow_factory_tpu.trainers.crd import _DECAY_PRESETS as J_PRESETS, compute_decay as J
    from flow_factory_tpu_torch.trainers.crd import _DECAY_PRESETS, compute_decay as T

    assert _DECAY_PRESETS == J_PRESETS
    kinds = [*J_PRESETS, "2", "6", 0.3, 1.0, "10-0.1-0.01-0.9", "0-0.9-0-0.9", "75.0-0-0.0075-0.999"]
    for kind in kinds:
        for step in (0, 1, 9, 10, 50, 74, 75, 76, 200, 10_000):
            assert T(step, kind) == J(step, kind), (kind, step)
    for bad in ("bogus", "1-2-3", "1-2-3-4-5", 7, "abc-def"):
        for fn in (J, T):
            with pytest.raises(ValueError):
                fn(0, bad)


def _timestep_trainers(strategy):
    """The JAX and the port DGPO trainers (bare) on the smoke config's
    training args with ``strategy``."""
    import os

    from flow_factory_tpu.hparams.args import Arguments as JArgs
    from flow_factory_tpu.trainers.dgpo import DGPOTrainer as JDGPO
    from flow_factory_tpu_torch.hparams import Arguments
    from flow_factory_tpu_torch.trainers.dgpo import DGPOTrainer

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "smoke_dgpo.yaml")
    out = []
    for cls, args in ((JDGPO, JArgs), (DGPOTrainer, Arguments)):
        tr = object.__new__(cls)
        tr.config = args.load_from_yaml(path)
        tr.training_args = tr.config.training_args
        tr.training_args.time_sampling_strategy = strategy
        tr.training_args.num_train_timesteps = 4
        out.append(tr)
    return out


@pytest.mark.parametrize("strategy", ["logit_normal", "uniform"])
def test_dgpo_shared_and_crd_micro_batch_timesteps_match_jax_bit_for_bit(strategy):
    """DGPO's (T,) shared timesteps of each (epoch, inner) and CRD's (T, B)
    timesteps of a micro-batch seeded by ("crd_t", seed, epoch, inner, its
    first index) equal the JAX package's bit for bit (numpy in both)."""
    from flow_factory_tpu.utils.base import derive_seed as j_derive
    from flow_factory_tpu_torch.utils.base import derive_seed

    jt, pt = _timestep_trainers(strategy)
    for epoch, inner in ((0, 0), (1, 0), (3, 1), (17, 2)):
        ours, theirs = pt.shared_timesteps(epoch, inner), jt._shared_timesteps(epoch, inner)
        assert ours.shape == (4,) and ours.dtype == theirs.dtype and np.array_equal(ours, theirs)
        for start in (0, 8, 16):
            ours = pt.sample_timesteps(8, derive_seed("crd_t", 42, epoch, inner, start))
            theirs = jt.sample_timesteps(8, j_derive("crd_t", 42, epoch, inner, start))
            assert ours.shape == (4, 8) and np.array_equal(ours, theirs)


def test_dgpo_shared_noise_and_group_ids():
    """The shared noise: every stream drawn per unique id from its own
    generator in sorted stream order, so rows of one id are equal and rows
    of two ids differ, the same on a second call; without ``use_shared_noise``
    nothing is shared. Group ids are numbered in first-seen order, as JAX's."""
    from flow_factory_tpu.trainers.dgpo import DGPOTrainer as JDGPO
    from flow_factory_tpu_torch.trainers.dgpo import DGPOTrainer
    from flow_factory_tpu_torch.utils.base import make_generator

    uids = ["c0ffee" * 4, "ab" * 12, "c0ffee" * 4, "ff" * 12, "ab" * 12]
    mb = [types.SimpleNamespace(unique_id=u) for u in uids]
    ids, n = DGPOTrainer.group_ids(mb)
    j_ids, j_n = JDGPO._group_ids(mb)
    assert ids == [0, 1, 0, 2, 1] and n == 3 and np.array_equal(j_ids, ids) and j_n == n

    pt = object.__new__(DGPOTrainer)
    pt.training_args = types.SimpleNamespace(seed=42)
    pt.adapter = types.SimpleNamespace(device=torch.device("cpu"))
    clean = {"latents": torch.zeros(5, 3, 4, 4), "audio_latents": torch.zeros(5, 6)}
    noise = pt.shared_noise(mb, clean, epoch=2, inner=1)
    again = pt.shared_noise(mb, clean, epoch=2, inner=1)
    for k in clean:
        assert noise[k].shape == clean[k].shape and torch.equal(noise[k], again[k])
        assert torch.equal(noise[k][0], noise[k][2]) and torch.equal(noise[k][1], noise[k][4])
        assert not torch.equal(noise[k][0], noise[k][1]) and not torch.equal(noise[k][0], noise[k][3])
    gen = make_generator("cpu", 42, 2, 1, int(uids[1][:16], 16), 2)
    assert torch.equal(noise["audio_latents"][1], torch.randn((6,), generator=gen))
    assert torch.equal(noise["latents"][1], torch.randn((3, 4, 4), generator=gen))
    assert not torch.equal(pt.shared_noise(mb, clean, epoch=3, inner=1)["latents"], noise["latents"])
