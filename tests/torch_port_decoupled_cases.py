"""The five decoupled trainers (DiffusionNFT, AWM, DPO, DGPO, CRD) of the
PyTorch port held to the JAX trainers' own ``_grad_fn`` on one tiny family
pair: the same frozen weights and LoRA in both packages (through the weight
bridge), the same numpy micro-batch (clean latent tree, noise tree, embeds,
advantages, timesteps) and the same old-policy quantities, which are JAX's,
fed to both. Imported by the tests/test_torch_port_decoupled_*.py files.

A :class:`Pair` holds a JAX adapter, the port's twin, each trained
component's module map and a batch of ``B`` rows in two prompt groups (rows
0 and 2, rows 1 and 3; a group's rows share their noise, as DGPO draws it).
:func:`run_case` builds one trainer's batch at the given per-row timesteps,
runs both packages and returns both results; :func:`assert_case_matches`
holds them to the bars of tests/test_torch_port_nft_awm.py,
test_torch_port_dgpo_crd.py and test_torch_port_dpo.py: the loss and every
aux metric 1e-5 relative (1e-7 absolute), DPO's loss and implicit margin
within β/2 x 4 fp32 ulps of the larger error, every LoRA gradient leaf
within 1e-4 of that leaf's largest magnitude in JAX (so a leaf JAX gives
zeros must be exactly zero)."""
import copy
import importlib
import types
from dataclasses import dataclass, field
from typing import Any, Dict

import jax
import jax.numpy as jnp
import numpy as np
import torch

TRAINERS = ("nft", "awm", "dpo", "dgpo", "crd")
B = 4
#: per-row advantages: group 0 (rows 0, 2) positive, group 1 (rows 1, 3) negative
ADVANTAGE = np.asarray([1.2, -0.4, 0.9, -0.3], np.float32)
GROUPS = [0, 1, 0, 1]
#: the std of the LoRA ``b`` a trainer's case runs at (DGPO's: the pair's
#: ``dgpo_b``)
LORA_B = {"nft": 0.1, "awm": 0.1, "dpo": 0.1, "crd": 0.1}
#: DGPO's ``ema_ref``: the LoRA with ``b`` x this
EMA_REF = 0.2
#: DGPO's preference is a difference of two errors (θ against ``ema_ref``)
#: and its loss a sum over rows of both advantage signs: each pair's
#: ``dgpo_b`` is chosen so that both stand at least this far from 0, where
#: fp32 rounding (some 1e-6 absolute) is far below the 1e-5 relative bar
DGPO_FLOOR = 0.05
#: each trainer's options: NFT and AWM with the v-space KL to the reference,
#: DPO at β 10, DGPO against ``ema_ref`` with the KL's teacher under CFG 3,
#: CRD's BCE loss under the softmax weights with the reward-adaptive KL (its
#: teacher under CFG 3); where the batch has no negative embeds the teachers
#: run without CFG in both packages
OPTIONS = {
    "nft": dict(nft_beta=0.7, adv_clip_range=(-1.5, 1.5), kl_beta=0.5),
    "awm": dict(clip_range=(-0.01, 0.01), adv_clip_range=(-1.5, 1.5), kl_beta=0.5, ema_kl_beta=0.0,
                awm_weighting="t", ghuber_power=1.0),
    "dpo": dict(beta=10.0),
    "dgpo": dict(dpo_beta=5.0, group_size=2, clip_range=(-0.01, 0.01), clip_dsm=False, clip_kl=False,
                 use_ema_ref=True, kl_beta=0.5, kl_cfg=3.0),
    "crd": dict(crd_beta=1.5, adv_clip_range=(-1.5, 1.5), crd_loss_type="bce", weight_temp=0.5,
                adaptive_logp=False, kl_beta=0.5, kl_cfg=3.0, reward_adaptive_kl=True),
}
#: AWM's old log-probs sit this far below the current ones: ratios e^0.005,
#: e^-0.02, e^0.03, e^-0.004 against advantages +, -, +, -: the clip (±0.01)
#: binds on rows 1 and 2 only, each row well clear of its edge
AWM_SHIFT = np.asarray([0.005, -0.02, 0.03, -0.004], np.float32)


def host(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


@dataclass
class Pair:
    ja: Any
    pa: Any
    lora: Dict[str, Dict]  # {component: flax LoRA with b of std 1}
    maps: Dict[str, Any]  # {component: the bridge's module map}
    batch: Dict[str, Any]  # numpy: clean and noise trees, rejected (DPO's), embeds
    guidance: float
    dgpo_b: float = 0.6
    extra: Dict[str, Any] = field(default_factory=dict)


def unit_lora(ja, rng) -> Dict[str, Dict]:
    """The JAX adapter's LoRA of every trained component with ``b`` of std 1
    (:func:`set_lora` scales it)."""
    return {comp: {p: {"a": ab["a"], "b": rng.standard_normal(ab["b"].shape).astype(np.float32)}
                   for p, ab in host(tree).items()}
            for comp, tree in ja.trainable.items()}


def scaled(lora, s: float):
    return {comp: {p: {"a": ab["a"], "b": (s * ab["b"]).astype(np.float32)} for p, ab in tree.items()}
            for comp, tree in lora.items()}


def jax_lora(lora):
    return {comp: jax.tree.map(jnp.asarray, tree) for comp, tree in lora.items()}


def port_lora(pair: Pair, lora):
    from flow_factory_tpu_torch.utils import weights

    return {comp: weights.lora_from_flax(tree, pair.maps[comp]) for comp, tree in lora.items()}


def set_lora(pair: Pair, s: float) -> Dict:
    """Both packages' live LoRA: the unit LoRA's ``b`` x ``s``; returns it."""
    lora = scaled(pair.lora, s)
    pair.ja.trainable = jax_lora(lora)
    for comp, tree in port_lora(pair, lora).items():
        pair.pa.load_lora(comp, tree)
    return lora


def random_batch(shapes: Dict[str, tuple], embeds: Dict[str, np.ndarray], seed: int) -> Dict[str, Any]:
    """Clean and rejected latent trees of ``B`` rows and a noise tree shared
    by the rows of a group, each stream of ``shapes`` (its per-row shape)."""
    rng = np.random.default_rng(seed)
    draw = lambda: {k: rng.standard_normal((B, *s)).astype(np.float32) for k, s in shapes.items()}
    group_noise = {k: rng.standard_normal((2, *s)).astype(np.float32)[GROUPS] for k, s in shapes.items()}
    return dict(clean=draw(), rejected=draw(), noise=group_noise, advantage=ADVANTAGE, **embeds)


def rollout_batch(pa, seed: int, **inference) -> Dict[str, Any]:
    """:func:`random_batch` on the embeds of a port rollout of
    ``inference``'s rows (their ``embed_keys``, stacked as the trainers
    stack them) at the streams' shapes."""
    from flow_factory_tpu_torch.samples import stack_samples

    pa.rollout()
    try:
        samples = pa.inference(compute_log_prob=False, trajectory_indices=[-1], **inference)
    finally:
        pa.train()
    bn = stack_samples(samples)
    embeds = {k: np.asarray(bn[k], np.float32) for k in pa.embed_keys if bn.get(k) is not None}
    shapes = {bk: bn[sk].shape[2:] for bk, sk in pa.decoupled_latent_keys.items()}
    return random_batch(shapes, embeds, seed)


def _lib(batch, fn):
    out = {}
    for k, v in batch.items():
        if isinstance(v, dict):
            out[k] = {kk: fn(np.array(vv)) for kk, vv in v.items()}
        elif isinstance(v, np.ndarray):
            out[k] = fn(np.array(v))
        else:
            out[k] = v
    return out


def port_grads(pair: Pair, grads) -> Dict[str, Dict]:
    """The port's flat gradient list as {component: flax LoRA grads}."""
    from flow_factory_tpu_torch.utils import weights

    it, out = iter(grads), {}
    pa = pair.pa
    for comp in sorted(pa.trainable):
        tree = {p: {k: next(it) for k in sorted(ab)} for p, ab in sorted(pa.trainable[comp].items())}
        out[comp] = weights.lora_to_flax(tree, pair.maps[comp])
    return out


def _jax_trainer(kind: str, pair: Pair, ta):
    """The pair's JAX trainer of ``kind``, made once (kept in
    ``pair.extra``): its jitted ``_grad_fn`` traces once for every case at
    the same shapes."""
    cache = pair.extra.setdefault("jax_trainers", {})
    if kind not in cache:
        cls = getattr(importlib.import_module(f"flow_factory_tpu.trainers.{kind}"), f"{kind.upper()}Trainer")
        jt = object.__new__(cls)
        jt.training_args, jt.adapter = ta, pair.ja
        if kind == "dgpo":
            jt.dpo_beta = ta.dpo_beta
        cache[kind] = jt
    return cache[kind]


def run_case(kind: str, pair: Pair, t, s: float = None):
    """One micro-batch of ``kind`` at the per-row timesteps ``t`` (DGPO: row
    0's for every row) through the JAX trainer's ``_grad_fn`` and the port's
    ``loss_and_grads``, the LoRA ``b`` at std ``s`` (default
    :data:`LORA_B`). The port's batch carries ``timestep_host``, row 0's t,
    as the port's trainers give it. Returns (JAX (loss, aux, grads), port
    (loss, aux, grads), the trainer's options)."""
    from flow_factory_tpu.trainers.awm import weighted_log_prob as jwlp
    from flow_factory_tpu.trainers.decoupled import DecoupledTrainer as JD

    ja, pa = pair.ja, pair.pa
    lora = set_lora(pair, (pair.dgpo_b if kind == "dgpo" else LORA_B[kind]) if s is None else s)
    t = np.asarray(t, np.float32)
    if kind == "dgpo":
        t = np.full((B,), t[0], np.float32)
    ta = types.SimpleNamespace(**OPTIONS[kind])
    batch = {k: v for k, v in pair.batch.items() if k != "rejected"}
    batch = dict(batch, timestep=t)
    if kind == "dpo":
        batch = {k: v for k, v in batch.items() if k not in ("clean", "advantage")}
        batch.update(chosen=pair.batch["clean"], rejected=pair.batch["rejected"])
    jb = {**_lib(batch, jnp.asarray), "guidance_scale": jnp.float32(pair.guidance)}
    frozen = ja.frozen_velocity_params()
    if kind in ("nft", "awm", "crd"):
        fwd = {**jb, **JD.tree_noised(jb["clean"], jb["noise"], jb["timestep"])}
        if kind == "crd":
            fwd = {k: v for k, v in fwd.items() if not k.startswith("negative_")}
        if kind == "awm":
            v = JD.tree_flat(ja.training_velocity_tree(ja.trainable, fwd, frozen=frozen))
            target = JD.tree_flat(jb["noise"]) - JD.tree_flat(jb["clean"])
            lp = np.asarray(jwlp(v, target, jb["timestep"], ta.awm_weighting, ta.ghuber_power))
            batch["old_log_prob"] = (lp - AWM_SHIFT).astype(np.float32)
        else:
            old = jax_lora(scaled(lora, 0.8 if kind == "nft" else 0.2))
            batch["old_v"] = host(ja.training_velocity_tree(old, fwd, frozen=frozen))
        jb = {**_lib(batch, jnp.asarray), "guidance_scale": jnp.float32(pair.guidance)}
    tb = {**_lib(batch, torch.from_numpy), "guidance_scale": float(pair.guidance), "timestep_host": float(t[0])}

    jt = _jax_trainer(kind, pair, ta)
    pt = object.__new__(getattr(importlib.import_module(f"flow_factory_tpu_torch.trainers.{kind}"),
                                f"{kind.upper()}Trainer"))
    pt.training_args, pt.adapter = ta, pa
    ref = ja.ref_trainable()
    if kind == "dgpo":
        from flow_factory_tpu_torch.trainers.dgpo import DGPOTrainer

        pt.requires_ema_ref = True
        ema_ref = scaled(lora, EMA_REF)
        jb["group_ids"] = jnp.asarray(GROUPS, jnp.int32)
        (j_loss, j_aux), j_grads = jt._grad_fn(ja.trainable, frozen, jb, ref, jax_lora(ema_ref), 2)
        ids, num_groups = DGPOTrainer.group_ids([types.SimpleNamespace(unique_id=u) for u in "abab"])
        assert (ids, num_groups) == (GROUPS, 2)
        tb.update(group_ids=torch.tensor(ids), num_groups=num_groups)
        with torch.no_grad():
            old_params = pa.merged_params(pa.velocity_component, port_lora(pair, ema_ref))
        (loss, aux), grads = pt.loss_and_grads(pt.with_frozen_velocities(tb, old_params))
    else:
        args = (ja.trainable, frozen, jb, ref) + ((None,) if kind == "awm" else ())
        (j_loss, j_aux), j_grads = jt._grad_fn(*args)
        (loss, aux), grads = pt.loss_and_grads(tb, pt.reference_trainable())
    return ((float(j_loss), {k: float(v) for k, v in j_aux.items()}, host(j_grads)),
            (float(loss), {k: float(v) for k, v in aux.items()}, port_grads(pair, grads)), ta)


def assert_case_matches(kind: str, pair: Pair, t, what: str, s: float = None):
    """:func:`run_case`, held to the module's bars; returns the port's
    (loss, aux, grads)."""
    (j_loss, j_aux, j_grads), (loss, aux, grads), ta = run_case(kind, pair, t, s)
    assert sorted(aux) == sorted(j_aux), what
    bars = {}
    if kind == "dpo":
        err = max(j_aux["train/theta_w_err"], j_aux["train/theta_l_err"])
        bars["train/loss"] = bars["train/implicit_margin"] = 0.5 * ta.beta * 4 * float(np.spacing(np.float32(err)))
    np.testing.assert_allclose(loss, j_loss, rtol=0 if bars else 1e-5, atol=bars.get("train/loss", 1e-7),
                               err_msg=what)
    for k in j_aux:
        np.testing.assert_allclose(aux[k], j_aux[k], rtol=0 if k in bars else 1e-5, atol=bars.get(k, 1e-7),
                                   err_msg=f"{what} {k}")
    assert sorted(grads) == sorted(j_grads), what
    for comp in j_grads:
        assert sorted(grads[comp]) == sorted(j_grads[comp]), (what, comp)
        for p, ab in j_grads[comp].items():
            for k, ref in ab.items():
                err = np.abs(grads[comp][p][k] - ref).max()
                assert err <= 1e-4 * np.abs(ref).max(), f"{what} {comp} {p}/{k}: {err} vs max {np.abs(ref).max()}"
    if kind == "awm":
        assert aux["train/clip_frac"] == 0.5, (what, aux)
    if kind == "nft":
        assert aux["train/positive_loss"] != aux["train/negative_loss"], what
    if kind == "dgpo":
        assert min(abs(j_aux["train/pref_mean"]), abs(j_aux["train/loss"])) >= DGPO_FLOOR, (what, j_aux)
    if "train/kl" in j_aux:
        assert j_aux["train/kl"] > 0, what
    return loss, aux, grads


def live(grads) -> Dict[str, float]:
    """{component: its largest |gradient| over every LoRA leaf}."""
    return {comp: max(float(np.abs(v).max()) for ab in tree.values() for v in ab.values())
            for comp, tree in grads.items()}


def port_loss(kind: str, pair: Pair, t, batch_override: Dict[str, Any]) -> float:
    """The port's loss alone at ``kind``'s case with ``batch_override``
    replacing batch entries (the old-policy quantities taken from the port
    itself), without gradients."""
    from flow_factory_tpu_torch.trainers.decoupled import uncfg

    pa = pair.pa
    lora = set_lora(pair, pair.dgpo_b if kind == "dgpo" else LORA_B[kind])
    t = np.asarray(t, np.float32)
    if kind == "dgpo":
        t = np.full((B,), t[0], np.float32)
    ta = types.SimpleNamespace(**OPTIONS[kind])
    base = copy.copy(pair.batch)
    base.update(batch_override)
    batch = {k: v for k, v in base.items() if k != "rejected"}
    if kind == "dpo":
        batch = {k: v for k, v in batch.items() if k not in ("clean", "advantage")}
        batch.update(chosen=base["clean"], rejected=base["rejected"])
    tb = {**_lib(dict(batch, timestep=t), torch.from_numpy), "guidance_scale": float(pair.guidance),
          "timestep_host": float(t[0])}
    pt = object.__new__(getattr(importlib.import_module(f"flow_factory_tpu_torch.trainers.{kind}"),
                                f"{kind.upper()}Trainer"))
    pt.training_args, pt.adapter = ta, pa
    with torch.no_grad():
        if kind in ("nft", "crd"):
            fwd = pt.noised_batch(tb)
            params = pa.merged_params(pa.velocity_component, port_lora(pair, scaled(lora, 0.8 if kind == "nft"
                                                                                   else 0.2)))
            tb["old_v"] = pa.training_velocity_tree(None, fwd if kind == "nft" else uncfg(fwd), params=params)
        if kind == "awm":
            from flow_factory_tpu_torch.trainers.awm import weighted_log_prob

            fwd = pt.noised_batch(tb)
            v = pt.tree_flat(pa.training_velocity_tree(pa.trainable, fwd))
            target = pt.tree_flat(tb["noise"]) - pt.tree_flat(tb["clean"])
            tb["old_log_prob"] = weighted_log_prob(v, target, tb["timestep"], ta.awm_weighting, ta.ghuber_power) \
                - torch.from_numpy(AWM_SHIFT)
        if kind == "dgpo":
            pt.requires_ema_ref = True
            tb.update(group_ids=torch.tensor(GROUPS), num_groups=2)
            old = pa.merged_params(pa.velocity_component, port_lora(pair, scaled(lora, EMA_REF)))
            tb = pt.with_frozen_velocities(tb, old)
        loss, _ = pt.loss_fn(pa.trainable, tb, pt.reference_trainable())
    return float(loss)
