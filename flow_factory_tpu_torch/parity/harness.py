"""L1-L4 numerical parity harness of the port (JAX ``parity/harness.py``).

The same four levels over the port's adapter API, probe for probe, so that a
record of the port compares key for key with a golden the JAX package wrote
(``tests/goldens/*.npz``):

* **L1 config** — every component config's fields, diffed exactly.
* **L2 components** — seeded probes through each component: the text
  encoders (``encode_prompt``), the scheduler (sigma grid and one pure
  :func:`sde_step`), the transformer (``training_velocity_tree`` at the
  rollout's first stored latents, batched as the trainers' replay batches
  it), the VAE decode and, where there is one, ``encode_video``.
* **L3 single step** — ``training_forward`` on a stored rollout transition,
  with the rollout's own log-prob beside it.
* **L4 full loop** — a seeded ``inference()``: final latents, the decoded
  media, LTX-2's audio and the per-step log-probs.

The probes draw from ``np.random.default_rng(PROBE_SEED)`` in the JAX
harness's order and take condition media from ``PROBE_COND_SEED``. What the
JAX adapter draws from JAX's PRNG (its seeded random weights, the rollout's
x0 and per-step noise, the noise of the L2 ``sde_step`` probe) the port
cannot draw: :class:`ProbeInputs` carries it across as numpy
(``tools/export_parity_inputs.py`` writes one file a golden). Without
inputs the harness runs the adapter's own weights and draws the noise from
``torch`` generators seeded with ``PROBE_SEED`` on the adapter's device:
the port's own goldens, never compared with JAX's.
"""
from __future__ import annotations

import dataclasses
import inspect
import io
import json
import logging
import os
import zipfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)

PROBE_SEED = 20260817
PROBE_COND_SEED = PROBE_SEED + 1
PROBE_PROMPTS = ["a red cube on a blue table"]

#: default per-level absolute tolerances (fp32), the JAX harness's
DEFAULT_TOLERANCES = {"L1": 0.0, "L2": 1e-4, "L3": 1e-3, "L4": 1e-3}

#: the shape of the L2 ``sde_step`` probe's latents and velocity
SDE_PROBE_SHAPE = (1, 16)


@dataclasses.dataclass
class ParityReport:
    passed: bool
    failures: List[str]
    max_diffs: Dict[str, float]
    missing: List[str]
    extra: List[str]

    def summary(self) -> str:
        lines = [f"parity: {'PASS' if self.passed else 'FAIL'}"]
        for k in sorted(self.max_diffs):
            lines.append(f"  {k}: max|Δ|={self.max_diffs[k]:.3e}")
        for f in self.failures:
            lines.append(f"  FAIL {f}")
        for m in self.missing:
            lines.append(f"  MISSING {m}")
        for e in self.extra:
            lines.append(f"  EXTRA {e}")
        return "\n".join(lines)


def _host(x) -> np.ndarray:
    """A tensor (any device) or array as host fp32 numpy."""
    if torch.is_tensor(x):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _on_device_keep_kind(x, device) -> torch.Tensor:
    """A tensor or array on ``device``: floating values in fp32, integer
    ones as they are (JAX's ``jnp.asarray``)."""
    a = x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
    if a.dtype.kind == "f":
        a = a.astype(np.float32)
    return torch.as_tensor(a).to(device)


def _stats(name: str, arr, record: Dict[str, np.ndarray], full: bool = False) -> None:
    """Store either the full tensor (small) or summary stats + a stride
    sample (large) under ``name`` (JAX ``harness.py:89-101``)."""
    arr = _host(arr)
    if full or arr.size <= 4096:
        record[name] = arr
    else:
        record[f"{name}.shape"] = np.asarray(arr.shape, np.int64)
        record[f"{name}.mean"] = np.float32(arr.mean())
        record[f"{name}.std"] = np.float32(arr.std())
        flat = arr.reshape(-1)
        record[f"{name}.sample"] = flat[:: max(1, flat.size // 1024)][:1024]


def save_npz(path: str, arrays: Dict[str, np.ndarray]) -> None:
    """``np.savez_compressed`` with fixed member timestamps and order, so
    that the same arrays give the same bytes."""
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        for name in sorted(arrays):
            buf = io.BytesIO()
            np.lib.format.write_array(buf, np.asarray(arrays[name]), allow_pickle=False)
            info = zipfile.ZipInfo(f"{name}.npy", date_time=(1980, 1, 1, 0, 0, 0))
            info.compress_type = zipfile.ZIP_DEFLATED
            info.external_attr = 0o644 << 16
            zf.writestr(info, buf.getvalue())


@dataclasses.dataclass
class ProbeInputs:
    """What a JAX tiny adapter drew from JAX's PRNG for the probes, as numpy.

    ``params``: {component: {flax path 'a/b/leaf': array}}, the adapter's
    seeded random init, bridged by :mod:`..utils.weights`; ``x0``: the
    rollout's initial latents for ``seed=PROBE_SEED`` as the JAX adapter
    draws them (unpacked; LTX-2: the video tokens) and ``audio_x0`` LTX-2's
    audio tokens beside them; ``noise``: (T, B, ...) the per-step noise of
    the rollout (packed where the scan's latents are); ``sde_noise``: the
    noise ``jax.random.key(PROBE_SEED)`` gives the L2 ``sde_step`` probe.

    On disk (:meth:`save`), a component named in ``shared`` ({component:
    the stem of another inputs file in the same directory}) is not written:
    that file holds the same tree, bit for bit, and :meth:`load` reads it
    from there. Several goldens share their JAX adapter's weights (FLUX.1
    and Kontext, LTX-2 T2AV and I2AV, ...)."""

    params: Dict[str, Dict[str, np.ndarray]]
    x0: np.ndarray
    noise: np.ndarray
    sde_noise: np.ndarray
    audio_x0: Optional[np.ndarray] = None
    shared: Dict[str, str] = dataclasses.field(default_factory=dict)

    SUFFIX = ".inputs.npz"

    def arrays(self) -> Dict[str, np.ndarray]:
        """The file's members: fp32 arrays, and a string per shared component."""
        out = {f"params/{comp}/{path}": np.asarray(a, np.float32)
               for comp, tree in self.params.items() if comp not in self.shared for path, a in tree.items()}
        out.update(x0=self.x0, noise=self.noise, sde_noise=self.sde_noise)
        if self.audio_x0 is not None:
            out["audio_x0"] = self.audio_x0
        out = {k: np.asarray(v, np.float32) for k, v in out.items()}
        out.update({f"shared/{comp}": np.asarray(stem) for comp, stem in self.shared.items()})
        return out

    def save(self, path: str) -> None:
        save_npz(path, self.arrays())

    @classmethod
    def load(cls, path: str) -> "ProbeInputs":
        with np.load(path, allow_pickle=False) as f:
            data = {k: f[k] for k in f.files}
        params: Dict[str, Dict[str, np.ndarray]] = {}
        shared: Dict[str, str] = {}
        for k in list(data):
            kind, _, rest = k.partition("/")
            if kind == "params":
                comp, leaf = rest.split("/", 1)
                params.setdefault(comp, {})[leaf] = data.pop(k)
            elif kind == "shared":
                shared[rest] = str(data.pop(k))
        folder = os.path.dirname(os.path.abspath(path))
        for comp, stem in shared.items():
            params[comp] = cls.load(os.path.join(folder, stem + cls.SUFFIX)).params[comp]
        return cls(params=params, x0=data["x0"], noise=data["noise"], sde_noise=data["sde_noise"],
                   audio_x0=data.get("audio_x0"), shared=shared)

    def load_weights(self, adapter) -> None:
        """The JAX init into every component of ``adapter``, strictly."""
        from ..utils.weights import convert

        maps = adapter.weight_maps()
        adapter.load_state_dicts({comp: convert(tree, *maps[comp]) for comp, tree in self.params.items()})

    def rollout_kwargs(self, device) -> Dict[str, Any]:
        """``x0=`` and ``noise=`` of the adapter's ``inference``."""
        on = lambda a: torch.from_numpy(np.array(a, np.float32)).to(device)
        x0 = on(self.x0) if self.audio_x0 is None else (on(self.x0), on(self.audio_x0))
        return {"x0": x0, "noise": [on(n) for n in self.noise]}


class ParityHarness:
    """Runs the L1-L4 probes over one adapter of the port. ``inputs`` (a
    :class:`ProbeInputs`) are loaded into the adapter here and replace its
    draws."""

    def __init__(self, adapter, levels: Tuple[int, ...] = (1, 2, 3, 4),
                 inputs: Optional[ProbeInputs] = None):
        self.adapter = adapter
        self.levels = set(levels)
        self.inputs = inputs
        if inputs is not None:
            inputs.load_weights(adapter)

    # ------------------------------------------------------------------
    # L1: config dump
    # ------------------------------------------------------------------
    def config_dump(self) -> Dict[str, Any]:
        """Every component config's scalar and sequence fields; the port's
        configs carry the JAX dataclasses' names and values."""
        out = {}
        for comp, cfg in getattr(self.adapter, "component_configs", {}).items():
            if dataclasses.is_dataclass(cfg):
                d = dataclasses.asdict(cfg)
            elif hasattr(cfg, "__dict__"):
                d = dict(cfg.__dict__)
            else:
                d = {"repr": repr(cfg)}
            out[comp] = {k: v for k, v in sorted(d.items())
                         if isinstance(v, (int, float, str, bool, tuple, list, type(None)))}
        return out

    # ------------------------------------------------------------------
    # Probe condition media (conditioned families)
    # ------------------------------------------------------------------
    def probe_condition_kwargs(self) -> Dict[str, Any]:
        """Condition media for the families whose ``inference`` takes
        ``images`` / ``condition_video`` by name: uniform [0, 1) draws of
        ``PROBE_COND_SEED``, one per prompt, the image before the video."""
        ta = self.adapter.training_args
        params = inspect.signature(self.adapter.inference).parameters
        rng = np.random.default_rng(PROBE_COND_SEED)
        h, w = int(ta.height), int(ta.width)
        kwargs: Dict[str, Any] = {}
        if "images" in params:
            kwargs["images"] = [rng.random((3, h, w)).astype(np.float32) for _ in PROBE_PROMPTS]
        if "condition_video" in params:
            frames = int(getattr(ta, "num_frames", None) or 5)
            kwargs["condition_video"] = [rng.random((frames, 3, h, w)).astype(np.float32)
                                         for _ in PROBE_PROMPTS]
        return kwargs

    def _generator(self) -> torch.Generator:
        """A generator seeded with ``PROBE_SEED`` on the adapter's device."""
        gen = torch.Generator(device=self.adapter.device)
        gen.manual_seed(PROBE_SEED)
        return gen

    def _sde_noise(self) -> torch.Tensor:
        dev = self.adapter.device
        if self.inputs is not None:
            return torch.from_numpy(np.array(self.inputs.sde_noise, np.float32)).to(dev)
        return torch.randn(SDE_PROBE_SHAPE, generator=self._generator(), device=dev, dtype=torch.float32)

    # ------------------------------------------------------------------
    # Probe runner
    # ------------------------------------------------------------------
    @torch.no_grad()
    def record(self) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
        """Run all selected probes; returns (tensor record, json manifest)."""
        from ..samples import stack_samples
        from ..scheduler.flow_match_euler import sde_step

        adapter = self.adapter
        ta = adapter.training_args
        dev = adapter.device
        on = lambda a: torch.as_tensor(_host(a)).to(dev)
        as_is = lambda a: _on_device_keep_kind(a, dev)
        rec: Dict[str, np.ndarray] = {}
        manifest: Dict[str, Any] = {
            "model_type": getattr(adapter.model_args, "model_type", "?"),
            "probe_seed": PROBE_SEED,
            "prompts": PROBE_PROMPTS,
            "levels": sorted(self.levels),
        }
        if 1 in self.levels:
            manifest["config"] = self.config_dump()

        rng = np.random.default_rng(PROBE_SEED)

        # ---- L4 first: the rollout also gives the L2/L3 probes their latents
        samples = None
        if self.levels & {2, 3, 4}:
            adapter.rollout()
            cond_kwargs = self.probe_condition_kwargs()
            manifest["condition_probes"] = sorted(cond_kwargs)
            draws = self.inputs.rollout_kwargs(dev) if self.inputs is not None else {"generator": self._generator()}
            samples = adapter.inference(prompt=list(PROBE_PROMPTS), compute_log_prob=True,
                                        trajectory_indices="all", seed=PROBE_SEED, **draws, **cond_kwargs)
            adapter.train()
        if 4 in self.levels and samples is not None:
            s = samples[0]
            _stats("L4/final_latents", s.all_latents[-1], rec, full=True)
            media = getattr(s, "image", None)
            if media is None:
                media = getattr(s, "video", None)
            if media is not None:
                _stats("L4/decoded", media, rec)
            if getattr(s, "audio", None) is not None:
                _stats("L4/audio", s.audio, rec)
            if s.log_probs is not None:
                _stats("L4/log_probs", s.log_probs, rec, full=True)

        # ---- L2: per-component forwards --------------------------------
        if 2 in self.levels:
            # (a) text encoders
            embeds = adapter.encode_prompt(list(PROBE_PROMPTS))
            for k, v in sorted(embeds.items()):
                if v is not None:
                    _stats(f"L2/encode_prompt/{k}", v, rec)

            # (b) scheduler: sigma grid + one pure SDE step on fixed vectors
            sched = adapter.scheduler
            sched.set_timesteps(ta.num_inference_steps, seq_len=256)
            rec["L2/scheduler/sigmas"] = np.asarray(sched.sigmas, np.float32)
            rec["L2/scheduler/timesteps"] = np.asarray(sched.timesteps, np.float32)
            lat = rng.standard_normal(SDE_PROBE_SHAPE, dtype=np.float32)
            vel = rng.standard_normal(SDE_PROBE_SHAPE, dtype=np.float32)
            sig = lambda i: torch.tensor(float(sched.sigmas[i]), dtype=torch.float32, device=dev)
            out = sde_step(on(vel), on(lat), sig(1), sig(2), dynamics_type=sched.dynamics_type,
                           noise_level=float(sched.noise_level), noise=self._sde_noise(),
                           compute_log_prob=True, sigma_max=sig(1))
            rec["L2/scheduler/sde_next_latents"] = _host(out.next_latents)
            rec["L2/scheduler/sde_log_prob"] = _host(out.log_prob)

            # (c) transformer: the velocity at the rollout's first stored
            # latents, batched as the trainers' replay batches a sample
            if samples is not None:
                s = samples[0]
                sb = stack_samples([s])
                batch = {"timestep": on([float(sched.timesteps[0])]), "guidance_scale": 1.0}
                for ek in adapter.embed_keys:
                    v = sb.get(ek)
                    if v is None:
                        v = embeds.get(ek)
                    if v is not None:
                        batch[ek] = as_is(v)
                lat_tree = {"latents": on(s.all_latents[:1])}
                for bk, sk in adapter.trajectory_batch_keys.items():
                    extra = s.extra_kwargs.get(sk)
                    if extra is not None:
                        lat_tree[bk] = on(extra[:1])
                vel_tree = adapter.training_velocity_tree(adapter.trainable, {**batch, **lat_tree})
                for k in sorted(vel_tree):
                    _stats(f"L2/transformer/velocity_{k}", vel_tree[k], rec)

            # (d) VAE decode of the L4 final latent
            if samples is not None and hasattr(adapter, "decode_latents"):
                try:
                    dec = adapter.decode_latents(on(samples[0].all_latents[-1:]))
                    _stats("L2/vae/decode", dec, rec)
                except Exception as e:  # geometry-specific decoders take more arguments
                    manifest.setdefault("skipped", []).append(f"L2/vae/decode: {e}")

            # (e) VAE encode where the adapter has one
            if hasattr(adapter, "encode_video"):
                try:
                    vid = rng.random((1, 5, 3, ta.resolution, ta.resolution)).astype(np.float32)
                    z = adapter.encode_video(vid)
                    if z is not None:
                        _stats("L2/vae/encode_video", z, rec)
                except Exception as e:
                    manifest.setdefault("skipped", []).append(f"L2/vae/encode_video: {e}")

        # ---- L3: seed-matched single training step ---------------------
        if 3 in self.levels and samples is not None:
            s = samples[0]
            sched = adapter.scheduler
            b = stack_samples([s])
            li_map, lp_map = s.latent_index_map, s.log_prob_index_map
            t_idx = int(np.asarray(sched.train_timesteps)[0])
            li, lni, lpi = int(li_map[t_idx]), int(li_map[t_idx + 1]), int(lp_map[t_idx])
            sigmas, timesteps = np.asarray(sched.sigmas), np.asarray(sched.timesteps)
            batch = {
                "latents": on(b["all_latents"][:, li]),
                "next_latents": on(b["all_latents"][:, lni]),
                "timestep": on([float(timesteps[t_idx])]),
                "sigma": on([float(sigmas[t_idx])]),
                "sigma_next": on([float(sigmas[t_idx + 1])]),
                "noise_level": on([float(np.asarray(sched.get_noise_levels())[t_idx])]),
                "guidance_scale": 1.0,
                "sigma_max": on([float(sigmas[1])]),
            }
            for ek in adapter.embed_keys:
                if b.get(ek) is not None:
                    batch[ek] = on(b[ek])
            for bk, sk in adapter.trajectory_batch_keys.items():
                if b.get(sk) is not None:
                    batch[bk] = on(np.asarray(b[sk], np.float32)[:, li])
            out = adapter.training_forward(adapter.trainable, batch, compute_log_prob=True)
            rec["L3/log_prob"] = _host(out.log_prob)
            _stats("L3/next_latents_mean", out.next_latents_mean, rec)
            if lpi >= 0 and s.log_probs is not None:
                # replay invariance: the training log-prob is the rollout's
                rec["L3/rollout_log_prob"] = np.asarray(s.log_probs[lpi: lpi + 1], np.float32)

        return rec, manifest

    # ------------------------------------------------------------------
    def save(self, path: str) -> None:
        rec, manifest = self.record()
        np.savez_compressed(path, **rec)
        with open(str(path) + ".json", "w") as f:
            json.dump(manifest, f, indent=1, default=str)
        logger.info("Recorded %d parity tensors to %s", len(rec), path)

    def check(self, golden_path: str, tolerances: Optional[Dict[str, float]] = None) -> ParityReport:
        rec, manifest = self.record()
        golden = dict(np.load(golden_path, allow_pickle=False))
        tol = dict(DEFAULT_TOLERANCES)
        tol.update(tolerances or {})
        report = compare_records(golden, rec, tol)
        # L1: the config diff against the golden's manifest
        if 1 in self.levels:
            try:
                with open(str(golden_path) + ".json") as f:
                    gm = json.load(f)
                diffs = _diff_config(gm.get("config", {}), manifest.get("config", {}))
                if diffs:
                    report.failures.extend(f"L1 config: {d}" for d in diffs)
                    report.passed = False
            except FileNotFoundError:
                report.missing.append("golden manifest (.json)")
                report.passed = False
        return report


def _diff_config(a: Dict[str, Any], b: Dict[str, Any]) -> List[str]:
    """Field-by-field differences of two config dumps (golden ``a``,
    current ``b``); a field only the current dump has is schema growth and
    no difference."""
    diffs = []
    norm = lambda v: list(v) if isinstance(v, (tuple, list)) else v  # json gives tuples back as lists
    for comp in sorted(set(a) | set(b)):
        ca, cb = a.get(comp), b.get(comp)
        if ca is None or cb is None:
            diffs.append(f"{comp}: present only in {'golden' if cb is None else 'current'}")
            continue
        for k in sorted(ca):
            va, vb = ca.get(k), cb.get(k)
            if norm(va) != norm(vb):
                diffs.append(f"{comp}.{k}: {va!r} != {vb!r}")
    return diffs


def compare_records(golden: Dict[str, np.ndarray], current: Dict[str, np.ndarray],
                    tolerances: Dict[str, float]) -> ParityReport:
    """Max |Δ| of every key both records hold, against its level's
    tolerance; a key the golden holds and the current record lacks fails."""
    failures, max_diffs = [], {}
    missing = sorted(set(golden) - set(current))
    extra = sorted(set(current) - set(golden))
    for k in sorted(set(golden) & set(current)):
        g, c = np.asarray(golden[k]), np.asarray(current[k])
        level = k.split("/", 1)[0]
        t = tolerances.get(level, 1e-4)
        if g.shape != c.shape:
            failures.append(f"{k}: shape {g.shape} != {c.shape}")
            continue
        d = float(np.max(np.abs(g.astype(np.float64) - c.astype(np.float64)))) if g.size else 0.0
        max_diffs[k] = d
        if not d <= t:
            failures.append(f"{k}: max|Δ|={d:.3e} > tol {t:.1e}")
    passed = not failures and not missing
    return ParityReport(passed=passed, failures=failures, max_diffs=max_diffs, missing=missing, extra=extra)
