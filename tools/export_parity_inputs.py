"""Write the probe inputs of the port's parity harness for the JAX goldens.

    JAX_PLATFORMS=cpu python tools/export_parity_inputs.py [GOLDEN ...] [--out DIR]

For each golden ``tests/goldens/<GOLDEN>.npz`` (default: all of them) this
builds the JAX package's tiny adapter of the golden's model type with the
``scripts/parity_check.py`` config, and writes
``<DIR>/<GOLDEN>.inputs.npz`` (default DIR: ``tests/goldens_torch``): what
that adapter draws from JAX's PRNG for the probes and the port cannot draw
itself, as fp32 numpy (``flow_factory_tpu_torch.parity.ProbeInputs``):

* ``params/<component>/<flax path>``: the adapter's seeded random init;
* ``x0`` (and LTX-2's ``audio_x0``): the rollout's initial latents for
  ``seed=PROBE_SEED``, keys split from ``derive_key("rollout", seed)`` one a
  row, drawn as the family's adapter draws them (``sd3/adapter.py:413-419``,
  ``flux/adapter.py:359-365``, ``wan/t2v.py:397-403``,
  ``ltx2/t2av.py:674-682``);
* ``noise``: (T, B, ...) the scan's per-step noise, a split a step from
  ``fold_in(keys[0], 7)`` (``models/abc.py:976``), at the scan's latent
  shape (packed for the FLUX-class families);
* ``sde_noise``: the L2 ``sde_step`` probe's noise, ``jax.random.key(PROBE_SEED)``
  (``parity/harness.py:225``).

A component whose tree an earlier golden of the same run (in name order)
holds bit for bit is written as ``shared/<component>``, the name of that
golden, and read from its file. The files are written with fixed member
timestamps, so a rerun on an unchanged JAX package gives the same bytes. This tool imports JAX and both
packages; the port itself never imports JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

GOLDENS = os.path.join(ROOT, "tests", "goldens")
OUT = os.path.join(ROOT, "tests", "goldens_torch")
#: limits of one family's file and of all of them, bytes
MAX_FILE_BYTES = 1_500_000
MAX_TOTAL_BYTES = 12_000_000


def golden_names():
    return sorted(f[:-len(".npz")] for f in os.listdir(GOLDENS) if f.endswith(".npz"))


def model_type_of(golden: str) -> str:
    with open(os.path.join(GOLDENS, f"{golden}.npz.json")) as f:
        return json.load(f)["model_type"]


def jax_adapter(model_type: str):
    """The JAX tiny adapter the golden was recorded from."""
    from parity_check import make_config

    from flow_factory_tpu.models import load_adapter
    from flow_factory_tpu.parallel.dist import set_world_size_override

    set_world_size_override(1)
    try:
        return load_adapter(make_config(model_type, "tiny"))
    finally:
        set_world_size_override(None)


def rollout_draws(ja, seed: int, batch: int):
    """(x0, audio x0 or None, per-step noise (T, B, ...)) as the JAX
    adapter ``ja`` draws them for ``inference(seed=seed)`` at its training
    geometry."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from flow_factory_tpu.models.flux.adapter import Flux1Adapter
    from flow_factory_tpu.models.ltx2.t2av import LTX2T2AVAdapter
    from flow_factory_tpu.models.sd3.adapter import SD35Adapter
    from flow_factory_tpu.models.wan.t2v import WanT2VAdapter
    from flow_factory_tpu.utils.base import derive_key

    ta = ja.training_args
    H, W, T = int(ta.height), int(ta.width), int(ta.num_inference_steps)
    frames = int(getattr(ta, "num_frames", 5))
    keys = jax.random.split(derive_key("rollout", seed), batch)
    normal = lambda shape: np.asarray(jax.vmap(lambda k: jax.random.normal(k, shape, jnp.float32))(keys))
    audio = None
    if isinstance(ja, LTX2T2AVAdapter):
        tl, h, w = ja.video_token_geometry(H, W, frames)
        shape = (tl * h * w, ja.video_latent_channels)
        La = ja.audio_token_count(frames)
        audio = np.asarray(jax.vmap(lambda k: jax.random.normal(
            jax.random.fold_in(k, 1), (La, ja.audio_latent_channels), jnp.float32))(keys))
        step_shape = shape
    elif isinstance(ja, WanT2VAdapter):
        shape = step_shape = tuple(ja.latent_shape(H, W, frames))
    elif isinstance(ja, Flux1Adapter):
        shape = tuple(ja.latent_shape(H, W))
        step_shape = tuple(ja.pack_latents(jnp.zeros((1, *shape), jnp.float32)).shape[1:])
    elif isinstance(ja, SD35Adapter):
        shape = step_shape = tuple(ja.latent_shape(H, W))
    else:
        raise TypeError(f"no rollout draw rule for {type(ja).__name__}")
    x0 = normal(shape)
    k, noise = jax.random.fold_in(keys[0], 7), []
    for _ in range(T):
        k, sub = jax.random.split(k)
        noise.append(np.asarray(jax.random.normal(sub, (batch, *step_shape), jnp.float32)))
    return x0, audio, np.stack(noise)


def probe_inputs(golden: str):
    """The :class:`ProbeInputs` of one golden, computed now from the JAX
    package."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from flow_factory_tpu.parity.harness import PROBE_PROMPTS, PROBE_SEED
    from flow_factory_tpu_torch.parity import ProbeInputs
    from flow_factory_tpu_torch.parity.harness import SDE_PROBE_SHAPE
    from flow_factory_tpu_torch.utils.weights import flatten_flax

    ja = jax_adapter(model_type_of(golden))
    params = {comp: flatten_flax(jax.tree.map(np.asarray, jax.device_get(tree)))
              for comp, tree in ja.params.items()}
    x0, audio, noise = rollout_draws(ja, PROBE_SEED, len(PROBE_PROMPTS))
    sde_noise = np.asarray(jax.random.normal(jax.random.key(PROBE_SEED), SDE_PROBE_SHAPE, jnp.float32))
    return ProbeInputs(params=params, x0=x0, noise=noise, sde_noise=sde_noise, audio_x0=audio)


def tree_digest(tree) -> str:
    """sha256 of a flat tree's paths, dtypes, shapes and bytes."""
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    for path in sorted(tree):
        a = np.ascontiguousarray(tree[path])
        h.update(f"{path}|{a.dtype.str}|{a.shape}|".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("goldens", nargs="*", help="golden names (default: every tests/goldens/*.npz)")
    ap.add_argument("--out", default=OUT, help="output directory")
    args = ap.parse_args(argv)
    import jax

    jax.config.update("jax_platforms", "cpu")
    os.makedirs(args.out, exist_ok=True)
    total, over, seen = 0, [], {}
    for golden in args.goldens or golden_names():
        path = os.path.join(args.out, f"{golden}.inputs.npz")
        inputs = probe_inputs(golden)
        for comp, tree in sorted(inputs.params.items()):
            owner = seen.setdefault((comp, tree_digest(tree)), golden)
            if owner != golden:
                inputs.shared[comp] = owner
        inputs.save(path)
        size = os.path.getsize(path)
        total += size
        print(f"{path}: {size} bytes", flush=True)
        if size > MAX_FILE_BYTES:
            over.append(f"{path} is {size} bytes, above {MAX_FILE_BYTES}")
    if total > MAX_TOTAL_BYTES:
        over.append(f"{total} bytes in all, above {MAX_TOTAL_BYTES}")
    print(f"{total} bytes in all")
    for line in over:
        print(line, file=sys.stderr)
    return 1 if over else 0


if __name__ == "__main__":
    raise SystemExit(main())
