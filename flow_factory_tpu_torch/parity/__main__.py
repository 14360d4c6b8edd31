"""L1-L4 parity harness of the port, on the command line (the JAX
package's ``scripts/parity_check.py``).

    # the port against a JAX golden, from the JAX adapter's draws
    python -m flow_factory_tpu_torch.parity --model-type sd3-5 --path tiny \\
        --device cpu --inputs tests/goldens_torch/sd35.inputs.npz \\
        --check tests/goldens/sd35.npz

    # the port's own goldens: record once, check on every change
    python -m flow_factory_tpu_torch.parity --model-type sd3-5 --path tiny \\
        --record OUT.npz
    python -m flow_factory_tpu_torch.parity --model-type sd3-5 --path tiny \\
        --check OUT.npz

    # two records, no model
    python -m flow_factory_tpu_torch.parity --compare A.npz B.npz

``--path`` is ``tiny`` (seeded random init) or a local diffusers checkpoint
directory, imported strictly unless ``--lax-import``. ``--inputs`` (written
by ``tools/export_parity_inputs.py``) replaces the adapter's weights and
its rollout and probe noise by the JAX tiny adapter's. The adapter runs on
``--device`` (default ``cuda``; without a card that raises: pass ``cpu``).
Levels: 1=config, 2=component forwards, 3=seed-matched single step, 4=full
loop. Exit code 0 = pass.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Optional

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_config(model_type: str, path: str, resolution: int = 32, steps: int = 4,
                strict_import: bool = False, attn_backend: str = "native", dtype: str = "float32",
                variant: Optional[str] = None):
    """The parity config of ``scripts/parity_check.py:31-54`` on the port's
    schema. ``attn_backend``, the frozen components' ``dtype`` and the preset
    ``variant`` (default: the one ``path`` implies) are the parity run's
    unless given."""
    from ..hparams import Arguments

    model = {"model_type": model_type, "model_name_or_path": path,
             "finetune_type": "lora", "lora_rank": 2, "lora_alpha": 4,
             "attn_backend": attn_backend, "master_dtype": "float32",
             "inference_dtype": dtype,
             "strict_import": strict_import}
    if variant is not None:
        model["variant"] = variant
    return Arguments.from_dict({
        "data": {"dataset_dir": os.path.join(ROOT, "tests", "fixtures", "tiny_prompts")},
        "model": model,
        "scheduler": {"dynamics_type": "Flow-SDE", "noise_level": 0.7,
                      "num_sde_steps": steps - 1,
                      "sde_steps": list(range(steps - 1))},
        "train": {"trainer_type": "grpo", "resolution": resolution,
                  "num_inference_steps": steps, "guidance_scale": 1.0,
                  "per_device_batch_size": 1, "group_size": 1,
                  "unique_sample_num_per_epoch": 1,
                  "latent_storage_dtype": "fp32", "seed": 0},
        "log": {"run_name": "parity"},
        "rewards": [],
    })


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model-type", help="adapter registry key (e.g. sd3-5)")
    ap.add_argument("--path", default="tiny",
                    help="'tiny' (seeded random init) or a diffusers checkpoint dir")
    ap.add_argument("--levels", default="1,2,3,4")
    ap.add_argument("--resolution", type=int, default=32)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--record", metavar="OUT.npz", help="record goldens")
    ap.add_argument("--check", metavar="GOLDEN.npz", help="check against goldens")
    ap.add_argument("--compare", nargs=2, metavar=("A.npz", "B.npz"),
                    help="compare two recorded npz files (no model build)")
    ap.add_argument("--tol-l2", type=float, default=None)
    ap.add_argument("--tol-l3", type=float, default=None)
    ap.add_argument("--tol-l4", type=float, default=None)
    ap.add_argument("--lax-import", action="store_true",
                    help="allow key-map gaps when loading a real checkpoint (default for "
                         "checkpoint dirs is strict: any unmatched key or leaf left at init aborts)")
    ap.add_argument("--inputs", metavar="FILE.npz",
                    help="the JAX tiny adapter's weights and draws (tools/export_parity_inputs.py)")
    ap.add_argument("--device", default="cuda", help="the adapter's device (default cuda)")
    args = ap.parse_args(argv)

    import numpy as np

    from .harness import DEFAULT_TOLERANCES, ParityHarness, ProbeInputs, compare_records

    tols = {lvl: v for lvl, v in (("L2", args.tol_l2), ("L3", args.tol_l3), ("L4", args.tol_l4))
            if v is not None}
    if args.compare:
        a, b = (dict(np.load(p, allow_pickle=False)) for p in args.compare)
        rep = compare_records(a, b, {**DEFAULT_TOLERANCES, **tols})
        print(rep.summary())
        return 0 if rep.passed else 1
    if not args.model_type:
        ap.error("--model-type required unless --compare")
    if not (args.record or args.check):
        ap.error("one of --record/--check/--compare required")

    from ..models import load_adapter
    from ..utils.base import use_full_fp32

    use_full_fp32()
    strict = os.path.isdir(args.path) and not args.lax_import
    config = make_config(args.model_type, args.path, args.resolution, args.steps, strict_import=strict)
    adapter = load_adapter(config, device=args.device)
    inputs = ProbeInputs.load(args.inputs) if args.inputs else None
    harness = ParityHarness(adapter, levels=tuple(int(x) for x in args.levels.split(",")), inputs=inputs)
    if args.record:
        harness.save(args.record)
        print(f"recorded goldens → {args.record}")
        return 0
    rep = harness.check(args.check, tolerances=tols)
    print(rep.summary())
    return 0 if rep.passed else 1


if __name__ == "__main__":
    sys.exit(main())
