"""Run phases of a checkout's ``chip_smoke.py`` alone, on the card.

    python3 tools/smoke_phases.py DIR PHASE [PHASE ...]

imports ``DIR/chip_smoke.py`` with DIR first on the path (so the port it
drives is DIR's), builds the kernels (``phase_environment``) and calls each
named phase function in order, e.g. ``phase_train phase_wan_train``; a phase
that takes the epochs' record is given an empty list. Its output is the
phases' own lines. To compare two commits on one card, unpack each with
``git archive`` into a directory that ``.gitignore`` lists and run parent,
change, change, parent in one call.
"""
from __future__ import annotations

import inspect
import os
import sys


def main() -> int:
    if len(sys.argv) < 3:
        print(__doc__, file=sys.stderr)
        return 2
    root = os.path.abspath(sys.argv[1])
    sys.path.insert(0, root)
    os.chdir(root)
    import chip_smoke
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from flow_factory_tpu_torch.utils.base import use_full_fp32

    use_full_fp32()
    chip_smoke.log(f"[phases] {root}: {sys.argv[2:]}")
    chip_smoke.phase_environment()
    for name in sys.argv[2:]:
        phase = getattr(chip_smoke, name)
        phase(*([] for _ in inspect.signature(phase).parameters))
    return 0


if __name__ == "__main__":
    sys.exit(main())
