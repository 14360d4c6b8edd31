"""Shared cases of the port's parity harness tests (imported by the
tests/test_torch_port_parity*.py files): the 13 JAX goldens, the port's
tiny adapter of a golden's model type, and the freshness check of a
committed inputs file against ``tools/export_parity_inputs.py``'s output
computed now from the JAX package."""
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(REPO, "tests", "goldens")
INPUTS = os.path.join(REPO, "tests", "goldens_torch")
sys.path.insert(0, os.path.join(REPO, "tools"))

#: every golden of tests/goldens, by name
NAMES = sorted(f[:-len(".npz")] for f in os.listdir(GOLDENS) if f.endswith(".npz"))


def model_type(name: str) -> str:
    with open(os.path.join(GOLDENS, f"{name}.npz.json")) as f:
        return json.load(f)["model_type"]


def inputs_path(name: str) -> str:
    return os.path.join(INPUTS, f"{name}.inputs.npz")


def port_adapter(name: str, **config):
    """The port's tiny adapter of the golden's model type on the CPU, built
    from the parity CLI's config."""
    from flow_factory_tpu_torch.models import load_adapter
    from flow_factory_tpu_torch.parity.__main__ import make_config

    return load_adapter(make_config(model_type(name), "tiny", **config), device="cpu")


def check_golden(name: str):
    """The port's harness on the committed inputs against the JAX golden at
    ``DEFAULT_TOLERANCES``; returns the report."""
    from flow_factory_tpu_torch.parity import ParityHarness, ProbeInputs

    harness = ParityHarness(port_adapter(name), inputs=ProbeInputs.load(inputs_path(name)))
    return harness.check(os.path.join(GOLDENS, f"{name}.npz"))


def assert_inputs_fresh(name: str, tmp_path) -> None:
    """The committed inputs of ``name`` equal what the export tool computes
    now from the JAX package, array for array bit for bit (a shared
    component is compared after it is read from the file it names), and
    the committed file's bytes are the tool's bytes for the same sharing."""
    import export_parity_inputs as tool

    from flow_factory_tpu_torch.parity import ProbeInputs

    fresh = tool.probe_inputs(name)
    committed = ProbeInputs.load(inputs_path(name))
    assert sorted(fresh.params) == sorted(committed.params), name
    for comp, tree in fresh.params.items():
        assert sorted(tree) == sorted(committed.params[comp]), (name, comp)
        for path, a in tree.items():
            b = committed.params[comp][path]
            assert a.dtype == b.dtype == np.float32 and a.shape == b.shape, (name, comp, path)
            assert np.array_equal(a.view(np.uint32), b.view(np.uint32)), (name, comp, path)
    for field in ("x0", "noise", "sde_noise", "audio_x0"):
        a, b = getattr(fresh, field), getattr(committed, field)
        assert (a is None) == (b is None), (name, field)
        if a is not None:
            assert a.shape == b.shape and np.array_equal(np.asarray(a, np.float32).view(np.uint32),
                                                         b.view(np.uint32)), (name, field)
    for comp, owner in committed.shared.items():
        assert owner != name and os.path.exists(inputs_path(owner)), (name, comp, owner)
        assert comp not in {k.split("/")[1] for k in np.load(inputs_path(name)).files if k.startswith("params/")}
    fresh.shared = dict(committed.shared)
    out = tmp_path / f"{name}.inputs.npz"
    fresh.save(str(out))
    with open(inputs_path(name), "rb") as f:
        assert out.read_bytes() == f.read(), name
