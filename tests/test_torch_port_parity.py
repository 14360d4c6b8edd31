"""PyTorch port, the parity harness (``flow_factory_tpu_torch/parity``) on
the CPU: the JAX harness's comparison and config-diff cases held to the JAX
functions, the probe-inputs file format, the port's own record followed by a
check at max |Δ| 0, the command line, and all 13 JAX goldens
(``tests/goldens``) through the port from the committed inputs
(``tests/goldens_torch``) at ``DEFAULT_TOLERANCES`` with L1 exact. The
inputs' freshness against the JAX package is in
tests/test_torch_port_parity_fresh_*.py."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
from torch_port_threads import one_torch_thread  # noqa: F401

import torch_port_parity_cases as C


def test_constants_are_the_jax_harness_constants():
    from flow_factory_tpu.parity import harness as J
    from flow_factory_tpu_torch import parity as P

    assert (P.PROBE_SEED, P.PROBE_COND_SEED, P.PROBE_PROMPTS) == (J.PROBE_SEED, J.PROBE_COND_SEED, J.PROBE_PROMPTS)
    assert P.DEFAULT_TOLERANCES == J.DEFAULT_TOLERANCES == {"L1": 0.0, "L2": 1e-4, "L3": 1e-3, "L4": 1e-3}


def test_compare_records_flags_mismatch():
    """tests/test_parity_harness.py's mismatch and missing-key cases, on the
    port's ``compare_records`` and on JAX's, with the same verdicts."""
    from flow_factory_tpu.parity import compare_records as jcompare
    from flow_factory_tpu_torch.parity import compare_records

    g = {"L2/x": np.zeros(4, np.float32), "L3/y": np.ones(3, np.float32)}
    for compare in (compare_records, jcompare):
        ok = compare(g, {k: v.copy() for k, v in g.items()}, {"L2": 1e-4, "L3": 1e-3})
        assert ok.passed
        bad = {**g, "L2/x": np.full(4, 1e-2, np.float32)}
        rep = compare(g, bad, {"L2": 1e-4, "L3": 1e-3})
        assert not rep.passed and any("L2/x" in f for f in rep.failures)
        rep2 = compare(g, {"L2/x": g["L2/x"]}, {"L2": 1e-4})
        assert not rep2.passed and rep2.missing == ["L3/y"]
        extra = compare(g, {**g, "L4/z": np.ones(1, np.float32)}, {"L2": 1e-4, "L3": 1e-3})
        assert extra.passed and extra.extra == ["L4/z"]
        shape = compare(g, {**g, "L3/y": np.ones(4, np.float32)}, {"L2": 1e-4, "L3": 1e-3})
        assert not shape.passed and any("shape" in f for f in shape.failures)


def test_compare_records_fails_a_nan():
    """A NaN passes no tolerance in the port (the JAX harness's ``d > t``
    lets one through)."""
    from flow_factory_tpu_torch.parity import compare_records

    g = {"L2/x": np.zeros(2, np.float32)}
    rep = compare_records(g, {"L2/x": np.asarray([0.0, np.nan], np.float32)}, {"L2": 1e-4})
    assert not rep.passed and rep.failures and "L2/x" in rep.summary()


@pytest.mark.parametrize("case", ["equal", "value", "tuple-list", "new-field", "lost-field", "component"])
def test_diff_config_matches_jax(case):
    """The L1 config diff, the port's against JAX's on the same dumps: equal
    dumps, a changed value, a tuple against its json list, a field only the
    current dump has (schema growth: no difference), a field only the golden
    has, a component on one side."""
    from flow_factory_tpu.parity.harness import _diff_config as jdiff
    from flow_factory_tpu_torch.parity import _diff_config

    golden = {"transformer": {"depth": 2, "axes": [8, 4, 4], "eps": 1e-6}, "vae": {"scale": 1.5}}
    current = {"transformer": {"depth": 2, "axes": (8, 4, 4), "eps": 1e-6}, "vae": {"scale": 1.5}}
    if case == "value":
        current["transformer"]["depth"] = 3
    if case == "new-field":
        current["vae"]["shift"] = 0.1
    if case == "lost-field":
        golden["vae"]["shift"] = 0.1
    if case == "component":
        current["text_encoder"] = {"layers": 2}
    diffs = _diff_config(golden, current)
    assert diffs == jdiff(golden, current)
    assert bool(diffs) == (case in ("value", "lost-field", "component")), diffs


def test_probe_inputs_round_trip_their_bytes_and_sharing(tmp_path):
    """:class:`ProbeInputs` saves the same bytes twice, loads back bit for
    bit, and a shared component is read from the file it names."""
    from flow_factory_tpu_torch.parity import ProbeInputs

    rng = np.random.default_rng(0)
    tree = {"block/linear/kernel": rng.standard_normal((4, 3)).astype(np.float32),
            "block/linear/bias": np.zeros(3, np.float32)}
    a = ProbeInputs(params={"transformer": tree, "vae": {"conv/kernel": np.ones((1, 1, 2, 2), np.float32)}},
                    x0=rng.standard_normal((1, 4, 4, 2)).astype(np.float32),
                    noise=rng.standard_normal((3, 1, 4, 8)).astype(np.float32),
                    sde_noise=rng.standard_normal((1, 16)).astype(np.float32))
    a.save(str(tmp_path / "one.inputs.npz"))
    a.save(str(tmp_path / "again.inputs.npz"))
    assert (tmp_path / "one.inputs.npz").read_bytes() == (tmp_path / "again.inputs.npz").read_bytes()
    b = ProbeInputs(params={"transformer": tree}, x0=a.x0, noise=a.noise, sde_noise=a.sde_noise,
                    audio_x0=a.x0[:, :2], shared={"transformer": "one"})
    b.save(str(tmp_path / "two.inputs.npz"))
    assert not any(k.startswith("params/") for k in np.load(tmp_path / "two.inputs.npz").files)
    back = ProbeInputs.load(str(tmp_path / "two.inputs.npz"))
    assert back.shared == {"transformer": "one"} and sorted(back.params) == ["transformer"]
    for path, arr in tree.items():
        assert np.array_equal(back.params["transformer"][path], arr)
    assert np.array_equal(back.audio_x0, a.x0[:, :2]) and np.array_equal(back.noise, a.noise)
    one = ProbeInputs.load(str(tmp_path / "one.inputs.npz"))
    assert one.audio_x0 is None and one.shared == {} and sorted(one.params) == ["transformer", "vae"]


@pytest.mark.parametrize("name", C.NAMES)
def test_port_record_then_check_gives_zero(name, tmp_path):
    """The port's own goldens, from its own weights and torch draws seeded
    with PROBE_SEED: ``record`` then ``check`` on a second adapter gives
    max |Δ| exactly 0 at every key and L1 no difference; the condition media
    of the conditioned families are drawn as JAX's harness draws them."""
    from flow_factory_tpu_torch.parity import ParityHarness

    path = str(tmp_path / f"{name}.npz")
    ParityHarness(C.port_adapter(name)).save(path)
    rep = ParityHarness(C.port_adapter(name)).check(path)
    assert rep.passed and not rep.extra, rep.summary()
    assert rep.max_diffs and all(d == 0.0 for d in rep.max_diffs.values()), rep.summary()
    with open(os.path.join(C.GOLDENS, f"{name}.npz.json")) as g, open(path + ".json") as f:
        assert json.load(f)["condition_probes"] == json.load(g)["condition_probes"]


@pytest.mark.parametrize("name", C.NAMES)
def test_golden_matches_through_the_port(name):
    """Each of the 13 JAX goldens through the port on the committed inputs:
    every key the golden holds within ``DEFAULT_TOLERANCES`` (L2 1e-4, L3 and
    L4 1e-3), the L1 config dump equal, no key missing or extra, and the
    replayed L3 log-prob within L3's tolerance of the rollout's."""
    rep = C.check_golden(name)
    assert rep.passed and not rep.missing and not rep.extra, rep.summary()
    assert len(rep.max_diffs) == len(np.load(os.path.join(C.GOLDENS, f"{name}.npz")).files)


def test_cli_checks_a_golden_on_the_cpu_and_asks_for_a_card_by_default(monkeypatch):
    """``python -m flow_factory_tpu_torch.parity ... --device cpu --inputs
    ... --check tests/goldens/sd35.npz`` exits 0; without ``--device`` it
    asks for ``cuda`` and, on a machine with no card, raises."""
    import torch

    from flow_factory_tpu_torch.parity.__main__ import main

    args = ["--model-type", "sd3-5", "--path", "tiny", "--inputs", C.inputs_path("sd35"),
            "--check", os.path.join(C.GOLDENS, "sd35.npz")]
    proc = subprocess.run([sys.executable, "-m", "flow_factory_tpu_torch.parity", *args, "--device", "cpu"],
                          cwd=C.REPO, capture_output=True, text=True, timeout=300,
                          env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "parity: PASS" in proc.stdout
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        main(args)
    golden = os.path.join(C.GOLDENS, "sd35.npz")
    assert main(["--compare", golden, golden]) == 0
