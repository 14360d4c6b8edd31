"""PyTorch port, boundaries: what the port imports, where it runs, and the
host modules it keeps its own copies of (against the JAX package's)."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of the port, imported in a fresh interpreter, leaves
    jax, flax and flow_factory_tpu out of sys.modules."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import flow_factory_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax", "flow_factory_tpu"))
        print(len(names), bad)
        sys.exit(1 if bad or len(names) < 30 else 0)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_source_files_never_name_jax():
    root = os.path.join(REPO, "flow_factory_tpu_torch")
    offenders = []
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                text = open(os.path.join(dirpath, f)).read()
                if "import jax" in text or "from jax" in text or "from flow_factory_tpu." in text \
                        or "import flow_factory_tpu\n" in text or "import flax" in text:
                    offenders.append(f)
    with open(os.path.join(REPO, "chip_smoke.py")) as fh:
        smoke = fh.read()
    assert not offenders and "import jax" not in smoke and "from flow_factory_tpu." not in smoke


def test_cuda_request_without_a_card_raises(monkeypatch):
    """Entry points default to cuda; without a card they raise rather than
    quietly running on the CPU."""
    from flow_factory_tpu_torch.models import load_adapter
    from flow_factory_tpu_torch.utils.base import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        load_adapter(_tiny_config())
    assert resolve_device("cpu") == torch.device("cpu")


def _tiny_config(**train):
    from flow_factory_tpu_torch.hparams import Arguments

    return Arguments.from_dict({
        "model": {"model_type": "sd3-5", "model_name_or_path": "tiny", "inference_dtype": "float32"},
        "train": {"resolution": 32, "num_inference_steps": 2, "per_device_batch_size": 1,
                  "group_size": 1, "unique_sample_num_per_epoch": 1, **train},
    })


def test_tiny_adapter_on_cpu_runs_the_plain_path_and_counts_nothing():
    """A CPU rollout computes every kernel's plain version: no launch counted."""
    from flow_factory_tpu_torch import ops
    from flow_factory_tpu_torch.models import load_adapter

    ops.reset_launch_counts()
    adapter = load_adapter(_tiny_config(guidance_scale=1.0), device="cpu")
    samples = adapter.inference(prompt=["a cat"], decode=False)
    assert ops.launch_counts() == {name: 0 for name in ops.KERNEL_WRAPPERS}
    assert np.isfinite(samples[0].all_latents).all()
    assert next(adapter.modules["transformer"].parameters()).device.type == "cpu"


def test_dist_defaults_and_refuses_more_than_one_process(monkeypatch):
    from flow_factory_tpu_torch.parallel import dist

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.delenv("RANK", raising=False)
    assert (dist.get_world_size(), dist.get_rank(), dist.is_distributed()) == (1, 0, False)
    assert dist.host_allgather_objects([1, 2]) == [[1, 2]]
    np.testing.assert_array_equal(dist.host_allgather(np.arange(3)), np.arange(3))
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    assert (dist.get_world_size(), dist.get_rank()) == (2, 1)
    with pytest.raises(NotImplementedError):
        dist.host_allgather(np.arange(3))


def test_hparams_match_jax_and_load_yaml_lazily():
    """The port's copy resolves the smoke GRPO YAML like the JAX package's
    (world size 1 on both sides), and storage dtypes map to torch."""
    from flow_factory_tpu.hparams.args import Arguments as JArgs
    from flow_factory_tpu.parallel.dist import set_world_size_override
    from flow_factory_tpu_torch.hparams import Arguments

    path = os.path.join(REPO, "tests/fixtures/smoke_grpo.yaml")
    set_world_size_override(1)
    try:
        theirs = JArgs.load_from_yaml(path)
    finally:
        set_world_size_override(None)
    ours = Arguments.load_from_yaml(path)
    a, b = ours.to_dict(), theirs.to_dict()
    for d in (a, b):
        d.pop("launcher")
        d["log"].pop("run_name")
    assert a == b
    assert ours.training_args.storage_dtype is torch.float32
    assert "yaml" not in open(os.path.join(REPO, "flow_factory_tpu_torch/hparams/args.py")).read().split(
        "def load_from_yaml")[0]


@pytest.mark.parametrize("indices", ["all", None, [0, 2, -1]])
def test_trajectory_maps_match_jax(indices):
    from flow_factory_tpu.utils.trajectory import build_store_maps as jmaps
    from flow_factory_tpu_torch.utils.trajectory import build_store_maps

    ours, theirs = build_store_maps(indices, 6), jmaps(indices, 6)
    for field in ("latent_store_slot", "logprob_store_slot", "latent_index_map", "logprob_index_map"):
        np.testing.assert_array_equal(getattr(ours, field), getattr(theirs, field))
    assert (ours.num_latent_slots, ours.num_logprob_slots) == (theirs.num_latent_slots, theirs.num_logprob_slots)


def test_hash_tokenizer_matches_jax_and_fits_clip_vocab():
    """Same ids as the JAX package wherever its id range is non-empty; for
    CLIP's full vocabulary (bos 49406, eos 49407 of 49408) the JAX package
    raises and the port maps words below the special ids."""
    from flow_factory_tpu.utils.tokenizer import HashTokenizer as JTok
    from flow_factory_tpu_torch.utils.tokenizer import HashTokenizer

    text = ["a photo of a red fox in the snow", ""]
    for kw in (dict(vocab_size=1000, max_length=8, bos_token_id=1, eos_token_id=2),
               dict(vocab_size=32128, max_length=16, eos_token_id=1)):
        np.testing.assert_array_equal(HashTokenizer(**kw)(text)["input_ids"], JTok(**kw)(text)["input_ids"])
    clip = dict(vocab_size=49408, max_length=77, bos_token_id=49406, eos_token_id=49407)
    with pytest.raises(ValueError):
        JTok(**clip)(text)
    ids = HashTokenizer(**clip)(text)["input_ids"]
    words = ids[0, 1:10]  # bos, nine words, eos
    assert ids[0, 0] == 49406 and ids[0, 10] == 49407 and np.all((words >= 1) & (words < 49406))


def test_rewards_and_advantages_match_jax():
    """Brightness reward and 'sum'/'gdpo' group advantages on the same images."""
    from flow_factory_tpu.advantage import AdvantageProcessor as JAdv
    from flow_factory_tpu.hparams.reward_args import RewardArguments as JRArgs
    from flow_factory_tpu.rewards.models import MyReward as JReward
    from flow_factory_tpu.samples import BaseSample as JSample
    from flow_factory_tpu_torch.advantage import AdvantageProcessor
    from flow_factory_tpu_torch.hparams.reward_args import RewardArguments
    from flow_factory_tpu_torch.rewards import MyReward, RewardProcessor
    from flow_factory_tpu_torch.samples import BaseSample

    rng = np.random.default_rng(0)
    images = [rng.uniform(0, 1, (3, 8, 8)).astype(np.float32) for _ in range(6)]
    prompts = ["p0", "p0", "p0", "p1", "p1", "p1"]
    ours = [BaseSample(image=im, prompt=p) for im, p in zip(images, prompts)]
    theirs = [JSample(image=im, prompt=p) for im, p in zip(images, prompts)]
    RewardProcessor([MyReward(RewardArguments(name="b", reward_model="MyReward"))]).score_and_attach(ours)
    j_scores = JReward(JRArgs(name="b", reward_model="MyReward")).compute_reward(image=images, prompt=prompts)
    for s, r in zip(theirs, j_scores):
        s.extra_kwargs["rewards"] = {"b": float(r)}
    for agg in ("sum", "gdpo"):
        m_ours = AdvantageProcessor(group_size=3, aggregation=agg).compute_advantages(ours)
        m_theirs = JAdv(group_size=3, aggregation=agg).compute_advantages(theirs)
        assert [s.unique_id for s in ours] == [s.unique_id for s in theirs]
        np.testing.assert_allclose([s.extra_kwargs["advantage"] for s in ours],
                                   [s.extra_kwargs["advantage"] for s in theirs], atol=1e-12)
        assert m_ours == pytest.approx(m_theirs)


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """chip_smoke.py exits non-zero and prints no result on a machine without
    CUDA, and in a directory that holds nothing else of the repo."""
    for cwd, script in ((REPO, "chip_smoke.py"), (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["CUDA_VISIBLE_DEVICES"] = ""
        res = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env, capture_output=True,
                             text=True, timeout=300)
        assert res.returncode != 0 and '"ok"' not in res.stdout
