"""PyTorch port, the run's entry point and its records: ``fft-train-torch``
(``flow_factory_tpu_torch.cli``) against the JAX package's ``fft-train`` —
overrides, one epoch to a final checkpoint, the multi-process refusal —
and the loggers (``load_logger``'s backends, tensorboard, the JSONL record's
media files and rows against the JAX package's for the same samples, the
train and eval media of a run), the epoch-1 profiler trace and the memory
snapshots. On the CPU, on the smoke config (tests/fixtures/smoke_grpo.yaml).
"""
import gzip
import json
import logging
import os
import signal
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests/fixtures/smoke_grpo.yaml")


@pytest.fixture(autouse=True, scope="module")
def _isolated():
    """The JAX package's world-size override is process-wide: reset it before
    and after this module (another module on the worker may have left it
    set). ``_restore_sigterm`` puts SIGTERM back after each test."""
    from flow_factory_tpu.parallel.dist import set_world_size_override

    set_world_size_override(None)
    yield
    set_world_size_override(None)


@pytest.fixture(autouse=True)
def _restore_sigterm():
    prev = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, prev)


#: every override value these tests pass
OVERRIDE_VALUES = ["1", "0", "2", "8", "2.0e-4", "0.5", "true", "false", "null", "[0, 1]", "cpu",
                   "cli_smoke", "tensorboard", "/tmp/fft/cache"]


def _overrides(tmp_path):
    return [
        "--set", "train.max_epochs=1",
        "--set", f"data.cache_dir={tmp_path / 'cache'}",
        "--set", f"log.save_dir={tmp_path / 'saves'}",
        "--set", "log.save_freq=1",
        "--set", "log.run_name=cli_smoke",
        "--set", "log.save_model_only=false",
        "--set", "scheduler.sde_steps=[0, 1]",
        "--set", "model.resume_path=null",
        "--train.learning_rate", "2.0e-4",
        "--train.ema_decay", "0.5",
        "--model.lora_rank", "8",
    ]


def _capture(monkeypatch, trainers_module):
    """Swap the package's ``load_trainer`` for one that records the config and
    returns a trainer that does nothing."""
    seen = {}

    class _Idle:
        def start(self):
            seen["started"] = True

        def cleanup(self):
            pass

    def load_trainer(config, *args, **kwargs):
        seen["config"] = config
        return _Idle()

    monkeypatch.setattr(trainers_module, "load_trainer", load_trainer)
    return seen


def test_overrides_build_the_jax_cli_config(tmp_path, monkeypatch):
    """``--set KEY=VALUE`` and bare ``--a.b value`` pairs give the same
    ``Arguments`` as the JAX ``train_cli``'s parsing (on one replica, as the
    port runs), ``config_file`` the path given."""
    import flow_factory_tpu.trainers as jax_trainers
    import flow_factory_tpu_torch.trainers as port_trainers
    from flow_factory_tpu.cli import train_cli as jax_cli
    from flow_factory_tpu.parallel.dist import set_world_size_override
    from flow_factory_tpu_torch.cli import train_cli

    argv = [FIXTURE, *_overrides(tmp_path)]
    theirs, ours = _capture(monkeypatch, jax_trainers), _capture(monkeypatch, port_trainers)
    set_world_size_override(1)  # the batch geometry resolves per replica count
    try:
        jax_cli(argv)
    finally:
        set_world_size_override(None)
    train_cli(argv)
    assert theirs["started"] and ours["started"]
    want, got = theirs["config"].to_dict(), ours["config"].to_dict()
    assert got == want and got["config_file"] == FIXTURE
    assert got["model"]["lora_rank"] == 8 and got["model"]["resume_path"] is None
    assert got["train"]["learning_rate"] == 2.0e-4 and got["scheduler"]["sde_steps"] == [0, 1]
    assert got["log"]["save_model_only"] is False and got["log"]["save_freq"] == 1


@pytest.mark.parametrize("raw", OVERRIDE_VALUES + ["1e-4", "[a, b]", "{k: 1}", "a: b: c"])
def test_override_values_read_as_the_jax_cli_reads_them(raw):
    """Each override value parses to what the JAX CLI's ``_parse_value``
    gives, of the same type; text that is not YAML stays the raw string."""
    from flow_factory_tpu.cli import _parse_value as jax_parse
    from flow_factory_tpu_torch.cli import _parse_value

    got, want = _parse_value(raw), jax_parse(raw)
    assert got == want and type(got) is type(want)


def test_cli_one_epoch_writes_the_final_checkpoint(tmp_path):
    """tests/test_cli.py for the port: one epoch through ``train_cli`` writes
    ``final/adapter_config.json``, ``final/lora_transformer.safetensors`` and
    ``metrics.jsonl`` (here with the training state too)."""
    from flow_factory_tpu_torch.cli import train_cli

    train_cli([FIXTURE, "--set", "model.device=cpu", *_overrides(tmp_path)])
    run = tmp_path / "saves" / "cli_smoke"
    assert sorted(os.listdir(run / "final")) == ["adapter_config.json", "lora_transformer.safetensors", "train_state"]
    rows = [json.loads(line) for line in open(run / "metrics.jsonl")]
    scalars = [r for r in rows if "media_tag" not in r]
    assert [r["step"] for r in scalars] == [0] and scalars[0]["train/ratio_mean"] == 1.0
    assert json.load(open(run / "final" / "adapter_config.json"))["lora_rank"] == 8


@pytest.mark.parametrize("env, flags", [
    ({"NUM_PROCESSES": "2"}, []),
    ({"NUM_NODES": "2"}, []),
    ({}, ["--num-processes", "2"]),
    ({}, ["--coordinator-address", "localhost:1234"]),
    ({}, ["--process-id", "0"]),
])
def test_more_than_one_process_raises(monkeypatch, env, flags):
    """The topology comes from the flags, else torchrun's environment, else
    any JAX alias (``resolve_launch``), and a mesh the port cannot run raises
    before any process group is made: ``tensor_size`` 2 without
    ``attn_backend: ring`` is tensor parallelism (ROADMAP item 22). A run on
    several processes: ``tests/test_torch_port_multiprocess.py``."""
    import torch.distributed as dist
    from flow_factory_tpu_torch.cli import resolve_launch, train_cli

    for names in (("NUM_PROCESSES", "NUM_MACHINES", "NUM_NODES", "HOST_NUM"),
                  ("COORDINATOR_ADDRESS", "MASTER_IP", "MASTER_ADDR", "CHIEF_IP"),
                  ("PROCESS_ID", "MACHINE_RANK", "NODE_RANK", "INDEX"),
                  ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_PORT")):
        for name in names:
            monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    kwargs = {"--num-processes": ("num_processes", int), "--process-id": ("process_id", int),
              "--coordinator-address": ("coordinator_address", str)}
    given = {kwargs[f][0]: kwargs[f][1](v) for f, v in zip(flags[::2], flags[1::2])}
    launch = resolve_launch(**given)
    want = {"coordinator_address": None, "process_id": None, "num_processes": 2 if env else None, **given}
    assert launch == want
    with pytest.raises(NotImplementedError, match="item 22"):
        train_cli([FIXTURE, "--set", "model.device=cpu", "--set", "model.tensor_size=2", *flags])
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# Loggers
# ---------------------------------------------------------------------------

class _Args:
    def __init__(self, save_dir, **kwargs):
        self.save_dir = save_dir
        self.__dict__.update(kwargs)


def _names(multi):
    return [type(b).__name__ for b in multi.backends]


def test_tensorboard_backend_writes_an_events_file(tmp_path):
    """``logging_backend: tensorboard`` builds console + jsonl + tensorboard,
    as in the JAX package, and the scalars land in an events file."""
    from flow_factory_tpu.logger import load_logger as jax_load_logger
    from flow_factory_tpu_torch.logger import load_logger

    ours = load_logger(_Args(str(tmp_path / "p"), logging_backend="tensorboard"), "run")
    theirs = jax_load_logger(_Args(str(tmp_path / "j"), logging_backend="tensorboard"), "run")
    assert _names(ours) == _names(theirs) == ["ConsoleLogger", "JSONLLogger", "TensorboardLogger"]
    ours.log_data({"train/loss": 0.25}, 3)
    ours.finish()
    tb = tmp_path / "p" / "run" / "tb"
    events = [f for f in os.listdir(tb) if f.startswith("events.out.tfevents")]
    assert events and os.path.getsize(tb / events[0]) > 0
    assert load_logger(_Args(str(tmp_path), logging_backend="none"), "run", is_main_process=False) is None


@pytest.mark.parametrize("args", [dict(logging_backend="wandb"), dict(logging_backend="swanlab"),
                                  dict(report_to=["console", "jsonl", "no_such_backend"])])
def test_unknown_or_missing_backend_warns_and_skips(tmp_path, monkeypatch, caplog, args):
    """A backend whose package is missing, or a name no backend has, is
    skipped with a warning; the run keeps console and jsonl — as in the JAX
    package."""
    from flow_factory_tpu.logger import load_logger as jax_load_logger
    from flow_factory_tpu_torch.logger import load_logger

    monkeypatch.setitem(sys.modules, "wandb", None)
    monkeypatch.setitem(sys.modules, "swanlab", None)
    with caplog.at_level(logging.WARNING):
        ours = load_logger(_Args(str(tmp_path / "p"), **args), "run")
    port_warnings = [r.getMessage() for r in caplog.records if r.name.startswith("flow_factory_tpu_torch")]
    theirs = jax_load_logger(_Args(str(tmp_path / "j"), **args), "run")
    assert _names(ours) == _names(theirs) == ["ConsoleLogger", "JSONLLogger"]
    assert len(port_warnings) == 1 and "skipping" in port_warnings[0]


def _media_samples():
    from flow_factory_tpu_torch.samples import T2ISample, T2VSample

    rng = np.random.RandomState(0)
    images = [T2ISample(prompt=f"prompt {i}", image=rng.rand(3, 8, 8).astype(np.float32),
                        extra_kwargs={"reward": 0.25 * i}) for i in range(3)]
    video = T2VSample(prompt="a clip", video=rng.rand(4, 3, 8, 8).astype(np.float32), extra_kwargs={"reward": 1.0})
    video.audio = np.sin(np.linspace(0, 30, 1200, dtype=np.float32))[None]
    video.audio_sample_rate = 24000
    return images + [video]


def test_jsonl_media_files_and_rows_match_the_jax_logger(tmp_path):
    """The same samples through the port's and the JAX package's
    ``samples_to_media_payload`` and ``JSONLLogger``: the same captions, the
    same media files byte for byte (an image grid, a video with its audio)
    and the same rows in ``metrics.jsonl``, but for the time and directory."""
    from flow_factory_tpu.logger.formatting import samples_to_media_payload as jax_payload
    from flow_factory_tpu.logger.logger import JSONLLogger as JaxJSONL
    from flow_factory_tpu_torch.logger.formatting import samples_to_media_payload
    from flow_factory_tpu_torch.logger.logger import JSONLLogger

    samples = _media_samples()
    dirs = {}
    for name, payload_fn, cls in (("port", samples_to_media_payload, JSONLLogger),
                                  ("jax", jax_payload, JaxJSONL)):
        media = payload_fn(samples, 30)
        lg = cls(_Args(str(tmp_path / name)), "run")
        lg.log_images("train/samples", media["images"], media["captions"], step=2)
        lg.log_videos("train/samples", media["videos"], media["captions"], step=2, fps=4)
        dirs[name] = (media["captions"], tmp_path / name / "run")
    assert dirs["port"][0] == dirs["jax"][0] == ["prompt 0 | r=0.0000", "prompt 1 | r=0.2500",
                                                 "prompt 2 | r=0.5000", "a clip | r=1.0000"]
    port_media, jax_media = dirs["port"][1] / "media", dirs["jax"][1] / "media"
    files = sorted(os.listdir(port_media))
    assert files == sorted(os.listdir(jax_media)) and any(f.endswith(".png") for f in files) and len(files) >= 2
    for f in files:
        assert (port_media / f).read_bytes() == (jax_media / f).read_bytes(), f

    def rows(run):
        out = []
        for r in map(json.loads, open(run / "metrics.jsonl")):
            r.pop("time")
            r["media_paths"] = [os.path.relpath(p, run) for p in r["media_paths"]]
            out.append(r)
        return out

    assert rows(dirs["port"][1]) == rows(dirs["jax"][1]) and len(rows(dirs["port"][1])) == 2


def _trainer_config(tmp_path, **log):
    from flow_factory_tpu_torch.hparams import Arguments

    cfg = Arguments.load_from_yaml(FIXTURE)
    cfg.data_args.cache_dir = str(tmp_path / "cache")
    cfg.log_args.save_dir = str(tmp_path / "saves")
    for k, v in log.items():
        cfg.log_args.extra_kwargs[k] = v
    return cfg


def test_run_logs_train_and_eval_media_profiles_epoch_1_and_snapshots_memory(tmp_path, monkeypatch):
    """Two epochs with an eval before each, ``log.profile_dir`` and
    ``FFT_MEMORY_PROFILE=1``: each epoch's train samples and each eval's
    samples are written as image grids with their rows, epoch 1 leaves a
    gzipped chrome trace, and the memory snapshots around each phase read 0
    device bytes on the CPU."""
    from flow_factory_tpu_torch.trainers import load_trainer

    monkeypatch.setenv("FFT_MEMORY_PROFILE", "1")
    cfg = _trainer_config(tmp_path, profile_dir=str(tmp_path / "profile"))
    cfg.eval_args.eval_freq = 1
    trainer = load_trainer(cfg, device="cpu")
    trainer.start()
    run = tmp_path / "saves" / cfg.log_args.run_name
    rows = [json.loads(line) for line in open(run / "metrics.jsonl")]
    media = sorted((r["media_tag"], r["step"]) for r in rows if "media_tag" in r)
    assert media == [("eval/samples", 0), ("eval/samples", 1), ("train/samples", 0), ("train/samples", 1)]
    assert all(os.path.exists(p) for r in rows for p in r.get("media_paths", []))
    assert {r["step"] for r in rows if "eval/reward_mean" in r} == {0, 1}
    (trace,) = os.listdir(tmp_path / "profile")
    assert trace == "epoch_1.pt.trace.json.gz"
    with gzip.open(tmp_path / "profile" / trace) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "epoch_1" for e in events)
    snaps = trainer._memory_profiler.device.snapshots
    assert {f"epoch{e}/{p}/{w}" for e in (0, 1) for p in ("sample", "feedback", "optimize")
            for w in ("enter", "exit")} == set(snaps)
    assert all(v == 0 for s in snaps.values() for v in s.values())
    assert trainer._memory_profiler.tensors.stages["epoch1/samples"] > 0


def test_memory_trackers_size_tensors_and_optimizer_state():
    """``tree_nbytes`` sums ``nbytes`` over tensors and arrays, an optimizer's
    state dict included; the facade reports as the JAX one does."""
    import torch

    from flow_factory_tpu.utils.memory_tracker import MemoryProfiler as JaxProfiler
    from flow_factory_tpu_torch.utils.memory_tracker import MemoryProfiler, tree_nbytes

    tree = {"w": np.zeros((128, 128), np.float32), "t": [torch.zeros(4, 4, dtype=torch.bfloat16)]}
    assert tree_nbytes(tree) == 128 * 128 * 4 + 32
    p = torch.nn.Parameter(torch.ones(10, 3))
    opt = torch.optim.AdamW([p])
    p.grad = torch.ones_like(p)
    opt.step()
    assert tree_nbytes(opt.state_dict()) == 2 * 10 * 3 * 4 + 4  # exp_avg, exp_avg_sq, the fp32 step
    ours, theirs = MemoryProfiler(), JaxProfiler()
    for prof in (ours, theirs):
        prof.model.track("transformer", {"w": tree["w"]})
        with prof.stage("rollout"):
            pass
    assert ours.report()["model"] == theirs.report()["model"] == {"transformer": "64.00KiB"}
    assert set(ours.report()["device"]) == set(theirs.report()["device"]) == {"rollout/enter", "rollout/exit"}
