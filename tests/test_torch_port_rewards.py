"""PyTorch port, the rewards against the JAX package: the registry (fault
F17: every reward name of the JAX registry that the port lacks raises
``NotImplementedError`` with its reason, the ported ones resolve, a name in
neither raises ``KeyError``); ``utils/reward_utils`` and ``MyGroupReward``
bit for bit in float64; the native CLIP reward at the tiny towers through
the weight bridge on images and videos, and imported from a transformers
CLIP directory; the ``RewardBuffer`` cases of the JAX package's
``tests/test_rewards_advantage.py`` (sync and async pointwise, groupwise
ranks, the incomplete group, the complete-group dispatch, the tail flush,
``split="pointwise"``), each run in both packages on the same samples and
models, the scores and the dispatched futures equal exactly."""
import os
import re

import jax
import numpy as np
import pytest
import torch
from torch_port_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _isolated():
    """The JAX package's world-size override is process-wide: reset it
    before and after this module (F0)."""
    from flow_factory_tpu.parallel.dist import set_world_size_override

    set_world_size_override(None)
    yield
    set_world_size_override(None)


def test_unported_reward_names_raise_with_their_reason():
    from flow_factory_tpu.rewards.registry import _REWARD_REGISTRY as JAX_REWARDS

    from flow_factory_tpu_torch.rewards.registry import _REWARD_REGISTRY, resolve_reward_class

    reasons = {"PickScore": "local weights", "PickScoreRank": "local weights", "CLIPScore": "local weights",
               "OCR": "not installed", "CLAP": "local weights", "ImageBind": "not installed"}
    unported = sorted(set(JAX_REWARDS) - set(_REWARD_REGISTRY))
    assert len(unported) == len(JAX_REWARDS) - 4
    for name in unported:
        with pytest.raises(NotImplementedError, match=re.escape(reasons.get(name, "server"))):
            resolve_reward_class(name)


def test_ported_and_unknown_reward_names():
    from flow_factory_tpu_torch.rewards.clip_native import NativeCLIPReward
    from flow_factory_tpu_torch.rewards.models import MyGroupReward, MyReward
    from flow_factory_tpu_torch.rewards.registry import resolve_reward_class

    assert resolve_reward_class("MyReward") is MyReward
    assert resolve_reward_class("MyGroupReward") is MyGroupReward
    assert resolve_reward_class("PickScoreNative") is resolve_reward_class("CLIPNative") is NativeCLIPReward
    with pytest.raises(KeyError, match="PickScor"):
        resolve_reward_class("PickScor")


# ---------------------------------------------------------------------------
# reward_utils and MyGroupReward
# ---------------------------------------------------------------------------

SCORES = (np.asarray([0.3, 0.7, 0.3, 0.1, 0.9]), np.asarray([2.0]), np.asarray([0.5, 0.5]))


@pytest.mark.parametrize("name", ["pairwise_matrix", "win_rates", "rank_normalize", "bradley_terry"])
def test_reward_utils_match_jax_bit_for_bit(name):
    """Each helper on groups with ties, one member and all tied: the JAX
    package's float64 bits (Bradley-Terry on the groups' win matrices)."""
    from flow_factory_tpu.utils import reward_utils as J

    from flow_factory_tpu_torch.utils import reward_utils as T

    for s in SCORES:
        arg = J.pairwise_matrix(s) * 3.0 if name == "bradley_terry" else s
        np.testing.assert_array_equal(getattr(T, name)(arg), getattr(J, name)(arg))


def _images(brightness):
    return [np.full((3, 4, 4), b, np.float32) for b in brightness]


def test_my_group_reward_matches_jax_bit_for_bit():
    from flow_factory_tpu.hparams.reward_args import RewardArguments as JArgs
    from flow_factory_tpu.rewards.models import MyGroupReward as J

    from flow_factory_tpu_torch.hparams.reward_args import RewardArguments
    from flow_factory_tpu_torch.rewards.models import MyGroupReward

    for b in ([0.9, 0.1, 0.4, 0.4], [0.2]):
        fields = dict(image=_images(b), prompt=["p"] * len(b))
        want = J(JArgs(name="r", reward_model="MyGroupReward")).compute_group_reward(**fields)
        got = MyGroupReward(RewardArguments(name="r", reward_model="MyGroupReward")).compute_group_reward(**fields)
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# The native CLIP reward
# ---------------------------------------------------------------------------

PROMPTS = ["a red apple on a wooden table", "a lighthouse at dusk", "two cats asleep on a sofa"]


def _clip_pair(path="", tiny=False):
    """The JAX reward and the port's on the CPU, both set up on
    ``model_name_or_path`` ``path`` (the tiny towers of a directory with
    ``tiny``)."""
    from flow_factory_tpu.hparams.reward_args import RewardArguments as JArgs
    from flow_factory_tpu.rewards.clip_native import NativeCLIPReward as J

    from flow_factory_tpu_torch.hparams.reward_args import RewardArguments
    from flow_factory_tpu_torch.rewards.clip_native import NativeCLIPReward

    kw = dict(name="clip", reward_model="PickScoreNative", model_name_or_path=path,
              extra_kwargs={"tiny": True} if tiny else {})
    jr = J(JArgs(**kw))
    jr.setup()
    pr = NativeCLIPReward(RewardArguments(**kw), device="cpu")
    pr.setup()
    return jr, pr


def _media(kind):
    rng = np.random.default_rng(3)
    if kind == "image":  # 24 px: the resize to the tiny towers' 16 px shrinks
        return dict(image=[rng.uniform(0, 1, (3, 24, 24)).astype(np.float32) for _ in PROMPTS])
    return dict(image=[None] * len(PROMPTS),
                video=[rng.uniform(0, 1, (3, 3, 12, 12)).astype(np.float32) for _ in PROMPTS])


def _assert_scores_close(got, want):
    assert got.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("kind", ["image", "video"])
def test_native_clip_reward_matches_jax_through_the_bridge(kind):
    """The tiny CLIP towers (post-LN vision, CLS pooling, the visual
    projection, the cosine times exp(logit_scale)) on the JAX reward's
    weights through the bridge: images, and videos as the mean of their
    frames' scores, within 1e-5 relative."""
    from flow_factory_tpu_torch.utils import weights

    jr, pr = _clip_pair()
    host = lambda tree: jax.tree.map(np.asarray, jax.device_get(tree))
    weights.load_component(pr.vision, weights.convert(host(jr.vision_params),
                                                      *weights.clip_vision_map(pr.vision_cfg.num_layers)))
    weights.load_component(pr.text, weights.convert(host(jr.text_params),
                                                    *weights.clip_text_map(pr.text_cfg.num_layers)))
    pr.visual_projection = torch.from_numpy(np.array(jr.visual_projection))
    pr.logit_scale = torch.tensor(float(jr.logit_scale))
    fields = dict(prompt=PROMPTS, **_media(kind))
    want = jr.compute_reward(**fields)
    _assert_scores_close(pr.compute_reward(**fields), want)
    assert np.abs(want).max() > 1.0  # away from 0: the bar is relative


def test_native_clip_reward_imports_a_transformers_directory_as_jax(tmp_path):
    """A transformers CLIP directory (``vision_model.*`` with the
    ``pre_layrnorm`` spelling and an (L, D) position table, ``text_model.*``,
    ``visual_projection``, ``logit_scale``) written from the JAX key maps:
    both rewards import it, and their scores agree within 1e-5 relative."""
    from safetensors.numpy import save_file
    from test_utils_aux import _synth_torch_state_dict

    from flow_factory_tpu.hparams.reward_args import RewardArguments as JArgs
    from flow_factory_tpu.rewards.clip_native import NativeCLIPReward as J
    from flow_factory_tpu.utils.checkpoint import clip_text_encoder_key_map, clip_vision_encoder_key_map

    jr = J(JArgs(name="clip", reward_model="PickScoreNative", model_name_or_path="tiny"))
    jr.setup()  # the tiny towers' parameter shapes
    vision = _synth_torch_state_dict(jr.vision_params, *clip_vision_encoder_key_map(jr.vision_cfg.num_layers),
                                     seed=1)
    vision["vision_model.embeddings.position_embedding.weight"] = \
        vision["vision_model.embeddings.position_embedding.weight"][0]
    text = _synth_torch_state_dict(jr.text_params, *clip_text_encoder_key_map(jr.text_cfg.num_layers), seed=2)
    rng = np.random.default_rng(4)
    sd = {k: 0.2 * v for k, v in {**vision, **text}.items()}
    sd["visual_projection.weight"] = rng.standard_normal((32, 32)).astype(np.float32) * 0.2
    sd["logit_scale"] = np.asarray(np.log(50.0), np.float32)
    save_file({k: np.ascontiguousarray(v) for k, v in sd.items()}, os.path.join(tmp_path, "model.safetensors"))
    jr, pr = _clip_pair(str(tmp_path), tiny=True)
    np.testing.assert_array_equal(pr.vision.vision_model.pre_layrnorm.weight.numpy(),
                                  sd["vision_model.pre_layrnorm.weight"])
    np.testing.assert_array_equal(pr.visual_projection.numpy(), sd["visual_projection.weight"].T)
    assert float(pr.logit_scale) == float(np.float32(np.log(50.0)))
    fields = dict(prompt=PROMPTS, **_media("image"))
    _assert_scores_close(pr.compute_reward(**fields), jr.compute_reward(**fields))



# ---------------------------------------------------------------------------
# RewardBuffer (the JAX package's tests/test_rewards_advantage.py:24-110),
# each case run on the same samples and models in both packages
# ---------------------------------------------------------------------------

def _package(which: str):
    """The reward names of one package, ``"jax"`` or ``"torch"``, and a
    maker of its samples (a 3 x 4 x 4 image of each brightness)."""
    from types import SimpleNamespace

    if which == "jax":
        from flow_factory_tpu import rewards
        from flow_factory_tpu.hparams.reward_args import RewardArguments
        from flow_factory_tpu.samples import BaseSample
    else:
        from flow_factory_tpu_torch import rewards
        from flow_factory_tpu_torch.hparams.reward_args import RewardArguments
        from flow_factory_tpu_torch.samples import BaseSample
    return SimpleNamespace(
        args=RewardArguments, MyReward=rewards.MyReward, MyGroupReward=rewards.MyGroupReward,
        RewardBuffer=rewards.RewardBuffer,
        samples=lambda prompts, brightness: [BaseSample(prompt=p, image=img)
                                             for p, img in zip(prompts, _images(brightness))])


def _samples(prompts, brightness):
    return _package("torch").samples(prompts, brightness)


def _args(**kw):
    from flow_factory_tpu_torch.hparams.reward_args import RewardArguments

    return RewardArguments(**kw)


def _scored(samples) -> list:
    """Each sample's ``rewards`` dict and ``reward``, as plain floats."""
    return [({k: float(v) for k, v in s.extra_kwargs["rewards"].items()}, float(s.extra_kwargs["reward"]))
            for s in samples]


def _in_both(case) -> dict:
    """``case(pkg)`` run with each package's names: what it returns (the
    scored samples, the futures dispatched at each step) is equal between
    the two, exactly; returns the port's."""
    got = {which: case(_package(which)) for which in ("jax", "torch")}
    assert got["torch"] == got["jax"]
    return got["torch"]


def test_pointwise_buffer_sync_and_async():
    def case(pkg):
        models = [pkg.MyReward(pkg.args(name="bright", reward_model="MyReward", weight=2.0)),
                  pkg.MyReward(pkg.args(name="bright_async", reward_model="MyReward", async_reward=True,
                                        num_workers=2))]
        buf = pkg.RewardBuffer(models, group_size=2, distributed_groups=False)
        samples = pkg.samples(["a", "a", "b", "b"], [0.1, 0.2, 0.3, 0.4])
        buf.add_samples(samples[:2])
        buf.add_samples(samples[2:])
        done = _scored(buf.finalize())
        buf.cleanup()
        return {"done": done}

    for (rewards, reward), b in zip(_in_both(case)["done"], [0.1, 0.2, 0.3, 0.4]):
        assert rewards["bright"] == pytest.approx(b, abs=1e-6)
        assert rewards["bright_async"] == pytest.approx(b, abs=1e-6)
        assert reward == pytest.approx(3 * b, abs=1e-5)


@pytest.mark.parametrize("distributed_groups", [False, True])
def test_groupwise_local_rank_reward(distributed_groups):
    """Ranks within each complete group; ``distributed_groups`` at one
    process is the local path."""
    def case(pkg):
        buf = pkg.RewardBuffer([pkg.MyGroupReward(pkg.args(name="rank", reward_model="MyGroupReward"))],
                               group_size=2, distributed_groups=distributed_groups)
        buf.add_samples(pkg.samples(["a", "a", "b", "b"], [0.9, 0.1, 0.2, 0.8]))
        done = _scored(buf.finalize())
        buf.cleanup()
        return {"done": done}

    assert [r["rank"] for r, _ in _in_both(case)["done"]] == [1.0, 0.0, 0.0, 1.0]


def test_groupwise_incomplete_group_raises():
    def case(pkg):
        buf = pkg.RewardBuffer([pkg.MyGroupReward(pkg.args(name="rank", reward_model="MyGroupReward"))],
                               group_size=3, distributed_groups=False)
        buf.add_samples(pkg.samples(["a", "a"], [0.5, 0.6]))
        with pytest.raises(ValueError) as info:
            buf.finalize()
        buf.cleanup()
        return {"raised": type(info.value)}

    assert _in_both(case) == {"raised": ValueError}
    from flow_factory_tpu_torch.rewards import MyGroupReward, RewardBuffer

    buf = RewardBuffer([MyGroupReward(_args(name="rank", reward_model="MyGroupReward"))], group_size=3,
                       distributed_groups=False)
    buf.add_samples(_samples(["a", "a"], [0.5, 0.6]))
    with pytest.raises(ValueError, match="complete local groups"):
        buf.finalize()
    buf.cleanup()


def test_groupwise_across_processes_raises_naming_item_11(monkeypatch):
    from flow_factory_tpu_torch.rewards import MyGroupReward, RewardProcessor

    """Above one process named by the environment, without a process group,
    the groupwise gather raises (across ranks:
    ``tests/test_torch_port_multiprocess.py``)."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    proc = RewardProcessor([MyGroupReward(_args(name="rank", reward_model="MyGroupReward"))])
    with pytest.raises(RuntimeError, match="no process group"):
        proc.score(_samples(["a", "a"], [0.5, 0.6]), group_size=2, distributed_groups=True)


def test_async_groupwise_dispatches_complete_groups():
    def case(pkg):
        args = pkg.args(name="rank", reward_model="MyGroupReward", async_reward=True, num_workers=2)
        buf = pkg.RewardBuffer([pkg.MyGroupReward(args)], group_size=2, distributed_groups=False)
        samples = pkg.samples(["a", "b", "a", "b"], [0.9, 0.2, 0.1, 0.8])
        futures = []
        buf.add_samples(samples[:2])  # both groups incomplete: nothing dispatched
        futures.append(len(buf._futures))
        buf.add_samples(samples[2:])  # both complete: two tasks
        futures.append(len(buf._futures))
        done = _scored(buf.finalize())
        buf.cleanup()
        return {"futures": futures, "done": done}

    got = _in_both(case)
    assert got["futures"] == [0, 2]
    assert [r["rank"] for r, _ in got["done"]] == [1.0, 0.0, 0.0, 1.0]


def test_async_pointwise_batch_trigger_and_tail_flush():
    def case(pkg):
        args = pkg.args(name="bright", reward_model="MyReward", async_reward=True, batch_size=2)
        buf = pkg.RewardBuffer([pkg.MyReward(args)], group_size=1, distributed_groups=False)
        buf.add_samples(pkg.samples(["a", "b", "c"], [0.1, 0.2, 0.3]))
        futures = [len(buf._futures)]  # the full batch alone
        done = _scored(buf.finalize())
        buf.cleanup()
        return {"futures": futures, "done": done}

    got = _in_both(case)
    assert got["futures"] == [1]
    assert [r["bright"] for r, _ in got["done"]] == pytest.approx([0.1, 0.2, 0.3], abs=1e-6)


def test_finalize_pointwise_split_skips_groupwise():
    """The evaluation: one sample a prompt (no group completes) beside a
    groupwise model; ``split="pointwise"`` scores the pointwise model alone
    and does not raise."""
    def case(pkg):
        buf = pkg.RewardBuffer([pkg.MyReward(pkg.args(name="bright", reward_model="MyReward", weight=2.0)),
                                pkg.MyGroupReward(pkg.args(name="rank", reward_model="MyGroupReward"))],
                               group_size=4, distributed_groups=False)
        buf.add_samples(pkg.samples(["a", "b"], [0.25, 0.5]))
        done = _scored(buf.finalize(split="pointwise"))
        buf.clear()
        cleared = (buf.samples, buf._futures)
        buf.cleanup()
        return {"done": done, "cleared": cleared}

    got = _in_both(case)
    for (rewards, reward), b in zip(got["done"], [0.25, 0.5]):
        assert rewards["bright"] == pytest.approx(b, abs=1e-6)
        assert "rank" not in rewards
        assert reward == pytest.approx(2 * b, abs=1e-5)
    assert got["cleared"] == ([], [])


def test_async_clip_scores_equal_a_synchronous_rescoring():
    """The native CLIP reward on worker threads, a full batch dispatched from
    ``add_samples`` and the tail flushed at ``finalize``: the same scores,
    bit for bit, as a synchronous rescoring of the same samples in the same
    batches, and finite."""
    from flow_factory_tpu_torch.rewards import NativeCLIPReward, RewardBuffer, RewardProcessor

    model = NativeCLIPReward(_args(name="clip", reward_model="PickScoreNative", model_name_or_path="tiny",
                                   async_reward=True, batch_size=2), device="cpu")
    buf = RewardBuffer([model], group_size=1, distributed_groups=False)
    samples = _samples(["p", "q", "r"], [0.2, 0.5, 0.9])
    buf.add_samples(samples)
    assert len(buf._futures) == 1
    got = [s.extra_kwargs["rewards"]["clip"] for s in buf.finalize()]
    again = RewardProcessor([model])._score_pointwise(model, samples)
    assert np.all(np.isfinite(got)) and got == list(again)
    buf.cleanup()
