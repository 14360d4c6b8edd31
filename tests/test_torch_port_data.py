"""PyTorch port, data: the K-repeat samplers, the fingerprint-cached
preprocessed dataset and the loaders, against the JAX package's on the same
seeds and the same prompts (``tests/fixtures/tiny_prompts``). Host code
only; no model runs here."""
import copy
import os

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN = os.path.join(REPO, "tests/fixtures/tiny_prompts/train.txt")


def _features(batch):
    """A stand-in for the prompt encoder, the same in both packages: a fixed-
    shape array per prompt from its bytes and a ragged per-prompt field."""
    codes = [np.frombuffer(p.encode(), np.uint8).astype(np.float32) for p in batch["prompt"]]
    return {"prompt_embeds": np.stack([np.resize(c, (4, 8)) / 255.0 for c in codes]),
            "token_ids": [c[: 3 + i] for i, c in enumerate(codes)]}


def _assert_rows_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        elif isinstance(a[k], list) and a[k] and isinstance(a[k][0], np.ndarray):
            assert len(a[k]) == len(b[k]) and all(np.array_equal(x, y) for x, y in zip(a[k], b[k])), k
        else:
            assert a[k] == b[k], k


def test_preprocessed_dataset_matches_jax_and_hits_its_cache(tmp_path):
    """The same records, the same fingerprinted cache directory name, the
    same rows one by one and gathered, ragged fields included; a second
    build with the same inputs reads the cache without preprocessing."""
    from flow_factory_tpu.data.dataset import GeneralDataset as JDataset
    from flow_factory_tpu_torch.data import GeneralDataset

    calls = []

    def counted(batch):
        calls.append(len(batch["prompt"]))
        return _features(batch)

    kw = dict(func_kwargs={"max_len": 8}, model_id="tiny", batch_size=4)
    theirs = JDataset(TRAIN, "train").preprocess(counted, str(tmp_path / "jax"), **kw)
    ours = GeneralDataset(TRAIN, "train").preprocess(counted, str(tmp_path / "port"), **kw)
    assert os.path.basename(ours.cache_path) == os.path.basename(theirs.cache_path)
    assert len(ours) == len(theirs) == 6 and sorted(ours.arrays) == ["prompt_embeds"]
    for i in range(len(ours)):
        _assert_rows_equal(ours[i], theirs[i])
    _assert_rows_equal(ours.get_batch([3, 0, 5, 5]), theirs.get_batch([3, 0, 5, 5]))
    n_calls = len(calls)
    again = GeneralDataset(TRAIN, "train").preprocess(counted, str(tmp_path / "port"), **kw)
    assert len(calls) == n_calls and again.cache_path == ours.cache_path
    _assert_rows_equal(again.get_batch(list(range(6))), ours.get_batch(list(range(6))))


@pytest.mark.parametrize("sampler_type,M,K,Bsz,W", [
    ("group_contiguous", 4, 4, 8, 1),
    ("group_contiguous", 4, 2, 2, 2),
    ("distributed_k_repeat", 9, 4, 6, 2),
    ("group_distributed", 6, 4, 4, 2),
])
def test_samplers_match_jax(sampler_type, M, K, Bsz, W):
    """Every rank's index batches for epochs 0-2 (M may exceed the dataset
    size, which cycles it)."""
    from flow_factory_tpu.data.sampler import get_data_sampler as jget
    from flow_factory_tpu_torch.data import get_data_sampler

    for rank in range(W):
        kw = dict(dataset_size=6, unique_sample_num=M, group_size=K, batch_size=Bsz, num_replicas=W,
                  rank=rank, seed=42)
        ours, theirs = get_data_sampler(sampler_type, **kw), jget(sampler_type, **kw)
        assert len(ours) == len(theirs) > 0
        for epoch in range(3):
            ours.set_epoch(epoch)
            theirs.set_epoch(epoch)
            assert list(ours) == list(theirs)


def test_dataloaders_match_jax(tmp_path):
    """``get_dataloader`` on the same config with ``sampler_type: auto``: the
    same resolved sampler and, for two epochs, the same train batches
    (indices, prompts, preprocessed arrays); the same test batches."""
    from flow_factory_tpu.data.loader import get_dataloader as jget
    from flow_factory_tpu.hparams.args import Arguments as JArgs
    from flow_factory_tpu.parallel.dist import set_world_size_override
    from flow_factory_tpu_torch.data import get_dataloader
    from flow_factory_tpu_torch.hparams import Arguments

    cfg = {"data": {"dataset_dir": os.path.dirname(TRAIN), "sampler_type": "auto", "preprocessing_batch_size": 4},
           "model": {"model_type": "sd3-5", "model_name_or_path": "tiny"},
           "train": {"resolution": 32, "per_device_batch_size": 2, "group_size": 2,
                     "unique_sample_num_per_epoch": 3, "seed": 7},
           "eval": {"per_device_batch_size": 2}}
    loaders = []
    for args, get, sub in ((Arguments, get_dataloader, "port"), (JArgs, jget, "jax")):
        set_world_size_override(1)  # the JAX Arguments resolve the world size when built
        try:
            config = args.from_dict(copy.deepcopy(cfg))
            config.data_args.cache_dir = str(tmp_path / sub)
            loaders.append((config.data_args.sampler_type, *get(config, _features)))
        finally:
            set_world_size_override(None)
    (ours_type, ours, ours_test), (theirs_type, theirs, theirs_test) = loaders
    assert ours_type == theirs_type
    assert len(ours) == len(theirs) == 3
    for epoch in range(2):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        for a, b in zip(ours, theirs):
            _assert_rows_equal(a, b)
    assert ours_test is not None and theirs_test is not None
    for a, b in zip(ours_test, theirs_test):
        _assert_rows_equal(a, b)
