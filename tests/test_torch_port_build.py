"""PyTorch port, on the CPU: the key of a built kernel library. Each
``ops/csrc/*.cu`` builds into ``build/lib<name>-<key>.so``; the key hashes
the source, every ``csrc`` header it includes (directly or through another
header) and the flags, so an edited header builds a new library instead of
loading a stale one. Checked on a temporary copy of ``csrc``; no ``nvcc``
is needed."""
import shutil

import pytest

from flow_factory_tpu_torch.ops import cuda_build

SOURCES = ("flash_bwd", "flash_fwd", "qknorm_flash_fwd")


@pytest.fixture
def csrc(tmp_path):
    return shutil.copytree(cuda_build.CSRC, tmp_path / "csrc")


def _keys(csrc):
    return {name: cuda_build.library_path(name, csrc).name for name in SOURCES}


def test_the_sources_and_their_headers():
    names = lambda n: [p.name for p in cuda_build._sources(cuda_build.CSRC / f"{n}.cu")]
    assert names("flash_bwd") == ["flash_bwd.cu", "hopper.cuh"]
    assert names("flash_fwd") == ["flash_fwd.cu", "flash_fwd_f32.cuh", "flash_fwd_wgmma.cuh", "hopper.cuh"]
    assert names("qknorm_flash_fwd") == ["qknorm_flash_fwd.cu", "flash_fwd_f32.cuh", "flash_fwd_wgmma.cuh",
                                         "hopper.cuh"]


def test_a_copy_keys_as_the_package_does(csrc):
    assert _keys(csrc) == {n: cuda_build.library_path(n).name for n in SOURCES}


@pytest.mark.parametrize("header,changed", [
    ("hopper.cuh", set(SOURCES)),                             # included by all three
    ("flash_fwd_wgmma.cuh", {"flash_fwd", "qknorm_flash_fwd"}),  # by the forwards only
    ("flash_fwd_f32.cuh", {"flash_fwd", "qknorm_flash_fwd"}),    # the fp32 forwards' template too
])
def test_editing_a_header_changes_the_keys_of_the_sources_that_include_it(csrc, header, changed):
    before = _keys(csrc)
    with open(csrc / header, "a") as f:
        f.write("// edited\n")
    after = _keys(csrc)
    assert {n for n in SOURCES if after[n] != before[n]} == changed


def test_editing_a_source_changes_its_key_alone(csrc):
    before = _keys(csrc)
    with open(csrc / "flash_fwd.cu", "a") as f:
        f.write("// edited\n")
    after = _keys(csrc)
    assert {n for n in SOURCES if after[n] != before[n]} == {"flash_fwd"}
