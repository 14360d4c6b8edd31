"""PyTorch port, parity inputs: the committed ``tests/goldens_torch`` files
of these goldens equal what ``tools/export_parity_inputs.py`` computes now
from the JAX package (its tiny adapter's weights, the rollout's x0 and
noise, the L2 ``sde_step`` probe's noise), bit for bit. The goldens are
spread over tests/test_torch_port_parity_fresh_{1,2,3,4}.py, a JAX adapter
build each."""
import pytest
from torch_port_threads import one_torch_thread  # noqa: F401

import torch_port_parity_cases as C

NAMES = ["flux2", "flux2_klein", "z_image", "qwen_image"]


@pytest.fixture(autouse=True, scope="module")
def _isolated():
    """The JAX package's world-size override is process-wide: reset it before
    and after this module (F0)."""
    from flow_factory_tpu.parallel.dist import set_world_size_override

    set_world_size_override(None)
    yield
    set_world_size_override(None)


@pytest.mark.parametrize("name", NAMES)
def test_committed_inputs_are_the_export_tools_output(name, tmp_path):
    C.assert_inputs_fresh(name, tmp_path)
