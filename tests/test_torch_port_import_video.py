"""PyTorch port, the pretrained-checkpoint import (ROADMAP Queue 1 item 19,
fault F16), the video families: Wan2.1 T2V and I2V, the Wan2.2-A14B MoE's
two experts and LTX-2 T2AV each loaded from one directory in both packages
(``tests/torch_port_import_cases.py``), with their config.json."""
import pytest
from torch_port_threads import one_torch_thread  # noqa: F401

from torch_port_import_cases import cases, check_config_json_like_jax, check_import_equals_jax  # noqa: F401


@pytest.mark.parametrize("model_type", ("wan2-t2v", "wan2-i2v", "wan22", "ltx2-t2av"))
def test_import_equals_jax_through_the_bridge(cases, model_type):
    """The port's strict import of the directory equals the JAX import
    through the bridge exactly. LTX-2's strict import fails in both
    packages, on the text connectors (the JAX map has none); without strict
    both leave exactly those, and the mel VAE's halves, at their inits, and
    both move the VAE's latent statistics into its config."""
    check_import_equals_jax(cases, model_type)


@pytest.mark.parametrize("model_type", ("wan2-t2v", "wan2-i2v", "ltx2-t2av"))
def test_config_json_self_configures_like_jax(cases, model_type):
    """The DiT's, UMT5's or Gemma3's, and the VAEs' config.json give the
    port's dataclasses the JAX adapter's values on every field they share
    (Wan I2V keeps the input width its checkpoint declares; LTX-2's
    transformer takes the width its VAE declares)."""
    check_config_json_like_jax(cases, model_type)
