"""The L1-L4 parity harness of the port (JAX ``flow_factory_tpu/parity``);
``python -m flow_factory_tpu_torch.parity`` is its command line."""
from .harness import (DEFAULT_TOLERANCES, PROBE_COND_SEED, PROBE_PROMPTS, PROBE_SEED, ParityHarness,
                      ParityReport, ProbeInputs, _diff_config, compare_records)

__all__ = ["DEFAULT_TOLERANCES", "PROBE_COND_SEED", "PROBE_PROMPTS", "PROBE_SEED", "ParityHarness",
           "ParityReport", "ProbeInputs", "_diff_config", "compare_records"]
