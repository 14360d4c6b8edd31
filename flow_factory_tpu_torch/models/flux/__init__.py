"""FLUX.1 (port of ``flow_factory_tpu/models/flux``)."""
