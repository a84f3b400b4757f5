"""Test configuration: force an 8-device virtual CPU mesh.

Tests never require an accelerator — sharded paths run on
``--xla_force_host_platform_device_count=8`` CPU devices, and numeric golden
tests run in float64 on CPU (the GPU path is float32; golden tests pin the
math, not the precision).  Tests that need the card carry the ``gpu``
marker and skip here.
"""

import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
if "--xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] += " --xla_force_host_platform_device_count=8"

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
