"""Test configuration: force JAX onto a virtual 8-device CPU mesh.

Kernel tests run the Pallas kernel in interpret mode on CPU; sharding tests
use the 8 virtual devices (`--xla_force_host_platform_device_count`), per
SURVEY.md §4. The platform is also pinned via jax.config, in case jax was
imported before this file ran.

``HAVAC_TEST_GPU=1`` leaves the platform alone, so the ``gpu``-marked tests
can run on the card (chip_smoke.py sets it and runs them in its own
process).
"""

import os

if os.environ.get("HAVAC_TEST_GPU") == "1":
    import jax
else:
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()

    import jax

    jax.config.update("jax_platforms", "cpu")

    assert len(jax.devices()) >= 8, (
        f"tests require 8 virtual CPU devices, got {jax.devices()}"
    )
