"""Test configuration: hermetic CPU backend with 8 virtual devices.

Tests run on the CPU backend even where a GPU is present; multi-device
sharding tests run on a virtual 8-device CPU mesh (SURVEY.md §4). Tests
marked ``gpu`` therefore skip here; chip_smoke.py runs them on the card.
Must run before jax imports.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# pin the config too, in case jax was imported before this file ran
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
