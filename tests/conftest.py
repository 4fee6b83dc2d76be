"""Test harness configuration: CPU with 8 virtual devices by default.

Multi-device sharding is tested on the standard JAX fake-multi-device CPU
harness (SURVEY.md §4): 8 virtual CPU devices stand in for a multi-GPU
mesh. This must run before any JAX backend initialization. A run that sets
``JAX_PLATFORMS`` itself (chip_smoke.py runs the ``gpu``-marked tests with
``JAX_PLATFORMS=cuda``) keeps its platform.

Tests marked ``gpu`` need an NVIDIA GPU: the ``_gpu_only`` fixture skips
them on any other backend, decided per test and never at import.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])


@pytest.fixture(autouse=True)
def _gpu_only(request):
    if request.node.get_closest_marker("gpu") and jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run by chip_smoke.py on the card)")

# Isolate the operator disk cache per test session: JincResizer now caches
# built operators by default (api operator_cache=True), and tests must not
# share entries with the user's real cache or with previous sessions.
import tempfile  # noqa: E402

os.environ["JINCRESIZE_CACHE_DIR"] = tempfile.mkdtemp(prefix="jincresize_test_cache_")
