import os

# Unit tests run on a virtual 8-device CPU mesh — deterministic, fast, and
# exercising the same sharding code paths the driver validates multi-chip.
# The env var alone is overridden by the installed TPU plugin, so force the
# platform through jax.config as well (must happen before any jax use).
if "--xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
    )
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU; skips without one "
        "(on the card: python -m pytest tests/test_torch_cuda.py -m cuda)",
    )
