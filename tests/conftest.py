import os

# Tests run on the real single CPU device — the 512-device override belongs
# ONLY to repro.launch.dryrun (see its module docstring).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: launches the port's CUDA kernels; skips without a "
        "CUDA card")
