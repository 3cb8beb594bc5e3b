import os
import sys

# tests see the default single CPU device; the dry-run (and only it) forces
# 512 fake devices in its own process.
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax

jax.config.update("jax_platform_name", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (a CUDA kernel has no CPU "
        "mode); skipped without one")
