"""Test configuration.

By default every test runs on the CPU, on a virtual 8-device mesh (XLA's
host-platform devices: the same SPMD partitioner and collectives as a real
mesh).  Pallas kernels run in interpret mode there.

Tests marked `gpu` need the card and skip elsewhere; the decision is made
in a fixture, at run time.  `python chip_smoke.py` runs them on the GPU, in
its own process, with LUW_TEST_GPU=1 (which leaves the platform alone).
"""

import os

import pytest

if not os.environ.get("LUW_TEST_GPU"):
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
os.environ.setdefault("JAX_ENABLE_X64", "0")


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Skip `gpu`-marked tests when JAX has no GPU."""
    if request.node.get_closest_marker("gpu") is not None:
        import jax

        if jax.default_backend() != "gpu":
            pytest.skip("needs a GPU (run through chip_smoke.py on the card)")
