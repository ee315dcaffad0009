"""Test harness config: force CPU with a virtual 8-device mesh.

Must run before jax is imported anywhere (SURVEY.md section 4: multi-device tests
via xla_force_host_platform_device_count).  The program itself runs on the GPU;
tests stay hermetic on CPU.  Tests that need the card carry the ``gpu`` marker
and skip here (see ``gpu_device`` below); chip_smoke.py runs the card checks.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu_device():
    """The first GPU device, or skip: decided when the test runs, never at
    import time, so every xdist worker collects the same tests."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs a GPU; chip_smoke.py runs this check on the card")
    return devs[0]
