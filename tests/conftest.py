"""Test configuration: run everything on a simulated 8-device CPU mesh.

The distributed code paths are exercised on a host-CPU mesh (SURVEY.md §4).
Both variables must be set before JAX is first imported. On a machine with
a GPU, ``BSM_TESTS_ON_GPU=1 python -m pytest tests -m gpu`` leaves JAX its
default backend so that the tests marked ``gpu`` run on the card.
"""

import os

if not os.environ.get("BSM_TESTS_ON_GPU"):
    os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    )

import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _skip_gpu_tests_off_gpu(request):
    """Tests marked ``gpu`` run only where JAX finds a GPU (decided per
    test, never at import, so every worker collects the same tests)."""
    if request.node.get_closest_marker("gpu") is not None:
        import jax

        if jax.default_backend() != "gpu":
            pytest.skip("needs an NVIDIA GPU (compiled kernel, no "
                        "interpret mode)")
