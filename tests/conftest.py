"""Test harness: pin JAX to a simulated 8-device CPU mesh.

Kernels run with CPU lowering (Pallas kernels in interpret mode) and dist/
tests get 8 fake devices for Mesh/shard_map collectives.  Tests marked
``gpu`` need the card: on a GPU machine ``python -m pytest tests -m gpu``
leaves the platform to JAX, and the ``gpu`` fixture skips them anywhere
else.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    # Before any backend touch: jax.config wins over a JAX_PLATFORMS value
    # set by the environment.
    if config.getoption("markexpr") != "gpu":
        os.environ["JAX_PLATFORMS"] = "cpu"
        jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu():
    """Skip the test unless JAX runs on a GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: run `python -m pytest tests -m gpu` on the card")


@pytest.fixture
def triton_interpret(monkeypatch):
    """Run the "triton" backend of align_pairs_batched on the CPU: scores-only dispatches
    take the lane kernel (kernels.lane_dp) in interpret mode."""
    import functools

    from praline_tpu.kernels import batch, lane_dp

    monkeypatch.setattr(batch, "resolve_backend", lambda backend: "triton")
    monkeypatch.setattr(
        lane_dp, "lane_dp_scores",
        functools.partial(lane_dp.lane_dp_scores, interpret=True),
    )


@pytest.fixture(autouse=True)
def _bound_jit_code_maps():
    """Keep the process under the kernel's mmap-region limit.

    Every compiled XLA:CPU executable holds JIT code pages in their own
    mmap regions, and the full suite compiles thousands of distinct
    shapes; past ``vm.max_map_count`` (65530 default) further mmaps fail
    and LLVM segfaults mid-compile (observed: nondeterministic
    ``Fatal Python error: Segmentation fault`` in
    ``backend_compile_and_load`` ~75% into the suite).  Clearing JAX's
    executable caches releases the regions (verified: 1719 -> 532 maps),
    at the cost of recompiles in later tests.
    """
    yield
    try:
        with open(f"/proc/{os.getpid()}/maps") as f:
            n = sum(1 for _ in f)
    except OSError:
        return
    if n > 40_000:
        jax.clear_caches()
