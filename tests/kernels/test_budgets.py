"""Dispatch byte budgets: fractions of the memory the device reports (a
device that reports none is an error), fixed constants on the CPU, and a
per-problem byte model that bounds what the XLA route really holds."""

import types

import jax
import jax.numpy as jnp
import pytest

from praline_tpu.kernels import batch as batch_mod

A = 23


@pytest.fixture
def fresh_memory_cache():
    batch_mod.device_memory_bytes.cache_clear()
    yield
    batch_mod.device_memory_bytes.cache_clear()


def _fake_devices(monkeypatch, stats):
    dev = types.SimpleNamespace(platform="gpu", device_kind="Fake GPU",
                                memory_stats=lambda: stats)
    monkeypatch.setattr(jax, "devices", lambda *a: [dev])


def test_cpu_reports_no_memory(fresh_memory_cache):
    assert batch_mod.device_memory_bytes() is None
    for name in ("HS", "TB", "DISPATCH"):
        assert batch_mod._budget(name) == getattr(batch_mod, f"{name}_BYTES_BUDGET")


def test_gpu_memory_is_its_bytes_limit(monkeypatch, fresh_memory_cache):
    _fake_devices(monkeypatch, {"bytes_limit": 64_000_000_000, "bytes_in_use": 0})
    assert batch_mod.device_memory_bytes() == 64_000_000_000
    assert batch_mod._budget("HS") == 4_000_000_000
    assert batch_mod._budget("TB") == 8_000_000_000
    assert batch_mod._budget("DISPATCH") == 32_000_000_000


@pytest.mark.parametrize("stats", [None, {}, {"bytes_in_use": 5}])
def test_gpu_without_a_memory_limit_is_an_error(monkeypatch, fresh_memory_cache,
                                                stats):
    _fake_devices(monkeypatch, stats)
    with pytest.raises(RuntimeError, match="reports no memory limit"):
        batch_mod.device_memory_bytes()


@pytest.mark.parametrize("traceback", [False, True])
@pytest.mark.parametrize("bx,by", [(63, 63), (127, 127), (255, 255),
                                   (63, 255), (255, 63)])
def test_byte_model_bounds_the_compiled_dispatch(bx, by, traceback):
    """XLA's own buffer assignment for an indexed dispatch (temporaries
    plus outputs, per problem) stays within per_problem_bytes."""
    B = 64
    lens = jax.ShapeDtypeStruct((32,), jnp.int32)
    ix = jax.ShapeDtypeStruct((B,), jnp.int32)
    s = jax.ShapeDtypeStruct((A, A), jnp.float32)
    sides = [(jax.ShapeDtypeStruct((32, b, A), jnp.uint8),
              jax.ShapeDtypeStruct((32, b), jnp.float32)) for b in (bx, by)]
    (sx, ivx), (sy, ivy) = sides
    compiled = batch_mod._indexed_jit().lower(
        sx, ivx, lens, sy, ivy, lens, ix, ix, s, gap_series=(11, 1),
        mode="global", traceback=traceback, backend="xla", replay=traceback,
        onehot_x=False, onehot_y=False, A=A,
    ).compile()
    ma = compiled.memory_analysis()
    held = ma.temp_size_in_bytes + ma.output_size_in_bytes
    score_bytes, tb_bytes = batch_mod.per_problem_bytes(bx, by)
    assert held / B <= score_bytes + (tb_bytes if traceback else 0)
