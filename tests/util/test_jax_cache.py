"""The persistent-compilation-cache helper shared by the CLI, bench.py and
chip_smoke.py (praline_tpu.util.jax_cache)."""

import jax
import pytest

from praline_tpu.util import jax_cache


@pytest.fixture
def restore_cache_config():
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_entry_size_bytes",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    yield
    for k, v in saved.items():
        jax.config.update(k, v)


def test_cpu_runs_cache_free(monkeypatch, restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    assert jax_cache.enable_compile_cache() is None
    assert jax.config.jax_compilation_cache_dir == before


def test_env_dir_wins_and_nothing_else_is_set(monkeypatch, tmp_path,
                                              restore_cache_config):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = (jax.config.jax_compilation_cache_dir,
              jax.config.jax_persistent_cache_min_compile_time_secs)
    assert jax_cache.enable_compile_cache() == str(tmp_path)
    assert (jax.config.jax_compilation_cache_dir,
            jax.config.jax_persistent_cache_min_compile_time_secs) == before


def test_default_dir_is_fixed_under_the_repo(monkeypatch, restore_cache_config):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = jax_cache.enable_compile_cache()
    assert got == str(jax_cache.REPO_CACHE_DIR)
    assert jax_cache.REPO_CACHE_DIR.parent.joinpath("praline_tpu").is_dir()
    assert jax.config.jax_compilation_cache_dir == got
    assert jax.config.jax_persistent_cache_min_entry_size_bytes == 0
    assert jax.config.jax_persistent_cache_min_compile_time_secs == 0.0
