"""The persistent compile cache lives where JAX_COMPILATION_CACHE_DIR says,
or at one fixed path inside the checkout."""

import os

import jax

from havac.utils import compile_cache


def test_env_var_set_configures_nothing(monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere")
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    assert compile_cache.enable_compile_cache() == "/elsewhere"
    assert calls == []


def test_env_var_unset_uses_the_fixed_checkout_path(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.enable_compile_cache()
        assert path == compile_cache.DEFAULT_DIR
        assert jax.config.jax_compilation_cache_dir == path
        repo = os.path.dirname(os.path.dirname(os.path.abspath(
            compile_cache.__file__)))
        assert path == os.path.join(os.path.dirname(repo), ".jax_cache")
        # Same path on every call: no process id, time or temp name in it.
        assert compile_cache.enable_compile_cache() == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_engine_construction_enables_the_cache(monkeypatch):
    from havac.engine import Havac

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        jax.config.update("jax_compilation_cache_dir", None)
        Havac(backend="xla")
        assert (jax.config.jax_compilation_cache_dir
                == compile_cache.DEFAULT_DIR)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
