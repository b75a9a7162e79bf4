"""Persistent compile-cache wiring (utils/compile_cache.py): policy
parsing, the opt-out, directory precedence (JAX_COMPILATION_CACHE_DIR over
everything, then an explicit path, then ACX_COMPILE_CACHE, then the fixed
<checkout>/.jax_cache), and that scanner construction tolerates every
setting."""

import os

import pytest

import aho_corasick_1975_tpu as ac
from aho_corasick_1975_tpu.utils import compile_cache as cc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def fresh_cache(monkeypatch):
    """A fresh module latch; afterwards the suite's hermetic setting (no
    cache directory, ACX_COMPILE_CACHE=off) is restored."""
    import jax
    from jax.experimental.compilation_cache import compilation_cache
    monkeypatch.setattr(cc, "_auto_done", False)
    monkeypatch.setattr(cc, "_active", None)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    yield
    compilation_cache.reset_cache()
    jax.config.update("jax_compilation_cache_dir", None)
    monkeypatch.setenv("ACX_COMPILE_CACHE", "off")
    monkeypatch.setattr(cc, "_auto_done", True)
    monkeypatch.setattr(cc, "_active", None)


def test_enabled_parsing(monkeypatch):
    for v, want in [("off", False), ("0", False), ("no", False),
                    ("FALSE", False), ("", True), ("on", True),
                    ("/tmp/somewhere", True)]:
        monkeypatch.setenv("ACX_COMPILE_CACHE", v)
        assert cc._enabled() is want, v


def test_cache_dir_resolution(monkeypatch):
    monkeypatch.setenv("ACX_COMPILE_CACHE", "/tmp/acx-cache-test")
    assert cc._cache_dir() == "/tmp/acx-cache-test"
    # the default is a fixed directory inside the checkout
    monkeypatch.setenv("ACX_COMPILE_CACHE", "on")
    assert cc._cache_dir() == os.path.join(REPO, ".jax_cache")
    monkeypatch.delenv("ACX_COMPILE_CACHE")
    assert cc._cache_dir() == os.path.join(REPO, ".jax_cache")


def test_enable_is_idempotent_and_off_respects_env(monkeypatch, tmp_path):
    # the suite runs with ACX_COMPILE_CACHE=off (conftest): the latch is
    # already set by earlier scanner constructions and must return None
    assert cc.enable_compile_cache() is None
    # a fresh latch with the env opt-out also disables
    monkeypatch.setattr(cc, "_auto_done", False)
    monkeypatch.setenv("ACX_COMPILE_CACHE", "off")
    assert cc.enable_compile_cache() is None
    # construction still works under the opt-out
    m = ac.Machine()
    m.insert_keyword("he")
    assert m.scanner(n_streams=4).count("hehe") == 2


def test_enable_with_explicit_path(monkeypatch, tmp_path, fresh_cache):
    """With a fresh latch and a writable dir the cache engages; jax
    accepts the directory config on the CPU backend too."""
    import jax

    monkeypatch.setenv("ACX_COMPILE_CACHE", str(tmp_path / "xla"))
    got = cc.enable_compile_cache()
    assert got == str(tmp_path / "xla")
    assert (tmp_path / "xla").is_dir()
    assert jax.config.jax_compilation_cache_dir == str(tmp_path / "xla")


def test_jax_env_dir_wins_and_is_not_overridden(monkeypatch, tmp_path,
                                                fresh_cache):
    """JAX_COMPILATION_CACHE_DIR set: that directory is the cache, and the
    module updates no directory config (JAX reads the variable itself)."""
    import jax
    from jax.experimental.compilation_cache import compilation_cache

    env_dir = str(tmp_path / "from-env")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
    monkeypatch.setenv("ACX_COMPILE_CACHE", str(tmp_path / "acx"))
    before = jax.config.jax_compilation_cache_dir

    def refuse(*a, **k):
        raise AssertionError("cache directory overridden")

    monkeypatch.setattr(compilation_cache, "set_cache_dir", refuse)
    assert cc.enable_compile_cache() == env_dir
    assert cc.enable_compile_cache(str(tmp_path / "explicit")) == env_dir
    assert jax.config.jax_compilation_cache_dir == before
    assert not (tmp_path / "acx").exists()


def test_default_dir_is_checkout_cache(monkeypatch, fresh_cache):
    """No variable set: the cache lives at <checkout>/.jax_cache."""
    import jax

    monkeypatch.setenv("ACX_COMPILE_CACHE", "on")
    want = os.path.join(REPO, ".jax_cache")
    assert cc.enable_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want


def test_explicit_path_honoured_after_automatic_call(monkeypatch, tmp_path,
                                                     fresh_cache):
    """The automatic (scanner) call latches; a later explicit path does
    not — it takes effect, and a later explicit disable does too."""
    import jax

    monkeypatch.setenv("ACX_COMPILE_CACHE", "off")
    assert cc.enable_compile_cache() is None        # the scanners' call
    assert cc.enable_compile_cache() is None        # latched
    monkeypatch.setenv("ACX_COMPILE_CACHE", "on")
    got = cc.enable_compile_cache(str(tmp_path / "later"))
    assert got == str(tmp_path / "later")
    assert jax.config.jax_compilation_cache_dir == got
    assert cc.enable_compile_cache() == got         # latch reports it
    assert cc.enable_compile_cache(enabled=False) is None
    assert jax.config.jax_compilation_cache_dir is None


def test_unwritable_cache_dir_degrades_to_disabled(monkeypatch,
                                                   fresh_cache):
    """Scanner construction must not fail because the cache directory
    cannot be created (read-only checkout)."""
    monkeypatch.setenv("ACX_COMPILE_CACHE", "/proc/acx-cannot-exist/x")
    assert cc.enable_compile_cache() is None
    m = ac.Machine()
    m.insert_keyword("he")
    assert m.scanner(n_streams=4).count("hehe") == 2
    # repeat calls report the real outcome (None), not a phantom dir
    assert cc.enable_compile_cache() is None
