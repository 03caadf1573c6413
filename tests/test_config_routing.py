"""Platform-derived configuration: the accelerator gate that routes fits to
the fused dense engines, the dense budget, and the compilation cache."""

import os

import jax
import numpy as np
import pytest

import cmfrec_tpu.config as config
from cmfrec_tpu.solvers import dense_pallas, drivers


@pytest.fixture
def small_problem(rng):
    m, n = 40, 30
    mask = rng.uniform(size=(m, n)) < 0.4
    rows, cols = np.nonzero(mask)
    vals = rng.normal(size=rows.size) + 3.0
    return rows, cols, vals, m, n


@pytest.fixture
def on_gpu(monkeypatch):
    """Pretend the default backend is a GPU: every gate reads
    config.on_accelerator (drivers imports it by name)."""
    monkeypatch.setattr(config, "on_accelerator", lambda: True)
    monkeypatch.setattr(drivers, "on_accelerator", lambda: True)
    monkeypatch.setenv("CMFREC_TPU_DENSE_BUDGET_GB", "1")


def _record(monkeypatch, name):
    """Replace one fused-engine entry point with a recorder."""
    calls = []

    def fake(*args, **kwargs):
        calls.append(kwargs)
        return {"engine": name}

    monkeypatch.setattr(dense_pallas, name, fake)
    return calls


@pytest.mark.parametrize("use_cg", [True, False])
def test_gpu_routes_explicit_to_fused_engine(on_gpu, monkeypatch,
                                             small_problem, use_cg):
    """Explicit CG and exact mode (use_cg=False) both take the fused dense
    engine on the GPU; exact mode is flagged to it."""
    calls = _record(monkeypatch, "fit_explicit_dense_pallas")
    res = drivers.fit_explicit_als(*small_problem, k=4, niter=2,
                                   use_cg=use_cg, scale_lam=True)
    assert res == {"engine": "fit_explicit_dense_pallas"}
    assert calls[0]["exact"] is (not use_cg)


def test_gpu_routes_implicit_to_fused_engine(on_gpu, monkeypatch,
                                             small_problem):
    calls = _record(monkeypatch, "fit_implicit_dense_pallas")
    rows, cols, vals, m, n = small_problem
    drivers.fit_implicit_als(rows, cols, np.abs(vals), m, n, k=4, niter=2)
    assert len(calls) == 1 and calls[0]["exact"] is False


def test_gpu_routes_collective_to_fused_engine(on_gpu, monkeypatch,
                                               small_problem):
    from cmfrec_tpu.solvers.collective import fit_collective_explicit_als

    calls = _record(monkeypatch, "fit_collective_dense_pallas")
    res = fit_collective_explicit_als(*small_problem, k=4, niter=2,
                                      add_implicit_features=True)
    assert res["engine"] == "fit_collective_dense_pallas"
    assert len(calls) == 1 and calls[0]["add_implicit_features"] is True


def test_cpu_keeps_plain_engines(monkeypatch, small_problem):
    """On the CPU the fused engine is never chosen: CG fits take the XLA
    dense engine."""
    assert not config.on_accelerator()
    calls = _record(monkeypatch, "fit_explicit_dense_pallas")
    res = drivers.fit_explicit_als(*small_problem, k=4, niter=2)
    assert not calls and np.isfinite(np.asarray(res["A"])).all()


def test_gpu_over_budget_goes_bucketed(on_gpu, monkeypatch, small_problem):
    """A padded dense form larger than the budget leaves the fused engine
    for the bucketed one."""
    class Bucketed(Exception):
        pass

    def build_pair(*args, **kwargs):
        raise Bucketed

    monkeypatch.setenv("CMFREC_TPU_DENSE_BUDGET_GB", "1e-6")
    monkeypatch.setattr(drivers, "_build_pair", build_pair)
    calls = _record(monkeypatch, "fit_explicit_dense_pallas")
    with pytest.raises(Bucketed):
        drivers.fit_explicit_als(*small_problem, k=4, niter=1)
    assert not calls


class _FakeDevice:
    def memory_stats(self):
        return {"bytes_limit": 60 * (1 << 30), "bytes_in_use": 0}


def test_dense_budget_from_device_memory(monkeypatch):
    monkeypatch.delenv("CMFREC_TPU_DENSE_BUDGET_GB", raising=False)
    monkeypatch.setattr(config, "on_accelerator", lambda: True)
    monkeypatch.setattr(config.jax, "devices", lambda: [_FakeDevice()])
    assert config.dense_budget_bytes() == int(
        config.DENSE_BUDGET_FRACTION * 60 * (1 << 30))


def test_dense_budget_cpu_and_override(monkeypatch):
    monkeypatch.delenv("CMFREC_TPU_DENSE_BUDGET_GB", raising=False)
    assert config.dense_budget_bytes() == int(6.5 * (1 << 30))
    monkeypatch.setenv("CMFREC_TPU_DENSE_BUDGET_GB", "2")
    monkeypatch.setattr(config, "on_accelerator", lambda: True)
    assert config.dense_budget_bytes() == 2 * (1 << 30)


@pytest.fixture
def restore_cache_config():
    old_dir = jax.config.jax_compilation_cache_dir
    old_min = jax.config.jax_persistent_cache_min_compile_time_secs
    yield
    jax.config.update("jax_compilation_cache_dir", old_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", old_min)


def test_compile_cache_follows_env(monkeypatch, tmp_path,
                                   restore_cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", None)
    assert config.enable_persistent_compilation_cache() == str(tmp_path)
    # JAX reads the variable itself; nothing else is set here
    assert jax.config.jax_compilation_cache_dir is None


def test_compile_cache_defaults_to_checkout(monkeypatch,
                                            restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = config.enable_persistent_compilation_cache()
    assert path == os.path.join(root, ".jax_cache")
    assert os.path.isdir(path)
    assert jax.config.jax_compilation_cache_dir == path
