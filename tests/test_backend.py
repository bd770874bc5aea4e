"""backend.py: platform choice, accelerator queries, compile cache.

The platform and cache checks run in fresh interpreters: JAX reads its
platform and cache settings once, at start-up.
"""

import os
import subprocess
import sys
import types

import jax.numpy as jnp
import pytest

from pangenie_tpu import backend

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _python(code: str, **env_extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "PANGENIE_TPU_PLATFORM",
                        "JAX_COMPILATION_CACHE_DIR")}
    env.update(env_extra)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, "-c", code], env=env, cwd=REPO,
        capture_output=True, text=True, timeout=300,
    )


def test_gpu_requested_without_gpu_raises():
    proc = _python(
        "from pangenie_tpu import backend; backend.platform()",
        PANGENIE_TPU_PLATFORM="gpu",
    )
    assert proc.returncode != 0
    assert "PANGENIE_TPU_PLATFORM=gpu" in proc.stderr


def test_cpu_requested_runs_on_cpu():
    proc = _python(
        "from pangenie_tpu import backend; print(backend.platform(), "
        "backend.is_accelerator())",
        PANGENIE_TPU_PLATFORM="cpu",
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["cpu", "False"]


@pytest.mark.parametrize("value", ["rocm", "cuda0"])
def test_unknown_platform_value_rejected(monkeypatch, value):
    monkeypatch.setenv("PANGENIE_TPU_PLATFORM", value)
    with pytest.raises(RuntimeError, match="not supported"):
        backend.requested_platform()


def test_check_platform_refuses_another_device():
    backend.check_platform("gpu", "gpu")
    backend.check_platform("cpu", None)
    with pytest.raises(RuntimeError, match="refusing"):
        backend.check_platform("cpu", "gpu")


def test_compile_cache_honours_env(tmp_path):
    proc = _python(
        "import pangenie_tpu, jax; print(jax.config.jax_compilation_cache_dir)",
        JAX_PLATFORMS="cpu", JAX_COMPILATION_CACHE_DIR=str(tmp_path),
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == str(tmp_path)


def test_compile_cache_default_is_fixed_in_checkout():
    proc = _python(
        "import pangenie_tpu, jax; print(jax.config.jax_compilation_cache_dir)",
        JAX_PLATFORMS="cpu",
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == os.path.join(REPO, ".jax_cache")
    assert backend.DEFAULT_CACHE_DIR == os.path.join(REPO, ".jax_cache")


def _fake_device(platform, stats):
    return types.SimpleNamespace(platform=platform,
                                 memory_stats=lambda: stats)


@pytest.mark.parametrize("stats", [None, {}, {"bytes_in_use": 5}])
def test_accelerator_without_memory_stats_is_an_error(stats):
    with pytest.raises(RuntimeError, match="memory stats"):
        backend.device_bytes_free(_fake_device("gpu", stats))


def test_device_bytes_free_from_memory_stats():
    dev = _fake_device("gpu", {"bytes_limit": 1000, "bytes_in_use": 250})
    assert backend.device_bytes_free(dev) == 750


def test_device_bytes_free_on_cpu_is_host_memory():
    assert backend.device_bytes_free() > 0


def test_cpu_only_reads_both_variables(monkeypatch):
    monkeypatch.delenv("PANGENIE_TPU_PLATFORM", raising=False)
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    assert backend.cpu_only()
    monkeypatch.setenv("JAX_PLATFORMS", "")
    assert not backend.cpu_only()
    monkeypatch.setenv("PANGENIE_TPU_PLATFORM", "gpu")
    assert not backend.cpu_only()
    monkeypatch.setenv("PANGENIE_TPU_PLATFORM", "cpu")
    assert backend.cpu_only()


def test_hmm_dtype_follows_the_device(monkeypatch):
    monkeypatch.delenv("PANGENIE_TPU_DTYPE", raising=False)
    assert backend.hmm_dtype() == jnp.float64
    monkeypatch.setattr(backend, "platform", lambda: "gpu")
    assert backend.hmm_dtype() == jnp.float32


def test_multi_process_on_gpus_needs_one_card_each(monkeypatch):
    from pangenie_tpu.parallel import distributed as dist

    monkeypatch.setenv("PANGENIE_TPU_PLATFORM", "gpu")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,1")
    with pytest.raises(RuntimeError, match="one card per process"):
        dist._check_one_card_per_process()
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "1")
    dist._check_one_card_per_process()
    monkeypatch.setenv("PANGENIE_TPU_PLATFORM", "cpu")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    dist._check_one_card_per_process()
