"""The one place that decides which backend the program runs on.

- Platform: ``PANGENIE_TPU_PLATFORM=cpu|gpu`` selects JAX's platform;
  unset, JAX's own default applies. A requested GPU that is missing is
  an error, never a silent run on the CPU.
- Accelerator queries: whether the default device is an accelerator,
  and how many bytes of device memory are free on it.
- The HMM dtype: float32 on an accelerator, float64 on the CPU (the
  reference's long-double bit-parity path); ``PANGENIE_TPU_DTYPE``
  overrides either way.
- The persistent compile cache: ``JAX_COMPILATION_CACHE_DIR`` when it
  is set, otherwise one fixed directory inside the checkout.
"""

from __future__ import annotations

import os

import jax

_PLATFORMS = {"cpu": "cpu", "gpu": "cuda"}
_ENV_PLATFORM = "PANGENIE_TPU_PLATFORM"

# fixed, so that every process of every run finds what an earlier one
# compiled (the cache key does not survive a moving directory)
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def requested_platform() -> str | None:
    """The platform ``PANGENIE_TPU_PLATFORM`` asks for, or None."""
    value = os.environ.get(_ENV_PLATFORM, "").strip().lower()
    if not value:
        return None
    if value not in _PLATFORMS:
        raise RuntimeError(
            f"{_ENV_PLATFORM}={value!r} is not supported; "
            f"choose one of {sorted(_PLATFORMS)}."
        )
    return value


def cpu_only() -> bool:
    """True when the process is held to the CPU by
    ``PANGENIE_TPU_PLATFORM`` or ``JAX_PLATFORMS``."""
    if requested_platform() is not None:
        return requested_platform() == "cpu"
    return os.environ.get("JAX_PLATFORMS", "").strip().lower() == "cpu"


def configure() -> None:
    """Apply the platform request and the compile cache to JAX's config.

    Runs when the package is imported, before any backend starts."""
    wanted = requested_platform()
    if wanted is not None:
        jax.config.update("jax_platforms", _PLATFORMS[wanted])
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        # with the variable set, JAX reads it itself
        jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)


def check_platform(found: str, wanted: str | None) -> None:
    """Raise unless the device platform JAX resolved is the one asked
    for."""
    if wanted is not None and found != wanted:
        raise RuntimeError(
            f"{_ENV_PLATFORM}={wanted} but JAX runs on {found!r}; "
            "refusing to continue on another device."
        )


def platform() -> str:
    """Start the backend and return the default device's platform
    ("cpu" or "gpu"). Raises when a requested GPU is not there."""
    wanted = requested_platform()
    try:
        found = jax.devices()[0].platform
    except Exception as e:  # JAX raises more than RuntimeError here
        raise RuntimeError(
            f"JAX backend failed to start ({_ENV_PLATFORM}="
            f"{wanted or 'unset'}; is the device there?): {e!r}"
        ) from e
    check_platform(found, wanted)
    return found


def is_accelerator() -> bool:
    """True when the default device is not the host CPU."""
    return platform() != "cpu"


def device_bytes_free(device=None) -> int:
    """Bytes of device memory this process may still allocate.

    On an accelerator: ``bytes_limit - bytes_in_use`` from the device's
    own memory stats; a device that reports none is an error. On the
    CPU, device memory is host memory: the host's available bytes."""
    if device is None:
        platform()
        device = jax.devices()[0]
    if device.platform == "cpu":
        return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    stats = device.memory_stats()
    if not stats or "bytes_limit" not in stats:
        raise RuntimeError(
            f"device {device} ({device.platform}) reports no memory "
            "stats; cannot size device buffers."
        )
    return int(stats["bytes_limit"]) - int(stats.get("bytes_in_use", 0))


def hmm_dtype():
    """HMM dtype: float32 on an accelerator, float64 on the CPU.

    float64 keeps the reference's bit-parity on the CPU; the float32
    path's genotype likelihoods agree with it within the bound that
    ``chip_smoke.py`` checks. ``PANGENIE_TPU_DTYPE=float32|float64``
    overrides either way."""
    import jax.numpy as jnp

    env = os.environ.get("PANGENIE_TPU_DTYPE", "").lower()
    if env in ("float32", "f32"):
        return jnp.float32
    if env in ("float64", "f64"):
        return jnp.float64
    return jnp.float32 if is_accelerator() else jnp.float64
