"""Compile-cache location and the accelerator check shared by the scripts
that measure or drive the system on its GPU (``chip_smoke.py``,
``bench*.py``, ``tools/``)."""
from __future__ import annotations

import os
import pathlib

import jax

_CHECKOUT = pathlib.Path(__file__).resolve().parent.parent


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory:
    ``$JAX_COMPILATION_CACHE_DIR`` when set, else ``<checkout>/.jax_cache``
    (a fixed path: the directory is part of the cache key, so a path that
    moves between runs never hits)."""
    path = (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or str(_CHECKOUT / ".jax_cache"))
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path


def require_gpu():
    """Return ``jax.devices()`` if they are GPUs; raise RuntimeError
    otherwise. Measurement paths call this first, so that a run without a
    card fails instead of reporting CPU numbers."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX found {len(devices)} {devices[0].platform} "
            "device(s); this script measures the GPU and has no CPU mode")
    return devices
