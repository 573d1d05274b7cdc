"""Run-time setup shared by the measurement scripts (``chip_smoke.py``,
``bench.py``): the persistent compile cache, the GPU requirement, and the
card's identity as NVML reports it.

Importing this module touches no JAX backend; each function does only what
its name says, when it is called.
"""

from __future__ import annotations

import ctypes
import os
from typing import List


def configure_compile_cache(root: str) -> str:
    """Point JAX's persistent compile cache at a fixed directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is set here.  Otherwise the cache lives at ``<root>/.jax_cache``
    (a fixed path: the directory is part of the cache key, so a moving one
    never hits).  Returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    path = os.path.join(os.path.abspath(root), ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def require_gpu():
    """Return ``jax.devices()`` if they are GPUs; otherwise raise
    ``RuntimeError`` naming the platform found.  Measurements never fall
    back to another backend."""
    import jax
    devices = jax.devices()
    platform = devices[0].platform
    if platform != "gpu":
        raise RuntimeError(
            f"a GPU is required, JAX found platform {platform!r} "
            f"({devices[0].device_kind})")
    return devices


class _NVML:
    """The few NVML calls needed to name a card and its power limit."""

    def __init__(self):
        self.lib = ctypes.CDLL("libnvidia-ml.so.1")
        self._check(self.lib.nvmlInit_v2())

    def _check(self, rc):
        if rc != 0:
            self.lib.nvmlErrorString.restype = ctypes.c_char_p
            raise RuntimeError(
                f"NVML error {rc}: {self.lib.nvmlErrorString(rc).decode()}")

    def cards(self) -> List[str]:
        count = ctypes.c_uint()
        self._check(self.lib.nvmlDeviceGetCount_v2(ctypes.byref(count)))
        out = []
        for i in range(count.value):
            handle = ctypes.c_void_p()
            self._check(self.lib.nvmlDeviceGetHandleByIndex_v2(
                ctypes.c_uint(i), ctypes.byref(handle)))
            name = ctypes.create_string_buffer(96)
            self._check(self.lib.nvmlDeviceGetName(handle, name,
                                                   ctypes.c_uint(96)))
            limit_mw = ctypes.c_uint()
            self._check(self.lib.nvmlDeviceGetPowerManagementLimit(
                handle, ctypes.byref(limit_mw)))
            out.append(format_card(name.value.decode(), limit_mw.value))
        return out

    def close(self):
        self.lib.nvmlShutdown()


def format_card(name: str, limit_mw: int) -> str:
    """One card in the form of ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader``: ``"<name>, <watts with 2 decimals> W"``."""
    return f"{name}, {limit_mw / 1000:.2f} W"


def gpu_cards() -> List[str]:
    """Name and power limit of every GPU on this host, one string each, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` prints
    them (read through NVML, without a child process)."""
    nvml = _NVML()
    try:
        return nvml.cards()
    finally:
        nvml.close()
