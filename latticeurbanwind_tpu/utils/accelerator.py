"""Accelerator environment probing — analog of core/accelerator_runtime.py.

The reference probes/repairs CUDA wheel layouts for numba and checks OpenCL
ICDs; here we probe the JAX backend, its devices (kind, count, memory), the
persistent compilation cache, and the native toolchain, emitting the same
style of JSON environment report the pipeline logs.

The persistent compilation cache is configured here and nowhere else
(`configure_compile_cache`).
"""

from __future__ import annotations

import json
import os
import shutil
import sys
from pathlib import Path
from typing import Optional

# <checkout>/.jax_cache, listed in .gitignore
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def compile_cache_dir() -> str:
    """`JAX_COMPILATION_CACHE_DIR` when set, else `<checkout>/.jax_cache`."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(DEFAULT_CACHE_DIR)


def configure_compile_cache() -> str:
    """Point JAX's persistent compilation cache at `compile_cache_dir()`.

    Production grids take tens of seconds to compile; the cache makes later
    processes start in seconds.  Called by the solver entry points before
    they compile."""
    import jax

    path = compile_cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path


def device_report() -> dict:
    """Backend and device facts as JAX reports them: kind, count, memory."""
    import jax

    devices = jax.devices()
    report = {
        "backend": jax.default_backend(),
        "device_kind": devices[0].device_kind,
        "device_count": len(devices),
        "devices": [str(d) for d in devices],
        "memory_bytes_limit": None,
    }
    stats = devices[0].memory_stats() or {}
    if "bytes_limit" in stats:
        report["memory_bytes_limit"] = int(stats["bytes_limit"])
    return report


def probe_environment() -> dict:
    report = {
        "python": sys.version.split()[0],
        "jax": None,
        "compilation_cache": compile_cache_dir(),
        "native_toolchain": {
            "g++": shutil.which("g++"),
            "cmake": shutil.which("cmake"),
            "ninja": shutil.which("ninja"),
        },
        "errors": [],
    }
    try:
        import jax

        report["jax"] = jax.__version__
        report.update(device_report())
    except Exception as e:   # noqa: BLE001 — the report names the failure
        report["errors"].append(f"jax: {type(e).__name__}: {e}")
        return report
    try:
        from ..utils.native import load

        report["native_library"] = "loaded" if load() is not None else "unavailable"
    except Exception as e:   # noqa: BLE001
        report["errors"].append(f"native: {type(e).__name__}: {e}")
    return report


def apply_runtime_environment(cache_dir: Optional[str] = None) -> dict:
    """Set up the recommended runtime env (persistent compile cache)."""
    if cache_dir:
        os.environ["JAX_COMPILATION_CACHE_DIR"] = cache_dir
    configure_compile_cache()
    return probe_environment()


def main(argv=None) -> int:
    print(json.dumps(probe_environment(), indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
