"""Build a CUDA source of ``csrc/`` into a shared library and load it.

The kernels have a plain C interface: ``nvcc`` compiles each ``.cu`` file on
its own (seconds, no PyTorch headers) into ``build/kernels/`` at the root of
the checkout, and ``ctypes`` loads it.  :func:`build_kernels` starts one
``nvcc`` per source, all at once.  The library's name carries a hash of
its source, of the ``csrc/*.cuh`` headers and of the flags, so an edited
kernel is rebuilt and an unchanged one is reused.

Each library links nvcc's default static CUDA runtime: its own copy, beside
the one PyTorch loaded.  So every entry point takes the device index of its
tensors and makes that device current for its launch
(``csrc/launch_device.cuh``) rather than rely on the runtime state PyTorch
leaves on the thread.

Nothing here runs at import time: a kernel module calls :func:`load_kernel`
on its first CUDA launch, so a machine without ``nvcc`` or a GPU can import
the whole package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_loaded: dict[str, ctypes.CDLL] = {}
build_seconds: dict[str, float] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine "
                       "with the CUDA toolkit (PATH or CUDA_HOME)")


def _lib_path(name: str) -> Path:
    parts = [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]      # the headers it may include
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in parts)
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_kernels(names) -> None:
    """Build the libraries of ``csrc/<name>.cu`` for every name that has
    none yet: one ``nvcc`` per source, all started together.  Each build's
    wall time lands in ``build_seconds[name]`` (0.0 when reused)."""
    t0 = time.perf_counter()
    running = {}
    for name in names:
        build_seconds[name] = 0.0
        lib_path = _lib_path(name)
        if lib_path.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        running[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True),
                         tmp, lib_path)
    failed = []
    for name, (proc, tmp, lib_path) in running.items():
        out, err = proc.communicate()
        build_seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{out}\n{err}")
        else:
            os.replace(tmp, lib_path)
    if failed:
        raise RuntimeError("\n".join(failed))


def load_kernel(name: str) -> ctypes.CDLL:
    """Return the loaded library built from ``csrc/<name>.cu``, building it
    first if ``build/kernels/`` has none for this source."""
    if name not in _loaded:
        if not _lib_path(name).exists():
            build_kernels([name])
        _loaded[name] = ctypes.CDLL(str(_lib_path(name)))
    return _loaded[name]
