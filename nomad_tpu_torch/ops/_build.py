"""Build the CUDA kernels in ``nomad_tpu_torch/csrc`` and load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
into its own shared library, ``<name>-<hash>.so`` in the build directory
(``utils/cache.py::build_dir``: ``build/nomad_tpu_torch`` under the
checkout unless ``NOMAD_TPU_TORCH_CACHE_DIR`` names another), at first
use. The hash covers the sources and the flags, so an edited kernel
rebuilds and an unchanged one loads at once.
Libraries are loaded with ``ctypes``; the wrappers in the sibling modules
declare each entry's argument types. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from ..utils.cache import build_dir

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
KERNEL_SOURCES = ("flash_attention", "flash_attention_bf16", "flash_attention_bwd",
                  "flash_attention_bwd_bf16", "fused_attention", "fused_attention_bf16",
                  "layernorm")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    pass


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for root in (home, "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise KernelBuildError(
        "nvcc not found (PATH, CUDA_HOME): the kernels are built from "
        "nomad_tpu_torch/csrc at first use and need the CUDA toolkit"
    )


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        if src.suffix == ".cuh" or src.stem == name:
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return build_dir() / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=KERNEL_SOURCES) -> dict[str, str]:
    """Compile every named source that is not built yet, one ``nvcc`` per
    source, all started together. Returns {name: nvcc's output}, which
    holds ``ptxas``' registers, shared memory and spills per kernel (read
    back from the log of an earlier build where nothing was compiled).
    Raises ``KernelBuildError`` with nvcc's stderr when a build fails."""
    procs = {}
    for name in names:
        so = _target(name)
        so.parent.mkdir(parents=True, exist_ok=True)
        if so.is_file():
            continue
        tmp = so.with_name(f".{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, so)
    failed = []
    for name, (proc, tmp, so) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode}) ---\n{out}")
            continue
        so.with_suffix(".log").write_text(out)
        os.replace(tmp, so)  # atomic: a concurrent build loads whole files
    if failed:
        raise KernelBuildError("kernel build failed:\n" + "\n".join(failed))
    logs = {}
    for name in names:
        log = _target(name).with_suffix(".log")
        logs[name] = log.read_text() if log.is_file() else ""
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(_target(name)))
            lib.nomad_cuda_error_string.argtypes = [ctypes.c_int]
            lib.nomad_cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a C entry returned a CUDA error (its ``cudaGetLastError``
    right after the launch)."""
    if err != 0:
        msg = lib.nomad_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
