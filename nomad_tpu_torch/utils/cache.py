"""Where the port keeps what it builds: the CUDA kernels' shared libraries
(``ops/_build.py``) and the native ingest library (``io/native.py``), each
named by a hash of its sources and flags, so an unchanged source loads at
once and an edited one builds anew.

The counterpart of ``nomad_tpu.utils.cache``, in the same order (first hit
wins):
  1. the ``NOMAD_TPU_TORCH_CACHE_DIR`` environment variable;
  2. ``<checkout>/build/nomad_tpu_torch`` when the package sits in a
     checkout (``.git`` or ``pyproject.toml`` beside it) and the directory
     can be written; ``.gitignore`` lists it;
  3. ``~/.cache/nomad_tpu_torch/build`` otherwise (an installed package, a
     read-only checkout).

Both build routines call :func:`build_dir` when they first build or load,
never at import. The JAX module's other members (``enable_compilation_cache``,
``cached_compile_guard``, ``cpu_compile_bypass``) manage XLA's persistent
compilation cache; PyTorch compiles nothing per shape, so they have no
counterpart.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

ENV_VAR = "NOMAD_TPU_TORCH_CACHE_DIR"
PACKAGE_ROOT = Path(__file__).resolve().parents[2]  # the directory that holds the package


def home_dir() -> Path:
    return Path(os.path.expanduser("~")) / ".cache" / "nomad_tpu_torch" / "build"


def workspace_dir() -> Optional[Path]:
    """``<checkout>/build/nomad_tpu_torch``, or None when the package is
    not in a checkout (an installed distribution: no cache beside
    site-packages, even where it could be written)."""
    if not any((PACKAGE_ROOT / marker).exists() for marker in (".git", "pyproject.toml")):
        return None
    return PACKAGE_ROOT / "build" / "nomad_tpu_torch"


def build_dir() -> Path:
    """The build directory, by the order in the module docstring."""
    env = os.environ.get(ENV_VAR)
    if env:
        return Path(env)
    ws = workspace_dir()
    if ws is None:
        return home_dir()
    try:
        ws.mkdir(parents=True, exist_ok=True)
        # a name of this process's own: two processes starting together
        # must not both race on one probe file and fall back
        probe = ws / f".w{os.getpid()}"
        probe.touch()
        probe.unlink()
        return ws
    except OSError:
        return home_dir()
