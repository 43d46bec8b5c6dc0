"""Where the port builds (``nomad_tpu_torch/utils/cache.py``), in the JAX
cache's order (``tests/test_cache.py``'s directory tests): the environment
variable, then the checkout's workspace, then ``~/.cache`` for an
installed or unwritable tree; read when a library is built, not at
import."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from nomad_tpu_torch.io import native
from nomad_tpu_torch.ops import _build
from nomad_tpu_torch.utils import cache

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture()
def home(tmp_path, monkeypatch):
    monkeypatch.delenv(cache.ENV_VAR, raising=False)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    return tmp_path / "home" / ".cache" / "nomad_tpu_torch" / "build"


def test_default_build_dir_is_the_workspace(home):
    ws = ROOT / "build" / "nomad_tpu_torch"
    assert cache.workspace_dir() == ws
    assert cache.build_dir() == ws and ws.is_dir()
    assert not (ws / f".w{os.getpid()}").exists(), "the writability probe is left behind"


def test_env_var_wins(monkeypatch, tmp_path):
    monkeypatch.setenv(cache.ENV_VAR, str(tmp_path / "x"))
    assert cache.build_dir() == tmp_path / "x"
    # the build routines read it when they build, not at import
    assert _build._target("layernorm").parent == tmp_path / "x"
    assert native.library_path().parent == tmp_path / "x"


def test_installed_tree_falls_back_to_home(home, monkeypatch, tmp_path):
    site = tmp_path / "site-packages"  # no .git, no pyproject.toml
    site.mkdir()
    monkeypatch.setattr(cache, "PACKAGE_ROOT", site)
    assert cache.workspace_dir() is None
    assert cache.build_dir() == home
    assert not (site / "build").exists()


def test_unwritable_workspace_falls_back_to_home(home, monkeypatch, tmp_path):
    tree = tmp_path / "checkout"
    tree.mkdir()
    (tree / "pyproject.toml").write_text("")
    (tree / "build").write_text("")  # a file where the directory would go
    monkeypatch.setattr(cache, "PACKAGE_ROOT", tree)
    assert cache.workspace_dir() == tree / "build" / "nomad_tpu_torch"
    assert cache.build_dir() == home


def test_probe_name_is_per_process(home, monkeypatch, tmp_path):
    """Another process's probe (here a directory no file can replace) does
    not push this one to the home directory, as a shared name would."""
    tree = tmp_path / "checkout"
    ws = tree / "build" / "nomad_tpu_torch"
    (ws / ".w").mkdir(parents=True)
    (ws / f".w{os.getpid() + 1}").mkdir()
    (tree / ".git").mkdir()
    monkeypatch.setattr(cache, "PACKAGE_ROOT", tree)
    assert cache.build_dir() == ws
    assert sorted(p.name for p in ws.iterdir()) == [".w", f".w{os.getpid() + 1}"]


def test_native_library_builds_into_the_env_dir(tmp_path):
    """A process with the variable set builds the native library there
    (g++, seconds) and loads it."""
    code = ("from nomad_tpu_torch.io import native\n"
            "assert native.available(), native.build_error()\n"
            "print(native.library_path())\n")
    env = {**os.environ, cache.ENV_VAR: str(tmp_path / "fresh")}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, check=True,
                         capture_output=True, text=True, timeout=300).stdout.strip()
    so = Path(out)
    assert so.parent == tmp_path / "fresh" and so.is_file()
    assert so.name.startswith("libnomad_native-") and so.suffix == ".so"
