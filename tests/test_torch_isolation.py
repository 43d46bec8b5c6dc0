"""The port stands alone: nothing in ``nomad_tpu_torch`` or ``chip_smoke.py``
imports JAX, flax or the JAX package, nor pandas, click, tqdm or PyYAML,
which the card's machine lacks; and its entry points run on the card
unless the caller asks for the CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import nomad_tpu_torch.api as tapi

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "nomad_tpu", "pandas", "click", "tqdm", "yaml"}
# torch.hub imports tqdm itself when it is installed (as here, not on the
# card's machine): the port's own imports of it are caught by the source scan
NOT_LOADED = FORBIDDEN - {"tqdm"}


def _port_sources():
    # the gloo tests' rank functions run in spawned ranks of the port alone
    files = sorted((ROOT / "nomad_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tests" / "torch_dist_workers.py"]
    assert len(files) > 10
    return files


def test_no_jax_imports_in_the_port():
    bad = []
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(ROOT)}:{node.lineno} {n}"
                    for n in names if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, nomad_tpu_torch.api, nomad_tpu_torch.__main__, nomad_tpu_torch.parallel\n"
        "import nomad_tpu_torch.scoring.large_scale, nomad_tpu_torch.graft_entry\n"
        "import nomad_tpu_torch.utils.degrader_drivers, nomad_tpu_torch.utils.nsim_sampling\n"
        "import nomad_tpu_torch.ops.wirecodec, nomad_tpu_torch.utils.cache\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{sorted(NOT_LOADED)!r})\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_no_cpu_fallback_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tapi.Nomad(device=device)
    with pytest.raises(ValueError, match="not supported"):
        tapi.Nomad(device="mps")
    assert tapi.Nomad(device="cpu").device == torch.device("cpu")
