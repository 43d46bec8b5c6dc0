"""Nothing the benchmark loads is JAX or the JAX package (top-level names
compared whole), and the reference loads nothing of the system under
test."""

import ast
import subprocess
import sys

from benchmark.harness import BENCH, FORBIDDEN, ROOT


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_of_the_benchmark_imports_jax():
    for path in BENCH.rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & set(FORBIDDEN), (path, tops & set(FORBIDDEN))


def test_the_reference_imports_nothing_of_the_system():
    for path in (BENCH / "reference").rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert "nomad_tpu_torch" not in tops, path


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(' '.join(sorted("
                          "{m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(out.stdout.split())


def test_a_process_of_the_benchmark_holds_no_jax():
    code = ("import benchmark.run, benchmark.control, benchmark.readers\n"
            "from benchmark import harness\n"
            "for e in ('predict_dir', 'loss_steps', 'se_epochs'):\n"
            "    harness.load_module('entries', e)\n"
            "import nomad_tpu_torch.api, nomad_tpu_torch.training.se")
    mods = _loaded(code)
    assert "nomad_tpu_torch" in mods and not mods & set(FORBIDDEN), mods & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_system():
    mods = _loaded("import benchmark.reference.wav2vec2, benchmark.reference.waveunet, "
                   "benchmark.reference.wav")
    assert "nomad_tpu_torch" not in mods and not mods & set(FORBIDDEN)


def test_the_guard_compares_whole_names(monkeypatch):
    from benchmark import harness

    monkeypatch.setitem(sys.modules, "nomad_tpu_torch_x", sys)
    assert harness.forbidden_modules() == [] or "nomad_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert "jaxlib" in harness.forbidden_modules()


def test_without_a_card_the_command_fails_and_prints_no_result():
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "score-corpus",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    import torch

    if torch.cuda.is_available():
        return  # on the card the command runs; this test is about its refusal
    assert out.returncode != 0 and out.stdout.strip() == ""
