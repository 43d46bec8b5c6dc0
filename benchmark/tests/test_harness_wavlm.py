"""The WavLM cell at a size the CPU runs in seconds: its entry end to end
(``correct``, and not with an altered answer), its traced readers, and the
counts of WavLM's FLOPs, K1r's bound and the LayerNorms' bytes against
hand-worked values. Its own tiny configuration and traffic."""

import copy
import json

import pytest

from benchmark import counts, counts_wavlm, faults
from benchmark.harness import BENCHMARK_JSON, load_json
from benchmark.run import run_cell

WAVLM = {"conv_dim": [32, 32, 32], "conv_kernel": [10, 3, 2], "conv_stride": [5, 2, 2],
         "conv_bias": False, "feat_extract_norm": "layer", "do_stable_layer_norm": True,
         "hidden_size": 64, "num_layers": 2, "num_heads": 4, "ffn_dim": 128,
         "pos_conv_kernel": 16, "pos_conv_groups": 4, "layer_norm_eps": 1e-5,
         "num_buckets": 32, "max_bucket_distance": 800}
CONFIG = {"name": "tiny-wavlm", "wavlm": WAVLM, "emb_dim": 16, "precision": "exact",
          "attention_impl": "kernel"}
TRAFFIC = {"kind": "corpus", "sizes_seed": 2, "groups": [
    {"dir": "deg", "count": 5, "seconds": [1.0, 2.0], "noise": [0.01, 0.1]},
    {"dir": "nmr", "count": 3, "seconds": [0.5, 1.0], "noise": 0.005}]}
W = load_json("configs", "nomad-wavlm-large")["wavlm"]


def _cell(traced: bool):
    return run_cell("score-longform-wavlm", 2**31 + 21, 0.5, traced, device="cpu",
                    workload=copy.deepcopy(load_json("workloads", "score-longform-wavlm")),
                    config=CONFIG, traffic=TRAFFIC, spec=json.loads(BENCHMARK_JSON.read_text()))


@pytest.mark.parametrize("fault", [None, "altered_answer"])
def test_the_wavlm_cell_runs_and_its_check_sees_an_altered_answer(fault, monkeypatch):
    from nomad_tpu_torch.api import Nomad

    monkeypatch.setattr(Nomad, "score_matrix", Nomad.score_matrix)  # restored after the test
    if fault:
        faults.FAULTS[fault]()
    out = _cell(False)
    assert out["correct"] is (fault is None), out["checks"]
    assert set(out["metrics"]) == {"score_wav_s_per_s", "setup_s"}


def test_the_wavlm_cells_traced_readers():
    out = _cell(True)
    assert out["correct"], out["checks"]
    m = {k: v["value"] for k, v in out["metrics"].items()}
    # the CPU has no device trace and no engine.batch records: those
    # readers give nothing; the counts and the span log give the rest
    assert set(m) == {"mfu.wavlm", "rel_bias.host_ms_per_call.wavlm"}, m
    assert m["mfu.wavlm"] > 0 and m["rel_bias.host_ms_per_call.wavlm"] > 0


def test_wavlm_flops_against_a_hand_count():
    p = counts_wavlm.forward_flops(16000, W, 256)
    t = 49  # frames of one second: 3199, 1599, 799, 399, 199, 99, 49
    assert p["blocks"] == 24 * 2 * t * (4 * 1024 ** 2 + 2 * 1024 * 4096)
    assert p["attention"] == 24 * 4 * t * t * 1024
    assert p["gates"] == 24 * 2 * t * 16 * 64 * 8
    assert p["rel_bias"] == 24 * 2 * 16 * t * t
    assert p["proj"] == 2 * t * 512 * 1024 and p["head"] == 2 * 1024 * 256
    assert p["pos_conv"] == 2 * t * 1024 * 64 * 128
    assert p["frontend"] == counts.wav2vec2_forward_flops(16000, W, 256)["frontend"]
    # ~43 GFLOP a second of audio at T' = 1,500 (30 s files)
    per_s = sum(counts_wavlm.forward_flops(30 * 16000, W, 256).values()) / 30
    assert 40e9 < per_s < 46e9


def test_k1r_bound_is_k1s_and_the_bias():
    k1, by = counts.flash_bound(1, 1499, 16, 64, 1499)
    k1r, by_r = counts_wavlm.k1r_bound(1, 1499, 16, 64, 1499)
    assert by == by_r == "operations" and k1r > k1
    # one product and one sum a score on top of K1's 256 FLOP a score
    assert k1r == pytest.approx(k1 * (256 + 2) / 256)


def test_layernorm_bytes_against_a_hand_count():
    fr = [3199, 1599, 799, 399, 199, 99, 49]
    hand = 8 * (512 * sum(fr) + 512 * 49 + 49 * 1024 * 49)
    assert counts_wavlm.layernorm_bytes(16000, W) == hand


def test_the_wavlm_files_load_no_jax_and_the_reference_nothing_of_the_system():
    import subprocess
    import sys

    from benchmark.harness import FORBIDDEN, ROOT

    def loaded(code):
        out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(' '.join(sorted("
                              "{m.split('.')[0] for m in sys.modules})))"],
                             cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
        return set(out.stdout.split())

    mods = loaded("from benchmark import harness, counts_wavlm\n"
                  "harness.load_module('entries', 'predict_dir_wavlm')\n"
                  "import nomad_tpu_torch.api")
    assert "nomad_tpu_torch" in mods and not mods & set(FORBIDDEN)
    mods = loaded("import benchmark.reference.wavlm")
    assert "nomad_tpu_torch" not in mods and not mods & set(FORBIDDEN)


@pytest.mark.parametrize("change", [{"conv_bias": True}, {"max_bucket_distance": 64}],
                         ids=["conv_bias", "max_bucket_distance"])
def test_the_entry_refuses_a_wavlm_the_port_does_not_build(change):
    from benchmark.harness import load_module

    entry = load_module("entries", "predict_dir_wavlm")
    with pytest.raises(ValueError, match="the port's WavLM"):
        entry.make_nomad(None, CONFIG | {"wavlm": WAVLM | change}, {})
