"""Cells at a size the CPU runs in seconds: the tiny wav2vec 2.0 of the
port's unit tests, a 2-level Wave-U-Net and a few short files, with the
cells' own entries and limits."""

import copy
import json

from benchmark.harness import BENCHMARK_JSON, load_json

W2V = {"conv_dim": [32, 32, 32], "conv_kernel": [10, 3, 2], "conv_stride": [5, 2, 2],
       "hidden_size": 64, "num_layers": 2, "num_heads": 4, "ffn_dim": 128,
       "pos_conv_kernel": 16, "pos_conv_groups": 4, "layer_norm_eps": 1e-5}
NOMAD = {"name": "tiny", "wav2vec2": W2V, "emb_dim": 16, "precision": "exact",
         "attention_impl": "kernel"}
SE = {"name": "tiny-se", "waveunet": {"n_layers": 2, "channels_interval": 24},
      "lossnet": NOMAD, "recipe": dict(load_json("configs", "waveunet-se-nomad")["recipe"],
                                       train_bs=4)}
TRAFFIC = {
    "score-corpus": {"kind": "corpus", "sizes_seed": 1, "groups": [
        {"dir": "deg", "count": 6, "seconds": [0.5, 1.5], "noise": [0.01, 0.1]},
        {"dir": "nmr", "count": 3, "seconds": [0.5, 1.0], "noise": 0.005}]},
    "loss-10s": {"kind": "loss_pairs", "batch": 4, "samples": 8000, "pool": 2,
                 "clean_noise": 0.005, "estimate_noise": [0.01, 0.1]},
    "se-train": {"kind": "se_pairs", "sizes_seed": 3, "count": 12, "seconds": [1.1, 1.5],
                 "clean_noise": 0.005, "noisy_noise": [0.01, 0.1]},
}


def cell(name: str) -> dict:
    """Keyword arguments of ``run.run_cell`` for the tiny version of a cell."""
    workload = copy.deepcopy(load_json("workloads", name))
    if "check" in workload:
        workload["check"]["rows"] = 2
    return {"workload": workload, "config": SE if name == "se-train" else NOMAD,
            "traffic": TRAFFIC[name], "spec": json.loads(BENCHMARK_JSON.read_text())}
