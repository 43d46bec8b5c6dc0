"""The loss steps on bf16 activations at "exact" (K1-bf16 forward, the
"highest" backward on bf16 tensors), as phase 14 of ``chip_smoke.py`` runs
them, with 7 warm steps each: BASE and fused BASE, 32 x 16,384 and 24 x
160,000 samples, each held to its plain path and timed through
``chip_smoke.run_loss_path``. Needs a CUDA card.

Run from the root of a checkout, so that two checkouts can be timed in
turns in one call (parent, this, this, parent):

    python3 -c "import runpy; runpy.run_path('<this checkout>/scripts/bf16_loss_steps.py')"

Prints, on its last line, "loss turns: " and one JSON object {path: step
median ms, host enqueue median ms, peak GB}.
"""

import json
import sys

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402  (the checkout's own smoke, from its root)

cs.set_exact_precision()
card = cs.card_info()
sd = cs.init_weights(cs.NomadModel(cs.Wav2Vec2Config.base(), emb_dim=256), seed=0).state_dict()
cs.report.setdefault("launches", {})
for impl, tag, want in (
        ("kernel", "base_bf16", cs.launches_want(k1_io=24, k2_io=12, k3_io=12, k5=4, k5_io=48)),
        ("fused_qkv", "fused_base_bf16",
         cs.launches_want(k4h_io=24, k1_io=12, k2_io=12, k3_io=12, k5=4, k5_io=48))):
    config = cs.mode_config("exact_bf16", attention_impl=impl)
    for key, n, samples in ((f"loss_path_{tag}", cs.LOSS_BATCH, cs.LOSS_SAMPLES),
                            (f"loss_path_10s_{tag}", cs.LOSS10_BATCH, cs.LOSS10_SAMPLES)):
        cs.run_loss_path(card, key, config, want, n, samples, "exact_bf16", sd, plain_impl=impl,
                         steps=7)
print("loss turns: " + json.dumps({
    k: {"step_median_ms": r["step_median_s"] * 1e3,
        "host_enqueue_median_ms": float(cs.np.median(r["host_enqueue_s"])) * 1e3,
        "peak_mem_gb": r["peak_mem_gb"]}
    for k, r in cs.report.items() if k.startswith("loss_path")}))
