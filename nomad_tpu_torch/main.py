"""Config-driven experiment dispatcher (counterpart of the repository's
``main.py``; reference ``main.py:6-44``).

    python -m nomad_tpu_torch.main --config_file nomad_tpu/configs/train_triplet.yaml

The YAML (read by ``utils.config``) names the training module
(``training_script``) and the experiment (``experiment_name``):
Training -> ``training_loop``; quality_nmr -> ``eval_audio_quality``;
valid_rank -> ``eval_degr_level``; intensity ->
``eval_degradation_intensity``; quality_fr -> ``eval_full_reference``.
The JAX package's and the reference's module paths of the triplet trainer
map to ``nomad_tpu_torch.training.triplet``; those of the speech-enhancement
demo (``nomad_tpu.training.se``, ``src.nomad_audio.nomad_loss_test``) run
``SpeechEnhancement(config).training_loop()`` and those of the smoke runner
(``nomad_tpu.smoke``, ``src.nomad_ar.nomad_score_test``,
``src.nomad_audio.nomad_score_test``) ``smoke.run(config)``, whatever the
experiment name, as the JAX package's dispatcher does. Runs on ``cuda``
unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import importlib
import sys
from typing import Optional

from .utils import config as config_io

TRIPLET = "nomad_tpu_torch.training.triplet"
SE = "nomad_tpu_torch.training.se"
SMOKE = "nomad_tpu_torch.smoke"
SCRIPT_ALIASES = {
    "nomad_tpu.training.triplet": TRIPLET,
    "src.training.train_triplet": TRIPLET,
    "nomad_tpu.training.se": SE,
    "src.nomad_audio.nomad_loss_test": SE,
    "nomad_tpu.smoke": SMOKE,
    "src.nomad_ar.nomad_score_test": SMOKE,
    "src.nomad_audio.nomad_score_test": SMOKE,
}
EXPERIMENTS = {
    "quality_nmr": "eval_audio_quality",
    "valid_rank": "eval_degr_level",
    "intensity": "eval_degradation_intensity",
    "quality_fr": "eval_full_reference",
}


def run(config_file: str, device: Optional[str] = None) -> None:
    config = config_io.load(config_file)
    script = config.get("training_script", TRIPLET)
    module_name = SCRIPT_ALIASES.get(script, script)
    module = importlib.import_module(module_name)
    if module_name == SE:
        module.SpeechEnhancement(config_file, device=device).training_loop()
        return
    if module_name == SMOKE:
        module.run(config, device=device)
        return
    experiment = config.get("experiment_name")
    train_obj = module.Training(config_file, device=device)
    if experiment == "Training":
        train_obj.training_loop()
    elif experiment in EXPERIMENTS:
        getattr(train_obj, EXPERIMENTS[experiment])(config["nomad_model_path"])
    else:
        print(f"Unknown experiment_name {experiment!r}; nothing to run", file=sys.stderr)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Run a NOMAD training or eval experiment")
    parser.add_argument("--config_file", required=True, help="experiment YAML")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    run(args.config_file, device=args.device)


if __name__ == "__main__":
    main()
