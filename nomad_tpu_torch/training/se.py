"""Speech-enhancement demo: a Wave-U-Net trained with MSE + the NOMAD
perceptual loss (counterpart of ``nomad_tpu.training.se``; reference
``nomad_loss_test.py:33-156``, BASELINE config 3).

  * ``SpeechEnhancement(config, device=None, nomad=None)`` reads a config
    dict or a YAML file of the configs' subset (``utils.config``), e.g.
    ``nomad_tpu/configs/se_config.yaml``. It runs on ``cuda`` unless
    ``device="cpu"``, and raises without CUDA rather than fall back to the
    CPU.
  * The lossnet is a frozen ``api.Nomad`` on the same device (``nomad=None``
    resolves it through ``api.get_nomad``; ``model_size: tiny`` gives the
    tiny config with a 16-wide embedding). ``loss_dropout: true`` raises:
    the JAX package's ``loss_fn_p`` cannot run the dropout loss either.
  * A train step: the U-Net in ``train()`` mode (batch statistics, the
    running ones updated once), ``mse(est, clean) + nomad_weight ·
    nomad.loss_fn(est, clean)``, backward into the U-Net alone and one
    ``torch.optim.Adam(lr)`` step (β 0.9/0.999, eps 1e-8: ``optax.adam``).
    On the card the lossnet's forwards run K1 and K5 and its backward K2
    and K3 (K1b, K2b and K3b for a lossnet in "balanced" or "fast", e.g.
    ``nomad=Nomad(precision="balanced")``, the JAX SE's own default); the
    clean forward records no graph, since neither its input nor the
    frozen lossnet needs a gradient.
  * The eval step, ``loss_components`` and ``enhance`` run the U-Net in
    ``eval()`` mode under ``no_grad``. ``test``/``quality`` score PESQ-WB:
    pip's ``pesq`` where installed, else the port's copy
    (``utils/pesq.py``).
  * ``training_loop``: ``se_models/<dd-mm-YYYY_HH-MM-SS>/config.yaml`` and
    ``best_model.npz`` (the JAX package's flat ``params/…`` +
    ``batch_stats/…`` layout, ``convert.waveunet_to_jax``), early stop
    after ``patience`` epochs without a better valid loss, and the test
    set every ``test_every`` epochs.
"""

from __future__ import annotations

import os
from datetime import datetime
from typing import Optional

import numpy as np
import torch

from ..api import Nomad, get_nomad, resolve_device, set_exact_precision
from ..convert import jax_to_waveunet, waveunet_to_jax
from ..models import Wav2Vec2Config, WaveUNet
from ..utils import config as config_io
from .data import PairedAudioDataset
from .losses import epoch_mean


def si_sdr(estimate: np.ndarray, clean: np.ndarray, eps: float = 1e-8) -> float:
    """Scale-invariant SDR in dB, the mean over the batch."""
    est = estimate.reshape(estimate.shape[0], -1)
    ref = clean.reshape(clean.shape[0], -1)
    ref_energy = np.sum(ref * ref, axis=-1, keepdims=True) + eps
    proj = (np.sum(est * ref, axis=-1, keepdims=True) / ref_energy) * ref
    noise = est - proj
    ratio = (np.sum(proj**2, axis=-1) + eps) / (np.sum(noise**2, axis=-1) + eps)
    return float(np.mean(10.0 * np.log10(ratio)))


def _try_pesq_batch(sr, ref, deg):
    """Mean PESQ-WB over a batch: pip's C extension when installed (the
    ITU code), else the port's P.862 implementation (``utils/pesq.py``)."""
    try:
        from pesq import pesq_batch
    except ImportError:
        from ..utils.pesq import pesq_batch

        scores = pesq_batch(sr, np.asarray(ref), np.asarray(deg), mode="wb")
        return float(np.mean(scores))
    scores = pesq_batch(fs=sr, ref=ref, deg=deg, mode="wb")
    return float(np.mean([x for x in np.asarray(scores).ravel()
                          if isinstance(x, float) or np.isreal(x)]))


class SpeechEnhancement:
    def __init__(self, config, device: Optional[str] = None, nomad: Optional[Nomad] = None):
        self.config = dict(config) if isinstance(config, dict) else config_io.load(config)
        config = self.config
        if config.get("loss_dropout", False):
            raise NotImplementedError(
                "loss_dropout: true (dropout inside the loss network) is not supported: "
                "the JAX package's Nomad.loss_fn_p passes no dropout rng, so flax raises "
                "InvalidRngError at its first step too; set loss_dropout: false"
            )
        self.device = resolve_device(device)
        set_exact_precision()
        self.sr = int(config.get("target_sr", 16000))

        if nomad is None:
            if config.get("model_size") == "tiny":
                nomad = get_nomad(device=str(self.device), config=Wav2Vec2Config.tiny(),
                                  emb_dim=16)
            else:
                nomad = get_nomad(device=str(self.device))
        if nomad.device != self.device:
            raise ValueError(f"the NOMAD lossnet is on {nomad.device}, the SE runs on "
                             f"{self.device}")
        self.nomad = nomad
        self.nomad_weight = float(config.get("nomad_weight", 0.001))

        self.unet = WaveUNet(n_layers=int(config.get("n_layers", 12))).to(self.device)
        self.optimizer = torch.optim.Adam(self.unet.parameters(), lr=float(config.get("lr", 1e-4)),
                                          betas=(0.9, 0.999), eps=1e-8)

        def mkset(noisy_key, clean_key):
            return PairedAudioDataset(config[noisy_key], config[clean_key], self.sr)

        self.train_set = mkset("noisy_train_dir", "clean_train_dir")
        self.valid_set = mkset("noisy_valid_dir", "clean_valid_dir")
        self.test_set = mkset("noisy_test_dir", "clean_test_dir")

    # ------------- steps -------------

    def _dev(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32).to(self.device)

    def objective(self, noisy, clean) -> torch.Tensor:
        """mse(est, clean) + nomad_weight · NOMAD(est, clean) of the U-Net
        in its current mode."""
        clean = self._dev(clean)
        est = self.unet(self._dev(noisy))
        mse = torch.mean((est - clean) ** 2)
        return mse + self.nomad_weight * self.nomad.loss_fn(est, clean)

    def train_step(self, noisy, clean) -> torch.Tensor:
        """One Adam step on a batch; returns the loss, still on the device."""
        self.unet.train()
        loss = self.objective(noisy, clean)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    def eval_step(self, noisy, clean) -> torch.Tensor:
        self.unet.eval()
        with torch.no_grad():
            return self.objective(noisy, clean)

    def loss_components(self) -> tuple:
        """(mse, nomad_raw) of the current model on the first training batch:
        the unweighted magnitudes of the two loss terms, to pick a balanced
        ``nomad_weight`` for a lossnet of another output scale."""
        noisy, clean = next(self.train_set.batches(int(self.config.get("train_bs", 32)),
                                                   shuffle=False))
        est = self.enhance(noisy)
        clean = self._dev(clean)
        with torch.no_grad():
            mse = float(torch.mean((est - clean) ** 2))
            return mse, float(self.nomad.loss_fn(est, clean))

    def enhance(self, noisy) -> torch.Tensor:
        """The U-Net in eval mode on [B, T] or [B, 1, T] noisy waveforms."""
        self.unet.eval()
        with torch.no_grad():
            return self.unet(self._dev(noisy))

    # ------------- epochs -------------

    def train(self, seed: int = 0) -> float:
        """One epoch over the training pairs, shuffled with ``seed``."""
        return epoch_mean([self.train_step(noisy, clean) for noisy, clean in
                           self.train_set.batches(int(self.config.get("train_bs", 32)),
                                                  shuffle=True, seed=seed)])

    def eval(self) -> float:
        return epoch_mean([self.eval_step(noisy, clean) for noisy, clean in
                           self.valid_set.batches(int(self.config.get("valid_bs", 100)),
                                                  shuffle=False)])

    def test(self) -> dict:
        """PESQ-WB of the test split."""
        return self.quality(self.test_set)

    def quality(self, dataset: PairedAudioDataset) -> dict:
        """Enhancement quality of any paired split: PESQ-WB (SI-SDR where no
        PESQ score comes back)."""
        ests, cleans = [], []
        for noisy, clean in dataset.batches(int(self.config.get("test_bs", 100)), shuffle=False):
            ests.append(self.enhance(noisy).cpu().numpy())
            cleans.append(clean)
        est, clean = np.concatenate(ests), np.concatenate(cleans)
        pesq = _try_pesq_batch(self.sr, clean, est)
        if pesq is not None:
            return {"metric": "pesq_wb", "value": pesq}
        return {"metric": "si_sdr_db", "value": si_sdr(est, clean)}

    def training_loop(self) -> None:
        config = self.config
        dt_string = datetime.now().strftime("%d-%m-%Y_%H-%M-%S")
        self.PATH_DIR = os.path.join("se_models", dt_string)
        os.makedirs(self.PATH_DIR, exist_ok=True)
        config_io.dump(config, os.path.join(self.PATH_DIR, "config.yaml"))

        best_valid_loss = np.inf
        counter = 0
        for i in range(int(config.get("num_epochs", 99))):
            print("\n")
            train_loss = self.train(seed=i)
            valid_loss = self.eval()
            if valid_loss < best_valid_loss:
                self.save(os.path.join(self.PATH_DIR, "best_model.npz"))
                best_valid_loss = valid_loss
                print("Saved Weights Success")
                counter = 0
            else:
                counter += 1
            print(f"COUNTER:  {counter}/{config.get('patience')}")
            if counter > int(config.get("patience", 50)):
                print("Stop training, counter greater than patience")
                break
            print(f"EPOCHS: {i+1} train_loss : {train_loss}")
            print(f"EPOCHS: {i+1} valid_loss : {valid_loss}")
            if (i + 1) % int(config.get("test_every", 10)) == 0:
                print("Test set evaluation")
                res = self.test()
                print(f"EPOCHS: {i+1} {res['metric']} : {res['value']}")

    # ------------- checkpoints -------------

    def save(self, path: str) -> None:
        """The JAX package's SE checkpoint: its ``SpeechEnhancement.load``
        reads it."""
        np.savez(path, **waveunet_to_jax(self.unet.state_dict()))

    def load(self, path: str) -> None:
        with np.load(path) as flat:
            self.load_flat(dict(flat))

    def load_flat(self, flat: dict) -> None:
        """U-Net parameters and running statistics from the JAX package's
        flat dict (``params/…``, ``batch_stats/…``)."""
        self.unet.load_state_dict(jax_to_waveunet(flat), strict=True)
