"""Faults planted in the system under test, for the check's own tests:
each breaks the timed path underneath a run, which must then come out
not correct. ``FAULTS[name]()`` patches the port in this process."""

from __future__ import annotations


def altered_answer() -> None:
    """One score altered where it is produced: the distance matrix's first
    element moves by 0.01."""
    from nomad_tpu_torch.api import Nomad

    inner = Nomad.score_matrix

    def score_matrix(self, nmr_paths, test_paths):
        m = inner(self, nmr_paths, test_paths).copy()
        m.flat[0] += 0.01
        return m

    Nomad.score_matrix = score_matrix


def half_batch_loss() -> None:
    """The loss over half of the batch, its mean taken over the rest."""
    from nomad_tpu_torch.api import Nomad

    inner = Nomad.loss_fn

    def loss_fn(self, estimate, clean, deterministic=True):
        h = max(1, estimate.shape[0] // 2)
        return inner(self, estimate[:h], clean[:h], deterministic)

    Nomad.loss_fn = loss_fn


def _from_step(after: int, sound, broken):
    """A ``train_step`` that is ``sound`` for its first ``after`` calls in
    this process and ``broken`` from then on: a fault that starts only
    once set-up's steps are over."""
    calls = [0]

    def train_step(self, noisy, clean):
        calls[0] += 1
        return (sound if calls[0] <= after else broken)(self, noisy, clean)

    return train_step


def half_batch_step(after: int = 0) -> None:
    """The SE step on half of the batch, its mean taken over the rest."""
    from nomad_tpu_torch.training.se import SpeechEnhancement

    inner = SpeechEnhancement.train_step

    def broken(self, noisy, clean):
        h = max(1, len(noisy) // 2)
        return inner(self, noisy[:h], clean[:h])

    SpeechEnhancement.train_step = _from_step(after, inner, broken)


def unchanged_state(after: int = 0) -> None:
    """An SE step that computes its loss and returns the state unchanged."""
    import torch

    from nomad_tpu_torch.training.se import SpeechEnhancement

    def broken(self, noisy, clean):
        self.unet.train()
        with torch.no_grad():
            saved = {k: v.clone() for k, v in self.unet.state_dict().items()}
            loss = self.objective(noisy, clean)
            self.unet.load_state_dict(saved)
        return loss.detach()

    SpeechEnhancement.train_step = _from_step(after, SpeechEnhancement.train_step, broken)


FAULTS = {"altered_answer": altered_answer, "half_batch_loss": half_batch_loss,
          "half_batch_step": half_batch_step, "unchanged_state": unchanged_state}
