"""Plain PyTorch and NumPy references that decide a run's ``correct``.

They import nothing of the system under test: ``wav.py`` reads PCM16
WAVs, ``wav2vec2.py`` is wav2vec 2.0 with the NOMAD heads and loss,
``waveunet.py`` the Wave-U-Net of the speech-enhancement demo with its
batch norm and Adam. Each runs in float32 with TF32 off
(``precision(tf32=False)``); the control runs them with TF32 on.
"""

import contextlib

import torch


@contextlib.contextmanager
def precision(tf32: bool):
    """float32 products and convolutions (``tf32=False``), or TF32 for
    both (the control), restored on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
