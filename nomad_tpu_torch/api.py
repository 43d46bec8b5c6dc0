"""Public NOMAD API of the port (counterpart of ``nomad_tpu.api``).

``Nomad(device=None).predict(mode='dir'|'csv', nmr, deg, results_path)``
embeds both file sets in one batched pass, computes the distance matrix on
the device and writes the two reference-format CSVs. It returns the
average and pairwise tables as ``ResultTable``s (labels + numpy values).

``Nomad.forward(estimate, clean)`` (= ``loss_fn``) is the differentiable
NOMAD loss: a 0-dim f32 tensor through which autograd carries
d loss / d estimate back to the caller's tensor. The weights stay frozen.
``get_embeddings(path)`` / ``get_embeddings_csv(file_names, root)`` return
``ResultTable``s of a 'filename' column and one column per dimension.

  * Device: ``cuda`` unless the caller passes ``device='cpu'``; without
    CUDA it raises rather than fall back to the CPU.
  * Weights resolve lazily, after ``predict``'s argument checks, in the
    JAX package's order: the ``pt-models/nomad_tpu_params.npz`` cache
    (either package's: the flat JAX layout, through the weight bridge);
    else ``nomad_best_model.pt``; else ``wav2vec_small.pt`` with a warning
    that the scoring head is random; else a seeded init with a loud warning
    (scores then differ from the published model). After a ``.pt`` load
    the cache is written, in the JAX layout, so either package reads it.
    Those files hold wav2vec 2.0 BASE's layout: a config of another layout
    (``Wav2Vec2Config.wavlm_large()``) refuses them and takes its weights
    as ``params``.
  * Precision: ``'exact'`` (the default), f32 with TF32 off for both
    cuBLAS matmuls and cuDNN convolutions (the cuDNN flag defaults to on
    and would reach the conv frontend). ``'balanced'`` and ``'fast'`` build
    ``Wav2Vec2Config.balanced()`` and ``.fast()``, the JAX package's
    recipes: one bf16 pass (bf16 operands, f32 accumulation) on their
    islands (``ops/precision.py``), the attention products in kernel K1b.
    They serve scoring, embeddings and the loss with its gradient, whose
    products round their operands as JAX transposes a DEFAULT product (the
    attention's backward in K2b + K3b). An explicit ``config`` wins over
    ``precision``, as in the JAX package. The JAX package defaults to
    ``'balanced'``; the port keeps ``'exact'``, its parity anchor, until
    a benchmark cell can judge the switch (ROADMAP).
  * Data parallelism: ``mesh=parallel.data_mesh()`` (in a process group,
    one rank per card, every rank making the same calls) runs the engine
    over the mesh: each rank embeds its share of every batch, and every
    rank returns the same scores. Rank 0 alone writes the two CSVs, and
    resolves the weights (writing the cache) before the other ranks read
    them. The device is the rank's; a ``device`` that names another
    raises.
  * Attention: ``config=Wav2Vec2Config.base(attention_impl="fused_qkv")``
    selects the projection-fused path (kernel K4h, or K4b in "fast", for
    inputs of up to 1,024 frames, ~20 s of audio) for both ``predict`` and
    ``forward``;
    the default runs the projections as products and attention in K1.
"""

from __future__ import annotations

import csv
import os
import tempfile
import warnings
from typing import Optional

import numpy as np
import torch

from .convert import convert_checkpoint, jax_to_state_dict, merge_into, state_dict_to_jax
from .models import NomadModel, Wav2Vec2Config, init_weights, nomad_loss
from .models.wav2vec2 import PRECISION_ISLANDS
from .ops import cdist
from .parallel.mesh import barrier, device_for, is_main
from .scoring.csvio import ResultTable, build_result_tables, write_results
from .scoring.engine import EmbeddingEngine, list_dir_files
from .utils.profiling import GLOBAL, profiling_active, timed

W2V_FILENAME = "wav2vec_small.pt"
NOMAD_FILENAME = "nomad_best_model.pt"
CACHE_FILENAME = "nomad_tpu_params.npz"


def resolve_device(device: Optional[str] = None) -> torch.device:
    """``None`` -> cuda. Raises when CUDA is asked for and missing."""
    dev = torch.device(device or "cuda")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: nomad_tpu_torch runs on the card and "
                "does not fall back to the CPU; pass device='cpu' to run there"
            )
    elif dev.type != "cpu":
        raise ValueError(f"device {device!r} not supported: expected 'cuda' or 'cpu'")
    return dev


def set_exact_precision() -> None:
    """f32 where an island asks for f32: no TF32 in cuBLAS matmuls nor
    cuDNN convolutions, in every mode; and bf16 products (the "default"
    islands) reduce in f32, never in bf16, across split-K."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def check_precision(precision: str) -> None:
    if precision not in PRECISION_ISLANDS:
        raise ValueError(
            f"unknown precision {precision!r}: expected one of {tuple(PRECISION_ISLANDS)}")


def write_cache(path: str, sd: dict) -> None:
    """The weights cache, in the JAX layout, written whole or not at all: a
    reader never opens a partly written file."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".", suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **state_dict_to_jax(sd))
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


class Nomad:
    def __init__(
        self,
        device: Optional[str] = None,
        weights_dir: str = "pt-models",
        config: Optional[Wav2Vec2Config] = None,
        emb_dim: int = 256,
        params: Optional[dict] = None,
        precision: str = "exact",
        mesh=None,
    ):
        check_precision(precision)
        self.mesh = mesh
        self.device = resolve_device(device) if mesh is None else device_for(mesh, device)
        set_exact_precision()
        self.config = config or Wav2Vec2Config.base(**PRECISION_ISLANDS[precision])
        self.emb_dim = emb_dim
        self.weights_dir = weights_dir
        self._params = params  # a port state_dict, or None: resolve lazily
        self._model = None
        self._engine = None
        print(f"NOMAD running on: {self.device}")

    # ---------------- weights ----------------

    def _resolve_params(self, model: NomadModel) -> dict:
        """The weights for ``model`` (a fresh ``NomadModel``), in the JAX
        package's order: the npz cache, ``nomad_best_model.pt``,
        ``wav2vec_small.pt``, a seeded init. A ``.pt`` overlays the seeded
        init (the lossnet head, quirk Q7, keeps it) and writes the cache."""
        cache = os.path.join(self.weights_dir, CACHE_FILENAME)
        nomad_path = os.path.join(self.weights_dir, NOMAD_FILENAME)
        w2v_path = os.path.join(self.weights_dir, W2V_FILENAME)
        found = [p for p in (cache, nomad_path, w2v_path) if os.path.isfile(p)]
        if found and self.config.arch != "wav2vec2":
            raise ValueError(
                f"{found[0]} holds wav2vec 2.0 BASE weights (the only checkpoints the converter "
                f"reads), and this config's arch is {self.config.arch!r}: pass its weights as "
                "params= instead of half-loading these")
        if os.path.isfile(cache):
            with np.load(cache) as flat:
                return jax_to_state_dict(dict(flat))
        init_weights(model, seed=0)
        ckpt = next((p for p in (nomad_path, w2v_path) if os.path.isfile(p)), None)
        if ckpt is None:
            warnings.warn(
                f"no checkpoints found under {self.weights_dir!r}; using a seeded "
                "random init. Scores will NOT match the published NOMAD model. Place "
                f"{W2V_FILENAME} + {NOMAD_FILENAME} (or {CACHE_FILENAME}) there to "
                "use real weights."
            )
            return model.state_dict()
        converted = convert_checkpoint(ckpt, self.config.num_layers, len(self.config.conv_dim))
        sd = merge_into(model.state_dict(), converted)
        if ckpt == w2v_path:
            warnings.warn(
                f"loaded {W2V_FILENAME} but {NOMAD_FILENAME} is missing: scoring head is "
                "randomly initialized"
            )
        try:
            write_cache(cache, sd)
        except OSError:
            pass  # a read-only weights dir: the next process converts again
        return sd

    @property
    def model(self) -> NomadModel:
        if self._model is None:
            model = NomadModel(self.config, emb_dim=self.emb_dim)
            if self._params is not None:
                sd = self._params
            elif self.mesh is None:
                sd = self._resolve_params(model)
            else:  # rank 0 converts a .pt and writes the cache; the others read it
                if is_main(self.mesh):
                    sd = self._resolve_params(model)
                barrier(self.mesh)
                if not is_main(self.mesh):
                    sd = self._resolve_params(model)
            model.load_state_dict(sd, strict=True)
            self._model = model.to(self.device).eval().requires_grad_(False)
        return self._model

    @property
    def engine(self) -> EmbeddingEngine:
        if self._engine is None:
            self._engine = EmbeddingEngine(self.model, self.device, mesh=self.mesh)
        return self._engine

    # ---------------- scoring ----------------

    def score_matrix(self, nmr_paths, test_paths) -> np.ndarray:
        """Raw distances [len(test_paths), len(nmr_paths)], f32: one engine
        pass over both sets, cdist on the device, one copy back. While
        profiling, the wait for the device's embeddings is a span of its own
        (``engine.device_wait``; else cdist's ``nonzero`` waits for them),
        and the engine's batches' device times enter the span log."""
        emb = self.engine.embed_files_device(list(nmr_paths) + list(test_paths))
        if profiling_active():
            with timed("engine.device_wait"):
                if emb.is_cuda:
                    torch.cuda.current_stream(emb.device).synchronize()
            GLOBAL.resolve()
        nmr_emb = emb[: len(nmr_paths)]
        test_emb = emb[len(nmr_paths):]
        dist = cdist(test_emb, nmr_emb)
        with timed("predict.d2h", nbytes=dist.numel() * dist.element_size()):
            return dist.cpu().numpy()

    def predict(self, mode="dir", nmr="data/nmr-data", deg="data/test-data",
                results_path=None):
        with timed("predict"):
            with timed("predict.resolve"):
                nmr_paths, test_paths = self._predict_paths(mode, nmr, deg, results_path)
            distance_matrix = self.score_matrix(nmr_paths, test_paths)
            with timed("predict.tables"):
                avg, dm = build_result_tables(test_paths, nmr_paths, distance_matrix)
            if is_main(self.mesh):
                with timed("predict.write_results"):
                    write_results(avg, dm, results_path)
            return avg, dm

    def _predict_paths(self, mode, nmr, deg, results_path) -> tuple[list, list]:
        """``predict``'s argument checks, then both sets' paths."""
        if nmr is None:
            raise Exception("missing nmr argument (non-matching reference path)")
        if deg is None:
            raise Exception("missing deg argument (test/degraded path)")
        if mode == "dir":
            if not os.path.isdir(nmr):
                raise Exception(f"nmr directory not found: {nmr}")
            if not os.path.isdir(deg):
                raise Exception(f"deg directory not found: {deg}")
        elif mode == "csv":
            if not os.path.isfile(nmr):
                raise Exception(f"nmr csv not found: {nmr}")
            if not os.path.isfile(deg):
                raise Exception(f"deg csv not found: {deg}")
        else:
            raise Exception(f"unknown mode {mode!r}: expected 'dir' or 'csv'")
        # a given results_path is not created (reference contract): fail
        # before any model or embedding work
        if results_path is not None and not os.path.isdir(results_path):
            raise Exception(f"results_path directory not found: {results_path}")

        print(f"Compute non-matching reference embeddings from {nmr}")
        nmr_paths = self._resolve_paths(nmr)
        print(f"Compute degraded embeddings from {deg}")
        return nmr_paths, self._resolve_paths(deg)

    # ---------------- differentiable loss ----------------

    def _waves(self, x) -> torch.Tensor:
        """[B, T] or [B, 1, T] waveforms (tensor or array) -> [B, T] f32 on
        the Nomad's device; ``.to`` keeps the caller's tensor in the graph."""
        x = torch.as_tensor(x)
        if x.ndim == 3:
            x = x.squeeze(1)
        if x.ndim != 2:
            raise ValueError(f"expected [B, T] or [B, 1, T] waveforms, got shape {tuple(x.shape)}")
        return x.to(device=self.device, dtype=torch.float32)

    def loss_fn(self, estimate, clean, deterministic: bool = True) -> torch.Tensor:
        """NOMAD perceptual loss: the sum of 13 per-layer L1 distances (12
        block outputs + the lossnet embedding, quirk Q7) between the clean
        and the estimate, with ``lengths=None`` (quirk Q6). Differentiable
        w.r.t. estimate and clean; returns a 0-dim f32 tensor."""
        if not deterministic:
            raise NotImplementedError(
                "deterministic=False (the dropout loss, se_config.yaml's "
                "loss_dropout) is not supported: the JAX package's loss_fn_p "
                "passes no dropout rng and raises InvalidRngError too (ROADMAP "
                "Queue 3)"
            )
        est, ref = self._waves(estimate), self._waves(clean)
        return nomad_loss(self.model.forward_layers(ref), self.model.forward_layers(est))

    def forward(self, estimate, clean) -> torch.Tensor:
        """Reference ``nomad.py:142-146``: the loss of ``loss_fn``."""
        return self.loss_fn(estimate, clean)

    def get_embeddings(self, path: str) -> ResultTable:
        """Reference ``nomad.py:148-164``: a 'filename' column (the files of
        a directory, in ``os.listdir`` order, or of a csv's 'filename'
        column) and one column per embedding dimension."""
        paths = self._resolve_paths(path)
        emb = self.engine.embed_files(paths)
        return ResultTable(paths, list(range(emb.shape[1])), emb, index_name="filename")

    def get_embeddings_csv(self, file_names, root=False) -> ResultTable:
        """Reference ``nomad.py:166-189``: embeddings of ``file_names``
        (joined to ``root`` when given); the first column is named after
        ``file_names.name`` when it has one, else 'filename', and holds the
        names as given."""
        names = list(file_names)
        paths = [os.path.join(root, f) if root else f for f in names]
        emb = self.engine.embed_files(paths)
        col = getattr(file_names, "name", None) or "filename"
        return ResultTable(names, list(range(emb.shape[1])), emb, index_name=col)

    def _resolve_paths(self, path: str) -> list:
        """Quirk Q3: dir mode follows os.listdir order; csv mode follows the
        row order of its 'filename' column."""
        if os.path.isdir(path):
            return list_dir_files(path)
        if os.path.isfile(path):
            with open(path, newline="", encoding="utf-8") as f:
                reader = csv.DictReader(f)
                if "filename" not in (reader.fieldnames or []):
                    raise Exception(
                        f"csv {path} has no 'filename' column (expected one "
                        "absolute wav path per row)"
                    )
                return [row["filename"] for row in reader]
        raise Exception(f"Path {path} does not exist")


_singleton: Optional[Nomad] = None


def get_nomad(**kwargs) -> Nomad:
    global _singleton
    if _singleton is None:
        _singleton = Nomad(**kwargs)
    return _singleton
