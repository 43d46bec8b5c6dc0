"""Triplet fine-tuning and the four evaluation experiments (counterpart of
``nomad_tpu.training.triplet``; reference ``train_triplet.py``).

  * ``Training(config, device=None, params=None, model_config=None)``
    reads a config dict or a YAML file of the configs' subset
    (``utils.config``). It runs on ``cuda`` unless ``device="cpu"``, and
    raises without CUDA rather than fall back to the CPU.
  * Freeze policy (``param_labels``): the ``embedding`` head trains at
    ``lr``; ``lossnet_embedding`` is always frozen; the conv frontend is
    frozen under ``freeze_convnet`` or ``freeze_all``, the transformer
    encoder under ``freeze_all``; everything else is backbone, at 1e-5
    when the convnet is frozen, else at ``lr``. Frozen parameters do not
    require a gradient and stay out of the optimizer, ``torch.optim.Adam``
    (β 0.9/0.999, eps 1e-8 outside the square root: optax's
    ``scale_by_adam`` and a scale of −lr).
  * ``precision: exact | balanced | fast | fast_bf16`` (with no
    ``model_config``) picks the model's precision islands, and for
    ``fast_bf16`` the bf16 block stack, as the JAX trainer does
    (``resolve_model_config``); the train and eval steps run in them.
  * ``experiment_name: Training`` maps ``freeze_convnet`` to
    ``frontend_stop_gradient`` (no autograd through the frozen frontend)
    and turns on ``remat`` (``remat: false`` turns it off), as the JAX
    package does.
  * A train step is one forward over [A; P; N] with dropout
    (``deterministic=False``), the triplet margin loss, backward and an
    Adam step; the eval step the same forward, deterministic, under
    ``inference_mode``. Lengths reach the model only with ``masked_pool``.
    int16 batches are dequantized on the device. Losses stay on the
    device until the epoch ends.
  * ``training_loop``: best-model ``.npz`` in the JAX package's flat key
    layout (``convert.state_dict_to_jax``), quirk Q10 (both LRs decay by
    gamma when ``(counter + 1) % lr_decay_step == 0``), early stop after
    ``patience``, and a resume state (parameters, Adam's state, counters,
    LRs) per epoch under ``<run_dir>/checkpoints``. The loader's epoch is
    set from the epoch index, so a resumed run shuffles as an
    uninterrupted one.
  * ``mesh`` (a ``parallel.data_mesh``): data parallelism, as the JAX
    trainer shards its step over the "data" axis. Every rank runs the same
    loader with the same seed and keeps its rows of a, p and n
    (``parallel.shard_rows``) before the copy to the device; the model
    draws each dropout mask for the global batch and keeps the rank's rows
    (``BatchRows``), so the masks are the single-process step's. The
    trainable gradients are averaged by one all-reduce of a flat buffer
    before Adam, so the parameters stay replicated (``replicate`` makes
    them so at the start); the train and eval steps return the global mean
    loss. The evals embed through the engine on the same mesh. Rank 0
    alone writes checkpoints, ``best_model.npz``, the resume state, the
    run's config and plots; every rank reads them. A batch must split
    evenly over the ranks, as XLA's batch sharding requires.
  * The evals read their CSVs with the stdlib (``training.data.read_table``),
    group by sorted keys as pandas' ``groupby`` does, embed through the
    scoring engine (``forward_features`` under ``eval_w2v``) and plot with
    matplotlib only when asked.
"""

from __future__ import annotations

import dataclasses
import math
import os
import re
import time
import warnings
from datetime import datetime
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..api import resolve_device, set_exact_precision
from ..convert import convert_checkpoint, jax_to_state_dict, merge_into, state_dict_to_jax
from ..models import NomadModel, Wav2Vec2Config, init_weights
from ..models.wav2vec2 import FAST_ISLANDS
from ..ops import cdist, cdist_diag
from ..ops.attention import BatchRows
from ..parallel.mesh import barrier, device_for, is_main, rank_rows, replicate, shard_rows
from ..scoring.engine import PCM16_SCALE, EmbeddingEngine
from ..utils import config as config_io
from ..utils.metrics import correlation_report, fit_order_three, srcc
from .checkpoint import CheckpointManager
from .data import TripletBatch, TripletDataset, TripletLoader, read_table
from .losses import epoch_mean, triplet_margin_loss


def param_labels(model: NomadModel, freeze_convnet: bool, freeze_all: bool) -> dict:
    """Parameter name -> 'head' | 'backbone' | 'frozen' (reference freeze
    policy, ``train_triplet.py:73-80, 99-107``)."""

    def label_of(name: str) -> str:
        if name.startswith("embedding."):
            return "head"
        if name.startswith("lossnet_embedding."):
            return "frozen"  # the loss path's head is not trained here
        if "feature_encoder" in name and (freeze_convnet or freeze_all):
            return "frozen"
        if freeze_all and name.startswith("backbone.encoder."):
            return "frozen"
        return "backbone"

    return {name: label_of(name) for name, _ in model.named_parameters()}


def _is_nan(v) -> bool:
    return isinstance(v, float) and math.isnan(v)


def _groupby(rows: list, key: str) -> list:
    """[(value, rows)] in sorted order of the value, NaN keys dropped
    (pandas ``groupby``)."""
    groups: dict = {}
    for r in rows:
        if not _is_nan(r[key]):
            groups.setdefault(r[key], []).append(r)
    return sorted(groups.items(), key=lambda kv: kv[0])


def _merge(left: list, right: list, on: str) -> list:
    """Inner join on one column, in the left rows' order (pandas
    ``merge``); right's columns win a name clash, which the callers avoid."""
    index: dict = {}
    for r in right:
        index.setdefault(r[on], []).append(r)
    return [{**l, **r} for l in left for r in index.get(l[on], [])]


def _group_means(rows: list, by: str, cols) -> tuple[list, dict]:
    keys, out = [], {c: [] for c in cols}
    for key, group in _groupby(rows, by):
        keys.append(key)
        for c in cols:
            out[c].append(np.mean(np.asarray([r[c] for r in group])))
    return keys, {c: np.asarray(v) for c, v in out.items()}


def resolve_model_config(cfg: dict) -> Wav2Vec2Config:
    """The model of ``model_size`` (``base`` | ``tiny``) at the config's
    training ``precision``, as the JAX trainer resolves it
    (``nomad_tpu/training/triplet.py:116-146``): ``exact`` leaves it f32;
    ``fast`` runs every encoder product in one bf16 pass with the frontend
    at "high", at any size, and ``fast_bf16`` does so on bf16 activations
    in the block stack (``encoder_dtype``); ``balanced`` is
    ``Wav2Vec2Config.balanced()`` for ``base`` only and leaves ``tiny`` as
    it is (the JAX trainer's own rule, kept)."""
    size = cfg.get("model_size", "base")
    model_config = Wav2Vec2Config.tiny() if size == "tiny" else Wav2Vec2Config.base()
    prec = cfg.get("precision", "exact")
    if prec in ("fast", "fast_bf16"):
        dtype = torch.bfloat16 if prec == "fast_bf16" else None
        return dataclasses.replace(model_config, **FAST_ISLANDS, encoder_dtype=dtype)
    if prec == "balanced" and size == "base":
        return Wav2Vec2Config.balanced()
    if prec not in ("exact", "balanced"):
        raise ValueError(
            f"unknown training precision {prec!r}: expected 'exact', 'balanced', 'fast' "
            "or 'fast_bf16'"
        )
    return model_config


class Training:
    """Config-compatible with the reference ``train_triplet.yaml`` and
    ``eval_triplet.yaml``."""

    def __init__(self, config_file_or_dict, device: Optional[str] = None,
                 params: Optional[dict] = None,
                 model_config: Optional[Wav2Vec2Config] = None, mesh=None):
        if isinstance(config_file_or_dict, dict):
            self.config = dict(config_file_or_dict)
        else:
            self.config = config_io.load(config_file_or_dict)
        cfg = self.config
        self.mesh = mesh
        self.device = resolve_device(device) if mesh is None else device_for(mesh, device)
        set_exact_precision()
        print(f"Device: {self.device}")

        if model_config is None:
            model_config = resolve_model_config(cfg)
        training = cfg.get("experiment_name") == "Training"
        if training and cfg.get("freeze_convnet", False):
            model_config = dataclasses.replace(model_config, frontend_stop_gradient=True)
        if training and cfg.get("remat", True):
            model_config = dataclasses.replace(
                model_config, remat=True, remat_policy=cfg.get("remat_policy", "full"))
        self.model_config = model_config
        self.emb_dim = int(cfg.get("emb_dim", 256))
        self.eval_w2v = bool(cfg.get("eval_w2v", False))
        self.masked_pool = bool(cfg.get("masked_pool", True))
        self.margin = float(cfg.get("margin", 0.2))
        self.model = NomadModel(model_config, emb_dim=self.emb_dim,
                                masked_pool=self.masked_pool)
        if params is not None:
            self.model.load_state_dict(params, strict=True)
        else:
            self._load_params(cfg)
        self.model.to(self.device)
        if mesh is not None:
            replicate(self.model.state_dict().values(), mesh)
        self.optimizer = None

        if training:
            self.current_level = cfg.get("current_level")
            self.train_set = TripletDataset(cfg, "train_df", level=self.current_level)
            self.valid_set = TripletDataset(cfg, "valid_df", level=self.current_level)
            pin = self.device.type == "cuda"
            threads = cfg.get("num_workers", 6)
            self.train_loader = TripletLoader(self.train_set, cfg["train_bs"], shuffle=True,
                                              num_threads=threads, pin_memory=pin)
            self.valid_loader = TripletLoader(self.valid_set, cfg["val_bs"], shuffle=False,
                                              num_threads=threads, pin_memory=pin)
            self._build_optimizer()

    # ------------- parameters / optimizer -------------

    def _load_params(self, cfg) -> None:
        """A seeded init, then ``checkpoint_path`` over it when it exists."""
        init_weights(self.model, seed=0)
        ckpt = cfg.get("checkpoint_path")
        if ckpt and os.path.isfile(ckpt):
            self.load_checkpoint(ckpt)
        else:
            warnings.warn(
                f"checkpoint_path {ckpt!r} not found; training starts from a seeded "
                "random init, not from the published wav2vec 2.0 weights."
            )

    def _build_optimizer(self) -> None:
        cfg = self.config
        freeze_convnet = bool(cfg.get("freeze_convnet", False))
        self.labels = param_labels(self.model, freeze_convnet, bool(cfg.get("freeze_all", False)))
        groups: dict = {"backbone": [], "head": []}
        for name, p in self.model.named_parameters():
            label = self.labels[name]
            p.requires_grad_(label != "frozen")
            if label != "frozen":
                groups[label].append(p)
        self.lr_head = float(cfg.get("lr", 1e-4))
        # two-group recipe (train_triplet.py:99-107): the backbone at 1e-5
        # when the convnet is frozen, else one LR for everything
        self.lr_backbone = 1e-5 if freeze_convnet else self.lr_head
        self.gamma = float(cfg.get("lr_decay_factor", 0.99))
        self.lr_decay_step = int(cfg.get("lr_decay_step", 30))
        self.optimizer = torch.optim.Adam(
            [{"params": ps, "name": label} for label, ps in groups.items() if ps],
            lr=self.lr_head, betas=(0.9, 0.999), eps=1e-8,
        )
        self._set_lrs()

    def _set_lrs(self) -> None:
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr_head if group["name"] == "head" else self.lr_backbone

    # ------------- steps -------------

    def _device_batch(self, batch: TripletBatch) -> tuple[torch.Tensor, torch.Tensor]:
        """[A; P; N] waveforms (f32) and lengths on the device."""
        def dev(x):
            return torch.as_tensor(x).to(self.device, non_blocking=True)

        wav = torch.cat([dev(batch.anchor), dev(batch.positive), dev(batch.negative)])
        if wav.dtype == torch.int16:
            wav = wav.to(torch.float32) / PCM16_SCALE
        lengths = torch.cat([dev(batch.lengths_a), dev(batch.lengths_p),
                             dev(batch.lengths_n)]).long()
        return wav, lengths

    def _batch_rows(self, b: int) -> Optional[BatchRows]:
        """Under a mesh, this rank's rows of the global [A; P; N] of b
        triplets: its triplets of each of a, p and n."""
        if self.mesh is None:
            return None
        mine = rank_rows(b, self.mesh)
        return BatchRows(3, b, mine.start, mine.stop)

    def triplet_loss(self, batch: TripletBatch, deterministic: bool,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The margin loss of one forward over [A; P; N]; under a mesh over
        this rank's triplets, the mean of its share."""
        rows = self._batch_rows(len(batch.lengths_a))
        if self.mesh is not None:
            batch = TripletBatch(*(shard_rows(getattr(batch, f.name), self.mesh)
                                   for f in dataclasses.fields(batch)))
        wav, lengths = self._device_batch(batch)
        emb = self.model(wav, lengths if self.masked_pool else None,
                         deterministic=deterministic, generator=generator, rows=rows)
        b = len(batch.lengths_a)
        return triplet_margin_loss(emb[:b], emb[b:2 * b], emb[2 * b:], self.margin)

    def _mean_over_ranks(self, t: torch.Tensor) -> torch.Tensor:
        """The mean of ``t`` over the mesh's ranks, in place (every rank
        holds the same share of the batch, so the mean of their means is the
        global mean)."""
        if self.mesh is not None:
            dist.all_reduce(t, group=self.mesh.get_group())
            t /= self.mesh.size()
        return t

    def _average_grads(self) -> None:
        """The trainable gradients averaged over the ranks: one all-reduce
        of a flat buffer, whose pieces become the gradients."""
        params = [p for g in self.optimizer.param_groups for p in g["params"]
                  if p.grad is not None]
        flat = self._mean_over_ranks(torch.cat([p.grad.reshape(-1) for p in params]))
        for p, g in zip(params, flat.split([p.numel() for p in params])):
            p.grad = g.view_as(p)

    def train_step(self, batch: TripletBatch,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """One step with dropout; returns the loss, still on the device
        (under a mesh the global one)."""
        loss = self.triplet_loss(batch, False, generator)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if self.mesh is not None:
            self._average_grads()
        self.optimizer.step()
        return self._mean_over_ranks(loss.detach())

    def eval_step(self, batch: TripletBatch) -> torch.Tensor:
        with torch.inference_mode():
            return self._mean_over_ranks(self.triplet_loss(batch, True))

    def train(self, loader=None, rng_seed: int = 0) -> float:
        """One epoch; dropout masks from a generator seeded with rng_seed."""
        loader = loader or self.train_loader
        self._set_lrs()
        generator = torch.Generator().manual_seed(rng_seed)
        losses = []
        wall0 = time.perf_counter()
        wait_s = 0.0
        it = iter(loader)
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                break
            wait_s += time.perf_counter() - t0  # the loader's prefetch fell behind
            losses.append(self.train_step(batch, generator))
        mean = epoch_mean(losses)  # waits for the device
        wall = time.perf_counter() - wall0
        self.last_train_stats = {
            "steps": len(losses),
            "wall_s": round(wall, 3),
            "loader_wait_s": round(wait_s, 3),
            "loader_overlap": round(1.0 - wait_s / max(wall, 1e-9), 4),
        }
        return mean

    def eval(self, loader=None) -> float:
        loader = loader or self.valid_loader
        return epoch_mean([self.eval_step(batch) for batch in loader])

    def training_loop(self) -> None:
        cfg = self.config
        if cfg.get("run_dir"):
            self.PATH_DIR = cfg["run_dir"]  # pinned: resume finds its checkpoints there
        else:
            dt_string = datetime.now().strftime("%d-%m-%Y_%H-%M-%S")
            self.PATH_DIR = os.path.join("out-models", cfg.get("out_dir", "train-triplet"),
                                         dt_string)
        if self.mesh is not None:  # rank 0's clock names the run
            names = [self.PATH_DIR]
            dist.broadcast_object_list(names, src=0)
            self.PATH_DIR = names[0]
        os.makedirs(self.PATH_DIR, exist_ok=True)
        if is_main(self.mesh):
            config_io.dump(cfg, os.path.join(self.PATH_DIR, "config.yaml"))

        best_valid_loss, counter, start_epoch = np.inf, 0, 0
        state = self._load_resume_state()
        if state is not None:
            best_valid_loss, counter, start_epoch = state
            print(f"Resuming from epoch {start_epoch}")

        for i in range(start_epoch, int(cfg.get("num_epochs", 50))):
            self.train_loader.epoch = i
            train_loss = self.train(rng_seed=i)
            valid_loss = self.eval()

            if valid_loss < best_valid_loss:
                self.save_checkpoint(os.path.join(self.PATH_DIR, "best_model.npz"))
                best_valid_loss = valid_loss
                print("Saved Weights Success")
                counter = 0
            else:
                counter += 1

            # Q10: the decay follows the stagnation counter, not the epoch
            if (counter + 1) % self.lr_decay_step == 0:
                self.lr_head *= self.gamma
                self.lr_backbone *= self.gamma

            self._save_resume_state(best_valid_loss, counter, i + 1)
            print(f"COUNTER:  {counter}/{cfg.get('patience')}")
            print(f"LR: [{self.lr_backbone}, {self.lr_head}]")
            if counter > int(cfg.get("patience", 20)):
                print("Stop training, counter greater than patience")
                break
            print(f"EPOCHS: {i+1} train_loss : {train_loss}")
            print(f"EPOCHS: {i+1} valid_loss : {valid_loss}")
            print("\n")

    # ------------- checkpoints -------------

    def save_checkpoint(self, path: str) -> None:
        """The JAX package's flat-key npz: its ``Training.load_checkpoint``
        and ``Nomad`` weights cache read it. Under a mesh rank 0 writes it
        and every rank waits for the file."""
        if is_main(self.mesh):
            np.savez(path, **state_dict_to_jax(self.model.state_dict()))
        barrier(self.mesh)

    def load_checkpoint(self, path: str) -> None:
        """The JAX package's flat-key npz, or a fairseq or NOMAD ``.pt``
        over a fresh seeded init, as the JAX trainer reads one: the file's
        tensors (``convert/from_fairseq.py``) replace the init's, and what
        the file lacks (the lossnet head) keeps the init."""
        if path.endswith(".npz"):
            with np.load(path) as flat:
                sd = jax_to_state_dict(dict(flat))
        else:
            cfg = self.model_config
            base = init_weights(NomadModel(cfg, emb_dim=self.emb_dim,
                                           masked_pool=self.masked_pool), seed=0)
            sd = merge_into(base.state_dict(),
                            convert_checkpoint(path, cfg.num_layers, len(cfg.conv_dim)))
        self.model.load_state_dict(sd, strict=True)

    def _ckpt_manager(self) -> Optional[CheckpointManager]:
        base = getattr(self, "PATH_DIR", None) or self.config.get("run_dir")
        if base is None:
            return None
        return CheckpointManager(os.path.join(base, "checkpoints"),
                                 keep=int(self.config.get("checkpoint_keep", 2)))

    def _opt_names(self) -> list:
        names = {id(p): n for n, p in self.model.named_parameters()}
        return [names[id(p)] for g in self.optimizer.param_groups for p in g["params"]]

    def _save_resume_state(self, best: float, counter: int, next_epoch: int) -> None:
        """Parameters, Adam's state, loop counters and both LRs."""
        mgr = self._ckpt_manager()
        if mgr is None:
            return
        if is_main(self.mesh):
            names = self._opt_names()
            state = {
                "params": {k: v.detach().cpu().numpy()
                           for k, v in self.model.state_dict().items()},
                "opt": {names[i]: {k: v.detach().cpu().numpy() for k, v in s.items()}
                        for i, s in self.optimizer.state_dict()["state"].items()},
            }
            mgr.save(next_epoch - 1, state, meta={
                "best": float(best), "counter": int(counter), "next_epoch": int(next_epoch),
                "lr_head": float(self.lr_head), "lr_backbone": float(self.lr_backbone)})
        barrier(self.mesh)

    def _load_resume_state(self) -> Optional[tuple[float, int, int]]:
        """With ``resume``: restore the latest state; (best, counter,
        next epoch), or None."""
        if not self.config.get("resume"):
            return None
        mgr = self._ckpt_manager()
        got = mgr.restore() if mgr is not None else None
        if got is None:
            return None
        _step, state, meta = got
        self.model.load_state_dict({k: torch.from_numpy(v) for k, v in state["params"].items()},
                                   strict=True)
        names = self._opt_names()
        opt = self.optimizer.state_dict()
        opt["state"] = {names.index(name): {k: torch.from_numpy(np.asarray(v))
                                            for k, v in s.items()}
                        for name, s in state["opt"].items()}
        self.optimizer.load_state_dict(opt)
        self.lr_head = float(meta["lr_head"])
        self.lr_backbone = float(meta["lr_backbone"])
        self._set_lrs()
        return float(meta["best"]), int(meta["counter"]), int(meta["next_epoch"])

    # ------------- embeddings for the evals -------------

    def _engine(self) -> EmbeddingEngine:
        """The scoring engine; the raw pooled features under ``eval_w2v``
        (the Origw2v ablation, ``train_triplet.py:67-69``)."""
        method = "forward_features" if self.eval_w2v else "forward"
        return EmbeddingEngine(self.model, self.device, method=method, mesh=self.mesh)

    def get_embeddings_csv(self, file_names, root=False) -> tuple[list, np.ndarray]:
        """(names, [N, D] embeddings) of the files, joined to root if given."""
        names = list(file_names)
        paths = [os.path.join(root, f) if root else f for f in names]
        return names, self._engine().embed_files(paths)

    def get_nmr_embeddings(self) -> tuple[list, np.ndarray]:
        d = self.config["non_match_dir"]
        return self.get_embeddings_csv([os.path.join(d, x) for x in os.listdir(d)])

    @staticmethod
    def _mean_distances(emb: np.ndarray, ref: np.ndarray) -> np.ndarray:
        return cdist(torch.from_numpy(emb), torch.from_numpy(ref)).cpu().numpy().mean(axis=1)

    # ------------- the evaluation experiments -------------

    def _quality_report(self, name: str, rows: list, plot: bool, fname: str) -> dict:
        """Per-condition means of Distance and MOS -> correlations (+ plot)."""
        _, means = _group_means(rows, "condition", ("Distance", "mos"))
        dist, mos = means["Distance"], means["mos"]
        report = correlation_report(dist, mos)
        for k, v in report.items():
            print(f"{name} {k}: {np.round(v, 2)}")
        if plot:
            self._scatter(mos, fit_order_three(dist, mos)(dist), fname)
        return report

    def eval_audio_quality(self, model_path, plot: bool = True) -> dict:
        """quality_nmr (``train_triplet.py:231-303``): per-db correlations of
        the conditions' mean NMR distance with their MOS."""
        if not self.eval_w2v and model_path:
            self.load_checkpoint(model_path)
        cfg = self.config
        test_data = read_table(cfg["test_db_file"])
        if cfg.get("db") is not None:
            test_data = [r for r in test_data if r["db"] in cfg["db"]]
        if cfg.get("conds") is not None:
            pattern = re.compile("|".join(cfg["conds"]))
            test_data = [r for r in test_data if pattern.search(str(r["condition"]))]
        _, ref = self.get_nmr_embeddings()
        results = {}
        for db_name, db in _groupby(test_data, "db"):
            names, emb = self.get_embeddings_csv([r["filepath_deg"] for r in db],
                                                 root=cfg.get("test_root_wav"))
            test_names = [{k: r[k] for k in ("filepath_deg", "condition", "mos")}
                          for r in _merge([{"filepath_deg": n} for n in names], db,
                                          "filepath_deg")]
            dist = self._mean_distances(emb, ref)
            rows = _merge([{"filepath_deg": n, "Distance": d} for n, d in zip(names, dist)],
                          test_names, "filepath_deg")
            results[db_name] = self._quality_report(db_name, rows, plot,
                                                    f"{db_name}_embeddings.png")
        return results

    def eval_degr_level(self, model_path, plot: bool = True) -> dict:
        """valid_rank (``train_triplet.py:305-342``): the validation set's
        anchors by mean NMR distance, stably sorted; columns Anchor,
        Distance, condition."""
        if model_path:
            self.load_checkpoint(model_path)
        valid_set = TripletDataset(self.config, "valid_df",
                                   level=self.config.get("current_level"))
        names, emb = self.get_embeddings_csv(valid_set.column("Anchor"),
                                             root=self.config["root"])
        _, ref = self.get_nmr_embeddings()
        dist = self._mean_distances(emb, ref)
        order = sorted(range(len(names)), key=lambda i: dist[i])
        anchors = [names[i] for i in order]
        out = {
            "Anchor": anchors,
            "Distance": dist[order],
            "condition": [x.split("_")[1] + " " + x.split("_")[2].split(".")[0]
                          for x in anchors],
        }
        if plot:
            keys, means = _group_means(
                [{"condition": c, "Distance": d} for c, d in zip(out["condition"],
                                                                  out["Distance"])],
                "condition", ("Distance",))
            ranked = [keys[i] for i in np.argsort(means["Distance"], kind="stable")]
            plt = self._pyplot()
            if plt is not None:
                plt.figure(figsize=(50, 20))
                plt.boxplot([[d for c, d in zip(out["condition"], out["Distance"]) if c == k]
                             for k in ranked])
                plt.xticks(range(1, len(ranked) + 1), ranked, rotation=65)
                plt.ylabel("Distance")
                plt.tight_layout()
                plt.savefig(self._out_path("validset_embeddings.png"))
                plt.close()
        return out

    def eval_degradation_intensity(self, model_path) -> dict:
        """intensity (``train_triplet.py:344-419``): per degradation, the
        SRCC of the mean NMR distance against the intensity level."""
        if not self.eval_w2v and model_path:
            self.load_checkpoint(model_path)
        cfg = self.config
        _, ref = self.get_nmr_embeddings()
        test_data = read_table(cfg["test_mono_data"])
        out = {}
        for deg_name, deg_data in _groupby(test_data, "Degradation"):
            names, emb = self.get_embeddings_csv([r["filepath_deg"] for r in deg_data],
                                                 root=cfg.get("test_mono_wav"))
            test_names = [{k: r[k] for k in ("filepath_deg", "Condition")}
                          for r in _merge([{"filepath_deg": n} for n in names], deg_data,
                                          "filepath_deg")]
            dist = self._mean_distances(emb, ref)
            rows = _merge([{"filepath_deg": n, "Distance": d} for n, d in zip(names, dist)],
                          test_names, "filepath_deg")
            levels, means = _group_means(rows, "Condition", ("Distance",))
            s = srcc(means["Distance"], levels)
            out[deg_name] = s
            print(f"Degradation: {deg_name}")
            print(f"SRCC: {np.round(s, 2)}")
        return out

    def eval_full_reference(self, model_path, plot: bool = True) -> dict:
        """quality_fr (``train_triplet.py:421-474``): the paired distance of
        each degraded file to its own reference."""
        if model_path:
            self.load_checkpoint(model_path)
        cfg = self.config
        test_data = read_table(cfg["test_db_file_fr"])
        results = {}
        for db_name, db in _groupby(test_data, "db"):
            _, ref_emb = self.get_embeddings_csv([r["filepath_ref"] for r in db],
                                                 root=cfg.get("test_root_wav"))
            names, test_emb = self.get_embeddings_csv([r["filepath_deg"] for r in db],
                                                      root=cfg.get("test_root_wav"))
            test_names = [{k: r[k] for k in ("filepath_deg", "condition", "mos")}
                          for r in _merge([{"filepath_deg": n} for n in names], db,
                                          "filepath_deg")]
            fr = cdist_diag(torch.from_numpy(test_emb), torch.from_numpy(ref_emb)).cpu().numpy()
            rows = _merge([{"filepath_deg": n, "Distance": d} for n, d in zip(names, fr)],
                          test_names, "filepath_deg")
            results[db_name] = self._quality_report(db_name, rows, plot,
                                                    f"fr_{db_name}_embeddings.png")
        return results

    # ------------- plots -------------

    def _out_path(self, name: str) -> str:
        model_path = self.config.get("nomad_model_path", "out-models/model.npz")
        out_dir = os.path.dirname(model_path) or "."
        os.makedirs(out_dir, exist_ok=True)
        return os.path.join(out_dir, name)

    def _pyplot(self):
        """matplotlib's pyplot on the Agg backend, or None (with a warning)
        where matplotlib is not installed; None on every rank but 0 under a
        mesh (one rank plots)."""
        if not is_main(self.mesh):
            return None
        try:
            import matplotlib
        except ImportError:
            warnings.warn("matplotlib is not installed: the eval's plot is skipped")
            return None
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        return plt

    def _scatter(self, mos, mapped, fname: str) -> None:
        plt = self._pyplot()
        if plt is None:
            return
        plt.scatter(np.asarray(mos), np.asarray(mapped))
        plt.xlabel("Actual MOS")
        plt.ylabel("Dist w.r.t. clean embeddings")
        plt.xlim([1, 5])
        plt.ylim([1, 5])
        plt.tight_layout()
        plt.savefig(self._out_path(fname))
        plt.close()
