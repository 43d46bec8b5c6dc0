"""Smoke run of nomad_tpu_torch on one CUDA card: build, check, time, score,
differentiate.

    python3 chip_smoke.py [--only-scoring | --only-loss | --only-train | --only-se |
                           --only-serve | --only-precision | --only-grad-modes |
                           --only-fused-modes | --only-fast-bf16 | --only-bf16-paths |
                           --only-large-scale | --only-wire-and-tools | --only-high3 |
                           --only-config-fields]

Phases, each fatal on failure:
  1. the card's name and power limit (nvidia-smi);
  2. build the hand-written kernels from nomad_tpu_torch/csrc with nvcc,
     print ptxas' registers, shared memory and spills (a spill fails, and
     so does a log without the K1b and K2b/K3b kernels and prologues the
     check must cover), and the occupancy (blocks per SM; K4's, K4h's and
     K4b's clusters on the card) of K1, K1b, K2, K3, K4, K4h and K4b (K1b,
     K2b and K3b failing below the blocks per SM their plan claims; K4h at
     T in {50, 65, 511, 1024} below its 1 block per SM or with no cluster
     on the card; K4b at each cluster size of its plan, 3 and 2 .. 16,
     failing below the 2 blocks per SM it is built for or with no cluster
     on the card); build the native C++ ingest library (``native/``, g++);
  3. hold each kernel against its plain PyTorch version on the card at the
     paths' shapes, and time kernel, plain version and one PyTorch call
     computing the same function (a yardstick the port never calls),
     beside the least time the card could take (bound): K1 and K5 at the
     scoring shapes, K2 and K3 (the attention backward) at the loss shape,
     the triplet-training shape and a ragged long shape, and untimed at
     every edge of their tiles, with NaN past the bound and a rerun that
     must give the same bits, K4 (projection-fused attention, "highest")
     at the scoring and loss shapes and a ragged [8, 1024] shape with
     garbage past each bound; K4h (its "high3": three bf16 passes a product
     on hi/lo splits, the fused "exact" and "balanced" paths' kernel) at
     [96, 511] (lengths to 499, a 0-key row), [32, 50], a ragged [8, 1024],
     [16, 65] and T in {1, 17, 64}, against its plain version within
     TOL_FUSED, held to float64 attention over each call (|O - O_f64| <=
     1.5 x the plain version's + 1e-6, and >= half of it), NaN past each
     bound changing no
     valid row, 123.0 there leaving every row finite, a rerun the same
     bits, its prologue's split weights and x bit-equal to their plain
     versions, timed beside the plain version and f32 ``F.linear`` + SDPA;
  4. the scoring paths at full wav2vec 2.0 BASE width with seeded weights:
     ``python -m nomad_tpu_torch --mode dir`` on 8 + 100 seeded 10 s WAVs,
     then ``Nomad(device="cuda").predict`` in process with the kernel
     launch counts read around it; embeddings held against the plain path
     on the same card and against batch-1 runs; warm throughput, pass time
     and peak memory; one warm pass under torch.profiler (device time by
     kernel group, the device's idle share). Then the same for the fused
     path (``attention_impl="fused_qkv"``: K4h, no K1), held against its
     plain path (the fused kernel's plain version at "high", plain
     LayerNorm) and the K1 path, with its pairwise score delta against the
     K1 path, and two single files on it: 300,000 samples (T' = 1,023,
     K4h) and 400,000 (T' = 1,433, past the fused limit: K1); and one batch
     of 96 files with the frontend and the encoder at "highest" (K4 12);
  5. the loss paths at the same width, K1's and the fused one (K4h, held
     against its own plain path):
     ``Nomad.forward(estimate, clean)`` and ``.backward()`` on 32 seeded
     16,384-sample crops, then K1's on 24 seeded 10 s clips (160,000
     samples, T' = 499: the triplet batch's attention shape), with the
     launch counts of one step; loss and d loss / d estimate held against
     the plain path; forward(x, x) == 0; warm step time, host enqueue
     time, peak memory and one step under torch.profiler;
  6. the trainer, at the recipe of ``nomad_tpu/configs/train_triplet.yaml``
     (8 triplets of seeded 10.5-12 s WAVs trimmed to 160,000 samples, the
     conv frontend frozen, dropout 0.1) on the same seeded BASE weights:
     ``Training(config, device="cuda")``'s train step with ``remat`` on
     and off and with the dropout rates at 0, and its eval step, each with
     its launch counts; frozen parameters bit-unchanged and trainable ones
     moved; remat on and off the same loss; the rates-at-0 step on the
     kernels held against the plain path (loss, gradients); warm step
     time, host enqueue time and peak memory; one profiled step with the
     plain dropout attention in a group of its own; then a 2-epoch
     ``training_loop``, a resume from its state (parameters, Adam state,
     LRs and epoch bit-equal) and ``eval_audio_quality`` on its
     ``best_model.npz``;
  7. the speech-enhancement demo at the recipe of
     ``nomad_tpu/configs/se_config.yaml`` (the full-width Wave-U-Net, 12
     levels of interval 24, on 32 x 16,384-sample crops of seeded PCM16
     pairs; the seeded BASE lossnet; MSE + 0.001 NOMAD; Adam 1e-4):
     ``SpeechEnhancement(config, device="cuda")``'s train step with its
     launch counts (K1 24, K2 12, K3 12, K5 52), the first step held
     against the plain path (loss, U-Net gradients under one sign pattern,
     running statistics), every U-Net tensor moved and the lossnet
     bit-unchanged; warm step time (CUDA events), host enqueue and peak
     memory, the same for a U-Net-alone step (MSE + Adam), one profiled
     step with the U-Net (forward and backward) in a group of its own;
     the eval step on the valid batch of 100 (K1 24, K5 52); ``test()``'s
     PESQ-WB and its host time; a 2-epoch ``training_loop`` whose
     ``best_model.npz``, reloaded, enhances the same bits;
  8. the scoring service at full BASE width, its weights loaded from a
     seeded fairseq-named ``pt-models/nomad_best_model.pt`` (written with
     ``convert.fairseq_synth``) on phase 4's 108 WAVs plus FLAC twins of 4
     of them: three processes of ``python -m nomad_tpu_torch.serve`` (from
     the .pt with ``--warm 10``, from the npz cache it wrote with and
     without ``--warm``), each sent ping, score, the same score, embed (16
     cached files and 4 new ones), loss (4 x 16,384 samples), stats and
     shutdown: every stdout line JSON, exit 0, every batch through the
     native C++ ingest, the repeated score from the cache, the scores of
     the three processes the same; cold start and each request's wall
     time; then the server in this process with its launch counts (cold
     score K1 24, K5 52; repeated score none; embed with 4 misses K1 12,
     K5 26; loss K1 24, K5 52), its peak memory (at most phase 4's), its
     embeddings against the served ones and a cache-less engine's, the
     FLAC twins against their WAVs, the loss against the plain path, the
     .pt-loaded weights against the npz-loaded ones, and one profiled
     cold score;
  9. the precision modes: K1b (the "default" flavour of K1: bf16
     products on the tensor cores, f32 softmax) against its plain version
     at [96, 511] (lengths to 499), [32, 50], a ragged [8, 4095], every
     tile edge T in {1, 15, 16, 17, 63, 64, 65, 511} and every edge of its
     ring T in {127, 128, 129, 191, 192, 193, 257}, with NaN past each
     bound and a 0-key row, held to exact attention in float64, its
     prologue's fold bit-equal to ``fold_bf16_ref`` and the kernel alone on
     it the one call's bits; the call through ``mha_flash`` against the
     work's bound, the prologue and the kernel each against what it moves,
     the call in turns with SDPA on bf16 copies (the casts outside the
     timed call and inside it); then ``Nomad(precision=...)`` in
     "exact", "balanced" and "fast" on the same seeded BASE weights over
     phase 4's 108 files (launches: K1 24 or K1b 24, K5 52), each mode's
     pairwise delta against "exact" there and on a pause-heavy stress set
     of 48 + 16 10 s files, warm predict and device pass throughput, peak
     memory, one profiled pass per mode; the card's routes of a bf16
     island (fc1, the positional conv) at full width against their plain
     versions and a float64 sum; each mode's embeddings of 4 stress files
     on the card against the same mode on the CPU, with the kernels and
     with the plain attention; and one ``serve --precision balanced``
     process;
 10. gradients in the precision modes: K2b and K3b (the "default" flavour
     of K2 and K3: bf16 products on the tensor cores, f32 accumulation,
     exp and masks), through ``flash_attention_bwd``, from K1b's O and LSE
     against their plain version at [32, 50], [24, 499], [24, 511] (499
     valid), a ragged [8, 4095] and every tile edge T in {1, 15, 16, 17,
     63, 64, 65, 511} and ring edge T in {129, 193, 257}, each with a
     full, a ragged, a 1-key and a 0-key row and NaN past each bound:
     within BWD_BF16_PLAIN_REL of the plain version's max |g|, and held to
     the exact float64 gradient (|g - g_f64| <= 1.5 x the plain version's
     + 1e-6, and >= half of it), dK = dV = 0 past each bound, a rerun the
     same bits, their prologue's fold bit-equal to ``fold_bf16_ref``; the
     prologue, K2b and K3b each timed alone, and the pair through
     ``flash_attention_bwd`` in turns with SDPA's gradient on bf16 copies
     made inside its timed call; the backward of the card's bf16
     product and convolution against float64 transposes; then on one
     seeded BASE state dict the loss with its gradient in "balanced" and
     "fast" at 32 x 16,384 and 24 x 160,000 samples (K1b 24, K2b 12, K3b
     12, K5 52 a step; the step's attention backward calls against their
     plain version on the same inputs; phase 5's checks against the same
     mode's plain path, within GRAD_MODE_FRAC times that plain path's
     distance to the "exact" plain path; on 10 s clips the gradient's gap
     to the plain path with K2b + K3b, K1b, then K5 alone swapped for its
     plain version, and the share of the gap each closes); the triplet recipe with
     ``precision:`` fast and balanced (remat on): the recipe's step
     (plain bf16 dropout attention, K5 50), its eval step (K1b 12, K5 26),
     the rates-at-0 step (K1b 24, K2b 12, K3b 12, K5 50), whose
     embeddings and gradients are held to the mode's plain path the same
     way, step times, peak memory and profiles; one SE step with a
     "balanced" lossnet;
 12. the fused path in the modes: K4b (the "default" flavour of K4: its
     five products in one bf16 pass on the tensor cores, f32
     accumulation and softmax) against its plain version at [96, 511]
     (lengths to 499, a 0-key row), [32, 50], a ragged [8, 1024] and
     every plan edge T in {1, 15, 16, 17, 63, 64, 65, 511, 1023, 1024},
     held to float64 attention of the bf16-rounded operands (|O - O_f64|
     <= 1.5 x the plain version's + 1e-6) and to K1b fed by the port's
     "default" projections (no further apart than their plain versions
     are), NaN past each bound changing no valid row, 123.0 there leaving
     every row finite, a rerun the same bits, its prologue's packed
     weights and rounded x bit-equal to their plain versions, timed beside
     ``F.linear`` + SDPA on bf16 (x rounded inside the timed call); then
     on phase 9's seeded BASE state dict
     ``Nomad(precision="fast", config=Wav2Vec2Config.fast(
     attention_impl="fused_qkv"))`` on phase 4's 108 files (K4b 24, K5 52,
     no K1, K1b or K4), held to the "fast" plain path within
     GRAD_MODE_FRAC times that plain path's distance to the "exact" plain
     path, its pairwise delta against "exact", device pass, peak and one
     profiled pass, two single files (T' = 1,023: K4b; T' = 1,433: K1b);
     the fused "fast" loss at 32 x 16,384 and 24 x 160,000 samples (K4b
     24, K1b 12, K2b 12, K3b 12, K5 52 a step) with phase 10's checks;
     and "balanced" with ``fused_qkv`` (K4h 12 a batch, no K4b: the fused
     kernel takes the projections' island);
 13. the trainer's ``fast_bf16`` (bf16 activations in the block stack):
     the bf16-I/O flavours of K5 (at [49056, 768] and [11976, 768]), K1b
     (at [96, 511] with lengths to 499, [24, 499], a ragged [8, 4095] and
     every tile and ring edge T in {1, 15, 16, 17, 63, 64, 65, 511, 127,
     128, 129, 191, 192, 193, 257}; its prologue's fold bit-equal to
     ``fold_bf16_ref`` and to the f32 flavour's)
     and K2b + K3b with their prologue (at [32, 50], [24, 499], [8, 4095]
     and the same edges; both flavours' folds the same bits), each case with
     a full, a ragged, a 1-key and a 0-key row: bit-equal to their f32-I/O
     flavour on the upcast inputs rounded once, held to their plain
     version and to float64 (phases 9 and 10's rules, plus one bf16 ulp of
     the output), NaN past each bound changing no row, a rerun the same
     bits, timed beside the f32-I/O flavour, the plain version and the
     PyTorch call on the same bf16 tensors; then phase 10's triplet recipe
     on phase 10's seeded BASE state dict with ``precision: fast_bf16``:
     the recipe's step with remat on and off (K5 2, K5-bf16 48 with remat,
     24 without), its eval step (K1b-bf16 12, K5 2, K5-bf16 24), the
     rates-at-0 step (K1b-bf16 24, K2b-bf16 12, K3b-bf16 12, K5 2, K5-bf16
     48) held to the fast_bf16 plain path by phase 10's rule; the evals'
     engine on the recipe's utterances (K1b-bf16 12, K5 2, K5-bf16 24 a
     batch; embeddings held to the plain path by phase 12's rule) and
     ``eval_audio_quality``; step times, enqueue, peak memory and profiles
     beside "fast"'s in the same run;
 14. bf16 activations on every attention path: the bf16-I/O flavours of
     K4h and K4b and K4-bf16 ("highest" on a bf16 x, K4h's template at six
     passes) (at [96, 511] with lengths to 499, [32, 50], a ragged [8,
     1024] and every plan edge T in {1, 15, 16, 17, 63, 64, 65, 511,
     1023, 1024}), K1-bf16 (the "highest" forward on bf16 tensors, K1b's
     template with three planes of P; at [96, 511], [24, 499], [32, 50], a
     ragged [8, 4095] and every edge T in {1, 15, 16, 17, 63, 64, 65, 511,
     127, 128, 129, 191, 192, 193, 257}) and K2-bf16 + K3-bf16 (the
     "highest" backward on bf16 tensors, K2b/K3b's template at three
     passes; the same, but [96, 511]), each case with a full, a ragged, a
     1-key and a 0-key row, under phase 13's rules (K4h's and K4b's
     bit-equal to the f32-I/O flavour on the upcast inputs rounded once;
     K4-bf16, K1-bf16, K2-bf16 and K3-bf16, summing in the tensor core's
     order, within one bf16 step of it beyond 1e-4 of its max, the share
     of elements that differ reported, K1-bf16's LSE no further from
     float64 than K1's x 1.5 + 1e-6, K4-bf16's three weight planes and
     K1-bf16's prologue bit-equal to their plain versions, and each one C
     call the bits of the prologue and the kernels launched alone; plain
     version and float64 plus one bf16 step; garbage past each bound; a
     rerun the same bits), timed in turns
     with the f32-I/O flavour and beside the plain version and the
     PyTorch calls of each flavour's function (bf16 calls at "default";
     f32 calls on the upcasts at "highest"; K2-bf16 + K3-bf16's call with
     its prologue at [32, 50], [24, 499] and [8, 4095]; K1-bf16, K4-bf16,
     K2-bf16 and K3-bf16 against the bound of their passes on the bf16
     tensor cores, the f32-FMA bound beside it, and the error of the P they recompute: the forward's LSE and the
     one-pass scores against float64); then on phase 9's
     seeded BASE state dict ``Wav2Vec2Config.fast(encoder_dtype=bf16,
     attention_impl="fused_qkv")`` on phase 4's 108 files (K4b-bf16 12, K5
     2, K5-bf16 24 per batch) against its plain path by phase 12's rule,
     its device pass beside the fused "fast" pass on f32 activations, peak
     and one profiled pass; "balanced" with ``fused_qkv`` (K4h-bf16 12),
     the fused path with the frontend and the encoder at "highest"
     (K4-bf16 12) and BASE (K1-bf16 12) on bf16 activations on one batch of
     96 files; the loss of the three (BASE also fused: K4h-bf16) at 32 x
     16,384 and 24 x 160,000
     samples by phase 10's rule against their own plain path; and the
     trainer's ``fast_bf16`` on the fused path at phase 13's recipe on
     phase 10's state dict: the recipe's step (the plain dropout attention,
     K5 only), its eval step (K4b-bf16 12) and the rates-at-0 step
     (K4b-bf16 24, K1b-bf16 12, K2b-bf16 12, K3b-bf16 12) by phase 10's
     rule;
 15. large-scale and data-parallel work at world size 1, in a one-rank
     NCCL group: BASELINE.json config 4 (10k degraded utterances x 100
     NMRs) cut to 1,020 degraded files of 1.5-24 s and 100 NMRs of 2-4 s
     through ``make_large_scale_scorer(...).score`` at full BASE width in
     "exact" (cold and warm wall time, wav-s/s, peak memory, K1 12 and K5
     26 a batch), held to ``Nomad.score_matrix`` on the same files (1e-5)
     and to float64 distances of its own embeddings (1e-4); then
     ``score_embeddings`` at the config's full 10,000 x 100 against
     float64; the engine over ``data_mesh()`` against the plain engine
     (1e-5, and whether the bits agree), the scorer on a 1 x 1 grid
     bit-equal to its dense path; ``Training(mesh=data_mesh())``'s recipe
     step (8 triplets x 160,000 samples, dropout 0.1, conv frozen; K5 50)
     bit-equal to the plain step from the same state and generator, both
     timed; ``graft_entry.entry()`` ([2, 256], K1b 12, K5 26) and
     ``graft_entry.dryrun_multichip(1)`` (one spawned NCCL rank);
 16. the wire codec, the q16 loader, the build cache and the dataset
     tools, on phase 9's seeded BASE weights: the codec's C++ and numpy
     encoders on phase 4's [96, 163,840] batch and the random, zeros and
     extremes payloads at [16, 163,840] (the same stream), the card's
     decode bit-equal to ``decode_numpy`` and to the input; the host
     encode, the card decode (CUDA events) and the copies of the raw batch
     and of the frame from pinned memory timed; phase 4's 108 files
     through the engine with ``wire_codec`` "off" and "on" in turns (K1
     12, K5 26 a batch; the embeddings bit-equal, every "on" batch
     packed) and once with ``serialize_pipeline``; 8 files
     at 22.05 kHz, 44.1 kHz stereo, 16 kHz FLAC and stereo with
     ``quantize_transfer`` on and off (int16 bytes only when on; the
     embeddings' and scores' distance against the 1e-3 budget); a cold
     ``python -m nomad_tpu_torch.serve`` to its first score with an empty
     ``NOMAD_TPU_TORCH_CACHE_DIR`` (K1, K5 and the native library built)
     and again with its libraries present; the degrader recipe
     (``config_audio_degrader.yaml``) on 4 seeded clean 10.5-12 s WAVs:
     the training and intensity sets (spawned workers; the codec grids
     only with ffmpeg), NSIM triplets from a seeded NSIM CSV, the CLEAN
     subset copied, and the triplet recipe's step on the generated
     ``train.csv`` with remat "full" and "dots" (K5 50 each; loss and
     gradients within 1e-6, time, peak);
 17. the JAX package's config fields that the port took last, at full
     BASE width on phase 9's seeded weights and phase 4's 108 files: the
     tail split (blocks 8-11 at "default": K1 x 8 and K1b x 4 a batch; on
     ``fused_qkv`` K4h x 8 and K4b x 4), its control (the head at
     "default", the tail at "high": K1b x 8, K1 x 4), ``matmul_precision=
     "default"`` (K1b x 12), the attention, fc2 and feature-projection
     islands at "default" (K1b x 12) and ``dtype=bfloat16`` (K1-bf16 x 12,
     K5-bf16 x 26 at widths 512 and 768): the launches of each block and
     of the pass against CONFIG_FIELD_CASES, warm device passes, the peak,
     the embeddings against the config's plain path by phase 12's rule,
     the pairwise delta against "exact" (reported); then ``dtype=bfloat16``'s
     loss at 24 x 160,000 samples against its plain path by phase 10's
     rule;
and last (phase 11) the kernels' JSON line, the card line, and the last
line ``{"ok": true, "device": {...}}``.
Exits non-zero, and prints no result, without a CUDA card or outside a
checkout of the repository. Every measurement is also printed as one
JSON object on the line that starts with "report: ". ``--only-scoring``
runs phases 1 and 4's K1 path alone (the pass time of two checkouts in
one call: copy the script into the other). ``--only-loss`` runs
phases 1 and 5 alone and ends with the report line: the same loss steps
timed over another checkout's package (the script uses no entry point
newer than the loss path's). ``--only-train`` runs phases 1 and 6 alone,
``--only-se`` phases 1 and 7, ``--only-serve`` phases 1 and 8,
``--only-precision`` phases 1, 2 and 9, ``--only-grad-modes`` phases 1, 2
and 10, ``--only-fused-modes`` phases 1, 2 and 12, ``--only-fast-bf16``
phases 1, 2 and 13, ``--only-bf16-paths`` phases 1, 2 and 14,
``--only-large-scale`` phases 1 and 15, ``--only-wire-and-tools`` phases
1, 2 and 16, ``--only-high3`` phases 1 and 2, phase 3's K4h checks and
the K4h-bf16 checks of phase 14 at the scoring shape, phase 4 and phase
5's fused loss (the paths that drive K4h), each ending with the report
line. ``--only-config-fields`` runs phases 1, 2 and 17.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from nomad_tpu_torch.api import CACHE_FILENAME, NOMAD_FILENAME, Nomad, set_exact_precision
from nomad_tpu_torch.convert.fairseq_synth import write_nomad_checkpoint
from nomad_tpu_torch.io import native, read_wav, write_wav
from nomad_tpu_torch.io.flac_encode import write_flac
from nomad_tpu_torch.models import NomadModel, Wav2Vec2Config, init_weights, wav2vec2
from nomad_tpu_torch.models.wav2vec2 import PRECISION_ISLANDS
from nomad_tpu_torch.ops import _build, cdist, flash_attention, fused_attention, layernorm
from nomad_tpu_torch.ops import precision as prec_ops
from nomad_tpu_torch.ops import wirecodec
from nomad_tpu_torch.scoring.engine import EmbeddingEngine, EmbeddingLRU
from nomad_tpu_torch.serve import NomadServer
from nomad_tpu_torch.training import SpeechEnhancement, Training, triplet
from nomad_tpu_torch.training import data as train_data
from nomad_tpu_torch.training.losses import pairwise_distance, triplet_margin_loss
from nomad_tpu_torch.utils import config as config_io

ROOT = Path(__file__).resolve().parent
# H100 SXM data-sheet peaks (at the 700 W limit): HBM rate, f32 without
# tensor cores ("exact" forbids TF32), dense bf16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12
SR = 16000
N_NMR, N_DEG, SECONDS = 8, 100, 10.0
# the SE demo's crop at its training batch (reference nomad_loss_test.py:196,
# nomad_tpu/configs/se_config.yaml:12): T' = 50 frames
LOSS_BATCH, LOSS_SAMPLES, LOSS_STEPS = 32, 16384, 7
# the loss on utterance-length clips: the triplet batch (A/P/N of batch 8)
# of 10 s trimmed to 160,000 samples gives T' = 499
LOSS10_BATCH, LOSS10_SAMPLES = 24, 160_000
# single files on the fused path: (samples, T' of their bucket); 1,023
# frames is the longest bucket K4 takes, 1,433 is past MAX_FUSED_T
FUSED_SINGLE_FILES = ((300_000, 1023), (400_000, 1433))
TOL_LN, TOL_FLASH = 1e-5, 2e-5  # f32, sums in another order than the plain version
# K2/K3 on unit-scale inputs: 2e-5 up to T = 512 keys or queries summed,
# growing as sqrt(T) beyond (rounding of a sum of T terms; at T = 4095 the
# one-key row's dK, analytically 0, is a sum of 4095 rounding residuals),
# plus 1e-5 relative: that row's dV sums every query's dO (|dV| ~ 30), one
# row after another in the kernel
TOL_FLASH_BWD, RTOL_FLASH_BWD = 2e-5, 1e-5
# K4: K1's tolerance, plus 1e-5 relative for the projections' sums of 768
# products, in another order than cuBLAS's
TOL_FUSED, RTOL_FUSED = 2e-5, 1e-5
TOL_REF_PATH, TOL_BATCH1 = 1e-4, 1e-5
TOL_LOSS_REL, TOL_GRAD_REL = 1e-5, 1e-4  # loss relative; gradient relative to max|g|
# the trainer: the recipe's config, 24 utterances of 10.5-12 s (trimmed to
# 160,000 samples: bucket 163,840, T' = 511 with 499 valid), 16 training
# and 8 validation triplets (2 steps and 1 step of batch 8), 4 NMR files
TRAIN_RECIPE = ROOT / "nomad_tpu" / "configs" / "train_triplet.yaml"
TRAIN_FILES, TRAIN_TRIPLETS, VALID_TRIPLETS, TRAIN_NMR = 24, 16, 8, 4
TRAIN_STEPS, TRAIN_SEED = 5, 6
ZERO_RATES = {"dropout": 0.0, "attention_dropout": 0.0, "activation_dropout": 0.0}
PLAIN_ATTENTION = "plain_attention"  # the profiler range around the dropout attention
# parameters whose gradient is 0 analytically (softmax does not see a
# shift shared by every key): Adam may leave them where they are
ZERO_GRAD_PARAMS = (".k_proj.bias",)
# the SE demo: the recipe of se_config.yaml; 64 training pairs (2 steps of
# 32), one validation batch of 100, 16 test pairs
SE_RECIPE = ROOT / "nomad_tpu" / "configs" / "se_config.yaml"
SE_TRAIN, SE_VALID, SE_TEST, SE_STEPS = 64, 100, 16, 7
UNET_RANGE = "wave_unet_forward"  # the profiler range around the U-Net's forward
TOL_SE_STATS = 1e-5  # running statistics after a step, kernel vs plain path
# conv biases ahead of a batch norm: their gradient is 0 analytically, so
# Adam may leave them where they are
SE_PRE_BN_BIAS = ".conv.bias"
# the scoring service: FLAC twins of 4 degraded files (112 files, a batch of
# 96 and a tail of 16), 4 new files and 16 cached ones in the embed request,
# the loss of 4 crops; the .pt's weights seed; phase 4's own scoring peak
# as PERF.md gives it, the service's bound when phase 4 does not run
# (--only-serve)
SERVE_TWINS, SERVE_NEW, SERVE_LOSS_BATCH, SERVE_SEED = (3, 10, 50, 97), 4, 4, 8
N_SERVE = N_NMR + N_DEG + len(SERVE_TWINS)
SERVE_KEYS = ("ping", "score", "score_repeat", "embed", "loss", "stats", "shutdown")
SERVE_TIMEOUT_S = 600
PEAK_SCORING_GB = 13.375
# the precision modes: the pairwise score delta against "exact" is
# reported against the scores' 1e-3 budget (BASELINE.md) and fails beyond
# ten times it, which only a fault can reach on seeded weights; the peak
# memory of a mode may exceed "exact"'s by 0.1 GB; the stress set of the
# JAX package's precision studies (scripts/precision_ladder.py)
MODES = ("exact", "balanced", "fast")
DELTA_BUDGET, DELTA_FAULT, MODE_PEAK_SLACK_GB = 1e-3, 1e-2, 0.1
# a "default" island's card route vs the float64 sum of its bf16 operands,
# relative to max |y|: f32 sums of <= 6,144 products; the stress files
# whose embeddings each mode compares on the card and on the CPU, and the
# share of a mode's distance to "exact" that the two may differ by
ROUTE_TOL, MODES_VS_PLAIN_FILES, MODE_PLAIN_FRAC = 1e-5, 4, 0.5
# a bf16 mode's loss step or train step on the kernels (K) against the
# same mode's plain path (P). Two f32 orders round some bf16 operand the
# other way and the next islands carry that on, so K and P are two bf16
# realizations of one mode, each about the mode's own distance D from
# "exact": by the triangle inequality up to ~2 D apart. D is taken from
# code that is not under test: P against the "exact" plain path (EP), on
# the same inputs, so a fault in K cannot widen its own tolerance. A
# fault smaller than D (a kernel output off by 1 %) hides in that
# spread; the path's own attention backward calls, recorded on the way
# and held to their plain version on the same inputs, catch those.
GRAD_MODE_FRAC = 2.0
# K2b/K3b (through flash_attention_bwd) against their plain version on the
# same inputs, for each of dQ, dK and dV: max |d| / max |g| (on the kernel
# checks' random inputs; on a path's own calls) and ||d|| / ||g||. Both
# round the same operands to bf16, so what differs is f32 summation order
# and the bf16 roundings of P and dS that it flips: a flip moves a few
# elements by up to 2^-8 of their largest term, where a fault (a 1 %
# scale, a swap) moves them all. Measured on an H100: max 1.22e-3 on
# random inputs, 3.74e-3 on the loss and train steps' calls; norm 3.6e-5
# and 2.78e-4; ~3x those. dQ scaled by 1.01 gives 1e-2 in both.
BWD_BF16_PLAIN_REL, BWD_BF16_PATH_REL, BWD_BF16_PLAIN_NORM = 3.5e-3, 1e-2, 1e-3
STRESS_DEG, STRESS_NMR = 48, 16
# K4b against K1b fed by the port's "default" projections, on the same
# inputs: no further apart than their two plain versions are (measured on
# an H100: K4b and K1b give the same bits there), plus 1e-6
FUSED_BF16_VS_K1B = 1.0
# phase 13's bf16-I/O flavours (bf16 in and out) against their plain
# version and float64: phases 9 and 10's rules plus one bf16 step of the
# output, relative to the largest value (two roundings of f32 values that
# lie close may fall on either side of a bf16 boundary)
BF16_ULP_REL = 2.0 ** -7
BWD_NOISE = 1e-4
# K2's and K3's bf16-I/O flavour (f32 products) against their plain version
# on the same bf16 inputs, before the bf16 step: f32 sums in two orders
BWD_F32_PLAIN_REL = 1e-4
# K1-bf16's and K4-bf16's O (f32-exact products on the tensor cores)
# against the f32 flavour's rounded once: one bf16 step beyond this share of
# the f32 flavour's max |O| (two f32 orders: an element whose sum cancelled
# carries its terms' rounding)
FWD_F32_PLAIN_REL = 1e-4
# phase 14's loss steps: fewer warm steps timed than phase 5's, to keep the
# phase near a minute
BF16_PATH_LOSS_STEPS = 3
# the edges of K1b's ring of 4 (K, V) stages: T in 2, 3 and 4 tiles and past
K1B_RING_EDGES = (127, 128, 129, 191, 192, 193, 257)

DEV = torch.device("cuda")
report: dict = {"kernels": {}, "checks": {}}
SHARED: dict = {}  # phase 9's and phase 10's seeded BASE state dicts, for phases 12 and 13


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def settled_allocated_gb() -> float:
    """What is still allocated on the card once garbage is collected and
    the cuBLAS workspaces are released (every thread that ran a GEMM keeps
    one, the backward's too): what a phase inherits from the ones before."""
    gc.collect()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated() / 1e9


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of fn() over iters calls (CUDA events, warmed up)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_pair_ms(fn_a, fn_b, iters: int, rounds: int = 1) -> tuple[float, float]:
    """Device times of two functions (``time_ms``) taken in turns a, b, b,
    a, so that the card's clock drift falls on both alike: the mean of each
    one's two turns, the median of that over ``rounds`` such rounds (for a
    yardstick whose time spreads between runs, read beside the kernel in
    the same minutes)."""
    a, b = [], []
    for _ in range(rounds):
        a1, b1, b2, a2 = (time_ms(fn, iters) for fn in (fn_a, fn_b, fn_b, fn_a))
        a.append((a1 + a2) / 2)
        b.append((b1 + b2) / 2)
    return float(np.median(a)), float(np.median(b))


def device_kernels(fn) -> dict:
    """Device time (ms) by kernel name of one warm fn() under torch.profiler."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names: dict = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            names[evt.name[:120]] = names.get(evt.name[:120], 0.0) + evt.time_range.elapsed_us() / 1e3
    return dict(sorted(names.items(), key=lambda x: -x[1]))


def bound(nbytes: float, flops: float, peak_flops: float = F32_FLOPS) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------- phase 1: the card ----------------


def card_info() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    line = smi.stdout.strip().splitlines()[0]
    report["card"] = {"nvidia_smi": line, "torch_name": torch.cuda.get_device_name(0),
                      "count": torch.cuda.device_count()}
    print(f"card: {line} | torch: {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    return line


# ---------------- phase 2: build ----------------

# kernels whose ptxas lines the spill check must find, by source: the
# K1b, K1-bf16, K2b/K3b, K2-bf16/K3-bf16, K4b, K4h and K4-bf16 prologues and
# kernels (each flavour a template instance; K4b's pass count 1, K4h's 3,
# K4-bf16's 6 and their prologues' planes 1, 2 and 3; K1b's, K2b/K3b's 1
# and K1-bf16's, K2-bf16/K3-bf16's 3 on bf16 I/O, as the mangled names give
# them)
PTXAS_ENTRIES = {
    "fused_attention_bf16": ("fused_qkv_fwd_bf16_kernelILi1E", "fused_qkv_fwd_bf16_kernelILi3E",
                             "fused_qkv_fwd_bf16_kernelILi6E", "pack_kernelILi1E",
                             "pack_kernelILi2E", "pack_kernelILi3E"),
    "flash_attention_bf16": ("flash_fwd_bf16_kernelIfLi1E",
                             "flash_fwd_bf16_kernelI13__nv_bfloat16Li1E",
                             "flash_fwd_bf16_kernelI13__nv_bfloat16Li3E",
                             "flash_fwd_fold_bf16_kernel"),
    "flash_attention_bwd_bf16": ("flash_bwd_dq_bf16_kernelIfLi1E", "flash_bwd_dkv_bf16_kernelIfLi1E",
                                 "flash_bwd_dq_bf16_kernelI13__nv_bfloat16Li1E",
                                 "flash_bwd_dkv_bf16_kernelI13__nv_bfloat16Li1E",
                                 "flash_bwd_dq_bf16_kernelI13__nv_bfloat16Li3E",
                                 "flash_bwd_dkv_bf16_kernelI13__nv_bfloat16Li3E",
                                 "flash_bwd_fold_bf16_kernel"),
}


def build_kernels() -> None:
    t0 = time.perf_counter()
    logs = _build.build()
    report["build_s"] = time.perf_counter() - t0
    print(f"build: {len(logs)} kernel sources in {report['build_s']:.1f} s", flush=True)
    t0 = time.perf_counter()
    if not native.available():  # the C++ ingest library every scoring path reads files with
        fail(f"the native ingest library did not build: {native.build_error()}")
    report["native_build_s"] = time.perf_counter() - t0
    print(f"build: native ingest library {native.library_path().name} in "
          f"{report['native_build_s']:.1f} s", flush=True)
    spills = []
    missing = [f"{name}: {sym}" for name, syms in PTXAS_ENTRIES.items() for sym in syms
               if not any(sym in line and "Compiling entry" in line
                          for line in logs.get(name, "").splitlines())]
    if missing:
        fail("ptxas' log lacks a kernel the spill check must cover: " + "; ".join(missing))
    for name, log in logs.items():
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "smem", "Compiling entry")):
                print(f"  ptxas[{name}]: {line.strip()}")
            spills += [f"{name}: {line.strip()}" for n in re.findall(r"(\d+) bytes spill", line)
                       if int(n)]
    if spills:
        fail("ptxas spills registers: " + "; ".join(spills))
    # resident blocks per SM (and K4's clusters on the card) at each
    # kernel's shared memory, from the CUDA occupancy API
    occ = {"flash_attention_fwd": {"blocks_per_sm": flash_attention.flash_occupancy(),
                                   "smem_bytes": flash_attention.FLASH_SMEM_BYTES}}
    # K1b in both I/O flavours; K1-bf16 ("highest", three planes of P)
    for prec, io, name in (("default", False, "flash_attention_bf16_fwd"),
                           ("default", True, "flash_attention_bf16io_fwd"),
                           ("highest", True, "flash_attention_f32_bf16io_fwd")):
        plan = flash_attention.flash_bf16_launch_plan(511, 1, 12, prec)
        blocks = flash_attention.flash_bf16_occupancy(bf16_io=io, precision=prec)
        occ[name] = {"blocks_per_sm": blocks, "plan_blocks_per_sm": plan["blocks_per_sm"],
                     "smem_bytes": plan["smem_bytes"], "stages": plan["stages"],
                     "passes": plan["passes"]}
        if blocks < plan["blocks_per_sm"]:
            fail(f"K1b's template ({name}): {blocks} blocks per SM, the plan claims "
                 f"{plan['blocks_per_sm']}")
    for t in (50, 499):  # K2/K3's plans: 32-row blocks up to T = 64, 64-row beyond
        for kernel, plan in flash_attention.flash_bwd_launch_plan(t, 1, 12).items():
            blocks = flash_attention.flash_bwd_occupancy(kernel, plan["rows_per_block"])
            occ[f"flash_attention_bwd_{kernel}_T{t}"] = {
                "rows_per_block": plan["rows_per_block"], "blocks_per_sm": blocks,
                "plan_blocks_per_sm": plan["blocks_per_sm"],
                "smem_bytes": plan["smem_bytes"]}
            if blocks < plan["blocks_per_sm"]:
                fail(f"K2/K3 {kernel} at T = {t}: {blocks} blocks per SM, the plan "
                     f"claims {plan['blocks_per_sm']}")
    # K2b/K3b in both I/O flavours; K2-bf16/K3-bf16 ("highest", three passes)
    for prec, io, tag in (("default", False, "bf16"), ("default", True, "bf16io"),
                          ("highest", True, "f32_bf16io")):
        for kernel, plan in flash_attention.flash_bwd_bf16_launch_plan(499, 1, 12, prec).items():
            blocks = flash_attention.flash_bwd_bf16_occupancy(kernel, bf16_io=io, precision=prec)
            occ[f"flash_attention_bwd_{kernel}_{tag}"] = {
                "blocks_per_sm": blocks, "plan_blocks_per_sm": plan["blocks_per_sm"],
                "smem_bytes": plan["smem_bytes"], "passes": plan["passes"]}
            if blocks < plan["blocks_per_sm"]:
                fail(f"K2b/K3b's template {kernel} ({tag}): {blocks} blocks per SM, the plan "
                     f"claims {plan['blocks_per_sm']}")
    for t in (50, 65, 511, 1024):
        for prec, io, name in (("highest", False, "fused_qkv_attention_fwd"),
                               ("highest", True, "fused_qkv_attention_f32_bf16io_fwd"),
                               ("high", False, "fused_qkv_attention_high3_fwd"),
                               ("high", True, "fused_qkv_attention_high3_bf16io_fwd")):
            plan = fused_attention.fused_launch_plan(t, 1, 12, prec, io)
            blocks, clusters = fused_attention.fused_occupancy(t, prec, io)
            occ[f"{name}_T{t}"] = {
                "cluster": plan.cluster, "tensors_per_block": plan.tensors_per_block,
                "blocks_per_sm": blocks, "clusters_on_card": clusters,
                "smem_bytes": plan.smem_bytes, "threads": plan.threads}
            # K4h and K4-bf16: their planes fill the shared memory of one
            # block an SM
            if prec == "high" and (blocks < fused_attention.FUSED_HIGH3_BLOCKS_PER_SM
                                   or clusters < 1):
                fail(f"K4h ({name}) at cluster {plan.cluster}: {blocks} blocks per SM (built for "
                     f"{fused_attention.FUSED_HIGH3_BLOCKS_PER_SM}), {clusters} clusters")
            if prec == "highest" and io and (
                    blocks < fused_attention.FUSED_HIGHEST_BF16_BLOCKS_PER_SM or clusters < 1):
                fail(f"K4-bf16 ({name}) at cluster {plan.cluster}: {blocks} blocks per SM (built "
                     f"for {fused_attention.FUSED_HIGHEST_BF16_BLOCKS_PER_SM}), {clusters} "
                     "clusters")
    # K4b at every cluster size of its plan: 3 (T <= 64), then 2 .. 16
    for t in [50] + [64 * c for c in range(2, fused_attention.MAX_CLUSTER + 1)]:
        for io, name in ((False, "fused_qkv_attention_bf16_fwd"),
                         (True, "fused_qkv_attention_bf16io_fwd")):
            plan = fused_attention.fused_launch_plan(t, 1, 12, "default")
            blocks, clusters = fused_attention.fused_occupancy(t, "default", io)
            occ[f"{name}_T{t}"] = {
                "cluster": plan.cluster, "tensors_per_block": plan.tensors_per_block,
                "blocks_per_sm": blocks, "clusters_on_card": clusters,
                "smem_bytes": plan.smem_bytes, "threads": plan.threads}
            if blocks < fused_attention.FUSED_BF16_BLOCKS_PER_SM or clusters < 1:
                fail(f"K4b ({name}) at cluster {plan.cluster}: {blocks} blocks per SM (built "
                     f"for {fused_attention.FUSED_BF16_BLOCKS_PER_SM}), {clusters} clusters")
    report["occupancy"] = occ
    print("occupancy: " + "; ".join(f"{k} {v}" for k, v in occ.items()), flush=True)


# ---------------- phase 3: kernels against their plain versions ----------------


def check_layernorm(rows: int, width: int, g: torch.Generator) -> dict:
    x = (3 * torch.randn(rows, width, generator=g) + 1).to(DEV)
    w = (1 + 0.1 * torch.randn(width, generator=g)).to(DEV)
    b = (0.1 * torch.randn(width, generator=g)).to(DEV)
    out = layernorm.layer_norm(x, w, b)
    ref = layernorm.layer_norm_ref(x, w, b)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    if not torch.isfinite(out).all() or err > TOL_LN:
        fail(f"layernorm [{rows}, {width}] max|d| {err:.3g} > {TOL_LN}")
    nbytes = 2 * rows * width * 4 + 2 * width * 4
    b_ms, b_by = bound(nbytes, 8.0 * rows * width)
    res = {
        "shape": [rows, width], "max_abs_err": err,
        "ms": time_ms(lambda: layernorm.layer_norm(x, w, b), 50),
        "plain_ms": time_ms(lambda: layernorm.layer_norm_ref(x, w, b), 20),
        "library_ms": time_ms(lambda: F.layer_norm(x, (width,), w, b, 1e-5), 50),
        "bound_ms": b_ms, "bound_by": b_by,
    }
    print(f"  layernorm [{rows}, {width}]: max|d| {err:.3g}  kernel {res['ms']:.4f} ms  "
          f"plain {res['plain_ms']:.4f}  F.layer_norm {res['library_ms']:.4f}  "
          f"bound {b_ms:.4f} ({b_by})", flush=True)
    return res


def flash_bound(b: int, t: int, h: int, d: int, lengths: torch.Tensor,
                peak_flops: float = F32_FLOPS, io_bytes: int = 4,
                pv_passes: int = 1) -> tuple[float, str]:
    """All T query rows are written; keys past lengths[b] are never read.
    q, k, v and O take ``io_bytes`` an element, LSE and lengths 4. S is one
    product, P . V ``pv_passes`` (K1-bf16's three planes of P: 3)."""
    keys = int(lengths.sum())
    flops = 2.0 * (1 + pv_passes) * h * d * t * keys
    nbytes = io_bytes * (2 * b * t * h * d + 2 * keys * h * d) + 4.0 * (b * h * t + b)
    return bound(nbytes, flops, peak_flops)


def check_flash(b: int, t: int, lengths: list, g: torch.Generator, timed: bool) -> dict:
    h, d = 12, 64
    # one [B, T, 3, H, D] buffer viewed as q, k, v: the strided layout the
    # model's projections hand over
    qkv = torch.randn(b, t, 3, h, d, generator=g).to(DEV)
    q, k, v = qkv.unbind(2)
    lens = torch.tensor(lengths, dtype=torch.int32, device=DEV)
    o, lse = flash_attention.mha_flash(q, k, v, lens)
    torch.cuda.synchronize()
    err = 0.0
    for i in range(b):  # the plain version row by row: [1, H, T, T] at a time
        ro, rlse = flash_attention.flash_attention_ref(q[i:i + 1], k[i:i + 1], v[i:i + 1], lens[i:i + 1])
        err = max(err, (o[i:i + 1] - ro).abs().max().item(), (lse[i:i + 1] - rlse).abs().max().item())
    finite = bool(torch.isfinite(o).all() and torch.isfinite(lse).all())
    if not finite or err > TOL_FLASH:
        fail(f"flash [{b}, {t}, {h}, {d}] finite={finite} max|d| {err:.3g} > {TOL_FLASH}")
    b_ms, b_by = flash_bound(b, t, h, d, lens)
    res = {"shape": [b, t, h, d], "lengths_sum": int(lens.sum()), "max_abs_err": err,
           "bound_ms": b_ms, "bound_by": b_by}
    res["ms"] = time_ms(lambda: flash_attention.mha_flash(q, k, v, lens), 10 if t > 1024 else 30)
    if timed:
        mask = (torch.arange(t, device=DEV)[None, :] < lens[:, None])[:, None, None, :]
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        res["plain_ms"] = time_ms(lambda: flash_attention.flash_attention_ref(q, k, v, lens), 5)
        res["library_ms"] = time_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask), 10)
    print(f"  flash [{b}, {t}, {h}, {d}] keys {int(lens.sum())}: max|d| {err:.3g}  "
          f"kernel {res['ms']:.4f} ms  plain {res.get('plain_ms', float('nan')):.4f}  "
          f"sdpa {res.get('library_ms', float('nan')):.4f}  bound {b_ms:.4f} ({b_by})", flush=True)
    return res


def flash_bwd_bounds(b: int, t: int, h: int, d: int, lengths: torch.Tensor,
                     peak_flops: float = F32_FLOPS, io_bytes: int = 4,
                     out_bytes: int | None = None, passes: int = 1) -> dict:
    """Per kernel: every (query row, valid key) pair costs K2 6*D FLOP (s,
    dP, dQ) and K3 8*D (s, dP, dK, dV); with ``passes`` = 3 (K2-bf16,
    K3-bf16: dQ, dK and dV each three bf16 passes) 10*D and 16*D on the
    tensor cores. Bytes: the valid keys' k and v,
    q, dO, LSE and Di of the batch rows that have a key, and the outputs
    (dQ; dK and dV), each once; q, k, v and dO ``io_bytes`` an element,
    the outputs ``out_bytes`` (``io_bytes`` unless given), LSE and Di 4.
    K2b and K3b read their prologue's bf16 fold, not the inputs: their own
    bound takes ``io_bytes=2`` and the outputs at the flavour's width."""
    lens = lengths.long()
    keys, live = int(lens.sum()), int((lens > 0).sum())
    pairs = t * keys
    row = float(io_bytes) * h * d
    out_row = float(io_bytes if out_bytes is None else out_bytes) * h * d
    reads = 2 * keys * row + 2 * live * t * row + 2 * live * h * t * 4.0
    return {"dq": bound(reads + b * t * out_row, 2.0 * (2 + passes) * h * d * pairs, peak_flops),
            "dkv": bound(reads + 2 * b * t * out_row, 2.0 * (2 + 2 * passes) * h * d * pairs,
                         peak_flops)}


def check_flash_bwd(b: int, t: int, lengths: list, g: torch.Generator, timed: bool,
                    kernel_times: bool = True) -> dict:
    """K2 and K3 against flash_attention_bwd_ref on the card. NaN is written
    into k and v past each row's bound; dK and dV must be exactly 0 there,
    and a second call must give the same bits. ``kernel_times``: time K2
    and K3; ``timed``: the plain version and SDPA's gradient too."""
    h, d = 12, 64
    qkv = torch.randn(b, t, 3, h, d, generator=g).to(DEV)
    q, k, v = qkv.unbind(2)
    for i, n in enumerate(lengths):
        k[i, n:] = float("nan")
        v[i, n:] = float("nan")
    lens = torch.tensor(lengths, dtype=torch.int32, device=DEV)
    o, lse = flash_attention.mha_flash(q, k, v, lens)
    do = torch.randn(b, t, h, d, generator=g).to(DEV)
    do_, di, lens_ = flash_attention._bwd_args(q, k, v, o, lse, do, lens)
    dq = flash_attention._bwd_dq_kernel(q, k, v, do_, lse, di, lens_)
    dk, dv = flash_attention._bwd_dkv_kernel(q, k, v, do_, lse, di, lens_)
    torch.cuda.synchronize()
    err = {"dq": 0.0, "dkv": 0.0}
    atol = TOL_FLASH_BWD * max(1.0, (t / 512) ** 0.5)
    excess = 0.0  # max of |d| - (atol + rtol |ref|): > 0 fails
    for i in range(b):  # the plain version row by row: [1, H, T, T] at a time
        sl = slice(i, i + 1)
        rq, rk, rv = flash_attention.flash_attention_bwd_ref(
            q[sl], k[sl], v[sl], o[sl], lse[sl], do[sl], lens[sl])
        for key, ours, ref in (("dq", dq, rq), ("dkv", dk, rk), ("dkv", dv, rv)):
            diff = (ours[sl] - ref).abs().nan_to_num(nan=float("inf"))  # a NaN fails
            err[key] = max(err[key], diff.max().item())
            excess = max(excess, (diff - atol - RTOL_FLASH_BWD * ref.abs()).max().item())
    finite = all(bool(torch.isfinite(x).all()) for x in (dq, dk, dv))
    zero_past = all(bool((dk[i, n:] == 0).all() and (dv[i, n:] == 0).all())
                    for i, n in enumerate(lengths))
    zero_rows = all(bool((dq[i] == 0).all()) for i, n in enumerate(lengths) if n == 0)
    again = (flash_attention._bwd_dq_kernel(q, k, v, do_, lse, di, lens_),
             *flash_attention._bwd_dkv_kernel(q, k, v, do_, lse, di, lens_))
    same_bits = all(torch.equal(x, y) for x, y in zip((dq, dk, dv), again))
    del again
    if not (finite and zero_past and zero_rows and same_bits) or excess > 0:
        fail(f"flash bwd [{b}, {t}, {h}, {d}] finite={finite} zero past bound={zero_past} "
             f"zero rows={zero_rows} rerun same bits={same_bits} max|d| {err} beyond "
             f"{atol:.3g} + {RTOL_FLASH_BWD}|ref| by {excess:.3g}")
    bounds = flash_bwd_bounds(b, t, h, d, lens)
    iters = 10 if t > 1024 else 30
    res = {"shape": [b, t, h, d], "lengths": lengths, "lengths_sum": int(lens.sum()),
           "tolerance": [atol, RTOL_FLASH_BWD]}
    for key, fn in (("dq", lambda: flash_attention._bwd_dq_kernel(q, k, v, do_, lse, di, lens_)),
                    ("dkv", lambda: flash_attention._bwd_dkv_kernel(q, k, v, do_, lse, di, lens_))):
        res[key] = {"max_abs_err": err[key], "bound_ms": bounds[key][0], "bound_by": bounds[key][1]}
        if kernel_times:
            res[key]["ms"] = time_ms(fn, iters)
    if not kernel_times:
        print(f"  flash bwd [{b}, {t}, {h}, {d}] lengths {lengths}: K2 max|d| {err['dq']:.3g}, "
              f"K3 max|d| {err['dkv']:.3g} (<= {atol:.3g} + {RTOL_FLASH_BWD}|ref|), "
              "rerun same bits", flush=True)
        return res
    if timed:
        # one plain call and one library call compute K2 and K3's outputs
        # together: both times stand on both rows
        plain = time_ms(lambda: flash_attention.flash_attention_bwd_ref(
            q, k, v, o, lse, do, lens), 5)
        qt, kt, vt = (x.detach().transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
        mask = None
        if int(lens.min()) < t:
            mask = (torch.arange(t, device=DEV)[None, :] < lens[:, None])[:, None, None, :]
        out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
        dot = do.transpose(1, 2)
        lib = time_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True), 10)
        for key in ("dq", "dkv"):
            res[key]["plain_ms"], res[key]["library_ms"] = plain, lib
        res["library_kernels_ms"] = device_kernels(
            lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True))
    if "library_kernels_ms" in res:
        print(f"  flash bwd [{b}, {t}, {h}, {d}]: SDPA's gradient launches "
              + "; ".join(f"{n} {ms:.4f} ms" for n, ms in res["library_kernels_ms"].items()))
    print(f"  flash bwd [{b}, {t}, {h}, {d}] keys {int(lens.sum())}: "
          f"K2 dQ max|d| {err['dq']:.3g} {res['dq']['ms']:.4f} ms (bound {bounds['dq'][0]:.4f}); "
          f"K3 dK/dV max|d| {err['dkv']:.3g} {res['dkv']['ms']:.4f} ms "
          f"(bound {bounds['dkv'][0]:.4f}); plain pair {res['dq'].get('plain_ms', float('nan')):.4f} "
          f"ms, sdpa grad {res['dq'].get('library_ms', float('nan')):.4f} ms", flush=True)
    return res


def fused_bound(b: int, t: int, h: int, dm: int, lengths: torch.Tensor,
                peak_flops: float = F32_FLOPS, x_bytes: int = 4,
                passes: tuple = (1, 1)) -> tuple[float, str]:
    """Q is projected for all T rows, K and V for the valid keys only, and
    every query row attends the valid keys; ``passes``: the bf16 passes of
    the projections and of the two attention products (K4h's high3: 3 and
    3, on a bf16 x, whose lo plane is 0, 2 and 3). Bytes: x, the three
    weights and biases, lengths and O, each once; x and O ``x_bytes`` an
    element, the rest 4."""
    keys = int(lengths.long().sum())
    flops = passes[0] * (2.0 * b * t * dm * dm + 4.0 * keys * dm * dm) + (
        passes[1] * 4.0 * h * 64 * t * keys)
    nbytes = x_bytes * 2.0 * b * t * dm + 4.0 * (3 * dm * dm + 3 * dm + b)
    return bound(nbytes, flops, peak_flops)


def check_fused(b: int, t: int, lengths: list, g: torch.Generator, timed: bool) -> dict:
    """K4 against fused_qkv_attention_ref on the card, x at unit scale and
    the weights at the seeded init's (std 1/sqrt(768)). Where a row is
    ragged, x is zero past its bound for the comparison, and the valid
    rows of a call with 123.0 there must be the same bits."""
    h, dm = 12, 768
    x = torch.randn(b, t, dm, generator=g)
    params = [a.to(DEV) for _ in range(3) for a in (
        torch.randn(dm, dm, generator=g) / dm**0.5, 0.1 * torch.randn(dm, generator=g))]
    for i, n in enumerate(lengths):
        x[i, n:] = 0.0
    x = x.to(DEV)
    lens = torch.tensor(lengths, dtype=torch.int32, device=DEV)
    o = fused_attention.fused_qkv_mha(x, *params, lens, h)
    ref = fused_attention.fused_qkv_attention_ref(x, *params, lens, h)
    torch.cuda.synchronize()
    diff = (o - ref).abs()
    err = diff.max().item()
    excess = (diff - TOL_FUSED - RTOL_FUSED * ref.abs()).max().item()
    garbage_ok = True
    if min(lengths) < t:
        x_bad = x.clone()
        for i, n in enumerate(lengths):
            x_bad[i, n:] = 123.0
        o_bad = fused_attention.fused_qkv_mha(x_bad, *params, lens, h)
        garbage_ok = bool(torch.isfinite(o_bad).all()) and all(
            torch.equal(o_bad[i, :, :n], o[i, :, :n]) for i, n in enumerate(lengths))
        del x_bad, o_bad
    finite = bool(torch.isfinite(o).all())
    if not (finite and garbage_ok) or excess > 0:
        fail(f"fused [{b}, {t}, {dm}] finite={finite} garbage past bound ignored={garbage_ok} "
             f"max|d| {err:.3g} beyond {TOL_FUSED} + {RTOL_FUSED}|ref| by {excess:.3g}")
    del ref, diff
    b_ms, b_by = fused_bound(b, t, h, dm, lens)
    res = {"shape": [b, t, dm], "heads": h, "lengths_sum": int(lens.sum()), "max_abs_err": err,
           "tolerance": [TOL_FUSED, RTOL_FUSED], "bound_ms": b_ms, "bound_by": b_by,
           "ms": time_ms(lambda: fused_attention.fused_qkv_mha(x, *params, lens, h), 20)}
    if timed:
        res["plain_ms"] = time_ms(
            lambda: fused_attention.fused_qkv_attention_ref(x, *params, lens, h), 5)
        res["library_ms"] = time_ms(fused_yardstick(x, params, lens, h), 10)
    print(f"  fused [{b}, {t}, {dm}] keys {int(lens.sum())}: max|d| {err:.3g}  "
          f"kernel {res['ms']:.4f} ms  plain {res.get('plain_ms', float('nan')):.4f}  "
          f"F.linear + sdpa {res.get('library_ms', float('nan')):.4f}  "
          f"bound {b_ms:.4f} ({b_by})", flush=True)
    return res


def garbage_past_bound_ok(kernel, x, o, lengths: list) -> bool:
    """A fused kernel (``kernel(x)`` -> O head-major) given NaN past each
    row's bound, then 123.0 there: every valid row the bits of ``o`` (its
    call on x with zeros there), and with 123.0 every row finite (a padded
    query row takes its Q from x, as the TPU kernel's does)."""
    ok = True
    ragged = min(lengths) < x.shape[1]
    for fill, whole in ((float("nan"), False), (123.0, True)) if ragged else ():
        x_bad = x.clone()
        for i, n in enumerate(lengths):
            x_bad[i, n:] = fill
        o_bad = kernel(x_bad)
        ok &= all(torch.equal(o_bad[i, :, :n], o[i, :, :n]) for i, n in enumerate(lengths))
        if whole:
            ok &= bool(torch.isfinite(o_bad).all())
        del x_bad, o_bad
    return ok


def fused_yardstick(x, params, lens, h: int):
    """One PyTorch computation of the fused kernel's function in f32: a
    product against the stacked [3 * 768, 768] weights (TF32 off; a bf16 x
    upcast inside the call), then SDPA with the key mask (two library
    calls)."""
    b, t, _ = x.shape
    wqkv, bqkv = torch.cat(params[0::2]), torch.cat(params[1::2])
    mask = None
    if int(lens.min()) < t:
        mask = (torch.arange(t, device=DEV)[None, :] < lens[:, None])[:, None, None, :]

    def library():
        q, k, v = F.linear(x.float(), wqkv, bqkv).view(b, t, 3, h, 64).permute(2, 0, 3, 1, 4)
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)

    return library


def check_fused_high3(b: int, t: int, lengths: list, g: torch.Generator, timed: bool,
                      kernel_time: bool = True) -> dict:
    """K4h (the TPU kernel's "high3") against fused_qkv_attention_ref(...,
    "high") on the card, x at unit scale and zero past each bound, the
    weights at the seeded init's scale: within TOL_FUSED + RTOL_FUSED |ref|
    of the plain version (f32 sums in another order: K4h sums each stage's
    three passes in the tensor core and the stages in f32, the plain
    version each pass in cuBLAS; a bf16 split that order flips moves an
    element by 2^-16 of it); O no further from float64 attention of the
    unrounded operands than 1.5 x the plain version's distance + 1e-6, and
    no nearer than half of it (both drop every lo.lo term), over the call
    (in one batch row a flip, ~1.5e-5, can outweigh that row's own high3
    error: K1b's rule holds per row for bf16 errors, not for these); every row
    finite; a 0-key row 0; NaN past each bound the same bits in every
    valid row, 123.0 there every row finite and the valid rows the same
    bits; a rerun the same bits; the prologue's split packed weights and
    split x bit-equal to ``pack_weights_ref(..., planes=2)`` and
    ``split_bf16``. ``timed``: the plain version and the yardstick, f32
    ``F.linear`` + SDPA (``fused_yardstick``: the same function computed
    more precisely; no PyTorch call computes bf16 x 3)."""
    h, dm = 12, 768
    x = torch.randn(b, t, dm, generator=g)
    params = [a.to(DEV) for _ in range(3) for a in (
        torch.randn(dm, dm, generator=g) / dm**0.5, 0.1 * torch.randn(dm, generator=g))]
    for i, n in enumerate(lengths):
        x[i, n:] = 0.0
    x = x.to(DEV)
    lens = torch.tensor(lengths, dtype=torch.int32, device=DEV)

    def kernel(xx=x):
        return fused_attention.fused_qkv_mha(xx, *params, lens, h, "high")

    o = kernel()
    ref = fused_attention.fused_qkv_attention_ref(x, *params, lens, h, "high")
    torch.cuda.synchronize()
    diff = (o - ref).abs()
    err = diff.max().item()
    excess_plain = (diff - TOL_FUSED - RTOL_FUSED * ref.abs()).max().item()
    del diff
    err_f64 = err_plain_f64 = 0.0
    for i in range(b):  # one batch row at a time: [1, H, T, T] in float64
        sl = slice(i, i + 1)
        exact = fused_f64_of(x[sl], params, lens[sl], h, rounded=False)
        err_f64 = max(err_f64, (o[sl].double() - exact).abs().max().item())
        err_plain_f64 = max(err_plain_f64, (ref[sl].double() - exact).abs().max().item())
        del exact
    excess = err_f64 - (1.5 * err_plain_f64 + 1e-6)
    checks = {"finite": bool(torch.isfinite(o).all()),
              "zero_key_rows": all(bool((o[i] == 0).all()) for i, n in enumerate(lengths)
                                   if n == 0),
              "rerun_same_bits": torch.equal(kernel(), o),
              "vs_plain": excess_plain <= 0, "vs_f64": excess <= 0,
              "rounds": err_f64 >= 0.5 * err_plain_f64}
    checks["garbage_past_bound"] = garbage_past_bound_ok(kernel, x, o, lengths)
    # the prologue's buffers: the packed weights' and x's hi and lo planes
    workspace = fused_attention._bf16_workspace(x, h, planes=2)
    fused_attention._launch("high", x, *params, lens, h, workspace=workspace)
    checks["split_planes"] = torch.equal(
        workspace[0], fused_attention.pack_weights_ref(*params[0::2], h, planes=2)) and \
        torch.equal(workspace[1], torch.cat(prec_ops.split_bf16(x)).to(torch.bfloat16))
    del workspace
    if not all(checks.values()):
        fail(f"fused high3 [{b}, {t}, {dm}] lengths {lengths[:8]}: {checks}; max|d| {err:.3g} "
             f"beyond {TOL_FUSED} + {RTOL_FUSED}|ref| by {excess_plain:.3g}; max|O - O_f64| "
             f"{err_f64:.3g} beyond 1.5 x the plain version's {err_plain_f64:.3g} + 1e-6 by "
             f"{excess:.3g}, or under half of it")
    del ref
    b_ms, b_by = fused_bound(b, t, h, dm, lens, BF16_FLOPS, passes=(3, 3))
    res = {"shape": [b, t, dm], "heads": h, "lengths_sum": int(lens.sum()), "max_abs_err": err,
           "tolerance": [TOL_FUSED, RTOL_FUSED], "max_abs_err_vs_f64": err_f64,
           "plain_max_abs_err_vs_f64": err_plain_f64, "bound_ms": b_ms, "bound_by": b_by}
    if kernel_time:
        res["ms"] = time_ms(kernel, 20)
    if timed:
        res["plain_ms"] = time_ms(
            lambda: fused_attention.fused_qkv_attention_ref(x, *params, lens, h, "high"), 5)
        res["library_ms"] = time_ms(fused_yardstick(x, params, lens, h), 10)
    print(f"  fused high3 [{b}, {t}, {dm}] keys {int(lens.sum())}: vs plain max|d| {err:.3g}, "
          f"vs f64 {err_f64:.3g} (plain {err_plain_f64:.3g}); K4h "
          f"{res.get('ms', float('nan')):.4f} ms  plain {res.get('plain_ms', float('nan')):.4f}  "
          f"F.linear + sdpa f32 {res.get('library_ms', float('nan')):.4f}  bound {b_ms:.4f} "
          f"({b_by})", flush=True)
    return res


def check_high3_shapes() -> None:
    """K4h at the fused "exact" path's shapes: the scoring shape (499
    valid frames of 511, rows ragged down to 1 key, a 0-key row), the loss
    crop, a ragged [8, 1024], the first two-block cluster [16, 65] and the
    one-tensor-per-block plan's edges T in {1, 17, 64}."""
    g = torch.Generator().manual_seed(19)
    rng = np.random.default_rng(19)
    main_lens = [511, 1, 0] + list(rng.integers(2, 511, size=9)) + [499] * 84
    res = {"main": check_fused_high3(96, 511, main_lens, g, timed=True),
           "loss": check_fused_high3(LOSS_BATCH, 50, [50] * LOSS_BATCH, g, timed=True),
           "ragged": check_fused_high3(8, 1024, [1024, 1023, 777, 513, 512, 64, 2, 1], g,
                                       timed=True),
           "edge": check_fused_high3(16, 65, [65] * 12 + [64, 33, 1, 0], g, timed=False)}
    for t in (1, 17, 64):
        res[f"edge_T{t}"] = check_fused_high3(4, t, [t, max(t // 2, 1), 1, 0], g, timed=False,
                                              kernel_time=False)
    report["kernels"]["fused_qkv_attention_high3_fwd"] = res


def check_kernels() -> None:
    g = torch.Generator().manual_seed(0)
    rows = 96 * 511  # batch 96 of the 10 s bucket's 511 frames
    ln768 = check_layernorm(rows, 768, g)
    ln512 = check_layernorm(rows, 512, g)
    rng = np.random.default_rng(0)
    # the main path's 10 s files give 499 valid frames of 511; a few rows
    # ragged down to 1 key, and one full row
    main_lens = [511, 1] + list(rng.integers(2, 511, size=10)) + [499] * 84
    fl_main = check_flash(96, 511, main_lens, g, timed=True)
    fl_long = check_flash(8, 4095, [4095, 4000, 3001, 2048, 1025, 513, 64, 1], g, timed=False)
    report["kernels"]["layernorm_fwd"] = {"main": ln768, "d512": ln512}
    report["kernels"]["flash_attention_fwd"] = {"main": fl_main, "long": fl_long}
    bwd = {
        # the loss path: 32 crops of 16,384 samples, T' = 50, no padding
        "main": check_flash_bwd(LOSS_BATCH, 50, [50] * LOSS_BATCH, g, timed=True),
        # triplet training and the loss on 10 s clips: 24 rows of 160,000
        # samples, T' = 499
        "train": check_flash_bwd(LOSS10_BATCH, 499, [499] * LOSS10_BATCH, g, timed=True),
        "long": check_flash_bwd(8, 4095, [4095, 4000, 2047, 1025, 513, 64, 1, 0], g,
                                timed=True),
    }
    # every edge of the tiles (32-row streamed tiles; 32-row blocks up to
    # T = 64, 64-row beyond): a full row, a ragged one, 1 key and none
    for t in (1, 31, 32, 33, 63, 64, 65, 499):
        bwd[f"edge_T{t}"] = check_flash_bwd(4, t, [t, max(t // 2, 1), 1, 0], g, timed=False,
                                            kernel_times=False)
    for key, name in (("dq", "flash_attention_bwd_dq"), ("dkv", "flash_attention_bwd_dkv")):
        report["kernels"][name] = {shape: r[key] | {"shape": r["shape"]} for shape, r in bwd.items()}
    report["sdpa_grad_kernels_ms"] = {shape: r["library_kernels_ms"] for shape, r in bwd.items()
                                      if "library_kernels_ms" in r}
    report["kernels"]["fused_qkv_attention_fwd"] = {
        # the scoring path's 10 s bucket with its lengths, the loss crop,
        # and the longest input K4 takes, ragged down to one key
        "main": check_fused(96, 511, main_lens, g, timed=True),
        "loss": check_fused(LOSS_BATCH, 50, [50] * LOSS_BATCH, g, timed=True),
        "ragged": check_fused(8, 1024, [1024, 1023, 777, 513, 512, 64, 2, 1], g, timed=False),
    }
    # K1 at the loss crop (24 launches per loss step), and K4 where its
    # cluster first spans two 64-row chunks, ragged down to no key
    report["kernels"]["flash_attention_fwd"]["loss"] = check_flash(
        LOSS_BATCH, 50, [50] * LOSS_BATCH, g, timed=True)
    report["kernels"]["fused_qkv_attention_fwd"]["edge"] = check_fused(
        16, 65, [65] * 12 + [64, 33, 1, 0], g, timed=False)
    check_high3_shapes()


# ---------------- phase 4: the main path ----------------


def speech_like(rng: np.random.Generator, n: int, noise) -> np.ndarray:
    """A voiced tone under a syllable-rate envelope plus white noise of
    amplitude ``noise`` (a float, or a (low, high) range to draw it from)."""
    t = np.arange(n) / SR
    f0 = rng.uniform(90, 250)
    env = np.clip(np.sin(2 * np.pi * rng.uniform(0.5, 2) * t), 0, 1)
    x = 0.2 * np.sin(2 * np.pi * f0 * t) * env
    x += (noise if isinstance(noise, float) else rng.uniform(*noise)) * rng.standard_normal(n)
    return x.astype(np.float32)


def write_wavs(root: Path) -> tuple[str, str]:
    rng = np.random.default_rng(1234)
    n = int(SECONDS * SR)
    dirs = []
    for sub, count in (("nmr", N_NMR), ("deg", N_DEG)):
        p = root / sub
        p.mkdir()
        for i in range(count):
            x = speech_like(rng, n, 0.005 if sub == "nmr" else (0.01, 0.1))
            write_wav(str(p / f"{sub}_{i:03d}.wav"), x, SR, bits=16)
        dirs.append(str(p))
    return dirs[0], dirs[1]


def read_csv(path: Path) -> tuple[list, list, np.ndarray]:
    lines = path.read_text().splitlines()
    header = lines[0].split(",")
    rows = [ln.split(",") for ln in lines[1:]]
    return header, [r[0] for r in rows], np.array([[float(c) for c in r[1:]] for r in rows])


def check_csvs(out: Path, what: str) -> np.ndarray:
    h_avg, labels, avg = read_csv(out / "nomad_avg.csv")
    h_dm, labels_dm, dm = read_csv(out / "nomad_scores.csv")
    if h_avg != ["Test File", "NOMAD"] or avg.shape != (N_DEG, 1):
        fail(f"{what}: nomad_avg.csv header {h_avg}, shape {avg.shape}")
    if len(h_dm) != N_NMR + 1 or dm.shape != (N_DEG, N_NMR) or labels != labels_dm:
        fail(f"{what}: nomad_scores.csv header {h_dm}, shape {dm.shape}")
    if not (np.isfinite(avg).all() and np.isfinite(dm).all()):
        fail(f"{what}: non-finite scores")
    return dm


# kernel name -> layer of the model, first match wins (cuDNN's implicit-GEMM
# convolutions carry "gemm" in their names too, so convolutions go first)
KERNEL_GROUPS = (
    # K1-bf16 ("highest" on bf16 tensors: three planes of P), then K1b-bf16;
    # K1-bf16's prologue is K1b-bf16's and goes there
    ("flash_attention_f32_bf16io_fwd", ("flash_fwd_bf16_kernel<__nv_bfloat16, 3",)),
    ("flash_attention_bf16io_fwd", ("flash_fwd_bf16_kernel<__nv_bfloat16",
                                    "flash_fwd_fold_bf16_kernel<__nv_bfloat16")),
    # K2-bf16/K3-bf16 ("highest" on bf16 tensors: three passes), then K2b/K3b-bf16
    ("flash_attention_bwd_f32_bf16io", ("flash_bwd_dq_bf16_kernel<__nv_bfloat16, 3",
                                        "flash_bwd_dkv_bf16_kernel<__nv_bfloat16, 3")),
    ("flash_attention_bwd_bf16io", ("flash_bwd_dq_bf16_kernel<__nv_bfloat16",
                                    "flash_bwd_dkv_bf16_kernel<__nv_bfloat16",
                                    "flash_bwd_fold_bf16_kernel<__nv_bfloat16")),
    ("layernorm_fwd_bf16io", ("layernorm_fwd_kernel<__nv_bfloat16",)),
    ("flash_attention_fwd", ("flash_fwd_kernel",)),
    ("flash_attention_bf16_fwd", ("flash_fwd_bf16_kernel", "flash_fwd_fold_bf16_kernel")),
    # K4-bf16 and K4h (K4b's template at 6 and 3 passes) and K4b, each with
    # its prologue (3, 2 and 1 planes)
    ("fused_qkv_attention_f32_bf16io_fwd", ("fused_qkv_fwd_bf16_kernel<6", "pack_kernel<3")),
    ("fused_qkv_attention_high3_fwd", ("fused_qkv_fwd_bf16_kernel<3", "pack_kernel<2")),
    ("fused_qkv_attention_bf16_fwd", ("fused_qkv_fwd_bf16_kernel", "pack_kernel<1")),
    ("fused_qkv_attention_fwd", ("fused_qkv_fwd_kernel",)),
    ("flash_attention_bwd", ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")),
    ("flash_attention_bwd_bf16", ("flash_bwd_dq_bf16_kernel", "flash_bwd_dkv_bf16_kernel",
                                  "flash_bwd_fold_bf16_kernel")),
    ("layernorm_fwd", ("layernorm_fwd_kernel",)),
    ("convolution", ("conv", "fprop", "implicit", "winograd", "cudnn")),
    ("matmul", ("gemm", "gemv", "cutlass", "sm90_xmma", "ampere", "nvjet")),
)


def kernel_group(name: str) -> str:
    name = name.lower()
    return next((g for g, keys in KERNEL_GROUPS if any(k in name for k in keys)),
                "memcpy/memset" if "memcpy" in name or "memset" in name else "elementwise/other")


def profile_run(fn, key: str, split=None) -> None:
    """One warm run of fn under torch.profiler: device time by kernel
    group, and the device's busy share of the run's wall time, into
    report[key]. ``split(prof)`` -> (group name, {kernel name: us}, info)
    moves those kernels' time out of their groups into one of its own."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, groups, by_name = [], {}, {}
    for evt in prof.events():
        if (evt.device_type != torch.autograd.DeviceType.CUDA or evt.time_range.elapsed_us() <= 0
                or getattr(evt, "is_user_annotation", False)):  # a range, not a kernel
            continue
        group = kernel_group(evt.name)
        groups[group] = groups.get(group, 0.0) + evt.time_range.elapsed_us()
        by_name[evt.name] = by_name.get(evt.name, 0.0) + evt.time_range.elapsed_us()
        spans.append((evt.time_range.start, evt.time_range.end))
    busy, end = 0.0, float("-inf")
    for s, e in sorted(spans):  # union of the device's busy intervals
        if e > end:
            busy += e - max(s, end)
            end = e
    split_info = None
    if split is not None:
        split_group, kernels, split_info = split(prof)
        for name, us in kernels.items():
            groups[kernel_group(name)] -= us
            groups[split_group] = groups.get(split_group, 0.0) + us
    total = sum(groups.values())
    prof_info = {
        "wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
        "device_idle_share": 1 - busy / wall_us if spans else None,
        "device_ms_by_group": {g: t / 1e3 for g, t in sorted(groups.items(), key=lambda x: -x[1])},
        "top_kernels_ms": {n[:160]: t / 1e3 for n, t in sorted(by_name.items(), key=lambda x: -x[1])[:12]},
        # the host's side: CPU time by operator, its own time only
        "top_host_ops_self_ms": {
            e.key[:120]: e.self_cpu_time_total / 1e3 for e in sorted(
                prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:12]},
    }
    if split_info is not None:
        prof_info["split"] = split_info
    report[key] = prof_info
    if not spans:
        print(f"{key}: the profiler recorded no device activity (idle share not measured)")
        return
    print(f"{key}: run {wall_us / 1e3:.1f} ms under the profiler, device busy {busy / 1e3:.1f} ms, "
          f"idle share {prof_info['device_idle_share']:.3f}; device time by group: " + ", ".join(
              f"{g} {t:.1f} ms ({t * 1e3 / total:.1%})"
              for g, t in prof_info["device_ms_by_group"].items()), flush=True)


def reset_launches() -> None:
    flash_attention.launches = flash_attention.launches_bwd_dq = 0
    flash_attention.launches_bwd_dkv = layernorm.launches = fused_attention.launches = 0
    flash_attention.launches_bf16 = fused_attention.launches_bf16 = 0
    flash_attention.launches_bwd_dq_bf16 = flash_attention.launches_bwd_dkv_bf16 = 0
    flash_attention.launches_bf16_io = layernorm.launches_bf16_io = 0
    flash_attention.launches_bwd_dq_bf16_io = flash_attention.launches_bwd_dkv_bf16_io = 0
    flash_attention.launches_f32_bf16_io = fused_attention.launches_f32_bf16_io = 0
    flash_attention.launches_bwd_dq_f32_bf16_io = flash_attention.launches_bwd_dkv_f32_bf16_io = 0
    fused_attention.launches_bf16_io = 0
    fused_attention.launches_high3 = fused_attention.launches_high3_bf16_io = 0
    flash_attention.launches_bwd_fold_bf16 = flash_attention.launches_bwd_fold_bf16_io = 0
    flash_attention.launches_fwd_fold_bf16 = flash_attention.launches_fwd_fold_bf16_io = 0


def read_launches() -> dict:
    return {"flash_attention_fwd": flash_attention.launches,
            "flash_attention_bf16_fwd": flash_attention.launches_bf16,
            "flash_attention_bwd_dq": flash_attention.launches_bwd_dq,
            "flash_attention_bwd_dkv": flash_attention.launches_bwd_dkv,
            "flash_attention_bwd_dq_bf16": flash_attention.launches_bwd_dq_bf16,
            "flash_attention_bwd_dkv_bf16": flash_attention.launches_bwd_dkv_bf16,
            "fused_qkv_attention_fwd": fused_attention.launches,
            "fused_qkv_attention_bf16_fwd": fused_attention.launches_bf16,
            "layernorm_fwd": layernorm.launches,
            "flash_attention_bf16io_fwd": flash_attention.launches_bf16_io,
            "flash_attention_bwd_dq_bf16io": flash_attention.launches_bwd_dq_bf16_io,
            "flash_attention_bwd_dkv_bf16io": flash_attention.launches_bwd_dkv_bf16_io,
            "layernorm_fwd_bf16io": layernorm.launches_bf16_io,
            "flash_attention_f32_bf16io_fwd": flash_attention.launches_f32_bf16_io,
            "flash_attention_bwd_dq_f32_bf16io": flash_attention.launches_bwd_dq_f32_bf16_io,
            "flash_attention_bwd_dkv_f32_bf16io": flash_attention.launches_bwd_dkv_f32_bf16_io,
            "fused_qkv_attention_f32_bf16io_fwd": fused_attention.launches_f32_bf16_io,
            "fused_qkv_attention_bf16io_fwd": fused_attention.launches_bf16_io,
            "fused_qkv_attention_high3_fwd": fused_attention.launches_high3,
            "fused_qkv_attention_high3_bf16io_fwd": fused_attention.launches_high3_bf16_io,
            "flash_attention_bwd_fold_bf16": flash_attention.launches_bwd_fold_bf16,
            "flash_attention_bwd_fold_bf16io": flash_attention.launches_bwd_fold_bf16_io,
            "flash_attention_fwd_fold_bf16": flash_attention.launches_fwd_fold_bf16,
            "flash_attention_fwd_fold_bf16io": flash_attention.launches_fwd_fold_bf16_io}


def launches_want(k1=0, k2=0, k3=0, k4=0, k5=0, k1b=0, k2b=0, k3b=0, k4b=0,
                  k1b_io=0, k2b_io=0, k3b_io=0, k5_io=0, k1_io=0, k2_io=0, k3_io=0, k4_io=0,
                  k4b_io=0, k4h=0, k4h_io=0) -> dict:
    """Launch counts by kernel; ``*_io``: the bf16-I/O flavours. The
    backward fold runs once per backward call of K2b/K3b or K2-bf16/K3-bf16:
    once per K2b launch, in K2b's flavour, and once per K2-bf16 launch
    (``k2_io``), in the bf16 one; the forward fold once per K1b launch, in
    its flavour, and once per K1-bf16 launch (``k1_io``), in the bf16
    one."""
    return {"flash_attention_fwd": k1, "flash_attention_bf16_fwd": k1b,
            "flash_attention_bwd_dq": k2, "flash_attention_bwd_dkv": k3,
            "flash_attention_bwd_dq_bf16": k2b, "flash_attention_bwd_dkv_bf16": k3b,
            "fused_qkv_attention_fwd": k4, "fused_qkv_attention_bf16_fwd": k4b,
            "layernorm_fwd": k5, "flash_attention_bf16io_fwd": k1b_io,
            "flash_attention_bwd_dq_bf16io": k2b_io, "flash_attention_bwd_dkv_bf16io": k3b_io,
            "layernorm_fwd_bf16io": k5_io, "flash_attention_f32_bf16io_fwd": k1_io,
            "flash_attention_bwd_dq_f32_bf16io": k2_io,
            "flash_attention_bwd_dkv_f32_bf16io": k3_io,
            "fused_qkv_attention_f32_bf16io_fwd": k4_io,
            "fused_qkv_attention_bf16io_fwd": k4b_io,
            "fused_qkv_attention_high3_fwd": k4h, "fused_qkv_attention_high3_bf16io_fwd": k4h_io,
            "flash_attention_bwd_fold_bf16": k2b,
            "flash_attention_bwd_fold_bf16io": k2b_io + k2_io,
            "flash_attention_fwd_fold_bf16": k1b, "flash_attention_fwd_fold_bf16io": k1b_io + k1_io}


def mode_config(mode: str = "exact", **kw) -> Wav2Vec2Config:
    """BASE with a precision mode's islands (``Nomad(precision=mode)``'s);
    a mode with "_bf16" appended takes them on bf16 activations ("fast_bf16"
    is the trainer's)."""
    if mode.endswith("_bf16"):
        return Wav2Vec2Config.base(**(PRECISION_ISLANDS[mode[:-5]] | kw),
                                   encoder_dtype=torch.bfloat16)
    return Wav2Vec2Config.base(**(PRECISION_ISLANDS[mode] | kw))


def plain_config(mode: str = "exact", **kw) -> Wav2Vec2Config:
    """The plain path of ``mode``: attention and LayerNorm in plain PyTorch.
    At "exact" the plain attention is ``mha_ref``, unless ``kw`` names the
    fused path, which runs under ``plain_flash("exact", impl="fused_qkv")``:
    at "high" its kernel computes the TPU kernel's "high3", which
    ``mha_ref`` does not. A bf16 mode keeps ``attention_impl="kernel"``
    and runs it under ``plain_flash()``: its attention rounds where K1b,
    K2b and K3b round (p before the normalisation), which ``mha_ref`` does
    not, so their own plain versions are its plain path."""
    if mode == "exact":
        return mode_config(**({"attention_impl": "ref", "layernorm_impl": "ref"} | kw))
    return mode_config(mode, layernorm_impl="ref", **kw)


@contextlib.contextmanager
def plain_flash(mode: str = "default", forward: bool = True, impl: str | None = None):
    """``FlashAttention`` through ``flash_attention_ref`` (unless not
    ``forward``) and ``flash_attention_bwd_ref`` on CUDA tensors, and (with
    ``forward``) ``FusedQKVAttention`` through ``fused_qkv_attention_ref``,
    for a bf16 ``mode`` or for the fused path (``impl`` "fused_qkv"); a
    no-op at "exact" otherwise."""
    saved = (flash_attention.mha_flash, flash_attention.flash_attention_bwd,
             fused_attention.fused_qkv_mha)
    if mode != "exact" or impl == "fused_qkv":
        if forward:
            flash_attention.mha_flash = flash_attention.flash_attention_ref
            fused_attention.fused_qkv_mha = fused_attention.fused_qkv_attention_ref
        flash_attention.flash_attention_bwd = flash_attention.flash_attention_bwd_ref
    try:
        yield
    finally:
        (flash_attention.mha_flash, flash_attention.flash_attention_bwd,
         fused_attention.fused_qkv_mha) = saved


@contextlib.contextmanager
def recorded_flash_bwd():
    """Record every ``flash_attention_bwd`` call of the path run inside:
    its inputs and outputs, cloned, for ``check_recorded_flash_bwd``."""
    calls, real = [], flash_attention.flash_attention_bwd

    def record(*args):
        outs = real(*args)
        calls.append((tuple(a.detach().clone() if torch.is_tensor(a) else a for a in args),
                      tuple(o.detach().clone() for o in outs)))
        return outs

    flash_attention.flash_attention_bwd = record
    try:
        yield calls
    finally:
        flash_attention.flash_attention_bwd = real


def bwd_rel_err(outs, ref) -> dict:
    """Over dQ, dK and dV: the largest max |out - ref| / max |ref| and
    ||out - ref|| / ||ref||, in f32."""
    res = {"max": 0.0, "norm": 0.0}
    for o, r in zip(outs, ref):
        o, r = o.float(), r.float()
        d = (o - r).nan_to_num(nan=float("inf"))
        res["max"] = max(res["max"], d.abs().max().item() / max(r.abs().max().item(), 1e-30))
        res["norm"] = max(res["norm"], d.norm().item() / max(r.norm().item(), 1e-30))
    return res


def check_recorded_flash_bwd(calls: list, what: str) -> dict:
    """The path's own attention backward calls (K2b + K3b through
    ``flash_attention_bwd``) against ``flash_attention_bwd_ref`` on the
    same inputs: within BWD_BF16_PATH_REL of each output's max |g|, and
    BWD_BF16_PLAIN_NORM of its norm; for bf16 outputs (the bf16-I/O
    flavours) plus one bf16 step at the max, and half of one in the norm."""
    worst = {"max": 0.0, "norm": 0.0}
    for args, outs in calls:
        err = bwd_rel_err(outs, flash_attention.flash_attention_bwd_ref(*args))
        worst = {k: max(worst[k], err[k]) for k in worst}
    ulp = BF16_ULP_REL if calls and calls[0][1][0].dtype == torch.bfloat16 else 0.0
    tol_max, tol_norm = BWD_BF16_PATH_REL + ulp, BWD_BF16_PLAIN_NORM + ulp / 2
    print(f"{what}: the path's {len(calls)} attention backward calls vs their plain version "
          f"on the same inputs max|d|/max|g| {worst['max']:.3g} (<= {tol_max:.3g}), "
          f"||d||/||g|| {worst['norm']:.3g} (<= {tol_norm:.3g})", flush=True)
    if not calls or worst["max"] > tol_max or worst["norm"] > tol_norm:
        fail(f"{what}: {len(calls)} attention backward calls, vs plain {worst}")
    return worst


def timed_passes(nomad: Nomad, waves: list) -> tuple[torch.Tensor, list]:
    """Three warm device passes (embed on decoded waveforms): the last
    embeddings and the pass times."""
    passes = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        emb = nomad.engine.embed_waves_device(waves)
        torch.cuda.synchronize()
        passes.append(time.perf_counter() - t0)
    return emb, passes


def batch1_error(nomad: Nomad, waves: list, emb: torch.Tensor) -> float:
    """Batch-1 vs the padded batches: two files of the full batch of 96,
    two of the 12-file tail that runs padded to 16."""
    n = len(waves)
    return max((nomad.engine.embed_waves_device([waves[i]])[0] - emb[i]).abs().max().item()
               for i in (0, n // 2, n - 2, n - 1))


def run_main_path(card: str, tmp: Path, nmr: str, deg: str) -> tuple:
    """The K1 scoring path; returns the decoded waves, its embeddings and
    the plain path's."""
    total_s = (N_NMR + N_DEG) * SECONDS
    cli_out = tmp / "cli"
    cli_out.mkdir()
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "nomad_tpu_torch", "--mode", "dir", "--nmr", nmr, "--deg", deg,
         "--results_path", str(cli_out)],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
    )
    report["checks"]["cli_s"] = time.perf_counter() - t0
    if cli.returncode != 0:
        fail(f"CLI exit {cli.returncode}:\n{cli.stdout[-3000:]}\n{cli.stderr[-3000:]}")
    cli_dm = check_csvs(cli_out, "CLI")
    print(f"main path: CLI scored {N_DEG} x {N_NMR} files in {report['checks']['cli_s']:.1f} s "
          "(cold process: start, build load, weights, first pass)", flush=True)

    leftover_gb = settled_allocated_gb()  # left by earlier phases: not this path's
    nomad = Nomad(device="cuda")
    api_out = tmp / "api"
    api_out.mkdir()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    nomad.predict("dir", nmr, deg, str(api_out))
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    counts = read_launches()
    batches = nomad.engine.batches
    report["launches"] = {"scoring": counts}
    report["checks"]["batches_per_pass"] = batches
    want = launches_want(k1=12 * batches, k5=26 * batches)
    if counts != want or batches == 0:
        fail(f"launch counts {counts} for {batches} batches (want {want})")
    api_dm = check_csvs(api_out, "API")
    if np.abs(api_dm - cli_dm).max() > 1e-3:
        fail(f"CLI and API scores differ by {np.abs(api_dm - cli_dm).max()}")
    print(f"main path: predict {cold_s:.2f} s cold, {batches} batches, launches {counts}",
          flush=True)

    # warm passes: whole predict (read + embed + cdist + CSVs), and the
    # device pass alone on decoded waveforms
    warm = []
    for _ in range(3):
        t0 = time.perf_counter()
        nomad.predict("dir", nmr, deg, str(api_out))
        warm.append(time.perf_counter() - t0)
    paths = sorted(Path(nmr).iterdir()) + sorted(Path(deg).iterdir())
    waves = nomad.engine.load_waves([str(p) for p in paths])
    emb, passes = timed_passes(nomad, waves)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    pred_s, pass_s = float(np.median(warm)), float(np.median(passes))
    report["main_path"] = {
        "files": N_NMR + N_DEG, "audio_s": total_s, "predict_warm_s": warm,
        "pass_s": passes, "wav_s_per_s_predict": total_s / pred_s,
        "wav_s_per_s_pass": total_s / pass_s, "peak_mem_gb": peak_gb,
        "leftover_mem_gb": leftover_gb, "card": card,
    }
    print(f"main path: warm predict {pred_s:.3f} s = {total_s / pred_s:.1f} wav-s/s; "
          f"device pass {pass_s:.3f} s = {total_s / pass_s:.1f} wav-s/s; "
          f"peak memory {peak_gb:.5f} GB, {leftover_gb:.5f} GB of it left by earlier phases"
          f"  [{card}]", flush=True)
    profile_run(lambda: nomad.engine.embed_waves_device(waves), "profile")

    # the same weights on the plain path (plain attention and LayerNorm)
    plain_emb = Nomad(device="cuda", config=plain_config()).engine.embed_waves_device(waves)
    d_ref = (emb - plain_emb).abs().max().item()
    report["checks"]["kernel_vs_plain_path_emb"] = d_ref
    if not torch.isfinite(emb).all() or d_ref > TOL_REF_PATH:
        fail(f"kernel path vs plain path embeddings: max|d| {d_ref:.3g} > {TOL_REF_PATH}")
    d_b1 = batch1_error(nomad, waves, emb)
    report["checks"]["batch1_vs_padded_emb"] = d_b1
    if d_b1 > TOL_BATCH1:
        fail(f"batch-1 vs padded-batch embeddings: max|d| {d_b1:.3g} > {TOL_BATCH1}")
    print(f"main path: kernel vs plain path max|d| {d_ref:.3g} (<= {TOL_REF_PATH}); "
          f"batch-1 vs padded max|d| {d_b1:.3g} (<= {TOL_BATCH1})", flush=True)
    return waves, emb, plain_emb


def fused_plain_embeddings(waves: list, **kw) -> torch.Tensor:
    """The fused path's own plain path (the fused kernel's plain version at
    its island's precision: "high3" at "high"; plain LayerNorm) on the same
    seeded weights."""
    with plain_flash("exact", impl="fused_qkv"):
        plain = Nomad(device="cuda", config=plain_config(attention_impl="fused_qkv", **kw))
        return plain.engine.embed_waves_device(waves)


def run_fused_scoring(card: str, tmp: Path, nmr: str, deg: str, waves: list,
                      k1_emb: torch.Tensor, plain_emb: torch.Tensor) -> None:
    """The fused path (``attention_impl="fused_qkv"``) on the same files:
    K4h in every block, no K1, against its own plain path (the fused
    kernel's plain version at "high": "high3") and the K1 path, within
    TOL_REF_PATH each, with the pairwise score delta against the K1 path
    (the score budget 1e-3; a fault beyond 1e-2) and the plain path's
    distance to the "exact" plain path (``mha_ref``: f32 attention) for the
    record; then one file at T' = 1,023 (K4h) and one at T' = 1,433 (past
    MAX_FUSED_T: K1), each against the fused plain path; then one batch of
    96 files with the frontend and the encoder at "highest" (K4, the f32
    kernel) against the K1 path."""
    total_s = (N_NMR + N_DEG) * SECONDS
    nomad = Nomad(device="cuda", config=Wav2Vec2Config.base(attention_impl="fused_qkv"))
    out = tmp / "fused"
    out.mkdir()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    nomad.predict("dir", nmr, deg, str(out))
    torch.cuda.synchronize()
    counts = read_launches()
    batches = nomad.engine.batches
    report["launches"]["scoring_fused"] = counts
    want = launches_want(k4h=12 * batches, k5=26 * batches)
    if counts != want or batches == 0:
        fail(f"fused path: launch counts {counts} for {batches} batches (want {want})")
    check_csvs(out, "fused API")
    emb, passes = timed_passes(nomad, waves)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    pass_s = float(np.median(passes))
    fused_plain = fused_plain_embeddings(waves)
    d_plain = (emb - fused_plain).abs().max().item()
    d_k1 = (emb - k1_emb).abs().max().item()
    d_b1 = batch1_error(nomad, waves, emb)
    delta = pairwise_delta(emb, k1_emb, slice(N_NMR, None), slice(0, N_NMR))
    report["fused_path"] = {
        "files": N_NMR + N_DEG, "audio_s": total_s, "batches": batches, "pass_s": passes,
        "wav_s_per_s_pass": total_s / pass_s, "peak_mem_gb": peak_gb, "card": card,
        "vs_plain_path_emb": d_plain, "vs_k1_path_emb": d_k1, "batch1_vs_padded_emb": d_b1,
        "plain_path_vs_exact_plain_emb": (fused_plain - plain_emb).abs().max().item(),
        "pairwise_delta_vs_k1_path": delta, "in_budget": delta <= DELTA_BUDGET,
    }
    del fused_plain
    print(f"fused path: {batches} batches, launches {counts}; device pass {pass_s:.3f} s = "
          f"{total_s / pass_s:.1f} wav-s/s; peak memory {peak_gb:.2f} GB  [{card}]; max|d| "
          f"{d_plain:.3g} vs its plain path (high3), {d_k1:.3g} vs K1 path (<= {TOL_REF_PATH}; "
          f"the plain paths {report['fused_path']['plain_path_vs_exact_plain_emb']:.3g} apart); "
          f"batch-1 vs padded {d_b1:.3g} (<= {TOL_BATCH1}); pairwise delta vs the K1 path "
          f"{delta:.3g} (budget {DELTA_BUDGET})", flush=True)
    if not torch.isfinite(emb).all() or max(d_plain, d_k1) > TOL_REF_PATH or \
            d_b1 > TOL_BATCH1 or delta > DELTA_FAULT:
        fail(f"fused path embeddings: {d_plain:.3g} vs plain, {d_k1:.3g} vs K1 path, "
             f"{d_b1:.3g} batch-1 vs padded, pairwise delta {delta:.3g}")
    profile_run(lambda: nomad.engine.embed_waves_device(waves), "profile_fused")

    rng = np.random.default_rng(99)
    for n, frames in FUSED_SINGLE_FILES:
        if fused_attention.fused_supported(frames):
            want = launches_want(k4h=12, k5=26)
        else:
            want = launches_want(k1=12, k5=26)
        wave = np.rint(np.clip(speech_like(rng, n, 0.02), -1, 1) * 32767).astype(np.int16)
        reset_launches()
        one = nomad.engine.embed_waves_device([wave])
        torch.cuda.synchronize()
        counts = read_launches()
        key = f"fused_single_T{frames}"
        report["launches"][key] = counts
        d = (one - fused_plain_embeddings([wave])).abs().max().item()
        report["checks"][f"{key}_vs_plain_path_emb"] = d
        print(f"fused path: one file of {n} samples (T' = {frames}): launches {counts}, "
              f"max|d| {d:.3g} vs its plain path (<= {TOL_REF_PATH})", flush=True)
        if counts != want or not torch.isfinite(one).all() or d > TOL_REF_PATH:
            fail(f"fused path, one file of {n} samples: launches {counts} (want {want}), "
                 f"max|d| {d:.3g} vs plain")
    del nomad

    # the f32 kernel K4 keeps a path: "highest" in the frontend and the
    # encoder, one batch, against the K1 path (f32 products on the card at
    # "high" and "highest" alike)
    one = waves[:96]
    highest = Nomad(device="cuda", config=Wav2Vec2Config.base(
        attention_impl="fused_qkv", frontend_precision="highest", encoder_precision="highest"))
    reset_launches()
    emb = highest.engine.embed_waves_device(one)
    torch.cuda.synchronize()
    counts = read_launches()
    report["launches"]["scoring_fused_highest"] = counts
    want = launches_want(k4=12, k5=26)
    d_k1 = (emb - k1_emb[:96]).abs().max().item()
    report["checks"]["fused_highest_vs_k1_path_emb"] = d_k1
    print(f"fused path at \"highest\": one batch of {len(one)} files, launches {counts}, max|d| "
          f"{d_k1:.3g} vs the K1 path (<= {TOL_REF_PATH})", flush=True)
    if counts != want or not torch.isfinite(emb).all() or d_k1 > TOL_REF_PATH:
        fail(f"fused path at \"highest\": launches {counts} (want {want}), max|d| {d_k1:.3g} "
             f"vs the K1 path")


def run_scoring_paths(card: str) -> None:
    with tempfile.TemporaryDirectory(prefix="nomad_smoke_") as tmp:
        tmp = Path(tmp)
        nmr, deg = write_wavs(tmp)
        waves, k1_emb, plain_emb = run_main_path(card, tmp, nmr, deg)
        run_fused_scoring(card, tmp, nmr, deg, waves, k1_emb, plain_emb)


# ---------------- phase 5: the loss path ----------------


def layer_signs(nomad: Nomad, est: torch.Tensor, clean: torch.Tensor) -> list:
    """sign(estimate layer - clean layer) for the 13 terms of the loss: the
    subgradient of |.| that the path's backward takes."""
    with torch.no_grad():
        return [torch.sign(a - c) for a, c in zip(nomad.model.forward_layers(est),
                                                  nomad.model.forward_layers(clean))]


def signed_grad(nomad: Nomad, est: torch.Tensor, clean: torch.Tensor,
                signs: list) -> torch.Tensor:
    """The gradient in ``est`` of the loss's 13 L1 terms taken under the
    sign pattern ``signs``: the loss's gradient where its own signs agree."""
    e = est.detach().clone().requires_grad_()
    with torch.no_grad():
        ref = nomad.model.forward_layers(clean)
    sum((s * (a - c)).mean() for s, a, c in zip(signs, nomad.model.forward_layers(e),
                                                 ref)).backward()
    return e.grad


def run_loss_path(card: str, key: str, config: Wav2Vec2Config, want: dict,
                  batch: int, samples: int, mode: str = "exact", params=None,
                  plain_impl: str | None = None, steps: int = LOSS_STEPS,
                  attribute: bool = False, plain_kw: dict | None = None) -> None:
    """One loss path on ``batch`` seeded clips of ``samples`` samples: its
    launch counts per step (``want``), loss and gradient against the plain
    path of the same precision ``mode``, forward(x, x) == 0, warm step
    time, peak memory and one profiled step, under ``report[key]``. In a
    bf16 mode the two paths are two bf16 realizations (a rounding that
    f32 order flips, the next blocks carry on), so they may differ by up
    to GRAD_MODE_FRAC times the plain path's distance to the "exact" plain
    path on the same inputs, on top of the f32 tolerances; the first
    step's attention backward calls are held to their plain version on
    the same inputs, and the gap with K2b/K3b alone swapped for their
    plain version is reported. ``params``: the weights (a state dict),
    else Nomad's seeded init. ``plain_impl``: the plain path's
    ``attention_impl`` in a bf16 mode (else the mode's own), or
    "fused_qkv" at "exact" (the fused kernel's plain version, else
    ``mha_ref``); ``plain_kw``: other fields of the plain path's config
    (``dtype``); ``steps``:
    warm steps timed. ``attribute``: the gap with K1b alone, then K5 alone,
    swapped for its plain version too, and the share of the gap each swap
    closes (beside K2b/K3b's)."""
    what, step_key = key.replace("_", " "), key.replace("path", "step")
    rng = np.random.default_rng(4321)
    clean_np = np.stack([speech_like(rng, samples, 0.005) for _ in range(batch)])
    est_np = clean_np + (0.03 * rng.standard_normal(clean_np.shape)).astype(np.float32)
    clean = torch.from_numpy(clean_np).to(DEV)
    est = torch.from_numpy(est_np).to(DEV).requires_grad_()
    nomad = Nomad(device="cuda", config=config, params=params)

    def step() -> torch.Tensor:
        est.grad = None
        loss = nomad.forward(est, clean)
        loss.backward()
        return loss

    torch.cuda.synchronize()
    reset_launches()
    with recorded_flash_bwd() if mode != "exact" else contextlib.nullcontext() as calls:
        loss = step()
    torch.cuda.synchronize()
    counts = read_launches()
    report["launches"][step_key] = counts
    if counts != want:
        fail(f"{what}: launch counts of a step {counts} (want {want})")
    grad = est.grad.detach().clone()
    value = loss.item()
    if not (np.isfinite(value) and bool(torch.isfinite(grad).all())) or grad.shape != est.shape:
        fail(f"{what}: loss {value}, gradient finite={bool(torch.isfinite(grad).all())} "
             f"shape {tuple(grad.shape)}")
    gmax = grad.abs().max().item()
    print(f"{what}: loss {value:.6g}, max|d loss/d est| {gmax:.4g}, launches {counts}",
          flush=True)
    mode_checks = None
    if mode != "exact":
        mode_checks = {"attention_bwd_calls_vs_plain": check_recorded_flash_bwd(calls, what)}
    del calls

    def rel(g, ref):
        return (g - ref).abs().max().item() / ref.abs().max().item()

    # the same weights on the plain path, which holds every layer's
    # [B, 12, T', T'] probabilities for its backward
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sd = nomad.model.state_dict()
    signs = layer_signs(nomad, est.detach(), clean)
    plain = Nomad(device="cuda", params=sd, config=plain_config(
        mode, **({"attention_impl": plain_impl} if plain_impl else {}), **(plain_kw or {})))
    with plain_flash(mode, impl=plain_impl):
        est_p = est.detach().clone().requires_grad_()
        loss_p = plain.forward(est_p, clean)
        loss_p.backward()
        torch.cuda.synchronize()
        plain_peak_gb = torch.cuda.max_memory_allocated() / 1e9
        d_loss = abs(loss_p.item() - value) / abs(loss_p.item())
        d_grad = rel(grad, est_p.grad)
        # an element of a layer difference within rounding of 0 can take the
        # other sign of |.| on the other path, which alone moves the gradient
        # by 2/numel of that element's Jacobian row: hold the plain path's
        # gradient under the kernel path's signs
        flips = sum(int((s_ != p_).sum()) for s_, p_ in zip(
            signs, layer_signs(plain, est.detach(), clean)))
        grad_s = signed_grad(plain, est, clean, signs)
    d_grad_signs = rel(grad, grad_s)
    tol_loss, tol_grad = TOL_LOSS_REL, TOL_GRAD_REL
    if mode != "exact":
        # D from the plain paths alone: this mode's against "exact"'s, under
        # the same signs; and, for the record, the kernel path's own
        # distance to "exact" and its gap with K2b/K3b alone swapped
        exact_plain = Nomad(device="cuda", config=plain_config(), params=sd)
        with torch.no_grad():
            loss_ep = exact_plain.forward(est.detach(), clean).item()
        grad_ep = signed_grad(exact_plain, est, clean, signs)
        del exact_plain
        exact = Nomad(device="cuda", config=mode_config(), params=sd)
        with torch.no_grad():
            loss_e = exact.forward(est.detach(), clean).item()
        grad_e = signed_grad(exact, est, clean, signs)
        del exact
        with plain_flash(mode, forward=False):
            grad_kp = signed_grad(nomad, est, clean, signs)
        swapped = {"k2b_k3b": grad_kp}
        if attribute:
            saved = flash_attention.mha_flash  # K1b alone: its plain forward, K2b/K3b kept
            flash_attention.mha_flash = flash_attention.flash_attention_ref
            try:
                swapped["k1b"] = signed_grad(nomad, est, clean, signs)
            finally:
                flash_attention.mha_flash = saved
            ln_ref = Nomad(device="cuda", params=sd,
                           config=dataclasses.replace(config, layernorm_impl="ref"))
            swapped["k5"] = signed_grad(ln_ref, est, clean, signs)
            del ln_ref
        d_plain = {"loss_rel": abs(loss_p.item() - loss_ep) / abs(loss_ep),
                   "grad_rel_to_max": rel(grad_s, grad_ep)}
        tol_loss += GRAD_MODE_FRAC * d_plain["loss_rel"]
        tol_grad += GRAD_MODE_FRAC * d_plain["grad_rel_to_max"]
        mode_checks |= {
            "plain_vs_exact_plain": d_plain,
            "kernel_vs_exact_kernel": {"loss_rel": abs(value - loss_e) / abs(loss_e),
                                       "grad_rel_to_max": rel(grad, grad_e)},
            "k2b_k3b_swapped": {"vs_kernel_path": rel(grad_kp, grad),
                                "vs_plain_path": rel(grad_kp, grad_s)}}
        if attribute:  # the kernel path's gap to the plain path, and each swap's share of it
            mode_checks["gap_attribution"] = {
                "gap": d_grad_signs, "swapped_vs_plain_path": {
                    n: rel(x, grad_s) for n, x in swapped.items()},
                "share_closed": {n: 1 - rel(x, grad_s) / d_grad_signs
                                 for n, x in swapped.items()}}
        del grad_ep, grad_e, grad_kp, swapped
    zero = nomad.forward(clean, clean).item()
    report[key] = {
        "shape": [batch, samples], "loss": value, "grad_max_abs": gmax,
        "plain_loss": loss_p.item(), "loss_rel_diff": d_loss,
        "grad_rel_diff_direct": d_grad, "grad_rel_diff_same_signs": d_grad_signs,
        "sign_flips": flips, "identity_loss": zero, "plain_path_peak_mem_gb": plain_peak_gb,
        "mode": mode, "tolerance": [tol_loss, tol_grad], "mode_checks": mode_checks,
    }
    print(f"{what}: vs plain path loss rel {d_loss:.3g} (<= {tol_loss:.3g}); gradient "
          f"max|d|/max|g| {d_grad:.3g} direct, {d_grad_signs:.3g} under one sign pattern "
          f"(<= {tol_grad:.3g}; {flips} layer elements change sign); forward(x, x) = {zero}; "
          f"plain path peak memory {plain_peak_gb:.2f} GB"
          + (f"; {mode_checks}" if mode_checks else ""), flush=True)
    if d_loss > tol_loss or d_grad_signs > tol_grad or (flips == 0 and d_grad > tol_grad):
        fail(f"{what} vs plain path: loss rel {d_loss:.3g}, gradient {d_grad:.3g} direct / "
             f"{d_grad_signs:.3g} same signs ({flips} flips)")
    if zero != 0.0:
        fail(f"{what}: forward(clean, clean) = {zero}, want exactly 0")
    del plain, loss_p, est_p, grad_s, signs
    torch.cuda.empty_cache()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, host = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        host.append(time.perf_counter() - t0)  # the host's enqueue, before the wait
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_s = float(np.median(times))
    report[key] |= {"step_s": times, "step_median_s": step_s, "host_enqueue_s": host,
                    "peak_mem_gb": peak_gb, "card": card}
    print(f"{what}: warm step (forward + backward) median {step_s * 1e3:.2f} ms over "
          f"{steps} (host enqueue median {np.median(host) * 1e3:.2f} ms), peak memory "
          f"{peak_gb:.2f} GB  [{card}]", flush=True)
    profile_run(step, f"profile_{step_key}")


def run_fused_loss_path(card: str) -> None:
    """The fused path: K4h in both forwards, K1 + K2 + K3 in the backward's
    f32 recompute of the estimate's blocks; held to its own plain path
    (the fused kernel's plain version, "high3")."""
    run_loss_path(card, "loss_path_fused", Wav2Vec2Config.base(attention_impl="fused_qkv"),
                  launches_want(k1=12, k2=12, k3=12, k4h=24, k5=52), LOSS_BATCH, LOSS_SAMPLES,
                  plain_impl="fused_qkv")


def run_loss_paths(card: str) -> None:
    report.setdefault("launches", {})
    run_loss_path(card, "loss_path", Wav2Vec2Config.base(),
                  launches_want(k1=24, k2=12, k3=12, k5=52), LOSS_BATCH, LOSS_SAMPLES)
    run_fused_loss_path(card)
    # 10 s clips: K2 and K3 at [24, 499, 12, 64]
    run_loss_path(card, "loss_path_10s", Wav2Vec2Config.base(),
                  launches_want(k1=24, k2=12, k3=12, k5=52), LOSS10_BATCH, LOSS10_SAMPLES)


# ---------------- phase 6: the trainer ----------------


def write_train_tree(root: Path) -> dict:
    """Seeded PCM16 utterances of 10.5-12 s, the triplet CSVs, NMR files and
    a small quality test db; returns the recipe's config pointed at them."""
    rng = np.random.default_rng(2468)
    deg, nmr = root / "deg", root / "nmr"
    deg.mkdir()
    nmr.mkdir()
    names = [f"utt_{i:02d}.wav" for i in range(TRAIN_FILES)]
    for name in names:
        write_wav(str(deg / name), speech_like(rng, int(rng.integers(168_000, 192_001)),
                                               (0.01, 0.1)), SR, bits=16)
    for i in range(TRAIN_NMR):
        write_wav(str(nmr / f"nmr_{i}.wav"),
                  speech_like(rng, int(rng.integers(168_000, 192_001)), 0.005), SR, bits=16)
    for csv_name, count in (("train.csv", TRAIN_TRIPLETS), ("valid.csv", VALID_TRIPLETS)):
        lines = ["db,Anchor,Positive,Negative,anc_pos_dist,anc_neg_dist"]
        for j in range(count):
            a, p, n = rng.choice(TRAIN_FILES, 3, replace=False)
            lines.append(f"{1 + j % 2},{names[a]},{names[p]},{names[n]},0.1,0.3")
        (root / csv_name).write_text("\n".join(lines) + "\n")
    (root / "test_db.csv").write_text("db,filepath_deg,condition,mos\n" + "".join(
        f"smoke,{names[j]},cond_{j // 2},{4.5 - 0.8 * (j // 2) + 0.1 * (j % 2)}\n"
        for j in range(8)))
    cfg = config_io.load(str(TRAIN_RECIPE))
    cfg.update(
        root=str(deg) + "/", train_df=str(root / "train.csv"), valid_df=str(root / "valid.csv"),
        checkpoint_path=None, num_epochs=2, run_dir=str(root / "run"),
        non_match_dir=str(nmr), test_db_file=str(root / "test_db.csv"), test_root_wav=str(deg),
        nomad_model_path=str(root / "run" / "best_model.npz"), db=None, conds=None)
    return cfg


def ranged_kernels(range_name: str, group: str):
    """A ``profile_run`` split: the kernels launched under the profiler
    range ``range_name`` (a forward and, under remat, its recompute) and by
    the backward nodes of the ops inside that range (matched on the forward
    thread and autograd sequence number), as the group ``group``."""
    return lambda prof: _ranged_kernels(prof, range_name, group)


def _ranged_kernels(prof, range_name: str, group: str) -> tuple:
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU]

    def under_range(e) -> bool:
        while e is not None:
            if e.name == range_name:
                return True
            e = e.cpu_parent
        return False

    fwd = {(e.thread, e.sequence_nr) for e in events
           if e.sequence_nr >= 0 and "Backward" not in e.name and under_range(e)}
    backward = {id(e) for e in events
                if "Backward" in e.name and (e.fwd_thread, e.sequence_nr) in fwd}

    def inside(e) -> bool:
        while e is not None:
            if e.name == range_name or id(e) in backward:
                return True
            e = e.cpu_parent
        return False

    kernels: dict = {}
    for e in events:
        if e.kernels and inside(e):
            for k in e.kernels:
                kernels[k.name] = kernels.get(k.name, 0.0) + k.duration
    info = {"forward_ops": len(fwd), "backward_events": len(backward),
            "kernels_us": dict(sorted(kernels.items(), key=lambda x: -x[1])[:8])}
    return group, kernels, info


@contextlib.contextmanager
def profiler_range(owner, attr: str, name: str):
    """Run ``owner.attr`` (a function of a module, or a method of an
    object) inside a profiler range called ``name``."""
    plain = getattr(owner, attr)
    own = attr in vars(owner)

    def annotated(*args, **kwargs):
        with torch.profiler.record_function(name):
            return plain(*args, **kwargs)

    setattr(owner, attr, annotated)
    try:
        yield
    finally:
        if own:
            setattr(owner, attr, plain)
        else:
            delattr(owner, attr)


def step_gen() -> torch.Generator:
    return torch.Generator().manual_seed(TRAIN_SEED)


def first_train_step(key: str, cfg: dict, batch, want: dict, params=None,
                     model_config=None) -> tuple:
    """A Training on the seeded weights (its own init, or ``params``, a copy
    of them) and its first train step, with its launch counts checked:
    (trainer, loss, the parameters before, the step's gradients).
    ``model_config`` None: Training resolves it from ``cfg``."""
    tr = Training(cfg, device="cuda", params=params, model_config=model_config)
    before = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
    torch.cuda.synchronize()
    reset_launches()
    loss = tr.train_step(batch, step_gen()).item()
    counts = read_launches()
    if want is not None:
        report["launches"][key] = counts
        if counts != want:
            fail(f"{key}: launch counts {counts} (want {want})")
    if not np.isfinite(loss):
        fail(f"{key}: loss {loss}")
    grads = {n: p.grad.detach().clone() for n, p in tr.model.named_parameters()
             if p.grad is not None}
    print(f"trainer: {key}: first-step loss {loss:.8g}, launches {counts}", flush=True)
    return tr, loss, before, grads


def time_steps(step, n: int, card: str, what: str) -> dict:
    """n warm steps: each one's device time (CUDA events around it), its
    wall time to the device's end and the host's enqueue time; peak
    memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dev, wall, host = [], [], []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        step()
        end.record()
        host.append(time.perf_counter() - t0)  # the host's enqueue, before the wait
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
        dev.append(start.elapsed_time(end))
    res = {"events_ms": dev, "events_median_ms": float(np.median(dev)), "step_s": wall,
           "step_median_s": float(np.median(wall)), "host_enqueue_s": host,
           "host_enqueue_median_s": float(np.median(host)),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "card": card}
    print(f"{what}: warm step median {res['events_median_ms']:.2f} ms (CUDA events), "
          f"{res['step_median_s'] * 1e3:.2f} ms wall over {n} (host enqueue median "
          f"{res['host_enqueue_median_s'] * 1e3:.2f} ms), peak memory {res['peak_mem_gb']:.2f} GB"
          f"  [{card}]", flush=True)
    return res


def time_train_steps(card: str, key: str, tr: Training, batch) -> dict:
    gen = step_gen()
    return time_steps(lambda: tr.train_step(batch, gen), TRAIN_STEPS, card, f"trainer: {key}")


def check_frozen_and_moved(tr: Training, before: dict, grads: dict) -> dict:
    """After a step: frozen parameters bit-unchanged, trainable ones moved
    (but those with a 0 gradient, which Adam leaves)."""
    frozen, moved, still = [], [], []
    for n, p in tr.model.named_parameters():
        same = torch.equal(p.detach(), before[n])
        if tr.labels[n] == "frozen":
            frozen.append(n)
            if not same:
                fail(f"trainer: frozen parameter {n} changed in a step")
        elif same:
            still.append(n)
            zero = n not in grads or not bool(grads[n].any())
            if not (zero or n.endswith(ZERO_GRAD_PARAMS)):
                fail(f"trainer: trainable parameter {n} did not move in a step")
        else:
            moved.append(n)
    if not any(n.startswith("backbone.feature_encoder.") for n in frozen) or not any(
            n.startswith("lossnet_embedding.") for n in frozen):
        fail(f"trainer: the recipe froze {len(frozen)} parameters, not the frontend and lossnet")
    print(f"trainer: after a step {len(frozen)} frozen parameters bit-unchanged, {len(moved)} "
          f"trainable moved, {len(still)} unmoved with a 0 gradient {still}", flush=True)
    return {"frozen": len(frozen), "moved": len(moved), "unmoved_zero_grad": still}


def release(tr: Training) -> None:
    """Give the card back a trainer's parameters, gradients and Adam state
    before the next phase (a lingering reference keeps only host memory)."""
    tr.model.to("cpu")
    tr.optimizer = None
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def run_trainer(card: str) -> None:
    report.setdefault("launches", {})
    out: dict = {"card": card}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="nomad_train_") as tmp:
        cfg = write_train_tree(Path(tmp))
        ds = train_data.TripletDataset(cfg, "train_df", level=cfg["current_level"])
        batch = train_data.collate_triplets([ds.load_item(i) for i in range(cfg["train_bs"])])
        shape = (cfg["train_bs"], 163_840)
        if batch.anchor.shape != shape or batch.anchor.dtype != np.int16 or not all(
                (getattr(batch, f) == 160_000).all() for f in ("lengths_a", "lengths_p",
                                                                "lengths_n")):
            fail(f"trainer: batch {batch.anchor.shape} {batch.anchor.dtype}, want {shape} int16 "
                 "of 160,000-sample files")
        batch = train_data._pinned(batch)
        out["batch"] = {"triplets": shape[0], "samples": 160_000, "padded": shape[1],
                        "rows": 3 * shape[0]}

        # the recipe: dropout 0.1, conv frozen, remat (on for Training)
        tr, loss_remat, before, grads = first_train_step(
            "train_step", cfg, batch, launches_want(k5=50))
        out["frozen_moved"] = check_frozen_and_moved(tr, before, grads)
        # the seeded init once (~10 s of host time for BASE): the other
        # trainers start from a copy of it
        init = {n: t.cpu() for n, t in before.items()}
        del before, grads
        out["train_step"] = time_train_steps(card, "train_step (dropout, remat)", tr, batch)
        reset_launches()
        tr.eval_step(batch)
        counts = read_launches()
        report["launches"]["eval_step"] = counts
        if counts != launches_want(k1=12, k5=26):
            fail(f"trainer: eval step launch counts {counts} (want K1 12, K5 26)")
        out["eval_step_ms"] = time_ms(lambda: tr.eval_step(batch), TRAIN_STEPS, warmup=1)
        print(f"trainer: eval step {out['eval_step_ms']:.2f} ms, launches {counts}  [{card}]",
              flush=True)
        with profiler_range(wav2vec2, "mha_dropout", PLAIN_ATTENTION):
            profile_run(lambda: tr.train_step(batch, step_gen()), "profile_train_step",
                        split=ranged_kernels(PLAIN_ATTENTION, "plain attention (products, "
                                             "softmax, dropout; fwd + bwd)"))
        release(tr)

        # dropout without remat: the same masks, so the same loss
        tr, loss_plain_bwd, _, _ = first_train_step(
            "train_step_no_remat", dict(cfg, remat=False), batch, launches_want(k5=26), init)
        out["train_step_no_remat"] = time_train_steps(card, "train_step (dropout, no remat)",
                                                      tr, batch)
        release(tr)
        d = abs(loss_remat - loss_plain_bwd) / abs(loss_remat)
        out["remat_vs_no_remat_loss_rel"] = d
        print(f"trainer: dropout on, remat on vs off: loss {loss_remat:.8g} vs "
              f"{loss_plain_bwd:.8g} (rel {d:.3g})", flush=True)
        if d > 1e-6:
            fail(f"trainer: remat on and off give other losses for one seed (rel {d:.3g})")

        # the dropout rates at 0: attention through K1 + K2 + K3
        tr, _, _, _ = first_train_step("train_step_rates0", cfg, batch,
                                       launches_want(k1=24, k2=12, k3=12, k5=50), init,
                                       mode_config(**ZERO_RATES))
        out["train_step_rates0"] = time_train_steps(card, "train_step (rates at 0, remat)",
                                                    tr, batch)
        release(tr)
        no_remat = dict(cfg, remat=False)
        tr, loss_k, _, grads_k = first_train_step(
            "train_step_rates0_no_remat", no_remat, batch,
            launches_want(k1=12, k2=12, k3=12, k5=26), init, mode_config(**ZERO_RATES))
        release(tr)
        tr, loss_p, _, grads_p = first_train_step(
            "train_step_rates0_plain", no_remat, batch, None, init,
            plain_config(**ZERO_RATES))
        release(tr)
        gmax = max(g.abs().max().item() for g in grads_p.values())
        d_loss = abs(loss_k - loss_p) / abs(loss_p)
        d_grad = max((grads_k[n] - g).abs().max().item() for n, g in grads_p.items()) / gmax
        out["rates0_kernel_vs_plain"] = {"loss": loss_k, "plain_loss": loss_p,
                                         "loss_rel": d_loss, "grad_rel_to_max": d_grad}
        print(f"trainer: rates at 0, kernel path vs plain path: loss rel {d_loss:.3g} "
              f"(<= {TOL_LOSS_REL}), gradient max|d|/max|g| {d_grad:.3g} (<= {TOL_GRAD_REL})",
              flush=True)
        if grads_k.keys() != grads_p.keys() or d_loss > TOL_LOSS_REL or d_grad > TOL_GRAD_REL:
            fail(f"trainer: rates-at-0 step vs plain path: loss rel {d_loss:.3g}, "
                 f"gradient {d_grad:.3g}")
        del grads_k, grads_p

        # two epochs of the loop, a resume from its state, an eval
        tr = Training(cfg, device="cuda", params=init)
        t0 = time.perf_counter()
        tr.training_loop()
        out["training_loop_s"] = time.perf_counter() - t0
        out["loop_last_epoch"] = tr.last_train_stats
        best = Path(cfg["run_dir"]) / "best_model.npz"
        if not best.is_file():
            fail("trainer: training_loop wrote no best_model.npz")
        resumed = Training(dict(cfg, resume=True), device="cuda", params=init)
        state = resumed._load_resume_state()
        if state is None or state[2] != cfg["num_epochs"]:
            fail(f"trainer: resume state {state}, want the next epoch {cfg['num_epochs']}")
        sd, sd_r = tr.model.state_dict(), resumed.model.state_dict()
        opt, opt_r = tr.optimizer.state_dict()["state"], resumed.optimizer.state_dict()["state"]
        same = (all(torch.equal(v, sd_r[k]) for k, v in sd.items())
                and opt.keys() == opt_r.keys()
                and all(torch.equal(v.cpu(), opt_r[i][k].cpu()) for i, s in opt.items()
                        for k, v in s.items())
                and (tr.lr_head, tr.lr_backbone) == (resumed.lr_head, resumed.lr_backbone))
        out["resume"] = {"next_epoch": state[2], "bit_equal": same,
                         "lrs": [resumed.lr_backbone, resumed.lr_head]}
        if not same:
            fail("trainer: the resumed parameters, Adam state or LRs differ from the run's")
        release(resumed)
        reset_launches()
        quality = tr.eval_audio_quality(str(best), plot=False)
        out["eval_audio_quality"] = quality
        out["eval_audio_quality_launches"] = read_launches()
        if not quality or not all(np.isfinite(v) for r in quality.values() for v in r.values()):
            fail(f"trainer: eval_audio_quality {quality}")
        print(f"trainer: 2-epoch loop {out['training_loop_s']:.1f} s, resume bit-equal at epoch "
              f"{state[2]}, eval_audio_quality {quality}", flush=True)
        release(tr)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"trainer: phase 6 took {out['phase_s']:.1f} s", flush=True)
    report["train_path"] = out


# ---------------- phase 7: the speech-enhancement demo ----------------


def write_se_tree(root: Path, counts=(SE_TRAIN, SE_VALID, SE_TEST)) -> dict:
    """Seeded PCM16 Valentini-like pairs (``counts``: train, valid, test):
    clean speech_like clips of 1.5-3 s, noisy = clean + white noise at
    0-15 dB SNR; returns the recipe's config pointed at them."""
    rng = np.random.default_rng(1357)
    cfg = config_io.load(str(SE_RECIPE))
    for split, count in zip(("train", "valid", "test"), counts):
        for kind in ("noisy", "clean"):
            (root / f"{kind}_{split}").mkdir()
            cfg[f"{kind}_{split}_dir"] = str(root / f"{kind}_{split}")
        for i in range(count):
            clean = speech_like(rng, int(rng.integers(24_000, 48_001)), 0.002)
            noise = rng.standard_normal(clean.shape)
            snr_db = rng.uniform(0, 15)
            noise *= np.sqrt(np.mean(clean**2) / np.mean(noise**2)) / 10 ** (snr_db / 20)
            noisy = np.clip(clean + noise, -1, 1).astype(np.float32)
            write_wav(str(root / f"clean_{split}" / f"p{i:03d}.wav"), clean, SR, bits=16)
            write_wav(str(root / f"noisy_{split}" / f"p{i:03d}.wav"), noisy, SR, bits=16)
    cfg["num_epochs"] = 2
    return cfg


def se_first_step(se: SpeechEnhancement, init: dict, noisy, clean, want) -> tuple:
    """The SE's first train step from the U-Net state ``init``: (loss, U-Net
    gradients, running statistics after it, launch counts)."""
    se.unet.load_state_dict(init)
    torch.cuda.synchronize()
    reset_launches()
    loss = se.train_step(noisy, clean).item()
    torch.cuda.synchronize()
    counts = read_launches()
    if want is not None and counts != want:
        fail(f"SE: train step launch counts {counts} (want {want})")
    if not np.isfinite(loss):
        fail(f"SE: first-step loss {loss}")
    grads = {n: p.grad.detach().clone() for n, p in se.unet.named_parameters()}
    stats = {n: b.detach().clone() for n, b in se.unet.named_buffers()}
    return loss, grads, stats, counts


def se_signed_grads(se: SpeechEnhancement, init: dict, signs: list, noisy, clean) -> dict:
    """The U-Net gradients of the SE objective with the L1 terms' signs fixed
    to ``signs`` (one subgradient for both paths), from the state ``init``."""
    se.unet.load_state_dict(init)
    se.unet.train()
    se.optimizer.zero_grad(set_to_none=True)
    clean_t = torch.from_numpy(clean).to(DEV)
    est = se.unet(torch.from_numpy(noisy).to(DEV))
    with torch.no_grad():
        ref = se.nomad.model.forward_layers(clean_t)
    terms = sum((s_ * (a - c)).mean() for s_, a, c in zip(
        signs, se.nomad.model.forward_layers(est), ref))
    (torch.mean((est - clean_t) ** 2) + se.nomad_weight * terms).backward()
    return {n: p.grad.detach().clone() for n, p in se.unet.named_parameters()}


def run_se(card: str) -> None:
    """The SE demo at the recipe of se_config.yaml: the full-width
    Wave-U-Net (12 levels, interval 24) on 32 x 16,384-sample crops, the
    seeded BASE lossnet, MSE + 0.001 NOMAD, Adam 1e-4."""
    report.setdefault("launches", {})
    out: dict = {"card": card}
    t_phase = time.perf_counter()
    cwd = Path.cwd()
    with tempfile.TemporaryDirectory(prefix="nomad_se_") as tmp:
        tmp = Path(tmp)
        cfg = write_se_tree(tmp)
        nomad = Nomad(device="cuda")
        se = SpeechEnhancement(cfg, device="cuda", nomad=nomad)
        if se.nomad_weight != 0.001 or int(cfg["train_bs"]) != 32 or cfg["loss_dropout"]:
            fail(f"SE: the recipe reads {cfg}")
        lossnet = {k: v.clone() for k, v in nomad.model.state_dict().items()}
        noisy, clean = next(se.train_set.batches(int(cfg["train_bs"]), shuffle=False))
        if noisy.shape != (32, 16384):
            fail(f"SE: train batch {noisy.shape}, want (32, 16384)")
        init = {k: v.clone() for k, v in se.unet.state_dict().items()}

        # the first step on the kernels, then on the plain path (plain
        # attention and LayerNorm) from the same U-Net state and batch
        want = launches_want(k1=24, k2=12, k3=12, k5=52)
        loss_k, grads_k, stats_k, counts = se_first_step(se, init, noisy, clean, want)
        report["launches"]["se_train_step"] = counts
        plain = SpeechEnhancement(cfg, device="cuda", nomad=Nomad(
            device="cuda", config=plain_config(), params=nomad.model.state_dict()))
        loss_p, grads_p, stats_p, _ = se_first_step(plain, init, noisy, clean, None)
        se.unet.load_state_dict(init)
        se.unet.train()
        with torch.no_grad():
            est = se.unet(torch.from_numpy(noisy).to(DEV))
        clean_t = torch.from_numpy(clean).to(DEV)
        signs = layer_signs(nomad, est, clean_t)
        flips = sum(int((a != b).sum()) for a, b in zip(signs, layer_signs(plain.nomad, est,
                                                                          clean_t)))
        grads_s = se_signed_grads(plain, init, signs, noisy, clean)
        del est, clean_t, plain
        gmax = max(g.abs().max().item() for g in grads_s.values())
        d_loss = abs(loss_k - loss_p) / abs(loss_p)
        d_direct = max((grads_k[n] - g).abs().max().item() for n, g in grads_p.items()) / gmax
        d_signs = max((grads_k[n] - g).abs().max().item() for n, g in grads_s.items()) / gmax
        d_stats = max((stats_k[n] - b).abs().max().item() for n, b in stats_p.items())
        out["first_step"] = {"loss": loss_k, "plain_loss": loss_p, "loss_rel": d_loss,
                             "grad_rel_direct": d_direct, "grad_rel_same_signs": d_signs,
                             "sign_flips": flips, "running_stats_max_abs": d_stats}
        print(f"SE: first step, launches {counts}; kernel vs plain path: loss {loss_k:.8g} vs "
              f"{loss_p:.8g} (rel {d_loss:.3g} <= {TOL_LOSS_REL}), U-Net gradients max|d|/max|g| "
              f"{d_direct:.3g} direct, {d_signs:.3g} under one sign pattern (<= {TOL_GRAD_REL}; "
              f"{flips} layer elements change sign), running statistics max|d| {d_stats:.3g} "
              f"(<= {TOL_SE_STATS})", flush=True)
        if d_loss > TOL_LOSS_REL or d_signs > TOL_GRAD_REL or d_stats > TOL_SE_STATS or (
                flips == 0 and d_direct > TOL_GRAD_REL):
            fail(f"SE: kernel step vs plain path: loss rel {d_loss:.3g}, gradients {d_direct:.3g} "
                 f"direct / {d_signs:.3g} same signs, running statistics {d_stats:.3g}")
        del grads_k, grads_p, grads_s, stats_k, stats_p
        torch.cuda.empty_cache()

        # warm train steps from the first step's state on, then what moved
        se.unet.load_state_dict(init)
        out["train_step"] = time_steps(lambda: se.train_step(noisy, clean), SE_STEPS, card,
                                       "SE: train step (U-Net + lossnet + Adam)")
        unmoved = [n for n, v in se.unet.state_dict().items() if torch.equal(v, init[n])]
        if any(not n.endswith(SE_PRE_BN_BIAS) for n in unmoved):
            fail(f"SE: U-Net tensors unmoved by the steps: {unmoved}")
        changed = [k for k, v in nomad.model.state_dict().items() if not torch.equal(v, lossnet[k])]
        if changed:
            fail(f"SE: the steps changed the lossnet: {changed[:5]}")
        out["moved"] = {"unet_tensors": len(init), "unmoved": unmoved, "lossnet_bit_unchanged":
                        len(lossnet)}
        print(f"SE: after {SE_STEPS + 2} steps {len(init) - len(unmoved)} of {len(init)} U-Net "
              f"tensors moved (unmoved: {unmoved}); the {len(lossnet)} lossnet tensors "
              "bit-unchanged", flush=True)
        with profiler_range(se.unet, "forward", UNET_RANGE):
            profile_run(lambda: se.train_step(noisy, clean), "profile_se_train_step",
                        split=ranged_kernels(UNET_RANGE, "Wave-U-Net (fwd + bwd)"))

        # the U-Net alone: forward, MSE, backward, Adam
        noisy_t, clean_t = torch.from_numpy(noisy).to(DEV), torch.from_numpy(clean).to(DEV)

        def unet_step():
            se.unet.train()
            loss = torch.mean((se.unet(noisy_t) - clean_t) ** 2)
            se.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            se.optimizer.step()

        reset_launches()
        out["unet_step"] = time_steps(unet_step, SE_STEPS, card,
                                      "SE: U-Net-alone step (MSE + Adam)")
        report["launches"]["se_unet_step"] = read_launches()
        out["lossnet_share_ms"] = (out["train_step"]["events_median_ms"]
                                   - out["unet_step"]["events_median_ms"])

        # the eval step on the recipe's valid batch of 100
        v_noisy, v_clean = next(se.valid_set.batches(int(cfg["valid_bs"]), shuffle=False))
        reset_launches()
        se.eval_step(v_noisy, v_clean)
        torch.cuda.synchronize()
        counts = read_launches()
        report["launches"]["se_eval_step"] = counts
        if v_noisy.shape != (100, 16384) or counts != launches_want(k1=24, k5=52):
            fail(f"SE: eval step on {v_noisy.shape}: launch counts {counts} (want K1 24, K5 52)")
        out["eval_step_ms"] = time_ms(lambda: se.eval_step(v_noisy, v_clean), SE_STEPS, warmup=1)
        t0 = time.perf_counter()
        quality = se.test()
        out["test"] = quality | {"host_s": time.perf_counter() - t0, "pairs": SE_TEST}
        if quality["metric"] != "pesq_wb" or not np.isfinite(quality["value"]):
            fail(f"SE: test() gave {quality}")
        print(f"SE: eval step (100 x 16,384) {out['eval_step_ms']:.2f} ms, launches {counts}; "
              f"test() {quality['metric']} {quality['value']:.4f} on {SE_TEST} pairs in "
              f"{out['test']['host_s']:.2f} s  [{card}]", flush=True)
        del se
        torch.cuda.empty_cache()

        # two epochs of the loop in a working directory of its own, then its
        # best_model.npz into a new SpeechEnhancement: enhance the same bits
        loop = SpeechEnhancement(cfg, device="cuda", nomad=nomad)
        probe = noisy[:8]
        saved: dict = {}
        save = loop.save

        def save_and_probe(path):
            save(path)
            saved["path"], saved["enhanced"] = path, loop.enhance(probe).clone()

        loop.save = save_and_probe
        os.chdir(tmp)
        try:
            t0 = time.perf_counter()
            loop.training_loop()
            out["training_loop_s"] = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
        best = tmp / saved["path"]
        if not best.is_file() or not (best.parent / "config.yaml").is_file():
            fail(f"SE: training_loop wrote no {saved.get('path')} or config.yaml")
        reloaded = SpeechEnhancement(cfg, device="cuda", nomad=nomad)
        reloaded.load(str(best))
        same = torch.equal(reloaded.enhance(probe), saved["enhanced"])
        out["reload_bit_equal"] = same
        print(f"SE: 2-epoch training_loop {out['training_loop_s']:.1f} s; {best.name} reloaded "
              f"enhances the same bits: {same}", flush=True)
        if not same:
            fail("SE: the reloaded best_model.npz enhances other bits")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"SE: phase 7 took {out['phase_s']:.1f} s", flush=True)
    report["se_path"] = out


# ---------------- phase 8: the scoring service ----------------


def write_serve_tree(root: Path) -> dict:
    """Phase 4's 8 NMR + 100 degraded 10 s PCM16 WAVs (the same seed),
    FLAC twins of 4 degraded files (112 files: a batch of 96 and a tail of
    16), 4 new 10 s WAVs for the embed request, and a seeded BASE
    ``pt-models/nomad_best_model.pt`` in fairseq's key layout."""
    nmr, deg = write_wavs(root)
    twins = []
    for i in SERVE_TWINS:
        wav_path = Path(deg) / f"deg_{i:03d}.wav"
        wave, sr = read_wav(str(wav_path))
        flac_path = Path(deg) / f"deg_{i:03d}_flac.flac"  # a stem of its own
        write_flac(str(flac_path), wave, sr)
        twins.append((str(flac_path), str(wav_path)))
    rng = np.random.default_rng(2468)
    new = root / "new"
    new.mkdir()
    new_paths = []
    for i in range(SERVE_NEW):
        new_paths.append(str(new / f"new_{i}.wav"))
        write_wav(new_paths[-1], speech_like(rng, int(SECONDS * SR), 0.05), SR, bits=16)
    weights = root / "pt-models"
    weights.mkdir()
    model = init_weights(NomadModel(Wav2Vec2Config.base(), emb_dim=256), seed=SERVE_SEED)
    t0 = time.perf_counter()
    write_nomad_checkpoint(model, str(weights / NOMAD_FILENAME))
    write_s = time.perf_counter() - t0
    cached = sorted(str(p) for p in Path(nmr).iterdir())[:8] + \
        sorted(str(p) for p in Path(deg).iterdir())[:8]
    clean = np.stack([speech_like(rng, LOSS_SAMPLES, 0.005) for _ in range(SERVE_LOSS_BATCH)])
    est = clean + (0.03 * rng.standard_normal(clean.shape)).astype(np.float32)
    return {"nmr": nmr, "deg": deg, "twins": twins, "new": new_paths, "cached": cached,
            "weights": weights, "model": model, "pt_write_s": write_s,
            "pt_bytes": (weights / NOMAD_FILENAME).stat().st_size,
            "loss": (est.astype(np.float32), clean.astype(np.float32))}


def serve_requests(tree: dict, out: Path) -> list:
    score = {"op": "score", "nmr": tree["nmr"], "deg": tree["deg"], "results_path": str(out)}
    est, clean = tree["loss"]
    return [{"op": "ping"}, score, score, {"op": "embed", "paths": tree["cached"] + tree["new"]},
            {"op": "loss", "estimate": est.tolist(), "clean": clean.tolist()},
            {"op": "stats"}, {"op": "shutdown"}]


def serve_process(tree: dict, root: Path, tag: str, warm: bool) -> dict:
    """``python -m nomad_tpu_torch.serve`` in ``root`` (weights from
    ``pt-models/`` there), one request at a time: every stdout line must
    parse as JSON, every response be ok, and the process exit 0 after
    ``shutdown``. The ping, sent at once, is answered when the server is
    ready: its wall time from the start is the cold start."""
    out = root / f"results_{tag}"
    out.mkdir()
    cmd = [sys.executable, "-m", "nomad_tpu_torch.serve"] + (["--warm", "10"] if warm else [])
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    err_path = root / f"serve_{tag}.stderr"
    with open(err_path, "w") as err:
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, cwd=root, env=env, stdin=subprocess.PIPE,
                                stdout=subprocess.PIPE, stderr=err, text=True)
        watchdog = threading.Timer(SERVE_TIMEOUT_S, proc.kill)
        watchdog.start()
        try:
            resps, walls = [], []
            for req in serve_requests(tree, out):
                t = time.perf_counter()
                proc.stdin.write(json.dumps(req) + "\n")
                proc.stdin.flush()
                line = proc.stdout.readline()
                walls.append(time.perf_counter() - (t0 if req["op"] == "ping" else t))
                if not line:
                    fail(f"serve {tag}: no answer to {req['op']}; stderr:\n"
                         f"{err_path.read_text()[-3000:]}")
                try:
                    resp = json.loads(line)
                except json.JSONDecodeError:
                    fail(f"serve {tag}: a stdout line is not JSON: {line[:200]!r}")
                if not resp.get("ok"):
                    fail(f"serve {tag}: {req['op']} failed: {resp}")
                resps.append(resp)
            rest = proc.stdout.read()
            rc = proc.wait(timeout=60)
        finally:
            watchdog.cancel()
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if rc != 0 or rest.strip():
        fail(f"serve {tag}: exit {rc}, stdout after shutdown {rest[:200]!r}; stderr:\n"
             f"{err_path.read_text()[-3000:]}")
    named = dict(zip(SERVE_KEYS, resps))
    wall = dict(zip(SERVE_KEYS, walls))
    t = named["stats"]["transfer"]
    if t["native_batches"] != t["batches"] or t["python_batches"] != 0:
        fail(f"serve {tag}: not every batch came through the native ingest: {t}")
    hits = named["stats"]["embed_cache"]["hits"]
    if named["score"] != named["score_repeat"] or hits != N_SERVE + len(tree["cached"]):
        fail(f"serve {tag}: the repeated score differs, or cache hits {hits} "
             f"(want {N_SERVE + len(tree['cached'])})")
    # the server logs its --warm time to stderr
    warmed = [json.loads(ln)["warmed_s"] for ln in err_path.read_text().splitlines()
              if ln.startswith('{"warmed_s"')]
    print(f"serve {tag}: " + ", ".join(f"{k} {v:.3f} s" for k, v in wall.items())
          + f" (ping: from the process's start); warm {warmed}; transfer {t}", flush=True)
    return {"resps": named, "wall_s": wall, "stats": named["stats"], "warmed_s": warmed}


def run_serve(card: str) -> None:
    """The scoring service at full BASE width on weights loaded from a
    fairseq-named ``nomad_best_model.pt``: three processes of ``python -m
    nomad_tpu_torch.serve`` (from the .pt with ``--warm 10``; from the npz
    cache the first wrote, with and without ``--warm``), then the server
    in this process for the launch counts and the checks."""
    report.setdefault("launches", {})
    t_phase = time.perf_counter()
    _build.build()  # every kernel, in parallel, before any process times its start
    if not native.available():
        fail(f"the native ingest library did not build: {native.build_error()}")
    gc.collect()
    torch.cuda.empty_cache()
    out: dict = {"card": card}
    with tempfile.TemporaryDirectory(prefix="nomad_serve_") as tmp:
        root = Path(tmp)
        tree = write_serve_tree(root)
        out |= {"pt_write_s": tree["pt_write_s"], "pt_bytes": tree["pt_bytes"]}
        cache = tree["weights"] / CACHE_FILENAME
        processes = {"pt_warm": serve_process(tree, root, "pt_warm", warm=True)}
        if not cache.is_file():
            fail(f"serve: no {CACHE_FILENAME} after loading the .pt")
        processes["npz_warm"] = serve_process(tree, root, "npz_warm", warm=True)
        processes["npz_cold"] = serve_process(tree, root, "npz_cold", warm=False)
        base = processes["pt_warm"]["resps"]
        emb_base = np.asarray(base["embed"]["embeddings"])
        for tag in ("npz_warm", "npz_cold"):
            resps = processes[tag]["resps"]
            if resps["score"] != base["score"]:
                fail(f"serve {tag}: score records differ from the .pt process's")
            d = float(np.abs(np.asarray(resps["embed"]["embeddings"]) - emb_base).max())
            out[f"{tag}_vs_pt_embed_max_abs"] = d
            if d > TOL_BATCH1:
                fail(f"serve {tag}: embeddings {d:.3g} from the .pt process's (> {TOL_BATCH1})")
        out["processes"] = {k: {"wall_s": v["wall_s"], "stats": v["stats"],
                               "warmed_s": v["warmed_s"]} for k, v in processes.items()}
        out["cold_start_pt_s"] = processes["pt_warm"]["wall_s"]["ping"]
        out["cold_start_npz_s"] = processes["npz_warm"]["wall_s"]["ping"]
        out["first_score_warm_s"] = processes["npz_warm"]["wall_s"]["score"]
        out["first_score_no_warm_s"] = processes["npz_cold"]["wall_s"]["score"]
        out["cold_start_npz_no_warm_s"] = processes["npz_cold"]["wall_s"]["ping"]
        print(f"serve: cold start {out['cold_start_pt_s']:.2f} s from the .pt "
              f"({out['pt_bytes'] / 1e6:.0f} MB, written in {out['pt_write_s']:.2f} s), "
              f"{out['cold_start_npz_s']:.2f} s from the npz (both with --warm 10; "
              f"{out['cold_start_npz_no_warm_s']:.2f} s without); first score "
              f"{out['first_score_warm_s']:.3f} s warmed vs {out['first_score_no_warm_s']:.3f} s "
              f"not  [{card}]", flush=True)
        run_serve_in_process(card, tree, root, base, out)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"serve: phase 8 took {out['phase_s']:.1f} s", flush=True)
    report["serve_path"] = out


def serve_step(server: NomadServer, req: dict, key: str, want: dict) -> dict:
    """One request in process with its launch counts."""
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    resp = server.handle(req)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_launches()
    report["launches"][key] = counts
    if not resp.get("ok") or counts != want:
        fail(f"serve in process, {key}: ok={resp.get('ok')}, launches {counts} (want {want})")
    print(f"serve in process: {key} {wall:.3f} s, launches {counts}", flush=True)
    return resp


def run_serve_in_process(card: str, tree: dict, root: Path, base: dict, out: dict) -> None:
    gc.collect()
    torch.cuda.empty_cache()
    held_gb = torch.cuda.memory_allocated() / 1e9  # cuBLAS workspaces included
    leftover_gb = settled_allocated_gb()  # left by earlier phases: not the service's
    nomad = Nomad(device="cuda", weights_dir=str(tree["weights"]))  # the npz cache
    server = NomadServer(nomad)
    out["in_process_warm"] = server.handle({"op": "warm", "seconds": [SECONDS]})
    eng = nomad.engine
    reqs = {r["op"]: r for r in serve_requests(tree, root / "results_in_process")}
    (root / "results_in_process").mkdir()
    torch.cuda.reset_peak_memory_stats()
    hits0 = eng.cache_hits
    cold = serve_step(server, reqs["score"], "serve_score_cold", launches_want(k1=24, k5=52))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    repeat = serve_step(server, reqs["score"], "serve_score_repeat", launches_want())
    repeat_hits = eng.cache_hits - hits0
    emb = serve_step(server, reqs["embed"], "serve_embed", launches_want(k1=12, k5=26))
    loss = serve_step(server, reqs["loss"], "serve_loss", launches_want(k1=24, k5=52))
    if repeat != cold or cold != base["score"] or repeat_hits != N_SERVE:
        fail(f"serve in process: repeated score equal {repeat == cold}, equal to the served "
             f"one {cold == base['score']}, hits {repeat_hits} (want {N_SERVE})")
    # the service's own peak against phase 4's own in this run (the same
    # 96-row batch), plus the cache's rows the service holds besides
    own_gb = peak_gb - leftover_gb
    main = report.get("main_path")
    phase4_gb = main["peak_mem_gb"] - main["leftover_mem_gb"] if main else PEAK_SCORING_GB
    cache_gb = N_SERVE * nomad.model.emb_dim * 4 / 1e9
    if own_gb > phase4_gb + cache_gb:
        fail(f"serve in process: own peak {own_gb:.5f} GB over phase 4's {phase4_gb:.5f} GB "
             f"+ the cache's {cache_gb:.6f} GB")
    t = eng.transfer_stats()
    if t["native_batches"] != t["batches"] or t["python_batches"] != 0:
        fail(f"serve in process: not every batch came through the native ingest: {t}")
    # the served embeddings: the subprocess's and a cache-less engine's
    emb = np.asarray(emb["embeddings"], np.float32)
    d_served = float(np.abs(emb - np.asarray(base["embed"]["embeddings"])).max())
    paths = reqs["embed"]["paths"]
    fresh = EmbeddingEngine(nomad.model, DEV).embed_files(paths)
    d_fresh = float(np.abs(emb - fresh).max())
    # FLAC twins, from the cache the cold score filled (no launch)
    twins = eng.embed_files_device([p for pair in tree["twins"] for p in pair])
    d_twins = float((twins[0::2] - twins[1::2]).abs().max())
    # the loss op against the plain path on the same weights
    est, clean = tree["loss"]
    plain = Nomad(device="cuda", config=plain_config(), params=nomad.model.state_dict())
    with torch.no_grad():
        loss_plain = plain.forward(est, clean).item()
    d_loss = abs(loss["loss"] - loss_plain) / abs(loss_plain)
    del plain
    # the .pt-loaded weights against the npz-loaded ones, and against the
    # model the .pt was written from
    pt_only = root / "pt_only"
    pt_only.mkdir()
    shutil.copy(tree["weights"] / NOMAD_FILENAME, pt_only / NOMAD_FILENAME)
    t0 = time.perf_counter()
    from_pt = Nomad(device="cuda", weights_dir=str(pt_only)).model.state_dict()
    pt_load_s = time.perf_counter() - t0
    from_npz = nomad.model.state_dict()
    pt_vs_npz = [k for k in from_npz if not torch.equal(from_pt[k].cpu(), from_npz[k].cpu())]
    written = tree["model"].state_dict()
    d_written = max(float((from_pt[k].cpu() - written[k]).abs().max() /
                          written[k].abs().max().clamp_min(1e-30))
                    for k in written if not k.startswith("lossnet_embedding"))
    out["in_process"] = {
        "peak_mem_gb": peak_gb, "own_peak_mem_gb": own_gb, "leftover_mem_gb": leftover_gb,
        "held_before_release_gb": held_gb, "phase4_own_peak_mem_gb": phase4_gb,
        "repeat_cache_hits": repeat_hits, "transfer": t,
        "embed_vs_served_max_abs": d_served, "embed_vs_cacheless_engine_max_abs": d_fresh,
        "flac_twins_vs_wav_max_abs": d_twins, "loss": loss["loss"], "plain_loss": loss_plain,
        "loss_rel_diff": d_loss, "pt_vs_npz_state_dict_differ": pt_vs_npz,
        "pt_vs_written_max_rel": d_written, "pt_load_convert_s": pt_load_s,
        "stats": server.handle({"op": "stats"}),
    }
    print(f"serve in process: own peak {own_gb:.5f} GB (<= phase 4's {phase4_gb:.5f} + the "
          f"cache's {cache_gb:.6f}; earlier phases left {held_gb:.5f} GB allocated, "
          f"{leftover_gb:.5f} GB after releasing the cuBLAS workspaces); repeated score "
          f"{repeat_hits} hits; embeddings vs the served ones max|d| {d_served:.3g}, vs a "
          f"cache-less engine {d_fresh:.3g} (<= {TOL_BATCH1}); FLAC twins vs WAVs {d_twins:.3g}; "
          f"loss {loss['loss']:.6g} vs plain {loss_plain:.6g} (rel {d_loss:.3g} <= "
          f"{TOL_LOSS_REL}); .pt vs npz weights: {len(pt_vs_npz)} tensors differ; .pt vs the "
          f"written model max rel {d_written:.3g}; .pt load + convert {pt_load_s:.2f} s; "
          f"transfer {t}  [{card}]", flush=True)
    if max(d_served, d_fresh, d_twins) > TOL_BATCH1 or d_loss > TOL_LOSS_REL or pt_vs_npz \
            or d_written > 1e-6:
        fail("serve in process: a check failed (see the line above)")
    # one profiled cold score: an empty cache, so every file is embedded
    def cold_score():
        server.nomad.engine.file_cache = EmbeddingLRU()
        server.handle(reqs["score"])

    profile_run(cold_score, "profile_serve_score")


# ---------------- phase 9: the precision modes ----------------


def attention_f64(q, k, v, lengths):
    """Exact masked attention in float64, the oracle of K1b and of its
    plain version: keys past each bound ignored, a row with no key 0."""
    t, d = q.shape[1], q.shape[3]
    valid = torch.arange(t, device=q.device)[None, :] < lengths.long()[:, None]
    kd = torch.where(valid[:, :, None, None], k, 0.0).double()
    vd = torch.where(valid[:, :, None, None], v, 0.0).double()
    s = torch.einsum("bqhd,bkhd->bhqk", q.double() / d**0.5, kd)
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1).nan_to_num(0.0)
    return torch.einsum("bhqk,bkhd->bqhd", p, vd)


def k1b_bounds(b: int, t: int, h: int, d: int, lengths: torch.Tensor, io_bytes: int,
               pv_passes: int = 1) -> dict:
    """K1b's prologue and kernel, each against what it moves: the prologue
    reads the valid rows of k and v once and writes the fold (bf16 [2, B*H,
    T64, D]) once; the kernel reads q, the fold's valid rows and lengths and
    writes O and LSE, and does the work's operations on the bf16 tensor
    cores: S in one pass, P . V in ``pv_passes`` (K1-bf16: 3)."""
    t_pad = -(-t // 64) * 64
    keys = int(lengths.long().clamp(0, t).sum())
    fold = bound(io_bytes * 2 * keys * h * d + 2 * 2 * b * h * t_pad * d, 0.0)
    kernel = bound(2 * io_bytes * b * t * h * d + 2 * 2 * keys * h * d + 4.0 * (b * h * t + b),
                   2.0 * (1 + pv_passes) * h * d * t * keys, BF16_FLOPS)
    return {"fold": fold, "kernel": kernel}


def fold_fwd_plain(k, v, lengths) -> torch.Tensor:
    """The plain version of K1b's prologue: k and v folded by
    ``fold_bf16_ref``, zero past each bound, as one [2, B*H, T64, D]."""
    return torch.stack([flash_attention.fold_bf16_ref(x, lengths, True) for x in (k, v)])


def check_fold_fwd(q, k, v, lengths, timed: bool, prec: str = "default") -> dict:
    """K1b's (``prec`` "default") or K1-bf16's ("highest") prologue through
    its wrapper against ``fold_fwd_plain`` on the card, bit for bit; the
    kernel alone on that fold against the one call (``mha_flash``), bit for
    bit; with ``timed``, the prologue's and the kernel's times, each beside
    the bound of what it moves, and the prologue's plain version's. Returns
    {"fold": ..., "kernel": ...}."""
    b, t, h, d = q.shape
    ws = flash_attention._flash_bf16_fold(q, k, v, lengths)
    ref = fold_fwd_plain(k, v, lengths)
    alone = flash_attention._flash_bf16_body(q, ws, lengths, prec)
    call = flash_attention.mha_flash(q, k, v, lengths, prec)
    torch.cuda.synchronize()
    if not torch.equal(ws, ref):
        fail(f"flash bf16 prologue [{b}, {t}, {h}, {d}] ({q.dtype}): its fold differs from "
             f"fold_bf16_ref's")
    if not (torch.equal(alone[0], call[0]) and torch.equal(alone[1], call[1])):
        fail(f"flash bf16 [{b}, {t}, {h}, {d}] ({q.dtype}): the kernel alone on the prologue's "
             f"fold differs from the one call's bits")
    bounds = k1b_bounds(b, t, h, d, lengths, q.element_size(),
                        flash_attention.flash_bf16_launch_plan(t, b, h, prec)["passes"])
    res = {"fold": {"max_abs_err": 0.0, "bit_equal": True, "bound_ms": bounds["fold"][0],
                    "bound_by": bounds["fold"][1], "library_ms": None},
           "kernel": {"bound_ms": bounds["kernel"][0], "bound_by": bounds["kernel"][1]}}
    if timed:
        iters = 10 if t > 1024 else 30
        res["fold"]["ms"] = time_ms(
            lambda: flash_attention._flash_bf16_fold(q, k, v, lengths, ws), iters)
        res["fold"]["plain_ms"] = time_ms(lambda: fold_fwd_plain(k, v, lengths), 5)
        res["kernel"]["ms"] = time_ms(
            lambda: flash_attention._flash_bf16_body(q, ws, lengths, prec), iters)
    return res


def check_flash_bf16(b: int, t: int, lengths: list, g: torch.Generator, timed: bool,
                     kernel_time: bool = True) -> dict:
    """K1b against flash_attention_ref(..., "default") on the card, NaN in k
    and v past each bound: every row finite; LSE within K1's tolerance of
    the plain one; O no further from exact float64 attention than 1.5 x the
    plain version's distance + 1e-6 (the kernel rounds p against the
    running maximum, the plain version against the final one: the same
    bf16 error class, other bits) and no nearer than half of it (it does
    round); a 0-key row O = 0, LSE = -1e30; a rerun the same bits; its
    prologue's fold bit-equal to ``fold_bf16_ref``'s and the kernel alone
    on it the one call's bits. ``kernel_time``: the call through
    ``mha_flash`` (prologue included) against the work's bound, the
    prologue and the kernel each alone against what it moves; ``timed``:
    the plain version, and the call in turns with SDPA on bf16 copies of q,
    k, v, the three casts made outside the timed call (the stricter
    yardstick, ``library_ms``) and inside it."""
    h, d = 12, 64
    qkv = torch.randn(b, t, 3, h, d, generator=g).to(DEV)
    q, k, v = qkv.unbind(2)
    for i, n in enumerate(lengths):
        k[i, n:] = float("nan")
        v[i, n:] = float("nan")
    lens = torch.tensor(lengths, dtype=torch.int32, device=DEV)
    o, lse = flash_attention.mha_flash(q, k, v, lens, "default")
    torch.cuda.synchronize()
    err = err_f64 = err_plain_f64 = err_lse = 0.0
    excess = float("-inf")  # max of |O - O_f64| - (1.5 |O_plain - O_f64| + 1e-6): > 0 fails
    for i in range(b):  # one batch row at a time: [1, H, T, T] in float64
        sl = slice(i, i + 1)
        ro, rlse = flash_attention.flash_attention_ref(q[sl], k[sl], v[sl], lens[sl], "default")
        exact = attention_f64(q[sl], k[sl], v[sl], lens[sl])
        e = (o[sl].double() - exact).abs().max().item()
        ep = (ro.double() - exact).abs().max().item()
        excess = max(excess, e - (1.5 * ep + 1e-6))
        err = max(err, (o[sl] - ro).abs().max().item())
        err_f64, err_plain_f64 = max(err_f64, e), max(err_plain_f64, ep)
        err_lse = max(err_lse, (lse[sl] - rlse).abs().max().item())
        del ro, rlse, exact
    finite = bool(torch.isfinite(o).all() and torch.isfinite(lse).all())
    empty_ok = all(bool((o[i] == 0).all() and (lse[i] == flash_attention.NEG_INF).all())
                   for i, n in enumerate(lengths) if n == 0)
    again = flash_attention.mha_flash(q, k, v, lens, "default")
    same_bits = torch.equal(again[0], o) and torch.equal(again[1], lse)
    del again
    rounds = err_f64 >= 0.5 * err_plain_f64
    if not (finite and empty_ok and same_bits and rounds) or excess > 0 or err_lse > TOL_FLASH:
        fail(f"flash bf16 [{b}, {t}, {h}, {d}] finite={finite} 0-key rows={empty_ok} rerun same "
             f"bits={same_bits}; max|O - O_f64| {err_f64:.3g} beyond 1.5 x the plain version's "
             f"{err_plain_f64:.3g} + 1e-6 by {excess:.3g}, or under half of it; LSE max|d| "
             f"{err_lse:.3g} (<= {TOL_FLASH})")
    b_ms, b_by = flash_bound(b, t, h, d, lens, BF16_FLOPS)
    parts = check_fold_fwd(q, k, v, lens, kernel_time)
    res = {"shape": [b, t, h, d], "lengths_sum": int(lens.sum()), "max_abs_err": err,
           "max_abs_err_vs_f64": err_f64, "plain_max_abs_err_vs_f64": err_plain_f64,
           "lse_max_abs_err": err_lse, "bound_ms": b_ms, "bound_by": b_by,
           "fold": parts["fold"] | {"shape": [b, t, h, d]}}
    res |= {f"kernel_{f}": v for f, v in parts["kernel"].items()}

    def call():
        return flash_attention.mha_flash(q, k, v, lens, "default")

    if kernel_time:
        res["ms"] = time_ms(call, 10 if t > 1024 else 30)
    if timed:
        mask = (torch.arange(t, device=DEV)[None, :] < lens[:, None])[:, None, None, :]
        qb, kb, vb = (x.nan_to_num(0.0).transpose(1, 2).to(torch.bfloat16) for x in (q, k, v))
        kz, vz = (x.nan_to_num(0.0) for x in (k, v))  # SDPA's mask cannot drop a NaN

        def library_casts_inside():
            return F.scaled_dot_product_attention(
                *(x.transpose(1, 2).to(torch.bfloat16) for x in (q, kz, vz)), attn_mask=mask)

        res["plain_ms"] = time_ms(
            lambda: flash_attention.flash_attention_ref(q, k, v, lens, "default"), 5)
        iters = 10 if t > 1024 else 30
        res["call_in_turns_ms"], res["library_ms"] = time_pair_ms(
            call, lambda: F.scaled_dot_product_attention(qb, kb, vb, attn_mask=mask), iters,
            rounds=5)
        res["call_in_turns_inside_ms"], res["library_casts_inside_ms"] = time_pair_ms(
            call, library_casts_inside, iters, rounds=5)
    fold, kern = res["fold"], parts["kernel"]
    print(f"  flash bf16 [{b}, {t}, {h}, {d}] keys {int(lens.sum())}: vs plain max|d| {err:.3g}, "
          f"vs f64 {err_f64:.3g} (plain {err_plain_f64:.3g}), LSE {err_lse:.3g}; prologue "
          f"bit-equal to fold_bf16_ref, the kernel alone the one call's bits"
          + (f"; through mha_flash {res['ms']:.4f} ms (the work's bound {b_ms:.4f}, {b_by}; "
             f"{b_ms / res['ms']:.1%}), prologue {fold['ms']:.4f} ms (bound "
             f"{fold['bound_ms']:.4f}; {fold['bound_ms'] / fold['ms']:.1%}), kernel "
             f"{kern['ms']:.4f} ms (bound {kern['bound_ms']:.4f}, {kern['bound_by']}; "
             f"{kern['bound_ms'] / kern['ms']:.1%})" if kernel_time else "")
          + (f"; plain {res['plain_ms']:.4f} ms; in turns: the call {res['call_in_turns_ms']:.4f}"
             f" vs sdpa bf16 (casts outside) {res['library_ms']:.4f}, the call "
             f"{res['call_in_turns_inside_ms']:.4f} vs sdpa bf16 with its casts "
             f"{res['library_casts_inside_ms']:.4f}" if timed else ""), flush=True)
    return res


def check_flash_bf16_shapes() -> None:
    g = torch.Generator().manual_seed(9)
    rng = np.random.default_rng(9)
    # the scoring shape as phase 3 holds K1 there: 499 valid frames of 511,
    # a few rows ragged down to 1 key, one full row, one row with no key
    main_lens = [511, 1, 0] + list(rng.integers(2, 511, size=9)) + [499] * 84
    res = {"main": check_flash_bf16(96, 511, main_lens, g, timed=True),
           "loss": check_flash_bf16(LOSS_BATCH, 50, [50] * LOSS_BATCH, g, timed=True),
           "long": check_flash_bf16(8, 4095, [4095, 4000, 3001, 2048, 1025, 513, 64, 0], g,
                                    timed=False)}
    # every edge of the 16-row warp tiles, 64-row blocks and 64-key tiles,
    # then of the 4-stage ring: 2, 3, 4 and 5 tiles, full and ragged
    for t in (1, 15, 16, 17, 63, 64, 65, 511) + K1B_RING_EDGES:
        res[f"edge_T{t}"] = check_flash_bf16(4, t, [t, max(t // 2, 1), 1, 0], g, timed=False,
                                             kernel_time=False)
    report["kernels"]["flash_attention_bf16_fwd"] = res
    report["kernels"]["flash_attention_fwd_fold_bf16"] = {k: r["fold"] for k, r in res.items()}


def speechish(n: int, seed: int) -> list:
    """Pause-heavy pitch-modulated harmonics, 10 s each (a copy of
    ``scripts/precision_ladder.py::speechish``, unpadded): the material on
    which the JAX package's precision studies found mixed-precision error
    largest."""
    out = []
    t = np.arange(int(SR * SECONDS)) / SR
    for i in range(n):
        r = np.random.default_rng(seed * 1000 + i)
        f0 = 90 + 80 * r.random()
        ph = np.cumsum(2 * np.pi * f0 * (1 + 0.08 * np.sin(2 * np.pi * 2.7 * t)) / SR)
        x = sum(np.sin(k * ph) / k for k in range(1, 5))
        env = np.clip(np.sin(2 * np.pi * (0.6 + 0.6 * r.random()) * t + 6 * r.random()), 0, 1)
        out.append((0.2 * x * env + 0.01 * r.standard_normal(t.shape)).astype(np.float32))
    return out


def pairwise_delta(emb: torch.Tensor, exact: torch.Tensor, test: slice, nmr: slice) -> float:
    """max |d| of the degraded x NMR distance matrix against "exact"'s: the
    metric of ``bench.py``'s parity leg."""
    return (cdist(emb[test], emb[nmr]) - cdist(exact[test], exact[nmr])).abs().max().item()


def routes_vs_plain(sd: dict) -> dict:
    """The card's routes of a "default" island (ops/precision.py) at full
    width on the seeded BASE weights, against the plain version on the CPU
    and a float64 sum of the same bf16-rounded operands: fc1 of block 0 on
    4,096 rows and the positional conv on [2, 768, 511]. Each is one bf16
    pass with f32 sums, so the card's and the plain version's distance to
    the float64 sum, relative to its max |y|, is f32 summation order and
    fails beyond ROUTE_TOL; an output rounded to bf16 would be ~1e-3."""
    g = torch.Generator().manual_seed(5)
    w1, b1 = (sd[f"backbone.encoder.layers.0.fc1.{n}"] for n in ("weight", "bias"))
    wc, bc = (sd[f"backbone.encoder.pos_conv.conv.{n}"] for n in ("weight", "bias"))
    x1, xc = torch.randn(4096, 768, generator=g), torch.randn(2, 768, 511, generator=g)
    kw = {"padding": wc.shape[-1] // 2, "groups": 768 // wc.shape[1]}

    def f64(t):
        return prec_ops.round_bf16(t).double()

    cases = {
        "linear_fc1": (lambda dev: prec_ops.linear(x1.to(dev), w1.to(dev), b1.to(dev), "default"),
                       lambda: F.linear(f64(x1), f64(w1), b1.double())),
        "conv1d_posconv": (
            lambda dev: prec_ops.conv1d(xc.to(dev), wc.to(dev), bc.to(dev), "default", **kw),
            lambda: F.conv1d(f64(xc), f64(wc), bc.double(), **kw)),
    }
    res = {}
    for name, (route, oracle) in cases.items():
        exact = oracle()
        scale = exact.abs().max().item()
        card = (route(DEV).cpu().double() - exact).abs().max().item() / scale
        plain = (route(torch.device("cpu")).double() - exact).abs().max().item() / scale
        res[name] = {"card_rel_err": card, "plain_rel_err": plain}
        print(f"precision route {name}: max|y - y_f64| / max|y_f64| card {card:.3g}, plain "
              f"(CPU) {plain:.3g} (<= {ROUTE_TOL})", flush=True)
        if max(card, plain) > ROUTE_TOL:
            fail(f"precision route {name}: card {card:.3g} or plain {plain:.3g} from the float64 "
                 f"sum of the bf16 operands (> {ROUTE_TOL} of max|y|)")
    return res


def modes_vs_plain(sd: dict, waves: list) -> dict:
    """Each mode's embeddings of a few stress files on the card against the
    same mode's plain version on the CPU (the same state dict and
    ``attention_impl``): with the card's kernels ('kernel': K1 or K1b, K5)
    and with the plain attention and LayerNorm on the card ('ref': only
    ops/precision.py's card routes differ from the CPU). "exact" differs by
    f32 summation order and fails beyond 1e-6. In a bf16 mode an operand
    that f32 order moves across a rounding boundary rounds the other way,
    and the next blocks carry that on, so a mode fails beyond
    MODE_PLAIN_FRAC of its own distance to "exact" on the card: what a
    misplaced or missing island would move."""
    wav = torch.from_numpy(np.stack(waves))
    lengths = torch.full((len(waves),), wav.shape[1])
    res, card_emb = {}, {}
    for mode in MODES:
        for impl in ("kernel", "ref"):
            cfg = getattr(Wav2Vec2Config, "base" if mode == "exact" else mode)(attention_impl=impl)
            model = NomadModel(cfg, emb_dim=256)
            model.load_state_dict(sd)
            with torch.inference_mode():
                cpu = model.eval()(wav, lengths)
                card = model.to(DEV)(wav.to(DEV), lengths.to(DEV)).cpu()
            del model
            card_emb[mode, impl] = card
            res[f"{mode}_{impl}"] = {"card_vs_plain": (card - cpu).abs().max().item()}
    for (mode, impl), emb in card_emb.items():
        r = res[f"{mode}_{impl}"]
        r["card_vs_exact"] = (emb - card_emb["exact", impl]).abs().max().item()
        limit = 1e-6 if mode == "exact" else MODE_PLAIN_FRAC * r["card_vs_exact"]
        print(f"precision modes: {mode} ({impl}) on {len(waves)} stress files: card vs plain "
              f"(CPU) max|d emb| {r['card_vs_plain']:.3g} (<= {limit:.3g}); vs exact on the "
              f"card {r['card_vs_exact']:.3g}", flush=True)
        if not r["card_vs_plain"] <= limit:
            fail(f"{mode} ({impl}): card vs plain embeddings {r['card_vs_plain']:.3g} > {limit:.3g}")
    return res


def run_mode(card: str, mode: str, sd: dict, tmp: Path, nmr: str, deg: str,
             stress: list) -> dict:
    """One mode on phase 4's files: ``predict`` with its launch counts,
    three warm predicts, three device passes, the stress set, peak memory
    and one profiled pass. Returns its embeddings and numbers."""
    total_s = (N_NMR + N_DEG) * SECONDS
    leftover_gb = settled_allocated_gb()
    nomad = Nomad(device="cuda", precision=mode, params=sd)
    out = tmp / f"results_{mode}"
    out.mkdir()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    _, dm = nomad.predict("dir", nmr, deg, str(out))
    torch.cuda.synchronize()
    counts = read_launches()
    batches = nomad.engine.batches
    report["launches"][f"scoring_{mode}"] = counts
    blocks = 12 * batches
    want = launches_want(k5=26 * batches, **({"k1": blocks} if mode == "exact" else {"k1b": blocks}))
    if counts != want or batches == 0:
        fail(f"{mode}: launch counts {counts} for {batches} batches (want {want})")
    check_csvs(out, f"{mode} API")
    warm = []
    for _ in range(3):
        t0 = time.perf_counter()
        nomad.predict("dir", nmr, deg, str(out))
        warm.append(time.perf_counter() - t0)
    paths = sorted(Path(nmr).iterdir()) + sorted(Path(deg).iterdir())
    waves = nomad.engine.load_waves([str(p) for p in paths])
    emb, passes = timed_passes(nomad, waves)
    stress_emb = nomad.engine.embed_waves_device(stress)
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    pred_s, pass_s = float(np.median(warm)), float(np.median(passes))
    res = {"files": N_NMR + N_DEG, "batches": batches, "predict_warm_s": warm, "pass_s": passes,
           "wav_s_per_s_predict": total_s / pred_s, "wav_s_per_s_pass": total_s / pass_s,
           "peak_mem_gb": peak_gb, "leftover_mem_gb": leftover_gb,
           "own_peak_mem_gb": peak_gb - leftover_gb, "card": card}
    finite = bool(torch.isfinite(emb).all() and torch.isfinite(stress_emb).all()) and bool(
        np.isfinite(dm.values).all())
    if not finite:
        fail(f"{mode}: non-finite embeddings or scores")
    print(f"{mode}: launches {counts}; warm predict {pred_s:.3f} s = {total_s / pred_s:.1f} "
          f"wav-s/s; device pass {pass_s:.3f} s = {total_s / pass_s:.1f} wav-s/s; own peak "
          f"memory {res['own_peak_mem_gb']:.5f} GB  [{card}]", flush=True)
    profile_run(lambda: nomad.engine.embed_waves_device(waves), f"profile_{mode}")
    res["scores"] = dm.values
    del nomad
    return res | {"emb": emb, "stress_emb": stress_emb}


def serve_in_mode(tmp: Path, nmr: str, deg: str, mode: str) -> dict:
    """One ``python -m nomad_tpu_torch.serve --precision <mode>`` process
    (the seeded init, as in this phase) sent ping, score, stats and
    shutdown: every stdout line JSON, every answer ok, exit 0, ``stats``
    naming the mode."""
    reqs = [{"op": "ping"}, {"op": "score", "nmr": nmr, "deg": deg, "results_path": None},
            {"op": "stats"}, {"op": "shutdown"}]
    cwd = tmp / f"serve_{mode}"
    cwd.mkdir()
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "nomad_tpu_torch.serve", "--precision", mode],
        input="\n".join(json.dumps(r) for r in reqs) + "\n", capture_output=True, text=True,
        timeout=SERVE_TIMEOUT_S, cwd=cwd, env=dict(os.environ, PYTHONPATH=str(ROOT)))
    wall = time.perf_counter() - t0
    try:
        resps = [json.loads(line) for line in proc.stdout.splitlines() if line.strip()]
    except json.JSONDecodeError:
        fail(f"serve --precision {mode}: a stdout line is not JSON:\n{proc.stdout[:2000]}")
    if proc.returncode != 0 or [r.get("ok") for r in resps] != [True] * len(reqs) \
            or resps[2].get("precision") != mode:
        fail(f"serve --precision {mode}: exit {proc.returncode}, answers "
             f"{[str(r)[:200] for r in resps]}; stderr:\n{proc.stderr[-3000:]}")
    print(f"serve --precision {mode}: {len(resps)} JSON answers, stats precision "
          f"{resps[2]['precision']!r}, exit 0, {wall:.1f} s", flush=True)
    return {"wall_s": wall, "scores": np.array([[r[c] for c in r if c != "Test File"]
                                                for r in resps[1]["pairwise"]])}


def run_precision(card: str) -> None:
    """Phase 9: K1b against its plain version at its shapes, then scoring
    in the three modes on one set of seeded BASE weights, then the
    service in "balanced"."""
    report.setdefault("launches", {})
    t_phase = time.perf_counter()
    print("precision modes: K1b vs its plain version on the card:", flush=True)
    check_flash_bf16_shapes()
    out: dict = {"card": card}
    with tempfile.TemporaryDirectory(prefix="nomad_modes_") as tmp:
        tmp = Path(tmp)
        nmr, deg = write_wavs(tmp)
        stress = speechish(STRESS_DEG, 1) + speechish(STRESS_NMR, 2)
        weights = init_weights(NomadModel(Wav2Vec2Config.base(), emb_dim=256), seed=0)
        sd = weights.state_dict()  # Nomad's own seeded init, once for the three modes
        SHARED["sd"] = sd
        del weights
        out["routes_vs_plain"] = routes_vs_plain(sd)
        res = {mode: run_mode(card, mode, sd, tmp, nmr, deg, stress) for mode in MODES}
        exact = res["exact"]
        for mode in MODES:
            r = res[mode]
            # phase 4's files are NMR first; the stress set degraded first
            r["pairwise_delta"] = pairwise_delta(r["emb"], exact["emb"], slice(N_NMR, None),
                                                 slice(0, N_NMR))
            r["stress_pairwise_delta"] = pairwise_delta(
                r["stress_emb"], exact["stress_emb"], slice(0, STRESS_DEG),
                slice(STRESS_DEG, None))
            r["in_budget"] = max(r["pairwise_delta"], r["stress_pairwise_delta"]) <= DELTA_BUDGET
        out["modes_vs_plain"] = modes_vs_plain(sd, stress[:MODES_VS_PLAIN_FILES])
        served = serve_in_mode(tmp, nmr, deg, "balanced")
        d_served = float(np.abs(served["scores"] - res["balanced"]["scores"]).max())
        out["serve_balanced"] = {"wall_s": served["wall_s"], "vs_in_process_max_abs": d_served}
    for mode in MODES:
        r = res[mode]
        out[mode] = {k: v for k, v in r.items() if k not in ("emb", "stress_emb", "scores")}
        print(f"{mode}: pairwise delta vs exact {r['pairwise_delta']:.3g} (108 files), "
              f"{r['stress_pairwise_delta']:.3g} (stress set); in budget (<= {DELTA_BUDGET}): "
              f"{r['in_budget']}; {r['wav_s_per_s_pass']:.1f} wav-s/s device pass, "
              f"{r['wav_s_per_s_predict']:.1f} warm predict; own peak "
              f"{r['own_peak_mem_gb']:.5f} GB  [{card}]", flush=True)
    out["phase_s"] = time.perf_counter() - t_phase
    report["precision_modes"] = out
    print(f"precision modes: served balanced scores vs in process max|d| {d_served:.3g}; "
          f"phase 9 took {out['phase_s']:.1f} s", flush=True)
    worst = max(max(res[m]["pairwise_delta"], res[m]["stress_pairwise_delta"]) for m in MODES)
    if worst > DELTA_FAULT:
        fail(f"a mode's pairwise delta vs exact {worst:.3g} > {DELTA_FAULT}")
    if d_served > 1e-3:  # one step of the CSVs' 3-decimal rounding
        fail(f"serve --precision balanced: scores {d_served:.3g} from the in-process ones")
    for mode in ("balanced", "fast"):
        over = res[mode]["own_peak_mem_gb"] - exact["own_peak_mem_gb"]
        if over > MODE_PEAK_SLACK_GB:
            fail(f"{mode}: own peak memory {over:.3f} GB over exact's (> {MODE_PEAK_SLACK_GB})")


# ---------------- phase 10: gradients in the precision modes ----------------


def attention_bwd_f64(q, k, v, do, lengths):
    """The exact gradient (dQ, dK, dV) of masked attention for the
    cotangent dO in float64, the oracle of K2b/K3b and of their plain
    version: keys past each bound take no part and get dK = dV = 0, a row
    with no key gets zero gradients."""
    t, d = q.shape[1], q.shape[3]
    valid = torch.arange(t, device=q.device)[None, :] < lengths.long()[:, None]
    vk = valid[:, :, None, None]
    qd, dod = q.double(), do.double()
    kd, vd = (torch.where(vk, x, 0.0).double() for x in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", qd, kd) / d**0.5
    p = torch.softmax(s.masked_fill(~valid[:, None, None, :], float("-inf")), dim=-1)
    p = p.nan_to_num(0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", dod, vd)
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kd) / d**0.5
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qd) / d**0.5
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dod)
    return dq, torch.where(vk, dk, 0.0), torch.where(vk, dv, 0.0)


def grad_routes_vs_plain(sd: dict) -> dict:
    """The backward of a "default" island's card routes (ops/precision.py)
    at full width on the seeded BASE weights, against the plain version on
    the CPU and float64 sums of the bf16-rounded cotangent and operands
    (JAX's DEFAULT transposes): fc1 of block 0 on 4,096 rows (dX, dW, db),
    the positional conv on [2, 768, 511] and one attention-shaped product
    [2, 12, 511, 64] . [2, 12, 64, 511] (cuBLAS ``bmm.dtype``). Each
    gradient, relative to its max, fails beyond ROUTE_TOL: f32 summation
    order; a cotangent left unrounded would be ~1e-3."""
    g = torch.Generator().manual_seed(6)
    w1, b1 = (sd[f"backbone.encoder.layers.0.fc1.{n}"] for n in ("weight", "bias"))
    wc, bc = (sd[f"backbone.encoder.pos_conv.conv.{n}"] for n in ("weight", "bias"))
    kw = {"padding": wc.shape[-1] // 2, "groups": 768 // wc.shape[1]}
    ins = {"linear_fc1": (torch.randn(4096, 768, generator=g), w1, b1),
           "conv1d_posconv": (torch.randn(2, 768, 511, generator=g), wc, bc),
           "matmul_attention": (torch.randn(2, 12, 511, 64, generator=g),
                                torch.randn(2, 12, 64, 511, generator=g))}
    fns = {"linear_fc1": lambda x, w, b: prec_ops.linear(x, w, b, "default"),
           "conv1d_posconv": lambda x, w, b: prec_ops.conv1d(x, w, b, "default", **kw),
           "matmul_attention": prec_ops.matmul_bf16}

    def r64(t):
        return prec_ops.round_bf16(t.to(DEV)).double()

    def oracle(name, dy, x, w, b=None):
        dyr = r64(dy)
        if name == "linear_fc1":
            return dyr @ r64(w), dyr.t() @ r64(x), dy.to(DEV).double().sum(0)
        if name == "conv1d_posconv":
            return (torch.nn.grad.conv1d_input(x.shape, r64(w), dyr, **kw),
                    torch.nn.grad.conv1d_weight(r64(x), w.shape, dyr, **kw),
                    dy.to(DEV).double().sum((0, 2)))
        return dyr @ r64(w).transpose(-1, -2), r64(x).transpose(-1, -2) @ dyr

    res = {}
    for name, args in ins.items():
        dy = torch.randn(fns[name](*args).shape, generator=g)
        exact = oracle(name, dy, *args)
        errs = {}
        for dev in ("card", "plain"):
            xs = [t.to(DEV if dev == "card" else "cpu").clone().requires_grad_() for t in args]
            fns[name](*xs).backward(dy.to(xs[0].device))
            errs[dev] = max((x.grad.to(DEV).double() - e).abs().max().item()
                            / e.abs().max().item() for x, e in zip(xs, exact))
        res[name] = {"card_rel_err": errs["card"], "plain_rel_err": errs["plain"]}
        print(f"precision route {name} backward: max|g - g_f64| / max|g_f64| card "
              f"{errs['card']:.3g}, plain (CPU) {errs['plain']:.3g} (<= {ROUTE_TOL})", flush=True)
        if max(errs.values()) > ROUTE_TOL:
            fail(f"precision route {name} backward: card {errs['card']:.3g} or plain "
                 f"{errs['plain']:.3g} from the float64 transposes (> {ROUTE_TOL} of max|g|)")
    return res


def fold_plain(q, k, v, do, lse, di, lengths) -> tuple:
    """The plain version of K2b/K3b's prologue: q, k, v and dO folded by
    ``fold_bf16_ref`` (k and v zero past each bound), LSE and Di padded
    with zeros to [2, B*H, T64]."""
    fold = torch.stack([flash_attention.fold_bf16_ref(x, lengths, n in (1, 2))
                        for n, x in enumerate((q, k, v, do))])
    b, h, t = lse.shape
    ld = torch.zeros((2, b * h, fold.shape[2]), dtype=torch.float32, device=lse.device)
    ld[0, :, :t] = lse.reshape(b * h, t)
    ld[1, :, :t] = di.reshape(b * h, t)
    return fold, ld


def fold_bound(b: int, t: int, h: int, d: int, lengths: torch.Tensor, io_bytes: int) -> tuple:
    """The prologue's bytes: q and dO, the valid rows of k and v, LSE and Di
    read once; the fold and the padded LSE and Di written once."""
    t_pad = -(-t // 64) * 64
    keys = int(lengths.long().clamp(0, t).sum())
    reads = io_bytes * h * d * (2 * b * t + 2 * keys) + 2 * 4 * b * h * t
    writes = 2 * 4 * b * h * t_pad * d + 2 * 4 * b * h * t_pad
    return bound(reads + writes, 0.0)


def check_fold(q, k, v, do, lse, di, lengths, timed: bool) -> dict:
    """K2b/K3b's prologue through its wrapper against ``fold_plain`` on the
    card, bit for bit (the fold and the padded LSE and Di), and, with
    ``timed``, its time beside its plain version's and its bound."""
    b, t, h, d = q.shape
    ws = flash_attention._bwd_bf16_fold(q, k, v, do, lse, di, lengths)
    ref = fold_plain(q, k, v, do, lse, di, lengths)
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(ws, ref)):
        fail(f"flash bwd prologue [{b}, {t}, {h}, {d}] ({q.dtype}): its fold differs from "
             f"fold_bf16_ref's or its LSE/Di from the padded ones")
    bound_ms, bound_by = fold_bound(b, t, h, d, lengths, q.element_size())
    res = {"max_abs_err": 0.0, "bit_equal": True, "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": None}
    if timed:
        iters = 10 if t > 1024 else 30
        res["ms"] = time_ms(lambda: flash_attention._bwd_bf16_fold(q, k, v, do, lse, di,
                                                                   lengths, ws), iters)
        res["plain_ms"] = time_ms(lambda: fold_plain(q, k, v, do, lse, di, lengths), 5)
    return res


def check_flash_bwd_bf16(b: int, t: int, lengths: list, g: torch.Generator, timed: bool,
                         kernel_times: bool = True) -> dict:
    """K2b and K3b, through ``flash_attention_bwd``, against
    flash_attention_bwd_ref(..., "default") on the card, from K1b's O and
    LSE, NaN in k and v past each bound: every output finite; dK = dV = 0
    past each bound and every gradient 0 for a row with no key; dQ, dK and
    dV each within BWD_BF16_PLAIN_REL of the plain version's max |g| and
    BWD_BF16_PLAIN_NORM of its norm from it, no further from the exact float64 gradient than 1.5 x the plain
    version's distance + 1e-6, and no nearer than half of it (they do
    round: bf16 operands everywhere, f32 sums in another order); a rerun
    the same bits; their prologue's fold bit-equal to its plain version.
    The three kernels launched one at a time (as the smoke times them) give
    the bits of ``flash_attention_bwd``'s one C call. ``kernel_times``:
    time the prologue, K2b and K3b each alone, each against what it moves
    (K2b and K3b read the bf16 fold); ``timed``: the plain version, and
    the pair through ``flash_attention_bwd`` (prologue and Di included),
    against the work's bound (the two kernels' bounds on the f32 inputs),
    in turns with SDPA's gradient on bf16 copies of q, k, v and dO, the
    four casts inside its timed call (the yardstick)."""
    h, d = 12, 64
    qkv = torch.randn(b, t, 3, h, d, generator=g).to(DEV)
    q, k, v = qkv.unbind(2)
    for i, n in enumerate(lengths):
        k[i, n:] = float("nan")
        v[i, n:] = float("nan")
    lens = torch.tensor(lengths, dtype=torch.int32, device=DEV)
    o, lse = flash_attention.mha_flash(q, k, v, lens, "default")
    do = torch.randn(b, t, h, d, generator=g).to(DEV)
    do_, di, lens_ = flash_attention._bwd_args(q, k, v, o, lse, do, lens)

    def kernels():
        return flash_attention.flash_attention_bwd(q, k, v, o, lse, do, lens, "default")

    outs = kernels()
    torch.cuda.synchronize()
    names = ("dq", "dk", "dv")
    err, err_f64, plain_f64, gmax, sq_err, sq_ref = ({n: 0.0 for n in names} for _ in range(6))
    for i in range(b):  # one batch row at a time: [1, H, T, T] in float64
        sl = slice(i, i + 1)
        ref = flash_attention.flash_attention_bwd_ref(q[sl], k[sl], v[sl], o[sl], lse[sl],
                                                      do[sl], lens[sl], "default")
        exact = attention_bwd_f64(q[sl], k[sl], v[sl], do[sl], lens[sl])
        for n, ours, r, x in zip(names, outs, ref, exact):
            err[n] = max(err[n], (ours[sl] - r).abs().nan_to_num(nan=float("inf")).max().item())
            err_f64[n] = max(err_f64[n], (ours[sl].double() - x).abs().nan_to_num(
                nan=float("inf")).max().item())
            plain_f64[n] = max(plain_f64[n], (r.double() - x).abs().max().item())
            gmax[n] = max(gmax[n], r.abs().max().item())
            sq_err[n] += (ours[sl] - r).nan_to_num(nan=float("inf")).square().sum().item()
            sq_ref[n] += r.square().sum().item()
        del ref, exact
    dq, dk, dv = outs
    finite = all(bool(torch.isfinite(x).all()) for x in outs)
    zero_past = all(bool((dk[i, n:] == 0).all() and (dv[i, n:] == 0).all())
                    for i, n in enumerate(lengths))
    zero_rows = all(bool((dq[i] == 0).all()) for i, n in enumerate(lengths) if n == 0)
    same_bits = all(torch.equal(x, y) for x, y in zip(outs, kernels()))
    ws = flash_attention._bwd_bf16_fold(q, k, v, do_, lse, di, lens_)
    alone = (*flash_attention._bwd_bf16_kernel("dq", q, ws, lens_),
             *flash_attention._bwd_bf16_kernel("dkv", q, ws, lens_))
    same_bits = same_bits and all(torch.equal(x, y) for x, y in zip(outs, alone))
    del alone
    excess = max(err_f64[n] - (1.5 * plain_f64[n] + 1e-6) for n in names)
    rounds = all(err_f64[n] >= 0.5 * plain_f64[n] for n in names)
    err_rel = {n: err[n] / max(gmax[n], 1e-30) for n in names}
    err_norm = {n: (sq_err[n] / max(sq_ref[n], 1e-60)) ** 0.5 for n in names}
    if (not (finite and zero_past and zero_rows and same_bits and rounds) or excess > 0
            or max(err_rel.values()) > BWD_BF16_PLAIN_REL
            or max(err_norm.values()) > BWD_BF16_PLAIN_NORM):
        fail(f"flash bwd bf16 [{b}, {t}, {h}, {d}] lengths {lengths}: finite={finite} zero past "
             f"bound={zero_past} zero rows={zero_rows} rerun same bits={same_bits}; vs plain "
             f"(and the kernels alone) max|d|/max|g| {err_rel} (<= {BWD_BF16_PLAIN_REL}), "
             f"||d||/||g|| {err_norm} "
             f"(<= {BWD_BF16_PLAIN_NORM}); max|g - g_f64| {err_f64} "
             f"beyond 1.5 x the plain version's {plain_f64} + 1e-6 by {excess:.3g}, or under "
             f"half of it")
    bounds = flash_bwd_bounds(b, t, h, d, lens, BF16_FLOPS, io_bytes=2, out_bytes=4)
    work = flash_bwd_bounds(b, t, h, d, lens, BF16_FLOPS)
    res = {"shape": [b, t, h, d], "lengths": lengths, "lengths_sum": int(lens.sum()),
           "fold": check_fold(q, k, v, do_, lse, di, lens_, kernel_times)}
    for key, parts in (("dq", ("dq",)), ("dkv", ("dk", "dv"))):
        res[key] = {"max_abs_err": max(err[n] for n in parts),
                    "max_rel_err": max(err_rel[n] for n in parts),
                    "norm_rel_err": max(err_norm[n] for n in parts),
                    "max_abs_err_vs_f64": {n: err_f64[n] for n in parts},
                    "plain_max_abs_err_vs_f64": {n: plain_f64[n] for n in parts},
                    "bound_ms": bounds[key][0], "bound_by": bounds[key][1]}
        if kernel_times:
            res[key]["ms"] = time_ms(lambda key=key: flash_attention._bwd_bf16_kernel(
                key, q, ws, lens_), 10 if t > 1024 else 30)
    if timed:
        # one plain call and one library call compute K2b and K3b's outputs
        # together: both times stand on both rows, the pair's beside them
        plain = time_ms(lambda: flash_attention.flash_attention_bwd_ref(
            q, k, v, o, lse, do, lens, "default"), 5)
        qb, kb, vb = (x.detach().nan_to_num(0.0).transpose(1, 2).to(torch.bfloat16)
                      .contiguous().requires_grad_() for x in (q, k, v))
        mask = None
        if int(lens.min()) < t:
            mask = (torch.arange(t, device=DEV)[None, :] < lens[:, None])[:, None, None, :]
        out = F.scaled_dot_product_attention(qb, kb, vb, attn_mask=mask)

        def library():  # the kernels round q, k, v and dO themselves: so does the yardstick
            for x in (q, k, v):
                x.transpose(1, 2).to(torch.bfloat16)
            return torch.autograd.grad(out, (qb, kb, vb), do.transpose(1, 2).to(torch.bfloat16),
                                       retain_graph=True)

        pair, lib = time_pair_ms(kernels, library, 3 if t > 1024 else 5, rounds=10)
        for key in ("dq", "dkv"):
            res[key] |= {"plain_ms": plain, "library_ms": lib, "pair_ms": pair,
                         "pair_bound_ms": work["dq"][0] + work["dkv"][0]}
    print(f"  flash bwd bf16 [{b}, {t}, {h}, {d}] lengths {lengths[:4]}...: vs plain max|d| "
          f"K2b {err['dq']:.3g}, K3b {max(err['dk'], err['dv']):.3g} (/max|g| "
          + ", ".join(f"{n} {err_rel[n]:.3g}" for n in names) + "; ||d||/||g|| "
          + ", ".join(f"{n} {err_norm[n]:.3g}" for n in names) + "); vs f64 "
          + ", ".join(f"{n} {err_f64[n]:.3g} (plain {plain_f64[n]:.3g})" for n in names)
          + (f"; K2b {res['dq']['ms']:.4f} ms (bound {bounds['dq'][0]:.4f}), K3b "
             f"{res['dkv']['ms']:.4f} ms (bound {bounds['dkv'][0]:.4f})" if kernel_times else "")
          + (f", prologue {res['fold']['ms']:.4f} ms (bound {res['fold']['bound_ms']:.4f})"
             if kernel_times else "")
          + (f"; in turns: the pair through flash_attention_bwd {res['dq']['pair_ms']:.4f} ms "
             f"(the work's bound {res['dq']['pair_bound_ms']:.4f}), "
             f"sdpa bf16 grad with its casts {res['dq']['library_ms']:.4f} ms; plain pair "
             f"{res['dq']['plain_ms']:.4f} ms" if timed else ""), flush=True)
    return res


def check_flash_bwd_bf16_shapes() -> None:
    """K2b and K3b with their prologue at the paths' shapes, each with a
    full, a ragged, a 1-key and a 0-key row: the loss crop [32, 50], 10 s
    clips [24, 499], the triplet batch's bucket [24, 511] (499 valid
    frames), a ragged [8, 4095]; untimed at every edge of the 16-row warp
    tiles, 64-row blocks and 64-row streamed tiles, and of the 3-stage
    ring."""
    g = torch.Generator().manual_seed(10)

    def rows(b, t, n=None):
        return [t, t // 2, 1, 0] + [n or t] * (b - 4)

    res = {"main": check_flash_bwd_bf16(LOSS_BATCH, 50, rows(LOSS_BATCH, 50), g, timed=True),
           "train": check_flash_bwd_bf16(LOSS10_BATCH, 499, rows(LOSS10_BATCH, 499), g,
                                         timed=True),
           "bucket": check_flash_bwd_bf16(LOSS10_BATCH, 511, rows(LOSS10_BATCH, 511, 499), g,
                                          timed=False),
           "long": check_flash_bwd_bf16(8, 4095, [4095, 4000, 3001, 2048, 1025, 64, 1, 0], g,
                                        timed=True)}
    # the warp tiles' and blocks' edges, then the ring's (3 stages): 3, 4
    # and 5 tiles, each with a ragged last tile
    for t in (1, 15, 16, 17, 63, 64, 65, 511, 129, 193, 257):
        res[f"edge_T{t}"] = check_flash_bwd_bf16(4, t, [t, max(t // 2, 1), 1, 0], g,
                                                 timed=False, kernel_times=False)
    for key, name in (("dq", "flash_attention_bwd_dq_bf16"),
                      ("dkv", "flash_attention_bwd_dkv_bf16"),
                      ("fold", "flash_attention_bwd_fold_bf16")):
        report["kernels"][name] = {shape: r[key] | {"shape": r["shape"]}
                                   for shape, r in res.items()}


def triplet_probe(cfg: dict, batch, init: dict, model_config, direction,
                  active=None) -> dict:
    """One deterministic forward over [A; P; N] on a Training from ``init``
    (no optimizer step): the embeddings, the margin loss, the hinge
    pattern (d(a, p) - d(a, n) + margin > 0 per triplet; ``active``, else
    its own) and two sets of parameter gradients: of the margin loss taken
    under that pattern ("margin") and of <embeddings, direction>
    ("probe"). The margin loss's gradient is the difference of those of
    d(a, p) and d(a, n), nearly equal at seeded weights; the smooth probe
    drives the same backward without that cancellation."""
    tr = Training(dict(cfg, remat=False), device="cuda", params=init, model_config=model_config)
    wav, lengths = tr._device_batch(batch)
    emb = tr.model(wav, lengths if tr.masked_pool else None, deterministic=True)
    b = len(batch.lengths_a)
    a, p, n = emb[:b], emb[b:2 * b], emb[2 * b:]
    loss = triplet_margin_loss(a, p, n, tr.margin).item()
    gap = pairwise_distance(a, p) - pairwise_distance(a, n)
    if active is None:
        active = gap + tr.margin > 0
    names, params = zip(*((n_, p_) for n_, p_ in tr.model.named_parameters()
                          if p_.requires_grad))
    margin = torch.autograd.grad((active * gap).sum() / b, params, retain_graph=True,
                                 allow_unused=True)
    probe = torch.autograd.grad((emb * direction).sum(), params, allow_unused=True)
    res = {"emb": emb.detach(), "loss": loss, "active": active,
           **{key: {n_: g_ for n_, g_ in zip(names, grads) if g_ is not None}
              for key, grads in (("margin", margin), ("probe", probe))}}
    release(tr)
    return res


def grads_rel(grads: dict, ref: dict, zero_grad: bool = False) -> tuple[float, str]:
    """max |d| / max |g| over the parameters whose gradient is 0
    analytically (``zero_grad``), or over the others, both relative to the
    others' max |g|; and the parameter where the max |d| lies."""
    names = [n for n in ref if n.endswith(ZERO_GRAD_PARAMS) == zero_grad]
    gmax = max(g.abs().max().item() for n, g in ref.items()
               if not n.endswith(ZERO_GRAD_PARAMS))
    worst = max(names, key=lambda n: (grads[n] - ref[n]).abs().max().item())
    return (grads[worst] - ref[worst]).abs().max().item() / gmax, worst


def probe_distance(x: dict, ref: dict) -> dict:
    """Two ``triplet_probe`` results apart: embeddings relative to the
    reference's max, both gradient sets relative to their max (with the
    parameter where the gap lies), the analytically-zero k_proj biases
    apart, and the margin loss."""
    out = {"emb_rel_to_max": (x["emb"] - ref["emb"]).abs().max().item()
           / ref["emb"].abs().max().item(), "loss_abs": abs(x["loss"] - ref["loss"])}
    for key in ("probe", "margin"):
        out[f"{key}_grad_rel_to_max"], out[f"{key}_grad_worst_param"] = grads_rel(
            x[key], ref[key])
    out["zero_grad_params_rel_to_max"] = grads_rel(x["probe"], ref["probe"], True)[0]
    return out


MODE_STEP_LAUNCHES = {"train_step": launches_want(k5=50),
                      "eval_step": launches_want(k1b=12, k5=26),
                      "train_step_rates0": launches_want(k1b=24, k2b=12, k3b=12, k5=50)}


def mode_train_steps(card: str, mode: str, cfg: dict, batch, init: dict,
                     want: dict = MODE_STEP_LAUNCHES) -> dict:
    """The triplet recipe in ``mode`` (``precision:`` in the config, remat
    on, dropout 0.1): the recipe's step (the plain dropout attention at
    bf16, K5 only) and its eval step (K1b); the dropout rates at 0 (K1b +
    K2b + K3b), each with the launch counts ``want`` gives (a bf16 block
    stack launches the bf16-I/O flavours); then, from ``init`` with the
    rates at 0, ``triplet_probe``
    on the kernel path (K), whose attention backward calls are held to
    their plain version on the same inputs, against the same mode's plain
    path (P): the embeddings and both gradient sets within GRAD_MODE_FRAC
    times P's distance to the "exact" plain path (EP), the margin loss
    within what the embeddings' distance allows (each triplet's
    d(a, p) - d(a, n) moves at most 4 max_i ||d emb_i||). Reported beside
    them: K against the "exact" kernel path (E), and the path with K2b and
    K3b alone swapped for their plain version (KP) against K and P."""
    out: dict = {}
    tr, loss, before, grads = first_train_step(
        f"train_step_{mode}", dict(cfg, precision=mode), batch, want["train_step"], init)
    out["loss"] = loss
    want_cfg = mode_config(mode, frontend_stop_gradient=True, remat=True)
    if tr.model_config != want_cfg:
        fail(f"trainer {mode}: precision resolved to {tr.model_config}, want {want_cfg}")
    out["frozen_moved"] = check_frozen_and_moved(tr, before, grads)
    del before, grads
    out["train_step"] = time_train_steps(card, f"train_step {mode} (dropout, remat)", tr, batch)
    with profiler_range(wav2vec2, "mha_dropout", PLAIN_ATTENTION):
        profile_run(lambda: tr.train_step(batch, step_gen()), f"profile_train_step_{mode}",
                    split=ranged_kernels(PLAIN_ATTENTION, "plain attention (products, "
                                         "softmax, dropout; fwd + bwd)"))
    reset_launches()
    tr.eval_step(batch)
    counts = read_launches()
    report["launches"][f"eval_step_{mode}"] = counts
    if counts != want["eval_step"]:
        fail(f"trainer {mode}: eval step launch counts {counts} (want {want['eval_step']})")
    out["eval_step"] = time_steps(lambda: tr.eval_step(batch), TRAIN_STEPS, card,
                                  f"trainer: eval_step {mode}")
    out["eval_step_ms"] = out["eval_step"]["events_median_ms"]
    release(tr)

    tr, _, _, _ = first_train_step(
        f"train_step_rates0_{mode}", cfg, batch, want["train_step_rates0"], init,
        mode_config(mode, **ZERO_RATES))
    out["train_step_rates0"] = time_train_steps(card, f"train_step {mode} (rates at 0, remat)",
                                                tr, batch)
    profile_run(lambda: tr.train_step(batch, step_gen()), f"profile_train_step_rates0_{mode}")
    emb_dim = tr.emb_dim
    release(tr)
    out["rates0_kernel_vs_plain"] = rates0_vs_plain(mode, cfg, batch, init, emb_dim)
    print(f"trainer {mode}: recipe step loss {loss:.8g}; eval step {out['eval_step_ms']:.2f} ms"
          f"  [{card}]", flush=True)
    return out


def rates0_vs_plain(mode: str, cfg: dict, batch, init: dict, emb_dim: int, **kw) -> dict:
    """``mode_train_steps``' comparison of the kernel path with the plain
    path at the rates at 0, from ``init``; ``kw`` (a bf16 ``mode``) goes
    into both paths' configs."""
    g = torch.Generator().manual_seed(TRAIN_SEED)
    direction = torch.randn(3 * len(batch.lengths_a), emb_dim, generator=g).to(DEV)

    def probe(config, active=None):
        return triplet_probe(cfg, batch, init, config, direction, active)

    what = f"trainer {mode}"
    with recorded_flash_bwd() as calls:
        k = probe(mode_config(mode, **ZERO_RATES, **kw))
    calls_vs_plain = check_recorded_flash_bwd(calls, f"{what}, rates at 0")
    del calls
    active = k["active"]
    with plain_flash(mode):
        p = probe(plain_config(mode, **ZERO_RATES, **kw), active)
    with plain_flash(mode, forward=False):
        kp = probe(mode_config(mode, **ZERO_RATES, **kw), active)
    ep = probe(plain_config(**ZERO_RATES), active)
    e = probe(mode_config(**ZERO_RATES), active)
    d, d_plain = probe_distance(k, p), probe_distance(p, ep)
    keys = ("emb_rel_to_max", "probe_grad_rel_to_max", "margin_grad_rel_to_max")
    tol = {key: TOL_GRAD_REL + GRAD_MODE_FRAC * d_plain[key] for key in keys}
    tol["loss_abs"] = 4 * (k["emb"] - p["emb"]).norm(dim=-1).max().item() + 1e-6
    res = {"loss": k["loss"], "plain_loss": p["loss"], "active_triplets": int(active.sum()),
           "vs_plain": d, "plain_vs_exact_plain": d_plain,
           "vs_exact_kernel": probe_distance(k, e),
           "k2b_k3b_swapped_vs_kernel": probe_distance(kp, k),
           "k2b_k3b_swapped_vs_plain": probe_distance(kp, p),
           "attention_bwd_calls_vs_plain": calls_vs_plain, "tolerance": tol}
    print(f"{what}: rates at 0, kernel path vs the {mode} plain path {d} (tolerance {tol}); "
          f"the {mode} plain path vs the exact plain path {d_plain}; kernel path vs exact "
          f"{res['vs_exact_kernel']}; K2b/K3b swapped for plain vs kernel path "
          f"{res['k2b_k3b_swapped_vs_kernel']}, vs plain path {res['k2b_k3b_swapped_vs_plain']}",
          flush=True)
    if k["probe"].keys() != p["probe"].keys() or any(d[key] > tol[key] for key in tol):
        fail(f"{what}: rates-at-0 kernel path vs plain path {d} beyond {tol}")
    return res


def mode_se_step(card: str, tmp: Path, sd: dict) -> dict:
    """One SE train step at the recipe with the lossnet at "balanced" (the
    JAX SE's own default): K1b 24, K2b 12, K3b 12, K5 52; a finite loss,
    every U-Net tensor but the pre-batch-norm biases moved, the lossnet
    unchanged; warm step time."""
    cfg = write_se_tree(tmp, counts=(32, 1, 1))
    nomad = Nomad(device="cuda", precision="balanced", params=sd)
    se = SpeechEnhancement(cfg, device="cuda", nomad=nomad)
    noisy, clean = next(se.train_set.batches(int(cfg["train_bs"]), shuffle=False))
    init = {k: v.clone() for k, v in se.unet.state_dict().items()}
    lossnet = {k: v.clone() for k, v in nomad.model.state_dict().items()}
    loss, _, _, counts = se_first_step(se, init, noisy, clean,
                                       launches_want(k1b=24, k2b=12, k3b=12, k5=52))
    report["launches"]["se_train_step_balanced"] = counts
    unmoved = [n for n, v in se.unet.state_dict().items()
               if torch.equal(v, init[n]) and not n.endswith(SE_PRE_BN_BIAS)]
    changed = [k for k, v in nomad.model.state_dict().items() if not torch.equal(v, lossnet[k])]
    if unmoved or changed:
        fail(f"SE balanced: U-Net tensors unmoved {unmoved}, lossnet tensors changed {changed[:5]}")
    out = {"loss": loss, "train_step": time_steps(lambda: se.train_step(noisy, clean), 3, card,
                                                  "SE: train step, lossnet balanced")}
    print(f"SE balanced: first-step loss {loss:.8g}, launches {counts}", flush=True)
    del se, nomad
    torch.cuda.empty_cache()
    return out


def run_grad_modes(card: str) -> None:
    """Phase 10: K2b and K3b against their plain version and float64, then
    the loss with its gradient in "balanced" and "fast" at the SE crop and
    on 10 s clips, the triplet recipe in both modes, and one SE step with
    a "balanced" lossnet, all on one seeded BASE state dict."""
    report.setdefault("launches", {})
    t_phase = time.perf_counter()
    print("gradient modes: K2b and K3b vs their plain version on the card:", flush=True)
    check_flash_bwd_bf16_shapes()
    sd = init_weights(NomadModel(Wav2Vec2Config.base(), emb_dim=256), seed=0).state_dict()
    SHARED["sd10"] = sd
    report["grad_routes"] = grad_routes_vs_plain(sd)
    want = launches_want(k1b=24, k2b=12, k3b=12, k5=52)
    for mode in ("balanced", "fast"):
        run_loss_path(card, f"loss_path_{mode}", mode_config(mode), want, LOSS_BATCH,
                      LOSS_SAMPLES, mode, sd)
        run_loss_path(card, f"loss_path_10s_{mode}", mode_config(mode), want, LOSS10_BATCH,
                      LOSS10_SAMPLES, mode, sd, attribute=True)
    out: dict = {"card": card}
    with tempfile.TemporaryDirectory(prefix="nomad_grad_modes_") as tmp:
        tmp = Path(tmp)
        (tmp / "train").mkdir()
        cfg = write_train_tree(tmp / "train")
        ds = train_data.TripletDataset(cfg, "train_df", level=cfg["current_level"])
        batch = train_data._pinned(train_data.collate_triplets(
            [ds.load_item(i) for i in range(cfg["train_bs"])]))
        for mode in ("fast", "balanced"):
            out[mode] = mode_train_steps(card, mode, cfg, batch, sd)
        (tmp / "se").mkdir()
        out["se_balanced"] = mode_se_step(card, tmp / "se", sd)
    out["phase_s"] = time.perf_counter() - t_phase
    report["grad_modes"] = out
    print(f"gradient modes: phase 10 took {out['phase_s']:.1f} s", flush=True)


# ---------------- phase 12: the fused path in the modes ----------------


def fused_f64(x, params, lengths, heads: int = 12) -> torch.Tensor:
    """K4b's oracle: the projections in float64 of the bf16-rounded x and
    weights plus the biases, then exact masked attention in float64
    (``attention_f64``); head-major [B, H, T, 64] like the kernel's O."""
    b, t, dm = x.shape
    xd = prec_ops.round_bf16(x).double()
    q, k, v = (F.linear(xd, prec_ops.round_bf16(w).double(), bias.double()).view(b, t, heads, -1)
               for w, bias in zip(params[0::2], params[1::2]))
    return attention_f64(q, k, v, lengths).transpose(1, 2)


def check_fused_bf16(b: int, t: int, lengths: list, g: torch.Generator, timed: bool,
                     kernel_time: bool = True) -> dict:
    """K4b against fused_qkv_attention_ref(..., "default") on the card, x at
    unit scale and zero past each bound, the weights at the seeded init's
    scale: every row finite; O no further from float64 attention of the
    bf16-rounded operands (``fused_f64``) than 1.5 x the plain version's
    distance + 1e-6, and no nearer than half of it (it does round); a
    0-key row O = 0; against K1b fed by the port's "default" projections
    of the same x no further than FUSED_BF16_VS_K1B times the two plain
    versions' own distance + 1e-6; NaN past each bound the same bits in
    every valid row (a padded query row takes its Q from x, as the TPU
    kernel's does), 123.0 there every row finite and the valid rows the
    same bits; a rerun the same bits; the prologue's packed weights and
    rounded x bit-equal to ``pack_weights_ref`` and ``x.to(bf16)``.
    ``timed``: the plain version and the yardstick, ``F.linear`` + SDPA on
    bf16 with x rounded inside the timed call, too."""
    h, dm = 12, 768
    x = torch.randn(b, t, dm, generator=g)
    params = [a.to(DEV) for _ in range(3) for a in (
        torch.randn(dm, dm, generator=g) / dm**0.5, 0.1 * torch.randn(dm, generator=g))]
    for i, n in enumerate(lengths):
        x[i, n:] = 0.0
    x = x.to(DEV)
    lens = torch.tensor(lengths, dtype=torch.int32, device=DEV)

    def kernel(xx=x):
        return fused_attention.fused_qkv_mha(xx, *params, lens, h, "default")

    o = kernel()
    ref = fused_attention.fused_qkv_attention_ref(x, *params, lens, h, "default")
    torch.cuda.synchronize()
    err = (o - ref).abs().max().item()
    err_f64 = err_plain_f64 = 0.0
    excess = float("-inf")
    for i in range(b):  # one batch row at a time: [1, H, T, T] in float64
        sl = slice(i, i + 1)
        exact = fused_f64(x[sl], params, lens[sl], h)
        e = (o[sl].double() - exact).abs().max().item()
        ep = (ref[sl].double() - exact).abs().max().item()
        excess = max(excess, e - (1.5 * ep + 1e-6))
        err_f64, err_plain_f64 = max(err_f64, e), max(err_plain_f64, ep)
        del exact
    q, k, v = (prec_ops.linear(x, w, bias, "default").view(b, t, h, 64)
               for w, bias in zip(params[0::2], params[1::2]))
    o_k1b = flash_attention.mha_flash(q, k, v, lens, "default")[0].transpose(1, 2)
    o_pair = flash_attention.flash_attention_ref(q, k, v, lens, "default")[0].transpose(1, 2)
    d_k1b = (o - o_k1b).abs().max().item()
    d_pair = (ref - o_pair).abs().max().item()
    del q, k, v, o_k1b, o_pair
    finite = bool(torch.isfinite(o).all())
    empty_ok = all(bool((o[i] == 0).all()) for i, n in enumerate(lengths) if n == 0)
    same_bits = torch.equal(kernel(), o)
    garbage_ok = garbage_past_bound_ok(kernel, x, o, lengths)
    rounds = err_f64 >= 0.5 * err_plain_f64
    vs_k1b_ok = d_k1b <= FUSED_BF16_VS_K1B * d_pair + 1e-6
    # the prologue's buffers: the packed weights and the rounded x, bit-equal
    # to their plain versions
    workspace = fused_attention._bf16_workspace(x, h)
    fused_attention._launch("default", x, *params, lens, h, workspace=workspace)
    packed = torch.equal(workspace[0], fused_attention.pack_weights_ref(*params[0::2], h)) and \
        torch.equal(workspace[1], x.to(torch.bfloat16))
    del workspace
    if not (finite and empty_ok and same_bits and garbage_ok and rounds and vs_k1b_ok
            and packed) or excess > 0:
        fail(f"fused bf16 [{b}, {t}, {dm}] lengths {lengths[:8]}: finite={finite} 0-key "
             f"rows={empty_ok} rerun same bits={same_bits} garbage past bound={garbage_ok} "
             f"packed weights and rounded x bit-equal={packed}; "
             f"max|O - O_f64| {err_f64:.3g} beyond 1.5 x the plain version's "
             f"{err_plain_f64:.3g} + 1e-6 by {excess:.3g}, or under half of it; vs K1b "
             f"{d_k1b:.3g} (plain pair {d_pair:.3g}, <= {FUSED_BF16_VS_K1B} x + 1e-6)")
    del ref
    b_ms, b_by = fused_bound(b, t, h, dm, lens, BF16_FLOPS)
    res = {"shape": [b, t, dm], "heads": h, "lengths_sum": int(lens.sum()),
           "max_abs_err": err, "max_abs_err_vs_f64": err_f64,
           "plain_max_abs_err_vs_f64": err_plain_f64, "vs_k1b_max_abs": d_k1b,
           "plain_pair_max_abs": d_pair, "bound_ms": b_ms, "bound_by": b_by}
    if kernel_time:
        res["ms"] = time_ms(kernel, 20)
    if timed:
        # the yardstick: x rounded to bf16 (inside the timed call, as the
        # kernel rounds it inside its own), one bf16 product against the
        # stacked [3 * 768, 768] weights, then SDPA on bf16 with the key mask
        wqkv = torch.cat(params[0::2]).to(torch.bfloat16)
        bqkv = torch.cat(params[1::2]).to(torch.bfloat16)
        mask = None
        if int(lens.min()) < t:
            mask = (torch.arange(t, device=DEV)[None, :] < lens[:, None])[:, None, None, :]

        def library():
            qq, kk, vv = F.linear(x.to(torch.bfloat16), wqkv, bqkv).view(
                b, t, 3, h, 64).permute(2, 0, 3, 1, 4)
            return F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask)

        res["plain_ms"] = time_ms(lambda: fused_attention.fused_qkv_attention_ref(
            x, *params, lens, h, "default"), 5)
        res["library_ms"] = time_ms(library, 10)
    print(f"  fused bf16 [{b}, {t}, {dm}] keys {int(lens.sum())}: vs plain max|d| {err:.3g}, "
          f"vs f64 {err_f64:.3g} (plain {err_plain_f64:.3g}), vs K1b {d_k1b:.3g} (plain pair "
          f"{d_pair:.3g}); kernel {res.get('ms', float('nan')):.4f} ms  plain "
          f"{res.get('plain_ms', float('nan')):.4f}  F.linear + sdpa bf16 "
          f"{res.get('library_ms', float('nan')):.4f}  bound {b_ms:.4f} ({b_by})", flush=True)
    return res


def check_fused_bf16_shapes() -> None:
    g = torch.Generator().manual_seed(12)
    rng = np.random.default_rng(12)
    # the scoring shape: 499 valid frames of 511, a few rows ragged down to
    # 1 key, one full row, one row with no key
    main_lens = [511, 1, 0] + list(rng.integers(2, 511, size=9)) + [499] * 84
    res = {"main": check_fused_bf16(96, 511, main_lens, g, timed=True),
           "loss": check_fused_bf16(LOSS_BATCH, 50, [50] * LOSS_BATCH, g, timed=True),
           "ragged": check_fused_bf16(8, 1024, [1024, 1023, 777, 513, 512, 64, 2, 1], g,
                                      timed=True)}
    # every edge of the plan: one tensor per block up to 64 rows (16-row
    # warp tiles), then a cluster of 64-row chunks up to 16 of them
    for t in (1, 15, 16, 17, 63, 64, 65, 511, 1023, 1024):
        res[f"edge_T{t}"] = check_fused_bf16(4, t, [t, max(t // 2, 1), 1, 0], g, timed=False,
                                             kernel_time=False)
    report["kernels"]["fused_qkv_attention_bf16_fwd"] = res


def fast_plain_paths(sd: dict, waves: list) -> tuple:
    """The "fast" plain path's embeddings (K1b's own plain version, plain
    LayerNorm) and the "exact" plain path's on the same waves."""
    with plain_flash("fast"):
        fast = Nomad(device="cuda", config=plain_config("fast"), params=sd)
        fast_emb = fast.engine.embed_waves_device(waves)
    del fast
    exact = Nomad(device="cuda", config=plain_config(), params=sd)
    exact_emb = exact.engine.embed_waves_device(waves)
    del exact
    return fast_emb, exact_emb


def run_fused_fast_scoring(card: str, sd: dict, tmp: Path, nmr: str, deg: str) -> dict:
    """``Nomad(precision="fast", config=Wav2Vec2Config.fast(
    attention_impl="fused_qkv"))`` on phase 4's files: launch counts of a
    predict (K4b 12 per batch, K5 26), warm device passes, own peak, one
    profiled pass, each beside the unfused "fast" K1b path's in the same
    run; its embeddings against the "fast" plain path within
    TOL_REF_PATH + GRAD_MODE_FRAC times that path's distance to the
    "exact" plain path, and, reported, against the "fast" K1b path and
    its pairwise delta against "exact" (the K1 path); then two single
    files, T' = 1,023 (K4b) and T' = 1,433 (past MAX_FUSED_T: K1b)."""
    total_s = (N_NMR + N_DEG) * SECONDS
    leftover_gb = settled_allocated_gb()
    nomad = Nomad(device="cuda", precision="fast", params=sd,
                  config=mode_config("fast", attention_impl="fused_qkv"))
    out = tmp / "fused_fast"
    out.mkdir()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    nomad.predict("dir", nmr, deg, str(out))
    torch.cuda.synchronize()
    counts = read_launches()
    batches = nomad.engine.batches
    report["launches"]["scoring_fused_fast"] = counts
    want = launches_want(k4b=12 * batches, k5=26 * batches)
    if counts != want or batches == 0:
        fail(f"fused fast: launch counts {counts} for {batches} batches (want {want})")
    check_csvs(out, "fused fast API")
    paths = sorted(Path(nmr).iterdir()) + sorted(Path(deg).iterdir())
    waves = nomad.engine.load_waves([str(p) for p in paths])
    emb, passes = timed_passes(nomad, waves)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    profile_run(lambda: nomad.engine.embed_waves_device(waves), "profile_fused_fast")
    pass_s = float(np.median(passes))
    # the unfused "fast" path (K1b after the q/k/v products) timed beside it
    k1b = Nomad(device="cuda", precision="fast", params=sd)
    k1b_emb, k1b_passes = timed_passes(k1b, waves)
    profile_run(lambda: k1b.engine.embed_waves_device(waves), "profile_fast_k1b_beside_fused")
    del k1b
    exact_emb = Nomad(device="cuda", params=sd).engine.embed_waves_device(waves)
    plain_fast, plain_exact = fast_plain_paths(sd, waves)
    d_plain = (plain_fast - plain_exact).abs().max().item()
    tol = TOL_REF_PATH + GRAD_MODE_FRAC * d_plain
    res = {"files": N_NMR + N_DEG, "batches": batches, "pass_s": passes,
           "wav_s_per_s_pass": total_s / pass_s, "k1b_fast_pass_s": k1b_passes,
           "k1b_fast_wav_s_per_s_pass": total_s / float(np.median(k1b_passes)),
           "peak_mem_gb": peak_gb,
           "leftover_mem_gb": leftover_gb, "own_peak_mem_gb": peak_gb - leftover_gb,
           "vs_fast_plain_path_emb": (emb - plain_fast).abs().max().item(),
           "fast_plain_vs_exact_plain_emb": d_plain, "tolerance": tol,
           "vs_fast_k1b_path_emb": (emb - k1b_emb).abs().max().item(),
           "vs_exact_k1_path_emb": (emb - exact_emb).abs().max().item(),
           "pairwise_delta": pairwise_delta(emb, exact_emb, slice(N_NMR, None),
                                            slice(0, N_NMR)),
           "card": card}
    print(f"fused fast: {batches} batches, launches {counts}; device pass {pass_s:.3f} s = "
          f"{total_s / pass_s:.1f} wav-s/s (the unfused fast K1b path beside it "
          f"{float(np.median(k1b_passes)):.3f} s); own peak {res['own_peak_mem_gb']:.5f} GB  [{card}]; "
          f"max|d emb| vs the fast plain path {res['vs_fast_plain_path_emb']:.3g} (<= {tol:.3g}: "
          f"{TOL_REF_PATH} + {GRAD_MODE_FRAC} x {d_plain:.3g}), vs the fast K1b path "
          f"{res['vs_fast_k1b_path_emb']:.3g}; pairwise delta vs exact "
          f"{res['pairwise_delta']:.3g}", flush=True)
    if not torch.isfinite(emb).all() or res["vs_fast_plain_path_emb"] > tol:
        fail(f"fused fast embeddings vs the fast plain path {res['vs_fast_plain_path_emb']:.3g} "
             f"> {tol:.3g}")
    del k1b_emb, exact_emb, plain_fast, plain_exact

    rng = np.random.default_rng(99)
    for n, frames in FUSED_SINGLE_FILES:
        if fused_attention.fused_supported(frames):
            want = launches_want(k4b=12, k5=26)
        else:
            want = launches_want(k1b=12, k5=26)
        wave = np.rint(np.clip(speech_like(rng, n, 0.02), -1, 1) * 32767).astype(np.int16)
        reset_launches()
        one = nomad.engine.embed_waves_device([wave])
        torch.cuda.synchronize()
        counts = read_launches()
        key = f"fused_fast_single_T{frames}"
        report["launches"][key] = counts
        p_fast, p_exact = fast_plain_paths(sd, [wave])
        d, d_p = (one - p_fast).abs().max().item(), (p_fast - p_exact).abs().max().item()
        tol = TOL_REF_PATH + GRAD_MODE_FRAC * d_p
        res[f"single_T{frames}"] = {"vs_fast_plain_path_emb": d,
                                    "fast_plain_vs_exact_plain_emb": d_p, "tolerance": tol}
        print(f"fused fast: one file of {n} samples (T' = {frames}): launches {counts}, "
              f"max|d| {d:.3g} vs the fast plain path (<= {tol:.3g})", flush=True)
        if counts != want or not torch.isfinite(one).all() or d > tol:
            fail(f"fused fast, one file of {n} samples: launches {counts} (want {want}), "
                 f"max|d| {d:.3g} vs the fast plain path (> {tol:.3g}?)")
    del nomad

    # "balanced" keeps K4h: the fused kernel takes the projections' island
    # ("high": the TPU kernel's "high3"), not the attention products'
    # ("default")
    balanced = Nomad(device="cuda", precision="balanced", params=sd,
                     config=mode_config("balanced", attention_impl="fused_qkv"))
    reset_launches()
    bal_emb = balanced.engine.embed_waves_device(waves)
    torch.cuda.synchronize()
    counts = read_launches()
    report["launches"]["scoring_fused_balanced"] = counts
    want = launches_want(k4h=12 * batches, k5=26 * batches)
    print(f"fused balanced: launches {counts} (want {want})", flush=True)
    if counts != want or not torch.isfinite(bal_emb).all():
        fail(f"fused balanced: launch counts {counts} (want {want})")
    del balanced
    return res


def run_fused_modes(card: str) -> None:
    """Phase 12: K4b against its plain version at its shapes, then the
    fused path in "fast" (scoring, single files, the loss at both shapes)
    and "balanced" (K4h) on phase 9's seeded BASE state dict."""
    report.setdefault("launches", {})
    t_phase = time.perf_counter()
    print("fused modes: K4b vs its plain version on the card:", flush=True)
    check_fused_bf16_shapes()
    sd = SHARED.get("sd")
    if sd is None:  # phase 12 alone: Nomad's seeded init, as phase 9 makes it
        sd = init_weights(NomadModel(Wav2Vec2Config.base(), emb_dim=256), seed=0).state_dict()
    out: dict = {"card": card}
    with tempfile.TemporaryDirectory(prefix="nomad_fused_modes_") as tmp:
        tmp = Path(tmp)
        nmr, deg = write_wavs(tmp)
        out["scoring_fast"] = run_fused_fast_scoring(card, sd, tmp, nmr, deg)
    want = launches_want(k4b=24, k1b=12, k2b=12, k3b=12, k5=52)
    config = mode_config("fast", attention_impl="fused_qkv")
    run_loss_path(card, "loss_path_fused_fast", config, want, LOSS_BATCH, LOSS_SAMPLES, "fast",
                  sd)
    run_loss_path(card, "loss_path_10s_fused_fast", config, want, LOSS10_BATCH, LOSS10_SAMPLES,
                  "fast", sd)
    out["phase_s"] = time.perf_counter() - t_phase
    report["fused_modes"] = out
    print(f"fused modes: phase 12 took {out['phase_s']:.1f} s", flush=True)


# ---------------- phase 13: the trainer's fast_bf16, the bf16-I/O flavours ----------------


def bf16_ulp_of(x: torch.Tensor) -> torch.Tensor:
    """One bf16 step at each |x| (8 significant bits), in f32."""
    mag = x.float().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def check_layernorm_bf16io(rows: int, width: int, g: torch.Generator) -> dict:
    """K5's bf16-I/O flavour: bit-equal to its f32 flavour on the upcast
    rows, rounded once; within K5's f32 tolerance TOL_LN plus one bf16 step
    of its plain version on the same bf16 rows, element by element (both
    round f32 values at most TOL_LN apart; an output near 0 is a sum that
    cancelled, whose f32 error is that of its terms); a rerun the same
    bits; timed beside the f32 flavour, the plain version and
    ``F.layer_norm`` on bf16."""
    x = (3 * torch.randn(rows, width, generator=g) + 1).to(DEV).to(torch.bfloat16)
    w = (1 + 0.1 * torch.randn(width, generator=g)).to(DEV)
    b = (0.1 * torch.randn(width, generator=g)).to(DEV)
    x32 = x.float()
    out = layernorm.layer_norm(x, w, b)
    twin = layernorm.layer_norm(x32, w, b)
    ref = layernorm.layer_norm_ref(x, w, b)
    torch.cuda.synchronize()
    d = (out.float() - ref.float()).abs()
    err = d.max().item()
    bit_equal = torch.equal(out, twin.to(torch.bfloat16))
    step = bf16_ulp_of(torch.maximum(out.float().abs(), ref.float().abs()))
    within = bool((d <= TOL_LN + step).all())
    same_bits = torch.equal(out, layernorm.layer_norm(x, w, b))
    if out.dtype != torch.bfloat16 or not (bit_equal and within and same_bits):
        fail(f"layernorm bf16 I/O [{rows}, {width}]: dtype {out.dtype}, bf16(f32 flavour) "
             f"bit-equal={bit_equal}, within {TOL_LN} + one bf16 step of plain={within} "
             f"(max|d| {err:.3g}), "
             f"rerun same bits={same_bits}")
    nbytes = 2 * rows * width * 2 + 2 * width * 4
    b_ms, b_by = bound(nbytes, 8.0 * rows * width)
    wb, bb = w.to(torch.bfloat16), b.to(torch.bfloat16)
    res = {"shape": [rows, width], "max_abs_err": err, "bit_equal_f32_flavour": bit_equal,
           "ms": time_ms(lambda: layernorm.layer_norm(x, w, b), 50),
           "f32_io_ms": time_ms(lambda: layernorm.layer_norm(x32, w, b), 50),
           "plain_ms": time_ms(lambda: layernorm.layer_norm_ref(x, w, b), 20),
           "library_ms": time_ms(lambda: F.layer_norm(x, (width,), wb, bb, 1e-5), 50),
           "bound_ms": b_ms, "bound_by": b_by}
    print(f"  layernorm bf16 I/O [{rows}, {width}]: bf16(f32 flavour) bit-equal, vs plain max|d| "
          f"{err:.3g} (<= {TOL_LN} + one bf16 step); kernel {res['ms']:.4f} ms, f32 I/O "
          f"{res['f32_io_ms']:.4f}, plain {res['plain_ms']:.4f}, F.layer_norm bf16 "
          f"{res['library_ms']:.4f}, bound {b_ms:.4f} ({b_by})", flush=True)
    return res


def near_one_step(x, y32, rel: float) -> tuple[bool, dict]:
    """A bf16 output x of a "highest" flavour on the tensor cores (K1-bf16,
    K4-bf16, K2-bf16, K3-bf16) against the f32 flavour's y32 (K1, K4, K2,
    K3 on the upcast inputs) rounded once: whether every element lies
    within one bf16 step (at the larger of the two) beyond ``rel`` of
    max |y32| (both sum f32-exact products, in two orders: an element that
    cancelled carries its terms' rounding); the share of elements whose
    bits differ, the share more than one step apart and the largest
    distance in steps."""
    yb = y32.to(torch.bfloat16)
    diff = (x.float() - yb.float()).abs()
    step = bf16_ulp_of(torch.maximum(x.float().abs(), yb.float().abs()))
    near = bool((diff <= step + rel * y32.abs().max().item()).all())
    return near, {"share_differ": (x != yb).float().mean().item(),
                  "share_beyond_one_step": (diff > step).float().mean().item(),
                  "max_steps": (diff / step).max().item()}


def near_f32_flavour(outs, outs32) -> tuple[bool, dict]:
    """K2-bf16's and K3-bf16's (dQ, dK, dV) against the f32 flavour's (K2
    and K3 on the upcast inputs) rounded once, each by ``near_one_step`` at
    BWD_F32_PLAIN_REL of the f32 flavour's max |g|. An output that is
    rounding noise on both sides (max |g| <= BWD_NOISE: dQ and dK with one
    key, analytically 0) is held by the float64 rule alone."""
    near, info = True, {}
    for n, x, y in zip(("dq", "dk", "dv"), outs, outs32):
        ok, info[n] = near_one_step(x, y, BWD_F32_PLAIN_REL)
        info[n]["noise"] = y.abs().max().item() <= BWD_NOISE
        near &= ok or info[n]["noise"]
    return near, info


def lse_gaps(q, k, lse, lse32, n: int) -> tuple[float, float]:
    """For one batch row of bf16 q, k with n valid keys: max |LSE - LSE_f64|
    of K1-bf16's LSE and of the f32 flavour's (K1 on the upcast inputs),
    LSE_f64 the log-sum-exp of the exact scores (0, 0 for a row with no
    key: both give -1e30)."""
    if n == 0:
        return 0.0, 0.0
    d = q.shape[3]
    qh, kh = q[0].transpose(0, 1).double(), k[0, :n].transpose(0, 1).double()
    exact = torch.logsumexp(torch.einsum("hqd,hkd->hqk", qh, kh) / d**0.5, dim=-1)
    return ((lse[0].double() - exact).abs().max().item(),
            (lse32[0].double() - exact).abs().max().item())


def recompute_gap(q, k, lse, n: int) -> tuple[float, float]:
    """How far the P = exp(S / sqrt(D) - LSE) that K2-bf16 and K3-bf16
    recompute lies from the exact softmax, for one batch row of bf16 q, k
    with n valid keys: max |LSE - LSE_f64| of the forward's saved LSE
    (K1-bf16: the tensor core's order) and max |S - S_f64| / sqrt(D) of the scores in
    one bf16 pass with f32 sums (cuBLAS's bmm standing in for the kernels'
    wgmma: the products are exact, the order of the sum differs)."""
    if n == 0:
        return 0.0, 0.0
    d = q.shape[3]
    qh, kh = q[0].transpose(0, 1), k[0, :n].transpose(0, 1)  # [H, T, D], [H, n, D]
    s64 = torch.einsum("hqd,hkd->hqk", qh.double(), kh.double()) / d**0.5
    s_tc = torch.bmm(qh, kh.transpose(1, 2), out_dtype=torch.float32).double() / d**0.5
    gaps = ((lse[0].double() - torch.logsumexp(s64, dim=-1)).abs().max().item(),
            (s_tc - s64).abs().max().item())
    del s64, s_tc
    return gaps


def check_flash_bf16io(b: int, t: int, lengths: list, g: torch.Generator, timed: bool,
                       bwd: bool = True, kernel_times: bool = True,
                       prec: str = "default") -> dict:
    """K1b's bf16-I/O flavour and, with ``bwd``, K2b's and K3b's (through
    ``flash_attention_bwd``), or at ``prec`` "highest" K1-bf16, K2-bf16
    and K3-bf16, on bf16 q, k, v (views of one [B, T, 3, H, D] buffer) and
    dO, NaN in k and v past each bound: K1b's O bit-equal to the f32-I/O
    flavour's on the upcast inputs rounded once (LSE equal), and so are
    K2b's and K3b's gradients; K1-bf16's O, K2-bf16's and K3-bf16's
    gradients (the f32 flavour's products on the tensor cores, summed in
    another order) each within one bf16 step of the f32 flavour's (K1, K2,
    K3 on the upcast inputs) rounded once, beyond FWD_F32_PLAIN_REL of its
    max |O| and BWD_F32_PLAIN_REL of its max |g| (two f32 orders: an
    element that cancelled carries its terms' rounding), the share of
    elements that differ reported, K1-bf16's LSE no further from float64
    than K1's x 1.5 + 1e-6; the prologue's fold bit-equal to its plain
    version and the one C call the bits of the prologue and the kernels
    launched alone; the same bits as with finite values past
    the bound, and on a rerun; a 0-key row O = 0, LSE = -1e30, zero
    gradients; dK = dV = 0 past each bound; against the plain version on
    the same bf16 inputs and float64: |O - O_f64| <= 1.5 x the plain
    version's + 1.5 bf16 steps at its max + 1e-6 (phase 9's rule for
    outputs rounded once), LSE within TOL_FLASH; each gradient within
    BWD_BF16_PLAIN_REL + BF16_ULP_REL of the plain version's max |g| and
    BWD_BF16_PLAIN_NORM + BF16_ULP_REL / 2 of its norm (where max |g| >
    BWD_NOISE), |g - g_f64| <= 1.5 x the plain version's + 1.5 bf16 steps
    + 1e-6 (phase 10's rule); at "highest" the gradients within
    BWD_F32_PLAIN_REL instead of BWD_BF16_PLAIN_REL and BWD_BF16_PLAIN_NORM
    (f32-exact products on both sides). ``kernel_times``: time the bf16-I/O
    kernels and their f32-I/O flavour; ``timed``: the plain version and the
    yardstick, SDPA (its gradient) on the bf16 tensors at "default", on
    their f32 upcasts at "highest", too. At "highest" the bounds count
    K1-bf16's (S one pass, P . V three), K2-bf16's and K3-bf16's passes on
    the bf16 tensor cores and the bytes of the fold they read; the f32-FMA
    bound of the f32 flavour's work beside them."""
    h, d = 12, 64
    bf = torch.bfloat16
    bf16_ops = prec_ops.is_bf16(prec)
    tags = ("K1b", "K2b", "K3b") if bf16_ops else ("K1-bf16", "K2-bf16", "K3-bf16")
    plain_rel = BWD_BF16_PLAIN_REL if bf16_ops else BWD_F32_PLAIN_REL
    plain_norm = BWD_BF16_PLAIN_NORM if bf16_ops else BWD_F32_PLAIN_REL
    peak = BF16_FLOPS if bf16_ops else F32_FLOPS
    qkv = torch.randn(b, t, 3, h, d, generator=g).to(DEV).to(bf)
    finite = qkv.clone()
    q, k, v = qkv.unbind(2)
    for i, n in enumerate(lengths):
        k[i, n:] = float("nan")
        v[i, n:] = float("nan")
    _, kf, vf = finite.unbind(2)
    lens = torch.tensor(lengths, dtype=torch.int32, device=DEV)
    up = [x.float() for x in (q, k, v)]
    o, lse = flash_attention.mha_flash(q, k, v, lens, prec)
    o32, lse32 = flash_attention.mha_flash(*up, lens, prec)
    o_fin, lse_fin = flash_attention.mha_flash(q, kf, vf, lens, prec)
    again = flash_attention.mha_flash(q, k, v, lens, prec)
    torch.cuda.synchronize()
    checks = {"dtype": o.dtype == bf and lse.dtype == torch.float32,
              "nan_past_bound_changes_nothing": torch.equal(o, o_fin) and torch.equal(lse, lse_fin),
              "rerun_same_bits": torch.equal(o, again[0]) and torch.equal(lse, again[1]),
              "finite": bool(torch.isfinite(o).all() and torch.isfinite(lse).all()),
              "zero_key_rows": all(bool((o[i] == 0).all() and (lse[i] == flash_attention.NEG_INF)
                                        .all()) for i, n in enumerate(lengths) if n == 0)}
    near_fwd = None
    if bf16_ops:  # one bf16 body: the f32 flavour's bits, rounded once
        checks["bit_equal_f32_flavour"] = torch.equal(o, o32.to(bf)) and torch.equal(lse, lse32)
    else:  # K1-bf16: the tensor core's order, within one bf16 step
        near, near_fwd = near_one_step(o, o32, FWD_F32_PLAIN_REL)
        checks["within_one_bf16_step_of_f32_flavour"] = near
    del o_fin, lse_fin, again
    err = err_f64 = err_plain_f64 = err_lse = lse_gap = s_gap = 0.0
    lse_f64 = lse32_f64 = 0.0
    excess = float("-inf")
    for i in range(b):  # one batch row at a time: [1, H, T, T] in float64
        sl = slice(i, i + 1)
        ro, rlse = flash_attention.flash_attention_ref(q[sl], k[sl], v[sl], lens[sl], prec)
        exact = attention_f64(up[0][sl], up[1][sl], up[2][sl], lens[sl])
        e = (o[sl].double() - exact).abs().max().item()
        ep = (ro.double() - exact).abs().max().item()
        step = BF16_ULP_REL * exact.abs().max().item()
        excess = max(excess, e - (1.5 * ep + 1.5 * step + 1e-6))
        err = max(err, (o[sl].float() - ro.float()).abs().max().item())
        err_f64, err_plain_f64 = max(err_f64, e), max(err_plain_f64, ep)
        err_lse = max(err_lse, (lse[sl] - rlse).abs().max().item())
        if not bf16_ops:
            gaps = lse_gaps(q[sl], k[sl], lse[sl], lse32[sl], lengths[i])
            lse_f64, lse32_f64 = max(lse_f64, gaps[0]), max(lse32_f64, gaps[1])
        if bwd and not bf16_ops:
            gaps = recompute_gap(q[sl], k[sl], lse[sl], lengths[i])
            lse_gap, s_gap = max(lse_gap, gaps[0]), max(s_gap, gaps[1])
        del ro, rlse, exact
    checks["vs_plain_and_f64"] = excess <= 0 and err_lse <= TOL_FLASH
    del o32, lse32
    res = {"shape": [b, t, h, d], "lengths": lengths, "lengths_sum": int(lens.sum()),
           "fwd": {"max_abs_err": err, "max_abs_err_vs_f64": err_f64,
                   "plain_max_abs_err_vs_f64": err_plain_f64, "lse_max_abs_err": err_lse}}
    if not bf16_ops:
        checks["lse_vs_f64_within_f32_flavour"] = lse_f64 <= 1.5 * lse32_f64 + 1e-6
        res["fwd"] |= {"vs_f32_flavour": near_fwd, "lse_max_abs_err_vs_f64": lse_f64,
                       "f32_flavour_lse_max_abs_err_vs_f64": lse32_f64,
                       "ratio_to_plain_vs_f64": err_f64 / max(err_plain_f64, 1e-30)}
    if bwd and not bf16_ops:
        res["recompute"] = {"lse_max_abs_err_vs_f64": lse_gap, "scores_max_abs_err_vs_f64": s_gap}
    # K1b: one pass a product; K1-bf16: S one pass and P . V three on the
    # bf16 tensor cores, the f32 flavour's FMA work beside
    b_ms, b_by = flash_bound(b, t, h, d, lens, BF16_FLOPS, io_bytes=2,
                             pv_passes=1 if bf16_ops else 3)
    res["fwd"] |= {"bound_ms": b_ms, "bound_by": b_by}
    if not bf16_ops:
        res["fwd"] |= dict(zip(("f32_fma_bound_ms", "f32_fma_bound_by"),
                               flash_bound(b, t, h, d, lens, F32_FLOPS, io_bytes=2)))
    iters = 10 if t > 1024 else 30
    up_c = [x.contiguous() for x in up]  # the f32-I/O flavour's inputs, for its times
    # the prologue (both I/O flavours fold to the same bits) and the kernel
    # alone on its fold, the one call's bits
    parts = check_fold_fwd(q, k, v, lens, kernel_times, prec)
    res["fwd_fold"] = parts["fold"]
    res["fwd"] |= {f"kernel_{f}": v for f, v in parts["kernel"].items()}
    ws32 = flash_attention._flash_bf16_fold(*up_c, lens)
    checks["fwd_fold_bit_equal_f32_flavour"] = torch.equal(
        flash_attention._flash_bf16_fold(q, k, v, lens), ws32)
    if kernel_times:
        res["fwd_fold"]["f32_io_ms"] = time_ms(
            lambda: flash_attention._flash_bf16_fold(*up_c, lens, ws32), iters)
    if kernel_times:
        res["fwd"]["ms"], res["fwd"]["f32_io_ms"] = time_pair_ms(
            lambda: flash_attention.mha_flash(q, k, v, lens, prec),
            lambda: flash_attention.mha_flash(*up_c, lens, prec), iters)
    mask = (torch.arange(t, device=DEV)[None, :] < lens[:, None])[:, None, None, :]
    # the yardstick computes the flavour's function: SDPA on the bf16
    # tensors at "default", on their f32 upcasts (made inside the timed
    # call) at "highest"
    up_lib = (lambda x: x) if bf16_ops else (lambda x: x.float())
    # the plain versions at [8, 4095] hold [B, H, T, T] f32 scores: fewer calls
    plain_iters, plain_warmup = (5, 3) if t <= 1024 else (2, 1)
    if timed:
        qb, kb, vb = (x.transpose(1, 2) for x in (q, kf, vf))
        res["fwd"]["plain_ms"] = time_ms(
            lambda: flash_attention.flash_attention_ref(q, k, v, lens, prec), plain_iters,
            plain_warmup)
        res["fwd"]["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
            up_lib(qb), up_lib(kb), up_lib(vb), attn_mask=mask), 10)
    if bwd:
        do = torch.randn(b, t, h, d, generator=g).to(DEV).to(bf)
        names = ("dq", "dk", "dv")

        def grads(*a):
            return flash_attention.flash_attention_bwd(*a, prec)

        outs = grads(q, k, v, o, lse, do, lens)
        outs32 = grads(*up, o.float(), lse, do.float(), lens)
        outs_fin = grads(q, kf, vf, o, lse, do, lens)
        again = grads(q, k, v, o, lse, do, lens)
        torch.cuda.synchronize()
        dq, dk, dv = outs
        if bf16_ops:  # one bf16 body: the f32 flavour's bits, rounded once
            checks["bwd_bit_equal_f32_flavour"] = all(torch.equal(x, y.to(bf))
                                                      for x, y in zip(outs, outs32))
        else:  # K2-bf16/K3-bf16: the tensor core's order, within one bf16 step
            near, res["bwd_vs_f32_flavour"] = near_f32_flavour(outs, outs32)
            checks["bwd_within_one_bf16_step_of_f32_flavour"] = near
        checks |= {
            "bwd_dtype": all(x.dtype == bf for x in outs),
            "bwd_rerun_same_bits": all(torch.equal(x, y) for x, y in zip(outs, again)),
            "bwd_finite": all(bool(torch.isfinite(x).all()) for x in outs),
            "bwd_zero_past_bound": all(bool((dk[i, n:] == 0).all() and (dv[i, n:] == 0).all())
                                       for i, n in enumerate(lengths)),
            "bwd_zero_key_rows": all(bool((dq[i] == 0).all()) for i, n in enumerate(lengths)
                                     if n == 0),
            # valid rows: every dQ row, and dK/dV below each bound
            "bwd_nan_past_bound_changes_nothing": torch.equal(dq, outs_fin[0]) and all(
                torch.equal(x[i, :n], y[i, :n]) for x, y in zip((dk, dv), outs_fin[1:])
                for i, n in enumerate(lengths))}
        del outs32, outs_fin, again
        err, err_f64, plain_f64, gmax, sq_err, sq_ref = ({n: 0.0 for n in names}
                                                         for _ in range(6))
        excess = float("-inf")
        for i in range(b):
            sl = slice(i, i + 1)
            ref = flash_attention.flash_attention_bwd_ref(q[sl], k[sl], v[sl], o[sl], lse[sl],
                                                          do[sl], lens[sl], prec)
            exact = attention_bwd_f64(up[0][sl], up[1][sl], up[2][sl], do[sl].float(), lens[sl])
            for n, ours, r, x in zip(names, outs, ref, exact):
                ours, r = ours[sl].float(), r.float()
                diff = (ours - r).nan_to_num(nan=float("inf"))
                err[n] = max(err[n], diff.abs().max().item())
                e = (ours.double() - x).abs().nan_to_num(nan=float("inf")).max().item()
                ep = (r.double() - x).abs().max().item()
                excess = max(excess, e - (1.5 * ep + 1.5 * BF16_ULP_REL * x.abs().max().item()
                                          + 1e-6))
                err_f64[n], plain_f64[n] = max(err_f64[n], e), max(plain_f64[n], ep)
                gmax[n] = max(gmax[n], r.abs().max().item())
                sq_err[n] += diff.square().sum().item()
                sq_ref[n] += r.square().sum().item()
            del ref, exact
        err_rel = {n: err[n] / max(gmax[n], 1e-30) for n in names}
        err_norm = {n: (sq_err[n] / max(sq_ref[n], 1e-60)) ** 0.5 for n in names}
        # an output that is rounding noise (max |g| <= BWD_NOISE: dQ and dK
        # with one key, analytically 0) is held by the float64 rule alone
        live = [n for n in names if gmax[n] > BWD_NOISE]
        checks["bwd_vs_plain_and_f64"] = (
            excess <= 0 and all(err_rel[n] <= plain_rel + BF16_ULP_REL and
                                err_norm[n] <= plain_norm + BF16_ULP_REL / 2
                                for n in live))
        # at "highest": K2-bf16/K3-bf16's passes on the bf16 tensor cores,
        # reading the fold; the f32 flavour's FMA work beside it
        bounds = flash_bwd_bounds(b, t, h, d, lens, BF16_FLOPS, io_bytes=2,
                                  passes=1 if bf16_ops else 3)
        fma_bounds = None if bf16_ops else flash_bwd_bounds(b, t, h, d, lens, F32_FLOPS,
                                                            io_bytes=2)
        do_, di, lens_ = flash_attention._bwd_args(q, k, v, o, lse, do, lens)
        do32, di32, _ = flash_attention._bwd_args(*up_c, o.float(), lse, do.float(), lens)
        args = {False: (q, k, v, do_, lse, di, lens_), True: (*up_c, do32, lse, di32, lens_)}
        # the prologue: both flavours fold to the same bits
        res["fold"] = check_fold(*args[False], kernel_times)
        ws = {f32: flash_attention._bwd_bf16_fold(*args[f32]) for f32 in (False, True)}
        checks["bwd_fold_bit_equal_f32_flavour"] = all(
            torch.equal(x, y) for x, y in zip(ws[False], ws[True]))
        if kernel_times:
            res["fold"]["f32_io_ms"] = time_ms(
                lambda: flash_attention._bwd_bf16_fold(*args[True], ws[True]), iters)
        if not bf16_ops:  # the one C call is the prologue and the kernels alone
            alone = (*flash_attention._bwd_bf16_kernel("dq", q, ws[False], lens_, prec),
                     *flash_attention._bwd_bf16_kernel("dkv", q, ws[False], lens_, prec))
            checks["bwd_one_call_is_the_kernels_alone"] = all(
                torch.equal(x, y) for x, y in zip(outs, alone))
            del alone

        def kernel(key, f32_io):
            if bf16_ops or not f32_io:
                return flash_attention._bwd_bf16_kernel(key, args[f32_io][0], ws[f32_io], lens_,
                                                        prec)
            return (flash_attention._bwd_dq_kernel if key == "dq"
                    else flash_attention._bwd_dkv_kernel)(*args[f32_io])

        for key, parts in (("dq", ("dq",)), ("dkv", ("dk", "dv"))):
            res[key] = {"max_abs_err": max(err[n] for n in parts),
                        "max_rel_err": max(err_rel[n] for n in parts),
                        "norm_rel_err": max(err_norm[n] for n in parts),
                        "max_abs_err_vs_f64": {n: err_f64[n] for n in parts},
                        "plain_max_abs_err_vs_f64": {n: plain_f64[n] for n in parts},
                        "bound_ms": bounds[key][0], "bound_by": bounds[key][1]}
            if fma_bounds is not None:
                res[key] |= {"f32_fma_bound_ms": fma_bounds[key][0],
                             "f32_fma_bound_by": fma_bounds[key][1],
                             "vs_f32_flavour": {n: res["bwd_vs_f32_flavour"][n] for n in parts},
                             "fold_ms": res["fold"].get("ms")}
            if kernel_times:
                res[key]["ms"], res[key]["f32_io_ms"] = time_pair_ms(
                    lambda key=key: kernel(key, False), lambda key=key: kernel(key, True), iters)
        if timed:
            plain = time_ms(lambda: flash_attention.flash_attention_bwd_ref(
                q, k, v, o, lse, do, lens, prec), plain_iters, plain_warmup)
            qb, kb, vb = (x.detach().transpose(1, 2).contiguous().requires_grad_()
                          for x in (q, kf, vf))
            out = F.scaled_dot_product_attention(up_lib(qb), up_lib(kb), up_lib(vb),
                                                 attn_mask=mask)
            # the pair through its wrapper (prologue and Di included) in turns
            # with the yardstick
            pair, lib = time_pair_ms(
                lambda: grads(q, k, v, o, lse, do, lens),
                lambda: torch.autograd.grad(out, (qb, kb, vb), up_lib(do.transpose(1, 2)),
                                            retain_graph=True), 3 if t > 1024 else 5, rounds=10)
            for key in ("dq", "dkv"):
                res[key] |= {"plain_ms": plain, "library_ms": lib, "pair_ms": pair,
                             "pair_bound_ms": bounds["dq"][0] + bounds["dkv"][0]}
    res["checks"] = checks
    if not all(checks.values()):
        fail(f"flash bf16 I/O {prec} [{b}, {t}, {h}, {d}] lengths {lengths[:4]}...: {checks}; "
             f"fwd {res['fwd']}; bwd {[res.get(k) for k in ('dq', 'dkv')]}")
    fwd = res["fwd"]
    if bf16_ops:
        line = (f"  flash bf16 I/O {prec} [{b}, {t}, {h}, {d}] keys {int(lens.sum())}: "
                f"bf16(f32 flavour) bit-equal, NaN past the bound changes nothing; ")
    else:
        near = fwd["vs_f32_flavour"]
        line = (f"  flash bf16 I/O {prec} [{b}, {t}, {h}, {d}] keys {int(lens.sum())}: "
                f"NaN past the bound changes nothing; {tags[0]} O vs bf16(f32 flavour): share "
                f"differing {near['share_differ']:.3g}, at most {near['max_steps']:.3g} bf16 "
                f"steps; |LSE - LSE_f64| {fwd['lse_max_abs_err_vs_f64']:.3g} (K1's "
                f"{fwd['f32_flavour_lse_max_abs_err_vs_f64']:.3g}); ")
    line += (f"{tags[0]} O vs plain max|d| "
             f"{fwd['max_abs_err']:.3g}, vs f64 {fwd['max_abs_err_vs_f64']:.3g} (plain "
             f"{fwd['plain_max_abs_err_vs_f64']:.3g})")
    if kernel_times:
        line += (f"; {tags[0]} {fwd['ms']:.4f} ms (f32 I/O {fwd['f32_io_ms']:.4f}, bound "
                 f"{b_ms:.4f} {b_by}")
        if not bf16_ops:
            line += f", f32-FMA bound {fwd['f32_fma_bound_ms']:.4f}"
        line += (f"; kernel alone {fwd['kernel_ms']:.4f}, prologue "
                 f"{res['fwd_fold']['ms']:.4f})")
    if bwd:
        rel = max(res["dq"]["max_rel_err"], res["dkv"]["max_rel_err"])
        norm = max(res["dq"]["norm_rel_err"], res["dkv"]["norm_rel_err"])
        line += f"; {tags[1]}/{tags[2]} vs plain max|d|/max|g| {rel:.3g}, ||d||/||g|| {norm:.3g}"
        if "bwd_vs_f32_flavour" in res:
            near = res["bwd_vs_f32_flavour"]
            line += ("; vs the f32 flavour rounded once: share differing " + ", ".join(
                f"{n} {v['share_differ']:.3g}" for n, v in near.items()) + f", at most "
                f"{max(v['max_steps'] for v in near.values()):.3g} bf16 steps; recomputed P: "
                f"|LSE - LSE_f64| {res['recompute']['lse_max_abs_err_vs_f64']:.3g}, "
                f"|S - S_f64|/8 {res['recompute']['scores_max_abs_err_vs_f64']:.3g}")
        if kernel_times:
            line += (f"; {tags[1]} {res['dq']['ms']:.4f} ms (f32 I/O {res['dq']['f32_io_ms']:.4f}, "
                     f"bound {res['dq']['bound_ms']:.4f}), {tags[2]} {res['dkv']['ms']:.4f} ms (f32 I/O "
                     f"{res['dkv']['f32_io_ms']:.4f}, bound {res['dkv']['bound_ms']:.4f})")
            if "f32_fma_bound_ms" in res["dq"]:
                line += (f", f32-FMA bounds {res['dq']['f32_fma_bound_ms']:.4f} + "
                         f"{res['dkv']['f32_fma_bound_ms']:.4f}")
            if "fold" in res:
                line += (f", prologue {res['fold']['ms']:.4f} ms (f32 I/O "
                         f"{res['fold']['f32_io_ms']:.4f}, bound {res['fold']['bound_ms']:.4f})")
    if timed:
        lib_io = "bf16" if bf16_ops else "f32"
        line += f"; plain fwd {fwd['plain_ms']:.4f} ms, sdpa {lib_io} {fwd['library_ms']:.4f}"
        if bwd:
            line += (f"; plain bwd pair {res['dq']['plain_ms']:.4f} ms; in turns the pair "
                     f"through flash_attention_bwd {res['dq']['pair_ms']:.4f} (the work's bound "
                     f"{res['dq']['pair_bound_ms']:.4f}), sdpa {lib_io} grad "
                     f"{res['dq']['library_ms']:.4f}")
    print(line, flush=True)
    return res


def check_bf16io_shapes() -> None:
    """The bf16-I/O flavours at the fast_bf16 paths' shapes: K5 at the
    evals' [96 x 511, 768] and the train step's [24 x 499, 768]; K1b at
    [96, 511] (the evals' engine, lengths to 499), K1b + K2b + K3b at [24,
    499] (the rates-at-0 step) and a ragged [8, 4095], K2b + K3b at the
    loss crop [32, 50], untimed at every tile edge; each with a full, a
    ragged, a 1-key and a 0-key row."""
    g = torch.Generator().manual_seed(13)
    rng = np.random.default_rng(13)

    def rows(b, t, n=None):
        return [t, t // 2, 1, 0] + [n or t] * (b - 4)

    main_lens = [511, 1, 0] + list(rng.integers(2, 511, size=9)) + [499] * 84
    ln = {"main": check_layernorm_bf16io(96 * 511, 768, g),
          "train": check_layernorm_bf16io(24 * 499, 768, g)}
    fl = {"main": check_flash_bf16io(96, 511, main_lens, g, timed=True, bwd=False),
          "train": check_flash_bf16io(LOSS10_BATCH, 499, rows(LOSS10_BATCH, 499), g, timed=True),
          "loss": check_flash_bf16io(LOSS_BATCH, 50, rows(LOSS_BATCH, 50), g, timed=True),
          "long": check_flash_bf16io(8, 4095, [4095, 4000, 3001, 2048, 1025, 64, 1, 0], g,
                                     timed=False)}
    # the tiles' edges, then K1b's ring's (K2b/K3b's ring edges among them)
    for t in (1, 15, 16, 17, 63, 64, 65, 511) + K1B_RING_EDGES:
        fl[f"edge_T{t}"] = check_flash_bf16io(4, t, [t, max(t // 2, 1), 1, 0], g, timed=False,
                                              kernel_times=False)
    report["kernels"]["layernorm_fwd_bf16io"] = ln
    report["kernels"]["flash_attention_bf16io_fwd"] = {k: r["fwd"] | {"shape": r["shape"]}
                                                       for k, r in fl.items()}
    report["kernels"]["flash_attention_fwd_fold_bf16io"] = {
        k: r["fwd_fold"] | {"shape": r["shape"]} for k, r in fl.items()}
    for key, name in (("dq", "flash_attention_bwd_dq_bf16io"),
                      ("dkv", "flash_attention_bwd_dkv_bf16io"),
                      ("fold", "flash_attention_bwd_fold_bf16io")):
        # the path's shape, [24, 499], is the row's "main"
        report["kernels"][name] = {("main" if k == "train" else k): r[key] | {"shape": r["shape"]}
                                   for k, r in fl.items() if key in r}


FAST_BF16_LAUNCHES = {
    "train_step": launches_want(k5=2, k5_io=48),
    "eval_step": launches_want(k1b_io=12, k5=2, k5_io=24),
    "train_step_rates0": launches_want(k1b_io=24, k2b_io=12, k3b_io=12, k5=2, k5_io=48)}


def fast_steps(card: str, cfg: dict, batch, init: dict) -> dict:
    """"fast" beside fast_bf16 in the same run: the recipe's step (one
    profiled), the rates-at-0 step and the eval step, their times,
    enqueue and peak memory."""
    out: dict = {}
    tr, out["loss"], _, _ = first_train_step("train_step_fast_p13", dict(cfg, precision="fast"),
                                             batch, MODE_STEP_LAUNCHES["train_step"], init)
    out["train_step"] = time_train_steps(card, "train_step fast (dropout, remat)", tr, batch)
    with profiler_range(wav2vec2, "mha_dropout", PLAIN_ATTENTION):
        profile_run(lambda: tr.train_step(batch, step_gen()), "profile_train_step_fast_p13",
                    split=ranged_kernels(PLAIN_ATTENTION, "plain attention (products, "
                                         "softmax, dropout; fwd + bwd)"))
    out["eval_step"] = time_steps(lambda: tr.eval_step(batch), TRAIN_STEPS, card,
                                  "trainer: eval_step fast")
    release(tr)
    tr, _, _, _ = first_train_step("train_step_rates0_fast_p13", cfg, batch,
                                   MODE_STEP_LAUNCHES["train_step_rates0"], init,
                                   mode_config("fast", **ZERO_RATES))
    out["train_step_rates0"] = time_train_steps(card, "train_step fast (rates at 0, remat)",
                                                tr, batch)
    release(tr)
    return out


def fast_bf16_engine(card: str, cfg: dict, init: dict) -> dict:
    """The evals' engine on a ``fast_bf16`` Training (its
    ``get_embeddings_csv``'s route) over the recipe's 24 utterances: the
    launches of a pass (K1b-bf16 12, K5 2, K5-bf16 24 a batch), warm pass
    time; the f32 embeddings held to the fast_bf16 plain path's within
    TOL_REF_PATH + GRAD_MODE_FRAC times that path's distance to the
    "exact" plain path (phase 12's rule); then ``eval_audio_quality``
    through it, finite."""
    paths = sorted(str(p) for p in Path(cfg["root"]).iterdir())
    tr = Training(dict(cfg, precision="fast_bf16"), device="cuda", params=init)
    engine = tr._engine()
    reset_launches()
    emb = engine.embed_files_device(paths)
    torch.cuda.synchronize()
    counts = read_launches()
    batches = engine.batches
    report["launches"]["eval_engine_fast_bf16"] = counts
    want = launches_want(k1b_io=12 * batches, k5=2 * batches, k5_io=24 * batches)
    waves = engine.load_waves(paths)
    passes = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.embed_waves_device(waves)
        torch.cuda.synchronize()
        passes.append(time.perf_counter() - t0)
    plain = {}
    for mode in ("fast_bf16", "exact"):
        ptr = Training(dict(cfg, precision=mode), device="cuda", params=init,
                       model_config=plain_config(mode))
        with plain_flash(mode):
            plain[mode] = ptr._engine().embed_waves_device(waves)
        release(ptr)
    d_plain = (plain["fast_bf16"] - plain["exact"]).abs().max().item()
    d = (emb - plain["fast_bf16"]).abs().max().item()
    tol = TOL_REF_PATH + GRAD_MODE_FRAC * d_plain
    quality = tr.eval_audio_quality(None, plot=False)
    release(tr)
    res = {"files": len(paths), "batches": batches, "launches": counts, "pass_s": passes,
           "vs_fast_bf16_plain_path_emb": d, "fast_bf16_plain_vs_exact_plain_emb": d_plain,
           "tolerance": tol, "eval_audio_quality": quality, "card": card}
    print(f"fast_bf16: the evals' engine, {len(paths)} files in {batches} batches: launches "
          f"{counts}; warm pass {float(np.median(passes)) * 1e3:.1f} ms; max|d emb| vs the "
          f"fast_bf16 plain path {d:.3g} (<= {tol:.3g}: {TOL_REF_PATH} + {GRAD_MODE_FRAC} x "
          f"{d_plain:.3g}); eval_audio_quality {quality}  [{card}]", flush=True)
    finite = bool(torch.isfinite(emb).all()) and emb.dtype == torch.float32 and all(
        np.isfinite(v) for r in quality.values() for v in r.values())
    if counts != want or batches == 0 or not finite or d > tol:
        fail(f"fast_bf16 engine: launches {counts} for {batches} batches (want {want}), "
             f"finite f32={finite}, max|d emb| vs plain {d:.3g} (> {tol:.3g}?)")
    return res


def run_fast_bf16(card: str) -> None:
    """Phase 13: the bf16-I/O flavours against their f32-I/O flavour,
    their plain version and float64 at their shapes; then the triplet
    recipe with ``precision: fast_bf16`` on phase 10's seeded BASE state
    dict (phase 10's checks, remat on and off the same loss), the evals'
    engine, and "fast" beside it."""
    report.setdefault("launches", {})
    t_phase = time.perf_counter()
    print("fast_bf16: the bf16-I/O flavours vs their f32-I/O flavour and plain versions:",
          flush=True)
    check_bf16io_shapes()
    sd = SHARED.get("sd10")
    if sd is None:  # phase 13 alone: the seeded init phase 10 makes
        sd = init_weights(NomadModel(Wav2Vec2Config.base(), emb_dim=256), seed=0).state_dict()
    out: dict = {"card": card}
    with tempfile.TemporaryDirectory(prefix="nomad_fast_bf16_") as tmp:
        cfg = write_train_tree(Path(tmp))
        ds = train_data.TripletDataset(cfg, "train_df", level=cfg["current_level"])
        batch = train_data._pinned(train_data.collate_triplets(
            [ds.load_item(i) for i in range(cfg["train_bs"])]))
        res = mode_train_steps(card, "fast_bf16", cfg, batch, sd, FAST_BF16_LAUNCHES)
        tr, loss_nr, _, _ = first_train_step(
            "train_step_fast_bf16_no_remat", dict(cfg, precision="fast_bf16", remat=False),
            batch, launches_want(k5=2, k5_io=24), sd)
        res["train_step_no_remat"] = time_train_steps(
            card, "train_step fast_bf16 (dropout, no remat)", tr, batch)
        release(tr)
        d = abs(res["loss"] - loss_nr) / abs(res["loss"])
        res["remat_vs_no_remat_loss_rel"] = d
        print(f"fast_bf16: dropout on, remat on vs off: loss {res['loss']:.8g} vs {loss_nr:.8g} "
              f"(rel {d:.3g})", flush=True)
        if d > 1e-6:
            fail(f"fast_bf16: remat on and off give other losses for one seed (rel {d:.3g})")
        res["eval_engine"] = fast_bf16_engine(card, cfg, sd)
        out["fast_bf16"] = res
        out["fast"] = fast_steps(card, cfg, batch, sd)
    for key in ("train_step", "train_step_rates0", "eval_step"):
        a, b = out["fast_bf16"][key], out["fast"][key]
        print(f"fast_bf16 vs fast, {key}: {a['events_median_ms']:.2f} vs "
              f"{b['events_median_ms']:.2f} ms (CUDA events), enqueue "
              f"{a['host_enqueue_median_s'] * 1e3:.2f} vs {b['host_enqueue_median_s'] * 1e3:.2f} "
              f"ms, peak {a['peak_mem_gb']:.2f} vs {b['peak_mem_gb']:.2f} GB  [{card}]", flush=True)
    out["phase_s"] = time.perf_counter() - t_phase
    report["fast_bf16"] = out
    print(f"fast_bf16: phase 13 took {out['phase_s']:.1f} s", flush=True)


# ---------------- phase 14: bf16 activations on every attention path ----------------


def fused_f64_of(x, params, lengths, heads: int, rounded: bool) -> torch.Tensor:
    """The fused kernel's float64 oracle: ``fused_f64`` (K4b: x and the
    weights rounded to bf16, ``rounded``) or the same of the unrounded
    operands (K4)."""
    if rounded:
        return fused_f64(x, params, lengths, heads)
    b, t, dm = x.shape
    xd = x.double()
    q, k, v = (F.linear(xd, w.double(), bias.double()).view(b, t, heads, -1)
               for w, bias in zip(params[0::2], params[1::2]))
    return attention_f64(q, k, v, lengths).transpose(1, 2)


def check_fused_bf16io(b: int, t: int, lengths: list, g: torch.Generator, timed: bool,
                       prec: str, kernel_time: bool = True) -> dict:
    """K4-bf16 (``prec`` "highest") or K4h's ("high") or K4b's ("default")
    bf16-I/O flavour on a bf16 x at unit scale, zero past each bound, with
    the f32 weights at the seeded init's scale: O bf16, K4h's and K4b's
    bit-equal to the f32-I/O flavour's on the upcast x rounded once,
    K4-bf16's (K4's products on the tensor cores, summed in another order)
    within one bf16 step of K4's on the upcast x rounded once, beyond
    FWD_F32_PLAIN_REL of its max |O|, the share of elements that differ
    reported, and its prologue's three weight planes bit-equal to
    ``pack_weights_ref(..., planes=3)``; a 0-key row O = 0;
    against the plain version on the same bf16 x and float64
    (``fused_f64_of``): |O - O_f64| <= 1.5 x the plain version's + 1.5
    bf16 steps at its max + 1e-6 (phase 13's rule for outputs rounded
    once); NaN past each bound the same bits in
    every valid row, 123.0 there every row finite and the valid rows the
    same bits; a rerun the same bits. Timed beside the f32-I/O flavour;
    ``timed``: the plain version and the yardstick too, the flavour's own
    function in library calls: at "default" ``F.linear`` of x with the
    rounded weights and SDPA on bf16, at "highest" the f32 product of the
    upcast x with the f32 weights (TF32 off) and f32 SDPA, and at "high"
    the same (no PyTorch call computes bf16 x 3). At "highest" the bound
    counts K4-bf16's passes on the bf16 tensor cores (3 for the
    projections, 6 for each attention product); the f32-FMA bound of K4's
    work beside it."""
    h, dm = 12, 768
    bf = torch.bfloat16
    bf16_ops = prec_ops.is_bf16(prec)
    tag = {"highest": "K4-bf16", "high": "K4h", "default": "K4b"}[prec]
    x = torch.randn(b, t, dm, generator=g)
    params = [a.to(DEV) for _ in range(3) for a in (
        torch.randn(dm, dm, generator=g) / dm**0.5, 0.1 * torch.randn(dm, generator=g))]
    for i, n in enumerate(lengths):
        x[i, n:] = 0.0
    x = x.to(DEV).to(bf)
    x32 = x.float()
    lens = torch.tensor(lengths, dtype=torch.int32, device=DEV)

    def kernel(xx=x):
        return fused_attention.fused_qkv_mha(xx, *params, lens, h, prec)

    o = kernel()
    o32 = kernel(x32)
    ref = fused_attention.fused_qkv_attention_ref(x, *params, lens, h, prec)
    torch.cuda.synchronize()
    checks = {"dtype": o.dtype == bf, "finite": bool(torch.isfinite(o).all()),
              "zero_key_rows": all(bool((o[i] == 0).all()) for i, n in enumerate(lengths)
                                   if n == 0)}
    near_info = None
    if prec == "highest":  # K4-bf16: the tensor core's order, within one bf16 step
        checks["within_one_bf16_step_of_f32_flavour"], near_info = near_one_step(
            o, o32, FWD_F32_PLAIN_REL)
        ws = fused_attention._bf16_workspace(x, h, planes=3)
        alone = fused_attention._launch(prec, x, *params, lens, h, workspace=ws)
        torch.cuda.synchronize()
        checks["prologue_packs_three_planes"] = torch.equal(
            ws[0], fused_attention.pack_weights_ref(*params[0::2], h, planes=3))
        checks["workspace_call_same_bits"] = torch.equal(alone, o)
        del ws, alone
    else:  # one body on the same bits: the f32 flavour's, rounded once
        checks["bit_equal_f32_flavour"] = torch.equal(o, o32.to(bf))
    del o32
    err = (o.float() - ref.float()).abs().max().item()
    err_f64 = err_plain_f64 = 0.0
    excess = float("-inf")
    for i in range(b):  # one batch row at a time: [1, H, T, T] in float64
        sl = slice(i, i + 1)
        exact = fused_f64_of(x32[sl], params, lens[sl], h, bf16_ops)
        e = (o[sl].double() - exact).abs().max().item()
        ep = (ref[sl].double() - exact).abs().max().item()
        step = BF16_ULP_REL * exact.abs().max().item()
        excess = max(excess, e - (1.5 * ep + 1.5 * step + 1e-6))
        err_f64, err_plain_f64 = max(err_f64, e), max(err_plain_f64, ep)
        del exact
    checks["vs_plain_and_f64"] = excess <= 0
    checks["rerun_same_bits"] = torch.equal(kernel(), o)
    checks["garbage_past_bound"] = garbage_past_bound_ok(kernel, x, o, lengths)
    if not all(checks.values()):
        fail(f"fused bf16 I/O {prec} [{b}, {t}, {dm}] lengths {lengths[:8]}: {checks}; "
             f"max|O - O_f64| {err_f64:.3g} beyond 1.5 x the plain version's "
             f"{err_plain_f64:.3g} + 1.5 bf16 steps + 1e-6 by {excess:.3g}")
    del ref
    # the passes on the bf16 tensor cores: K4h three, two for the
    # projections of a bf16 x; K4-bf16 three for the projections and six for
    # each attention product
    passes = {"high": (2, 3), "highest": (3, 6), "default": (1, 1)}[prec]
    b_ms, b_by = fused_bound(b, t, h, dm, lens, BF16_FLOPS, x_bytes=2, passes=passes)
    res = {"shape": [b, t, dm], "heads": h, "lengths_sum": int(lens.sum()),
           "max_abs_err": err, "max_abs_err_vs_f64": err_f64,
           "plain_max_abs_err_vs_f64": err_plain_f64, "bound_ms": b_ms, "bound_by": b_by}
    if prec == "highest":
        res |= dict(zip(("f32_fma_bound_ms", "f32_fma_bound_by"),
                        fused_bound(b, t, h, dm, lens, F32_FLOPS, x_bytes=2)))
        res |= {"vs_f32_flavour": near_info,
                "ratio_to_plain_vs_f64": err_f64 / max(err_plain_f64, 1e-30)}
    if kernel_time:
        x32c = x32.contiguous()
        res["ms"], res["f32_io_ms"] = time_pair_ms(kernel, lambda: kernel(x32c), 20)
    if timed:
        # the yardstick computes the flavour's function: at "default" a bf16
        # product of x and the rounded weights, SDPA on bf16; at "highest"
        # the f32 product of the upcast x (inside the timed call) and the
        # f32 weights (TF32 off), then f32 SDPA
        wqkv = torch.cat(params[0::2])
        bqkv = torch.cat(params[1::2])
        if bf16_ops:
            wqkv, bqkv = wqkv.to(bf), bqkv.to(bf)
        mask = None
        if int(lens.min()) < t:
            mask = (torch.arange(t, device=DEV)[None, :] < lens[:, None])[:, None, None, :]

        def library():
            xx = x if bf16_ops else x.float()
            qq, kk, vv = F.linear(xx, wqkv, bqkv).view(b, t, 3, h, 64).permute(2, 0, 3, 1, 4)
            return F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask)

        res["plain_ms"] = time_ms(lambda: fused_attention.fused_qkv_attention_ref(
            x, *params, lens, h, prec), 5)
        res["library_ms"] = time_ms(library, 10)
    vs_f32 = ("bf16(f32 flavour) bit-equal" if near_info is None else
              f"vs bf16(f32 flavour): share differing {near_info['share_differ']:.3g}, at most "
              f"{near_info['max_steps']:.3g} bf16 steps, three weight planes bit-equal to "
              f"pack_weights_ref, f32-FMA bound {res['f32_fma_bound_ms']:.4f}")
    print(f"  fused bf16 I/O {prec} [{b}, {t}, {dm}] keys {int(lens.sum())}: {vs_f32}, "
          f"garbage past the bound changes no valid row; {tag} O vs plain max|d| "
          f"{err:.3g}, vs f64 {err_f64:.3g} (plain {err_plain_f64:.3g}); {tag} "
          f"{res.get('ms', float('nan')):.4f} ms (f32 I/O {res.get('f32_io_ms', float('nan')):.4f})"
          f"  plain {res.get('plain_ms', float('nan')):.4f}  F.linear + sdpa "
          f"{'bf16' if bf16_ops else 'f32'} {res.get('library_ms', float('nan')):.4f}  bound "
          f"{b_ms:.4f} ({b_by})", flush=True)
    return res


def check_bf16_paths_shapes() -> None:
    """The six bf16-I/O flavours at their paths' shapes: K4-bf16, K4h and
    K4b at the scoring shape [96, 511] (lengths to 499, a 1-key and a 0-key
    row), the loss crop [32, 50], a ragged [8, 1024] and every plan edge;
    K1-bf16 at [96, 511], [24, 499] (with K2-bf16 and K3-bf16: the loss on
    10 s clips) and a ragged [8, 4095] (with them, timed); K2-bf16 and
    K3-bf16 at the loss crop [32, 50] too; K1-bf16, K2-bf16 and K3-bf16
    untimed at every tile edge and every edge of the 4- and 3-stage rings;
    each edge with a full, a ragged, a 1-key and a 0-key row."""
    g = torch.Generator().manual_seed(14)
    rng = np.random.default_rng(14)

    def rows(b, t, n=None):
        return [t, t // 2, 1, 0] + [n or t] * (b - 4)

    main_lens = [511, 1, 0] + list(rng.integers(2, 511, size=9)) + [499] * 84
    for prec, name in (("highest", "fused_qkv_attention_f32_bf16io_fwd"),
                       ("default", "fused_qkv_attention_bf16io_fwd"),
                       ("high", "fused_qkv_attention_high3_bf16io_fwd")):
        res = {"main": check_fused_bf16io(96, 511, main_lens, g, True, prec),
               "loss": check_fused_bf16io(LOSS_BATCH, 50, rows(LOSS_BATCH, 50), g, True, prec),
               "ragged": check_fused_bf16io(8, 1024, [1024, 1023, 777, 513, 512, 64, 1, 0], g,
                                            True, prec)}
        for t in (1, 15, 16, 17, 63, 64, 65, 511, 1023, 1024):
            res[f"edge_T{t}"] = check_fused_bf16io(4, t, [t, max(t // 2, 1), 1, 0], g, False,
                                                   prec, kernel_time=False)
        report["kernels"][name] = res
    fl = {"main": check_flash_bf16io(96, 511, main_lens, g, timed=True, bwd=False,
                                     prec="highest"),
          "train": check_flash_bf16io(LOSS10_BATCH, 499, rows(LOSS10_BATCH, 499), g, timed=True,
                                      prec="highest"),
          "loss": check_flash_bf16io(LOSS_BATCH, 50, rows(LOSS_BATCH, 50), g, timed=True,
                                     prec="highest"),
          "long": check_flash_bf16io(8, 4095, [4095, 4000, 3001, 2048, 1025, 64, 1, 0], g,
                                     timed=True, prec="highest")}
    for t in (1, 15, 16, 17, 63, 64, 65, 511) + K1B_RING_EDGES:
        fl[f"edge_T{t}"] = check_flash_bf16io(4, t, [t, max(t // 2, 1), 1, 0], g, timed=False,
                                              kernel_times=False, prec="highest")
    report["kernels"]["flash_attention_f32_bf16io_fwd"] = {
        k: r["fwd"] | {"shape": r["shape"]} for k, r in fl.items()}
    for key, name in (("dq", "flash_attention_bwd_dq_f32_bf16io"),
                      ("dkv", "flash_attention_bwd_dkv_f32_bf16io")):
        # the paths' shapes: the loss crop "main", [24, 499] (10 s clips) "train"
        report["kernels"][name] = {("main" if k == "loss" else k): r[key] | {"shape": r["shape"]}
                                   for k, r in fl.items() if key in r}


def bf16_plain_paths(mode: str, sd: dict, waves: list, impl: str, **kw) -> tuple:
    """A bf16 mode's plain path (``impl``'s attention through its plain
    versions, plain LayerNorm; ``kw``: other fields of its config) and the
    "exact" plain path, embedded on the same waves."""
    with plain_flash(mode):
        plain = Nomad(device="cuda", config=plain_config(mode, attention_impl=impl, **kw),
                      params=sd)
        emb = plain.engine.embed_waves_device(waves)
    del plain
    exact = Nomad(device="cuda", config=plain_config(), params=sd)
    exact_emb = exact.engine.embed_waves_device(waves)
    del exact
    return emb, exact_emb


def bf16_path_vs_plain(what: str, emb: torch.Tensor, plain: torch.Tensor,
                       exact_plain: torch.Tensor) -> dict:
    """Phase 12's rule: a bf16 path's f32 embeddings, finite, within
    TOL_REF_PATH + GRAD_MODE_FRAC times its plain path's distance to the
    "exact" plain path."""
    d_plain = (plain - exact_plain).abs().max().item()
    d = (emb - plain).abs().max().item()
    tol = TOL_REF_PATH + GRAD_MODE_FRAC * d_plain
    print(f"{what}: max|d emb| vs its plain path {d:.3g} (<= {tol:.3g}: {TOL_REF_PATH} + "
          f"{GRAD_MODE_FRAC} x {d_plain:.3g})", flush=True)
    if emb.dtype != torch.float32 or not torch.isfinite(emb).all() or d > tol:
        fail(f"{what}: embeddings {emb.dtype}, finite={bool(torch.isfinite(emb).all())}, "
             f"vs its plain path {d:.3g} > {tol:.3g}?")
    return {"vs_plain_path_emb": d, "plain_vs_exact_plain_emb": d_plain, "tolerance": tol}


def run_bf16_scoring(card: str, sd: dict, tmp: Path, nmr: str, deg: str) -> dict:
    """``Nomad(config=Wav2Vec2Config.fast(encoder_dtype=bf16,
    attention_impl="fused_qkv"))`` on phase 4's files: launch counts of a
    predict (K4b-bf16 12, K5 2, K5-bf16 24 per batch), warm device passes
    beside phase 12's fused "fast" pass (f32 activations) in this run, own
    peak, one profiled pass, and the embeddings against its plain path by
    phase 12's rule; then ``balanced(encoder_dtype=bf16,
    attention_impl="fused_qkv")`` (K4h-bf16 12), the same at "exact" with
    the frontend and the encoder at "highest" (K4-bf16 12) and
    ``base(encoder_dtype=bf16)`` (K1-bf16 12) on one batch of 96 files,
    each against its plain path by the same rule."""
    total_s = (N_NMR + N_DEG) * SECONDS
    leftover_gb = settled_allocated_gb()
    nomad = Nomad(device="cuda", params=sd,
                  config=mode_config("fast_bf16", attention_impl="fused_qkv"))
    out = tmp / "fused_fast_bf16"
    out.mkdir()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    nomad.predict("dir", nmr, deg, str(out))
    torch.cuda.synchronize()
    counts = read_launches()
    batches = nomad.engine.batches
    report["launches"]["scoring_fused_fast_bf16"] = counts
    want = launches_want(k4b_io=12 * batches, k5=2 * batches, k5_io=24 * batches)
    if counts != want or batches == 0:
        fail(f"fused fast bf16: launch counts {counts} for {batches} batches (want {want})")
    check_csvs(out, "fused fast bf16 API")
    paths = sorted(Path(nmr).iterdir()) + sorted(Path(deg).iterdir())
    waves = nomad.engine.load_waves([str(p) for p in paths])
    emb, passes = timed_passes(nomad, waves)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    profile_run(lambda: nomad.engine.embed_waves_device(waves), "profile_fused_fast_bf16")
    del nomad
    fused_fast = Nomad(device="cuda", precision="fast", params=sd,
                       config=mode_config("fast", attention_impl="fused_qkv"))
    _, passes_f32 = timed_passes(fused_fast, waves)
    del fused_fast
    pass_s, pass_f32_s = float(np.median(passes)), float(np.median(passes_f32))
    plain, exact_plain = bf16_plain_paths("fast_bf16", sd, waves, "fused_qkv")
    res = {"files": N_NMR + N_DEG, "batches": batches, "pass_s": passes,
           "wav_s_per_s_pass": total_s / pass_s, "fused_fast_pass_s": passes_f32,
           "fused_fast_wav_s_per_s_pass": total_s / pass_f32_s, "peak_mem_gb": peak_gb,
           "leftover_mem_gb": leftover_gb, "own_peak_mem_gb": peak_gb - leftover_gb, "card": card}
    print(f"fused fast bf16: {batches} batches, launches {counts}; device pass {pass_s:.3f} s = "
          f"{total_s / pass_s:.1f} wav-s/s (fused fast, f32 activations, in this run: "
          f"{pass_f32_s:.3f} s = {total_s / pass_f32_s:.1f} wav-s/s); own peak "
          f"{res['own_peak_mem_gb']:.5f} GB  [{card}]", flush=True)
    res |= bf16_path_vs_plain("fused fast bf16", emb, plain, exact_plain)
    del emb, plain, exact_plain
    highest = {"frontend_precision": "highest", "encoder_precision": "highest"}
    for mode, impl, key, want, kw in (
            ("balanced_bf16", "fused_qkv", "fused_balanced_bf16",
             launches_want(k4h_io=12, k5=2, k5_io=24), {}),
            ("exact_bf16", "fused_qkv", "fused_highest_bf16",
             launches_want(k4_io=12, k5=2, k5_io=24), highest),
            ("exact_bf16", "kernel", "base_bf16", launches_want(k1_io=12, k5=2, k5_io=24), {})):
        one = waves[:96]
        model = Nomad(device="cuda", params=sd,
                      config=mode_config(mode, attention_impl=impl, **kw))
        reset_launches()
        emb = model.engine.embed_waves_device(one)
        torch.cuda.synchronize()
        counts = read_launches()
        report["launches"][f"scoring_{key}"] = counts
        print(f"{key}: one batch of {len(one)} files, launches {counts} (want {want})",
              flush=True)
        if counts != want:
            fail(f"{key}: launch counts {counts} (want {want})")
        del model
        plain, exact_plain = bf16_plain_paths(mode, sd, one, impl, **kw)
        res[key] = bf16_path_vs_plain(key, emb, plain, exact_plain)
        del emb, plain, exact_plain
    return res


BF16_PATH_LAUNCHES = {
    "train_step": launches_want(k5=2, k5_io=48),
    "eval_step": launches_want(k4b_io=12, k5=2, k5_io=24),
    "train_step_rates0": launches_want(k4b_io=24, k1b_io=12, k2b_io=12, k3b_io=12, k5=2,
                                       k5_io=48)}


def fused_fast_bf16_steps(card: str, cfg: dict, batch, init: dict) -> dict:
    """``Training(model_config=fast_bf16's config with attention_impl=
    "fused_qkv")`` at phase 13's recipe (remat on): the recipe's step (the
    plain dropout attention, as the JAX package's ``use_fused`` falls back:
    K5 only), its eval step and the step with the rates at 0 (K4b-bf16,
    its backward through K1b-bf16 + K2b-bf16 + K3b-bf16), each with its
    launch counts and warm times; then the rates-at-0 comparison with the
    fused fast_bf16 plain path by phase 10's rule."""
    out: dict = {}
    config = dataclasses.replace(
        triplet.resolve_model_config(dict(cfg, precision="fast_bf16")),
        attention_impl="fused_qkv")
    tr, out["loss"], _, _ = first_train_step(
        "train_step_fused_fast_bf16", dict(cfg, precision="fast_bf16"), batch,
        BF16_PATH_LAUNCHES["train_step"], init, config)
    out["train_step"] = time_train_steps(card, "train_step fused fast_bf16 (dropout, remat)",
                                         tr, batch)
    reset_launches()
    tr.eval_step(batch)
    counts = read_launches()
    report["launches"]["eval_step_fused_fast_bf16"] = counts
    if counts != BF16_PATH_LAUNCHES["eval_step"]:
        fail(f"trainer fused fast_bf16: eval step launch counts {counts} "
             f"(want {BF16_PATH_LAUNCHES['eval_step']})")
    out["eval_step"] = time_steps(lambda: tr.eval_step(batch), TRAIN_STEPS, card,
                                  "trainer: eval_step fused fast_bf16")
    emb_dim = tr.emb_dim
    release(tr)
    tr, _, _, _ = first_train_step(
        "train_step_rates0_fused_fast_bf16", cfg, batch, BF16_PATH_LAUNCHES["train_step_rates0"],
        init, dataclasses.replace(config, **ZERO_RATES))
    out["train_step_rates0"] = time_train_steps(
        card, "train_step fused fast_bf16 (rates at 0, remat)", tr, batch)
    profile_run(lambda: tr.train_step(batch, step_gen()),
                "profile_train_step_rates0_fused_fast_bf16")
    release(tr)
    out["rates0_kernel_vs_plain"] = rates0_vs_plain("fast_bf16", cfg, batch, init, emb_dim,
                                                    attention_impl="fused_qkv")
    return out


def run_bf16_paths(card: str) -> None:
    """Phase 14: K4-bf16, the bf16-I/O flavours of K4h and K4b, K1-bf16,
    K2-bf16 and K3-bf16 against their f32-I/O flavour, their plain version
    and float64 at their shapes;
    then on phase 12's and 13's seeded BASE state dicts the scoring path
    ``fast(encoder_dtype=bf16, attention_impl="fused_qkv")`` (the main
    path), "balanced" with ``fused_qkv`` and BASE on bf16 activations; the
    loss of the three at 32 x 16,384 and 24 x 160,000 samples; and the
    trainer's fast_bf16 on the fused path."""
    report.setdefault("launches", {})
    t_phase = time.perf_counter()
    print("bf16 paths: K4-bf16, K4h-bf16, K4b-bf16, K1-bf16, K2-bf16 and K3-bf16 vs their f32 "
          "flavour and plain versions:", flush=True)
    check_bf16_paths_shapes()
    sd = SHARED.get("sd")
    if sd is None:  # phase 14 alone: Nomad's seeded init, as phase 9 makes it
        sd = init_weights(NomadModel(Wav2Vec2Config.base(), emb_dim=256), seed=0).state_dict()
    out: dict = {"card": card}
    with tempfile.TemporaryDirectory(prefix="nomad_bf16_paths_") as tmp:
        tmp = Path(tmp)
        nmr, deg = write_wavs(tmp)
        out["scoring"] = run_bf16_scoring(card, sd, tmp, nmr, deg)
    # the loss: both forwards on the kernel, the estimate's backward through
    # the recompute (fused: K1's flavour + K2 + K3) or K2 + K3
    for mode, impl, tag, want in (
            ("fast_bf16", "fused_qkv", "fused_fast_bf16",
             launches_want(k4b_io=24, k1b_io=12, k2b_io=12, k3b_io=12, k5=4, k5_io=48)),
            ("exact_bf16", "kernel", "base_bf16",
             launches_want(k1_io=24, k2_io=12, k3_io=12, k5=4, k5_io=48)),
            ("exact_bf16", "fused_qkv", "fused_base_bf16",
             launches_want(k4h_io=24, k1_io=12, k2_io=12, k3_io=12, k5=4, k5_io=48))):
        config = mode_config(mode, attention_impl=impl)
        for key, n, samples in ((f"loss_path_{tag}", LOSS_BATCH, LOSS_SAMPLES),
                                (f"loss_path_10s_{tag}", LOSS10_BATCH, LOSS10_SAMPLES)):
            run_loss_path(card, key, config, want, n, samples, mode, sd, plain_impl=impl,
                          steps=BF16_PATH_LOSS_STEPS)
    sd10 = SHARED.get("sd10")
    if sd10 is None:  # as phase 10 makes it
        sd10 = init_weights(NomadModel(Wav2Vec2Config.base(), emb_dim=256), seed=0).state_dict()
    with tempfile.TemporaryDirectory(prefix="nomad_bf16_paths_train_") as tmp:
        cfg = write_train_tree(Path(tmp))
        ds = train_data.TripletDataset(cfg, "train_df", level=cfg["current_level"])
        batch = train_data._pinned(train_data.collate_triplets(
            [ds.load_item(i) for i in range(cfg["train_bs"])]))
        out["trainer_fused_fast_bf16"] = fused_fast_bf16_steps(card, cfg, batch, sd10)
    out["phase_s"] = time.perf_counter() - t_phase
    report["bf16_paths"] = out
    print(f"bf16 paths: phase 14 took {out['phase_s']:.1f} s", flush=True)


# ---------------- phase 15: large-scale and data-parallel work, world size 1 ----------------

# BASELINE.json config 4, "10k degraded LibriSpeech utterances x 100 NMRs":
# 1,000 of the 10,000 degraded files go through the engine (the smoke's
# time limit), 1.5-20 s long, and 20 more of 20-24 s (LibriSpeech's long
# utterances) so that a bucket past 1,024 frames is hit; 100 NMRs of 2-4 s;
# ``score_embeddings`` at the config's full 10,000 x 100 on seeded unit
# embeddings
LS_DEG, LS_LONG, LS_NMR, LS_FULL_DEG = 1000, 20, 100, 10_000
LS_DEG_S, LS_LONG_S, LS_NMR_S = (1.5, 20.0), (20.0, 24.0), (2.0, 4.0)
# the distance matrix against float64 distances of its own embeddings: the
# JAX package's large-scale test against scipy
TOL_LS_F64 = 1e-4
LS_STEPS = 3  # warm recipe steps timed, plain and on the mesh


def write_large_scale_tree(root: Path) -> tuple[list, list, float]:
    """Seeded PCM16 degraded and NMR files; (deg paths, nmr paths, seconds
    of degraded audio)."""
    rng = np.random.default_rng(4321)
    jobs = []
    for sub, count, span, noise in (("deg", LS_DEG, LS_DEG_S, (0.01, 0.1)),
                                    ("deg", LS_LONG, LS_LONG_S, (0.01, 0.1)),
                                    ("nmr", LS_NMR, LS_NMR_S, 0.005)):
        (root / sub).mkdir(exist_ok=True)
        for _ in range(count):
            n = int(rng.uniform(*span) * SR)
            seed = int(rng.integers(1 << 31))
            jobs.append((root / sub / f"{sub}_{len(jobs):05d}.wav", n, seed, noise))

    def write(job):
        path, n, seed, noise = job
        write_wav(str(path), speech_like(np.random.default_rng(seed), n, noise), SR, bits=16)

    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=8) as ex:
        list(ex.map(write, jobs))
    deg = [str(j[0]) for j in jobs if j[0].parent.name == "deg"]
    nmr = [str(j[0]) for j in jobs if j[0].parent.name == "nmr"]
    return deg, nmr, sum(j[1] for j in jobs if j[0].parent.name == "deg") / SR


def f64_distances(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Euclidean distances of the rows of a and b in float64."""
    a, b = a.astype(np.float64), b.astype(np.float64)
    sq = (a * a).sum(1)[:, None] + (b * b).sum(1)[None, :] - 2.0 * a @ b.T
    return np.sqrt(np.maximum(sq, 0.0))


def large_scale_scoring(card: str, out: dict, nomad: Nomad, deg: list, nmr: list,
                        seconds: float):
    """(a) config 4 through ``make_large_scale_scorer(...).score``; returns
    the scorer and its embeddings."""
    from nomad_tpu_torch.scoring import make_large_scale_scorer

    scorer = make_large_scale_scorer(nomad.model)
    if scorer.engine.mesh is not None or scorer._grid() is not None:
        fail("large scale: a one-rank group built a mesh")
    walls = []
    for run in ("cold", "warm"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        batches = scorer.engine.batches
        reset_launches()
        t0 = time.perf_counter()
        avg, dm = scorer.score(deg, nmr)
        walls.append(time.perf_counter() - t0)
        counts = read_launches()
        nb = scorer.engine.batches - batches
        want = launches_want(k1=12 * nb, k5=26 * nb)
        if counts != want:
            fail(f"large scale: {run} score() launches {counts} (want {want}, {nb} batches)")
    report["launches"]["large_scale_score"] = counts
    peak = torch.cuda.max_memory_allocated() / 1e9
    out["score"] = {"deg": len(deg), "nmr": len(nmr), "deg_seconds": seconds,
                    "cold_s": walls[0], "warm_s": walls[1],
                    "warm_wav_s_per_s": seconds / walls[1], "batches": nb, "peak_gb": peak,
                    "launches": {"k1": counts["flash_attention_fwd"],
                                 "k5": counts["layernorm_fwd"]}}
    print(f"large scale: config 4 cut to {len(deg)} x {len(nmr)} files ({seconds:.0f} s of "
          f"degraded audio): score() cold {walls[0]:.2f} s, warm {walls[1]:.2f} s "
          f"({seconds / walls[1]:.1f} wav-s/s of degraded audio), {nb} batches, K1 "
          f"{counts['flash_attention_fwd']}, K5 {counts['layernorm_fwd']}, peak {peak:.2f} GB"
          f"  [{card}]", flush=True)
    if avg.shape != (len(deg),) or dm.shape != (len(deg), len(nmr)) or not (
            np.isfinite(avg).all() and np.isfinite(dm).all()):
        fail(f"large scale: avg {avg.shape}, dm {dm.shape} or non-finite")

    ref = nomad.score_matrix(nmr, deg)
    d_dm = float(np.abs(dm - ref).max())
    d_avg = float(np.abs(avg - ref.mean(axis=1)).max())
    deg_emb = scorer.engine.embed_files_device(deg)
    nmr_emb = scorer.engine.embed_files_device(nmr)
    avg2, dm2 = scorer.score_embeddings(deg_emb, nmr_emb)
    d_f64 = float(np.abs(dm - f64_distances(deg_emb.cpu().numpy(), nmr_emb.cpu().numpy())).max())
    out["checks"] = {"dm_vs_score_matrix": d_dm, "avg_vs_score_matrix": d_avg,
                     "dm_vs_f64": d_f64,
                     "rerun_bit_equal": bool(np.array_equal(dm2, dm) and np.array_equal(avg2, avg))}
    print(f"large scale: vs Nomad.score_matrix max|d| dm {d_dm:.3g}, avg {d_avg:.3g} (<= "
          f"{TOL_BATCH1}); dm vs float64 of its embeddings {d_f64:.3g} (<= {TOL_LS_F64}); "
          f"score_embeddings of the engine's embeddings the same bits: "
          f"{out['checks']['rerun_bit_equal']}", flush=True)
    if d_dm > TOL_BATCH1 or d_avg > TOL_BATCH1 or d_f64 > TOL_LS_F64:
        fail(f"large scale: {out['checks']}")
    if not out["checks"]["rerun_bit_equal"]:
        fail("large scale: score() and score_embeddings of the same embeddings differ")

    rng = np.random.default_rng(77)
    full = [rng.standard_normal((k, 256)).astype(np.float32) for k in (LS_FULL_DEG, len(nmr))]
    full = [x / np.linalg.norm(x, axis=1, keepdims=True) for x in full]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    avg_f, dm_f = scorer.score_embeddings(*full)
    t_full = time.perf_counter() - t0
    d_full = float(np.abs(dm_f - f64_distances(*full)).max())
    d_full_avg = float(np.abs(avg_f - f64_distances(*full).mean(axis=1)).max())
    out["full"] = {"shape": list(dm_f.shape), "s": t_full, "dm_vs_f64": d_full,
                   "avg_vs_f64": d_full_avg}
    print(f"large scale: score_embeddings at the config's full {LS_FULL_DEG:,} x {len(nmr)}: "
          f"{t_full * 1e3:.1f} ms, vs float64 max|d| dm {d_full:.3g}, avg {d_full_avg:.3g} "
          f"(<= {TOL_LS_F64})  [{card}]", flush=True)
    if dm_f.shape != (LS_FULL_DEG, len(nmr)) or d_full > TOL_LS_F64 or d_full_avg > TOL_LS_F64:
        fail(f"large scale: the full-size matrix {out['full']}")
    return scorer, deg_emb, nmr_emb


def large_scale_mesh(card: str, out: dict, nomad: Nomad, scorer, deg: list, nmr: list,
                     deg_emb: torch.Tensor, nmr_emb: torch.Tensor, mesh) -> None:
    """(b) the mesh engine on (a)'s files in one call against the plain
    engine's embeddings of them (other batch plans: the padded-vs-batch-1
    bound), and the 1 x 1 grid against the dense path."""
    from nomad_tpu_torch.parallel import grid_mesh
    from nomad_tpu_torch.scoring import LargeScaleScorer

    engine = EmbeddingEngine(nomad.model, mesh=mesh)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    emb = engine.embed_files_device(deg + nmr)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_launches()
    want = launches_want(k1=12 * engine.batches, k5=26 * engine.batches)
    report["launches"]["large_scale_mesh_engine"] = counts
    if counts != want:
        fail(f"large scale: the mesh engine's launches {counts} (want {want})")
    plain = torch.cat([deg_emb, nmr_emb])
    d = (emb - plain).abs().max().item()
    out["mesh_engine"] = {"max_abs_vs_plain": d, "bit_equal": bool(torch.equal(emb, plain)),
                          "s": wall, "batches": engine.batches}
    print(f"large scale: data_mesh() engine on {len(deg) + len(nmr)} files, {wall:.2f} s, "
          f"{engine.batches} batches: max|d| vs the plain engine {d:.3g} (<= {TOL_BATCH1}), "
          f"bits equal: {out['mesh_engine']['bit_equal']}  [{card}]", flush=True)
    if d > TOL_BATCH1:
        fail(f"large scale: the mesh engine vs the plain one {d:.3g}")
    avg, dm = scorer.score_embeddings(deg_emb, nmr_emb)
    gavg, gdm = LargeScaleScorer.score_on_grid(grid_mesh(1, 1), deg_emb, nmr_emb)
    same = bool(np.array_equal(gdm, dm) and np.array_equal(gavg, avg))
    out["grid_1x1_bit_equal"] = same
    print(f"large scale: LargeScaleScorer on a 1 x 1 grid vs the dense path: bits equal {same}",
          flush=True)
    if not same:
        fail("large scale: the 1 x 1 grid differs from the dense path")


def ls_step(cfg: dict, sd: dict, batch, key: str, **kw) -> tuple:
    """A Training from ``sd`` and its first recipe step (launches checked):
    (trainer, loss, parameters, Adam state). The step runs cuDNN's
    deterministic algorithms: with its defaults the positional conv's
    backward may sum in another order from one run to the next."""
    tr = Training(cfg, params=sd, **kw)
    torch.cuda.synchronize()
    torch.backends.cudnn.deterministic = True
    try:
        reset_launches()
        loss = tr.train_step(batch, step_gen()).item()
        counts = read_launches()
    finally:
        torch.backends.cudnn.deterministic = False
    report["launches"][f"large_scale_train_step_{key}"] = counts
    if counts != launches_want(k5=50):
        fail(f"large scale: the {key} recipe step's launches {counts} (want K5 50)")
    # host copies: a copy on the card would count in the next run's peak
    params = {k: v.cpu() for k, v in tr.model.state_dict().items()}
    adam = {i: {k: v.cpu() for k, v in st.items()}
            for i, st in tr.optimizer.state_dict()["state"].items()}
    return tr, loss, params, adam


def step_diff(a: tuple, b: tuple) -> dict:
    """Where two steps' (loss, parameters, Adam state) differ."""
    (la, pa, sa), (lb, pb, sb) = a, b
    params = [k for k, v in pa.items() if not torch.equal(v, pb[k])]
    adam = [f"{i}.{k}" for i, st in sa.items() for k, v in st.items()
            if not torch.equal(v, sb[i][k])]
    worst = max([(pa[k] - pb[k]).abs().max().item() for k in params] or [0.0])
    return {"loss_equal": la == lb, "params_differ": len(params), "adam_differ": len(adam),
            "first": (params + adam)[:4], "max_abs_param": worst,
            "bit_equal": la == lb and not params and not adam}


def large_scale_training(card: str, out: dict, sd: dict, mesh) -> None:
    """(c) ``Training(mesh=data_mesh())`` at world size 1: one recipe step
    bit-equal to the plain one from the same state and generator (both
    with cuDNN's deterministic algorithms), and the two timed."""
    with tempfile.TemporaryDirectory(prefix="nomad_ls_train_") as tmp:
        cfg = write_train_tree(Path(tmp))
        ds = train_data.TripletDataset(cfg, "train_df", level=cfg["current_level"])
        batch = train_data._pinned(train_data.collate_triplets(
            [ds.load_item(i) for i in range(cfg["train_bs"])]))
        runs = {}
        for key, kw in (("plain", {"device": "cuda"}), ("mesh", {"mesh": mesh})):
            tr, *runs[key] = ls_step(cfg, sd, batch, key, **kw)
            gen = step_gen()
            out[f"train_step_{key}"] = time_steps(
                lambda: tr.train_step(batch, gen), LS_STEPS, card,
                f"large scale: {key} recipe step")
            release(tr)
    diff = step_diff(runs["plain"], runs["mesh"])
    out["train_step_mesh_vs_plain"] = diff
    print(f"large scale: Training(mesh=data_mesh()) recipe step vs the plain step (cuDNN "
          f"deterministic): loss {runs['mesh'][0]:.8g} vs {runs['plain'][0]:.8g}; bit-equal "
          f"{diff['bit_equal']} {diff}", flush=True)
    if not diff["bit_equal"]:
        fail("large scale: the world-size-1 mesh step differs from the plain step")


def large_scale_entries(card: str, out: dict) -> None:
    """(d) ``graft_entry.entry()`` on the card and ``dryrun_multichip(1)``."""
    from nomad_tpu_torch import graft_entry

    fn, args = graft_entry.entry()
    reset_launches()
    emb = fn(*args)
    torch.cuda.synchronize()
    counts = read_launches()
    report["launches"]["graft_entry"] = counts
    if counts != launches_want(k1b=12, k5=26):
        fail(f"large scale: entry()'s launches {counts} (want K1b 12, K5 26)")
    if tuple(emb.shape) != (2, 256) or not bool(torch.isfinite(emb).all()):
        fail(f"large scale: entry() gave {tuple(emb.shape)}, finite {torch.isfinite(emb).all()}")
    del fn, args
    t0 = time.perf_counter()
    graft_entry.dryrun_multichip(1)
    out["entries"] = {"entry_shape": list(emb.shape), "dryrun_multichip_1_s":
                      time.perf_counter() - t0}
    print(f"large scale: entry() [2, 256] finite (K1b 12, K5 26); dryrun_multichip(1) passed "
          f"in {out['entries']['dryrun_multichip_1_s']:.1f} s", flush=True)


def run_large_scale(card: str) -> None:
    """Phase 15: large-scale and data-parallel work on one card, in a
    one-rank NCCL group destroyed before the phase ends."""
    from nomad_tpu_torch.parallel import data_mesh, init_process_group
    from nomad_tpu_torch.parallel.mesh import destroy_process_group

    report.setdefault("launches", {})
    out: dict = {"card": card}
    t_phase = time.perf_counter()
    init_process_group(0, 1, "cuda")
    try:
        mesh = data_mesh()
        with tempfile.TemporaryDirectory(prefix="nomad_large_scale_") as tmp:
            t0 = time.perf_counter()
            deg, nmr, seconds = write_large_scale_tree(Path(tmp))
            out["write_s"] = time.perf_counter() - t0
            nomad = Nomad(device="cuda", weights_dir=str(Path(tmp) / "no-weights"))
            scorer, deg_emb, nmr_emb = large_scale_scoring(card, out, nomad, deg, nmr, seconds)
            large_scale_mesh(card, out, nomad, scorer, deg, nmr, deg_emb, nmr_emb, mesh)
            sd = {k: v.detach().cpu().clone() for k, v in nomad.model.state_dict().items()}
            del nomad, scorer, deg_emb, nmr_emb
            settled_allocated_gb()
        large_scale_training(card, out, sd, mesh)
        large_scale_entries(card, out)
    finally:
        destroy_process_group()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"large scale: phase 15 took {out['phase_s']:.1f} s", flush=True)
    report["large_scale"] = out


# ---------------- phase 16: the wire codec, the q16 loader, the build cache, the tools ----------------

WIRE_BATCH = (96, 163_840)  # phase 4's full batch: 96 files of 10 s in the 163,840 bucket
WIRE_CASE_ROWS = 16  # the synthetic payloads' rows (the numpy encoder and decoder take seconds)
WIRE_ITERS = 10
# the q16 directory: 4 files of each kind the native path cannot load as
# raw int16 (name, rate, channels, container)
Q16_KINDS = (("r22", 22050, 1, "wav"), ("st44", 44100, 2, "wav"), ("fl16", SR, 1, "flac"),
             ("st16", SR, 2, "wav"))
Q16_PER_KIND = 2
DEGRADER_RECIPE = ROOT / "nomad_tpu" / "configs" / "config_audio_degrader.yaml"
# the tools: 4 clean files; 2 spawned workers (each imports torch: on the
# card's machine 4 and 8 workers took longer, 13.1 + 16.8 s and 15.4 +
# 19.0 s); the intensity grid's levels cut to every other one
TOOLS_CLEAN, TOOLS_WORKERS, TOOLS_STEPS, TOOLS_TEST_LEVEL_STEP = 4, 2, 3, 2
COLD_SERVE_FILES = 2  # NMR and degraded files of the cold start's first score


def codec_cases(speech: np.ndarray) -> dict:
    """Phase 4's batch and tests/test_wirecodec.py's synthetic payloads at
    WIRE_CASE_ROWS of its rows."""
    rng = np.random.default_rng(16)
    shape = (WIRE_CASE_ROWS, speech.shape[1])
    return {"speech": speech,
            "random": rng.integers(-32768, 32768, shape, dtype=np.int16),
            "zeros": np.zeros(shape, np.int16),
            "extremes": np.tile(np.array([-32768, 32767], np.int16),
                                shape[0] * shape[1] // 2).reshape(shape)}


def pinned(a: np.ndarray) -> torch.Tensor:
    t = torch.empty(a.shape, dtype=torch.from_numpy(a[:0]).dtype, pin_memory=True)
    t.numpy()[...] = a
    return t


def h2d_ms(host: torch.Tensor) -> float:
    """One pinned host tensor's copy to the card (CUDA events)."""
    dst = torch.empty(host.shape, dtype=host.dtype, device=DEV)
    return time_ms(lambda: dst.copy_(host, non_blocking=True), WIRE_ITERS)


def check_codec(waves: list, card: str) -> dict:
    """Both encoders on each payload class: the same stream; the card's
    decode bit-equal to ``decode_numpy`` and to the input; for phase 4's
    [96, 163,840] batch the host encode, the card decode and the copies of
    the raw batch and of the frame timed."""
    speech = np.zeros(WIRE_BATCH, np.int16)
    for row, w in enumerate(waves[:WIRE_BATCH[0]]):
        speech[row, :len(w)] = w
    res = {}
    for name, arr in codec_cases(speech).items():
        b, t = arr.shape
        t0 = time.perf_counter()
        enc = wirecodec.encode(arr)
        native_s = time.perf_counter() - t0
        saved = wirecodec.native_pack_i16
        wirecodec.native_pack_i16 = lambda *a, **k: None
        try:
            t0 = time.perf_counter()
            enc_np = wirecodec.encode(arr)
            numpy_s = time.perf_counter() - t0
        finally:
            wirecodec.native_pack_i16 = saved
        same = all(np.array_equal(enc[k], enc_np[k]) for k in ("packed", "widths", "offsets",
                                                               "firsts"))
        frame = pinned(wirecodec.combined_rows(enc).view(np.int32))
        dec = wirecodec.decode_combined(frame.to(DEV), b, t).cpu().numpy()
        exact = np.array_equal(dec, arr) and np.array_equal(dec, wirecodec.decode_numpy(enc))
        r = {"ratio": frame.numel() * 4 / arr.nbytes, "native_encode_s": native_s,
             "numpy_encode_s": numpy_s, "encoders_same_stream": same, "decode_exact": exact}
        print(f"codec: {name} [{b}, {t}]: frame/raw {r['ratio']:.4f}, C++ and numpy encoders "
              f"the same stream {same} ({native_s:.3f} s, {numpy_s:.3f} s), card decode "
              f"bit-equal to decode_numpy and the input {exact}", flush=True)
        if not (same and exact):
            fail(f"codec: {name}: encoders the same {same}, card decode exact {exact}")
        if name == "speech":
            dev = frame.to(DEV)
            enc_s = []
            for _ in range(3):
                t0 = time.perf_counter()
                wirecodec.combined_rows(wirecodec.encode(arr))
                enc_s.append(time.perf_counter() - t0)
            raw = pinned(arr)
            r |= {"encode_frame_s": float(np.median(enc_s)),
                  "decode_ms": time_ms(lambda: wirecodec.decode_combined(dev, b, t), WIRE_ITERS),
                  "h2d_raw_ms": h2d_ms(raw), "h2d_frame_ms": h2d_ms(frame),
                  "raw_bytes": arr.nbytes, "frame_bytes": frame.numel() * 4}
            r["h2d_raw_GBps"] = arr.nbytes / r["h2d_raw_ms"] / 1e6
            main = report.get("main_path")  # phase 4's device pass, when it ran
            if main:
                r["h2d_raw_share_of_pass"] = r["h2d_raw_ms"] / 1e3 / float(np.median(main["pass_s"]))
            print(f"codec: speech: host encode + frame {r['encode_frame_s'] * 1e3:.1f} ms; card "
                  f"decode {r['decode_ms']:.3f} ms; copy to the card from pinned memory: raw "
                  f"{arr.nbytes / 1e6:.1f} MB {r['h2d_raw_ms']:.3f} ms "
                  f"({r['h2d_raw_GBps']:.1f} GB/s), frame {r['frame_bytes'] / 1e6:.1f} MB "
                  f"{r['h2d_frame_ms']:.3f} ms (ratio {r['h2d_frame_ms'] / r['h2d_raw_ms']:.3f})"
                  f"  [{card}]", flush=True)
        res[name] = r
    return res


def embed_counted(eng: EmbeddingEngine, paths: list, key: str, **kw) -> tuple:
    """One ``embed_files_device`` call with its launch counts (K1 12, K5 26
    a batch) and wall time to the card's end."""
    batches = eng.batches
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    emb = eng.embed_files_device(paths, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_launches()
    n = eng.batches - batches
    report["launches"][key] = counts
    if counts != launches_want(k1=12 * n, k5=26 * n) or n == 0:
        fail(f"{key}: launch counts {counts} for {n} batches")
    return emb, wall, n


def packed_vs_raw(model: NomadModel, paths: list, card: str) -> tuple:
    """Phase 4's 108 files with ``wire_codec`` "off" and "on" in turns
    (off, on, on, off): the embeddings bit-equal, every batch of "on"
    packed. Returns the "off" embeddings and the results."""
    engines = {m: EmbeddingEngine(model, DEV, wire_codec=m) for m in ("off", "on")}
    embs, walls = {}, {"off": [], "on": []}
    for i, m in enumerate(("off", "on", "on", "off")):
        emb, wall, n = embed_counted(engines[m], paths, f"wire_codec_{m}_{i}")
        walls[m].append(wall)
        if m in embs and not torch.equal(emb, embs[m]):
            fail(f"codec: two '{m}' passes differ")
        embs[m] = emb
    equal = torch.equal(embs["on"], embs["off"])
    stats = engines["on"].transfer_stats()
    # the reference's serial loop: each batch waited for before the next copy
    serial, serial_s, _ = embed_counted(EmbeddingEngine(model, DEV, serialize_pipeline=True),
                                        paths, "serialize_pipeline")
    res = {"bit_equal": equal, "pass_s": walls, "batches_per_pass": n, "serial_pass_s": serial_s,
           "on_stats": stats, "off_stats": engines["off"].transfer_stats(), "card": card}
    print(f"codec: {len(paths)} files, wire_codec off / on in turns: passes {walls['off']} / "
          f"{walls['on']} s; embeddings bit-equal {equal}; on: {stats}; serialized pass "
          f"{serial_s:.3f} s", flush=True)
    if not equal or stats["codec_hits"] != stats["batches"] or stats["codec_skips"]:
        fail(f"codec: the packed path's embeddings bit-equal {equal}, stats {stats}")
    if not torch.equal(serial, embs["off"]):
        fail("codec: the serialized pass's embeddings differ from the pipelined pass's")
    return embs["off"], res


def write_q16_tree(root: Path) -> list:
    rng = np.random.default_rng(1616)
    paths = []
    for name, sr, ch, ext in Q16_KINDS:
        for i in range(Q16_PER_KIND):
            n = int(SECONDS * sr)
            x = np.stack([speech_like(rng, n, (0.01, 0.1)) for _ in range(ch)])
            p = str(root / f"{name}_{i}.{ext}")
            if ext == "flac":
                write_flac(p, x, sr)
            else:
                write_wav(p, x, sr, bits=16)
            paths.append(p)
    return paths


def check_q16(model: NomadModel, paths: list, nmr_emb: torch.Tensor, card: str) -> dict:
    """``quantize_transfer`` on (the default) and off over files the raw
    int16 loader cannot take: int16 bytes only when on, f32 when off; the
    embeddings' and the scores' (against phase 4's NMR files) distance,
    against the 1e-3 score budget."""
    res, embs = {"card": card}, {}
    for on in (True, False):
        eng = EmbeddingEngine(model, DEV, quantize_transfer=on)
        embs[on], wall, n = embed_counted(eng, paths, f"q16_{'on' if on else 'off'}")
        t = eng.transfer_stats()
        res["on" if on else "off"] = {"transfer": t, "wall_s": wall, "batches": n}
        if t["native_batches"] != n or (t["h2d_bytes_f32"] == 0) != on or (
                t["h2d_bytes_int16"] > 0) != on:
            fail(f"q16: quantize_transfer={on}: transfer {t}")
    d_emb = (embs[True] - embs[False]).abs().max().item()
    d_score = (cdist(embs[True], nmr_emb) - cdist(embs[False], nmr_emb)).abs().max().item()
    res |= {"max_abs_emb": d_emb, "max_abs_score": d_score, "in_budget": d_score <= DELTA_BUDGET}
    print(f"q16: {len(paths)} files (22.05 kHz, 44.1 kHz stereo, FLAC, stereo): int16 bytes on "
          f"{res['on']['transfer']['h2d_bytes_int16'] / 1e6:.1f} MB, f32 bytes off "
          f"{res['off']['transfer']['h2d_bytes_f32'] / 1e6:.1f} MB; quantized vs f32 max|d emb| "
          f"{d_emb:.3g}, max|d score| {d_score:.3g} (budget {DELTA_BUDGET})  [{card}]",
          flush=True)
    if not np.isfinite(d_score) or d_score > DELTA_FAULT:
        fail(f"q16: quantized vs f32 scores differ by {d_score}")
    return res


def serve_first_answers(root: Path, cache_dir: Path, nmr: str, deg: str, tag: str) -> dict:
    """``python -m nomad_tpu_torch.serve`` with its build directory at
    ``cache_dir``: the wall time from the start to the ping's answer
    (imports, the card, the weights) and to the first score's (kernels
    built or loaded, the first pass)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), NOMAD_TPU_TORCH_CACHE_DIR=str(cache_dir))
    before = {p.name for p in cache_dir.glob("*.so")} if cache_dir.is_dir() else set()
    reqs = [{"op": "ping"}, {"op": "score", "nmr": nmr, "deg": deg,
                             "results_path": str(root / f"out_{tag}")}, {"op": "shutdown"}]
    (root / f"out_{tag}").mkdir()
    err_path = root / f"serve_{tag}.stderr"
    walls = []
    with open(err_path, "w") as err:
        t0 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, "-m", "nomad_tpu_torch.serve"], cwd=root,
                                env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                                stderr=err, text=True)
        watchdog = threading.Timer(SERVE_TIMEOUT_S, proc.kill)
        watchdog.start()
        try:
            for req in reqs:
                proc.stdin.write(json.dumps(req) + "\n")
                proc.stdin.flush()
                line = proc.stdout.readline()
                walls.append(time.perf_counter() - t0)
                try:
                    ok = json.loads(line).get("ok") if line else False
                except json.JSONDecodeError:
                    ok = False
                if not ok:
                    fail(f"cold serve {tag}: {req['op']} answered {line[:300]!r}; stderr:\n"
                         f"{err_path.read_text()[-3000:]}")
            rc = proc.wait(timeout=60)
        finally:
            watchdog.cancel()
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if rc != 0:
        fail(f"cold serve {tag}: exit {rc}")
    built = sorted({p.name for p in cache_dir.glob("*.so")} - before)
    res = {"ping_s": walls[0], "first_score_s": walls[1], "built": built}
    print(f"cold serve ({tag}): ping answered {walls[0]:.2f} s after the start, the first score "
          f"{walls[1]:.2f} s; built {built}", flush=True)
    return res


def check_cold_serve(root: Path, sd: dict, nmr: str, deg: str, card: str) -> dict:
    """A cold ``serve`` start to its first answer in a fresh build directory
    (every library it runs built: K1, K5 and the native ingest) and again
    with them present; the difference is the build's share."""
    from nomad_tpu_torch.api import write_cache

    serve_root = root / "serve"
    write_cache(str(serve_root / "pt-models" / CACHE_FILENAME), sd)
    dirs = []
    for sub, src in (("nmr", nmr), ("deg", deg)):
        (serve_root / sub).mkdir(parents=True)
        for p in sorted(Path(src).iterdir())[:COLD_SERVE_FILES]:
            shutil.copy(p, serve_root / sub / p.name)
        dirs.append(str(serve_root / sub))
    cache_dir = root / "fresh_build"
    absent = serve_first_answers(serve_root, cache_dir, *dirs, "absent")
    present = serve_first_answers(serve_root, cache_dir, *dirs, "present")
    want = {f"{n}-" for n in ("flash_attention", "layernorm", "libnomad_native")}
    if {next((w for w in want if b.startswith(w)), b) for b in absent["built"]} != want or \
            present["built"]:
        fail(f"cold serve: built {absent['built']} cold, then {present['built']}")
    res = {"absent": absent, "present": present, "card": card,
           "build_share_s": absent["first_score_s"] - present["first_score_s"]}
    print(f"cold serve: first score {absent['first_score_s']:.2f} s with the build directory "
          f"empty, {present['first_score_s']:.2f} s with its libraries present: the build "
          f"{res['build_share_s']:.2f} s  [{card}]", flush=True)
    return res


def write_degrader_tree(root: Path) -> dict:
    """The degrader recipe (``config_audio_degrader.yaml``) pointed at 4
    seeded clean 10.5-12 s WAVs (train and test alike) and 2 noise files,
    its test levels cut to every other one."""
    rng = np.random.default_rng(1617)
    cfg = config_io.load(str(DEGRADER_RECIPE))
    cfg.update(root=str(root) + "/", root_noise=str(root), noise_dir_train="noise",
               noise_dir_test="noise")
    for key in ("mp3_test", "opus_test", "vorbis", "clip_test", "reverb", "noise_test"):
        cfg[key] = cfg[key][::TOOLS_TEST_LEVEL_STEP]
    for sub in (cfg["in_dir_train_wav"], cfg["in_dir_test_wav"]):
        (root / sub / "spk1").mkdir(parents=True)
    (root / "noise").mkdir()
    for i in range(TOOLS_CLEAN):
        x = speech_like(rng, int(rng.integers(168_000, 192_001)), 0.005)
        for sub in (cfg["in_dir_train_wav"], cfg["in_dir_test_wav"]):
            write_wav(str(root / sub / "spk1" / f"utt_{i}.wav"), x, SR, bits=16)
    for i in range(2):
        write_wav(str(root / "noise" / f"n{i}.wav"),
                  (0.1 * rng.standard_normal(3 * SR)).astype(np.float32), SR, bits=16)
    return cfg


def run_tools(root: Path, sd: dict, card: str) -> dict:
    """The dataset tools on the card's machine, which has no pandas: both
    generators at the recipe's grids, NSIM triplets from a seeded NSIM CSV,
    the CLEAN subset copied, then the triplet recipe's step on the
    generated ``train.csv`` (K5 50) with remat "full" and "dots": loss and
    gradients within 1e-6 of max |g| (cuDNN's deterministic algorithms in
    both), time and peak."""
    from nomad_tpu_torch.utils import degrader_drivers, nsim_sampling

    res: dict = {"card": card}
    cfg = write_degrader_tree(root)
    codecs = degrader_drivers.D.have_ffmpeg()
    t0 = time.perf_counter()
    rows = degrader_drivers.generate_training_set(cfg, workers=TOOLS_WORKERS)
    res["training_set_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    test_rows = degrader_drivers.generate_intensity_test_set(cfg, workers=TOOLS_WORKERS)
    res["intensity_set_s"] = time.perf_counter() - t0
    grid = len(cfg["clip_train"]) + len(cfg["noise_train"]) + codecs * (
        len(cfg["mp3_train"]) + len(cfg["opus_train"]))
    test_grid = len(cfg["clip_test"]) + len(cfg["reverb"]) + len(cfg["noise_test"]) + codecs * (
        len(cfg["mp3_test"]) + len(cfg["opus_test"]) + len(cfg["vorbis"]))
    out_root = Path(cfg["root"]) / cfg["out_dir_train"]
    read = train_data.read_table(str(out_root / "degraded_data.csv"))
    if len(rows) != TOOLS_CLEAN * grid or read != rows or len(test_rows) != test_grid or not all(
            (out_root / r["degraded"]).is_file() for r in rows):
        fail(f"tools: {len(rows)} training rows (want {TOOLS_CLEAN * grid}), "
             f"{len(test_rows)} intensity rows (want {test_grid})")
    # seeded NSIM labels for the degraded files, then the triplets
    rng = np.random.default_rng(1618)
    nsim_rows = [{"reference": r["reference"], "degraded": r["degraded"],
                  "nsim": float(np.round(rng.uniform(0.3, 1.0), 3))} for r in rows]
    nsim_csv = str(root / "nsim.csv")
    train_data.write_rows(nsim_csv, ("reference", "degraded", "nsim"), nsim_rows)
    train_csv, valid_csv = str(root / "train.csv"), str(root / "valid.csv")
    t0 = time.perf_counter()
    tables = nsim_sampling.build_triplet_csvs(nsim_csv, nsim_csv, train_csv, valid_csv)
    res["triplets_s"] = time.perf_counter() - t0
    clean_src = root / "clean_src"
    shutil.copytree(Path(cfg["root"]) / cfg["in_dir_train_wav"], clean_src / "CLEAN")
    copied = degrader_drivers.copy_referenced_subset([train_csv, valid_csv], str(clean_src),
                                                     str(out_root))
    res |= {"training_rows": len(rows), "intensity_rows": len(test_rows),
            "triplets": [len(t) for t in tables], "clean_copied": len(copied),
            "ffmpeg_codecs": codecs}
    print(f"tools: training set {len(rows)} files in {res['training_set_s']:.1f} s, intensity "
          f"set {len(test_rows)} in {res['intensity_set_s']:.1f} s ({TOOLS_WORKERS} spawned "
          f"workers; codecs {'on' if codecs else 'off: no ffmpeg'}); triplets {res['triplets']}"
          f"; {len(copied)} clean files copied", flush=True)

    recipe = config_io.load(str(TRAIN_RECIPE))
    recipe.update(root=str(out_root) + "/", train_df=train_csv, valid_df=valid_csv,
                  checkpoint_path=None, run_dir=str(root / "run"))
    ds = train_data.TripletDataset(recipe, "train_df", level=recipe["current_level"])
    batch = train_data.collate_triplets([ds.load_item(i) for i in range(recipe["train_bs"])])
    if batch.anchor.shape != (recipe["train_bs"], 163_840) or batch.anchor.dtype != np.int16:
        fail(f"tools: the generated train.csv's batch {batch.anchor.shape} {batch.anchor.dtype}")
    batch = train_data._pinned(batch)
    steps = {}
    for policy in ("full", "dots"):
        torch.backends.cudnn.deterministic = True
        try:
            tr, loss, _, grads = first_train_step(f"tools_recipe_step_{policy}",
                                                  dict(recipe, remat_policy=policy), batch,
                                                  launches_want(k5=50), sd)
        finally:
            torch.backends.cudnn.deterministic = False
        gen = step_gen()
        timing = time_steps(lambda: tr.train_step(batch, gen), TOOLS_STEPS, card,
                            f"tools: recipe step, remat {policy}")
        steps[policy] = (loss, grads, timing)
        release(tr)
        del tr
    (loss_f, grads_f, time_f), (loss_d, grads_d, time_d) = steps["full"], steps["dots"]
    gmax = max(g.abs().max().item() for g in grads_f.values())
    d_loss = abs(loss_d - loss_f) / abs(loss_f)
    d_grad = max((grads_d[n] - g).abs().max().item() for n, g in grads_f.items()) / gmax
    res |= {"step_full": time_f, "step_dots": time_d, "dots_vs_full_loss_rel": d_loss,
            "dots_vs_full_grad_rel_to_max": d_grad}
    print(f"tools: remat dots vs full on the generated triplets: loss rel {d_loss:.3g}, gradient "
          f"max|d|/max|g| {d_grad:.3g} (<= 1e-6); step {time_d['events_median_ms']:.2f} vs "
          f"{time_f['events_median_ms']:.2f} ms, peak {time_d['peak_mem_gb']:.2f} vs "
          f"{time_f['peak_mem_gb']:.2f} GB  [{card}]", flush=True)
    if grads_d.keys() != grads_f.keys() or d_loss > 1e-6 or d_grad > 1e-6:
        fail(f"tools: remat dots vs full: loss rel {d_loss}, gradient {d_grad}")
    return res


def run_wire_and_tools(card: str) -> None:
    """Phase 16: the wire codec, the q16 loader, the build cache's cold
    start and the dataset tools."""
    report.setdefault("launches", {})
    out: dict = {"card": card}
    t_phase = time.perf_counter()
    sd = SHARED.get("sd")
    if sd is None:  # run alone: phase 9's seeded init
        sd = init_weights(NomadModel(Wav2Vec2Config.base(), emb_dim=256), seed=0).state_dict()
    model = NomadModel(Wav2Vec2Config.base(), emb_dim=256)
    model.load_state_dict(sd)
    model = model.to(DEV).eval()
    with tempfile.TemporaryDirectory(prefix="nomad_wire_") as tmp:
        tmp = Path(tmp)
        nmr, deg = write_wavs(tmp)
        paths = [str(p) for p in sorted(Path(nmr).iterdir()) + sorted(Path(deg).iterdir())]
        waves = EmbeddingEngine(model, DEV).load_waves(paths)
        out["codec"] = check_codec(waves, card)
        emb_off, out["packed_vs_raw"] = packed_vs_raw(model, paths, card)
        (tmp / "q16").mkdir()
        out["q16"] = check_q16(model, write_q16_tree(tmp / "q16"), emb_off[:N_NMR], card)
        del model, emb_off
        settled_allocated_gb()
        out["cold_serve"] = check_cold_serve(tmp, sd, nmr, deg, card)
        (tmp / "tools").mkdir()
        out["tools"] = run_tools(tmp / "tools", sd, card)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"wire and tools: phase 16 took {out['phase_s']:.1f} s", flush=True)
    report["wire_and_tools"] = out


# ---------------- phase 17: the rest of the JAX package's Wav2Vec2Config ----------------

# name: (the config's fields, the attention kernel of each of the 12 blocks
# in one batch's forward, the LayerNorm kernel): the first five are rungs
# of scripts/precision_ladder.py and scripts/precision_sweep.py
CONFIG_FIELD_CASES = {
    "tail4": (dict(encoder_tail_start=8, encoder_tail_precision="default"),
              ["k1"] * 8 + ["k1b"] * 4, "k5"),
    "tail4_fused": (dict(encoder_tail_start=8, encoder_tail_precision="default",
                         attention_impl="fused_qkv"), ["k4h"] * 8 + ["k4b"] * 4, "k5"),
    "head_default_tail_high": (dict(encoder_precision="default", encoder_tail_start=8,
                                    encoder_tail_precision="high"),
                               ["k1b"] * 8 + ["k1"] * 4, "k5"),
    "matmul_default": (dict(matmul_precision="default"), ["k1b"] * 12, "k5"),
    "finer_islands": (dict(attn_precision="default", ffn2_precision="default",
                           featproj_precision="default"), ["k1b"] * 12, "k5"),
    "dtype_bf16": (dict(dtype=torch.bfloat16), ["k1_io"] * 12, "k5_io"),
}


@contextlib.contextmanager
def launches_by_layer(model: NomadModel):
    """The launches each block of ``model`` makes, one dict a call, read by
    hooks around each block's forward (the counters are the wrappers',
    counted on the host at each launch)."""
    layers = model.backbone.encoder.layers
    calls: list = [[] for _ in layers]
    start: dict = {}
    hooks = []
    for i, layer in enumerate(layers):
        hooks.append(layer.register_forward_pre_hook(
            lambda m, args, i=i: start.__setitem__(i, read_launches())))
        hooks.append(layer.register_forward_hook(
            lambda m, args, out, i=i: calls[i].append(
                {k: v - start[i][k] for k, v in read_launches().items()})))
    try:
        yield calls
    finally:
        for h in hooks:
            h.remove()


def config_field_case(card: str, name: str, sd: dict, waves: list, exact_emb: torch.Tensor,
                      exact_plain: torch.Tensor) -> dict:
    """One configuration of phase 17 on phase 4's decoded files: the
    launches of one device pass, block by block and in all, against
    CONFIG_FIELD_CASES; three warm device passes and the peak; the
    embeddings against the same config's plain path (its attention kernels'
    own plain versions, plain LayerNorm) by phase 12's rule; the pairwise
    delta against the "exact" kernel path's, reported."""
    fields, attn, ln = CONFIG_FIELD_CASES[name]
    total_s = (N_NMR + N_DEG) * SECONDS
    config = Wav2Vec2Config.base(**fields)
    leftover_gb = settled_allocated_gb()
    nomad = Nomad(device="cuda", config=config, params=sd)
    torch.cuda.synchronize()
    reset_launches()
    with launches_by_layer(nomad.model) as by_layer:
        emb = nomad.engine.embed_waves_device(waves)
        torch.cuda.synchronize()
    counts = read_launches()
    batches = len(by_layer[0])
    report["launches"][f"config_fields_{name}"] = counts
    layer_want = [launches_want(**{kernel: 1, ln: 2}) for kernel in attn]
    outside = launches_want(**{ln: 2})  # feature_layer_norm and the encoder's LayerNorm
    want = {k: batches * (outside[k] + sum(w[k] for w in layer_want)) for k in outside}
    bad = [(i, j) for i, per_call in enumerate(by_layer) for j, c in enumerate(per_call)
           if c != layer_want[i]]
    if counts != want or batches == 0 or bad:
        fail(f"{name}: launch counts {counts} for {batches} batches (want {want}); "
             f"blocks off their table (block, batch): {bad}")
    torch.cuda.reset_peak_memory_stats()
    emb, passes = timed_passes(nomad, waves)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del nomad
    with plain_flash("default"):
        plain = Nomad(device="cuda", config=dataclasses.replace(config, layernorm_impl="ref"),
                      params=sd)
        plain_emb = plain.engine.embed_waves_device(waves)
    del plain
    pass_s = float(np.median(passes))
    res = {"fields": {k: str(v) for k, v in fields.items()}, "batches": batches,
           "launches_per_block": [{k: v for k, v in w.items() if v} for w in layer_want],
           "pass_s": passes, "wav_s_per_s_pass": total_s / pass_s, "peak_mem_gb": peak_gb,
           "leftover_mem_gb": leftover_gb, "own_peak_mem_gb": peak_gb - leftover_gb,
           "pairwise_delta_vs_exact": pairwise_delta(emb, exact_emb, slice(N_NMR, None),
                                                     slice(0, N_NMR)),
           "card": card}
    print(f"config fields {name}: {batches} batches, blocks {attn[0]} x "
          f"{attn.count(attn[0])}" + (f", {attn[-1]} x {attn.count(attn[-1])}"
                                      if attn[-1] != attn[0] else "")
          + f" each with {ln} x 2, launches {counts}; device pass {pass_s:.3f} s = "
          f"{total_s / pass_s:.1f} wav-s/s; own peak {res['own_peak_mem_gb']:.5f} GB; pairwise "
          f"delta vs exact {res['pairwise_delta_vs_exact']:.3g}  [{card}]", flush=True)
    res |= bf16_path_vs_plain(f"config fields {name}", emb, plain_emb, exact_plain)
    return res


def run_config_fields(card: str) -> None:
    """Phase 17: the JAX package's config fields that the port took last
    (``matmul_precision``, the attention, FFN and feature-projection
    islands, the encoder tail split, ``dtype``) at full BASE width on phase
    9's seeded weights and phase 4's 108 files, each configuration of
    CONFIG_FIELD_CASES through ``config_field_case``; then ``dtype=bf16``'s
    loss at 24 x 160,000 samples (K1-bf16 24, K2-bf16 12, K3-bf16 12,
    K5-bf16 52 a step) against its plain path by phase 10's rule."""
    report.setdefault("launches", {})
    t_phase = time.perf_counter()
    sd = SHARED.get("sd")
    if sd is None:  # phase 17 alone: Nomad's seeded init, as phase 9 makes it
        sd = init_weights(NomadModel(Wav2Vec2Config.base(), emb_dim=256), seed=0).state_dict()
    out: dict = {"card": card}
    with tempfile.TemporaryDirectory(prefix="nomad_config_fields_") as tmp:
        nmr, deg = write_wavs(Path(tmp))
        exact = Nomad(device="cuda", params=sd)
        paths = sorted(Path(nmr).iterdir()) + sorted(Path(deg).iterdir())
        waves = exact.engine.load_waves([str(p) for p in paths])
        exact_emb = exact.engine.embed_waves_device(waves)
        del exact
        exact_plain = Nomad(device="cuda", config=plain_config(), params=sd)
        exact_plain_emb = exact_plain.engine.embed_waves_device(waves)
        del exact_plain
        for name in CONFIG_FIELD_CASES:
            out[name] = config_field_case(card, name, sd, waves, exact_emb, exact_plain_emb)
    run_loss_path(card, "loss_path_10s_dtype_bf16", Wav2Vec2Config.base(dtype=torch.bfloat16),
                  launches_want(k1_io=24, k2_io=12, k3_io=12, k5_io=52), LOSS10_BATCH,
                  LOSS10_SAMPLES, "exact_bf16", sd, plain_impl="kernel",
                  steps=BF16_PATH_LOSS_STEPS, plain_kw={"dtype": torch.bfloat16})
    out["phase_s"] = time.perf_counter() - t_phase
    report["config_fields"] = out
    print(f"config fields: phase 17 took {out['phase_s']:.1f} s", flush=True)


def run_high3(card: str) -> None:
    """``--only-high3``: K4h against its plain version at its shapes (phase
    3's checks) and its bf16-I/O flavour at the scoring shape (phase 14's),
    then the paths that drive it: phase 4 (the fused "exact" scoring path,
    K4 on its "highest" batch) and phase 5's fused loss."""
    report.setdefault("launches", {})
    print("high3: K4h vs its plain version on the card:", flush=True)
    check_high3_shapes()
    rng = np.random.default_rng(14)
    main_lens = [511, 1, 0] + list(rng.integers(2, 511, size=9)) + [499] * 84
    report["kernels"]["fused_qkv_attention_high3_bf16io_fwd"] = {"main": check_fused_bf16io(
        96, 511, main_lens, torch.Generator().manual_seed(14), True, "high")}
    run_scoring_paths(card)
    run_fused_loss_path(card)


def run_scoring_k1(card: str) -> None:
    """Phase 4's K1 path alone (``--only-scoring``)."""
    report.setdefault("launches", {})
    with tempfile.TemporaryDirectory(prefix="nomad_smoke_") as tmp:
        tmp = Path(tmp)
        nmr, deg = write_wavs(tmp)
        run_main_path(card, tmp, nmr, deg)


def main() -> None:
    parser = argparse.ArgumentParser(description="Smoke run of nomad_tpu_torch on one CUDA card")
    only = parser.add_mutually_exclusive_group()
    only.add_argument("--only-scoring", action="store_true",
                      help="phases 1 and 4's K1 path only; ends with the report line")
    only.add_argument("--only-loss", action="store_true",
                      help="phases 1 and 5 only; ends with the report line")
    only.add_argument("--only-train", action="store_true",
                      help="phases 1 and 6 only; ends with the report line")
    only.add_argument("--only-se", action="store_true",
                      help="phases 1 and 7 only; ends with the report line")
    only.add_argument("--only-serve", action="store_true",
                      help="phases 1 and 8 only; ends with the report line")
    only.add_argument("--only-precision", action="store_true",
                      help="phases 1, 2 and 9 only; ends with the report line")
    only.add_argument("--only-grad-modes", action="store_true",
                      help="phases 1, 2 and 10 only; ends with the report line")
    only.add_argument("--only-fused-modes", action="store_true",
                      help="phases 1, 2 and 12 only; ends with the report line")
    only.add_argument("--only-fast-bf16", action="store_true",
                      help="phases 1, 2 and 13 only; ends with the report line")
    only.add_argument("--only-bf16-paths", action="store_true",
                      help="phases 1, 2 and 14 only; ends with the report line")
    only.add_argument("--only-large-scale", action="store_true",
                      help="phases 1 and 15 only; ends with the report line")
    only.add_argument("--only-wire-and-tools", action="store_true",
                      help="phases 1, 2 and 16 only; ends with the report line")
    only.add_argument("--only-config-fields", action="store_true",
                      help="phases 1, 2 and 17 only; ends with the report line")
    only.add_argument("--only-high3", action="store_true",
                      help="phases 1 and 2, K4h's checks, phase 4 and the fused loss only; "
                           "ends with the report line")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this smoke runs on a CUDA card")
    set_exact_precision()
    card = card_info()
    alone = {"only_scoring": run_scoring_k1, "only_loss": run_loss_paths,
             "only_train": run_trainer, "only_se": run_se,
             "only_serve": run_serve,
             "only_precision": lambda card: (build_kernels(), run_precision(card)),
             "only_grad_modes": lambda card: (build_kernels(), run_grad_modes(card)),
             "only_fused_modes": lambda card: (build_kernels(), run_fused_modes(card)),
             "only_fast_bf16": lambda card: (build_kernels(), run_fast_bf16(card)),
             "only_bf16_paths": lambda card: (build_kernels(), run_bf16_paths(card)),
             "only_large_scale": run_large_scale,
             "only_wire_and_tools": lambda card: (build_kernels(), run_wire_and_tools(card)),
             "only_config_fields": lambda card: (build_kernels(), run_config_fields(card)),
             "only_high3": lambda card: (build_kernels(), run_high3(card))}
    for flag, phase in alone.items():
        if getattr(args, flag):
            phase(card)
            print("report: " + json.dumps(report, default=float))
            return
    build_kernels()
    print("kernels vs plain versions on the card:", flush=True)
    check_kernels()
    run_scoring_paths(card)
    run_loss_paths(card)
    run_trainer(card)
    run_se(card)
    run_serve(card)
    run_precision(card)
    run_grad_modes(card)
    run_fused_modes(card)
    run_fast_bf16(card)
    run_bf16_paths(card)
    run_large_scale(card)
    run_wire_and_tools(card)
    run_config_fields(card)

    rows = []
    for name, src, replaces in (
        ("flash_attention_fwd", "nomad_tpu_torch/csrc/flash_attention.cu",
         "nomad_tpu/ops/flash_attention.py:37"),
        ("flash_attention_bf16_fwd", "nomad_tpu_torch/csrc/flash_attention_bf16.cu",
         "nomad_tpu/ops/flash_attention.py:37"),
        ("flash_attention_bwd_dq", "nomad_tpu_torch/csrc/flash_attention_bwd.cu",
         "nomad_tpu/ops/flash_attention.py:182"),
        ("flash_attention_bwd_dkv", "nomad_tpu_torch/csrc/flash_attention_bwd.cu",
         "nomad_tpu/ops/flash_attention.py:222"),
        ("flash_attention_bwd_dq_bf16", "nomad_tpu_torch/csrc/flash_attention_bwd_bf16.cu",
         "nomad_tpu/ops/flash_attention.py:182"),
        ("flash_attention_bwd_dkv_bf16", "nomad_tpu_torch/csrc/flash_attention_bwd_bf16.cu",
         "nomad_tpu/ops/flash_attention.py:222"),
        ("fused_qkv_attention_fwd", "nomad_tpu_torch/csrc/fused_attention.cu",
         "nomad_tpu/ops/fused_attention.py:93"),
        ("fused_qkv_attention_bf16_fwd", "nomad_tpu_torch/csrc/fused_attention_bf16.cu",
         "nomad_tpu/ops/fused_attention.py:93"),
        ("fused_qkv_attention_high3_fwd", "nomad_tpu_torch/csrc/fused_attention_bf16.cu",
         "nomad_tpu/ops/fused_attention.py:93"),
        ("layernorm_fwd", "nomad_tpu_torch/csrc/layernorm.cu", "nomad_tpu/ops/layernorm.py:31"),
        ("flash_attention_bf16io_fwd", "nomad_tpu_torch/csrc/flash_attention_bf16.cu",
         "nomad_tpu/ops/flash_attention.py:37"),
        ("flash_attention_bwd_dq_bf16io", "nomad_tpu_torch/csrc/flash_attention_bwd_bf16.cu",
         "nomad_tpu/ops/flash_attention.py:182"),
        ("flash_attention_bwd_dkv_bf16io", "nomad_tpu_torch/csrc/flash_attention_bwd_bf16.cu",
         "nomad_tpu/ops/flash_attention.py:222"),
        ("layernorm_fwd_bf16io", "nomad_tpu_torch/csrc/layernorm.cu",
         "nomad_tpu/ops/layernorm.py:31"),
        ("fused_qkv_attention_f32_bf16io_fwd", "nomad_tpu_torch/csrc/fused_attention_bf16.cu",
         "nomad_tpu/ops/fused_attention.py:93"),
        ("fused_qkv_attention_bf16io_fwd", "nomad_tpu_torch/csrc/fused_attention_bf16.cu",
         "nomad_tpu/ops/fused_attention.py:93"),
        ("fused_qkv_attention_high3_bf16io_fwd", "nomad_tpu_torch/csrc/fused_attention_bf16.cu",
         "nomad_tpu/ops/fused_attention.py:93"),
        ("flash_attention_f32_bf16io_fwd", "nomad_tpu_torch/csrc/flash_attention_bf16.cu",
         "nomad_tpu/ops/flash_attention.py:37"),
        ("flash_attention_bwd_dq_f32_bf16io", "nomad_tpu_torch/csrc/flash_attention_bwd_bf16.cu",
         "nomad_tpu/ops/flash_attention.py:182"),
        ("flash_attention_bwd_dkv_f32_bf16io",
         "nomad_tpu_torch/csrc/flash_attention_bwd_bf16.cu",
         "nomad_tpu/ops/flash_attention.py:222"),
        # K2b/K3b's prologue: the fold the JAX package does outside its kernels
        ("flash_attention_bwd_fold_bf16", "nomad_tpu_torch/csrc/flash_attention_bwd_bf16.cu",
         "nomad_tpu/ops/flash_attention.py:143"),
        ("flash_attention_bwd_fold_bf16io", "nomad_tpu_torch/csrc/flash_attention_bwd_bf16.cu",
         "nomad_tpu/ops/flash_attention.py:143"),
        # K1b's prologue: the fold the JAX package does ahead of its forward
        ("flash_attention_fwd_fold_bf16", "nomad_tpu_torch/csrc/flash_attention_bf16.cu",
         "nomad_tpu/ops/flash_attention.py:143"),
        ("flash_attention_fwd_fold_bf16io", "nomad_tpu_torch/csrc/flash_attention_bf16.cu",
         "nomad_tpu/ops/flash_attention.py:143"),
    ):
        k = report["kernels"][name]
        m = k["main"]
        by_path = {path: c[name] for path, c in report["launches"].items()}
        row = {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(v["max_abs_err"] for v in k.values()),
            "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m["library_ms"],
        }
        if "train" in k:  # K2/K3, K2b/K3b: the loss crop above, [24, 499] (10 s clips) beside it
            row |= {f"train_{f}": k["train"][f]
                    for f in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        if "f32_io_ms" in m:  # a bf16-I/O flavour: its f32-I/O flavour's time beside it
            row["f32_io_ms"] = m["f32_io_ms"]
        # K2b/K3b: the pair through its wrapper, in turns with library_ms, and
        # the work's bound
        row |= {f: m[f] for f in ("pair_ms", "pair_bound_ms") if f in m}
        row |= {f"train_{f}": k["train"][f] for f in ("pair_ms", "pair_bound_ms")
                if f in k.get("train", {})}
        # K1b: the kernel alone beside the call, both yardsticks' turns
        row |= {f: m[f] for f in ("kernel_ms", "kernel_bound_ms", "kernel_bound_by",
                                  "library_casts_inside_ms", "call_in_turns_ms",
                                  "call_in_turns_inside_ms") if f in m}
        rows.append(row)
    unlaunched = [r["name"] for r in rows if r["launches"] == 0]
    if unlaunched:
        fail(f"kernels no path launched: {unlaunched}")
    print("report: " + json.dumps(report, default=float))
    print("kernels: " + "; ".join(
        f"{r['name']} max|d| {r['max_abs_err']:.3g} {r['ms']:.4f} ms (bound {r['bound_ms']:.4f})"
        for r in rows))
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
