"""Persistent scoring service (counterpart of ``nomad_tpu.serve``): the
model stays loaded on the card between requests, and unchanged files reuse
their embeddings.

JSON-lines protocol over stdin/stdout (or any file pair): one request per
line, one response per line.

Requests:
  {"op": "score", "nmr": <dir-or-csv>, "deg": <dir-or-csv>,
   "results_path": <dir or null>, "mode": "dir" | "csv"}
  {"op": "embed", "paths": [...]}
  {"op": "loss", "estimate": [[...]], "clean": [[...]]}  -> a float
  {"op": "warm", "seconds": [10, 30]}  -> one zero batch per shape
  {"op": "stats"}      -> spans, precision, transfer and cache counters
  {"op": "ping"} / {"op": "shutdown"}

A request that fails, or an unknown op, gets ``{"ok": false, "error": ...}``
and the service goes on. Unchanged files (path, mtime and size) reuse their
embedding across requests (``--no-cache`` turns it off); the cache is an
LRU of ``--cache-size`` entries, ~1 KB each, kept on the device.

Run: ``python -m nomad_tpu_torch.serve [--model base|tiny] [--warm 10 30]
[--device cuda|cpu] [--precision exact|balanced|fast]``. stdout carries
only the JSON responses: the API's banners go to stderr. Runs on ``cuda``
unless ``--device cpu``. ``--precision`` picks the model's islands (the
tiny model's too) and ``stats`` reports it; the embedding cache belongs
to the server's one model.
"""

from __future__ import annotations

import json
import sys
import time
import traceback
from typing import Optional


class NomadServer:
    def __init__(self, nomad=None, model: str = "base", cache: bool = True,
                 cache_size: int = 65536, precision: str = "exact",
                 device: Optional[str] = None):
        if nomad is None:
            from .api import Nomad, check_precision
            from .models.wav2vec2 import PRECISION_ISLANDS, Wav2Vec2Config

            config = None
            if model == "tiny":
                check_precision(precision)
                config = Wav2Vec2Config.tiny(**PRECISION_ISLANDS[precision])
            nomad = Nomad(device=device, config=config, emb_dim=16 if config else 256,
                          precision=precision)
            self.precision = precision
        else:
            self.precision = "custom"  # the caller's model and weights
        self.nomad = nomad
        if cache:
            from .scoring.engine import EmbeddingLRU

            self.nomad.engine.file_cache = EmbeddingLRU(maxsize=cache_size)

    def warmup(self, seconds=(10.0,)) -> dict:
        """One zero batch at each duration's full batch shape and at tails of
        1, 8 and 32 rows (``EmbeddingEngine.prewarm``), so that the first
        request does not pay for loading kernels and settling cuDNN and the
        allocator."""
        t0 = time.time()
        self.nomad.engine.prewarm(tuple(seconds))
        total = round(time.time() - t0, 2)
        return {str(s): total for s in seconds} | {"total": total}

    def handle(self, req: dict) -> dict:
        op = req.get("op")
        if op == "ping":
            return {"ok": True, "op": "ping"}
        if op == "warm":
            return {"ok": True, "warmed_s": self.warmup(tuple(req.get("seconds", (10.0,))))}
        if op == "stats":
            from .utils.profiling import GLOBAL

            eng = self.nomad._engine
            cache = eng.file_cache if eng is not None else None
            return {
                "ok": True,
                "stats": GLOBAL.stats(),
                "precision": self.precision,
                "transfer": eng.transfer_stats() if eng is not None else {},
                "embed_cache": {
                    "enabled": cache is not None,
                    "hits": eng.cache_hits if eng is not None else 0,
                    **(cache.stats() if cache is not None else {}),
                },
            }
        if op == "score":
            avg, dm = self.nomad.predict(req.get("mode", "dir"), req["nmr"], req["deg"],
                                         req.get("results_path"))
            return {"ok": True, "avg": avg.records(), "pairwise": dm.records()}
        if op == "embed":
            emb = self.nomad.engine.embed_files(req["paths"])
            return {"ok": True, "embeddings": emb.tolist()}
        if op == "loss":
            import numpy as np
            import torch

            with torch.no_grad():
                loss = self.nomad.forward(np.asarray(req["estimate"], np.float32),
                                          np.asarray(req["clean"], np.float32))
            return {"ok": True, "loss": float(loss)}
        if op == "shutdown":
            return {"ok": True, "op": "shutdown"}
        return {"ok": False, "error": f"unknown op {op!r}"}

    def run(self, infile=None, outfile=None) -> None:
        infile = infile or sys.stdin
        outfile = outfile or sys.stdout
        for line in infile:
            line = line.strip()
            if not line:
                continue
            try:
                resp = self.handle(json.loads(line))
            except Exception as e:  # noqa: BLE001 - the service must not die
                resp = {"ok": False, "error": f"{type(e).__name__}: {e}",
                        "traceback": traceback.format_exc(limit=3)}
            outfile.write(json.dumps(resp) + "\n")
            outfile.flush()
            if resp.get("op") == "shutdown":
                break


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(prog="python -m nomad_tpu_torch.serve")
    ap.add_argument("--model", default="base", choices=["base", "tiny"])
    ap.add_argument("--precision", default="exact", choices=["balanced", "exact", "fast"],
                    help="exact (f32, TF32 off; the default) or the JAX package's recipes "
                    "balanced and fast (one bf16 pass on their islands)")
    ap.add_argument("--warm", type=float, nargs="*", default=None, metavar="SECONDS",
                    help="run one zero batch per batch shape of these file durations at "
                    "startup (e.g. --warm 10 30)")
    ap.add_argument("--no-cache", action="store_true",
                    help="disable the per-file embedding cache (unchanged files reuse "
                    "their embedding across requests by default)")
    ap.add_argument("--cache-size", type=int, default=65536,
                    help="embedding-cache entry cap (LRU eviction beyond it; ~1 KB/entry)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    # the protocol stream carries only JSON responses; the API prints the
    # reference's banners ("NOMAD running on", the embedding banners), so
    # stdout goes to stderr while the server lives
    real_out = sys.stdout
    sys.stdout = sys.stderr
    try:
        server = NomadServer(model=args.model, cache=not args.no_cache,
                             cache_size=args.cache_size, precision=args.precision,
                             device=args.device)
        if args.warm is not None:
            durations = tuple(args.warm) or (10.0,)
            print(json.dumps({"warmed_s": server.warmup(durations)}), file=sys.stderr)
        server.run(outfile=real_out)
    finally:
        sys.stdout = real_out


if __name__ == "__main__":
    main()
