"""Digests of the attention kernels' outputs on seeded inputs: one SHA-256
per kernel flavour and shape, to hold two checkouts to the same bits on
one card.

    python -m nomad_tpu_torch.kernel_digests > this.json
    cd <other checkout> && python -c "import runpy; runpy.run_path(
        '<this checkout>/nomad_tpu_torch/kernel_digests.py', run_name='__main__')" > other.json

Runs K1, K1-bf16 and K1b (O and LSE), K1r (O and LSE, f32, with a seeded
gate and bias table), K2 + K3 (f32 tensors at
"highest"), K2-bf16 + K3-bf16 (bf16 tensors at "highest") and K2b + K3b
(dQ, dK, dV) through ``mha_flash`` and ``flash_attention_bwd``, and K4,
K4-bf16, K4b and K4h through ``fused_qkv_mha`` (at "highest" on f32 and
on bf16 x, "default" and "high"), on f32 and on bf16 inputs made from one
seed, at the
scoring shape [96, 511], the loss crop [32, 50] and a ragged [8, 1024],
each with a 0-key row (ragged rows and a 1-key row at [96, 511] and
[8, 1024]). Prints one JSON object
{case: digest of the outputs' bytes}; a case the checkout's wrappers
refuse (a flavour it does not have) reads "refused: <error>". Run in two
checkouts on one card, the objects must agree on every case both have
when a change must keep a kernel's bits (a template that grows another
flavour, say). Needs a CUDA card; the kernels build at first use.
"""

from __future__ import annotations

import hashlib
import json
import sys

import torch

from nomad_tpu_torch.api import set_exact_precision
from nomad_tpu_torch.ops import flash_attention, fused_attention

SHAPES = ((96, 511, [511, 1, 0] + [499] * 93), (32, 50, [50] * 31 + [0]),
          (8, 1024, [1024, 700, 513, 64, 2, 1, 1024, 0]))
HEADS, WIDTH = 12, 768


def digest(tensors) -> str:
    h = hashlib.sha256()
    for x in tensors:
        h.update(x.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def cases(dev: torch.device) -> dict:
    g = torch.Generator().manual_seed(2024)
    out = {}
    for b, t, lens in SHAPES:
        q, k, v = torch.randn(b, t, 3, HEADS, 64, generator=g).to(dev).unbind(2)
        do = torch.randn(b, t, HEADS, 64, generator=g).to(dev)
        x = torch.randn(b, t, WIDTH, generator=g).to(dev)
        params = [a.to(dev) for _ in range(3) for a in (
            torch.randn(WIDTH, WIDTH, generator=g) / WIDTH**0.5,
            0.1 * torch.randn(WIDTH, generator=g))]
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        gr = torch.Generator().manual_seed(2027 + t)  # the other cases' draws stay as they were
        gate = (1.0 + 2.0 * torch.rand(b, HEADS, t, generator=gr)).to(dev)
        table = (0.3 * torch.randn(HEADS, 2 * t - 1, generator=gr)).to(dev)
        try:
            out[f"flash_rel_fwd_T{t}"] = digest(flash_attention.mha_flash_rel(
                q, k, v, gate, table, lengths))
        except (AttributeError, TypeError, ValueError, RuntimeError) as err:
            out[f"flash_rel_fwd_T{t}"] = f"refused: {err}"
        for io in (torch.float32, torch.bfloat16):
            qi, ki, vi, doi, xi = (a.to(io) for a in (q, k, v, do, x))
            for prec in ("highest", "default"):
                tag = f"{prec}_{str(io)[6:]}_io_T{t}"
                try:
                    o, lse = flash_attention.mha_flash(qi, ki, vi, lengths, prec)
                    out[f"flash_fwd_{tag}"] = digest((o, lse))
                    out[f"flash_bwd_{tag}"] = digest(flash_attention.flash_attention_bwd(
                        qi, ki, vi, o, lse, doi, lengths, prec))
                except (TypeError, ValueError, RuntimeError) as err:
                    out[f"flash_{tag}"] = f"refused: {err}"
            # "high" moves only the fused route's kernel (K4h; the flash
            # kernels take "high" as "highest")
            for prec in ("highest", "default", "high"):
                tag = f"{prec}_{str(io)[6:]}_io_T{t}"
                try:
                    out[f"fused_{tag}"] = digest((fused_attention.fused_qkv_mha(
                        xi, *params, lengths, HEADS, prec),))
                except (TypeError, ValueError, RuntimeError) as err:
                    out[f"fused_{tag}"] = f"refused: {err}"
    torch.cuda.synchronize()
    return out


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("kernel_digests: needs a CUDA card")
    set_exact_precision()
    print(json.dumps(cases(torch.device("cuda")), indent=1, sort_keys=True))


if __name__ == "__main__":
    main()
