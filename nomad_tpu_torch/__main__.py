"""CLI: ``python -m nomad_tpu_torch --mode dir --nmr X --deg Y`` — the
flags of ``python -m nomad_tpu``, on argparse."""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m nomad_tpu_torch")
    ap.add_argument("--mode", type=str, default="dir", help="Choose mode dir or csv")
    ap.add_argument("--nmr", type=str, default=None,
                    help="Path to non-matching reference files")
    ap.add_argument("--deg", type=str, default=None, help="Path to test files")
    ap.add_argument(
        "--results_path", type=str, default=None,
        help=(
            "Output directory for the two score CSVs (per-file averages and "
            "the full per-NMR matrix). When omitted, a timestamped folder is "
            "created under ./results-csv."
        ),
    )
    ap.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from .api import get_nomad

    nomad = get_nomad(device=args.device)
    nomad_avg, _scores = nomad.predict(args.mode, args.nmr, args.deg, args.results_path)
    print("Nomad average scores, printing top 5 test files")
    print(nomad_avg.head())


if __name__ == "__main__":
    main()
