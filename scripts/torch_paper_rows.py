"""Print the paper's experiment rows from the port, one JSON line each.

Runs ``repro_torch.experiments``' functions on the card (``--device
cpu`` for the plain torch path) and prints every row as a JSON line
``{"experiment", "cell", "full", "row", "seconds", "card"}``: the
cell's label and the seconds it took (``experiments.paper.
experiment_cells``), and the card's name and power limit as nvidia-smi
gives them.  It writes no file.

    python scripts/torch_paper_rows.py run_federated --full \\
        [--compressions 1 8 32]
    python scripts/torch_paper_rows.py run_heterogeneity run_sensitivity

A name is one of the nine functions of ``repro_torch.experiments``;
``all`` takes every one.  Without ``--full`` each runs at its ``quick``
grid, with it at the paper's.  ``--compressions`` picks Fig. 4's m/n
(``run_federated`` only), so one compression can take a call of its
own.  Needs a CUDA device unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def card_name(device: str) -> str:
    if device == "cpu":
        return "cpu"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        "nvidia-smi failed"


def main() -> None:
    from repro_torch.experiments import __all__ as names
    from repro_torch.experiments.paper import experiment_cells

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("names", nargs="+", help=f"all | {' | '.join(names)}")
    ap.add_argument("--full", action="store_true",
                    help="the paper's grids (default: the quick grids)")
    ap.add_argument("--compressions", type=float, nargs="+",
                    default=[1, 8, 32], help="Fig. 4's m/n")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import torch

    if args.device != "cpu" and not torch.cuda.is_available():
        sys.exit("torch sees no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_name(args.device)
    todo = list(names) if args.names == ["all"] else args.names
    comps = {f"m/n={int(c) if c == int(c) else c}"
             for c in args.compressions}
    for name in todo:
        for label, thunk in experiment_cells(name, not args.full,
                                             device=args.device):
            if name == "run_federated" and label not in comps:
                continue
            t0 = time.perf_counter()
            rows = thunk()
            if args.device != "cpu":
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            for row in rows:
                print(json.dumps({"experiment": name, "cell": label,
                                  "full": args.full, "row": row,
                                  "seconds": dt, "card": card},
                                 default=str), flush=True)


if __name__ == "__main__":
    main()
