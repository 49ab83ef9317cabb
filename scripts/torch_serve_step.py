"""Time the port's streaming serving step on the card: phase 4 of
``chip_smoke.py`` alone.  qwen2-0.5b at full width with
``SERVE_ZAMPLING``, u8 words from ``RandomState(SEED)`` scores, the 4
ragged ``PROMPTS`` over ``LANES`` lanes, ``NEW_TOKENS`` new tokens
each; a warm-up run, then ``--reps`` timed runs of the scheduler.

    python scripts/torch_serve_step.py [--src DIR] [--label NAME] [--reps N]
                                       [--profile N]

``--src`` names the directory that holds the ``repro_torch`` package
to time (default: this checkout's ``src/``), so that two trees can be
timed in turn on one card in one session (parent, change, change,
parent).  The constants come from this checkout's ``chip_smoke.py``.
Prints one JSON line: the label, the card's name and power limit, the
package's path, the median ms/step of each timed run, and whether each
run's tokens are ``SERVE_TOKENS``.  ``--profile N`` adds one more run
under cProfile and one under torch.profiler: the N host functions of
most own time, and the run's device time with its N kernels of most
device time.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="directory holding the repro_torch package")
    ap.add_argument("--label", default="tree")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--profile", type=int, default=0)
    args = ap.parse_args()
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    sys.path.insert(1, str(ROOT))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("torch sees no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False

    import chip_smoke as cs
    import repro_torch
    from repro_torch.configs import get_arch
    from repro_torch.core.zampling import ZamplingConfig, build_specs
    from repro_torch.models.model import build_model, param_template
    from repro_torch.serve import (ServeConfig, ServeScheduler,
                                   make_serve_state)

    if not Path(repro_torch.__file__).resolve().is_relative_to(src):
        sys.exit(f"repro_torch came from {repro_torch.__file__}, not {src}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0].strip()
    dev = torch.device("cuda")
    cfg = get_arch("qwen2-0.5b")
    model = build_model(cfg)
    zspecs = build_specs(param_template(cfg),
                         ZamplingConfig(**cs.SERVE_ZAMPLING))
    rng = np.random.RandomState(cs.SEED)  # as chip_smoke.main draws them
    scores = {p: rng.rand(s.n).astype(np.float32)
              for p, s in zspecs.specs.items()}
    dense = {}
    for p in zspecs.dense_paths:
        shape = zspecs.template[p].shape
        dense[p] = (np.ones(shape, np.float32) if "ln" in p or "norm" in p
                    else (0.02 * rng.randn(*shape)).astype(np.float32))
    sstate = make_serve_state(zspecs, {"scores": scores, "dense": dense},
                              cs.DRAW_WORD, downlink="u8", dither_word=0,
                              device=dev)
    scfg = ServeConfig(lanes=cs.LANES,
                       seq_len=max(map(len, cs.PROMPTS)) + cs.NEW_TOKENS,
                       mode="streaming", max_new_tokens=cs.NEW_TOKENS)
    sched = ServeScheduler(model, sstate, scfg, device=dev)

    def run():
        rids = [sched.submit(p) for p in cs.PROMPTS]
        step_ms = []
        while sched.pending:
            t0 = time.perf_counter()
            sched.step_once()  # ends in the host sync of the logits
            step_ms.append(1e3 * (time.perf_counter() - t0))
        return step_ms, [sched.results[r].tolist() for r in rids]

    medians, equal = [], []
    for rep in range(args.reps + 1):  # the first run warms up
        step_ms, toks = run()
        if rep:
            medians.append(float(np.median(step_ms)))
            equal.append(toks == cs.SERVE_TOKENS)
    out = {"label": args.label, "card": card, "src": str(src),
           "steps": len(step_ms), "median_step_ms": medians,
           "tokens_equal": equal}
    if args.profile:
        import cProfile
        import pstats

        prof = cProfile.Profile()
        prof.enable()
        step_ms, _ = run()
        prof.disable()
        st = pstats.Stats(prof)
        host = sorted(st.stats.items(), key=lambda kv: -kv[1][2])
        out["profiled_run_ms"] = sum(step_ms)
        out["host_top"] = [
            [f"{Path(f).name}:{line}({name})", calls, 1e3 * tot, 1e3 * cum]
            for (f, line, name), (_, calls, tot, cum, _) in
            host[:args.profile]]
        by_tag, total, top = cs.profile_device_us(lambda: run(), (),
                                                  top=args.profile)
        out["device_ms_a_run"] = 1e-3 * total
        out["device_top"] = [[n, 1e-3 * us, k] for n, us, k in top]
    print(json.dumps(out))


if __name__ == "__main__":
    main()
