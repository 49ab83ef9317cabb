"""Times the upload-pack kernels of two or more source trees on one card.

Kernel 10 (``qz_sample_pack_batched_fwd``, K=10 clients) and kernel 9
(``qz_sample_pack_fwd``, one client, where a tree has it) run at
chip_smoke's Fig. 4 MNISTFC leaves (784-300-100-10, compression 8,
d=10, window 128) on the same seeded probabilities and draw words, for
each tree in the order given, all in one process: a tree named twice
(A B B A) is timed twice, so drift shows.  Each tree's kernels are built
from that tree's sources into its own ``build/``.  The timers are
chip_smoke's: CUDA-event ms per launch over 50 back-to-back launches
(host launch cost included) and device ms per launch by torch.profiler
over 10.  Every tree's lanes must equal the first tree's, bit for bit,
and kernel 9's must equal kernel 10's row.

Usage, from the repo root on a machine with a CUDA GPU (``before/`` a
copy of another revision, e.g. unpacked with ``git archive``):
    python3 chip_pack_ab.py before . . before
It prints, per tree and kernel, the leaves' times, their sum for one
round, and last one JSON line with every number and the card's name and
power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import chip_smoke as cs

LEAF_KERNEL = "sample_pack"  # the profiler tag of both trees' pack kernels


def load_tree(tree: Path) -> dict:
    """Import ``tree``'s port and start its kernels' build; returns what
    the timing needs.  The modules are dropped from ``sys.modules`` so
    that the next tree imports its own."""
    src = str(tree.resolve() / "src")
    sys.path.insert(0, src)
    try:
        from repro_torch.configs.mnistfc import MNISTFC
        from repro_torch.core.sampling import as_words
        from repro_torch.core.zampling import ZamplingConfig, build_specs
        from repro_torch.kernels import qz_reconstruct as qr
        from repro_torch.models.mlp import mlp_template

        if Path(qr.__file__).resolve().parents[3] != tree.resolve():
            raise RuntimeError(f"imported {qr.__file__}, not {tree}'s port")
        qr.LIBRARY.start()
        return {"qr": qr, "as_words": as_words,
                "specs": build_specs(mlp_template(MNISTFC),
                                     ZamplingConfig(**cs.FED_ZAMPLING)).specs}
    finally:
        sys.path.remove(src)
        for name in [n for n in sys.modules if n.split(".")[0]
                     == "repro_torch"]:
            del sys.modules[name]


def time_tree(t: dict, P, words, dev) -> dict:
    """{kernel: {leaf: (ms, device ms), "lanes": {leaf: tensor}}}."""
    qr = t["qr"]
    steps = t["as_words"](words, dev)
    out = {}
    kernels = {"qz_sample_pack_batched_fwd": lambda spec, p: (
        qr.qz_sample_pack_batched_fwd(spec, p, steps))}
    if hasattr(qr, "qz_sample_pack_fwd"):
        kernels["qz_sample_pack_fwd"] = lambda spec, p: (
            qr.qz_sample_pack_fwd(spec, p[0].contiguous(), words[0]))
    for name, call in kernels.items():
        leaves, lanes = {}, {}
        for path, spec in t["specs"].items():
            p = P[path]
            lanes[path] = call(spec, p)
            ms = cs.event_ms(lambda: call(spec, p), 50)
            by_tag, _ = cs.profile_device_us(
                lambda: [call(spec, p) for _ in range(10)], (LEAF_KERNEL,))
            us, n = by_tag[LEAF_KERNEL]
            leaves[path] = (ms, 1e-3 * us / n if n else None)
        out[name] = {"leaves": leaves, "lanes": lanes}
    return out


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available() or len(sys.argv) < 3:
        cs.die("needs a CUDA device and two or more source trees")
    trees = [Path(a) for a in sys.argv[1:]]
    loaded = {}
    for tree in trees:
        if tree.resolve() not in loaded:
            loaded[tree.resolve()] = load_tree(tree)
    for t in loaded.values():
        t["qr"].build()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    specs = next(iter(loaded.values()))["specs"]
    rng = np.random.RandomState(cs.SEED)
    P = {path: torch.from_numpy(np.clip(
        rng.rand(cs.FED_K, s.n).astype(np.float32) * 1.2 - 0.1, 0, 1)
    ).to(dev) for path, s in specs.items()}
    words = [int(w) for w in rng.randint(0, 2**32, cs.FED_K,
                                         dtype=np.uint64)]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    runs, first = [], None
    for tree in trees:
        got = time_tree(loaded[tree.resolve()], P, words, dev)
        ref = got["qz_sample_pack_batched_fwd"]["lanes"]
        first = first or ref
        for path in specs:
            if not torch.equal(ref[path], first[path]):
                cs.die(f"{tree}'s kernel 10 lanes differ from "
                       f"{trees[0]}'s at {path}")
            one = got.get("qz_sample_pack_fwd")
            if one and not torch.equal(one["lanes"][path], ref[path][0]):
                cs.die(f"{tree}'s kernel 9 differs from kernel 10's row "
                       f"at {path}")
        for name, r in got.items():
            ms = sum(v[0] for v in r["leaves"].values())
            dms = [v[1] for v in r["leaves"].values()]
            dsum = None if None in dms else sum(dms)
            cs.say(f"ab: {tree} {name}: " + ", ".join(
                f"{p} {v[0]:.4f} ms (device "
                + ("not measured" if v[1] is None else f"{v[1]:.4f} ms")
                + ")" for p, v in r["leaves"].items())
                + f"; one round {ms:.4f} ms (device "
                + ("not measured" if dsum is None else f"{dsum:.4f} ms")
                + f") ({card})")
            runs.append({"tree": str(tree), "kernel": name, "ms": ms,
                         "device_ms": dsum, "leaves": {
                             p: {"ms": v[0], "device_ms": v[1]}
                             for p, v in r["leaves"].items()}})
    cs.say(f"ab: every tree's lanes equal the first tree's ({card})")
    cs.say(json.dumps({"card": card, "runs": runs}))


if __name__ == "__main__":
    main()
