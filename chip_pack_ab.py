"""Times the upload-pack or the serve kernels of two or more source trees
on one card.

Pack mode (the default): kernel 10 (``qz_sample_pack_batched_fwd``,
K=10 clients) and kernel 9 (``qz_sample_pack_fwd``, one client, where a
tree has it) at chip_smoke's Fig. 4 MNISTFC leaves (784-300-100-10,
compression 8, d=10, window 128) on the same seeded probabilities and
draw words; every tree's lanes must equal the first tree's, bit for
bit, and kernel 9's must equal kernel 10's row.

Serve mode (``--serve``): kernel 12 (``qz_sample_matmul`` at B=4) and
kernel 11 (``qz_sample_matvec``, B=1) at the 8 zampled linears of
full-width qwen2-0.5b (chip_smoke's serving specs: compression 8, d=8),
group 0, on the same seeded u8 words and activations; every tree's
outputs must equal the first tree's, bit for bit.  A step's time sums
each shape's time over its launches in an engine step (24 for a block
linear, 1 for lm_head).

Each tree is timed in the order given, all in one process: a tree named
twice (A B B A) is timed twice, so drift shows.  Each tree's kernels are
built from that tree's sources into its own ``build/``.  The timers are
chip_smoke's: CUDA-event ms per launch over back-to-back launches (50
for pack, 10 for serve, 3 at lm_head; host launch cost included) and
device ms per launch by torch.profiler over 10 (3 at lm_head).

Usage, from the repo root on a machine with a CUDA GPU (``before/`` a
copy of another revision, e.g. unpacked with ``git archive``):
    python3 chip_pack_ab.py before . . before
    python3 chip_pack_ab.py --serve before . . before
It prints, per tree and kernel, the times, their sum for one round (or
engine step), and last one JSON line with every number and the card's
name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import chip_smoke as cs

LEAF_KERNEL = "sample_pack"  # the profiler tag of both trees' pack kernels
SERVE_KERNEL = "serve_matmul_kernel"  # and of their serve kernels
SERVE_PATHS = cs.LINEARS + ("lm_head",)


def load_tree(tree: Path, serve: bool) -> dict:
    """Import ``tree``'s port and start its kernels' build; returns what
    the timing needs.  The modules are dropped from ``sys.modules`` so
    that the next tree imports its own."""
    src = str(tree.resolve() / "src")
    sys.path.insert(0, src)
    try:
        from repro_torch.configs import get_arch
        from repro_torch.configs.mnistfc import MNISTFC
        from repro_torch.core.sampling import as_words
        from repro_torch.core.zampling import ZamplingConfig, build_specs
        from repro_torch.kernels import ops
        from repro_torch.kernels import qz_decode as qd
        from repro_torch.kernels import qz_reconstruct as qr
        from repro_torch.models.mlp import mlp_template
        from repro_torch.models.model import param_template

        if Path(qr.__file__).resolve().parents[3] != tree.resolve():
            raise RuntimeError(f"imported {qr.__file__}, not {tree}'s port")
        if serve:
            qd.LIBRARY.start()
            specs = build_specs(param_template(get_arch("qwen2-0.5b")),
                                ZamplingConfig(**cs.SERVE_ZAMPLING)).specs
            return {"qd": qd, "ops": ops,
                    "specs": {p: specs[p] for p in SERVE_PATHS}}
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


def time_serve(t: dict, words, X, dev) -> dict:
    """{kernel: {"shapes": {path: (ms, device ms)}, "out": {path: Y}}}."""
    qd, ops = t["qd"], t["ops"]
    out = {}
    for name, B in (("qz_sample_matmul", 4), ("qz_sample_matvec", 1)):
        shapes, ys = {}, {}
        for path, spec in t["specs"].items():
            _, d_in, d_out = ops.serve_group_dims(spec)
            x = X[path][:B]

            def call():
                if B == 1:
                    return qd.qz_sample_matvec(
                        spec, words[path], cs.DRAW_WORD, x[0], d_in=d_in,
                        d_out=d_out, qbits=8)[None]
                return qd.qz_sample_matmul(
                    spec, words[path], cs.DRAW_WORD, x, d_in=d_in,
                    d_out=d_out, qbits=8)

            ys[path] = call()
            reps = 3 if path == "lm_head" else 10
            ms = cs.event_ms(call, reps)
            by_tag, _ = cs.profile_device_us(
                lambda: [call() for _ in range(reps)], (SERVE_KERNEL,))
            us, n = by_tag[SERVE_KERNEL]
            shapes[path] = (ms, 1e-3 * us / n if n else None)
        out[name] = {"shapes": shapes, "out": ys}
    return out


def serve_main(trees, loaded, card, dev) -> None:
    import numpy as np
    import torch

    t0 = next(iter(loaded.values()))
    specs = t0["specs"]
    dims = {p: t0["ops"].serve_group_dims(s) for p, s in specs.items()}
    rng = np.random.RandomState(cs.SEED)
    words = {p: torch.from_numpy(rng.randint(0, 256, s.n).astype(np.uint8))
             .to(dev) for p, s in specs.items()}
    X = {p: torch.from_numpy(rng.randn(4, dims[p][1]).astype(np.float32))
         .to(dev) for p in specs}
    per_step = {p: dims[p][0] for p in specs}  # launches in an engine step
    runs, first = [], None
    for tree in trees:
        got = time_serve(loaded[tree.resolve()], words, X, dev)
        first = first or got
        for name, r in got.items():
            for path in specs:
                if not torch.equal(r["out"][path], first[name]["out"][path]):
                    cs.die(f"{tree}'s {name} differs from {trees[0]}'s at "
                           f"{path}")
            ms = sum(per_step[p] * v[0] for p, v in r["shapes"].items())
            dms = [v[1] for v in r["shapes"].values()]
            dsum = (None if None in dms else
                    sum(per_step[p] * v[1] for p, v in r["shapes"].items()))
            cs.say(f"ab: {tree} {name}: " + ", ".join(
                f"{p} {v[0]:.4f} ms (device "
                + ("not measured" if v[1] is None else f"{v[1]:.4f} ms")
                + ")" for p, v in r["shapes"].items())
                + f"; one engine step {ms:.3f} ms (device "
                + ("not measured" if dsum is None else f"{dsum:.3f} ms")
                + f") ({card})")
            runs.append({"tree": str(tree), "kernel": name, "ms": ms,
                         "device_ms": dsum, "shapes": {
                             p: {"ms": v[0], "device_ms": v[1],
                                 "launches_per_step": per_step[p]}
                             for p, v in r["shapes"].items()}})
    cs.say(f"ab: every tree's serve outputs equal the first tree's ({card})")
    cs.say(json.dumps({"card": card, "runs": runs}))


def main() -> None:
    import numpy as np
    import torch

    args = sys.argv[1:]
    serve = bool(args) and args[0] == "--serve"
    args = args[1:] if serve else args
    if not torch.cuda.is_available() or len(args) < 2:
        cs.die("needs a CUDA device and two or more source trees")
    trees = [Path(a) for a in args]
    loaded = {}
    for tree in trees:
        if tree.resolve() not in loaded:
            loaded[tree.resolve()] = load_tree(tree, serve)
    for t in loaded.values():
        (t["qd"] if serve else t["qr"]).build()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    if serve:
        serve_main(trees, loaded, card, dev)
        return
    specs = next(iter(loaded.values()))["specs"]
    rng = np.random.RandomState(cs.SEED)
    P = {path: torch.from_numpy(np.clip(
        rng.rand(cs.FED_K, s.n).astype(np.float32) * 1.2 - 0.1, 0, 1)
    ).to(dev) for path, s in specs.items()}
    words = [int(w) for w in rng.randint(0, 2**32, cs.FED_K,
                                         dtype=np.uint64)]
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
