"""Times the upload-pack, the serve or the backward kernels, or the
local step, of two or more source trees on one card.

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

Backward mode (``--bwd``): the one-client backward kernels, kernel 2
(``qz_reconstruct_bwd``, the scatter) at Fig. 6's three leaves (MNISTFC
at compression 1, d=16, window 128: chip_smoke's phase 12) and kernel 5
(``qz_reconstruct_bwd_plan``, the canonical plan) at Fig. 6's leaves
and at Fig. 4's (chip_smoke's federated specs, d=10: each rank's
backward in the sharded round); the K-client kernels 4
(``qz_reconstruct_batched_bwd``) and 6
(``qz_reconstruct_batched_bwd_plan``) at Fig. 4's leaves, K=10; and
kernel 4 at the 12 zampled leaves of full-width qwen2-0.5b (launch/
train.py's specs: compression 8, d=8), K=4, on seeded normal cotangents
except at ``embed``, whose rows are 0 but for LM_TOKENS seeded tokens'
d_model rows, as a batch's embedding gradient is.  The same cotangents
for every tree; every tree's outputs must equal the first tree's, bit
for bit.  A step's time sums a kernel's leaves (one launch each a local
step, or a K=10 round's step, or a K=4 LM step).

Forward mode (``--fwd``): the forward kernels, kernel 8
(``qz_sample_reconstruct_batched_fwd``, K=10) at Fig. 4's leaves on
seeded f32 probabilities and on seeded u8 words, kernel 3
(``qz_reconstruct_batched_fwd``, K=10) at Fig. 4's leaves on the masks
drawn from those probabilities (the composed round's operand), kernels
7 (``qz_sample_reconstruct_fwd``) and 1 (``qz_reconstruct_fwd``) at
Fig. 6's leaves (K=1, f32 probabilities), and kernel 8 at the 12 zampled
leaves of full-width qwen2-0.5b, K=4, on seeded f32 probabilities drawn
on the card (the LM's mean uploads and f32 downlink).  The same operands
and draw words for every tree; every tree's outputs must equal the
first tree's, bit for bit (through an int32 view).  A unit's time sums
a kernel's leaves (one launch each a Fig. 4 or Fig. 6 step, or a K=4 LM
step).

Step mode (``--step``): the local step the backward kernels serve,
``train_local_zampling`` of Fig. 6 ``zampling_d16`` (chip_smoke's phase
10 inputs: the same seeded scores, data and draw words), STEP_N steps on
the plan and STEP_N under ``REPRO_BWD_PLAN=scatter``; every tree's
losses must equal the first tree's, bit for bit.  A step's time is the
host's wall clock between batches, its median over steps 1 to STEP_N-1
(step 0 builds plans and layouts).

Each tree is timed in the order given, all in one process: a tree named
twice (A B B A) is timed twice, so drift shows.  Each tree's kernels are
built from that tree's sources into its own ``build/``.  The timers are
chip_smoke's: CUDA-event ms per launch over back-to-back launches (50
for pack and backward, 10 for serve and the LM's backward, 3 at
lm_head's serve; host launch cost included) and device ms per launch by
torch.profiler over 10 (3 at lm_head's serve).

A tree may be given as ``TREE@NAME=VALUE,NAME=VALUE``: a copy of TREE's
``src/`` under ``build/variants/`` with each named integer constant of
the port's kernels set to VALUE, where it is defined (``constexpr int
NAME = ...;`` in ``csrc/`` or ``NAME = ...`` at the top of a module of
``kernels/``), so one call compares tuning constants of one revision.

Usage, from the repo root on a machine with a CUDA GPU (``before/`` a
copy of another revision, e.g. unpacked with ``git archive``):
    python3 chip_pack_ab.py before . . before
    python3 chip_pack_ab.py --serve before . . before
    python3 chip_pack_ab.py --bwd before . . before
    python3 chip_pack_ab.py --fwd before . . before
    python3 chip_pack_ab.py --step before . . before before . . before
    python3 chip_pack_ab.py --bwd . .@EDGE_ILP=1 .@EDGE_ILP=1 .
It prints, per tree and kernel, the times, their sum for one round (or
engine step), and last one JSON line with every number and the card's
name and power limit.
"""

from __future__ import annotations

import contextlib
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import chip_smoke as cs

LEAF_KERNEL = "sample_pack"  # the profiler tag of both trees' pack kernels
SERVE_KERNEL = "serve_matmul_kernel"  # and of their serve kernels
SERVE_PATHS = cs.LINEARS + ("lm_head",)
# the backward kernels' profiler tags: each names both trees' kernels
# (a timed window launches one kernel only)
BWD_TAGS = {"qz_reconstruct_bwd": "scatter_bwd",
            "qz_reconstruct_bwd_plan": "plan_bwd",
            "qz_reconstruct_batched_bwd": "scatter_bwd",
            "qz_reconstruct_batched_bwd_plan": "plan_bwd"}
# the forward kernels' profiler tags: each names both the old and the
# new trees' kernels (sample_reconstruct_kernel and its successor
# sample_reconstruct_window_kernel; likewise mask_)
FWD_TAGS = {"qz_sample_reconstruct_batched_fwd": "sample_reconstruct",
            "qz_sample_reconstruct_fwd": "sample_reconstruct",
            "qz_reconstruct_batched_fwd": "mask_reconstruct",
            "qz_reconstruct_fwd": "mask_reconstruct"}
STEP_N = 200  # local steps a tree takes on each backward path
LM_TOKENS = 512  # embed's live tokens: chip_smoke's LM batch 4 x seq 128


def variant_tree(arg: str) -> Path:
    """The tree an argument names: ``TREE``, or ``TREE@NAME=VALUE,...``
    copied with those constants set (see the module's docstring)."""
    tree, _, sets = arg.partition("@")
    if not sets:
        return Path(tree)
    root = Path(__file__).resolve().parent / "build" / "variants" / re.sub(
        r"[^A-Za-z0-9_=.-]+", "_", arg)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(Path(tree) / "src", root / "src",
                    ignore=shutil.ignore_patterns("__pycache__"))
    port = root / "src" / "repro_torch"
    for item in sets.split(","):
        name, value = item.split("=")
        found = 0
        for path in [*(port / "csrc").glob("*.cu"),
                     *(port / "kernels").glob("*.py")]:
            text = path.read_text()
            text, n = re.subn(
                rf"(^constexpr\s+int\s+{name}\s*=\s*)\d+;"
                rf"|(^{name}\s*=\s*)\d+$",
                lambda m: f"{m.group(1) or m.group(2)}{int(value)}"
                + (";" if m.group(1) else ""), text, flags=re.M)
            if n:
                path.write_text(text)
                found += n
        if found != 1:
            cs.die(f"{arg}: {name} is defined {found} times in {tree}")
    return root


def load_tree(tree: Path, mode: str) -> dict:
    """Import ``tree``'s port and start its kernels' build; returns what
    the timing needs.  The modules are dropped from ``sys.modules`` so
    that the next tree imports its own."""
    src = str(tree.resolve() / "src")
    sys.path.insert(0, src)
    try:
        from repro_torch.configs import get_arch
        from repro_torch.configs.mnistfc import MNISTFC
        from repro_torch.core.sampling import as_words, sample_mask_hash
        from repro_torch.core.zampling import ZamplingConfig, build_specs
        from repro_torch.kernels import ops
        from repro_torch.kernels import qz_decode as qd
        from repro_torch.kernels import qz_reconstruct as qr
        from repro_torch.models.mlp import mlp_template
        from repro_torch.models.model import param_template

        if Path(qr.__file__).resolve().parents[3] != tree.resolve():
            raise RuntimeError(f"imported {qr.__file__}, not {tree}'s port")
        if mode == "step":
            from repro_torch.core.zampling import init_state
            from repro_torch.data import make_teacher_dataset
            from repro_torch.models.mlp import mlp_loss
            from repro_torch.train import (LocalTrainConfig,
                                           train_local_zampling)

            qr.LIBRARY.start()
            zs = build_specs(mlp_template(MNISTFC), ZamplingConfig(
                compression=1.0, d=cs.LOCAL_D, window=128, min_size=128,
                seed=0))
            # the step imports lazily: the tree's modules and path are
            # put back while it runs (``active``)
            return {"qr": qr, "zs": zs, "init_state": init_state,
                    "src": src, "modules": {
                        n: m for n, m in sys.modules.items()
                        if n.split(".")[0] == "repro_torch"},
                    "data": make_teacher_dataset, "loss": mlp_loss,
                    "cfg": LocalTrainConfig, "train": train_local_zampling}
        if mode in ("bwd", "fwd"):
            qr.LIBRARY.start()
            fig6 = build_specs(mlp_template(MNISTFC), ZamplingConfig(
                compression=1.0, d=cs.LOCAL_D, window=128, min_size=128,
                seed=0)).specs
            fig4 = build_specs(mlp_template(MNISTFC),
                               ZamplingConfig(**cs.FED_ZAMPLING)).specs
            lm = build_specs(param_template(get_arch("qwen2-0.5b")),
                             ZamplingConfig(compression=8, d=8,
                                            min_size=4096)).specs
            return {"qr": qr, "fig6": fig6, "fig4": fig4, "lm": lm,
                    "as_words": as_words,
                    "sample_mask_hash": sample_mask_hash}
        if mode == "serve":
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


def time_bwd(t: dict, g6, g4, G4, GL) -> dict:
    """{kernel: {"leaves": {name: (ms, device ms)}, "out": {name: grad}}}
    for kernels 2 and 5 (one client), 4 and 6 (K=10) and 4 (K=4, the
    LM's leaves)."""
    qr = t["qr"]
    calls = {
        "qz_reconstruct_bwd": [
            (f"Fig. 6 {p}", lambda s=s, p=p: qr.qz_reconstruct_bwd(s, g6[p]))
            for p, s in t["fig6"].items()],
        "qz_reconstruct_bwd_plan": [
            (f"Fig. 6 {p}",
             lambda s=s, p=p: qr.qz_reconstruct_bwd_plan(s, g6[p]))
            for p, s in t["fig6"].items()] + [
            (f"Fig. 4 {p}",
             lambda s=s, p=p: qr.qz_reconstruct_bwd_plan(s, g4[p]))
            for p, s in t["fig4"].items()],
        "qz_reconstruct_batched_bwd": [
            (f"Fig. 4 {p}",
             lambda s=s, p=p: qr.qz_reconstruct_batched_bwd(s, G4[p]))
            for p, s in t["fig4"].items()] + [
            (f"LM {p}",
             lambda s=s, p=p: qr.qz_reconstruct_batched_bwd(s, GL[p]))
            for p, s in t["lm"].items()],
        "qz_reconstruct_batched_bwd_plan": [
            (f"Fig. 4 {p}",
             lambda s=s, p=p: qr.qz_reconstruct_batched_bwd_plan(s, G4[p]))
            for p, s in t["fig4"].items()]}
    out = {}
    for name, leaves in calls.items():
        times, grads = {}, {}
        for leaf, call in leaves:
            grads[leaf] = call()
            ms = cs.event_ms(call, 10 if leaf.startswith("LM") else 50)
            tag = BWD_TAGS[name]
            by_tag, _ = cs.profile_device_us(
                lambda: [call() for _ in range(10)], (tag,))
            us, n = by_tag[tag]
            times[leaf] = (ms, 1e-3 * us / n if n else None)
        out[name] = {"leaves": times, "out": grads}
    return out


def time_fwd(t: dict, ops: dict) -> dict:
    """{kernel: {"leaves": {name: (ms, device ms)}, "out": {name: W}}}
    for kernels 8 and 3 (K=10, Fig. 4; 8 also K=4, the LM's leaves) and
    7 and 1 (one client, Fig. 6)."""
    qr = t["qr"]
    s10, s1, sL = (t["as_words"](ops[k], ops["dev"])
                   for k in ("words10", "words1", "wordsL"))
    calls = {
        "qz_sample_reconstruct_batched_fwd": [
            (f"Fig. 4 f32 {p}", lambda s=s, p=p:
             qr.qz_sample_reconstruct_batched_fwd(s, ops["P4"][p], s10))
            for p, s in t["fig4"].items()] + [
            (f"Fig. 4 u8 {p}", lambda s=s, p=p:
             qr.qz_sample_reconstruct_batched_fwd(s, ops["Q4"][p], s10, 8))
            for p, s in t["fig4"].items()] + [
            (f"LM {p}", lambda s=s, p=p:
             qr.qz_sample_reconstruct_batched_fwd(s, ops["PL"][p], sL))
            for p, s in t["lm"].items()],
        "qz_reconstruct_batched_fwd": [
            (f"Fig. 4 masks {p}", lambda s=s, p=p:
             qr.qz_reconstruct_batched_fwd(s, ops["Z4"][p]))
            for p, s in t["fig4"].items()],
        "qz_sample_reconstruct_fwd": [
            (f"Fig. 6 f32 {p}", lambda s=s, p=p:
             qr.qz_sample_reconstruct_fwd(s, ops["p6"][p], s1))
            for p, s in t["fig6"].items()],
        "qz_reconstruct_fwd": [
            (f"Fig. 6 f32 {p}", lambda s=s, p=p:
             qr.qz_reconstruct_fwd(s, ops["p6"][p]))
            for p, s in t["fig6"].items()]}
    out = {}
    for name, leaves in calls.items():
        times, ws = {}, {}
        for leaf, call in leaves:
            ws[leaf] = call()
            lm = leaf.startswith("LM")
            ms = cs.event_ms(call, 10 if lm else 50)
            tag = FWD_TAGS[name]
            by_tag, _ = cs.profile_device_us(
                lambda: [call() for _ in range(10)], (tag,))
            us, n = by_tag[tag]
            times[leaf] = (ms, 1e-3 * us / n if n else None)
        out[name] = {"leaves": times, "out": ws}
    return out


def fwd_main(trees, loaded, card, dev) -> None:
    import numpy as np
    import torch

    t0 = next(iter(loaded.values()))
    rng = np.random.RandomState(cs.SEED)

    def probs(k, n):
        return torch.from_numpy(np.clip(
            rng.rand(k, n) * 1.2 - 0.1, 0, 1).astype(np.float32)).to(dev)

    ops = {"dev": dev,
           "words10": rng.randint(0, 2**32, cs.FED_K, dtype=np.uint64),
           "words1": rng.randint(0, 2**32, 1, dtype=np.uint64),
           "wordsL": rng.randint(0, 2**32, cs.LM_K, dtype=np.uint64)}
    ops["P4"] = {p: probs(cs.FED_K, s.n) for p, s in t0["fig4"].items()}
    ops["Q4"] = {p: torch.from_numpy(rng.randint(
        0, 256, (cs.FED_K, s.n)).astype(np.uint8)).to(dev)
        for p, s in t0["fig4"].items()}
    # the composed round's operand: the masks drawn from P4 at words10
    w10 = t0["as_words"](ops["words10"], dev)
    ops["Z4"] = {p: t0["sample_mask_hash"](ops["P4"][p], s.seed, s.tensor_id,
                                           w10)
                 for p, s in t0["fig4"].items()}
    ops["p6"] = {p: probs(1, s.n)[0] for p, s in t0["fig6"].items()}
    # the LM's probabilities, 1.3 GB in all, drawn on the card from a seed
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    ops["PL"] = {p: torch.rand((cs.LM_K, s.n), generator=gen, device=dev)
                 for p, s in t0["lm"].items()}
    runs, first = [], None
    for tree in trees:
        got = time_fwd(loaded[tree.resolve()], ops)
        if first is None:
            first = got
        for name, r in got.items():
            for leaf, v in r["out"].items():
                if not cs.same_bits(v, first[name]["out"][leaf]):
                    cs.die(f"{tree}'s {name} differs from {trees[0]}'s at "
                           f"{leaf}")
            units = {}
            for leaf, (ms, dms) in r["leaves"].items():
                unit = " ".join(leaf.split(" ")[:-1])  # "Fig. 4 f32", "LM"
                acc = units.setdefault(unit, [0.0, 0.0])
                acc[0] += ms
                acc[1] = None if dms is None or acc[1] is None else acc[1] + dms
            cs.say(f"ab: {tree} {name}: " + ", ".join(
                f"{leaf} {v[0]:.4f} ms (device "
                + ("not measured" if v[1] is None else f"{v[1]:.4f} ms")
                + ")" for leaf, v in r["leaves"].items())
                + "".join(
                    f"; {u} step {v[0]:.4f} ms (device "
                    + ("not measured" if v[1] is None else f"{v[1]:.4f} ms")
                    + ")" for u, v in units.items())
                + f" ({card})")
            runs.append({"tree": str(tree), "kernel": name,
                         "steps": {u: {"ms": v[0], "device_ms": v[1]}
                                   for u, v in units.items()},
                         "leaves": {leaf: {"ms": v[0], "device_ms": v[1]}
                                    for leaf, v in r["leaves"].items()}})
        del got
        torch.cuda.empty_cache()
    cs.say(f"ab: every tree's forward outputs equal the first tree's by bits "
           f"({card})")
    cs.say(json.dumps({"card": card, "runs": runs}))


def bwd_main(trees, loaded, card, dev) -> None:
    import numpy as np
    import torch

    t0 = next(iter(loaded.values()))
    rng = np.random.RandomState(cs.SEED)

    def cot(shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev)

    g6 = {p: cot((s.m,)) for p, s in t0["fig6"].items()}
    g4 = {p: cot((s.m,)) for p, s in t0["fig4"].items()}
    G4 = {p: cot((cs.FED_K, s.m)) for p, s in t0["fig4"].items()}
    # the LM's cotangents, 10 GB in all, drawn on the card from a seed
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    GL = {p: torch.randn((cs.LM_K, s.m), generator=gen, device=dev)
          for p, s in t0["lm"].items()}
    emb = t0["lm"]["embed"]
    live = torch.zeros(emb.shape[0], dtype=torch.bool, device=dev)
    live[torch.randperm(emb.shape[0], generator=gen, device=dev)[
        :LM_TOKENS]] = True  # the tokens' rows, in moved flat order
    GL["embed"] *= live[:, None].expand(emb.shape).movedim(
        emb.major_axis, 0).reshape(-1)
    runs, first = [], None
    for tree in trees:
        got = time_bwd(loaded[tree.resolve()], g6, g4, G4, GL)
        first = first or got
        for name, r in got.items():
            for leaf, v in r["out"].items():
                if not torch.equal(v, first[name]["out"][leaf]):
                    cs.die(f"{tree}'s {name} differs from {trees[0]}'s at "
                           f"{leaf}")
            steps = {}
            for leaf, (ms, dms) in r["leaves"].items():
                fig = leaf.rsplit(" ", 1)[0]  # "Fig. 6", "Fig. 4", "LM"
                acc = steps.setdefault(fig, [0.0, 0.0])
                acc[0] += ms
                acc[1] = None if dms is None or acc[1] is None else acc[1] + dms
            cs.say(f"ab: {tree} {name}: " + ", ".join(
                f"{leaf} {v[0]:.4f} ms (device "
                + ("not measured" if v[1] is None else f"{v[1]:.4f} ms")
                + ")" for leaf, v in r["leaves"].items())
                + "".join(
                    f"; a {f} step {v[0]:.4f} ms (device "
                    + ("not measured" if v[1] is None else f"{v[1]:.4f} ms")
                    + ")" for f, v in steps.items())
                + f" ({card})")
            runs.append({"tree": str(tree), "kernel": name,
                         "steps": {f: {"ms": v[0], "device_ms": v[1]}
                                   for f, v in steps.items()},
                         "leaves": {leaf: {"ms": v[0], "device_ms": v[1]}
                                    for leaf, v in r["leaves"].items()}})
    cs.say(f"ab: every tree's backward outputs equal the first tree's ({card})")
    cs.say(json.dumps({"card": card, "runs": runs}))


@contextlib.contextmanager
def active(t: dict):
    """The tree's port importable as ``repro_torch`` for a while."""
    sys.path.insert(0, t["src"])
    sys.modules.update(t["modules"])
    try:
        yield
    finally:
        sys.path.remove(t["src"])
        for name in [n for n in sys.modules if n.split(".")[0]
                     == "repro_torch"]:
            t["modules"][name] = sys.modules.pop(name)


def time_steps(t: dict, batches, scores, words, dev) -> dict:
    """{path: (median step seconds, losses)} for the plan and scatter."""
    import os

    import numpy as np
    import torch

    zs = t["zs"]
    dense = {p: np.zeros(zs.template[p].shape, np.float32)
             for p in zs.dense_paths}
    state0 = t["init_state"](zs, scores, dense, device=dev)
    cfg = t["cfg"](steps=STEP_N, lr=cs.LOCAL_LR, eval_every=10**9)
    out = {}
    for path in ("plan", "scatter"):
        marks = []

        def timed():
            for b in batches:
                marks.append(time.perf_counter())
                yield b

        os.environ["REPRO_BWD_PLAN"] = path
        try:
            with active(t):
                _, hist = t["train"](zs, state0, t["loss"], timed(), cfg,
                                     words, device=dev)
                torch.cuda.synchronize()
        finally:
            os.environ.pop("REPRO_BWD_PLAN", None)
        marks.append(time.perf_counter())
        out[path] = (float(np.median(np.diff(marks)[1:])),
                     [float(v) for v in hist["loss"]])
    return out


def step_main(trees, loaded, card, dev) -> None:
    import numpy as np
    import torch

    t0 = next(iter(loaded.values()))
    rng = np.random.RandomState(cs.SEED)  # chip_smoke's phase 10 inputs
    scores = {p: rng.rand(s.n).astype(np.float32)
              for p, s in t0["zs"].specs.items()}
    words = [int(w) for w in rng.randint(0, 2**32, STEP_N, dtype=np.uint64)]
    ds = t0["data"](n_train=8000, n_test=1500, seed=0)
    it = ds.batches(cs.LOCAL_BATCH, seed=0)
    batches = [{"x": torch.from_numpy(x).to(dev),
                "y": torch.from_numpy(y).to(dev)}
               for x, y in (next(it) for _ in range(STEP_N))]
    runs, first = [], None
    for tree in trees:
        got = time_steps(loaded[tree.resolve()], batches, scores, words, dev)
        first = first or got
        for path, (sec, losses) in got.items():
            if losses != first[path][1]:
                cs.die(f"{tree}'s losses on the {path} differ from "
                       f"{trees[0]}'s")
            cs.say(f"ab: {tree} local step on the {path}: median "
                   f"{1e3 * sec:.4f} ms of steps 1-{STEP_N - 1} ({card})")
            runs.append({"tree": str(tree), "path": path, "ms": 1e3 * sec})
    cs.say(f"ab: every tree's local losses equal the first tree's ({card})")
    cs.say(json.dumps({"card": card, "runs": runs}))


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
    mode = {"--serve": "serve", "--bwd": "bwd", "--step": "step",
            "--fwd": "fwd"}.get(
        args[0] if args else "", "pack")
    args = args[1:] if mode != "pack" else args
    if not torch.cuda.is_available() or len(args) < 2:
        cs.die("needs a CUDA device and two or more source trees")
    trees = [variant_tree(a) for a in args]
    loaded = {}
    for tree in trees:
        if tree.resolve() not in loaded:
            loaded[tree.resolve()] = load_tree(tree, mode)
    for t in loaded.values():
        (t["qd"] if mode == "serve" else t["qr"]).build()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    if mode == "serve":
        serve_main(trees, loaded, card, dev)
        return
    if mode == "bwd":
        bwd_main(trees, loaded, card, dev)
        return
    if mode == "fwd":
        fwd_main(trees, loaded, card, dev)
        return
    if mode == "step":
        step_main(trees, loaded, card, dev)
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
