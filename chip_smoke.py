#!/usr/bin/env python3
"""Smoke run of the PyTorch port (src/repro_torch) on one NVIDIA GPU.

Five paths at full width, every Pallas kernel they run replaced by a
hand-written CUDA kernel:

- serving: qwen2-0.5b (24 layers, d_model 896, 14 heads with 2 KV heads,
  d_ff 4864, padded vocab 152064) off u8 downlink words through the
  streaming engine, every zampled linear on the serve kernel;
- federated training: the paper's round (Fig. 4) on MNISTFC
  784-300-100-10, compression 8, d=10, window 128, K=10 clients, E=100
  local SGD steps at lr 0.5, psum_u32 1-bit uplink, u8 downlink, on the
  sample-reconstruct forward, the plan backward and the sample-pack
  upload kernels; evaluation draws sampled networks off the u8 carry;
  the composed round (explicit masks on the reconstruct kernels) once;
- the sharded federated round: the same round with one client per rank
  of a torch.distributed group, 10 ranks (processes) on the one card
  over gloo, on the one-client forward, backward and upload kernels;
- local training: the paper's Fig. 6 zampling_d16 on MNISTFC at
  compression 1, d=16, Adam at lr 1e-2, batch 128, in sample mode (the
  K=1 sample-reconstruct forward, the K=1 plan backward, or the K=1
  scatter backward under REPRO_BWD_PLAN=scatter) and in continuous mode
  (the K=1 reconstruct forward); the expected and discretized networks
  on the reconstruct forward;
- LM training: federated zampling of qwen2-0.5b through
  repro_torch.launch.train (K=4 clients, E=2 local SGD steps at lr 0.05,
  batch 4, sequence 128, compression 8, d=8, mean uploads, f32
  downlink) under REPRO_BWD_PLAN=scatter, on the sample-reconstruct
  forward and the scatter backward: at the entry point's default scale
  0.25 (f32) and at full width (bf16).

Phases, one printed line or more each:

1. device: the card's name and power limit (nvidia-smi);
2. build: nvcc builds both kernel libraries from the sources in the
   checkout, one process each, started together, with what
   ``-Xptxas -v`` reports;
3. serve kernel against its plain torch version on the card, bitwise, at
   all 8 zampled linears of the model (groups 0 and 23 where there are
   24, B in {1, 4}, u8 words, and f32 and u16 at one shape), and the
   lm_head also against a float64 product of the plainly regenerated
   weights; the kernels' logf, sqrtf and cosf (csrc/qz_common.cuh)
   against the library's at every argument a draw can give;
4. serving: ServeScheduler with 4 lanes answers 4 ragged prompts for 8
   new tokens each, which must be the tokens these inputs have given
   since the serve kernel was first checked (SERVE_TOKENS), and the
   first request rerun alone (B=1) must give the same tokens; each
   engine step must launch the kernel 169 times;
5. serve kernel times (CUDA events and torch.profiler device time),
   launch geometry (CTAs, shared memory a CTA), bounds and plain times,
   and the library yardstick (torch.sparse.mm of the CSR Q against the
   drawn mask, then X @ W) at B in {4, 1};
6. federated-round kernels against their plain versions on the card,
   bitwise (every training-kernel check compares bits: -0 is not +0), at
   the three zampled MNISTFC leaves (sample-reconstruct at
   K=10 f32 and K=1 u8/f32, plan backward at K=10, sample-pack at
   K=10), and the row plan and the plan walk's compact layout built on
   the card against the kernels' own regenerated Q (the layout against
   Q^T's canonical CSR, bitwise);
7. federated training: 5 rounds through the kernels (after them no
   padded transpose plan is cached, and the bytes of plan state on the
   card are printed), round 0 rerun on
   the plain path (bitwise the same words, dense leaves and loss),
   launch counts (3 E per round for the forward and backward kernels, 3
   for the upload, 3 per sampled network in evaluation), falling loss,
   rising sampled accuracy, metered wire bytes, round and step times;
8. federated-round kernel times, bounds, plain times and
   torch.sparse.mm yardsticks, and kernels 8, 7 and 6's geometry and
   host cost a launch;
9. the reconstruct forward (K=1 and K=10), the K=1 plan backward and the
   sample-reconstruct forward (K=1 and K=10) against their plain
   versions, bitwise, at Fig. 6's three leaves for d in {1, 16, 256}
   (a client at p = 0 over a window; the reconstruct forward also on
   operands holding -0 and negatives),
   the card-built row plans and layouts against the kernels' Q, and the
   K=10 reconstruct
   forward at the composed round's own Fig. 4 leaves against its plain
   version and against the sample-reconstruct kernel;
10. local training: step 0 through the kernels against the plain path
   (loss, gradients, Adam-updated state, bitwise), 500 sample-mode
   steps (3 forward and 3 backward launches each), the loss trend,
   sampled (10 networks), best-mask, expected and discretized accuracy,
   step times; then the same for 100 continuous-mode steps; then one
   composed federated round against phase 7's fused round 0 (bitwise
   words, dense leaves and loss; kernel 3 and kernel 6 launches only);
11. reconstruct-forward and K=1 plan-backward times, device times,
   bounds, plain times and torch.sparse.mm yardsticks, kernels 1, 3 and
   the K=1 plan backward's launch geometry and host cost a launch, and
   the device busy share of a local step;
12. the K=1 scatter backward against its plain version and the K=1 plan
   backward at Fig. 6's leaves for d in {1, 16, 256} (bitwise, and a
   second launch the same bits), the slot plan on the K=1 plan backward;
   local training under REPRO_BWD_PLAN=scatter: step 0 through kernels
   7 and 2 against kernels 7 and 5 (loss, gradients, updated state, Adam
   moments, bitwise), 20 steps with 3 launches of each a step whose
   losses equal phase 10's; the K=1 scatter backward's times, bounds,
   plain times, torch.sparse.mm yardsticks, launch geometry and host
   cost a launch;
13. the K-client scatter backward against its plain version and the
   K-client plan backward on the canonical plan, bitwise, at Fig. 4's
   leaves (K=10) and full-width qwen2-0.5b's blocks/ln1, blocks/attn/wk
   and blocks/attn/wq (K=4), a second launch the same bits, and the slot
   plan on the plan backward against its plain version; both kernels'
   K-client geometry;
14. LM training at launch/train.py's defaults (scale 0.25, f32): round 0
   through the kernels against the plain path on the card, under
   torch.use_deterministic_algorithms (score means, dense leaves and
   loss bitwise; 12 E launches each of the forward and the scatter
   backward);
15. LM training at full width (scale 1.0, bf16 leaves), 3 rounds through
   the kernels only: each round's loss (finite) and time, 12 E launches
   of kernels 8 and 4 a round and none of any other, the time of one
   local step, the device busy share of one more round by
   torch.profiler, and the peak device memory beside the bytes the plan
   path's plans would take (computed, never allocated);
16. on the operands of one local step of the trained full-width state,
   at all 12 zampled leaves: the K-client scatter backward against its
   plain version (bitwise, and a second launch the same bits) and the
   K-client sample-reconstruct forward against its plain version
   (bitwise); the scatter backward's times, device times, bounds, plain
   times, torch.sparse.mm yardsticks, geometry and host cost a launch;
   the sample-reconstruct forward's times, device times, bounds (this
   step's draws), plain times, torch.sparse.mm yardsticks, geometry and
   host cost a launch on the same operands, beside its Fig. 4 round in
   the kernels line;
17. the sharded round: bmm against per-client mm at the three MNISTFC
   layer shapes (counted, not gated); sharded_client_fit for 5 rounds on
   10 ranks at phase 7's settings and inputs, a rank's client k trained
   at the stacked round's words for client k (checked on its upload
   words); on every rank, on the operands that the fit's own round 0
   recorded, kernel 9 bitwise its plain version, kernel 10's row and
   the round's lanes, and kernel 5 (at each leaf's first local
   backward) bitwise its plain version, kernel 6's row and the round's
   g_z; each
   rank's launches (3 E a round of the one-client forward and backward,
   3 of kernel 9, none of any other); every rank's state identical
   after round 0 and the last round; round 0's collective u8 words
   bitwise the stacked aggregate's of the same 10 uploads; round 0's u8
   words differing from phase 7's at most 1e-3 of n_total; losses that
   fall and stay within 1e-3 of phase 7's; kernel 9's times and bound;
18. one JSON line with every kernel's launches, times and bound, the
   card, the run's total seconds, and last {"ok": true, "device": ...}.

Usage, from the repo root on a machine with a CUDA GPU:
    python3 chip_smoke.py
It needs one card and exits non-zero, printing no result, when torch
sees no CUDA device or the port's sources are not beside it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
T_START = time.perf_counter()
SEED = 0
DRAW_WORD = 2
PROMPTS = [[5, 17, 42, 7], [1, 2, 3], [9, 9, 1, 0, 3], [4, 4]]
NEW_TOKENS = 8
# phase 4's tokens for PROMPTS (every serve kernel since the first is
# bitwise the plain path, so a redesign must give them again)
SERVE_TOKENS = [[115217, 47379, 47379, 47379, 47379, 47379, 47379, 47379],
                [10769, 129520, 139572, 22558, 139572, 129520, 83111, 129520],
                [63951, 110966, 110966, 110966, 110966, 110966, 110966,
                 110966],
                [40323, 77280, 40323, 77280, 40323, 95010, 95010, 95010]]
LANES = 4
# the serving state's zampling: every linear of qwen2-0.5b, u8 words
SERVE_ZAMPLING = dict(compression=8, d=8, min_size=65536)
# H100 SXM, NVIDIA's data sheet: HBM rate, and the float32 (non-tensor)
# rate that the hash and Box-Muller operations are counted against (the
# data sheet lists no int32 rate; the card issues int32 at half of it, so
# the bound is a floor).
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
# operations the kernel does per weight, per mask edge, per drawn edge
# (see csrc/qz_common.cuh): a hash combine is 12 int ops, fmix32 8
OPS_PER_WEIGHT = 12 + 21 + 23 + 2  # row hash, base, stride, window base
OPS_PER_EDGE = 3 + 1 + 20 + 4  # index, coord, mask hash, threshold compare
OPS_PER_DRAWN = 40 + 8 + 6 + 1  # 2 value hashes, 2 uniforms, Box-Muller, add
# the training kernels' least work (see csrc/qz_reconstruct.cu): one
# draw per (client, coordinate), however many edges read it; the plan's
# compact layout read once (its m*d real entries, a 4-byte value and a
# 2- or 4-byte row each, and its offsets); the upload's 4-byte wire lanes
OPS_ROW_EDGE = 4  # an edge's in-window index and coordinate
OPS_VALUE = 54  # an edge's value: 2 value hashes, 2 uniforms, Box-Muller
# of a value hash, the mix fmix32(ctr + K1) of its counter: the same for
# every row at a slot, so the scatter's least work mixes it once a slot
OPS_SLOT_MIX = 9
OPS_DRAW = 24  # one client's draw at one coordinate: mask hash + compare
OPS_PACK = 2  # shift and OR of a drawn bit into its lane
OPS_MAC = 2  # a multiply and an add per (client, edge) whose operand is not 0
OPS_PLAN = 2  # a multiply and an add per real transpose-plan entry
FED_ROUNDS = 5
FED_K = 10
FED_E = 100
FED_BATCH = 64
FED_ZAMPLING = dict(compression=8, d=10, window=128, min_size=128, seed=1)
FED_CONFIG = dict(num_clients=FED_K, local_steps=FED_E, local_lr=0.5,
                  aggregate="psum_u32", downlink="u8")
FED_FLIP_SHARE = 1e-3  # differing round-0 u8 words, of n_total (phase 17)
# phase 17's losses against phase 7's: the two drivers draw the same
# bits, but their products round apart (bmm against mm) and a few upload
# bits flip, so the trajectories part by rounding; the port and JAX, which
# part the same way, agree to 4.5e-5 over these 5 rounds
# (tests/test_torch_fit_reference.py)
SHARDED_LOSS_RTOL = 1e-3
RANK_TIMEOUT = 600.0  # seconds, phase 17's ranks and their collectives
EVAL_NETS = 10
# local zampling: the paper's Fig. 6 zampling_d16 (experiments/paper.py
# :466-492 at quick=False), 500 of its 4000 steps
LOCAL_D = 16
LOCAL_DS = (1, 16, 256)  # phase 9: every d of the paper's local runs
LOCAL_STEPS = 500
CONT_STEPS = 100
SCATTER_STEPS = 20  # phase 12: local steps under REPRO_BWD_PLAN=scatter
LM_K = 4  # launch/train.py's clients
LM_ROUNDS = 3  # phase 15: full-width rounds
LOCAL_LR = 1e-2
LOCAL_BATCH = 128
LINEARS = ("blocks/attn/wq", "blocks/attn/wk", "blocks/attn/wv",
           "blocks/attn/wo", "blocks/mlp/gate", "blocks/mlp/up",
           "blocks/mlp/down")


def die(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def event_ms(fn, reps: int, warm: bool = True) -> float:
    """Mean milliseconds of ``fn()`` on the card, by CUDA events, after
    one call to warm up (``warm``)."""
    import torch

    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _bound_ms(ops_n: float, bytes_n: float):
    """(least ms, what binds) for work of ops_n operations and bytes_n
    bytes on the card."""
    t_ops, t_bytes = ops_n / PEAK_OPS_PER_S, bytes_n / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def scatter_work(spec, G):
    """(ops, bytes) of grad_Z = Q^T G by the scatter for this run's
    cotangents G (K, m): per row some client's cotangent is not 0 at, its
    two row hashes, and per edge of it the index, the value's two hashes
    (their counters' mixes made once a slot) and Box-Muller; a multiply
    and an add per (client, edge) whose cotangent is not 0; G read once,
    grad_Z written once."""
    K, m, d = G.shape[0], spec.m, spec.d
    nz = G != 0
    live = float(nz.any(0).sum())
    edge = OPS_ROW_EDGE + OPS_VALUE - 2 * OPS_SLOT_MIX
    ops_n = (live * (OPS_PER_WEIGHT + d * edge) + 2 * d * OPS_SLOT_MIX
             + float(nz.sum()) * d * OPS_MAC)
    return ops_n, K * (4 * m + 4 * spec.n)


def q_csr(spec, dev, transpose: bool):
    """CSR of Q (m, n), or of Q^T (n, m), with int32 indices, built from
    the kernels' own Q (``qz_edges``) a chunk of whole windows at a time:
    Q^T's columns come out in ascending row order within each
    coordinate.  For the library yardsticks only."""
    import torch

    from repro_torch.kernels import qz_decode

    m, d, rpw, win = spec.m, spec.d, spec.rows_per_window, spec.window
    p0 = torch.zeros(spec.n, device=dev)
    per = max(1, (1 << 23) // (rpw * d))  # windows per chunk
    col = torch.empty(m * d, dtype=torch.int32, device=dev)
    val = torch.empty(m * d, dtype=torch.float32, device=dev)
    counts = torch.zeros(spec.n, dtype=torch.int64, device=dev)
    for w0 in range(0, spec.num_windows, per):
        r0, r1 = w0 * rpw, min(m, (w0 + per) * rpw)
        if r0 >= r1:
            break
        rows = torch.arange(r0, r1, device=dev)
        idx, _, v, _ = qz_decode.qz_edges(spec, p0, 0, rows)
        coord = (rows // rpw)[:, None] * win + idx.to(torch.int64)
        if transpose:
            key = coord.reshape(-1)
            key, perm = torch.sort(key, stable=True)
            col[r0 * d:r1 * d] = rows.repeat_interleave(d)[perm].to(torch.int32)
            val[r0 * d:r1 * d] = v.reshape(-1)[perm]
            counts += torch.bincount(key, minlength=spec.n)
        else:
            col[r0 * d:r1 * d] = coord.reshape(-1).to(torch.int32)
            val[r0 * d:r1 * d] = v.reshape(-1)
    if transpose:
        crow = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
        shape = (spec.n, m)
    else:
        crow = torch.arange(m + 1, dtype=torch.int64, device=dev) * d
        shape = (m, spec.n)
    return torch.sparse_csr_tensor(crow.to(torch.int32), col, val, shape,
                                   check_invariants=False)


def drawn_counts(spec, Z):
    """(drawn, any_drawn) of masks Z (K, n) over Q's m*d edges: the
    (client, edge) pairs whose bit is 1 and the edges some client's bit is
    1 at, a chunk of rows at a time (``qz_edges`` gives each edge's
    coordinate)."""
    import torch

    from repro_torch.kernels import qz_decode

    p0 = torch.zeros(spec.n, device=Z.device)
    drawn = any_drawn = 0
    step = max(1, (1 << 22) // spec.d)
    for r0 in range(0, spec.m, step):
        rows = torch.arange(r0, min(spec.m, r0 + step), device=Z.device)
        idx, _, _, _ = qz_decode.qz_edges(spec, p0, 0, rows)
        coord = ((rows // spec.rows_per_window)[:, None] * spec.window
                 + idx.to(torch.int64))
        bits = Z[:, coord] > 0  # (K, rows, d)
        drawn += int(bits.sum())
        any_drawn += int(bits.any(0).sum())
    return float(drawn), float(any_drawn)


def layout_is_qt(spec, dev):
    """(largest in-degree, entries, equal) of the plan walk's compact
    layout, built on the card, against ``q_csr``'s Q^T of the kernels'
    own Q: the same offsets, rows and values, bitwise, in canonical
    order."""
    import torch

    from repro_torch.kernels import qz_reconstruct as qr

    lay = qr.plan_layout(spec, dev)
    QT = q_csr(spec, dev, True)
    starts = lay.starts.to(torch.int64)
    counts = starts[1:] - starts[:-1]
    coord = torch.repeat_interleave(
        torch.arange(spec.n, device=dev), counts)
    local = lay.rows.to(torch.int64)
    if lay.narrow:  # uint16 bits in an int16 tensor
        local &= 0xFFFF
    rows = (coord // spec.window) * spec.rows_per_window + local
    ok = (torch.equal(starts, QT.crow_indices().to(torch.int64))
          and torch.equal(lay.vals, QT.values())
          and torch.equal(rows, QT.col_indices().to(torch.int64)))
    return int(counts.max()), int(starts[-1]), ok


def profile_device_us(fn, tags, top: int = 0):
    """Run ``fn`` under torch.profiler: ({tag: (device us, launches)} of
    the CUDA kernels whose name holds the tag, all kernels' device us),
    and with ``top`` the ``top`` kernel names of most device time as a
    third item, [(name, us, launches)]."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_tag = {tag: [0.0, 0] for tag in tags}
    by_name = {}
    total = 0.0
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = evt.time_range.elapsed_us()
        total += us
        acc = by_name.setdefault(evt.name, [0.0, 0])
        acc[0] += us
        acc[1] += 1
        for tag in tags:
            if tag in evt.name:
                by_tag[tag][0] += us
                by_tag[tag][1] += 1
    out = ({t: tuple(v) for t, v in by_tag.items()}, total)
    if top:
        ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
        out += ([(name, us, n) for name, (us, n) in ranked],)
    return out


class KernelTimes:
    """Each training kernel's times at the leaves of a path, summed:
    CUDA-event ms per launch over 50 back-to-back launches (host launch
    cost included), device ms per launch by torch.profiler over 10, the
    plain version's and the library call's ms as the caller timed them,
    and the bound of each leaf's least work."""

    def __init__(self, card: str, tags: dict):
        self.card, self.tags = card, tags  # {kernel name: profiler tag}
        self.acc = {name: {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0,
                           "library_ms": 0.0, "ops_ms": 0.0,
                           "bytes_ms": 0.0, "bound_ms": 0.0, "shapes": {}}
                    for name in tags}

    def add(self, name, path, kernel, t_p, t_y, ops_n, bytes_n):
        """One kernel at one leaf; ``t_y`` None where no library call
        computes the same function."""
        t_k = event_ms(kernel, 50)
        tag = self.tags[name]
        by_tag, _ = profile_device_us(
            lambda: [kernel() for _ in range(10)], (tag,))
        us, n_l = by_tag[tag]
        t_d = 1e-3 * us / n_l if n_l else None  # no device trace: None
        b, _ = _bound_ms(ops_n, bytes_n)
        a = self.acc[name]
        a["ms"] += t_k
        a["device_ms"] = (a["device_ms"] + t_d
                          if t_d is not None and a["device_ms"] is not None
                          else None)
        a["plain_ms"] += t_p
        a["library_ms"] += t_y if t_y is not None else 0.0
        a["ops_ms"] += 1e3 * ops_n / PEAK_OPS_PER_S
        a["bytes_ms"] += 1e3 * bytes_n / PEAK_BYTES_PER_S
        a["bound_ms"] += b
        a["shapes"][path] = {"ms": t_k, "device_ms": t_d, "plain_ms": t_p,
                             "library_ms": t_y, "bound_ms": b, "ops": ops_n,
                             "bytes": bytes_n}
        say(f"time: {name} {path}: kernel {t_k:.4f} ms (device "
            f"{'not measured' if t_d is None else f'{t_d:.4f} ms'}), plain "
            f"{t_p:.3f} ms, "
            + (f"torch.sparse.mm {t_y:.4f} ms, " if t_y is not None else "")
            + f"bound {b:.5f} ms ({self.card})")

    def row(self, name, replaces, launches, max_err, times, per, lib):
        """The kernels-line entry: the leaves' sums times ``times``
        launches per leaf in one ``per``."""
        a = self.acc[name]
        r = {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/qz_reconstruct.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": max_err, "ms": times * a["ms"],
            "device_ms": (None if a["device_ms"] is None
                          else times * a["device_ms"]),
            "plain_ms": times * a["plain_ms"],
            "bound_ms": times * a["bound_ms"],
            "bound_by": ("operations" if a["ops_ms"] >= a["bytes_ms"]
                         else "bytes"),
            "library_ms": times * a["library_ms"] if lib else None,
            "library_call": lib, "per": per, "shapes": a["shapes"],
        }
        dms = r["device_ms"]
        say(f"time: {name} per {per}: kernel {r['ms']:.4f} ms (device "
            f"{'not measured' if dms is None else f'{dms:.4f} ms'}), bound "
            f"{r['bound_ms']:.5f} ms ({r['bound_by']}), plain "
            f"{r['plain_ms']:.2f} ms"
            + (f", {lib} {r['library_ms']:.4f} ms" if lib else "")
            + f" ({self.card})")
        return r


def host_us(fn, reps: int = 50) -> float:
    """Host microseconds a call of ``fn`` takes to enqueue its work: the
    wall clock of ``reps`` back-to-back calls with no synchronise, after
    one call to warm up."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return 1e6 * dt / reps


def geometry_text(geo) -> str:
    """A training kernel's launch geometry (``qr.FwdGeometry``,
    ``qr.ScatterGeometry`` or ``qr.PlanGeometry``), for a ``launch:``
    line."""
    return ", ".join(f"{k} {v}" for k, v in geo._asdict().items()
                     if k != "div_d")


def launch_report(card, kt, name, path, fn, geo) -> None:
    """A training kernel at one leaf, after ``kt.add``: device and event
    time, the launch geometry, and the host's cost of a launch (the one
    measured, kept in the leaf's entry of the kernels line)."""
    sh = kt.acc[name]["shapes"][path]
    sh["host_us"] = host_us(fn)
    dms = sh["device_ms"]
    say(f"launch: {name} {path}: device "
        + ("not measured" if dms is None else f"{1e3 * dms:.2f} us")
        + f", events {1e3 * sh['ms']:.2f} us, host {sh['host_us']:.2f} us "
        f"a launch (wall clock of 50 enqueues); {geometry_text(geo)} "
        f"({card})")


def same_bits(got, want) -> bool:
    """Equal shapes and equal bits: floats compared through an int32 view,
    so -0 and +0 differ (``torch.equal`` counts them equal)."""
    import torch

    if got.shape != want.shape or got.dtype != want.dtype:
        return False
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    return bool(torch.equal(got, want))


def check_bitwise(max_err, name, got, want, what):
    """Die unless a kernel's output equals its plain version's, bit for
    bit (the sign of zero too); record the largest difference."""
    import torch

    torch.cuda.synchronize()
    same = same_bits(got, want)
    diff = (got.double() - want.double()).abs().max().item()
    max_err[name] = max(max_err[name], diff)
    say(f"train-kernel-vs-plain: {name} {what}: bitwise={same} "
        f"max_abs_err={diff:.3e}")
    if not same:
        die(f"{name} differs from its plain version ({what})")


def fed_data():
    """Phase 7's data: the teacher dataset and its stream of round
    batches, (K, E, B, ...) each."""
    from repro_torch.data import (client_batch_stream, iid_client_split,
                                  make_teacher_dataset)

    ds = make_teacher_dataset(n_train=8000, n_test=1500, seed=0)
    return ds, client_batch_stream(iid_client_split(ds, FED_K, seed=0),
                                   FED_BATCH, FED_E, seed=0)


def host_state(state) -> dict:
    """A round state's tensors as numpy arrays."""
    return {part: {p: v.cpu().numpy() for p, v in state[part].items()}
            for part in ("scores", "dense")}


def training_phases(card: str, dev) -> list:
    """Phases 6-8: the federated round's kernels at full MNISTFC width.
    Returns the four training kernels' rows of the kernels line."""
    import numpy as np
    import torch

    from repro_torch.comm.bitpack import packed_len
    from repro_torch.comm.downlink import get_codec
    from repro_torch.comm.metering import round_wire_report
    from repro_torch.configs.mnistfc import MNISTFC
    from repro_torch.core.federated import (FederatedConfig, encode_state,
                                            federated_round)
    from repro_torch.core.sampling import (as_words, clip_probs,
                                           sample_mask_hash,
                                           sample_mask_qhash)
    from repro_torch.core import transpose_plan as ttp
    from repro_torch.core.transpose_plan import row_plan
    from repro_torch.core.zampling import ZamplingConfig, build_specs
    from repro_torch.kernels import ops, qz_decode
    from repro_torch.kernels import qz_reconstruct as qr
    from repro_torch.models.mlp import mlp_accuracy, mlp_loss, mlp_template
    from repro_torch.train import evaluate

    # --- the configuration: experiments/paper.py Fig. 4 at quick=False
    zspecs = build_specs(mlp_template(MNISTFC),
                         ZamplingConfig(**FED_ZAMPLING))
    specs = zspecs.specs
    rng = np.random.RandomState(SEED)
    scores = {p: rng.rand(s.n).astype(np.float32) for p, s in specs.items()}
    dense = {p: np.zeros(zspecs.template[p].shape, np.float32)
             for p in zspecs.dense_paths}
    cfg = FederatedConfig(**FED_CONFIG)
    round_words = [int(w) for w in rng.randint(0, 2**32, FED_ROUNDS,
                                                dtype=np.uint64)]
    eval_words = [int(w) for w in rng.randint(0, 2**32, EVAL_NETS,
                                              dtype=np.uint64)]
    say(f"train: MNISTFC {MNISTFC}, zampled "
        + ", ".join(f"{p} {s.shape} m={s.m} n={s.n} rpw={s.rows_per_window}"
                    for p, s in specs.items())
        + f"; dense {list(zspecs.dense_paths)}; K={FED_K} E={FED_E} "
        f"batch {FED_BATCH} lr 0.5 psum_u32/u8")

    def words_k(k):
        return as_words(rng.randint(0, 2**32, k, dtype=np.uint64), dev)

    # --- 6. kernels against their plain versions ---------------------------
    max_err = {name: 0.0 for name in qr.LAUNCHES}

    def check(name, got, want, what):
        check_bitwise(max_err, name, got, want, what)

    t0 = time.perf_counter()
    u8 = get_codec("u8")
    for path, spec in specs.items():
        P = clip_probs(torch.from_numpy(
            rng.rand(FED_K, spec.n).astype(np.float32) * 1.2 - 0.1).to(dev))
        steps = words_k(FED_K)
        W = qr.qz_sample_reconstruct_batched_fwd(spec, P, steps)
        check("qz_sample_reconstruct_batched_fwd", W,
              ops.sample_reconstruct_plain(spec, P, steps),
              f"{path} K={FED_K} f32")
        check("qz_sample_reconstruct_fwd",
              qr.qz_sample_reconstruct_fwd(spec, P[3], steps[3:4]), W[3],
              f"{path} K=1 f32 against the batched kernel's row 3")
        q8 = u8.encode(spec, P[0], round_words[0])
        check("qz_sample_reconstruct_fwd",
              qr.qz_sample_reconstruct_fwd(spec, q8, steps[:1], 8),
              ops.sample_reconstruct_plain(spec, q8[None], steps[:1], 8)[0],
              f"{path} K=1 u8")
        check("qz_sample_reconstruct_fwd",
              qr.qz_sample_reconstruct_fwd(spec, q8, steps[:1], 8),
              qr.qz_sample_reconstruct_fwd(spec, u8.decode(spec, q8),
                                           steps[:1]),
              f"{path} K=1 u8 words against f32 on the decoded scores")
        G = torch.from_numpy(rng.randn(FED_K, spec.m).astype(np.float32)
                             ).to(dev)
        check("qz_reconstruct_batched_bwd_plan",
              qr.qz_reconstruct_batched_bwd_plan(spec, G),
              ops.plan_bwd_plain(spec, G), f"{path} K={FED_K} seeded G")
        check("qz_sample_pack_batched_fwd",
              qr.qz_sample_pack_batched_fwd(spec, P, steps),
              ops.sample_pack_plain(spec, P, steps), f"{path} K={FED_K}")
        # the row plan and the plan walk's layout, built on the card: the
        # layout's values are a gather of the row plan's; the kernels
        # regenerate Q from the same device functions as qz_edges
        gidx, vals = row_plan(spec, dev)
        rows = torch.arange(spec.m, device=dev)
        idx, _, kvals, _ = qz_decode.qz_edges(spec, P[0], 0, rows)
        win = (rows // spec.rows_per_window)[:, None] * spec.window
        ok_idx = torch.equal(gidx[:spec.m], win + idx.to(torch.int64))
        ok_val = torch.equal(vals[:spec.m], kvals)
        deg, entries, ok_lay = layout_is_qt(spec, dev)
        say(f"train-plan: {path}: largest in-degree {deg}, {entries} "
            f"entries; row plan indices equal the kernels' = {ok_idx}, "
            f"values bitwise = {ok_val}; the layout is Q^T's canonical CSR "
            f"of the kernels' Q = {ok_lay}")
        if not (ok_idx and ok_val and ok_lay):
            die(f"the card-built plan differs from the kernels' Q ({path})")
    say(f"phase 6 done in {time.perf_counter() - t0:.1f} s; every "
        "comparison bitwise")

    # --- 7. federated training through the kernels ---------------------------
    t0 = time.perf_counter()
    ds, stream = fed_data()
    batches = [dict(zip(("x", "y"), next(stream))) for _ in range(FED_ROUNDS)]
    test = {"x": torch.from_numpy(ds.x_test).to(dev),
            "y": torch.from_numpy(ds.y_test).to(dev)}

    def acc_fn(params):
        return mlp_accuracy(params, test)

    state0 = encode_state(zspecs, cfg, {"scores": scores, "dense": dense},
                          device=dev)
    acc0, std0 = evaluate(zspecs, state0, acc_fn, eval_words, carried="u8",
                          device=dev)
    say(f"train: data and state ready in {time.perf_counter() - t0:.1f} s; "
        f"sampled accuracy before: {acc0:.4f} +- {std0:.4f} "
        f"({EVAL_NETS} networks)")

    # the plain versions' padded plans and row plans of phase 6 go: the
    # kernels' path must build none
    ttp.clear_caches()
    qz_decode.reset_launches()
    qr.reset_launches()
    state, round_s, losses = state0, [], []
    rep = round_wire_report(zspecs, cfg.aggregate, FED_K, downlink="u8")
    for r in range(FED_ROUNDS):
        t1 = time.perf_counter()
        state, met = federated_round(zspecs, state, mlp_loss, batches[r],
                                     round_words[r], cfg, round_index=r,
                                     device=dev)
        torch.cuda.synchronize()
        round_s.append(time.perf_counter() - t1)
        losses.append(float(met["loss"]))
        if r == 0:
            state_r0, loss_r0 = state, met["loss"].clone()
        up = (sum(4 * packed_len(s.n) for s in specs.values())
              + 4 * zspecs.dense_total)
        down = (sum(w.numel() * w.element_size()
                    for w in state["scores"].values())
                + sum(4 * d.numel() for d in state["dense"].values()))
        say(f"train: round {r}: loss {losses[-1]:.6f}, {round_s[-1]:.3f} s; "
            f"uplink {up} B/client (metrics "
            f"{met['uplink_bytes_per_client']:.0f}, report "
            f"{rep['uplink_bytes_per_client']:.0f}), downlink "
            f"{down} B/client (metrics "
            f"{met['downlink_bytes_per_client']:.0f}, report "
            f"{rep['downlink_bytes_per_client']:.0f})")
        if not (up == met["uplink_bytes_per_client"]
                == rep["uplink_bytes_per_client"]
                and down == met["downlink_bytes_per_client"]
                == rep["downlink_bytes_per_client"]):
            die("metered wire bytes differ from round_wire_report's")
    fit_launches = dict(qr.LAUNCHES)
    want = {name: 0 for name in qr.LAUNCHES}
    want.update({"qz_sample_reconstruct_batched_fwd": 3 * FED_E * FED_ROUNDS,
                 "qz_reconstruct_batched_bwd_plan": 3 * FED_E * FED_ROUNDS,
                 "qz_sample_pack_batched_fwd": 3 * FED_ROUNDS})
    say(f"train: launches in {FED_ROUNDS} rounds {fit_launches}, expected "
        f"{want}")
    if fit_launches != want or any(qz_decode.LAUNCHES.values()):
        die("training launch counts differ from 3E per round (forward, "
            "backward) and 3 per round (upload)")
    qr.reset_launches()
    acc1, std1 = evaluate(zspecs, state, acc_fn, eval_words, carried="u8",
                          device=dev)
    eval_launches = dict(qr.LAUNCHES)
    say(f"train: sampled accuracy after: {acc1:.4f} +- {std1:.4f} "
        f"({EVAL_NETS} networks); evaluation launches {eval_launches}")
    if (eval_launches["qz_sample_reconstruct_fwd"] != 3 * EVAL_NETS
            or sum(eval_launches.values()) != 3 * EVAL_NETS):
        die("evaluation must launch the K=1 kernel 3 times per network")
    padded = ttp._build_transpose_plan.cache_info().currsize
    say(f"train-plan: after {FED_ROUNDS} rounds and an evaluation through "
        f"the kernels: {padded} padded transpose plans cached (none on the "
        f"card), {ttp._row_plan.cache_info().currsize} row plans; plan "
        f"state on the card {qr.plan_state_bytes()} B, the plan walk's "
        f"compact layouts of {list(specs)}")
    if padded:
        die("a padded transpose plan was built on the kernels' path")
    med = float(np.median(round_s[1:]))
    say(f"train: losses {losses}; round times {[round(t, 4) for t in round_s]}"
        f" s; median round (rounds 1-{FED_ROUNDS - 1}) {med:.4f} s, "
        f"{1e3 * med / FED_E:.3f} ms per local step (K={FED_K} clients, "
        f"3 forward + 3 backward launches each) on {card}")
    if not losses[-1] < losses[0]:
        die(f"the loss did not fall: {losses}")
    if not acc1 > acc0:
        die(f"sampled accuracy did not rise: {acc0} -> {acc1}")

    qr.reset_launches()
    ref_state, ref_met = federated_round(
        zspecs, state0, mlp_loss, batches[0], round_words[0], cfg,
        round_index=0, impl="ref", device=dev)
    torch.cuda.synchronize()
    same_words = all(torch.equal(ref_state["scores"][p], state_r0["scores"][p])
                     for p in specs)
    same_dense = all(torch.equal(ref_state["dense"][p], state_r0["dense"][p])
                     for p in zspecs.dense_paths)
    same_loss = torch.equal(ref_met["loss"], loss_r0)
    say(f"train: round 0 on the plain path: u8 words bitwise={same_words}, "
        f"dense bitwise={same_dense}, loss bitwise={same_loss} "
        f"({float(ref_met['loss']):.9f}); kernel launches "
        f"{sum(qr.LAUNCHES.values())}")
    if not (same_words and same_dense and same_loss) or any(
            qr.LAUNCHES.values()):
        die("round 0 through the kernels differs from the plain path")
    say(f"phase 7 done in {time.perf_counter() - t0:.1f} s")

    # --- 8. kernel times at the main path's shapes -------------------------
    t0 = time.perf_counter()
    decoded = {p: u8.decode(s, state["scores"][p]) for p, s in specs.items()}
    kt = KernelTimes(card, {
        "qz_sample_reconstruct_batched_fwd": "sample_reconstruct_window_kernel",
        "qz_sample_reconstruct_fwd": "sample_reconstruct_window_kernel",
        "qz_reconstruct_batched_bwd_plan": "plan_bwd_kernel",
        "qz_sample_pack_batched_fwd": "sample_pack_kernel"})
    add = kt.add

    for path, spec in specs.items():
        m, n, d = spec.m, spec.n, spec.d
        gidx, _ = row_plan(spec, dev)
        Q, QT = q_csr(spec, dev, False), q_csr(spec, dev, True)
        P = decoded[path].expand(FED_K, n).contiguous()
        steps = words_k(FED_K)
        Z = sample_mask_hash(P, spec.seed, spec.tensor_id, steps)
        bits = Z[:, gidx[:m]] > 0  # (K, m, d): this run's draws
        drawn, any_drawn = float(bits.sum()), float(bits.any(0).sum())
        row_ops = m * OPS_PER_WEIGHT + m * d * OPS_ROW_EDGE
        Zt = Z.t().contiguous()
        add("qz_sample_reconstruct_batched_fwd", path,
            lambda: qr.qz_sample_reconstruct_batched_fwd(spec, P, steps),
            event_ms(lambda: ops.sample_reconstruct_plain(spec, P, steps), 3),
            event_ms(lambda: torch.sparse.mm(Q, Zt), 50),
            row_ops + any_drawn * OPS_VALUE + FED_K * n * OPS_DRAW + drawn,
            FED_K * (4 * n + 4 * m) + 4 * FED_K)
        launch_report(card, kt, "qz_sample_reconstruct_batched_fwd", path,
                      lambda: qr.qz_sample_reconstruct_batched_fwd(
                          spec, P, steps), qr.fwd_geometry(spec, FED_K))
        q = state["scores"][path]
        s1 = steps[:1]
        z1 = sample_mask_qhash(q[None], 8, spec.seed, spec.tensor_id, s1)
        b1 = z1[:, gidx[:m]] > 0
        z1t = z1.t().contiguous()
        add("qz_sample_reconstruct_fwd", path,
            lambda: qr.qz_sample_reconstruct_fwd(spec, q, s1, 8),
            event_ms(lambda: ops.sample_reconstruct_plain(spec, q[None], s1,
                                                          8), 3),
            event_ms(lambda: torch.sparse.mm(Q, z1t), 50),
            row_ops + float(b1.sum()) * (OPS_VALUE + 1) + n * OPS_DRAW,
            n + 4 * m + 4)
        launch_report(card, kt, "qz_sample_reconstruct_fwd", path,
                      lambda: qr.qz_sample_reconstruct_fwd(spec, q, s1, 8),
                      qr.fwd_geometry(spec, 1))
        G = torch.from_numpy(rng.randn(FED_K, m).astype(np.float32)).to(dev)
        Gt = G.t().contiguous()
        geo = qr.plan_bwd_geometry(spec, dev, K=FED_K)
        # the compact layout read once (a value and a row of
        # geo.row_bytes an entry, and the offsets), K cotangents, K outputs
        add("qz_reconstruct_batched_bwd_plan", path,
            lambda: qr.qz_reconstruct_batched_bwd_plan(spec, G),
            event_ms(lambda: ops.plan_bwd_plain(spec, G), 3),
            event_ms(lambda: torch.sparse.mm(QT, Gt), 50),
            OPS_PLAN * FED_K * m * d,
            (4 + geo.row_bytes) * m * d + 4 * (n + 1) + 4 * FED_K * (m + n))
        launch_report(card, kt, "qz_reconstruct_batched_bwd_plan", path,
                      lambda: qr.qz_reconstruct_batched_bwd_plan(spec, G), geo)
        add("qz_sample_pack_batched_fwd", path,
            lambda: qr.qz_sample_pack_batched_fwd(spec, P, steps),
            event_ms(lambda: ops.sample_pack_plain(spec, P, steps), 3),
            None, FED_K * n * (OPS_DRAW + OPS_PACK),
            FED_K * (4 * n + 4 * packed_len(n)) + 4 * FED_K)

    meta = {
        "qz_sample_reconstruct_batched_fwd": (
            "src/repro/kernels/qz_reconstruct.py:553", fit_launches, FED_E,
            "one round: E launches per zampled leaf, K=10",
            "torch.sparse.mm(Q_csr, Z^T) on the drawn masks (no draw)"),
        "qz_sample_reconstruct_fwd": (
            "src/repro/kernels/qz_reconstruct.py:507", eval_launches, 1,
            "one sampled network off the u8 carry: 1 launch per leaf",
            "torch.sparse.mm(Q_csr, z) on the drawn mask (no draw)"),
        "qz_reconstruct_batched_bwd_plan": (
            "src/repro/kernels/qz_reconstruct.py:396", fit_launches, FED_E,
            "one round: E launches per zampled leaf, K=10",
            "torch.sparse.mm(Q^T_csr, G^T)"),
        "qz_sample_pack_batched_fwd": (
            "src/repro/kernels/qz_reconstruct.py:621", fit_launches, 1,
            "one round: 1 launch per zampled leaf, K=10", None),
    }
    rows = [kt.row(name, replaces, launch_src[name], max_err[name], times,
                   per, lib)
            for name, (replaces, launch_src, times, per, lib) in meta.items()]
    k_round = sum(r["ms"] for r in rows
                  if r["name"] != "qz_sample_reconstruct_fwd")
    say(f"share: training kernel time per round (CUDA events) / median round "
        f"time: {k_round:.3f} / {1e3 * med:.3f} ms = "
        f"{k_round / (1e3 * med):.4f} ({card})")

    # device time by kernel, by torch.profiler over one more round and
    # one evaluation; CUDA-event times above include the host's launch
    # cost between back-to-back calls
    tags = {"qz_sample_reconstruct_batched_fwd":
            "sample_reconstruct_window_kernel",
            "qz_reconstruct_batched_bwd_plan": "plan_bwd_kernel",
            "qz_sample_pack_batched_fwd": "sample_pack_kernel"}
    by_tag, dev_us = profile_device_us(
        lambda: federated_round(zspecs, state, mlp_loss, batches[-1],
                                round_words[-1], cfg,
                                round_index=FED_ROUNDS, device=dev),
        tuple(tags.values()))
    ev_tag, ev_us = profile_device_us(
        lambda: evaluate(zspecs, state, acc_fn, eval_words, carried="u8",
                         device=dev), ("sample_reconstruct_window_kernel",))
    if dev_us <= 0:
        say("profile: torch.profiler showed no device time; device times "
            "not measured")
    else:
        for row in rows:
            if row["name"] == "qz_sample_reconstruct_fwd":
                us, n_l = ev_tag["sample_reconstruct_window_kernel"]
                us /= EVAL_NETS
            else:
                us, n_l = by_tag[tags[row["name"]]]
            row["device_ms_in_main_path"] = 1e-3 * us
            say(f"profile: {row['name']}: device {1e-3 * us:.4f} ms per "
                f"{row['per'].split(':')[0]} in the main path's run "
                f"({n_l} launches) ({card})")
        say(f"profile: one round: all kernels {1e-3 * dev_us:.3f} ms of "
            f"device time; busy share over the median round "
            f"{1e-3 * dev_us / (1e3 * med):.4f}; training kernels "
            f"{1e-3 * sum(v[0] for v in by_tag.values()):.3f} ms; one "
            f"evaluation of {EVAL_NETS} networks {1e-3 * ev_us:.3f} ms "
            f"({card})")
    say(f"phase 8 done in {time.perf_counter() - t0:.1f} s")
    fed = {"zspecs": zspecs, "cfg": cfg, "state0": state0,
           "batch0": batches[0], "word0": round_words[0],
           "state_r0": state_r0, "loss_r0": loss_r0,
           "round_words": round_words, "losses": losses,
           "host_state0": host_state(state0),
           "host_state_r0": host_state(state_r0)}
    return rows, fed



def local_phases(card: str, dev, fed: dict, rows: list) -> list:
    """Phases 9-11: the local-zampling path at full MNISTFC width (the
    paper's Fig. 6 zampling_d16) and the composed federated round.
    Updates the max_abs_err of kernels 7 and 8 in ``rows`` with the
    repaired d range; returns the rows of kernels 1, 3 and 5."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.comm.downlink import get_codec
    from repro_torch.configs.mnistfc import MNISTFC
    from repro_torch.core.federated import federated_round
    from repro_torch.core.sampling import as_words, clip_probs, sample_mask_hash
    from repro_torch.core.transpose_plan import row_plan
    from repro_torch.core.zampling import (ZamplingConfig, build_specs,
                                           init_state, sample_weights)
    from repro_torch.data import make_teacher_dataset
    from repro_torch.kernels import ops, qz_decode
    from repro_torch.kernels import qz_reconstruct as qr
    from repro_torch.models.mlp import mlp_accuracy, mlp_loss, mlp_template
    from repro_torch.optim import adam
    from repro_torch.train import (LocalTrainConfig, evaluate,
                                   train_local_zampling, train_step)

    def fig6(d):
        return build_specs(mlp_template(MNISTFC), ZamplingConfig(
            compression=1.0, d=d, window=128, min_size=128, seed=0))

    max_err = {name: 0.0 for name in qr.LAUNCHES}

    def check(name, got, want, what):
        check_bitwise(max_err, name, got, want, what)

    def launches_are(what, want):
        got = {k: v for k, v in qr.LAUNCHES.items() if v}
        want = {k: v for k, v in want.items() if v}
        say(f"local: launches in {what}: {got}, expected {want}")
        if got != want or any(qz_decode.LAUNCHES.values()):
            die(f"launch counts of {what} differ from the expected")

    # --- 9. kernels 1, 3, 5 and the repaired 7, 8 against plain ------------
    t0 = time.perf_counter()
    rng = np.random.RandomState(SEED + 1)
    for d in LOCAL_DS:
        for path, spec in fig6(d).specs.items():
            what = f"Fig. 6 {path} d={d}"
            P = clip_probs(torch.from_numpy(
                rng.rand(FED_K, spec.n).astype(np.float32) * 1.2 - 0.1).to(dev))
            steps = as_words(rng.randint(0, 2**32, FED_K, dtype=np.uint64),
                             dev)
            P[1, :spec.window] = 0.0  # a client at p = 0 over window 0
            g = torch.from_numpy(rng.randn(spec.m).astype(np.float32)).to(dev)
            W = qr.qz_reconstruct_batched_fwd(spec, P)
            check("qz_reconstruct_batched_fwd", W,
                  ops.reconstruct_plain(spec, P), f"{what} K={FED_K}")
            Zs = P.clone()  # explicit operands holding -0 and negatives
            Zs[:, 1::3] = -0.0
            Zs[2] = -Zs[2]
            check("qz_reconstruct_batched_fwd",
                  qr.qz_reconstruct_batched_fwd(spec, Zs),
                  ops.reconstruct_plain(spec, Zs),
                  f"{what} K={FED_K} operands with -0 and negatives")
            check("qz_reconstruct_fwd", qr.qz_reconstruct_fwd(spec, Zs[2]),
                  ops.reconstruct_plain(spec, Zs[2:3])[0],
                  f"{what} K=1 operand with -0 and negatives")
            w = qr.qz_reconstruct_fwd(spec, P[3])
            check("qz_reconstruct_fwd", w,
                  ops.reconstruct_plain(spec, P[3:4])[0], f"{what} K=1")
            check("qz_reconstruct_fwd", w, W[3],
                  f"{what} K=1 against the batched kernel's row 3")
            check("qz_reconstruct_bwd_plan", qr.qz_reconstruct_bwd_plan(spec, g),
                  ops.plan_bwd_one_plain(spec, g), f"{what} seeded g")
            W = qr.qz_sample_reconstruct_batched_fwd(spec, P, steps)
            check("qz_sample_reconstruct_batched_fwd", W,
                  ops.sample_reconstruct_plain(spec, P, steps),
                  f"{what} K={FED_K}")
            check("qz_sample_reconstruct_fwd",
                  qr.qz_sample_reconstruct_fwd(spec, P[5], steps[5:6]),
                  ops.sample_reconstruct_plain(spec, P[5:6], steps[5:6])[0],
                  f"{what} K=1")
            Z = sample_mask_hash(P, spec.seed, spec.tensor_id, steps)
            check("qz_reconstruct_batched_fwd",
                  qr.qz_reconstruct_batched_fwd(spec, Z), W,
                  f"{what} K={FED_K} on the drawn masks against kernel 8")
            gidx, vals = row_plan(spec, dev)
            r = torch.arange(spec.m, device=dev)
            idx, _, kvals, _ = qz_decode.qz_edges(spec, P[0], 0, r)
            ok = (torch.equal(vals[:spec.m], kvals) and torch.equal(
                gidx[:spec.m], (r // spec.rows_per_window)[:, None]
                * spec.window + idx.to(torch.int64)))
            deg, entries, ok_lay = layout_is_qt(spec, dev)
            say(f"local-plan: {what}: largest in-degree {deg}, {entries} "
                f"entries; row plan equals the kernels' Q = {ok}; the "
                f"layout is Q^T's canonical CSR of it = {ok_lay}")
            if not (ok and ok_lay):
                die(f"the card-built plan differs from the kernels' Q ({what})")
            del P, W, Z, Zs, gidx, vals, idx, kvals
        torch.cuda.empty_cache()
    # kernel 3 at the shapes of its own path, the composed round: the
    # Fig. 4 leaves of phase 7 at K=10, on masks drawn from the round's
    # u8 words (phase 11 times it on these operands)
    u8 = get_codec("u8")
    zs4 = fed["zspecs"]
    fig4_masks = {}
    for path, spec in zs4.specs.items():
        what = f"Fig. 4 {path} d={spec.d}"
        P = u8.decode(spec, fed["state_r0"]["scores"][path]).expand(
            FED_K, spec.n).contiguous()
        steps = as_words(rng.randint(0, 2**32, FED_K, dtype=np.uint64), dev)
        Z = sample_mask_hash(P, spec.seed, spec.tensor_id, steps)
        W = qr.qz_reconstruct_batched_fwd(spec, Z)
        check("qz_reconstruct_batched_fwd", W, ops.reconstruct_plain(spec, Z),
              f"{what} K={FED_K}")
        check("qz_reconstruct_batched_fwd", W,
              qr.qz_sample_reconstruct_batched_fwd(spec, P, steps),
              f"{what} K={FED_K} on the drawn masks against kernel 8")
        fig4_masks[path] = Z
    for row in rows:
        if row["name"] in ("qz_sample_reconstruct_batched_fwd",
                           "qz_sample_reconstruct_fwd"):
            row["max_abs_err"] = max(row["max_abs_err"], max_err[row["name"]])
    say(f"phase 9 done in {time.perf_counter() - t0:.1f} s; every "
        "comparison bitwise")

    # --- 10. local zampling at full width -----------------------------------
    t0 = time.perf_counter()
    zs = fig6(LOCAL_D)
    specs = zs.specs
    rng0 = np.random.RandomState(SEED)  # tests/test_torch_local_reference.py
    scores = {p: rng0.rand(s.n).astype(np.float32) for p, s in specs.items()}
    dense = {p: np.zeros(zs.template[p].shape, np.float32)
             for p in zs.dense_paths}
    step_words = [int(w) for w in rng0.randint(0, 2**32, LOCAL_STEPS,
                                               dtype=np.uint64)]
    eval_words = [int(w) for w in rng0.randint(0, 2**32, EVAL_NETS,
                                               dtype=np.uint64)]
    ds = make_teacher_dataset(n_train=8000, n_test=1500, seed=0)
    it = ds.batches(LOCAL_BATCH, seed=0)
    batches = [{"x": torch.from_numpy(x).to(dev),
                "y": torch.from_numpy(y).to(dev)}
               for x, y in (next(it) for _ in range(LOCAL_STEPS))]
    test = {"x": torch.from_numpy(ds.x_test).to(dev),
            "y": torch.from_numpy(ds.y_test).to(dev)}
    state0 = init_state(zs, scores, dense, device=dev)
    opt = adam(LOCAL_LR)
    say(f"local: Fig. 6 zampling_d16, MNISTFC {MNISTFC} at compression 1, "
        f"d={LOCAL_D}: "
        + ", ".join(f"{p} m={s.m} n={s.n}" for p, s in specs.items())
        + f"; Adam lr {LOCAL_LR}, batch {LOCAL_BATCH}, {LOCAL_STEPS} sample "
        f"steps and {CONT_STEPS} continuous steps; data on the card in "
        f"{time.perf_counter() - t0:.1f} s")

    def acc_fn(params):
        return mlp_accuracy(params, test)

    def step0(mode, impl):
        flat = {**state0["scores"], **state0["dense"]}
        return train_step(zs, state0, opt.init(flat), batches[0],
                          step_words[0], mlp_loss, opt, mode=mode, impl=impl)

    def step0_bitwise(mode, want):
        qr.reset_launches()
        qz_decode.reset_launches()
        k_state, _, k_loss, k_grads = step0(mode, None)
        torch.cuda.synchronize()
        launches_are(f"step 0 ({mode})", want)
        qr.reset_launches()
        p_state, _, p_loss, p_grads = step0(mode, "ref")
        torch.cuda.synchronize()
        same = {"loss": torch.equal(k_loss, p_loss)}
        for part in ("scores", "dense"):
            same[f"{part} gradients"] = all(torch.equal(
                k_grads[part][p], p_grads[part][p]) for p in k_grads[part])
            same[f"updated {part}"] = all(torch.equal(
                k_state[part][p], p_state[part][p]) for p in k_state[part])
        say(f"local: step 0 ({mode}) through the kernels against the plain "
            f"path: {same}; loss {float(k_loss):.9f}; plain-path launches "
            f"{sum(qr.LAUNCHES.values())}")
        if not all(same.values()) or any(qr.LAUNCHES.values()):
            die(f"step 0 ({mode}) through the kernels differs from the "
                "plain path")

    def run(cfg, words, n):
        """train_local_zampling over the first n batches: (state, losses,
        seconds of each step, launches)."""
        marks = []

        def timed():
            for b in batches[:n]:
                marks.append(time.perf_counter())
                yield b

        qr.reset_launches()
        qz_decode.reset_launches()
        state, hist = train_local_zampling(zs, state0, mlp_loss, timed(), cfg,
                                           words, device=dev)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        return state, hist["loss"], np.diff(marks), dict(qr.LAUNCHES)

    def show_losses(mode, losses):
        at = list(range(0, len(losses), 100)) + [len(losses) - 1]
        say(f"local: {mode} loss at steps {at}: "
            f"{[round(losses[t], 6) for t in at]}; mean of the first 20 "
            f"{np.mean(losses[:20]):.6f}, of the last 20 "
            f"{np.mean(losses[-20:]):.6f}")
        if not np.mean(losses[-20:]) < np.mean(losses[:20]):
            die(f"the {mode}-mode loss did not fall")

    def counted_eval(mode):
        qr.reset_launches()
        v, _ = evaluate(zs, state, acc_fn, mode=mode, device=dev)
        launches_are(f"the {mode} evaluation", {"qz_reconstruct_fwd": 3})
        return v

    step0_bitwise("sample", {"qz_sample_reconstruct_fwd": 3,
                             "qz_reconstruct_bwd_plan": 3})
    state, losses, step_s, local_launches = run(
        LocalTrainConfig(steps=LOCAL_STEPS, lr=LOCAL_LR, eval_every=10**9),
        step_words, LOCAL_STEPS)
    launches_are(f"{LOCAL_STEPS} sample steps",
                 {"qz_sample_reconstruct_fwd": 3 * LOCAL_STEPS,
                  "qz_reconstruct_bwd_plan": 3 * LOCAL_STEPS})
    show_losses("sample", losses)
    med = float(np.median(step_s[1:]))
    say(f"local: sample step times: step 0 {1e3 * step_s[0]:.3f} ms, median "
        f"of steps 1-{LOCAL_STEPS - 1} {1e3 * med:.4f} ms (min "
        f"{1e3 * step_s[1:].min():.4f}, max {1e3 * step_s[1:].max():.4f}) on "
        f"{card}")
    with torch.no_grad():
        sampled = [float(acc_fn(sample_weights(zs, state, w, device=dev)))
                   for w in eval_words]
    expected = counted_eval("continuous")
    discretized = counted_eval("discretize")
    say(f"local: after {LOCAL_STEPS} sample steps: sampled accuracy "
        f"{np.mean(sampled):.4f} +- {np.std(sampled):.4f} ({EVAL_NETS} "
        f"networks), best mask {max(sampled):.4f}, expected {expected:.4f}, "
        f"discretized {discretized:.4f}")
    sample_state = state

    step0_bitwise("continuous", {"qz_reconstruct_fwd": 3,
                                 "qz_reconstruct_bwd_plan": 3})
    state, c_losses, c_step_s, cont_launches = run(
        LocalTrainConfig(steps=CONT_STEPS, lr=LOCAL_LR, mode="continuous",
                         eval_every=10**9), None, CONT_STEPS)
    launches_are(f"{CONT_STEPS} continuous steps",
                 {"qz_reconstruct_fwd": 3 * CONT_STEPS,
                  "qz_reconstruct_bwd_plan": 3 * CONT_STEPS})
    show_losses("continuous", c_losses)
    cont_state = state
    c_med = float(np.median(c_step_s[1:]))
    c_expected = counted_eval("continuous")
    c_discretized = counted_eval("discretize")
    with torch.no_grad():
        c_sampled = [float(acc_fn(sample_weights(zs, state, w, device=dev)))
                     for w in eval_words]
    say(f"local: after {CONT_STEPS} continuous steps: expected "
        f"{c_expected:.4f}, discretized {c_discretized:.4f}, sampled "
        f"{np.mean(c_sampled):.4f} +- {np.std(c_sampled):.4f}; median step "
        f"{1e3 * c_med:.4f} ms on {card}")
    if not all(np.isfinite(losses + c_losses)):
        die("a local loss is not finite")
    say("local-json: " + json.dumps({
        "sample": {"losses": losses, "sampled_accuracy": sampled,
                   "expected_accuracy": expected,
                   "discretized_accuracy": discretized,
                   "median_step_ms": 1e3 * med},
        "continuous": {"losses": c_losses, "expected_accuracy": c_expected,
                       "discretized_accuracy": c_discretized,
                       "sampled_accuracy": c_sampled,
                       "median_step_ms": 1e3 * c_med}}))

    # the composed federated round against the fused round 0 (phase 7)
    ccfg = dataclasses.replace(fed["cfg"], mask_path="composed")
    qr.reset_launches()
    qz_decode.reset_launches()
    t1 = time.perf_counter()
    c_round, c_met = federated_round(zs4, fed["state0"], mlp_loss,
                                     fed["batch0"], fed["word0"], ccfg,
                                     round_index=0, device=dev)
    torch.cuda.synchronize()
    c_round_s = time.perf_counter() - t1
    composed_launches = dict(qr.LAUNCHES)
    launches_are("the composed round",
                 {"qz_reconstruct_batched_fwd": 3 * FED_E,
                  "qz_reconstruct_batched_bwd_plan": 3 * FED_E})
    same = (all(torch.equal(c_round["scores"][p], fed["state_r0"]["scores"][p])
                for p in zs4.specs),
            all(torch.equal(c_round["dense"][p], fed["state_r0"]["dense"][p])
                for p in zs4.dense_paths),
            torch.equal(c_met["loss"], fed["loss_r0"]))
    say(f"local: composed round 0 against the fused round 0: u8 words "
        f"bitwise={same[0]}, dense bitwise={same[1]}, loss bitwise="
        f"{same[2]} ({float(c_met['loss']):.9f}); {c_round_s:.3f} s")
    if not all(same):
        die("the composed round differs from the fused round")
    say(f"phase 10 done in {time.perf_counter() - t0:.1f} s")

    # --- 11. times of kernels 1, 3 and 5 --------------------------------------
    t0 = time.perf_counter()
    kt = KernelTimes(card, {
        "qz_reconstruct_fwd": "mask_reconstruct_window_kernel",
        "qz_reconstruct_batched_fwd": "mask_reconstruct_window_kernel",
        "qz_reconstruct_bwd_plan": "plan_bwd_kernel"})

    def add(name, path, kernel, plain, library, ops_n, bytes_n):
        kt.add(name, path, kernel, event_ms(plain, 3), event_ms(library, 50),
               ops_n, bytes_n)

    def fwd_work(spec, Z):
        """(ops, bytes) of W = Q Z: per row, per edge, per edge some
        client's operand is not 0, per (client, edge) whose is not 0."""
        gidx, _ = row_plan(spec, dev)
        live = Z[:, gidx[:spec.m]] != 0  # (K, m, d): this run's operands
        K, m, d = Z.shape[0], spec.m, spec.d
        ops_n = (m * OPS_PER_WEIGHT + m * d * OPS_ROW_EDGE
                 + float(live.any(0).sum()) * OPS_VALUE
                 + float(live.sum()) * OPS_MAC)
        return ops_n, K * (4 * spec.n + 4 * m)

    for path, spec in specs.items():
        # the continuous run's own operand: its final clipped probabilities
        z = clip_probs(cont_state["scores"][path])
        Q = q_csr(spec, dev, False)
        zt = z[:, None].contiguous()
        add("qz_reconstruct_fwd", path,
            lambda: qr.qz_reconstruct_fwd(spec, z),
            lambda: ops.reconstruct_plain(spec, z[None]),
            lambda: torch.sparse.mm(Q, zt), *fwd_work(spec, z[None]))
        launch_report(card, kt, "qz_reconstruct_fwd", path,
                      lambda: qr.qz_reconstruct_fwd(spec, z),
                      qr.fwd_geometry(spec, 1, True))
        g = torch.from_numpy(rng.randn(spec.m).astype(np.float32)).to(dev)
        QT = q_csr(spec, dev, True)
        gt = g[:, None].contiguous()
        md = spec.m * spec.d
        geo = qr.plan_bwd_geometry(spec, dev)
        # the compact layout's entries (a value and a row of
        # geo.row_bytes each) and offsets, g and the output
        add("qz_reconstruct_bwd_plan", path,
            lambda: qr.qz_reconstruct_bwd_plan(spec, g),
            lambda: ops.plan_bwd_one_plain(spec, g),
            lambda: torch.sparse.mm(QT, gt), OPS_PLAN * md,
            (4 + geo.row_bytes) * md + 4 * (spec.n + 1)
            + 4 * (spec.m + spec.n))
        launch_report(card, kt, "qz_reconstruct_bwd_plan", path,
                      lambda: qr.qz_reconstruct_bwd_plan(spec, g), geo)
    say("launch: qz_reconstruct_bwd_plan host cost a launch, as the events "
        f"of {path}: "
        f"{1e3 * kt.acc['qz_reconstruct_bwd_plan']['shapes'][path]['ms']:.2f}"
        f" us ({card})")
    for path, spec in zs4.specs.items():
        Z = fig4_masks[path]
        Q = q_csr(spec, dev, False)
        Zt = Z.t().contiguous()
        add("qz_reconstruct_batched_fwd", path,
            lambda: qr.qz_reconstruct_batched_fwd(spec, Z),
            lambda: ops.reconstruct_plain(spec, Z),
            lambda: torch.sparse.mm(Q, Zt), *fwd_work(spec, Z))
        launch_report(card, kt, "qz_reconstruct_batched_fwd", path,
                      lambda: qr.qz_reconstruct_batched_fwd(spec, Z),
                      qr.fwd_geometry(spec, FED_K, True))

    meta = {
        "qz_reconstruct_fwd": (
            "src/repro/kernels/qz_reconstruct.py:199", cont_launches, 1,
            "one continuous-mode local step: 1 launch per zampled leaf",
            "torch.sparse.mm(Q_csr, z)"),
        "qz_reconstruct_batched_fwd": (
            "src/repro/kernels/qz_reconstruct.py:269", composed_launches,
            FED_E, "one composed round: E launches per zampled leaf, K=10",
            "torch.sparse.mm(Q_csr, Z^T) on the drawn masks"),
        "qz_reconstruct_bwd_plan": (
            "src/repro/kernels/qz_reconstruct.py:349", local_launches, 1,
            "one sample-mode local step: 1 launch per zampled leaf",
            "torch.sparse.mm(Q^T_csr, g)"),
    }
    out = [kt.row(name, replaces, launch_src[name], max_err[name], times,
                  per, lib)
           for name, (replaces, launch_src, times, per, lib) in meta.items()]

    # device time of local steps in the main path, by torch.profiler
    flat = {**sample_state["scores"], **sample_state["dense"]}

    def steps10(mode):
        st, os_ = sample_state, opt.init(flat)
        for t in range(10):
            st, os_, loss, _ = train_step(zs, st, os_, batches[t],
                                          step_words[t], mlp_loss, opt,
                                          mode=mode)
            float(loss)

    for mode, m_ms, kernel_tags in (
            ("sample", med, ("sample_reconstruct_window_kernel",
                             "plan_bwd_kernel")),
            ("continuous", c_med, ("mask_reconstruct_window_kernel",
                                   "plan_bwd_kernel"))):
        by_tag, dev_us = profile_device_us(lambda: steps10(mode),
                                           kernel_tags)
        if dev_us <= 0:
            say("profile: torch.profiler showed no device time; device "
                "times not measured")
            continue
        say(f"profile: 10 {mode}-mode local steps: all kernels "
            f"{1e-3 * dev_us / 10:.4f} ms of device time per step, busy "
            f"share over the median step {1e-3 * dev_us / 10 / (1e3 * m_ms):.4f}"
            + "".join(f"; {t} {1e-3 * v[0] / 10:.4f} ms per step ({v[1]} "
                      f"launches)" for t, v in by_tag.items())
            + f" ({card})")
    say(f"phase 11 done in {time.perf_counter() - t0:.1f} s")

    # --- 12. the K=1 scatter backward, and local training under it --------
    t0 = time.perf_counter()
    for d in LOCAL_DS:
        for path, spec in fig6(d).specs.items():
            what = f"Fig. 6 {path} d={d}"
            g = torch.from_numpy(rng.randn(spec.m).astype(np.float32)).to(dev)
            g[::3] = 0.0  # rows whose cotangent is 0
            gz = qr.qz_reconstruct_bwd(spec, g)
            check("qz_reconstruct_bwd", gz, ops.scatter_bwd_one_plain(spec, g),
                  what)
            check("qz_reconstruct_bwd", gz, qr.qz_reconstruct_bwd_plan(spec, g),
                  f"{what} against kernel 5 on the canonical plan")
            check("qz_reconstruct_bwd", qr.qz_reconstruct_bwd(spec, g), gz,
                  f"{what} a second launch")
            check("qz_reconstruct_bwd_plan",
                  qr.qz_reconstruct_bwd_plan(spec, g, "slot"),
                  ops.plan_bwd_one_plain(spec, g, "slot"),
                  f"{what} slot plan")
    os.environ["REPRO_BWD_PLAN"] = "scatter"
    try:
        qr.reset_launches()
        qz_decode.reset_launches()
        flat0 = {**state0["scores"], **state0["dense"]}
        k_state, k_opt, k_loss, k_grads = train_step(
            zs, state0, opt.init(flat0), batches[0], step_words[0], mlp_loss,
            opt)
        torch.cuda.synchronize()
        launches_are("step 0 under scatter", {"qz_sample_reconstruct_fwd": 3,
                                              "qz_reconstruct_bwd": 3})
        os.environ["REPRO_BWD_PLAN"] = "plan"
        qr.reset_launches()
        p_state, p_opt, p_loss, p_grads = train_step(
            zs, state0, opt.init(flat0), batches[0], step_words[0], mlp_loss,
            opt)
        torch.cuda.synchronize()
        launches_are("step 0 on the plan", {"qz_sample_reconstruct_fwd": 3,
                                            "qz_reconstruct_bwd_plan": 3})
        same = {"loss": torch.equal(k_loss, p_loss),
                "Adam step": torch.equal(k_opt.step, p_opt.step)}
        for part in ("scores", "dense"):
            same[f"{part} gradients"] = all(torch.equal(
                k_grads[part][p], p_grads[part][p]) for p in k_grads[part])
            same[f"updated {part}"] = all(torch.equal(
                k_state[part][p], p_state[part][p]) for p in k_state[part])
        same["Adam moments"] = all(
            torch.equal(k_opt.mu[p], p_opt.mu[p])
            and torch.equal(k_opt.nu[p], p_opt.nu[p]) for p in k_opt.mu)
        say(f"local: step 0 through kernels 7 and 2 (scatter) against kernels "
            f"7 and 5 (plan): {same}; loss {float(k_loss):.9f}")
        if not all(same.values()):
            die("local step 0 under scatter differs from the plan's")
        os.environ["REPRO_BWD_PLAN"] = "scatter"
        _, sc_losses, sc_step_s, scatter_launches = run(
            LocalTrainConfig(steps=SCATTER_STEPS, lr=LOCAL_LR,
                             eval_every=10**9), step_words, SCATTER_STEPS)
        launches_are(f"{SCATTER_STEPS} sample steps under scatter",
                     {"qz_sample_reconstruct_fwd": 3 * SCATTER_STEPS,
                      "qz_reconstruct_bwd": 3 * SCATTER_STEPS})
    finally:
        os.environ.pop("REPRO_BWD_PLAN", None)
    sc_med = float(np.median(sc_step_s[1:]))
    same_losses = sc_losses == losses[:SCATTER_STEPS]
    say(f"local: {SCATTER_STEPS} steps under scatter: losses {[round(v, 6) for v in sc_losses[:5]]}"
        f"...{round(sc_losses[-1], 6)}, equal to phase 10's first "
        f"{SCATTER_STEPS} in every bit = {same_losses}; median step "
        f"{1e3 * sc_med:.4f} ms (plan: {1e3 * med:.4f} ms) on {card}")
    if not same_losses:
        die("local training under scatter differs from the plan's")
    kt2 = KernelTimes(card, {"qz_reconstruct_bwd": "scatter_bwd_kernel"})
    for path, spec in specs.items():
        g = torch.from_numpy(rng.randn(spec.m).astype(np.float32)).to(dev)
        QT = q_csr(spec, dev, True)
        gt = g[:, None].contiguous()
        kt2.add("qz_reconstruct_bwd", path,
                lambda: qr.qz_reconstruct_bwd(spec, g),
                event_ms(lambda: ops.scatter_bwd_one_plain(spec, g), 3),
                event_ms(lambda: torch.sparse.mm(QT, gt), 50),
                *scatter_work(spec, g[None]))
        launch_report(card, kt2, "qz_reconstruct_bwd", path,
                      lambda: qr.qz_reconstruct_bwd(spec, g),
                      qr.scatter_bwd_geometry(spec))
    say("launch: qz_reconstruct_bwd host cost a launch, as the events of "
        f"{path}: "
        f"{1e3 * kt2.acc['qz_reconstruct_bwd']['shapes'][path]['ms']:.2f} us "
        f"({card})")
    out.append(kt2.row(
        "qz_reconstruct_bwd", "src/repro/kernels/qz_reconstruct.py:224",
        scatter_launches["qz_reconstruct_bwd"], max_err["qz_reconstruct_bwd"],
        1,
        "one sample-mode local step under REPRO_BWD_PLAN=scatter: 1 launch "
        "per zampled leaf", "torch.sparse.mm(Q^T_csr, g)"))
    say(f"phase 12 done in {time.perf_counter() - t0:.1f} s")
    return out


def lm_phases(card: str, dev, fed: dict, kernel_rows: list) -> list:
    """Phases 13-16: kernel 4 against its plain version and kernel 6, and
    federated zampling of qwen2-0.5b through launch/train.py (the
    default scale 0.25 against the plain path, then full width under
    REPRO_BWD_PLAN=scatter), with kernels 8 and 4 held against their
    plain versions at every full-width leaf.  Updates kernel 8's
    max_abs_err in ``kernel_rows``; returns kernel 4's row."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core import federated as tfed
    from repro_torch.core.sampling import (as_words, fold_word,
                                           sample_mask_hash,
                                           sample_mask_qhash)
    from repro_torch.core.transpose_plan import clear_caches
    from repro_torch.core.zampling import ZamplingConfig, build_specs
    from repro_torch.kernels import ops, qz_decode
    from repro_torch.kernels import qz_reconstruct as qr
    from repro_torch.launch import train as lm_train
    from repro_torch.models.model import param_template

    max_err = {name: 0.0 for name in qr.LAUNCHES}

    def check(name, got, want, what):
        check_bitwise(max_err, name, got, want, what)

    def launched():
        return {k: v for k, v in qr.LAUNCHES.items() if v}

    # --- 13. kernel 4 against its plain version and kernel 6 ---------------
    t0 = time.perf_counter()
    rng = np.random.RandomState(SEED + 2)
    full = build_specs(param_template(get_arch("qwen2-0.5b")), ZamplingConfig(
        compression=8, d=8, min_size=4096))  # launch/train.py's at scale 1
    cases = [(f"Fig. 4 {p}", s_, FED_K) for p, s_ in fed["zspecs"].specs.items()]
    cases += [(f"qwen2-0.5b {p}", full.specs[p], LM_K)
              for p in ("blocks/ln1", "blocks/attn/wk", "blocks/attn/wq")]
    for what, spec, K in cases:
        G = torch.from_numpy(rng.randn(K, spec.m).astype(np.float32)).to(dev)
        G[:, ::3] = 0.0  # rows whose cotangent is 0 for every client
        what = (f"{what} m={spec.m} n={spec.n} rpw={spec.rows_per_window} "
                f"d={spec.d} K={K}")
        out = qr.qz_reconstruct_batched_bwd(spec, G)
        check("qz_reconstruct_batched_bwd", out, ops.scatter_bwd_plain(spec, G),
              what)
        check("qz_reconstruct_batched_bwd", out,
              qr.qz_reconstruct_batched_bwd_plan(spec, G),
              f"{what} against kernel 6 on the canonical plan")
        check("qz_reconstruct_batched_bwd", qr.qz_reconstruct_batched_bwd(
            spec, G), out, f"{what} a second launch")
        check("qz_reconstruct_batched_bwd_plan",
              qr.qz_reconstruct_batched_bwd_plan(spec, G, "slot"),
              ops.plan_bwd_plain(spec, G, "slot"), f"{what} slot plan")
        say(f"launch: qz_reconstruct_batched_bwd {what}: "
            f"{geometry_text(qr.scatter_bwd_geometry(spec, K))}")
        say(f"launch: qz_reconstruct_batched_bwd_plan {what}: "
            f"{geometry_text(qr.plan_bwd_geometry(spec, dev, K=K))}")
        del G, out
        clear_caches()  # the plain versions' plans
        qr.clear_caches()  # the kernel's layouts
        torch.cuda.empty_cache()
    say(f"phase 13 done in {time.perf_counter() - t0:.1f} s; every "
        "comparison bitwise")

    os.environ["REPRO_BWD_PLAN"] = "scatter"
    try:
        # --- 14. launch/train.py's default configuration, kernels vs plain --
        t0 = time.perf_counter()
        args = lm_train.parser().parse_args(["--rounds", "1"])
        run = lm_train.build(args)
        say(lm_train.describe(run) + f"; K={args.clients} E="
            f"{args.local_steps} B={args.batch} S={args.seq} "
            f"{run.cfg.dtype}; REPRO_BWD_PLAN=scatter")
        n_leaves = len(run.zspecs.specs)
        batch = run.batch()
        torch.use_deterministic_algorithms(True)
        try:
            res = {}
            for impl in (None, "ref"):
                qr.reset_launches()
                qz_decode.reset_launches()
                t1 = time.perf_counter()
                res[impl] = tfed.federated_round(
                    run.zspecs, run.state, run.loss, batch, run.words[0],
                    run.fcfg, impl=impl, device=dev)
                torch.cuda.synchronize()
                say(f"lm: round 0 at scale {args.scale} through "
                    f"{'the kernels' if impl is None else 'the plain path'}: "
                    f"loss {float(res[impl][1]['loss']):.9f}, "
                    f"{time.perf_counter() - t1:.2f} s, launches {launched()}")
                want = ({"qz_sample_reconstruct_batched_fwd":
                         n_leaves * args.local_steps,
                         "qz_reconstruct_batched_bwd":
                         n_leaves * args.local_steps} if impl is None else {})
                if launched() != want or any(qz_decode.LAUNCHES.values()):
                    die(f"round 0 launches {launched()}, expected {want}")
        finally:
            torch.use_deterministic_algorithms(False)
        (a, ma), (b, mb) = res[None], res["ref"]
        same = (all(torch.equal(a["scores"][p], b["scores"][p])
                    for p in run.zspecs.specs),
                all(torch.equal(a["dense"][p], b["dense"][p])
                    for p in run.zspecs.dense_paths),
                torch.equal(ma["loss"], mb["loss"]))
        say(f"lm: round 0 kernels against plain (deterministic algorithms): "
            f"score means bitwise={same[0]}, dense bitwise={same[1]}, loss "
            f"bitwise={same[2]}")
        if not all(same):
            die("LM round 0 through the kernels differs from the plain path")
        del run, res, a, b
        clear_caches()
        torch.cuda.empty_cache()
        say(f"phase 14 done in {time.perf_counter() - t0:.1f} s")

        # --- 15. full width, through the kernels only ------------------------
        t0 = time.perf_counter()
        args = lm_train.parser().parse_args(
            ["--scale", "1.0", "--rounds", str(LM_ROUNDS)])
        run = lm_train.build(args)
        E = args.local_steps
        say(lm_train.describe(run) + f"; K={args.clients} E={E} "
            f"B={args.batch} S={args.seq} {run.cfg.dtype}; "
            "REPRO_BWD_PLAN=scatter; built in "
            f"{time.perf_counter() - t0:.1f} s")
        n_leaves = len(run.zspecs.specs)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        qr.reset_launches()
        qz_decode.reset_launches()
        per_round, round_s, snap = [], [], {}

        def on_round(r, state, met, dt):
            now = dict(qr.LAUNCHES)
            per_round.append({k: v - snap.get(k, 0) for k, v in now.items()
                              if v - snap.get(k, 0)})
            snap.update(now)
            round_s.append(dt)

        history = lm_train.train(run, on_round=on_round)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        lm_launches = dict(qr.LAUNCHES)
        want = {"qz_sample_reconstruct_batched_fwd": n_leaves * E,
                "qz_reconstruct_batched_bwd": n_leaves * E}
        say(f"lm: full width, {LM_ROUNDS} rounds: losses {history}; round "
            f"times {[round(t, 4) for t in round_s]} s; launches per round "
            f"{per_round}, expected {want} each")
        if not all(np.isfinite(history)):
            die(f"a full-width loss is not finite: {history}")
        if (any(pr != want for pr in per_round)
                or any(qz_decode.LAUNCHES.values())):
            die("full-width launches differ from 12 E of kernels 8 and 4 a "
                "round, none of the others")
        # the bytes the plan path would hold: each leaf's row plan
        # (int64 coordinate and f32 value per edge) and transpose plan
        # (int32 row and f32 value per (coordinate, deg) entry, deg the
        # exact largest in-degree, counted here), never allocated
        plan_bytes = 0
        for path, spec in run.zspecs.specs.items():
            counts = torch.zeros(spec.n, dtype=torch.int64, device=dev)
            p0 = torch.zeros(spec.n, device=dev)
            step = max(1, (1 << 24) // spec.d)
            for r0 in range(0, spec.m, step):
                rows = torch.arange(r0, min(spec.m, r0 + step), device=dev)
                idx, _, _, _ = qz_decode.qz_edges(spec, p0, 0, rows)
                coord = ((rows // spec.rows_per_window)[:, None] * spec.window
                         + idx.to(torch.int64))
                counts += torch.bincount(coord.reshape(-1),
                                         minlength=spec.n)
            deg = int(counts.max())
            plan_bytes += 12 * spec.m_pad * spec.d + 8 * spec.n * deg
            if path in ("embed", "blocks/ln1"):
                say(f"lm: {path}: m={spec.m} n={spec.n} window={spec.window} "
                    f"rpw={spec.rows_per_window}, largest in-degree {deg}")
            del counts
        say(f"lm: peak device memory {peak / 2**30:.3f} GiB "
            f"(torch.cuda.max_memory_allocated, {LM_ROUNDS} rounds); the plan "
            f"path's row and transpose plans alone {plan_bytes / 2**30:.3f} GiB"
            f" (computed, never allocated), on a card of "
            f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.1f}"
            f" GiB ({card})")
        # one local step's time: local_update at E and at E-1 steps
        batch = {n: torch.from_numpy(v).to(dev)
                 for n, v in run.batch().items()}
        words = [fold_word(run.words[-1], 0, i) for i in range(args.clients)]
        lu_s = {}
        for e in (E, E - 1):
            cfg_e = dataclasses.replace(run.fcfg, local_steps=e)
            b_e = {n: v[:, :e].contiguous() for n, v in batch.items()}
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            tfed.local_update(run.zspecs, run.state, run.loss, b_e, words,
                              cfg_e)
            torch.cuda.synchronize()
            lu_s[e] = time.perf_counter() - t1
        step_s = lu_s[E] - lu_s[E - 1]
        med = float(np.median(round_s))
        # one more round (the next batch) under torch.profiler
        by_tag, dev_us, top = profile_device_us(
            lambda: tfed.federated_round(run.zspecs, run.state, run.loss,
                                         run.batch(), run.words[-1],
                                         run.fcfg, device=dev),
            ("sample_reconstruct_window_kernel", "scatter_bwd_kernel"), top=12)
        say(f"lm: median round {med:.4f} s; one local step "
            f"{1e3 * step_s:.2f} ms (local_update at E={E} {lu_s[E]:.4f} s, "
            f"at E={E - 1} {lu_s[E - 1]:.4f} s) ({card})")
        if dev_us > 0:
            say(f"profile: one full-width round: all kernels "
                f"{1e-3 * dev_us:.3f} ms of device time, busy share over the "
                f"median round {1e-3 * dev_us / (1e3 * med):.4f}"
                + "".join(f"; {t} {1e-3 * v[0]:.3f} ms ({v[1]} launches)"
                          for t, v in by_tag.items()) + f" ({card})")
            for name, us, n_l in top:
                say(f"profile: full-width round: {1e-3 * us:9.3f} ms in "
                    f"{n_l:5d} launches of {name[:110]}")
        else:
            say("profile: torch.profiler showed no device time; busy share "
                "not measured")
        say(f"phase 15 done in {time.perf_counter() - t0:.1f} s")

        # --- 16. kernels 8 and 4 on one local step's own operands ----------
        t0 = time.perf_counter()
        stash8, stash4 = {}, {}
        launch8 = qr.qz_sample_reconstruct_batched_fwd
        launch4 = qr.qz_reconstruct_batched_bwd

        def stashing8(spec, P, steps, qbits=None):
            stash8[spec] = (P.detach().clone(), steps.clone()
                            if torch.is_tensor(steps) else steps, qbits)
            return launch8(spec, P, steps, qbits)

        def stashing4(spec, G):
            out = launch4(spec, G)
            stash4[spec] = (G.detach().clone(), out.clone())
            return out

        qr.qz_sample_reconstruct_batched_fwd = stashing8
        qr.qz_reconstruct_batched_bwd = stashing4
        try:
            b1 = {n: v[:, :1].contiguous() for n, v in batch.items()}
            tfed.local_update(run.zspecs, run.state, run.loss, b1, words,
                              dataclasses.replace(run.fcfg, local_steps=1))
        finally:
            qr.qz_sample_reconstruct_batched_fwd = launch8
            qr.qz_reconstruct_batched_bwd = launch4
        del run, batch
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        leaves = set(full.specs.values())
        if set(stash8) != leaves or set(stash4) != leaves:
            die("one full-width local step did not reach kernels 8 and 4 at "
                "every zampled leaf")
        kt = KernelTimes(card, {"qz_reconstruct_batched_bwd":
                                "scatter_bwd_kernel"})
        kt8 = KernelTimes(card, {"qz_sample_reconstruct_batched_fwd":
                                 "sample_reconstruct_window_kernel"})
        for path, spec in full.specs.items():
            what = (f"full-width {path} m={spec.m} n={spec.n} "
                    f"rpw={spec.rows_per_window} d={spec.d} K={LM_K}")
            G, got = stash4.pop(spec)
            plain = {}

            def plain4():
                plain["out"] = ops.scatter_bwd_plain(spec, G)

            t_plain = event_ms(plain4, 1, warm=False)
            check("qz_reconstruct_batched_bwd", got, plain["out"],
                  f"{what} (the local step's own cotangent)")
            check("qz_reconstruct_batched_bwd", qr.qz_reconstruct_batched_bwd(
                spec, G), got, f"{what} a second launch")
            QT = q_csr(spec, dev, True)
            Gt = G.t().contiguous()
            lib_out = torch.sparse.mm(QT, Gt).t()
            say(f"library: {path}: sparse.mm(Q^T, G^T) against kernel 4: max "
                f"abs diff {(got - lib_out).abs().max().item():.3e} (of max "
                f"{got.abs().max().item():.3e})")
            del got, lib_out, plain
            kt.add("qz_reconstruct_batched_bwd", path,
                   lambda: qr.qz_reconstruct_batched_bwd(spec, G), t_plain,
                   event_ms(lambda: torch.sparse.mm(QT, Gt), 5),
                   *scatter_work(spec, G))
            launch_report(card, kt, "qz_reconstruct_batched_bwd", path,
                          lambda: qr.qz_reconstruct_batched_bwd(spec, G),
                          qr.scatter_bwd_geometry(spec, LM_K))
            del G, QT, Gt
            torch.cuda.empty_cache()
            P, steps, qbits = stash8.pop(spec)
            plain = {}

            def plain8():
                plain["out"] = ops.sample_reconstruct_plain(spec, P, steps,
                                                            qbits)

            t_plain = event_ms(plain8, 1, warm=False)
            check("qz_sample_reconstruct_batched_fwd",
                  qr.qz_sample_reconstruct_batched_fwd(spec, P, steps, qbits),
                  plain["out"],
                  f"{what} (the local step's own probabilities and words)")
            del plain["out"]
            clear_caches()  # the plain forward's row plan
            torch.cuda.empty_cache()
            # kernel 8's times on the same operands: its bound counts this
            # step's draws, its yardstick multiplies the drawn masks
            words_k = as_words(steps, dev).reshape(-1)
            Z = (sample_mask_hash(P, spec.seed, spec.tensor_id, words_k)
                 if qbits is None else sample_mask_qhash(
                     P, qbits, spec.seed, spec.tensor_id, words_k))
            drawn, any_drawn = drawn_counts(spec, Z)
            Q = q_csr(spec, dev, False)
            Zt = Z.t().contiguous()
            m, n, d = spec.m, spec.n, spec.d
            kt8.add("qz_sample_reconstruct_batched_fwd", path,
                    lambda: qr.qz_sample_reconstruct_batched_fwd(
                        spec, P, steps, qbits), t_plain,
                    event_ms(lambda: torch.sparse.mm(Q, Zt), 5),
                    m * OPS_PER_WEIGHT + m * d * OPS_ROW_EDGE
                    + any_drawn * OPS_VALUE + LM_K * n * OPS_DRAW + drawn,
                    LM_K * (P.element_size() * n + 4 * m) + 4 * LM_K)
            launch_report(card, kt8, "qz_sample_reconstruct_batched_fwd",
                          path, lambda: qr.qz_sample_reconstruct_batched_fwd(
                              spec, P, steps, qbits),
                          qr.fwd_geometry(spec, LM_K))
            del P, steps, Z, Zt, Q
            torch.cuda.empty_cache()
        say(f"lm: kernels 8 and 4 bitwise their plain versions at all "
            f"{len(full.specs)} full-width leaves on one local step's "
            f"operands; peak device memory of the checks "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        for r in kernel_rows:
            if r["name"] == "qz_sample_reconstruct_batched_fwd":
                r["max_abs_err"] = max(
                    r["max_abs_err"],
                    max_err["qz_sample_reconstruct_batched_fwd"])
        row = kt.row(
            "qz_reconstruct_batched_bwd",
            "src/repro/kernels/qz_reconstruct.py:296",
            lm_launches["qz_reconstruct_batched_bwd"],
            max_err["qz_reconstruct_batched_bwd"], 1,
            "one full-width qwen2-0.5b local step under "
            "REPRO_BWD_PLAN=scatter: 1 launch per zampled leaf, K=4",
            "torch.sparse.mm(Q^T_csr, G^T)")
        if dev_us > 0:
            us, n_l = by_tag["scatter_bwd_kernel"]
            row["device_ms_in_main_path"] = 1e-3 * us / E
        row8 = kt8.row(
            "qz_sample_reconstruct_batched_fwd",
            "src/repro/kernels/qz_reconstruct.py:553",
            lm_launches["qz_sample_reconstruct_batched_fwd"],
            max_err["qz_sample_reconstruct_batched_fwd"], 1,
            "one full-width qwen2-0.5b local step: 1 launch per zampled "
            "leaf, K=4",
            "torch.sparse.mm(Q_csr, Z^T) on the drawn masks (no draw)")
        if dev_us > 0:
            us, _ = by_tag["sample_reconstruct_window_kernel"]
            row8["device_ms_in_main_path"] = 1e-3 * us / E
        for r in kernel_rows:  # beside its Fig. 4 round
            if r["name"] == "qz_sample_reconstruct_batched_fwd":
                r["lm_step"] = {k: row8[k] for k in (
                    "launches", "ms", "device_ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms", "library_call", "per",
                    "shapes", "device_ms_in_main_path") if k in row8}
        row["lm"] = {"losses": history, "round_s": round_s,
                     "local_step_ms": 1e3 * step_s, "peak_bytes": peak,
                     "plan_path_bytes": plan_bytes,
                     "busy_share": (1e-3 * dev_us / (1e3 * med)
                                    if dev_us > 0 else None)}
        say(f"phase 16 done in {time.perf_counter() - t0:.1f} s")
    finally:
        os.environ.pop("REPRO_BWD_PLAN", None)
    return [row]


def sharded_rank(a: dict) -> dict:
    """One rank of phase 17, in its own process (started by
    ``comm.shardmap.run_ranks``): client k = the rank trains phase 7's
    client k on the card, through ``sharded_client_fit``.  Round 0 of
    that fit records its state, each upload's operands and lanes, and
    each leaf's first backward; after the timed run, kernel 9 is held
    against its plain version and kernel 10's row on those operands, and
    kernel 5 against its plain version and kernel 6's row.  Returns host
    arrays: the fit's launches, losses, time and final state, round 0's
    state, upload words and lanes, and the checks."""
    import numpy as np
    import torch
    import torch.distributed as dist

    import repro_torch.train.fit as fit_mod
    from repro_torch.comm.shardmap import axis_index
    from repro_torch.configs.mnistfc import MNISTFC
    from repro_torch.core.federated import FederatedConfig
    from repro_torch.core.sampling import as_words
    from repro_torch.core.zampling import ZamplingConfig, build_specs
    from repro_torch.kernels import ops, qz_decode
    from repro_torch.kernels import qz_reconstruct as qr
    from repro_torch.models.mlp import mlp_loss, mlp_template

    # a rank is a new process: main()'s switches are not inherited
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    rank = axis_index()
    zspecs = build_specs(mlp_template(MNISTFC),
                         ZamplingConfig(**FED_ZAMPLING))
    cfg = FederatedConfig(**FED_CONFIG)
    words = a["round_words"]
    _, stream = fed_data()
    mine = [next(stream) for _ in words]
    batches = {n: torch.from_numpy(np.stack([b[i][rank] for b in mine])
                                   ).to(dev)
               for i, n in enumerate(("x", "y"))}  # (R, E, B, ...)
    del mine
    qr.build()
    torch.cuda.synchronize()
    # hooks on the fit's own round 0: each calls what it wraps, so the
    # counts are the fit's; they copy on the device, and time each round
    uploads, bwd, r0, round_s = [], {}, [], []
    pack, plan_bwd = ops.sample_pack, qr.qz_reconstruct_bwd_plan
    update = fit_mod.sharded_client_update

    def recording_pack(spec, p, step, **kw):
        lanes = pack(spec, p, step, **kw)
        if not r0:
            uploads.append((p.detach().clone(), step, lanes))
        return lanes

    def recording_bwd(spec, g, *args):
        gz = plan_bwd(spec, g, *args)
        if spec.tensor_id not in bwd:  # round 0's first local step
            bwd[spec.tensor_id] = (g.clone(), args, gz.clone())
        return gz

    def recording_update(*args, **kw):
        t = time.perf_counter()
        st, met = update(*args, **kw)
        torch.cuda.synchronize()
        round_s.append(time.perf_counter() - t)
        if not r0:
            r0.append({part: {p: v.clone() for p, v in st[part].items()}
                       for part in ("scores", "dense")})
        return st, met

    ops.sample_pack, qr.qz_reconstruct_bwd_plan = recording_pack, recording_bwd
    fit_mod.sharded_client_update = recording_update
    # the main path: every count at 0 just before it, read just after
    dist.barrier()
    qr.reset_launches()
    qz_decode.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, mets = fit_mod.sharded_client_fit(
        zspecs, a["state0"], mlp_loss, batches, words, cfg, device=dev)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = dict(qr.LAUNCHES)
    launches.update(qz_decode.LAUNCHES)
    ops.sample_pack, qr.qz_reconstruct_bwd_plan = pack, plan_bwd
    fit_mod.sharded_client_update = update
    if len(uploads) != len(zspecs.specs) or len(bwd) != len(zspecs.specs):
        raise RuntimeError(f"round 0 recorded {len(uploads)} uploads and "
                           f"{len(bwd)} backwards of {len(zspecs.specs)} "
                           "leaves")

    def diff(x, y):
        return float((x.double() - y.double()).abs().max().item())

    checks, bwd_checks = [], []
    for path, (p, step, lanes) in zip(zspecs.specs, uploads):
        spec = zspecs.specs[path]
        k9 = qr.qz_sample_pack_fwd(spec, p, step)
        plain = ops.sample_pack_one_plain(spec, p, step)
        k10 = qr.qz_sample_pack_batched_fwd(spec, p[None].contiguous(),
                                            as_words([step], dev))[0]
        torch.cuda.synchronize()
        checks.append((path, bool(torch.equal(k9, plain)),
                       bool(torch.equal(k9, k10)),
                       bool(torch.equal(k9, lanes)), diff(k9, plain)))
        g, args, gz = bwd[spec.tensor_id]
        k5 = qr.qz_reconstruct_bwd_plan(spec, g, *args)
        plain = ops.plan_bwd_one_plain(spec, g, *args)
        k6 = qr.qz_reconstruct_batched_bwd_plan(spec, g[None].contiguous(),
                                                *args)[0]
        torch.cuda.synchronize()
        bwd_checks.append((path, bool(torch.equal(k5, plain)),
                           bool(torch.equal(k5, k6)),
                           bool(torch.equal(k5, gz)), diff(k5, plain)))
    return {"rank": rank, "launches": launches, "fit_s": fit_s,
            "round_s": round_s,
            "losses": mets["loss"].cpu().numpy(),
            "uplink_bytes_per_client": float(
                mets["uplink_bytes_per_client"][0]),
            "cohort_size": float(mets["cohort_size"][0]),
            "state": host_state(state), "state_r0": host_state(r0[0]),
            "upload_words": [step for _, step, _ in uploads],
            "lanes": [lanes.cpu() for _, _, lanes in uploads],
            "operands": ([p.cpu() for p, _, _ in uploads] if rank == 0
                         else None),
            "checks": checks, "bwd_checks": bwd_checks}


def sharded_phase(card: str, dev, fed: dict, rows: list) -> dict:
    """Phase 17: the sharded client round, a client per rank, 10 ranks
    on this one card over gloo, at phase 7's settings and inputs.
    Folds kernel 5's checks on the ranks' operands into its row of
    ``rows``; returns kernel 9's row of the kernels line."""
    import numpy as np
    import torch

    from repro_torch.comm.bitpack import packed_len
    from repro_torch.comm.protocol import resolve_transport
    from repro_torch.comm.shardmap import run_ranks
    from repro_torch.configs.mnistfc import MNISTFC
    from repro_torch.core.federated import _encode_scores
    from repro_torch.core.sampling import as_word, fold_word
    from repro_torch.kernels import ops
    from repro_torch.kernels import qz_reconstruct as qr

    t0 = time.perf_counter()
    zspecs, cfg, words = fed["zspecs"], fed["cfg"], fed["round_words"]
    specs = zspecs.specs
    # the stacked round runs each layer as one bmm over the K clients, a
    # rank as one mm: equal where the products are batch-invariant
    rng = np.random.RandomState(SEED + 17)
    for a, b in zip(MNISTFC[:-1], MNISTFC[1:]):
        x = torch.from_numpy(rng.randn(FED_K, FED_BATCH, a).astype(
            np.float32)).to(dev)
        w = torch.from_numpy(rng.randn(FED_K, a, b).astype(np.float32)).to(dev)
        y = torch.bmm(x, w)
        ym = torch.stack([x[k] @ w[k] for k in range(FED_K)])
        say(f"sharded: bmm against per-client mm at ({FED_K}, {FED_BATCH}, "
            f"{a}) x ({a}, {b}): {int((y != ym).sum())} of {y.numel()} "
            f"outputs differ, max {(y - ym).abs().max().item():.3e} ({card})")
    torch.cuda.empty_cache()

    # NCCL takes one rank per device; the 10 ranks share this card, so
    # the group is gloo's, on CUDA tensors (the kernels run on the card)
    t1 = time.perf_counter()
    res = run_ranks(sharded_rank, FED_K, ({
        "round_words": words, "state0": fed["host_state0"]},),
        backend="gloo", timeout=RANK_TIMEOUT)
    run_s = time.perf_counter() - t1
    fit_s = [r["fit_s"] for r in res]
    # a round ends when its last rank does
    round_s = [max(r["round_s"][i] for r in res) for i in range(FED_ROUNDS)]
    med = float(np.median(round_s[1:]))
    say(f"sharded: {FED_K} ranks (processes) on one card over gloo: "
        f"{run_s:.1f} s from start to the last result; sharded_client_fit "
        f"of {FED_ROUNDS} rounds {max(fit_s):.3f} s (ranks "
        f"{min(fit_s):.3f}-{max(fit_s):.3f}); round times "
        f"{[round(t, 4) for t in round_s]} s; median round (rounds "
        f"1-{FED_ROUNDS - 1}) {med:.4f} s, {1e3 * med / FED_E:.3f} ms a "
        f"local step (phase 7's stacked round: K={FED_K} in one process) "
        f"({card})")

    # each rank trained client k at the stacked round's words
    want_w = [fold_word(fold_word(as_word(words[0]), 0, k), FED_E)
              for k in range(FED_K)]
    got_w = [r["upload_words"] for r in res]
    say(f"sharded: round 0 upload words of ranks 0-2 {got_w[:3]}; equal to "
        f"the stacked round's clients' = "
        f"{all(g == [w] * len(specs) for g, w in zip(got_w, want_w))}")
    if [r["rank"] for r in res] != list(range(FED_K)) or not all(
            g == [w] * len(specs) for g, w in zip(got_w, want_w)):
        die("a rank's draw words are not the stacked round's client's")
    # kernel 9 on each rank's own upload operands
    max_err = 0.0
    for r in res:
        for path, plain, k10, run, err in r["checks"]:
            max_err = max(max_err, err)
            if not (plain and k10 and run):
                die(f"kernel 9 differs on rank {r['rank']} {path}: plain "
                    f"{plain}, kernel 10's row {k10}, the round's {run}")
    say(f"train-kernel-vs-plain: qz_sample_pack_fwd on every rank's round-0 "
        f"operands at {list(specs)}: bitwise its plain version, kernel 10's "
        f"row and the round's lanes on all {FED_K} ranks")
    # kernel 5 on each rank's first local backward of round 0
    bwd_err = 0.0
    for r in res:
        for path, plain, k6, run, err in r["bwd_checks"]:
            bwd_err = max(bwd_err, err)
            if not (plain and k6 and run):
                die(f"kernel 5 differs on rank {r['rank']} {path}: plain "
                    f"{plain}, kernel 6's row {k6}, the round's {run}")
    for row in rows:
        if row["name"] == "qz_reconstruct_bwd_plan":
            row["max_abs_err"] = max(row["max_abs_err"], bwd_err)
    say(f"train-kernel-vs-plain: qz_reconstruct_bwd_plan on every rank's "
        f"round-0 cotangents at {list(specs)}: bitwise its plain version, "
        f"kernel 6's row and the round's g_z on all {FED_K} ranks "
        f"(max_abs_err={bwd_err:.3e})")
    # launches of one rank's fit: 3E forward and backward, 3 uploads a round
    want = {name: 0 for name in res[0]["launches"]}
    want.update({"qz_sample_reconstruct_fwd": 3 * FED_E * FED_ROUNDS,
                 "qz_reconstruct_bwd_plan": 3 * FED_E * FED_ROUNDS,
                 "qz_sample_pack_fwd": 3 * FED_ROUNDS})
    for r in res:
        say(f"sharded: rank {r['rank']} launches {r['launches']}")
        if r["launches"] != want:
            die(f"rank {r['rank']}'s launches differ from {want}")
    # the replicated state
    same = all(np.array_equal(r[k][part][p], res[0][k][part][p])
               for r in res for k in ("state", "state_r0")
               for part in ("scores", "dense") for p in res[0][k][part])
    same_loss = all(np.array_equal(r["losses"], res[0]["losses"])
                    for r in res)
    say(f"sharded: every rank's state after round 0 and round "
        f"{FED_ROUNDS - 1} identical = {same}, losses identical = "
        f"{same_loss}; metrics count K = {res[0]['cohort_size']:.0f}, "
        f"uplink {res[0]['uplink_bytes_per_client']:.0f} B/client")
    if not (same and same_loss and res[0]["cohort_size"] == FED_K):
        die("the ranks' replicated state or metrics differ")
    # the collective aggregate against the stacked one of the same uploads
    transport = resolve_transport(cfg.aggregate, cfg.mode)
    agg = {}
    for i, (path, spec) in enumerate(specs.items()):
        lanes = torch.stack([r["lanes"][i] for r in res]).to(dev)
        if lanes.shape != (FED_K, packed_len(spec.n)):
            die(f"rank lanes of {path} have shape {tuple(lanes.shape)}")
        agg[path] = transport.aggregate_stacked_packed(lanes, spec.n)
    stacked = _encode_scores(zspecs, cfg, agg, words[0], 0)
    ok_agg = all(np.array_equal(stacked[p].cpu().numpy(),
                                res[0]["state_r0"]["scores"][p])
                 for p in specs)
    say(f"sharded: round 0's collective u8 words equal the stacked "
        f"aggregate's of the same {FED_K} uploads = {ok_agg}")
    if not ok_agg:
        die("the collective aggregate differs from the stacked one")
    # against phase 7's stacked round 0 and fit
    flips = sum(int((res[0]["state_r0"]["scores"][p]
                     != fed["host_state_r0"]["scores"][p]).sum())
                for p in specs)
    dense_d = max(float(np.abs(res[0]["state_r0"]["dense"][p]
                               - fed["host_state_r0"]["dense"][p]).max())
                  for p in zspecs.dense_paths)
    losses, ref = [float(v) for v in res[0]["losses"]], fed["losses"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
    say(f"sharded: round 0 against phase 7's stacked round 0: {flips} of "
        f"{zspecs.n_total} u8 words differ (limit "
        f"{FED_FLIP_SHARE * zspecs.n_total:.0f}), dense leaves within "
        f"{dense_d:.3e}")
    say(f"sharded: losses {losses}; phase 7's {ref}; largest relative "
        f"difference {rel:.3e} (limit {SHARDED_LOSS_RTOL})")
    if flips > FED_FLIP_SHARE * zspecs.n_total:
        die("too many round-0 u8 words differ from the stacked round's")
    if not losses[-1] < losses[0]:
        die(f"the sharded round's loss did not fall: {losses}")
    if not rel <= SHARDED_LOSS_RTOL:
        die("the sharded round's losses part from phase 7's")

    # kernel 9's times on rank 0's round-0 operands
    kt = KernelTimes(card, {"qz_sample_pack_fwd": "sample_pack_kernel"})
    for i, (path, spec) in enumerate(specs.items()):
        p = res[0]["operands"][i].to(dev)
        w = res[0]["upload_words"][i]
        kt.add("qz_sample_pack_fwd", path,
               lambda: qr.qz_sample_pack_fwd(spec, p, w),
               event_ms(lambda: ops.sample_pack_one_plain(spec, p, w), 3),
               None, spec.n * (OPS_DRAW + OPS_PACK),
               4 * spec.n + 4 * packed_len(spec.n) + 4)
    row = kt.row("qz_sample_pack_fwd", "src/repro/kernels/qz_reconstruct.py:592",
                 sum(r["launches"]["qz_sample_pack_fwd"] for r in res),
                 max_err, 1, "one rank's round: 1 launch per zampled leaf",
                 None)
    row["ranks"] = FED_K
    row["sharded_round_s"] = med  # median of rounds 1 to R-1
    say(f"phase 17 done in {time.perf_counter() - t0:.1f} s")
    return row


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        die("torch sees no CUDA device")
    if not (ROOT / "src" / "repro_torch" / "csrc" / "qz_decode.cu").exists():
        die("src/repro_torch is not beside chip_smoke.py")
    # phase 14 compares under torch.use_deterministic_algorithms, which
    # needs this cuBLAS workspace setting from the first cuBLAS call on
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    os.environ.pop("REPRO_BWD_PLAN", None)  # the phases set the gate
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.configs import get_arch
    from repro_torch.core.zampling import ZamplingConfig, build_specs
    from repro_torch.kernels import nvcc, ops, qz_decode, qz_reconstruct
    from repro_torch.models.model import build_model, param_template
    from repro_torch.serve import (ServeConfig, ServeScheduler,
                                   make_serve_state, serve_generate)
    from repro_torch.comm.downlink import get_codec

    dev = torch.device("cuda")

    # --- 1. device ------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        die(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    kind = torch.cuda.get_device_name(0)
    say(f"device: {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.device_count()} visible")

    # --- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    libs = (qz_decode.LIBRARY, qz_reconstruct.LIBRARY)
    nvcc.build_all(libs)
    say(f"build: {', '.join(lib.source for lib in libs)} in "
        f"{time.perf_counter() - t0:.1f} s (one nvcc each, in parallel), "
        f"nvcc {' '.join(nvcc.NVCC_FLAGS)}")
    for lib in libs:
        for line in lib.log.splitlines():
            if any(w in line for w in ("registers", "spill",
                                       "Compiling entry")):
                say(f"build: {lib.source}: ptxas: {line.strip()}")

    # --- the full-width serving state -------------------------------------
    cfg = get_arch("qwen2-0.5b")
    model = build_model(cfg)
    zspecs = build_specs(param_template(cfg),
                         ZamplingConfig(**SERVE_ZAMPLING))
    rng = np.random.RandomState(SEED)
    scores = {p: rng.rand(s.n).astype(np.float32)
              for p, s in zspecs.specs.items()}
    dense = {}
    for p in zspecs.dense_paths:
        shape = zspecs.template[p].shape
        dense[p] = (np.ones(shape, np.float32) if "ln" in p or "norm" in p
                    else (0.02 * rng.randn(*shape)).astype(np.float32))
    t0 = time.perf_counter()
    sstate = make_serve_state(zspecs, {"scores": scores, "dense": dense},
                              DRAW_WORD, downlink="u8", dither_word=0,
                              device=dev)
    torch.cuda.synchronize()
    say(f"state: {len(zspecs.specs)} zampled leaves, m={zspecs.m_total} "
        f"weights, n={zspecs.n_total} u8 words "
        f"({sstate.resident_zampled_bytes()} B resident), encoded on the "
        f"card in {time.perf_counter() - t0:.2f} s; dense "
        f"{list(zspecs.dense_paths)}")
    L = cfg.n_layers

    def operand(path, codec):
        spec = zspecs.specs[path]
        if codec == "u8":
            return ops.serve_operand(sstate.words[path], 8), 8
        s = torch.from_numpy(scores[path]).to(dev)
        c = get_codec(codec)
        if c.quantized:
            return ops.serve_operand(c.encode(spec, s, 0), c.bits), c.bits
        return ops.serve_operand(s, None), None

    def run_kernel(spec, p, X, row_offset, d_in, d_out, qbits):
        if X.shape[0] == 1:
            return qz_decode.qz_sample_matvec(
                spec, p, DRAW_WORD, X[0], row_offset=row_offset, d_in=d_in,
                d_out=d_out, qbits=qbits)[None]
        return qz_decode.qz_sample_matmul(
            spec, p, DRAW_WORD, X, row_offset=row_offset, d_in=d_in,
            d_out=d_out, qbits=qbits)

    # --- 3. kernel against its plain version ------------------------------
    max_err = {"qz_sample_matmul": 0.0, "qz_sample_matvec": 0.0}
    fallback = []

    def edge_check(path, codec, group):
        """Device functions against plain torch at the group's first rows:
        Q indices and mask bits exact, values and weights compared."""
        spec = zspecs.specs[path]
        _, d_in, d_out = ops.serve_group_dims(spec)
        p, qbits = operand(path, codec)
        rows = group * d_in * d_out + torch.arange(65536, device=dev)
        idx, bits, vals, w = qz_decode.qz_edges(spec, p, DRAW_WORD, rows,
                                                qbits)
        from repro_torch.core.qspec import row_indices, row_values
        idx_ok = torch.equal(idx.to(torch.int64), row_indices(spec, rows))
        bit_ok = torch.equal(bits.to(torch.float32), ops.serve_edge_bits(
            spec, p, DRAW_WORD, rows, qbits))
        pv = row_values(spec, rows)
        pw = ops.serve_edge_weights(spec, p, DRAW_WORD, rows, qbits)
        say(f"edges: {path} g={group} {codec}: indices exact={idx_ok}, "
            f"mask bits exact={bit_ok}, values differing "
            f"{(vals != pv).float().mean().item():.3e} (max "
            f"{(vals - pv).abs().max().item():.3e}), weights differing "
            f"{(w != pw).float().mean().item():.3e}")
        if not (idx_ok and bit_ok):
            die(f"Q indices or mask bits differ from plain torch ({path})")

    def compare(path, group, codec, B):
        spec = zspecs.specs[path]
        _, d_in, d_out = ops.serve_group_dims(spec)
        p, qbits = operand(path, codec)
        X = torch.from_numpy(rng.randn(B, d_in).astype(np.float32)).to(dev)
        off = group * d_in * d_out
        yk = run_kernel(spec, p, X, off, d_in, d_out, qbits)
        yp = ops.serve_contract_plain(spec, p, DRAW_WORD, X, off, d_in,
                                      d_out, qbits)
        torch.cuda.synchronize()
        name = "qz_sample_matvec" if B == 1 else "qz_sample_matmul"
        err = (yk - yp).abs().max().item()
        max_err[name] = max(max_err[name], err)
        exact = bool((yk == yp).all())
        say(f"kernel-vs-plain: {path} {d_in}x{d_out} g={group} {codec} "
            f"B={B}: bitwise={exact} max_abs_err={err:.3e}")
        if not exact:
            # CUDA's logf/cosf against torch's: values by tolerance only
            fallback.append(path)
            edge_check(path, codec, group)
            if not torch.allclose(yk, yp, rtol=1e-5, atol=1e-5):
                die(f"kernel disagrees with plain torch beyond rtol=atol="
                    f"1e-5 ({path} g={group} {codec} B={B})")
        return X, yk

    t0 = time.perf_counter()
    for path in LINEARS:
        for group in (0, L - 1):
            for B in (1, 4):
                compare(path, group, "u8", B)
    for codec in ("f32", "u16"):
        for B in (1, 4):
            compare("blocks/attn/wq", 0, codec, B)
    edge_check("blocks/attn/wq", "u8", 0)
    gauss = qz_decode.gauss_check(dev)
    say(f"box-muller: the kernels' logf, sqrtf, cosf and Box-Muller against "
        f"the library's at all 2^24 uniforms: {gauss} arguments differ")
    if any(gauss):
        die("the kernels' Box-Muller differs from the library's")
    spec = zspecs.specs["lm_head"]
    _, d_in, d_out = ops.serve_group_dims(spec)
    compare("lm_head", 0, "u8", 1)
    X, yk = compare("lm_head", 0, "u8", 4)
    p, _ = operand("lm_head", "u8")
    y64 = torch.zeros((4, d_out), dtype=torch.float64, device=dev)
    cols = torch.arange(d_out, device=dev)
    for i0 in range(0, d_in, 16):
        ii = torch.arange(i0, min(d_in, i0 + 16), device=dev)
        W = ops.serve_edge_weights(spec, p, DRAW_WORD,
                                   ii[:, None] * d_out + cols, 8)
        y64 += X[:, i0:i0 + 16].double() @ W.double()
    rel = (torch.linalg.norm(yk.double() - y64)
           / torch.linalg.norm(y64)).item()
    say(f"kernel-vs-float64: lm_head {d_in}x{d_out} B=4: relative L2 error "
        f"{rel:.3e} (limit 1e-5)")
    if not rel <= 1e-5:
        die("lm_head kernel output is far from the float64 product")
    say(f"phase 3 done in {time.perf_counter() - t0:.1f} s"
        + (f"; tolerance fallback at {sorted(set(fallback))}" if fallback
           else "; every comparison bitwise"))

    # --- 4. serving through the kernel --------------------------------------
    scfg = ServeConfig(lanes=LANES, seq_len=max(map(len, PROMPTS)) + NEW_TOKENS,
                       mode="streaming", max_new_tokens=NEW_TOKENS)
    sched = ServeScheduler(model, sstate, scfg, device=dev)
    eng = sched.engine
    # warm-up outside the counted run: the first torch matmul creates the
    # cuBLAS handle
    for lanes in (1, LANES):
        eng.step(eng.arrays_of(sstate), eng.init_lane_cache(lanes, 4),
                 torch.zeros((lanes, 1), dtype=torch.int64, device=dev))
    torch.cuda.synchronize()
    rids = [sched.submit(p) for p in PROMPTS]
    qz_decode.reset_launches()
    qz_reconstruct.reset_launches()
    step_ms = []
    while sched.pending:
        t0 = time.perf_counter()
        sched.step_once()  # ends in the host sync of the step's logits
        step_ms.append(1e3 * (time.perf_counter() - t0))
    results = sched.results
    t_sched = sum(step_ms) / 1e3
    t0 = time.perf_counter()
    single = serve_generate(model, sstate, torch.tensor([PROMPTS[0]]),
                            NEW_TOKENS, seq_len=scfg.seq_len, device=dev)
    torch.cuda.synchronize()
    t_single = time.perf_counter() - t0
    launches = dict(qz_decode.LAUNCHES)
    if any(qz_reconstruct.LAUNCHES.values()):
        die(f"serving launched training kernels: {qz_reconstruct.LAUNCHES}")
    single_steps = len(PROMPTS[0]) + NEW_TOKENS - 1
    per_step = 7 * L + 1
    for rid, prompt in zip(rids, PROMPTS):
        say(f"serve: {prompt} -> {results[rid].tolist()}")
    one = single[0, len(PROMPTS[0]):].tolist()
    say(f"serve: single request (B=1) {PROMPTS[0]} -> {one}")
    if one != results[rids[0]].tolist():
        die("the single request's tokens differ from its scheduler lane's")
    got = [results[rid].tolist() for rid in rids]
    say(f"serve: tokens equal SERVE_TOKENS: {got == SERVE_TOKENS}")
    if got != SERVE_TOKENS:
        die("the scheduler's tokens differ from SERVE_TOKENS")
    for rid in rids:
        toks = results[rid]
        if len(toks) != NEW_TOKENS or toks.min() < 0 or toks.max() >= cfg.padded_vocab:
            die(f"request {rid} gave malformed tokens {toks.tolist()}")
    say(f"serve: launches {launches}; scheduler {sched.steps} steps x "
        f"{per_step} = {per_step * sched.steps}, single {single_steps} steps "
        f"x {per_step} = {per_step * single_steps}")
    if (launches["qz_sample_matmul"] != per_step * sched.steps
            or launches["qz_sample_matvec"] != per_step * single_steps):
        die("launch counts do not match 169 per engine step")
    n_tok = sum(len(v) for v in results.values())
    say(f"serve: scheduler {sched.steps} steps in {t_sched:.3f} s "
        f"(median {float(np.median(step_ms)):.2f} ms/step, min "
        f"{min(step_ms):.2f}, max {max(step_ms):.2f}; {n_tok / t_sched:.2f} "
        f"tok/s for {n_tok} tokens); single request {single_steps} steps in "
        f"{t_single:.3f} s ({1e3 * t_single / single_steps:.2f} ms/step) on "
        f"{card}")
    logits, _ = eng.step(eng.arrays_of(sstate), eng.init_cache(1, 4),
                         torch.tensor([[PROMPTS[0][0]]], device=dev))
    if logits.shape != (1, 1, cfg.padded_vocab) or not bool(
            torch.isfinite(logits).all()):
        die(f"logits malformed: shape {tuple(logits.shape)}")

    # --- 5. kernel times at the main path's shapes ----------------------------
    stats = {}
    for path in LINEARS + ("lm_head",):
        spec = zspecs.specs[path]
        groups, d_in, d_out = ops.serve_group_dims(spec)
        p, qbits = operand(path, "u8")
        sub = d_in * d_out
        drawn = torch.zeros(groups, dtype=torch.float64, device=dev)
        step_rows = max(1, (1 << 22) // (d_out * spec.d)) * d_out
        for r0 in range(0, spec.m, step_rows):
            rows = torch.arange(r0, min(spec.m, r0 + step_rows), device=dev)
            b = ops.serve_edge_bits(spec, p, DRAW_WORD, rows, qbits).sum(-1)
            drawn.index_add_(0, rows // sub, b.double())
        w0, nblk, bpw = ops.serve_block_grid(spec, 256, 0, sub)
        word_bytes = (nblk // bpw) * spec.window  # u8 windows a group reads
        stats[path] = (groups, d_in, d_out, drawn.cpu().numpy(), word_bytes)

    def bound_ms(path, B):
        groups, d_in, d_out, drawn, word_bytes = stats[path]
        w = d_in * d_out
        total = 0.0
        for g in range(groups):
            ops_n = (w * (OPS_PER_WEIGHT + 8 * OPS_PER_EDGE + 2 * B)
                     + drawn[g] * OPS_PER_DRAWN)
            bytes_n = word_bytes + 4 * B * (d_in + d_out)
            total += max(ops_n / PEAK_OPS_PER_S, bytes_n / PEAK_BYTES_PER_S)
        return 1e3 * total

    # the library yardstick of the same function without the in-kernel
    # draw: torch.sparse.mm of the CSR Q against the drawn mask (all of a
    # leaf's groups at once), then torch.matmul of X against that W
    from repro_torch.core.sampling import sample_mask_qhash

    t0 = time.perf_counter()
    Xs = {(B, path): torch.from_numpy(rng.randn(
              B, stats[path][1]).astype(np.float32)).to(dev)
          for B in (LANES, 1) for path in LINEARS + ("lm_head",)}
    lib = {}
    for path in LINEARS + ("lm_head",):
        spec = zspecs.specs[path]
        groups, d_in, d_out = stats[path][:3]
        Q = q_csr(spec, dev, False)
        z = sample_mask_qhash(sstate.words[path], 8, spec.seed,
                              spec.tensor_id, DRAW_WORD)[:, None].contiguous()
        for B in (LANES, 1):
            X = Xs[(B, path)]

            def library():
                return X @ torch.sparse.mm(Q, z).reshape(groups, d_in, d_out)

            lib[(B, path)] = event_ms(library, 3)
            if B == LANES:
                p, qbits = operand(path, "u8")
                yk = torch.stack([run_kernel(spec, p, X, g * d_in * d_out,
                                             d_in, d_out, qbits)
                                  for g in range(groups)])
                yl = library()
                say(f"library: {path}: sparse.mm + matmul against the kernel "
                    f"at B={B}: max abs diff {(yk - yl).abs().max().item():.3e} "
                    f"(of max {yk.abs().max().item():.3e})")
                del yk, yl
        del Q, z
        torch.cuda.empty_cache()
    say(f"library: CSR yardsticks built and timed in "
        f"{time.perf_counter() - t0:.1f} s")

    rows = []
    for name, B in (("qz_sample_matmul", LANES), ("qz_sample_matvec", 1)):
        ms = device = plain = yard = bound = library_ms = 0.0
        shapes = {}
        for path in LINEARS + ("lm_head",):
            spec = zspecs.specs[path]
            groups, d_in, d_out = stats[path][:3]
            p, qbits = operand(path, "u8")
            X = Xs[(B, path)]
            reps = 3 if path == "lm_head" else 10
            t_k = event_ms(lambda: run_kernel(spec, p, X, 0, d_in, d_out, qbits),
                           reps)
            by_tag, _ = profile_device_us(
                lambda: [run_kernel(spec, p, X, 0, d_in, d_out, qbits)
                         for _ in range(reps)], ("serve_matmul_kernel",))
            us, n_l = by_tag["serve_matmul_kernel"]
            t_d = 1e-3 * us / n_l if n_l else None  # no device trace: None
            plan = qz_decode.serve_plan(d_in, d_out, B, spec.d,
                                        spec.rows_per_window, ops.SERVE_BM)
            ctas = qz_decode.launch_grid(spec, d_in, d_out, B, qbits)
            t_p = event_ms(lambda: ops.serve_contract_plain(
                spec, p, DRAW_WORD, X, 0, d_in, d_out, qbits), 1)
            cols = torch.arange(d_out, device=dev)
            W = torch.cat([ops.serve_edge_weights(
                spec, p, DRAW_WORD, torch.arange(i0, min(d_in, i0 + 16),
                                                 device=dev)[:, None] * d_out
                + cols, qbits) for i0 in range(0, d_in, 16)])
            t_y = event_ms(lambda: X @ W, 10)
            del W
            b = bound_ms(path, B)
            ms += groups * t_k
            device = (device + groups * t_d if t_d is not None
                      and device is not None else None)
            plain += groups * t_p
            yard += groups * t_y
            bound += b
            library_ms += lib[(B, path)]
            shapes[path] = {"d_in": d_in, "d_out": d_out, "launches": groups,
                            "ms": t_k, "device_ms": t_d, "plain_ms": t_p,
                            "bound_ms": b / groups,
                            "library_ms_all_groups": lib[(B, path)],
                            "ctas": ctas,
                            "tiles": plan.tiles, "tile_columns": plan.co,
                            "smem": plan.smem}
            say(f"time: {name} {path} {d_in}x{d_out} B={B}: kernel "
                f"{t_k:.4f} ms (device "
                f"{'not measured' if t_d is None else f'{t_d:.4f} ms'}; "
                f"{ctas} CTAs, {plan.tiles} tiles "
                f"of {plan.co} columns, {plan.smem} B of shared memory a "
                f"CTA), plain {t_p:.2f} ms, matmul of materialized "
                f"weights {t_y:.4f} ms, sparse.mm + matmul of all {groups} "
                f"groups {lib[(B, path)]:.4f} ms, bound {b / groups:.4f} ms "
                f"({card})")
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/qz_decode.cu",
            "replaces": ("src/repro/kernels/qz_decode.py:239"
                         if name == "qz_sample_matmul"
                         else "src/repro/kernels/qz_decode.py:207"),
            "launches": launches[name], "max_abs_err": max_err[name],
            "ms": ms, "device_ms": device, "plain_ms": plain,
            "bound_ms": bound, "bound_by": "operations",
            "library_ms": library_ms,
            "library_call": "torch.sparse.mm(Q_csr, z) on the drawn mask, "
                            "then X @ W",
            "batch": B, "per": "one engine step (169 launches)",
            "yardstick_matmul_materialized_ms": yard, "shapes": shapes,
        })
        say(f"time: {name} per engine step (B={B}): kernel {ms:.3f} ms "
            f"(device {'not measured' if device is None else f'{device:.3f} ms'}), "
            f"bound {bound:.3f} ms ({bound / ms:.3f} of it), plain "
            f"{plain:.1f} ms, matmul of materialized weights {yard:.3f} ms, "
            f"sparse.mm + matmul {library_ms:.3f} ms ({card})")

    med = float(np.median(step_ms))
    single_ms = 1e3 * t_single / single_steps
    say(f"share: serve kernel time per step / step wall time: scheduler "
        f"{rows[0]['ms']:.3f} / {med:.3f} ms = {rows[0]['ms'] / med:.3f}, "
        f"single request {rows[1]['ms']:.3f} / {single_ms:.3f} ms = "
        f"{rows[1]['ms'] / single_ms:.3f} ({card})")
    del sstate, sched, eng, model
    torch.cuda.empty_cache()

    train_rows, fed = training_phases(card, dev)
    rows += train_rows
    rows += local_phases(card, dev, fed, rows)
    del fed["state_r0"], fed["state0"]
    torch.cuda.empty_cache()
    rows += lm_phases(card, dev, fed, rows)
    torch.cuda.empty_cache()
    rows.append(sharded_phase(card, dev, fed, rows))
    say(f"card: {card}")
    say(f"total: {time.perf_counter() - T_START:.1f} s for the whole run")
    say(json.dumps({"kernels": rows}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
