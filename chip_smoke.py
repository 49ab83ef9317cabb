#!/usr/bin/env python3
"""Smoke run of the PyTorch port (src/repro_torch) on one NVIDIA GPU.

Serves qwen2-0.5b at full width (24 layers, d_model 896, 14 heads with 2
KV heads, d_ff 4864, padded vocab 152064) off u8 downlink words through
the streaming engine, every zampled linear on the hand-written CUDA
serve kernel, and checks it in phases, one printed line or more each:

1. device: the card's name and power limit (nvidia-smi);
2. build: nvcc builds the kernel from the sources in the checkout, with
   what ``-Xptxas -v`` reports;
3. kernel against its plain torch version on the card, bitwise, at every
   linear shape of the model (groups 0 and 23, B in {1, 4}, u8 words, and
   f32 and u16 at one shape), and the lm_head also against a float64
   product of the plainly regenerated weights;
4. serving: ServeScheduler with 4 lanes answers 4 ragged prompts for 8
   new tokens each, and the first request rerun alone (B=1) must give
   the same tokens; each engine step must launch the kernel 169 times;
5. kernels: one JSON line with each kernel's launches, times and bound;
6. last line: {"ok": true, "device": {...}}.

Usage, from the repo root on a machine with a CUDA GPU:
    python3 chip_smoke.py
It needs one card and exits non-zero, printing no result, when torch
sees no CUDA device or the port's sources are not beside it.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
DRAW_WORD = 2
PROMPTS = [[5, 17, 42, 7], [1, 2, 3], [9, 9, 1, 0, 3], [4, 4]]
NEW_TOKENS = 8
LANES = 4
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
LINEARS = ("blocks/attn/wq", "blocks/attn/wk", "blocks/attn/wv",
           "blocks/attn/wo", "blocks/mlp/gate", "blocks/mlp/up",
           "blocks/mlp/down")


def die(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def event_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` on the card, by CUDA events."""
    import torch

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


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        die("torch sees no CUDA device")
    if not (ROOT / "src" / "repro_torch" / "csrc" / "qz_decode.cu").exists():
        die("src/repro_torch is not beside chip_smoke.py")
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.configs import get_arch
    from repro_torch.core.zampling import ZamplingConfig, build_specs
    from repro_torch.kernels import ops, qz_decode
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
    qz_decode.build()
    say(f"build: qz_decode.cu in {time.perf_counter() - t0:.1f} s, nvcc "
        f"{' '.join(qz_decode.NVCC_FLAGS)}")
    for line in qz_decode.BUILD_LOG.splitlines():
        if any(w in line for w in ("registers", "spill", "Compiling entry")):
            say(f"build: ptxas: {line.strip()}")

    # --- the full-width serving state -------------------------------------
    cfg = get_arch("qwen2-0.5b")
    model = build_model(cfg)
    zspecs = build_specs(param_template(cfg),
                         ZamplingConfig(compression=8, d=8, min_size=65536))
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
    for path in ("blocks/attn/wq", "blocks/attn/wk", "blocks/mlp/gate",
                 "blocks/mlp/down"):
        for group in (0, L - 1):
            for B in (1, 4):
                compare(path, group, "u8", B)
    for codec in ("f32", "u16"):
        for B in (1, 4):
            compare("blocks/attn/wq", 0, codec, B)
    edge_check("blocks/attn/wq", "u8", 0)
    spec = zspecs.specs["lm_head"]
    _, d_in, d_out = ops.serve_group_dims(spec)
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
    single_steps = len(PROMPTS[0]) + NEW_TOKENS - 1
    per_step = 7 * L + 1
    for rid, prompt in zip(rids, PROMPTS):
        say(f"serve: {prompt} -> {results[rid].tolist()}")
    one = single[0, len(PROMPTS[0]):].tolist()
    say(f"serve: single request (B=1) {PROMPTS[0]} -> {one}")
    if one != results[rids[0]].tolist():
        die("the single request's tokens differ from its scheduler lane's")
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

    rows = []
    for name, B in (("qz_sample_matmul", LANES), ("qz_sample_matvec", 1)):
        ms = plain = yard = bound = 0.0
        shapes = {}
        for path in LINEARS + ("lm_head",):
            spec = zspecs.specs[path]
            groups, d_in, d_out = stats[path][:3]
            p, qbits = operand(path, "u8")
            X = torch.from_numpy(rng.randn(B, d_in).astype(np.float32)).to(dev)
            t_k = event_ms(lambda: run_kernel(spec, p, X, 0, d_in, d_out, qbits),
                           3 if path == "lm_head" else 10)
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
            plain += groups * t_p
            yard += groups * t_y
            bound += b
            shapes[path] = {"d_in": d_in, "d_out": d_out, "launches": groups,
                            "ms": t_k, "plain_ms": t_p,
                            "bound_ms": b / groups}
            say(f"time: {name} {path} {d_in}x{d_out} B={B}: kernel "
                f"{t_k:.4f} ms, plain {t_p:.2f} ms, matmul of materialized "
                f"weights {t_y:.4f} ms, bound {b / groups:.4f} ms ({card})")
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/qz_decode.cu",
            "replaces": ("src/repro/kernels/qz_decode.py:239"
                         if name == "qz_sample_matmul"
                         else "src/repro/kernels/qz_decode.py:207"),
            "launches": launches[name], "max_abs_err": max_err[name],
            "ms": ms, "plain_ms": plain, "bound_ms": bound,
            "bound_by": "operations", "library_ms": None,
            "batch": B, "per": "one engine step (169 launches)",
            "yardstick_matmul_materialized_ms": yard, "shapes": shapes,
        })
        say(f"time: {name} per engine step (B={B}): kernel {ms:.3f} ms, "
            f"bound {bound:.3f} ms ({bound / ms:.3f} of it), plain "
            f"{plain:.1f} ms, matmul of materialized weights {yard:.3f} ms "
            f"({card})")

    med = float(np.median(step_ms))
    single_ms = 1e3 * t_single / single_steps
    say(f"share: serve kernel time per step / step wall time: scheduler "
        f"{rows[0]['ms']:.3f} / {med:.3f} ms = {rows[0]['ms'] / med:.3f}, "
        f"single request {rows[1]['ms']:.3f} / {single_ms:.3f} ms = "
        f"{rows[1]['ms'] / single_ms:.3f} ({card})")
    say(f"card: {card}")
    say(json.dumps({"kernels": rows}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
