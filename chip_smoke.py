#!/usr/bin/env python3
"""Chip smoke of the PyTorch + CUDA port: builds the kernels, drives the
paper's main path and the LM serving path on one NVIDIA GPU, holds every
kernel against its plain PyTorch version, and prints the kernels' numbers.

Run from the root of a checkout, with no arguments: ``python3 chip_smoke.py``.
Phases (each raises on failure; nothing is caught):

1. build the three kernel sources (``sched_scoring.cu``, ``flash_attention.cu``,
   ``decode_attention.cu``) for sm_90a, one nvcc each, all at once; card name
   and power limit;
2. kernel against its plain version on the card, over the scoring regimes
   and edge shapes (identical feasibility mask and argmax, max abs error 0);
3. main path at full width: ``schedule`` on ``paper_cluster((20, 70, 90))``
   (the reference golden), ``refine`` on the card (equal to the CPU path
   and to the reference's result), ``simulate`` / ``simulate_batch``;
4. resource path: the same cluster with memory and 6 racks, ``refine``
   (3 rounds) on the card equal to the CPU path and the reference's result;
5. ``optimal_schedule`` on ``paper_cluster((1, 1, 1))``: the reference golden;
6. timings with CUDA events (cold L2, median) at B=16384, T=478, m=180;
7. the attention kernels (B3 flash, B4 decode) against their plain versions
   on the card: GQA (G 2 and 8), MQA, window, bidirectional, ragged S (192,
   300, 600), per-row lengths down to 1, float32 and bfloat16;
8. LM serving at full width: ``qwen1.5-0.5b`` (24 layers, bf16, random
   weights from a seed) serves 8 requests of 512 prompt tokens and 64
   generated tokens through ``init_params -> init_caches -> prefill ->
   decode_step``; 24 B3 launches per prefill, 24 B4 launches per decode
   step; then 2 requests x 128 prompt tokens x 8 steps on the card against
   the same weights in float32 on the CPU, fed the card's tokens;
9. B3 and B4 timed at the serving shapes beside their plain versions and
   ``scaled_dot_product_attention``.

The last lines are the ``{"kernels": [...]}`` record, the card's
``nvidia-smi`` name and power limit, and ``{"ok": true, "device": ...}``.
Without a CUDA device, or away from the repository, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet).
HBM_BYTES_PER_S = 3.35e12
FP64_FLOPS_PER_S = 34e12  # vector FP64, outside the tensor cores
BF16_FLOPS_PER_S = 989e12  # dense bf16 on the tensor cores

# The reference's results (``repro.core``, NumPy scoring) for phases 3-5.
MAIN_GOLDEN = dict(rate=297.0, n_instances=[2, 56, 210, 210], iterations=46,
                   md5="1dfed7471c737dcb63fc259cb03ffe02")
MAIN_REFINE_REF = ([], 1189.9999999999998)
RESOURCE_REFINE_REF = (["grow c0x4", "swap c0#0<->c2#0", "swap c0#1<->c1#0"], 1154.5354084899689)
OPTIMAL_REF = dict(evaluated=26136, pruned=35, n_instances=[1, 2, 1, 3],
                   throughput=23.268698060941833)


def check(cond, message: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {message}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def resource_cluster(P, np):
    """20/70/90 with per-type memory demand, 8 units of memory a machine and
    six racks of 30 machines (same rack 1, across racks 2)."""
    base = P.paper_cluster((20, 70, 90))
    profile = base.profile.with_mem(np.array([0.5, 1.0, 1.5, 2.0]))
    return P.Cluster(
        machine_types=base.machine_types, capacity=base.capacity, profile=profile,
        mem_capacity=np.full(180, 8.0),
        distance=P.rack_distance_matrix(np.arange(180) % 6), net_penalty=0.05,
    )


def scoring_problem(np, seed, B, T, m, n, per_row=False, skew=False, cap_rows=False,
                    memory=False, network=False):
    rng = np.random.default_rng(seed)
    tm = rng.integers(0, m, size=(B, T))
    comp = np.sort(rng.integers(0, n, size=(B, T) if per_row else T), axis=-1)
    uir = rng.uniform(0.05, 1.5, size=(B, T) if (per_row or skew) else T)
    e_cm = rng.uniform(0.3, 3.0, size=(n, m)) * 10.0
    met_cm = rng.uniform(0.0, 2.0, size=(n, m))
    cap = rng.uniform(0.5, 1.5, size=(B, m) if cap_rows else m) * 100.0 * T / m
    if B >= 3 and m >= 3:
        tm[:3] = 0
        cap[..., 0] = 0.5 * T * met_cm[:, 0].mean()  # rows 0-2 over their fixed load
    extras = {}
    if network:
        extras["net_var"] = rng.uniform(0.0, 5.0, size=(B, m))
    if memory:
        mem_c = rng.uniform(0.5, 2.0, size=n)
        mem_w = np.zeros((B, m))
        np.add.at(mem_w, (np.repeat(np.arange(B), T), tm.reshape(-1)),
                  np.broadcast_to(mem_c[comp], (B, T)).reshape(-1))
        # A shared memory capacity at the median row's peak: about half the
        # rows fit.
        extras["mem_c"] = mem_c
        extras["mem_capacity"] = np.full(m, np.median(mem_w.max(axis=1)) if B else 1.0)
    return (tm, comp, uir, e_cm, met_cm, cap), extras


def to_tensors(torch, np, device, args, extras):
    tm, comp, uir, e_cm, met_cm, cap = args
    t = lambda x, dt: torch.from_numpy(np.ascontiguousarray(x, dtype=dt)).to(device)  # noqa: E731
    out = (t(tm, np.int32), t(comp, np.int32), t(uir, np.float64), t(e_cm, np.float64),
           t(met_cm, np.float64), t(cap, np.float64))
    return out, {k: t(v, np.float64) for k, v in extras.items()}


def compare_kernel(torch, np, ops, args, extras):
    """Kernel on the card vs plain version (CPU) on the same inputs; returns
    the max abs error after checking mask and argmax."""
    cpu_args, cpu_kw = to_tensors(torch, np, "cpu", args, extras)
    gpu_args, gpu_kw = to_tensors(torch, np, "cuda", args, extras)
    plain = ops.sched_scoring(*cpu_args, **cpu_kw).numpy()
    got = ops.sched_scoring(*gpu_args, **gpu_kw)
    torch.cuda.synchronize()
    got = got.cpu().numpy()
    check(got.shape == plain.shape, "kernel output shape")
    check(np.array_equal(got == 0.0, plain == 0.0), "kernel feasibility mask differs")
    if got.size:
        check(int(np.argmax(got)) == int(np.argmax(plain)), "kernel argmax differs")
        finite = np.isfinite(plain)
        check(np.array_equal(np.isfinite(got), finite), "kernel infinities differ")
        err = float(np.max(np.abs(got[finite] - plain[finite]), initial=0.0))
    else:
        err = 0.0
    check(err == 0.0, f"kernel differs from its plain version by {err}")
    return err, int((plain == 0.0).sum())


def time_cuda(torch, fn, reps=15, flush_bytes=256 << 20):
    """Median ms of ``fn()`` over ``reps`` runs, each after a write of
    ``flush_bytes`` that evicts the 50 MB L2 (the sweep's caller finds it cold)."""
    flush = torch.empty(flush_bytes // 4, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


# Phase 7's cases: (label, B, Sq, Sk, H, Hkv, D, causal, window) for B3 and
# (label, B, H, Hkv, S, D) for B4, whose lengths run from 1 to S.
FLASH_CASES = [
    ("serving shape", 8, 512, 512, 16, 16, 64, True, 0),
    ("GQA G=2, right-aligned queries", 1, 128, 256, 4, 2, 64, True, 0),
    ("GQA G=8, ragged S=300", 2, 300, 300, 8, 1, 64, True, 0),
    ("MQA + window 128, D=128", 2, 256, 256, 2, 1, 128, True, 128),
    ("bidirectional, D=32", 1, 64, 64, 2, 2, 32, False, 0),
    ("ragged S=192", 1, 192, 192, 2, 2, 64, True, 0),
    ("window without causal, Sk=300", 1, 100, 300, 4, 2, 32, False, 40),
    ("ragged S=600, window 200, D=256", 1, 600, 600, 2, 2, 256, True, 200),
]
DECODE_CASES = [
    ("serving shape", 8, 16, 16, 576, 64),
    ("GQA G=4, S=1024", 2, 8, 2, 1024, 64),
    ("GQA G=8, ragged S=300", 2, 16, 2, 300, 64),
    ("MQA, D=128", 4, 4, 1, 512, 128),
    ("ragged S=600", 3, 16, 16, 600, 64),
    ("ragged S=192, D=256", 2, 16, 2, 192, 256),
]
# Kernel vs plain version on the same card, elementwise |got - want| <=
# atol + rtol |want|. Both compute in float32 and differ only in the order of
# sums: float32 2e-5, the tolerance of tests/test_kernels.py. In bfloat16
# both round that float32 result once, so they may differ by one bf16 ulp,
# at most 2^-7 |want|; the 1e-5 covers the float32 part near zero.
ATTN_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (1e-5, 2.0 ** -7)}
# Card (bf16) against the CPU (float32) on the same weights, per step:
# ||d||_2 / ||ref||_2 and max|d| / max|ref| of the logits, each at most
# 16 u with u = 2^-8 the bf16 unit roundoff. The same full-depth model at
# widths 256-512, bf16 against float32 on a CPU, gives 0.015-0.017.
LOGIT_TOL = 16 * 2.0 ** -8


def attention_error(torch, what, got, want) -> float:
    """Max abs error of a kernel's output against its plain version, after
    checking it is finite and within ``ATTN_TOL`` of its type."""
    atol, rtol = ATTN_TOL[str(got.dtype).split(".")[1]]
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    check(torch.allclose(got, want, atol=atol, rtol=rtol),
          f"{what}: max abs error {err}, over atol {atol} + rtol {rtol}")
    return err


def attention_phase(torch, flash_ops, decode_ops, flash_ref, decode_ref):
    """Phase 7: each attention kernel against its plain version on the card."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    max_err = {"flash_attention": 0.0, "decode_attention": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        for label, B, Sq, Sk, H, Hkv, D, causal, window in FLASH_CASES:
            q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                       for shape in ((B, Sq, H, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D)))
            got = flash_ops.flash_attention(q, k, v, causal=causal, window=window)
            want = flash_ref(q, k, v, causal=causal, window=window)
            err = attention_error(torch, f"flash_attention {label} {name}", got, want)
            max_err["flash_attention"] = max(max_err["flash_attention"], err)
            print(f"  B3 {label:<34} {name:<8} max abs err {err:.3e}")
        for label, B, H, Hkv, S, D in DECODE_CASES:
            q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                       for shape in ((B, H, D), (B, S, Hkv, D), (B, S, Hkv, D)))
            lengths = torch.randint(1, S + 1, (B,), generator=gen, device="cuda",
                                    dtype=torch.int32)
            lengths[0] = 1
            if B > 1:
                lengths[-1] = S
            got = decode_ops.decode_attention(q, k, v, lengths)
            want = decode_ref(q, k, v, lengths)
            err = attention_error(torch, f"decode_attention {label} {name}", got, want)
            max_err["decode_attention"] = max(max_err["decode_attention"], err)
            print(f"  B4 {label:<34} {name:<8} lengths {lengths.tolist()} max abs err {err:.3e}")
    return max_err


def serve_phase(torch, flash_ops, decode_ops, M, serve, cfg, wall):
    """Phase 8: serve at full width on the card, then hold a short run
    against the same weights in float32 on the CPU. Returns the launch counts
    of the main run."""
    params = M.init_params(cfg, seed=0, device="cuda")
    n_params = sum(t.numel() for t in _leaves(params))
    B, prompt_len, gen_len = 8, 512, 64
    serve(cfg, batch=2, prompt_len=16, gen_len=2, params=params, device="cuda")  # set-up
    flash_ops.reset_launches()
    decode_ops.reset_launches()
    res = serve(cfg, batch=B, prompt_len=prompt_len, gen_len=gen_len, params=params,
                device="cuda")
    launches = {**flash_ops.LAUNCHES, **decode_ops.LAUNCHES}
    check(launches["flash_attention"] == cfg.n_layers,
          f"prefill launched B3 {launches['flash_attention']} times, not {cfg.n_layers}")
    check(launches["decode_attention"] == cfg.n_layers * (gen_len - 1),
          f"decode launched B4 {launches['decode_attention']} times, "
          f"not {cfg.n_layers * (gen_len - 1)}")
    toks = res.tokens
    check(tuple(toks.shape) == (B, gen_len) and int(toks.min()) >= 0
          and int(toks.max()) < cfg.vocab_size, "served tokens out of shape or vocabulary")
    wall["prefill_s"], wall["decode_s"] = res.prefill_s, res.decode_s
    print(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads of "
          f"{cfg.resolved_head_dim}, {n_params / 1e6:.1f} M parameters in {cfg.param_dtype}")
    print(f"  served {B} requests x {prompt_len} prompt + {gen_len} generated tokens: prefill "
          f"{res.prefill_s:.4f} s ({B * prompt_len / res.prefill_s:,.0f} prompt tok/s), decode "
          f"{res.decode_s:.4f} s for {gen_len - 1} steps ({B * (gen_len - 1) / res.decode_s:,.1f} "
          f"tok/s, {1e3 * res.decode_s / (gen_len - 1):.3f} ms/step); launches {launches}")
    print(f"  sample output ids: {toks[0, :12].tolist()}")

    # The same weights on the CPU in float32, teacher-forced with the card's tokens.
    Bc, Pc, steps = 2, 128, 8
    prompt = torch.randint(0, cfg.vocab_size, (Bc, Pc),
                           generator=torch.Generator().manual_seed(2))
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    params32 = _map_leaves(params, lambda t: t.float().cpu())
    card_c = M.init_caches(cfg, Bc, Pc + steps, device="cuda")
    cpu_c = M.init_caches(cfg32, Bc, Pc + steps, device="cpu")
    card_l, card_c = M.prefill(params, cfg, {"tokens": prompt}, card_c, device="cuda")
    cpu_l, cpu_c = M.prefill(params32, cfg32, {"tokens": prompt}, cpu_c, device="cpu")
    worst = (0.0, 0.0)
    agree = 0
    for step in range(steps + 1):
        got = card_l.float().cpu()
        check(bool(torch.isfinite(got).all()) and tuple(got.shape) == (Bc, cfg.vocab_size),
              f"card logits at step {step}: non-finite or misshapen")
        rel_l2 = float((got - cpu_l).norm() / cpu_l.norm())
        rel_max = float((got - cpu_l).abs().max() / cpu_l.abs().max())
        check(rel_l2 <= LOGIT_TOL and rel_max <= LOGIT_TOL,
              f"step {step}: card vs CPU logits differ by {rel_l2:.4f} (l2) / {rel_max:.4f} "
              f"(max) over {LOGIT_TOL}")
        worst = (max(worst[0], rel_l2), max(worst[1], rel_max))
        tok = got.argmax(-1)
        agree += int((tok == cpu_l.argmax(-1)).sum())
        if step < steps:
            card_l, card_c = M.decode_step(params, cfg, {"tokens": tok[:, None]}, card_c,
                                           device="cuda")
            cpu_l, cpu_c = M.decode_step(params32, cfg32, {"tokens": tok[:, None]}, cpu_c,
                                         device="cpu")
    print(f"  card (bf16) vs CPU (float32), {Bc} x {Pc} prompt + {steps} steps, teacher-forced: "
          f"worst relative error {worst[0]:.4f} (l2) / {worst[1]:.4f} (max) <= {LOGIT_TOL}; "
          f"argmax agrees {agree}/{Bc * (steps + 1)}")
    return launches


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _map_leaves(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_leaves(v, fn) for v in tree]
    return fn(tree)


def attention_timings(torch, flash_ops, decode_ops, flash_ref, decode_ref, cfg, max_err,
                      launches):
    """Phase 9: B3 and B4 at the serving shapes; returns their records."""
    import torch.nn.functional as F

    B, S, H, Hkv, D = 8, 512, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    gen = torch.Generator(device="cuda").manual_seed(9)
    bf16 = dict(device="cuda", dtype=torch.bfloat16)
    q, k, v = (torch.randn(shape, generator=gen, **bf16)
               for shape in ((B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    err = attention_error(torch, "B3 at the serving shape", flash_ops.flash_attention(
        q, k, v, causal=True), flash_ref(q, k, v, causal=True))
    max_err["flash_attention"] = max(max_err["flash_attention"], err)
    ms = time_cuda(torch, lambda: flash_ops.flash_attention(q, k, v, causal=True))
    plain_ms = time_cuda(torch, lambda: flash_ref(q, k, v, causal=True), reps=5)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    lib_ms = time_cuda(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))
    pairs = B * H * S * (S + 1) // 2  # unmasked (query, key) pairs of the causal mask
    flops = 4 * D * pairs
    n_bytes = 2 * B * S * (2 * H + 2 * Hkv) * D  # bf16 q, k, v read and o written once
    bound = _bound(flops / BF16_FLOPS_PER_S, n_bytes / HBM_BYTES_PER_S)
    records = [_record("flash_attention", "src/repro_torch/kernels/flash_attention/csrc/"
                       "flash_attention.cu", "src/repro/kernels/flash_attention/kernel.py:102",
                       launches, max_err, ms, plain_ms, bound, lib_ms)]
    print(f"  B3 flash_attention B={B} S={S} H={H} D={D} bf16 causal: {ms:.4f} ms, bound "
          f"{bound[0]:.4f} ms by {bound[1]} ({flops / 1e9:.2f} GFLOP, {n_bytes / 1e6:.2f} MB; "
          f"{100 * bound[0] / ms:.1f}% of it), plain {plain_ms:.4f} ms, "
          f"scaled_dot_product_attention {lib_ms:.4f} ms")

    S_cache, length = 576, 575  # the last decode step of phase 8: 512 + 63 tokens cached
    qd = torch.randn(B, H, D, generator=gen, **bf16)
    kc, vc = (torch.randn(B, S_cache, Hkv, D, generator=gen, **bf16) for _ in range(2))
    lengths = torch.full((B,), length, dtype=torch.int32, device="cuda")
    err = attention_error(torch, "B4 at the serving shape", decode_ops.decode_attention(
        qd, kc, vc, lengths), decode_ref(qd, kc, vc, lengths))
    max_err["decode_attention"] = max(max_err["decode_attention"], err)
    ms = time_cuda(torch, lambda: decode_ops.decode_attention(qd, kc, vc, lengths))
    plain_ms = time_cuda(torch, lambda: decode_ref(qd, kc, vc, lengths), reps=5)
    qs = qd[:, :, None]
    ks, vs = (x[:, :length].transpose(1, 2).contiguous() for x in (kc, vc))
    lib_ms = time_cuda(torch, lambda: F.scaled_dot_product_attention(qs, ks, vs))
    n_bytes = 2 * B * length * Hkv * D * 2 + 2 * B * H * D * 2 + B * 4
    flops = 4 * B * H * length * D
    bound = _bound(flops / BF16_FLOPS_PER_S, n_bytes / HBM_BYTES_PER_S)
    records.append(_record("decode_attention", "src/repro_torch/kernels/decode_attention/csrc/"
                           "decode_attention.cu", "src/repro/kernels/decode_attention/kernel.py:75",
                           launches, max_err, ms, plain_ms, bound, lib_ms))
    print(f"  B4 decode_attention B={B} H={H} S={S_cache} lengths {length} D={D} bf16: "
          f"{ms:.4f} ms, bound {bound[0]:.4f} ms by {bound[1]} ({n_bytes / 1e6:.2f} MB; "
          f"{100 * bound[0] / ms:.1f}% of it), plain {plain_ms:.4f} ms, "
          f"scaled_dot_product_attention {lib_ms:.4f} ms")
    return records


def _bound(op_s, byte_s):
    """(ms, what bounds it): the larger of the operations' and the bytes' times."""
    return (max(op_s, byte_s) * 1e3, "operations" if op_s >= byte_s else "bytes")


def _record(name, source, replaces, launches, max_err, ms, plain_ms, bound, lib_ms):
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=launches[name], max_abs_err=max_err[name], ms=ms, plain_ms=plain_ms,
                bound_ms=bound[0], bound_by=bound[1], library_ms=lib_ms)


def main() -> int:
    if not (SRC / "repro_torch" / "core").is_dir():
        print("chip_smoke: run from the root of a checkout (src/repro_torch is missing)",
              file=sys.stderr)
        return 2
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on a GPU",
              file=sys.stderr)
        return 3
    sys.path.insert(0, str(SRC))
    import repro_torch.core as P
    from repro_torch.core.schedule_state import ScheduleState
    from repro_torch.kernels._build import build_info
    from repro_torch.kernels.decode_attention import kernel as decode_kernel
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.sched_scoring import kernel, ops

    wall = {}
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)

    # [1] build and device ------------------------------------------------
    print(f"[1] build and device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(f"  nvidia-smi: {smi}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:  # one nvcc per source, all started together
        builds = [pool.submit(k.load_library) for k in (kernel, flash_kernel, decode_kernel)]
        for build in builds:
            build.result()
    wall["build_s"] = time.perf_counter() - t0
    for k in (kernel, flash_kernel, decode_kernel):
        info = build_info(k.SOURCE)
        print(f"  built {k.SOURCE.relative_to(ROOT)} for sm_90a in "
              f"{info.get('seconds', 0.0):.2f} s -> {info['library']}")
        for line in info.get("log", "").splitlines():
            if "registers" in line or "spill" in line or "entry function" in line:
                print(f"  ptxas: {line.strip()}")
    print(f"  all three built in {wall['build_s']:.2f} s")

    # [2] kernel against its plain version on the card ---------------------
    print("[2] kernel against its plain PyTorch version on the card")
    max_err = {"sched_scoring": 0.0, "sched_scoring_resources": 0.0}
    cases = []
    for m in (1, 3, 180):
        for T in (1, 37, 478):
            cases.append((f"shared m={m} T={T}", dict(B=97, T=T, m=m, n=4)))
    cases += [
        ("per-row maps", dict(B=300, T=478, m=180, n=4, per_row=True)),
        ("skew per-row unit_ir", dict(B=257, T=478, m=180, n=4, skew=True)),
        ("per-row capacity (B, m)", dict(B=211, T=130, m=180, n=4, cap_rows=True)),
        ("T=130 (not a multiple of 32)", dict(B=129, T=130, m=17, n=3)),
        ("B2 memory only", dict(B=333, T=478, m=180, n=4, memory=True)),
        ("B2 memory only m=3", dict(B=65, T=37, m=3, n=4, memory=True)),
        ("B2 network only", dict(B=333, T=478, m=180, n=4, network=True)),
        ("B2 memory + network, per-row maps", dict(B=129, T=533, m=180, n=4, per_row=True,
                                                   memory=True, network=True)),
        ("B2 memory + network, per-row capacity", dict(B=129, T=533, m=180, n=4, cap_rows=True,
                                                       memory=True, network=True)),
        ("B2 memory + network, m=1", dict(B=33, T=5, m=1, n=2, memory=True, network=True)),
    ]
    for i, (label, kw) in enumerate(cases):
        args, extras = scoring_problem(np, 100 + i, **kw)
        err, n_inf = compare_kernel(torch, np, ops, args, extras)
        key = "sched_scoring_resources" if extras else "sched_scoring"
        max_err[key] = max(max_err[key], err)
        print(f"  {label:<40} B={kw['B']:<6} -> equal; {n_inf} infeasible rows")
    before = dict(ops.LAUNCHES)
    args, extras = scoring_problem(np, 1, 0, 478, 180, 4)
    empty = ops.sched_scoring(*to_tensors(torch, np, "cuda", args, extras)[0])
    check(empty.shape == (0,) and ops.LAUNCHES == before, "B=0 must return empty, no launch")
    print("  B = 0 -> empty result, no launch")

    # [3] main path at full width ------------------------------------------
    print("[3] main path: schedule -> refine -> simulate, paper_cluster((20, 70, 90))")
    import hashlib

    cluster = P.paper_cluster((20, 70, 90))
    t0 = time.perf_counter()
    sched = P.schedule(P.linear_topology(), cluster, r0=1.0, rate_epsilon=1.0)
    wall["schedule_s"] = time.perf_counter() - t0
    md5 = hashlib.md5(sched.etg.task_machine().tobytes()).hexdigest()
    check(sched.rate == MAIN_GOLDEN["rate"]
          and sched.etg.n_instances.tolist() == MAIN_GOLDEN["n_instances"]
          and sched.iterations == MAIN_GOLDEN["iterations"] and md5 == MAIN_GOLDEN["md5"],
          "schedule() left the 20/70/90 golden")
    print(f"  schedule: rate {sched.rate}, n_instances {sched.etg.n_instances.tolist()}, "
          f"{sched.iterations} iterations, md5 {md5} ({wall['schedule_s']:.3f} s)")
    ops.reset_launches()
    t0 = time.perf_counter()
    ref_gpu = P.refine(sched.etg, cluster, device="cuda")
    torch.cuda.synchronize()
    wall["refine_s"] = time.perf_counter() - t0
    main_launches = dict(ops.LAUNCHES)
    check(main_launches["sched_scoring"] > 0, "the main path launched no sched_scoring kernel")
    t0 = time.perf_counter()
    ref_cpu = P.refine(sched.etg, cluster, device="cpu")
    wall["refine_cpu_s"] = time.perf_counter() - t0
    check(ref_gpu.moves == ref_cpu.moves and ref_gpu.throughput == ref_cpu.throughput
          and np.array_equal(ref_gpu.etg.task_machine(), ref_cpu.etg.task_machine()),
          "refine on the card differs from the CPU path")
    check(ref_gpu.moves == MAIN_REFINE_REF[0] and ref_gpu.throughput == MAIN_REFINE_REF[1],
          "refine differs from the reference's result")
    print(f"  refine(device='cuda'): moves {ref_gpu.moves}, throughput {ref_gpu.throughput!r} "
          f"({wall['refine_s']:.3f} s; cpu path {wall['refine_cpu_s']:.3f} s), "
          f"launches {main_launches}")
    etg = ref_gpu.etg
    rate, thpt = P.max_stable_rate(etg, cluster)
    t0 = time.perf_counter()
    sim = P.simulate(etg, cluster, rate, device="cuda")
    wall["simulate_s"] = time.perf_counter() - t0
    check(abs(sim.throughput - thpt) <= 1e-9 * thpt, "simulated throughput != closed form at R*")
    rng = np.random.default_rng(0)
    base = etg.task_machine()
    batch = np.tile(base, (4096, 1))
    rows = np.arange(4096)
    batch[rows, rng.integers(0, base.size, 4096)] = rng.integers(0, 180, 4096)
    r0 = rng.uniform(0.5, 1.5, 4096) * rate
    t0 = time.perf_counter()
    sim_gpu = P.simulate_batch(etg, cluster, batch, r0, device="cuda")
    wall["simulate_batch_s"] = time.perf_counter() - t0
    sim_cpu = P.simulate_batch(etg, cluster, batch, r0, device="cpu")
    for field in ("ir", "pr", "tcu", "machine_util", "throughput"):
        a, b = getattr(sim_gpu, field), getattr(sim_cpu, field)
        check(a.shape == b.shape and np.all(np.isfinite(a)), f"simulate_batch {field} shape")
        check(np.allclose(a, b, rtol=1e-9, atol=1e-9), f"simulate_batch {field} cuda != cpu")
    print(f"  simulate(device='cuda') at R* {rate!r}: throughput {sim.throughput!r} "
          f"({wall['simulate_s']:.3f} s)")
    print(f"  simulate_batch(device='cuda') B=4096: matches cpu to 1e-9 "
          f"({wall['simulate_batch_s']:.3f} s)")

    # [4] resource path ----------------------------------------------------
    print("[4] resource path: memory + 6 racks, refine max_rounds=3")
    rcl = resource_cluster(P, np)
    rsched = P.schedule(P.linear_topology(), rcl, r0=1.0, rate_epsilon=1.0)
    ops.reset_launches()
    t0 = time.perf_counter()
    res_gpu = P.refine(rsched.etg, rcl, max_rounds=3, device="cuda")
    torch.cuda.synchronize()
    wall["resource_refine_s"] = time.perf_counter() - t0
    res_launches = dict(ops.LAUNCHES)
    check(res_launches["sched_scoring_resources"] > 0,
          "the resource path launched no sched_scoring_resources kernel")
    t0 = time.perf_counter()
    res_cpu = P.refine(rsched.etg, rcl, max_rounds=3, device="cpu")
    wall["resource_refine_cpu_s"] = time.perf_counter() - t0
    check(res_gpu.moves == res_cpu.moves and res_gpu.throughput == res_cpu.throughput
          and np.array_equal(res_gpu.etg.task_machine(), res_cpu.etg.task_machine()),
          "resource refine on the card differs from the CPU path")
    check(res_gpu.moves == RESOURCE_REFINE_REF[0]
          and abs(res_gpu.throughput - RESOURCE_REFINE_REF[1]) <= 1e-12 * RESOURCE_REFINE_REF[1],
          "resource refine differs from the reference's result")
    check(np.all(ScheduleState.from_etg(res_gpu.etg, rcl).mem_load <= rcl.mem_capacity),
          "resource refine left a machine over memory")
    print(f"  180 machines, 6 racks, memory: schedule rate {rsched.rate}, "
          f"n_instances {rsched.etg.n_instances.tolist()}; moves {res_gpu.moves}, "
          f"throughput {res_gpu.throughput!r} ({wall['resource_refine_s']:.3f} s; cpu path "
          f"{wall['resource_refine_cpu_s']:.3f} s), launches {res_launches}")

    # [5] exhaustive search ------------------------------------------------
    print("[5] exhaustive search: optimal_schedule, paper_cluster((1, 1, 1)), 8 tasks")
    small = P.paper_cluster((1, 1, 1))
    ops.reset_launches()
    t0 = time.perf_counter()
    opt = P.optimal_schedule(P.linear_topology(), small, max_total_tasks=8, device="cuda")
    wall["optimal_s"] = time.perf_counter() - t0
    opt_launches = dict(ops.LAUNCHES)
    opt_cpu = P.optimal_schedule(P.linear_topology(), small, max_total_tasks=8, device="cpu")
    check(opt.candidates_evaluated == OPTIMAL_REF["evaluated"]
          and opt.classes_pruned == OPTIMAL_REF["pruned"]
          and opt.etg.n_instances.tolist() == OPTIMAL_REF["n_instances"]
          and opt.throughput == OPTIMAL_REF["throughput"], "optimal_schedule left the golden")
    check(opt.throughput == opt_cpu.throughput
          and opt.candidates_evaluated == opt_cpu.candidates_evaluated
          and np.array_equal(opt.etg.task_machine(), opt_cpu.etg.task_machine()),
          "optimal_schedule on the card differs from the CPU path")
    check(opt_launches["sched_scoring"] > 0, "optimal_schedule launched no kernel")
    print(f"  optimal_schedule: throughput {opt.throughput!r}, {opt.candidates_evaluated} "
          f"evaluated, {opt.classes_pruned} pruned, n_instances {opt.etg.n_instances.tolist()} "
          f"({wall['optimal_s']:.3f} s), launches {opt_launches}")

    # [6] timings ----------------------------------------------------------
    print("[6] timings (CUDA events, cold L2, median of 15) at B=16384 T=478 m=180")
    from repro_torch.kernels.sched_scoring.ref import sched_scoring_ref

    B, T, m, n = 16384, base.size, 180, 4
    batch = np.tile(base, (B, 1))
    batch[np.arange(B), rng.integers(0, T, B)] = rng.integers(0, m, B)
    state = ScheduleState.from_etg(etg, cluster)
    comp = np.repeat(np.arange(n), etg.n_instances)
    uir = (state.cir_unit / etg.n_instances)[comp]
    host_args = (batch, comp, uir, state.e_cm, state.met_cm, cluster.capacity)
    host_extras = dict(net_var=rng.uniform(0.0, 0.2, size=(B, m)),
                       mem_c=np.array([0.5, 1.0, 1.5, 2.0]), mem_capacity=np.full(m, 8.0))
    records = []
    for key, extras, replaces in (
        ("sched_scoring", {}, "src/repro/kernels/sched_scoring/kernel.py:130"),
        ("sched_scoring_resources", host_extras,
         "src/repro/kernels/sched_scoring/kernel.py:180"),
    ):
        err, _ = compare_kernel(torch, np, ops, host_args, extras)  # at the timed shape
        max_err[key] = max(max_err[key], err)
        g_args, g_kw = to_tensors(torch, np, "cuda", host_args, extras)
        ms = time_cuda(torch, lambda: ops.sched_scoring(*g_args, **g_kw))
        plain_ms = time_cuda(torch, lambda: sched_scoring_ref(*g_args, **g_kw), reps=5)
        n_bytes = sum(x.numel() * x.element_size() for x in (*g_args, *g_kw.values())) + B * 8
        flops = B * T * 3 + B * m * 4
        bound_ms = max(n_bytes / HBM_BYTES_PER_S, flops / FP64_FLOPS_PER_S) * 1e3
        launches = main_launches[key] if key == "sched_scoring" else res_launches[key]
        print(f"  {key}: {ms:.4f} ms (bound {bound_ms:.4f} ms by bytes, "
              f"{100 * bound_ms / ms:.1f}% of it), plain {plain_ms:.3f} ms; no single PyTorch "
              f"call computes this function, so library_ms is null")
        records.append(dict(
            name=key, route="cuda",
            source="src/repro_torch/kernels/sched_scoring/csrc/sched_scoring.cu",
            replaces=replaces, launches=launches, max_abs_err=max_err[key], ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes", library_ms=None,
        ))
    sweep = []
    for _ in range(5):
        t0 = time.perf_counter()
        P.max_stable_rate_batch(sched.etg, cluster, batch, device="cuda")
        sweep.append((time.perf_counter() - t0) * 1e3)
    wall["sweep_ms"] = statistics.median(sweep)
    print(f"  one host-to-host sweep at {B} x {T} (int32 conversion, copy, kernel, readback): "
          f"{wall['sweep_ms']:.3f} ms median of 5")

    # [7] attention kernels against their plain versions -------------------
    print("[7] attention kernels (B3, B4) against their plain PyTorch versions on the card")
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import ops as decode_ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.models import model as M
    from repro_torch.serve_lm import serve

    t_lm = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in full float32
    torch.backends.cudnn.allow_tf32 = False
    attn_err = attention_phase(torch, flash_ops, decode_ops, flash_attention_ref,
                               decode_attention_ref)

    # [8] LM serving at full width ------------------------------------------
    print("[8] serving qwen1.5-0.5b at full width: init_params -> init_caches -> prefill -> "
          "decode_step")
    lm_cfg = get_config("qwen1.5-0.5b")
    lm_launches = serve_phase(torch, flash_ops, decode_ops, M, serve, lm_cfg, wall)

    # [9] attention timings -------------------------------------------------
    print("[9] attention timings at the serving shapes (CUDA events, cold L2, median of 15; "
          "plain version median of 5)")
    records += attention_timings(torch, flash_ops, decode_ops, flash_attention_ref,
                                 decode_attention_ref, lm_cfg, attn_err, lm_launches)
    wall["phases_7_9_s"] = time.perf_counter() - t_lm
    print("  wall: " + ", ".join(f"{k} {v:.3f}" for k, v in wall.items()))

    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
