"""Where the serving time goes: one prefill and a run of decode steps under
``torch.profiler``, on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve [--arch qwen1.5-0.5b]
        [--batch 8] [--prompt-len 512] [--steps 16] [--layers N]

(``--arch recurrentgemma-2b --prompt-len 2304`` profiles the hybrid,
``--arch granite-moe-1b-a400m`` the MoE model, ``--arch deepseek-v3-671b
--layers 4`` DeepSeek's first 4 layers, all that one card holds,
``--arch xlstm-125m`` xLSTM, ``--arch whisper-tiny --prompt-len 4`` the
encoder-decoder over stub frames, its encoder inside the prefill,
``--arch qwen2-vl-72b --layers 32`` qwen2-vl's first 32 of 80 layers,
prefilled from stub embeddings as ``serve_lm.serve`` draws them.)
Serves the published width and depth (the first ``--layers`` layers if
given) with random weights (seed 0). For each phase it prints the host
wall time (ended by a synchronise), the device busy time (the union of the
kernels' and copies' intervals in the trace), the busy share, the device
time and wrapper calls of each of the port's own kernels (B3 flash
attention; B4 decode attention, its split and combine kernels summed; B5
RG-LRU scan; the sLSTM recurrence), the device time of each labelled
stage (``STAGES``: a MoE layer's stages, xLSTM's recurrences, Whisper's
encoder and cross-attention), and the kernels that took the most device
time, then
one JSON line with the same numbers. A trace that holds no device
activity, or fewer calls of a port kernel than its wrapper launched, is
taken once more (``whole_trace``), both counts printed; a second short
trace fails.
Needs a card; there is no CPU mode.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import time
from collections import defaultdict

import torch

from repro_torch.configs import get_config
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.rglru_scan import ops as scan_ops
from repro_torch.kernels.slstm_scan import ops as slstm_ops
from repro_torch.models import moe, xlstm
from repro_torch.models import model as M

__all__ = ["MOE_STAGES", "PORT_KERNELS", "STAGES", "stages", "port_call_ms", "profile_phase",
           "trace_shortfall", "whole_trace", "main"]

# The port's hand-written kernels: the substring of every trace kernel name
# whose device time is theirs, and that of the one kernel they launch once a
# wrapper call (B4 launches a split and a combine kernel a call).
PORT_KERNELS = {"flash_attention": "flash_attention",
                "decode_attention": "decode_attention_combine",
                "rglru_scan": "rglru_scan",
                "slstm_scan": "slstm_scan"}
# Their wrappers, by the same names.
_PORT_OPS = {"flash_attention": flash_ops, "decode_attention": decode_ops,
             "rglru_scan": scan_ops, "slstm_scan": slstm_ops}


# The stages of a MoE layer, by the function of ``models.moe`` that runs
# each: routing, dispatch (slot tables and the gather into the expert
# buffer), the expert products, the combine, and the shared experts.
MOE_STAGES = {"_route": "route", "_slot_tables": "dispatch", "_dispatch": "dispatch",
              "_expert_ffn": "experts", "_combine": "combine", "mlp": "shared"}

# Every labelled stage: (module, range prefix, {function: stage}). xLSTM's
# recurrences (the mLSTM chunk loop and its one-token update, torch ops; the
# sLSTM time loop, the ``slstm_scan`` kernel on the card) and Whisper's
# encoder (its B3 launches included) and cross-attention sub-layer (the
# norm, the k/v projections of the frames, B3 or B4) beside the MoE stages.
STAGES = (
    (moe, "moe", MOE_STAGES),
    (xlstm, "xlstm", {"_mlstm_chunk_parallel": "mlstm_chunks", "_mlstm_decode": "mlstm_decode",
                      "_slstm_scan": "slstm_loop"}),
    (M, "whisper", {"encode": "encoder", "_cross_sublayer": "cross_attention"}),
)

# While ``stages`` is open: the ranges open now (innermost last), and for
# each launch of a port kernel, its name and the innermost range open then.
_OPEN: list[str] = []
_LAUNCHED: list[tuple[str, str | None]] = []


@contextlib.contextmanager
def stages():
    """While open, each stage of ``STAGES`` runs inside a profiler range
    named ``<prefix>.<stage>``, which ``profile_phase`` reads; serving
    outside it carries no range. The port kernels' wrappers note the range
    each launch falls in (the profiler does not link the kernels that the
    port's own C entries launch to the ranges around them)."""
    real = [(mod, name, getattr(mod, name)) for mod, _, names in STAGES for name in names]
    real += [(ops, key, getattr(ops, key)) for key, ops in _PORT_OPS.items()]

    def labelled(label, fn):
        def run(*args, **kwargs):
            _OPEN.append(label)
            try:
                with torch.profiler.record_function(label):
                    return fn(*args, **kwargs)
            finally:
                _OPEN.pop()
        return run

    def noted(key, ops, fn):
        def run(*args, **kwargs):
            before = ops.LAUNCHES[key]
            out = fn(*args, **kwargs)
            if ops.LAUNCHES[key] != before:
                _LAUNCHED.append((key, _OPEN[-1] if _OPEN else None))
            return out
        return run

    for mod, prefix, names in STAGES:
        for name, stage in names.items():
            setattr(mod, name, labelled(f"{prefix}.{stage}", getattr(mod, name)))
    for key, ops in _PORT_OPS.items():
        setattr(ops, key, noted(key, ops, getattr(ops, key)))
    try:
        yield
    finally:
        for mod, name, fn in real:
            setattr(mod, name, fn)
        _LAUNCHED.clear()


def port_call_ms(spans, key: str, once: str) -> list[float]:
    """Device ms of each call of a port kernel, in launch order: the trace's
    device activities whose names hold ``key``, by start time (one stream
    runs them in launch order), a call ending at the one kernel it launches
    once (``once``)."""
    calls, acc = [], 0.0
    for start, stop, name in spans:
        if key in name:
            acc += stop - start
            if once in name:
                calls.append(acc * 1e-3)
                acc = 0.0
    return calls


def trace_shortfall(spans, launched, kernels: dict[str, str]) -> str | None:
    """What a trace lacks, or None where it is whole: device activity, and
    for each of ``kernels`` (named as in ``PORT_KERNELS``) as many calls
    (``port_call_ms``) in ``spans`` as its wrapper noted launches in
    ``launched`` ((kernel, range) pairs)."""
    if not spans:
        return "the profiler recorded no device activity"
    short = []
    for key, once in kernels.items():
        noted = sum(1 for k, _ in launched if k == key)
        traced = len(port_call_ms(spans, key, once))
        if noted and traced != noted:
            short.append(f"{key}: {noted} launches noted, {traced} in the trace")
    return "; ".join(short) or None


def whole_trace(trace, kernels: dict[str, str], again=None):
    """``trace()`` profiles a run once and returns (spans, launched,
    record). Where that trace falls short (``trace_shortfall``: records the
    profiler dropped), ``again()`` (where given) restores what the run
    changed and the run is profiled once more; both counts are printed.
    Returns the record of the whole trace; raises, naming both shortfalls,
    where the second trace falls short too."""
    spans, launched, record = trace()
    first = trace_shortfall(spans, launched, kernels)
    if first is None:
        return record
    print(f"  profiler: the trace fell short ({first}); profiling once more", flush=True)
    if again is not None:
        again()
    spans, launched, record = trace()
    second = trace_shortfall(spans, launched, kernels)
    if second is not None:
        raise RuntimeError(f"the profiler's trace fell short twice: first {first}; then {second}")
    counts = ", ".join(f"{key} {len(port_call_ms(spans, key, once))}"
                       for key, once in kernels.items() if any(k == key for k, _ in launched))
    print(f"  profiler: the second trace is whole ({len(spans)} device activities"
          + (f"; calls {counts}" if counts else "") + ")", flush=True)
    return record


def profile_phase(fn, top: int = 8, kernels: dict[str, str] = PORT_KERNELS, again=None) -> dict:
    """Run ``fn`` under the profiler; wall and device-busy seconds, the
    device time and calls of each of ``kernels`` (named as in
    ``PORT_KERNELS``), and the device time under each ``<prefix>.<stage>``
    range of ``STAGES`` (``stages``; empty without one): its torch ops'
    and the port kernels it launched. A trace that falls short is taken
    once more (``whole_trace``), after ``again()`` where given (a decode
    run's prefill: the cache has room for one run)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def trace():
        _LAUNCHED.clear()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        # A profiler range also shows on the device's timeline, spanning its
        # kernels and the gaps between them: it is no device activity.
        spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                       if e.device_type == DeviceType.CUDA
                       and not getattr(e, "is_user_annotation", False))
        launched = list(_LAUNCHED)
        return spans, launched, (prof, spans, launched, wall)

    prof, spans, launched, wall = whole_trace(trace, kernels, again)
    busy_us, end = 0.0, float("-inf")
    by_name: dict[str, list] = defaultdict(lambda: [0.0, 0])
    for start, stop, name in spans:
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
        by_name[name][0] += stop - start
        by_name[name][1] += 1
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    port = {k: dict(device_ms=sum(t for n, (t, _) in by_name.items() if k in n) * 1e-3,
                    calls=sum(c for n, (_, c) in by_name.items() if once in n))
            for k, once in kernels.items()}
    prefixes = tuple(f"{prefix}." for _, prefix, _ in STAGES)
    stage_ms: dict[str, float] = defaultdict(float)
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name.startswith(prefixes):
            stage_ms[e.name] += e.device_time_total * 1e-3
    for key, once in kernels.items():
        in_stage = [stage for k, stage in launched if k == key]
        if any(in_stage):
            for stage, ms in zip(in_stage, port_call_ms(spans, key, once)):
                if stage is not None:
                    stage_ms[stage] += ms
    return dict(wall_s=wall, device_busy_s=busy_us * 1e-6, busy_share=busy_us * 1e-6 / wall,
                launches=len(spans), port_kernels=port, stages_ms=dict(stage_ms),
                top=[dict(name=n[:80], device_ms=t * 1e-3, calls=c) for n, (t, c) in ranked])


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--layers", type=int, default=0,
                    help="serve only the first N layers (0: all of them)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers,
                                  block_pattern=cfg.block_pattern[:args.layers])
    B, P, steps = args.batch, args.prompt_len, args.steps
    params = M.init_params(cfg, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    act = M._DTYPES[cfg.dtype]
    # qwen2-vl prefills from stub embeddings, as ``serve`` draws them, its
    # rotary at the text-only positions; its decode steps take tokens.
    first = ({"embeds": torch.randn(B, P, cfg.d_model, device="cuda", generator=gen, dtype=act)}
             if cfg.embedding_inputs else
             {"tokens": torch.randint(0, cfg.vocab_size, (B, P), device="cuda", generator=gen)})
    frames = (torch.randn(B, cfg.encoder_seq, cfg.d_model, device="cuda", generator=gen,
                          dtype=act) if cfg.is_encoder_decoder else None)
    state = {"extra": {}}

    def prefill():
        caches = M.init_caches(cfg, B, P + steps + 1, device="cuda")
        if frames is not None:  # the encoder runs once a request batch, in the prefill
            state["extra"] = {"encoder_out": M.encode(params, cfg, frames)}
        logits, state["caches"] = M.prefill(params, cfg, {**first, **state["extra"]}, caches)
        state["tok"] = logits.argmax(-1)[:, None]

    def decode():
        for _ in range(steps):
            logits, state["caches"] = M.decode_step(
                params, cfg, {"tokens": state["tok"], **state["extra"]}, state["caches"])
            state["tok"] = logits.argmax(-1)[:, None]

    prefill()  # first-call set-up (kernel build and load, allocator, cuBLAS handles)
    decode()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    out = {"gpu": smi, "arch": cfg.name, "layers": cfg.n_layers, "batch": B, "prompt_len": P,
           "steps": steps}
    for name, fn in (("prefill", prefill), ("decode", decode)):
        with stages():
            out[name] = res = profile_phase(fn, again=prefill if fn is decode else None)
        print(f"[{name}] wall {res['wall_s']:.4f} s, device busy {res['device_busy_s']:.4f} s "
              f"({100 * res['busy_share']:.1f}%), {res['launches']} device activities")
        print("  port kernels: " + ", ".join(f"{k} {v['device_ms']:.3f} ms x{v['calls']}"
                                             for k, v in res["port_kernels"].items()))
        if res["stages_ms"]:
            busy_ms = res["device_busy_s"] * 1e3
            print("  stages: " + ", ".join(
                f"{k} {v:.3f} ms ({100 * v / busy_ms:.1f}% of device busy)"
                for k, v in res["stages_ms"].items()))
        for row in res["top"]:
            print(f"  {row['device_ms']:10.3f} ms  x{row['calls']:<6} {row['name']}")
    print(smi)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
