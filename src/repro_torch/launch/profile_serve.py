"""Where the serving time goes: one prefill and a run of decode steps under
``torch.profiler``, on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve [--arch qwen1.5-0.5b]
        [--batch 8] [--prompt-len 512] [--steps 16]

(``--arch recurrentgemma-2b --prompt-len 2304`` profiles the hybrid.)
Serves the published width and depth with random weights (seed 0). For
each phase it prints the host wall time (ended by a synchronise), the
device busy time (the union of the kernels' and copies' intervals in the
trace), the busy share, the device time and wrapper calls of each of the
port's own kernels (B3 flash attention; B4 decode attention, its split and
combine kernels summed; B5 RG-LRU scan) and the kernels that took the most
device time, then one JSON line with the same numbers.
Needs a card; there is no CPU mode.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from collections import defaultdict

import torch

from repro_torch.configs import get_config
from repro_torch.models import model as M

__all__ = ["PORT_KERNELS", "profile_phase", "main"]

# The port's hand-written kernels: the substring of every trace kernel name
# whose device time is theirs, and that of the one kernel they launch once a
# wrapper call (B4 launches a split and a combine kernel a call).
PORT_KERNELS = {"flash_attention": "flash_attention",
                "decode_attention": "decode_attention_combine",
                "rglru_scan": "rglru_scan"}


def profile_phase(fn, top: int = 8, kernels: dict[str, str] = PORT_KERNELS) -> dict:
    """Run ``fn`` once under the profiler; wall and device-busy seconds, and
    the device time and calls of each of ``kernels`` (named as in
    ``PORT_KERNELS``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        raise RuntimeError("the profiler recorded no device activity")
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
    return dict(wall_s=wall, device_busy_s=busy_us * 1e-6, busy_share=busy_us * 1e-6 / wall,
                launches=len(spans), port_kernels=port,
                top=[dict(name=n[:80], device_ms=t * 1e-3, calls=c) for n, (t, c) in ranked])


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--steps", type=int, default=16)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    B, P, steps = args.batch, args.prompt_len, args.steps
    params = M.init_params(cfg, seed=0, device="cuda")
    prompt = torch.randint(0, cfg.vocab_size, (B, P), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(1))
    state = {}

    def prefill():
        caches = M.init_caches(cfg, B, P + steps + 1, device="cuda")
        logits, state["caches"] = M.prefill(params, cfg, {"tokens": prompt}, caches)
        state["tok"] = logits.argmax(-1)[:, None]

    def decode():
        for _ in range(steps):
            logits, state["caches"] = M.decode_step(params, cfg, {"tokens": state["tok"]},
                                                    state["caches"])
            state["tok"] = logits.argmax(-1)[:, None]

    prefill()  # first-call set-up (kernel build and load, allocator, cuBLAS handles)
    decode()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    out = {"gpu": smi, "arch": cfg.name, "batch": B, "prompt_len": P, "steps": steps}
    for name, fn in (("prefill", prefill), ("decode", decode)):
        out[name] = res = profile_phase(fn)
        print(f"[{name}] wall {res['wall_s']:.4f} s, device busy {res['device_busy_s']:.4f} s "
              f"({100 * res['busy_share']:.1f}%), {res['launches']} device activities")
        print("  port kernels: " + ", ".join(f"{k} {v['device_ms']:.3f} ms x{v['calls']}"
                                             for k, v in res["port_kernels"].items()))
        for row in res["top"]:
            print(f"  {row['device_ms']:10.3f} ms  x{row['calls']:<6} {row['name']}")
    print(smi)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
