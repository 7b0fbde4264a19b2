"""Serving example: batched prefill + greedy decode against KV caches.

The port of the serving part of ``examples/serve_lm.py``:

    PYTHONPATH=src python -m repro_torch.serve_lm [--arch qwen1.5-0.5b] [--device cpu]

It serves the reduced variant of the architecture (``cfg.reduced()``), as
the JAX example does; ``serve`` takes any config, and ``chip_smoke.py`` and
``repro_torch.launch.profile_serve`` drive it at the published width and
depth. Weights and prompts are random, from fixed seeds; an
encoder-decoder (whisper-tiny) takes stub frame embeddings, random too, in
place of the conv/mel front end, which the JAX package stubs as well. The
example's first part, which plans the deployment across a fleet with
the paper's scheduler and replans after an elastic failure, needs
``repro.sched`` and waits for its port (ROADMAP A14).
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig

__all__ = ["ServeResult", "serve", "main"]


@dataclasses.dataclass
class ServeResult:
    tokens: torch.Tensor   # (B, gen_len) generated ids, on the serving device
    prefill_s: float       # host seconds of the prefill (and the encoder), ended by a synchronise
    decode_s: float        # host seconds of the gen_len - 1 decode steps


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(
    cfg: ModelConfig,
    *,
    batch: int,
    prompt_len: int,
    gen_len: int,
    device: str | torch.device = "cuda",
    params: dict | None = None,
) -> ServeResult:
    """Serve ``batch`` random prompts of ``prompt_len`` tokens and decode
    ``gen_len`` tokens greedily (prefill gives the first). Without
    ``params``, the weights are drawn with seed 0.

    An encoder-decoder also draws (B, encoder_seq, d_model) stub frame
    embeddings in the activation type; the encoder runs once, inside the
    prefill's time, and every step takes its output."""
    dev = resolve_device(device)
    if params is None:
        params = M.init_params(cfg, seed=0, device=dev)
    caches = M.init_caches(cfg, batch, prompt_len + gen_len, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=gen, device=dev)
    frames = None
    if cfg.is_encoder_decoder:
        frames = torch.randn(batch, cfg.encoder_seq, cfg.d_model, generator=gen, device=dev,
                             dtype=M._DTYPES[cfg.dtype])
    prefill = make_prefill_step(cfg, device=dev)
    decode = make_serve_step(cfg, kind="decode", device=dev)

    _sync(dev)
    t0 = time.perf_counter()
    extra = {"encoder_out": M.encode(params, cfg, frames)} if frames is not None else {}
    logits, caches = prefill(params, {"tokens": prompt, **extra}, caches)
    tok = logits.argmax(-1)[:, None]
    _sync(dev)
    t1 = time.perf_counter()
    generated = [tok]
    for _ in range(gen_len - 1):
        logits, caches = decode(params, {"tokens": tok, **extra}, caches)
        tok = logits.argmax(-1)[:, None]
        generated.append(tok)
    tokens = torch.cat(generated, dim=1)
    _sync(dev)
    t2 = time.perf_counter()
    return ServeResult(tokens=tokens, prefill_s=t1 - t0, decode_s=t2 - t1)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).reduced()
    dev = resolve_device(args.device)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "the CPU"
    res = serve(cfg, batch=args.batch, prompt_len=args.prompt_len, gen_len=args.gen_len,
                device=dev)
    B, G = args.batch, args.gen_len
    dt = res.prefill_s + res.decode_s
    print(f"served {B} requests x {G} tokens of {cfg.name} in {dt:.2f}s "
          f"({B * G / dt:,.0f} tok/s on {where}); prefill {res.prefill_s:.3f}s for "
          f"{B} x {args.prompt_len} prompt tokens, decode {res.decode_s:.3f}s for "
          f"{G - 1} steps ({B * (G - 1) / max(res.decode_s, 1e-9):,.0f} tok/s)")
    print("sample output ids:", res.tokens[0, :16].tolist())


if __name__ == "__main__":
    main()
