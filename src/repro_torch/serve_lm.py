"""Serving example: batched prefill + greedy decode against KV caches,
fronted by the paper's scheduler as admission/replica planner, including
an elastic failure event.

The port of ``examples/serve_lm.py``:

    PYTHONPATH=src python -m repro_torch.serve_lm [--arch qwen1.5-0.5b] [--device cpu]

It first plans the full architecture's deployment over a GPU fleet (H100 x
6 groups of 8, L4 x 8 groups of 4) with ``ElasticController``, loses two
H100 groups and replans, then restores them. Then it serves the reduced
variant of the architecture (``cfg.reduced()``), as the JAX example does;
``serve`` takes any config, and ``chip_smoke.py`` and
``repro_torch.launch.profile_serve`` drive it at the published width and
depth. Weights and prompts are random, from fixed seeds; an
encoder-decoder (whisper-tiny) takes stub frame embeddings, random too, in
place of the conv/mel front end, and qwen2-vl stub prompt embeddings in
place of its vision front end, both of which the JAX package stubs as
well. Unlike the JAX example, whose qwen2-vl decode steps take zero
embeddings, every decode step feeds the token just generated.
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
from repro_torch.sched.elastic import ElasticController
from repro_torch.sched.fleet import H100_SXM, L4, DevicePool, Fleet

__all__ = ["FLEET", "ServeResult", "serve", "main"]

# The fleet that ``main`` plans over: the GPU counterpart of the JAX
# example's (v5e x 6 groups of 8, lite x 8 groups of 4).
FLEET = Fleet(pools=(
    DevicePool(chip=H100_SXM, count=6, chips_per_group=8, name="h100"),
    DevicePool(chip=L4, count=8, chips_per_group=4, name="l4"),
))


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
    prompt_embeds: torch.Tensor | None = None,
    mrope_positions: torch.Tensor | None = None,
    decode_positions: torch.Tensor | None = None,
) -> ServeResult:
    """Serve ``batch`` random prompts of ``prompt_len`` tokens and decode
    ``gen_len`` tokens greedily (prefill gives the first). Without
    ``params``, the weights are drawn with seed 0.

    An encoder-decoder also draws (B, encoder_seq, d_model) stub frame
    embeddings in the activation type; the encoder runs once, inside the
    prefill's time, and every step takes its output.

    A model with ``cfg.embedding_inputs`` (qwen2-vl) prefills from
    ``prompt_embeds`` (B, prompt_len, d_model), taken as given, or without
    them from stub embeddings drawn in the activation type; under M-RoPE
    the prefill takes ``mrope_positions`` (3, B, prompt_len) and the decode
    steps ``decode_positions`` (3, B, gen_len - 1), step i its column i,
    each the text-only fallback where not given. Decode steps feed the
    generated tokens."""
    dev = resolve_device(device)
    if params is None:
        params = M.init_params(cfg, seed=0, device=dev)
    caches = M.init_caches(cfg, batch, prompt_len + gen_len, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    first: dict = {}
    if cfg.embedding_inputs:
        if prompt_embeds is None:
            prompt_embeds = torch.randn(batch, prompt_len, cfg.d_model, generator=gen,
                                        device=dev, dtype=M._DTYPES[cfg.dtype])
        first["embeds"] = prompt_embeds
    else:
        first["tokens"] = torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=gen,
                                        device=dev)
    if mrope_positions is not None:
        first["mrope_positions"] = mrope_positions
    if decode_positions is not None and tuple(decode_positions.shape) != (3, batch, gen_len - 1):
        raise ValueError(f"decode_positions of shape {tuple(decode_positions.shape)}, not "
                         f"(3, {batch}, {gen_len - 1})")
    frames = None
    if cfg.is_encoder_decoder:
        frames = torch.randn(batch, cfg.encoder_seq, cfg.d_model, generator=gen, device=dev,
                             dtype=M._DTYPES[cfg.dtype])
    prefill = make_prefill_step(cfg, device=dev)
    decode = make_serve_step(cfg, kind="decode", device=dev)

    _sync(dev)
    t0 = time.perf_counter()
    extra = {"encoder_out": M.encode(params, cfg, frames)} if frames is not None else {}
    logits, caches = prefill(params, {**first, **extra}, caches)
    tok = logits.argmax(-1)[:, None]
    _sync(dev)
    t1 = time.perf_counter()
    generated = [tok]
    for i in range(gen_len - 1):
        step = {"tokens": tok, **extra}
        if decode_positions is not None:
            step["mrope_positions"] = decode_positions[:, :, i:i + 1]
        logits, caches = decode(params, step, caches)
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
    dev = resolve_device(args.device)

    # --- plan the serving deployment with the paper's scheduler ---------
    full_cfg = get_config(args.arch)
    ec = ElasticController(full_cfg, FLEET, n_stages=4, device=dev)
    print(ec.current.summary())

    # --- elastic event: lose two h100 groups, re-plan -------------------
    ec.fail(0, 2)
    print(f"\nafter losing 2 h100 groups -> admission {ec.admission_rate:,.0f} tok/s")
    print(ec.current.summary())
    ec.restore(0, 2)

    # --- serve the reduced model --------------------------------------------
    cfg = full_cfg.reduced()
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "the CPU"
    res = serve(cfg, batch=args.batch, prompt_len=args.prompt_len, gen_len=args.gen_len,
                device=dev)
    B, G = args.batch, args.gen_len
    dt = res.prefill_s + res.decode_s
    print(f"\nserved {B} requests x {G} tokens of {cfg.name} in {dt:.2f}s "
          f"({B * G / dt:,.0f} tok/s on {where}); prefill {res.prefill_s:.3f}s for "
          f"{B} x {args.prompt_len} prompt tokens, decode {res.decode_s:.3f}s for "
          f"{G - 1} steps ({B * (G - 1) / max(res.decode_s, 1e-9):,.0f} tok/s)")
    print("sample output ids:", res.tokens[0, :16].tolist())


if __name__ == "__main__":
    main()
