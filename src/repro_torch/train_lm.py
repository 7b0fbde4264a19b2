"""End-to-end training driver: the port of ``examples/train_lm.py``.

Trains a qwen1.5-family model on the synthetic corpus with the full
runtime (async checkpoints, restart safety, watchdog), on the card unless
``--device cpu`` is given:

    PYTHONPATH=src python -m repro_torch.train_lm [--steps 200] [--arch qwen1.5-0.5b]
        [--seq-len 256] [--batch 8] [--full] [--ckpt-dir DIR] [--device cuda|cpu]

Without ``--full`` the config is the example's mini model (4 layers,
d_model 256, vocab 4096, float32); ``--full`` keeps the arch's width at up
to 12 layers, in float32. The loss must fall from the first step to the
last, as the example asserts.
"""

from __future__ import annotations

import argparse
import dataclasses
import tempfile

from repro_torch import resolve_device
from repro_torch._tree import leaves
from repro_torch.configs import get_config
from repro_torch.data.pipeline import Prefetcher, SyntheticLM
from repro_torch.launch import steps as steps_lib
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.runtime.trainer import Trainer, TrainerConfig

__all__ = ["config_for", "main"]


def config_for(arch: str, full: bool):
    """The example's model: the arch at up to 12 layers in float32 with
    ``full``, else its mini variant."""
    base = get_config(arch)
    if full:
        return dataclasses.replace(base, n_layers=min(base.n_layers, 12), dtype="float32",
                                   param_dtype="float32")
    return dataclasses.replace(
        base.reduced(), name=base.name + "-mini",
        d_model=256, n_heads=8, n_kv_heads=min(base.n_kv_heads, 8),
        head_dim=32, d_ff=512 if base.d_ff else 0, vocab_size=4096,
        n_layers=4, block_pattern=base.reduced().block_pattern[:4]
        if base.block_pattern else (),
    )


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--full", action="store_true",
                    help="the arch's width at up to 12 layers (slower on a CPU)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = config_for(args.arch, args.full)
    print(f"training {cfg.name}: {cfg.n_layers}L d={cfg.d_model} vocab={cfg.vocab_size} "
          f"on {device}")

    opt_cfg = adamw.AdamWConfig(lr=1e-3, weight_decay=0.01)
    lr_fn = adamw.cosine_schedule(1e-3, warmup_steps=20, total_steps=args.steps)

    def init_state():
        params = M.init_params(cfg, seed=0, device=device)
        n = sum(x.numel() for x in leaves(params))
        print(f"params: {n/1e6:.1f}M")
        return {"params": params, "opt": adamw.init_opt_state(params, opt_cfg)}

    train_step = steps_lib.make_train_step(cfg, opt_cfg, device=device, lr_fn=lr_fn)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_train_")
    tcfg = TrainerConfig(total_steps=args.steps, ckpt_dir=ckpt_dir,
                         ckpt_every=50, log_every=10)
    with Prefetcher(iter(SyntheticLM(cfg.vocab_size, args.seq_len, args.batch))) as data:
        out = Trainer(tcfg, train_step, init_state, data).run()
    first, last = out["losses"][0], out["losses"][-1]
    print(f"\nloss {first:.3f} -> {last:.3f} over {out['final_step']} steps "
          f"(checkpoints in {ckpt_dir})")
    if not last < first:
        raise RuntimeError("training did not reduce loss")
    return out


if __name__ == "__main__":
    main()
