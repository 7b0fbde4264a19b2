"""The port's training loss against the JAX package's, on the CPU.

At reduced configs in float32 (d_model 64): the JAX package's parameters,
norm scales and biases drawn from a numpy seed, go to the port through
``params_from_jax``, and both packages see the same numpy batch.

* ``loss_fn`` (``_chunked_xent`` with it) for five families: qwen1.5 (one
  chunk, and a ragged S = 1100 over chunks of 512, 512 and 76),
  granite-moe (its aux loss), deepseek-v3 (MLA and the MTP head),
  recurrentgemma (RG-LRU and local attention) and xlstm; 1e-5. The remat
  route (``torch.utils.checkpoint``) gives the same number.
* Without a card ``loss_fn``, the train step, a ``Trainer`` that trains on
  ``"cuda"`` and ``train_lm.main`` raise before any host work; an RG-LRU
  model's ``"cuda"`` request is refused the same way, and its CPU loss
  differentiates through B5's backward.

``tests/test_torch_train_step.py`` holds the gradients and the steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as jax_model
from repro.models.layers import MeshCtx
from repro_torch._tree import leaves, leaves_with_path
from repro_torch.configs import get_config
from repro_torch.launch.steps import make_train_step
from repro_torch.models import model as M
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import adamw
from torch_train_common import B, TOL, tokens as _tokens, tree as _tree

CTX = MeshCtx(mesh=None)


@pytest.mark.parametrize("name,S", [("qwen1.5-0.5b", 12), ("qwen1.5-0.5b", 1100),
                                    ("granite-moe-1b-a400m", 12), ("deepseek-v3-671b", 12),
                                    ("recurrentgemma-2b", 40), ("xlstm-125m", 12)])
def test_loss_fn_matches_jax(name, S):
    jcfg, cfg, tree = _tree(name)
    tokens = _tokens(cfg, S)
    want = float(jax.jit(lambda p, t: jax_model.loss_fn(p, jcfg, CTX, {"tokens": t}))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(tokens)))
    params = params_from_jax(tree, cfg, device="cpu")
    got = M.loss_fn(params, cfg, {"tokens": tokens}, device="cpu")
    assert got.dtype == torch.float32 and got.ndim == 0
    np.testing.assert_allclose(float(got), want, **TOL)
    if name == "granite-moe-1b-a400m":  # the aux loss is in it
        _, _, auxes, _ = M._trunk(params, cfg, {"tokens": torch.from_numpy(tokens)}, train=True)
        aux = sum(auxes)
        assert len(auxes) == cfg.n_layers and float(aux) > 0
        _, _, jaux = jax.jit(lambda p, t: jax_model.forward(p, jcfg, CTX, {"tokens": t}))(
            jax.tree.map(jnp.asarray, tree), jnp.asarray(tokens))
        np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6, rtol=1e-6)


def test_chunked_xent_matches_jax_with_a_mask():
    """Three chunks (512, 512, 76 positions) under a random mask, explicit
    labels; and the remat route gives the same number."""
    jcfg, cfg, tree = _tree("qwen1.5-0.5b")
    rng = np.random.default_rng(3)
    h = rng.standard_normal((B, 1100, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab_size, size=(B, 1100)).astype(np.int32)
    mask = (rng.random((B, 1100)) < 0.7).astype(np.float32)
    xent = jax.jit(lambda p, *a: jax_model._chunked_xent(p, jcfg, *a))
    want = float(xent(jax.tree.map(jnp.asarray, tree), jnp.asarray(h), jnp.asarray(labels),
                      jnp.asarray(mask)))
    params = params_from_jax(tree, cfg, device="cpu")
    args = (params, cfg, torch.from_numpy(h), torch.from_numpy(labels), torch.from_numpy(mask))
    np.testing.assert_allclose(float(M._chunked_xent(*args)), want, **TOL)
    np.testing.assert_allclose(float(M._chunked_xent(*args, remat=True)), want, **TOL)


def test_embedding_inputs_need_labels():
    cfg = get_config("qwen2-vl-72b").reduced()
    params = M.init_params(cfg, device="cpu")
    with pytest.raises(ValueError, match="explicit labels"):
        M.loss_fn(params, cfg, {"embeds": torch.zeros(1, 4, cfg.d_model)}, device="cpu")


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: 'cuda' requests are valid here")


def test_training_raises_without_a_card_before_host_work(no_card, monkeypatch, tmp_path):
    import signal
    import threading

    from repro_torch import train_lm
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    cfg = get_config("qwen1.5-0.5b").reduced()
    params = M.init_params(cfg, device="cpu")
    opt = adamw.AdamWConfig()
    state = {"params": params, "opt": adamw.init_opt_state(params, opt)}
    batch = {"tokens": _tokens(cfg, 8)}
    work = []
    monkeypatch.setattr(M, "_trunk", lambda *a, **k: work.append(a))
    monkeypatch.setattr(train_lm, "get_config", lambda *a: work.append(a))
    handlers = [signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)]
    threads = threading.active_count()
    trainer = Trainer(TrainerConfig(total_steps=2, ckpt_dir=str(tmp_path / "ck")),
                      make_train_step(cfg, opt), lambda: state, iter([batch] * 2),
                      log=lambda *_: None)
    for call in (lambda: M.loss_fn(params, cfg, batch),
                 lambda: make_train_step(cfg, opt)(state, batch),
                 trainer.run,
                 lambda: train_lm.main([]),
                 lambda: train_lm.main(["--device", "cuda", "--steps", "1"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert work == []
    assert not (tmp_path / "ck").exists()
    assert [signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)] == handlers
    assert threading.active_count() == threads


def test_rglru_training_on_the_card_is_deferred():
    """RG-LRU training is no longer deferred: B5 has a backward, so
    ``loss_fn`` refuses an RG-LRU model on ``"cuda"`` only as it refuses
    every model without a card (``no CUDA device``, before any host work),
    and on the CPU the loss differentiates through B5's autograd route."""
    cfg = get_config("recurrentgemma-2b").reduced()
    params = M.init_params(cfg, device="cpu")
    batch = {"tokens": _tokens(cfg, 8)}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            M.loss_fn(params, cfg, batch, device="cuda")
    flat = [p.requires_grad_(True) for p in leaves(params)]
    grads = torch.autograd.grad(M.loss_fn(params, cfg, batch, device="cpu"), flat)
    by_name = {path: g for (path, _), g in zip(leaves_with_path(params), grads)}
    lam = [g for path, g in by_name.items() if path[-1] == "lambda_raw"]
    assert len(lam) == cfg.resolved_block_pattern.count("rglru")
    assert all(torch.isfinite(g).all() and g.abs().max() > 0 for g in lam)
