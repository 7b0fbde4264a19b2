"""Training on the card. Marked ``cuda``: the tests skip without a card. This
file imports no JAX, so it runs on a machine that has torch alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_train_cuda.py

* One ``make_train_step`` step of qwen1.5-0.5b at full width and depth
  (bf16 parameters, float32 moments, remat) from a ``SyntheticLM`` batch:
  a finite loss near ln(vocab), a finite grad norm, every parameter moved,
  and no B3 or B4 launch (training attends through ``sdpa``).
* The same step at 2 layers in float32 against the CPU: loss within 1e-4
  relative, the grad norm and the new parameters within 1e-3.
* B3 and B4 refuse CUDA inputs that require grad; B5 gives its plain
  version's gradient through its backward kernel, and a reduced RG-LRU
  model trains one step on the card (remat: B5 twice a recurrent block,
  its backward once).
"""

import dataclasses
import math

import pytest
import torch

from repro_torch._tree import leaves, tree_map
from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.rglru_scan import ops as scan_ops
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
from repro_torch.launch.steps import make_train_step
from repro_torch.models import model as M
from repro_torch.optim import adamw

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = tf32


def test_full_width_step_on_the_card(cuda_device):
    cfg = get_config("qwen1.5-0.5b")
    opt = adamw.AdamWConfig()
    params = M.init_params(cfg, seed=0, device="cuda")
    state = {"params": params, "opt": adamw.init_opt_state(params, opt)}
    batch = SyntheticLM(cfg.vocab_size, 512, 2, seed=0).batch_at(0)
    flash_ops.reset_launches()
    decode_ops.reset_launches()
    new, metrics = make_train_step(cfg, opt, device="cuda", remat=True)(state, batch)
    assert flash_ops.LAUNCHES["flash_attention"] == decode_ops.LAUNCHES["decode_attention"] == 0
    loss, norm = float(metrics["loss"]), float(metrics["grad_norm"])
    assert math.isfinite(norm) and abs(loss - math.log(cfg.vocab_size)) < 2.0
    assert all(p.dtype == torch.bfloat16 for p in leaves(new["params"]))
    assert all(m.dtype == torch.float32 for m in leaves(new["opt"]["m"]))
    assert all(not torch.equal(a, b) for a, b in zip(leaves(new["params"]), leaves(params))
               if a.numel() > 1024)


def test_float32_step_matches_the_cpu(cuda_device):
    base = get_config("qwen1.5-0.5b")
    cfg = dataclasses.replace(base, n_layers=2, dtype="float32", param_dtype="float32")
    opt = adamw.AdamWConfig()
    params = M.init_params(cfg, seed=0, device="cpu")
    batch = SyntheticLM(cfg.vocab_size, 64, 2, seed=1).batch_at(0)
    out = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t, d=dev: t.to(d), params)
        state = {"params": p, "opt": adamw.init_opt_state(p, opt)}
        out[dev] = make_train_step(cfg, opt, device=dev)(state, batch)
    (cpu, m_cpu), (card, m_card) = out["cpu"], out["cuda"]
    assert float(m_card["loss"]) == pytest.approx(float(m_cpu["loss"]), rel=1e-4)
    assert float(m_card["grad_norm"]) == pytest.approx(float(m_cpu["grad_norm"]), rel=1e-3)
    d_cpu = torch.cat([(a - b).flatten() for a, b in zip(leaves(cpu["params"]), leaves(params))])
    d_card = torch.cat([(a.cpu() - b).flatten()
                        for a, b in zip(leaves(card["params"]), leaves(params))])
    assert float((d_card - d_cpu).norm() / d_cpu.norm()) < 1e-3


def test_kernels_refuse_grad_and_rglru_training_waits(cuda_device):
    """B3 and B4 refuse CUDA inputs that require grad; B5 no longer waits
    (ROADMAP A13b is done): under autograd it launches its kernel and its
    backward kernel and gives the plain version's gradient, and ``loss_fn``
    trains an RG-LRU model on the card through them."""
    q = torch.randn(1, 4, 2, 64, device="cuda", requires_grad=True)
    k = torch.randn(1, 4, 2, 64, device="cuda")
    with pytest.raises(RuntimeError, match="no backward"):
        flash_ops.flash_attention(q, k, k, causal=True)
    lengths = torch.full((1,), 4, dtype=torch.int32, device="cuda")
    with pytest.raises(RuntimeError, match="no backward"):
        decode_ops.decode_attention(q[:, 0], k, k, lengths)
    with torch.no_grad():  # serving: no grad mode, the kernel launches
        assert flash_ops.flash_attention(q, k, k, causal=True).shape == q.shape
    gen = torch.Generator(device="cuda").manual_seed(0)
    a = torch.rand(2, 37, 40, device="cuda", generator=gen).requires_grad_(True)
    b = torch.randn(2, 37, 40, device="cuda", generator=gen).requires_grad_(True)
    h0 = torch.randn(2, 40, device="cuda", generator=gen).requires_grad_(True)
    g = torch.randn(2, 37, 40, device="cuda", generator=gen)
    scan_ops.reset_launches()
    got = torch.autograd.grad(scan_ops.rglru_scan(a, b, h0), (a, b, h0), g)
    assert scan_ops.LAUNCHES == {"rglru_scan": 1, "rglru_scan_bwd": 1}
    want = torch.autograd.grad(rglru_scan_ref(a, b, h0), (a, b, h0), g)
    for x, w in zip(got, want):
        torch.testing.assert_close(x, w, atol=1e-5, rtol=1e-5)
    cfg = get_config("recurrentgemma-2b").reduced()
    n_rec = cfg.resolved_block_pattern.count("rglru")
    opt = adamw.AdamWConfig()
    params = M.init_params(cfg, device="cuda")
    state = {"params": params, "opt": adamw.init_opt_state(params, opt)}
    scan_ops.reset_launches()
    _, metrics = make_train_step(cfg, opt, device="cuda", remat=True)(
        state, {"tokens": torch.zeros(1, 12, dtype=torch.int64)})
    assert math.isfinite(float(metrics["loss"])) and math.isfinite(float(metrics["grad_norm"]))
    assert scan_ops.LAUNCHES == {"rglru_scan": 2 * n_rec, "rglru_scan_bwd": n_rec}
