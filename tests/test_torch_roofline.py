"""The port's model-FLOPs accounting against the JAX package's, on the CPU.

``repro_torch.roofline.param_counts`` and ``model_flops`` must give the
reference's floats exactly, for all ten architectures and every shape
cell; and, as ``tests/test_roofline.py`` holds the reference's counts to
its abstract parameters, ``param_counts`` must equal the number of weights
in the port's ``init_params`` at each reduced config: every matrix and
stacked expert tensor, with the vocabulary a multiple of 512 (so that the
padded rows are none) and without the norms, the biases and DeepSeek's MTP
head, which the analytic count leaves out.
"""

import dataclasses

import pytest

pytest.importorskip("torch")

from repro import roofline as jax_roofline  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models.config import SHAPES as JAX_SHAPES  # noqa: E402
from repro_torch import roofline  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, get_config  # noqa: E402
from repro_torch.models import model as M  # noqa: E402


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_and_model_flops_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert roofline.param_counts(cfg) == jax_roofline.param_counts(jcfg)
    assert roofline.param_counts(cfg.reduced()) == jax_roofline.param_counts(jcfg.reduced())
    assert set(SHAPES) == set(JAX_SHAPES)
    for name, shape in SHAPES.items():
        assert roofline.model_flops(cfg, shape) == jax_roofline.model_flops(jcfg,
                                                                            JAX_SHAPES[name])


def _weights(tree, top=None):
    """(top-level key, tensor) of every leaf of a parameter tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _weights(v, top or k)
    elif isinstance(tree, list):
        for v in tree:
            yield from _weights(v, top)
    else:
        yield top, tree


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_equal_the_ports_init_at_reduced_configs(arch):
    cfg = dataclasses.replace(get_config(arch).reduced(), vocab_size=512)
    assert cfg.padded_vocab == cfg.vocab_size
    params = M.init_params(cfg, seed=0, device="cpu")
    n = sum(t.numel() for top, t in _weights(params) if t.ndim >= 2 and top != "mtp")
    assert roofline.param_counts(cfg)["total"] == n


def test_qwen2_vl_counts():
    """qwen2-vl-72b: 72.7 G parameters at 80 layers; its first 32 layers
    (what one 80 GB card serves in bf16) 30.58 G."""
    cfg = get_config("qwen2-vl-72b")
    assert roofline.param_counts(cfg)["total"] == pytest.approx(72.7e9, rel=1e-3)
    cut = dataclasses.replace(cfg, n_layers=32)
    assert roofline.param_counts(cut)["total"] == pytest.approx(30.58e9, rel=1e-3)
