"""What the training parity tests share: the reference's reduced-config
parameters as numpy trees (norm scales and biases drawn from a numpy seed),
token batches, and a leaf-by-leaf comparison of a port tree with a
reference tree."""

import functools

import jax
import numpy as np

from repro.configs import get_config as jax_get_config
from repro.models import model as jax_model
from repro_torch._tree import leaves_with_path
from repro_torch.configs import get_config
from repro_torch.models.convert import params_from_jax

TOL = dict(atol=1e-5, rtol=1e-5)
B = 2


@functools.cache
def tree(name, seed=0):
    """(jax cfg, port cfg, numpy parameters) of a reduced arch; callers copy
    what they change."""
    jcfg, cfg = jax_get_config(name).reduced(), get_config(name).reduced()
    rng = np.random.default_rng(seed)
    init = jax.jit(lambda key: jax_model.init_params(key, jcfg))
    tree = jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed)))

    def perturb(path, a):
        key = jax.tree_util.keystr(path)
        if "norm" in key or "'b'" in key:
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return jcfg, cfg, jax.tree_util.tree_map_with_path(perturb, tree)


def tokens(cfg, S, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)


def close_trees(port, ref_np, cfg, rel=None, zero=lambda path: False):
    """Every leaf of the port's tree against the reference's (numpy, stacked).
    A leaf where ``zero(path)`` holds is a gradient that is exactly 0 (both
    sides rounding noise): each side within ``rel`` of the tree's largest
    leaf."""
    want = dict(leaves_with_path(params_from_jax(ref_np, cfg, device="cpu")))
    got = dict(leaves_with_path(port))
    assert got.keys() == want.keys()
    largest = max(float(w.abs().max()) for w in want.values())
    for path, g in got.items():
        w = want[path].numpy()
        if zero(path):
            assert max(float(np.abs(w).max()), float(g.detach().abs().max())) <= rel * largest, path
        elif rel is None:
            np.testing.assert_allclose(g.detach().numpy(), w, **TOL, err_msg=str(path))
        else:
            scale = max(float(np.abs(w).max()), 1e-30)
            np.testing.assert_allclose(g.detach().numpy(), w, rtol=rel, atol=rel * scale,
                                       err_msg=str(path))
