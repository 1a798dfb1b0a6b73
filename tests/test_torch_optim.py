"""The port's AdamW (``repro_torch.runtime.optimizer``) against the JAX
package's on the same parameters, grads and state (numpy in, fp32, 1e-6):
global-norm clipping that binds and that does not, two consecutive steps
(bias corrections at t = 1 and 2), and the rank rule for weight decay
(stacked ``(L, D)`` norm scales and ``(L, H, hd)`` biases are decayed, an
unstacked ``final_norm.scale`` is not)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import optimizer as jopt
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.runtime import optimizer as topt

TOL = 1e-6


def _tree(rng, scale=1.0):
    """A parameter-shaped tree: stacked block leaves of rank 2 and 3, an
    embedding, and an unstacked norm scale."""
    shapes = {
        "embed": {"tok": (64, 16)},
        "blocks": {"ln1": {"scale": (3, 16)},
                   "attn": {"wq": (3, 16, 4, 8), "bq": (3, 4, 8)}},
        "final_norm": {"scale": (16,)},
    }

    def make(s):
        if isinstance(s, dict):
            return {k: make(v) for k, v in s.items()}
        return (scale * rng.standard_normal(s)).astype(np.float32)

    return make(shapes)


def _torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)), tree)


def _close(t_tree, j_tree, tol=TOL):
    flat_t = tree_leaves(t_tree)
    flat_j = tree_leaves(jax.tree.map(np.asarray, j_tree))
    assert len(flat_t) == len(flat_j)
    for a, b in zip(flat_t, flat_j):
        np.testing.assert_allclose(a.numpy(), b, atol=tol, rtol=tol)


@pytest.mark.parametrize("grad_scale,clip", [
    (10.0, 1.0),        # gnorm >> 1: the clip binds
    (1e-3, 1.0),        # gnorm << 1: it does not
    (1.0, 0.0),         # clipping off
])
def test_two_adamw_steps_match_jax(grad_scale, clip):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    grads = [_tree(rng, grad_scale), _tree(rng, grad_scale)]
    jcfg = jopt.AdamWConfig(lr=1e-2, grad_clip=clip)
    tcfg = topt.AdamWConfig(lr=1e-2, grad_clip=clip)
    jp, js = jax.tree.map(jnp.asarray, params), jopt.adamw_init(params, jcfg)
    tp = _torch(params)
    ts = topt.adamw_init(tp, tcfg)
    for g in grads:
        jp, js, jstats = jopt.adamw_update(jp, jax.tree.map(jnp.asarray, g), js, jcfg)
        tp, ts, tstats = topt.adamw_update(tp, _torch(g), ts, tcfg)
        np.testing.assert_allclose(float(tstats["grad_norm"]), float(jstats["grad_norm"]),
                                   rtol=TOL)
        assert int(ts.step) == int(js.step) and ts.step.dtype == torch.int32
        _close(tp, jp)
        _close(ts.m, js.m)
        _close(ts.v, js.v)
    if clip:
        binds = float(tstats["grad_norm"]) > clip
        assert binds == (grad_scale > 1.0)


def test_weight_decay_follows_rank_as_in_jax():
    """Zero grads: the update is decay alone.  Every leaf of rank >= 2 moves
    by lr·wd·p, including the stacked norm scales (L, D) and biases
    (L, H, hd); the rank-1 final norm scale does not move."""
    rng = np.random.default_rng(1)
    params = _tree(rng)
    zeros = tree_map(np.zeros_like, params)
    cfg = topt.AdamWConfig(lr=1e-2, weight_decay=0.1)
    tp = _torch(params)
    new, _, _ = topt.adamw_update(tp, _torch(zeros), topt.adamw_init(tp, cfg), cfg)
    jnew, _, _ = jopt.adamw_update(jax.tree.map(jnp.asarray, params),
                                   jax.tree.map(jnp.asarray, zeros),
                                   jopt.adamw_init(params, jopt.AdamWConfig(lr=1e-2)),
                                   jopt.AdamWConfig(lr=1e-2))
    _close(new, jnew)
    decayed = lambda p: p * (1 - cfg.lr * cfg.weight_decay)
    for path in (("blocks", "ln1", "scale"), ("blocks", "attn", "bq"),
                 ("blocks", "attn", "wq"), ("embed", "tok")):
        a, b = new, params
        for k in path:
            a, b = a[k], b[k]
        np.testing.assert_allclose(a.numpy(), decayed(b), rtol=1e-6)
    np.testing.assert_array_equal(new["final_norm"]["scale"].numpy(),
                                  params["final_norm"]["scale"])


def test_update_leaves_its_inputs_untouched():
    rng = np.random.default_rng(2)
    cfg = topt.AdamWConfig()
    tp, tg = _torch(_tree(rng)), _torch(_tree(rng))
    before = [x.clone() for x in tree_leaves(tp) + tree_leaves(tg)]
    state = topt.adamw_init(tp, cfg)
    topt.adamw_update(tp, tg, state, cfg)
    after = tree_leaves(tp) + tree_leaves(tg)
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert int(state.step) == 0 and all(float(x.abs().sum()) == 0 for x in tree_leaves(state.m))


def test_global_norm_matches_jax():
    tree = _tree(np.random.default_rng(3), 2.0)
    np.testing.assert_allclose(float(topt.global_norm(_torch(tree))),
                               float(jopt.global_norm(jax.tree.map(jnp.asarray, tree))),
                               rtol=TOL)
