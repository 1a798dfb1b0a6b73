"""Shared by the port's parity tests: JAX-initialised weights with the
zero biases and unit norm scales perturbed, so those paths are compared."""
import numpy as np


def perturbed(tree, rng):
    """Numpy param tree with the zero biases and unit norm scales of a fresh
    init perturbed, so the bias and qk-norm paths are really compared."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = perturbed(v, rng)
        elif k in ("bq", "bk", "bv"):
            out[k] = (v + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        elif k in ("scale", "q_norm", "k_norm"):
            out[k] = (v * (1 + 0.1 * rng.standard_normal(v.shape))).astype(np.float32)
        else:
            out[k] = np.asarray(v, np.float32)
    return out


def perturbed_heads(tree, rng):
    """``perturbed``, and each Mamba2 head's ``A_log``, ``D`` and
    ``dt_bias`` drawn apart: a fresh init gives every head the same
    (zeros, ones, zeros), so a rank that took the wrong heads of them
    would compute the same numbers and go unseen."""
    return _heads_apart(perturbed(tree, rng), rng)


def _heads_apart(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _heads_apart(v, rng)
        elif k in ("A_log", "dt_bias"):
            out[k] = (v + 0.5 * rng.standard_normal(v.shape)).astype(np.float32)
        elif k == "D":
            out[k] = (v * (1 + 0.5 * rng.standard_normal(v.shape))).astype(np.float32)
        else:
            out[k] = v
    return out
