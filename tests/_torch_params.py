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
