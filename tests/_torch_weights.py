"""Weights for the port's parity tests, made from a seed with numpy in the
JAX package's layouts (no JAX random init runs, which keeps the tests
cheap on the CPU)."""

import jax
import jax.numpy as jnp
import numpy as np


def mtcnn_params(spec, seed):
    """det*.npy-layout params with the JAX init's weight distribution, and
    small random biases and alphas so that both are exercised."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, kind, shape in spec:
        if kind == "prelu":
            out[name] = {"alpha": rng.uniform(0.1, 0.4, shape).astype(np.float32)}
        else:
            fan_in = int(np.prod(shape[:-1]))
            out[name] = {
                "weights": (rng.normal(size=shape) / np.sqrt(fan_in)).astype(
                    np.float32),
                "biases": (rng.normal(size=shape[-1]) * 0.1).astype(np.float32)}
    return out


def flax_params(model, hw, seed):
    """A flax params tree for ``model`` at input ``hw`` filled from numpy
    (lecun-scaled normal kernels, small biases); the tree's shape comes
    from ``jax.eval_shape`` so no JAX random init runs."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, hw, hw, 1), jnp.float32))["params"]
    rng = np.random.default_rng(seed)

    def fill(s):
        if len(s.shape) == 1:
            return (rng.normal(size=s.shape) * 0.01).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1]))
        return (rng.normal(size=s.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map(fill, shapes)
