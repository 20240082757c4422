"""Random Flax variable trees for the port's parity tests (test_torch_*.py).

``random_variables(module.init, *args)`` traces ``init`` with
``jax.eval_shape`` and fills every leaf with seeded numpy values, so the
tests get full-size trees without running, or compiling, the JAX package's
orthogonal initializers (their QR decompositions dominate a test's compile
time at these sizes). No leaf sits at an init value (zero bias, unit BN
statistics), so a tensor the bridge maps to the wrong place cannot hide:

    kernel, recurrent_kernel   ~ N(0, 1/fan_in)
    scale (BatchNorm)          ~ 1 + N(0, 0.1²)
    var   (BatchNorm)          ~ U(0.5, 1.5)
    bias, mean, other leaves   ~ N(0, 0.1²)
"""

import functools

import jax
import numpy as np


def random_variables(init, *args, seed: int, **kwargs):
    shapes = jax.eval_shape(functools.partial(init, **kwargs), jax.random.key(0), *args)
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name in ("kernel", "recurrent_kernel"):
            x = rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif name == "scale":
            x = 1.0 + 0.1 * rng.standard_normal(s.shape)
        elif name == "var":
            x = rng.uniform(0.5, 1.5, s.shape)
        else:
            x = 0.1 * rng.standard_normal(s.shape)
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)
