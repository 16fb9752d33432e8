"""The port's primitive layers against the JAX package's, on the CPU, in f32.

Inputs are made with numpy from a seed.  Tolerance 1e-6: the same f32
arithmetic in both, up to the order of sums and the last bit of sin, cos
and pow.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jax_layers
from repro_torch.models import layers

TOL = 1e-6


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def test_rms_norm_matches_jax():
    x, scale = _arrays(0, (2, 5, 64), (64,))
    out = layers.rms_norm(torch.from_numpy(x), torch.from_numpy(scale))
    ref = jax_layers.rms_norm(jnp.asarray(x), jnp.asarray(scale))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_matches_jax(theta):
    (x,) = _arrays(1, (2, 7, 4, 16))
    positions = np.stack([np.arange(7), np.arange(100, 107)]).astype(np.int32)
    out = layers.rope(torch.from_numpy(x), torch.from_numpy(positions), theta)
    ref = jax_layers.rope(jnp.asarray(x), jnp.asarray(positions), theta)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)


def test_swiglu_mlp_matches_jax():
    x, wg, wu, wo = _arrays(2, (2, 5, 64), (64, 96), (64, 96), (96, 64))
    wg, wu, wo = wg / 8, wu / 8, wo / 10  # fan-in scale: outputs of order 1
    p = {"wg": wg, "wu": wu, "wo": wo}
    out = layers.mlp_apply({k: torch.from_numpy(v) for k, v in p.items()},
                           torch.from_numpy(x), "swiglu")
    ref = jax_layers.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                               jnp.asarray(x), "swiglu")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)
