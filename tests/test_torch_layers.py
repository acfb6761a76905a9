"""ops/layers.py of the port against the JAX package: the same numpy inputs
through both, f32, atol 1e-6 (both compute in f32; the residue is
summation order in the norms and transcendental rounding in RoPE)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pipeinfer_tpu.ops import layers as JL
from pipeinfer_tpu_torch.ops import layers as TL

ATOL = 1e-6


def _both(a):
    return jnp.asarray(a), torch.from_numpy(np.ascontiguousarray(a))


def test_rms_norm(rng):
    x = rng.standard_normal((7, 256)).astype(np.float32)
    w = rng.standard_normal(256).astype(np.float32)
    (xj, xt), (wj, wt) = _both(x), _both(w)
    np.testing.assert_allclose(TL.rms_norm(xt, wt, 1e-5).numpy(),
                               np.asarray(JL.rms_norm(xj, wj, 1e-5)), atol=ATOL, rtol=0)


@pytest.mark.parametrize("with_bias", [False, True])
def test_layer_norm(rng, with_bias):
    x = rng.standard_normal((5, 128)).astype(np.float32)
    w = rng.standard_normal(128).astype(np.float32)
    b = rng.standard_normal(128).astype(np.float32) if with_bias else None
    want = JL.layer_norm(jnp.asarray(x), jnp.asarray(w),
                         None if b is None else jnp.asarray(b), 1e-5)
    got = TL.layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                        None if b is None else torch.from_numpy(b), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_silu(rng):
    x = rng.standard_normal((4, 64)).astype(np.float32) * 4
    np.testing.assert_allclose(TL.silu(torch.from_numpy(x)).numpy(),
                               np.asarray(JL.silu(jnp.asarray(x))), atol=ATOL, rtol=0)


ROPE_CASES = {
    "norm": dict(mode="norm"),
    "neox": dict(mode="neox"),
    "norm_partial_dims": dict(mode="norm", n_dims=32),
    "linear_scale": dict(mode="norm", freq_scale=0.25, freq_base=500000.0),
    "yarn": dict(mode="neox", freq_scale=0.25, yarn_ext_factor=1.0, yarn_attn_factor=1.0,
                 n_orig_ctx=2048),
}


@pytest.mark.parametrize("case", list(ROPE_CASES))
def test_apply_rope(rng, case):
    kw = dict(ROPE_CASES[case])
    n_dims = kw.pop("n_dims", None)
    x = rng.standard_normal((6, 4, 64)).astype(np.float32)
    # positions across a 1024-cell pool (the main path's pool size); the
    # two libraries' cos/sin differ by an ulp of the angle, which grows
    # with position (at 3000 it reaches 1.01e-6)
    pos = np.array([0, 1, 7, 100, 511, 1023], np.int32)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), n_dims, **kw)
    got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), n_dims, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
