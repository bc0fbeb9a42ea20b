"""Windowed scoring attention (`ops/attention.py::windowed_scoring_attend`)
against dense attention over the same key set.

In windowed mode the repeat queries attend [sink ∥ scored window ∥ repeat]
only; with the window cut to its true length that is exactly causal
attention over one compacted key list, which `attend_dense` computes
independently. Checked at multi-window shapes: every chunk but the last
fills the static window, the last is partial."""

import jax.numpy as jnp
import numpy as np
import pytest

from kvzip_tpu.ops.attention import attend_dense, windowed_scoring_attend


def _mk(rng, *shape, dtype=jnp.float32):
    return jnp.asarray(rng.standard_normal(shape) * 0.5, dtype)


def _dense(q, k_sink, k_ctx, k_rep, v_sink, v_ctx, v_rep, ctx_len):
    keys = jnp.concatenate(
        [k_sink, k_ctx[:, :ctx_len], jnp.swapaxes(k_rep, 0, 1)], axis=1)
    vals = jnp.concatenate(
        [v_sink, v_ctx[:, :ctx_len], jnp.swapaxes(v_rep, 0, 1)], axis=1)
    base = jnp.full((keys.shape[0],), k_sink.shape[1] + ctx_len, jnp.int32)
    return attend_dense(q, keys, vals, base, None, scale=q.shape[-1] ** -0.5)


@pytest.mark.parametrize("ctx_len", [48, 33, 1])
@pytest.mark.parametrize("sink", [8, 3])
def test_windowed_matches_dense_oracle(ctx_len, sink):
    rng = np.random.default_rng(0)
    T, Hkv, G, D = 64, 2, 2, 128
    H = Hkv * G
    S_ctx = 48
    q = _mk(rng, T, H, D)
    k_sink, v_sink = _mk(rng, Hkv, sink, D), _mk(rng, Hkv, sink, D)
    k_ctx, v_ctx = _mk(rng, Hkv, S_ctx, D), _mk(rng, Hkv, S_ctx, D)
    k_rep, v_rep = _mk(rng, T, Hkv, D), _mk(rng, T, Hkv, D)

    got = windowed_scoring_attend(
        q, k_sink, k_ctx, k_rep, v_sink, v_ctx, v_rep,
        jnp.asarray(ctx_len, jnp.int32), scale=D ** -0.5,
        out_dtype=jnp.float32)
    want = _dense(q, k_sink, k_ctx, k_rep, v_sink, v_ctx, v_rep, ctx_len)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=0, atol=2e-5)


def test_windowed_bf16_matches_dense_oracle():
    """bf16 in/out (the production dtype): agreement within bf16 rounding."""
    rng = np.random.default_rng(1)
    T, Hkv, G, D = 32, 1, 4, 128
    bf = jnp.bfloat16
    q = _mk(rng, T, Hkv * G, D, dtype=bf)
    ks, vs = _mk(rng, Hkv, 4, D, dtype=bf), _mk(rng, Hkv, 4, D, dtype=bf)
    kc, vc = _mk(rng, Hkv, 32, D, dtype=bf), _mk(rng, Hkv, 32, D, dtype=bf)
    kr, vr = _mk(rng, T, Hkv, D, dtype=bf), _mk(rng, T, Hkv, D, dtype=bf)
    got = windowed_scoring_attend(q, ks, kc, kr, vs, vc, vr,
                                  jnp.asarray(20, jnp.int32),
                                  scale=D ** -0.5)
    want = _dense(q, ks, kc, kr, vs, vc, vr, 20)
    np.testing.assert_allclose(
        np.asarray(got, np.float32), np.asarray(want, np.float32),
        rtol=0, atol=2e-2)
