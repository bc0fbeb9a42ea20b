"""INT4 flat decode: parity with the bf16 flat path + engine e2e."""

import jax
import jax.numpy as jnp
import numpy as np

from kvzip_tpu.config import tiny_config
from kvzip_tpu.engine import Engine
from kvzip_tpu.ops.attention import flat_decode, flat_decode_int4
from kvzip_tpu.ops.quant import dequantize_int4, quantize_int4

CTX = ("Quantized flat caches stream packed nibbles. " * 25 +
       "The callsign is bluejay. " +
       "Padding sentences fill out the rest of the context. " * 25)


def test_int4_flat_kernel_matches_bf16_flat():
    rng = np.random.default_rng(0)
    Hkv, G, D, T = 2, 2, 128, 1
    H = Hkv * G
    R_pad, Tcap, tail_used = 64, 8, 2

    k_flat = rng.standard_normal((R_pad, D)).astype(np.float32)
    v_flat = rng.standard_normal((R_pad, D)).astype(np.float32)
    row_head = np.full((R_pad,), -1, np.int32)
    row_head[:20] = 0
    row_head[20:49] = 1
    k_tail = rng.standard_normal((Hkv, Tcap, D)).astype(np.float32)
    v_tail = rng.standard_normal((Hkv, Tcap, D)).astype(np.float32)
    q = jnp.asarray(rng.standard_normal((T, H, D)), jnp.float32)

    kq, ks, kz = quantize_int4(jnp.asarray(k_flat), pack="split")
    vq, vs, vz = quantize_int4(jnp.asarray(v_flat), pack="split")

    got = flat_decode_int4(
        q, kq.T, ks[:, 0], kz[:, 0], vq.T, vs[:, 0], vz[:, 0],
        jnp.asarray(row_head), jnp.asarray(k_tail), jnp.asarray(v_tail),
        jnp.asarray(tail_used, jnp.int32), scale=D ** -0.5)

    # reference: bf16 flat decode over the dequantized rows
    k_deq = dequantize_int4(kq, ks, kz, jnp.float32, pack="split")
    v_deq = dequantize_int4(vq, vs, vz, jnp.float32, pack="split")
    want = flat_decode(
        q, k_deq.T, v_deq, jnp.asarray(row_head), jnp.asarray(k_tail),
        jnp.asarray(v_tail), jnp.asarray(tail_used, jnp.int32),
        scale=D ** -0.5)

    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


def test_int4_flat_engine_end_to_end():
    cfg = tiny_config("llama", head_dim=128, num_heads=4, num_kv_heads=2,
                      hidden_size=128)
    eng = Engine("tiny-llama", kv_type="evict", config=cfg, dtype=jnp.float32,
                 max_new_tokens=6, decode_budget=256, capacity_granularity=256,
                 score_chunk_size=256, kv_quant="int4", flat_decode="legacy")
    st = eng.prefill(CTX, prefill_chunk_size=300)
    full_used = st.cache.used_bytes()
    eng.prune(st, 0.5, "pair")

    from kvzip_tpu.cache import FlatInt4KV

    assert isinstance(st.cache, FlatInt4KV)
    assert st.cache.used_bytes() < full_used

    out = eng.generate(eng.apply_template("What is the callsign?"), st)
    assert isinstance(out, str)
    assert int(jax.device_get(st.cache.tail_len)) == 0  # restored

    p = eng.prob(eng.apply_template("What is the callsign?"), st)
    np.testing.assert_allclose(p.sum(-1), 1.0, rtol=1e-4)


def test_stepped_build_matches_oneshot():
    """build_flat_int4_stepped (bounded-peak, donated per-array) produces
    exactly the same FlatInt4KV as the one-shot build_flat_int4."""
    import dataclasses

    from kvzip_tpu.cache import (build_flat_int4, build_flat_int4_stepped,
                                 init_int4_cache, append_layer_int4)
    from kvzip_tpu.config import tiny_config

    rng = np.random.default_rng(3)
    cfg = tiny_config("llama", head_dim=128, num_heads=4, num_kv_heads=2,
                      hidden_size=128)
    L, H, D = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    C, ctx, sink = 256, 100, 4
    cache = init_int4_cache(cfg, C, jnp.float32)
    # fill sink+ctx rows on every layer
    for l in range(L):
        k_new = jnp.asarray(rng.standard_normal((sink + ctx, H, D)),
                            jnp.float32)
        v_new = jnp.asarray(rng.standard_normal((sink + ctx, H, D)),
                            jnp.float32)
        layer = tuple(a[l] for a in (cache.k_q, cache.v_q, cache.k_s,
                                     cache.k_z, cache.v_s, cache.v_z))
        layer = append_layer_int4(layer, cache.lengths[l], k_new, v_new)
        cache = dataclasses.replace(
            cache,
            k_q=cache.k_q.at[l].set(layer[0]),
            v_q=cache.v_q.at[l].set(layer[1]),
            k_s=cache.k_s.at[l].set(layer[2]),
            k_z=cache.k_z.at[l].set(layer[3]),
            v_s=cache.v_s.at[l].set(layer[4]),
            v_z=cache.v_z.at[l].set(layer[5]))
    cache = dataclasses.replace(
        cache, lengths=cache.lengths + sink + ctx,
        seen=jnp.asarray(sink + ctx, jnp.int32))

    keep = jnp.asarray(rng.random((L, H, ctx)) > 0.5)
    r_pad = 256
    want = build_flat_int4(cache, keep, sink, r_pad, 16, jnp.float32)
    # deep-copy the dense cache: the stepped build donates its arrays
    cache2 = jax.tree.map(jnp.copy, cache)
    got = build_flat_int4_stepped(cache2, keep, sink, r_pad, 16, jnp.float32)

    for f in ("k_flat_q", "v_flat_q", "k_flat_s", "k_flat_z", "v_flat_s",
              "v_flat_z", "row_head", "lengths"):
        np.testing.assert_array_equal(
            np.asarray(getattr(got, f)), np.asarray(getattr(want, f)),
            err_msg=f)
