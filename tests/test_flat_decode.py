"""Flat compacted decode cache: decode parity + end-to-end engine path."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kvzip_tpu.cache import build_flat, init_cache
from kvzip_tpu.config import tiny_config
from kvzip_tpu.engine import Engine
from kvzip_tpu.ops.attention import attend_dense, flat_decode

CTX = ("Flat decode caches read only live rows. " * 30 +
       "The hidden token is marmalade. " +
       "Some extra trailing filler for realistic lengths. " * 25)


@pytest.mark.parametrize("T", [1, 4])
def test_flat_kernel_matches_dense(T):
    """Dense cache with per-head lengths vs its flat rebuild + tail."""
    rng = np.random.default_rng(0)
    Hkv, G, D, C = 2, 3, 8, 32
    H = Hkv * G
    lens = np.asarray([10, 17])
    tail_cap, tail_used = 8, 3

    k = rng.standard_normal((Hkv, C, D)).astype(np.float32)
    v = rng.standard_normal((Hkv, C, D)).astype(np.float32)

    # dense ground truth: per-head rows [0, lens[h]) + tail rows appended
    k_dense = np.zeros((Hkv, C + tail_cap, D), np.float32)
    v_dense = np.zeros((Hkv, C + tail_cap, D), np.float32)
    k_tail = rng.standard_normal((Hkv, tail_cap, D)).astype(np.float32)
    v_tail = rng.standard_normal((Hkv, tail_cap, D)).astype(np.float32)
    base = []
    for h in range(Hkv):
        k_dense[h, :lens[h]] = k[h, :lens[h]]
        v_dense[h, :lens[h]] = v[h, :lens[h]]
        k_dense[h, lens[h]:lens[h] + tail_used + T] = k_tail[h, :tail_used + T]
        v_dense[h, lens[h]:lens[h] + tail_used + T] = v_tail[h, :tail_used + T]
        base.append(lens[h] + tail_used)

    q = jnp.asarray(rng.standard_normal((T, H, D)), jnp.float32)
    want = attend_dense(q, jnp.asarray(k_dense), jnp.asarray(v_dense),
                        jnp.asarray(base, jnp.int32), None, scale=D ** -0.5)

    # flat layout: concatenated kept rows + head ids, padded
    R_pad = 32
    k_flat = np.zeros((R_pad, D), np.float32)
    v_flat = np.zeros((R_pad, D), np.float32)
    row_head = np.full((R_pad,), -1, np.int32)
    r = 0
    for h in range(Hkv):
        k_flat[r:r + lens[h]] = k[h, :lens[h]]
        v_flat[r:r + lens[h]] = v[h, :lens[h]]
        row_head[r:r + lens[h]] = h
        r += lens[h]

    got = flat_decode(
        q, jnp.asarray(k_flat.T), jnp.asarray(v_flat), jnp.asarray(row_head),
        jnp.asarray(k_tail), jnp.asarray(v_tail),
        jnp.asarray(tail_used, jnp.int32), scale=D ** -0.5)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


def test_build_flat_structure():
    cfg = tiny_config("llama")
    cache = init_cache(cfg, 64, jnp.float32)
    L, H = cfg.num_layers, cfg.num_kv_heads
    rng = np.random.default_rng(1)
    k = jnp.asarray(rng.standard_normal(cache.k.shape), jnp.float32)
    cache = dataclasses.replace(
        cache, k=k, lengths=jnp.full((L, H), 40, jnp.int32),
        seen=jnp.asarray(40, jnp.int32))

    sink, ctx_len = 4, 36
    keep = jnp.asarray(rng.random((L, H, ctx_len)) > 0.5)
    flat = build_flat(cache, keep, sink, r_pad=192, tail_cap=8)

    lens = np.asarray(jax.device_get(flat.lengths))
    want_lens = np.asarray(jax.device_get(keep)).sum(-1) + sink
    np.testing.assert_array_equal(lens, want_lens)

    rh = np.asarray(jax.device_get(flat.row_head))
    kf = np.asarray(jax.device_get(flat.k_flat))
    k_np = np.asarray(jax.device_get(cache.k))
    keep_np = np.asarray(jax.device_get(keep))
    for l in range(L):
        r = 0
        for h in range(H):
            kept_rows = [j for j in range(sink + ctx_len)
                         if j < sink or keep_np[l, h, j - sink]]
            for j in kept_rows:
                assert rh[l, r] == h
                np.testing.assert_allclose(kf[l, :, r], k_np[l, h, j])
                r += 1
        assert (rh[l, r:] == -1).all()


def test_flatten_full_matches_dense():
    """Full-cache flat view (honest baseline) ≡ dense full-cache decode."""
    cfg = tiny_config("llama", head_dim=128, num_heads=4, num_kv_heads=2,
                      hidden_size=128)
    eng = Engine("tiny-llama", kv_type="evict", config=cfg, dtype=jnp.float32,
                 max_new_tokens=6, decode_budget=256, capacity_granularity=256,
                 score_chunk_size=256, flat_decode="on")
    st = eng.prefill(CTX, prefill_chunk_size=300, do_score=False)
    st_full = eng.flatten_full(st)

    from kvzip_tpu.cache import FlatKV

    assert isinstance(st_full.cache, FlatKV)
    # all rows live: per-head lengths = sink + ctx_len
    np.testing.assert_array_equal(
        np.asarray(jax.device_get(st_full.cache.lengths)),
        st.sink + st.ctx_len)

    q = eng.apply_template("What is the hidden token?")
    p_dense = eng.prob(q, st)
    p_flat = eng.prob(q, st_full)
    np.testing.assert_allclose(p_flat, p_dense, atol=3e-3, rtol=0)


def test_flat_engine_end_to_end():
    # "legacy" pins the round-3 uniform-r_pad layout (still used by batched
    # serving); the default "on" path now builds the pool (tests/test_pool.py)
    cfg = tiny_config("llama", head_dim=128, num_heads=4, num_kv_heads=2,
                      hidden_size=128)
    eng = Engine("tiny-llama", kv_type="evict", config=cfg, dtype=jnp.float32,
                 max_new_tokens=6, decode_budget=256, capacity_granularity=256,
                 score_chunk_size=256, flat_decode="legacy")
    eng_ref = Engine("tiny-llama", kv_type="evict", config=cfg,
                     dtype=jnp.float32, max_new_tokens=6, decode_budget=256,
                     capacity_granularity=256, score_chunk_size=256,
                     flat_decode="off")

    st = eng.prefill(CTX, prefill_chunk_size=300)
    st_ref = eng_ref.prefill(CTX, prefill_chunk_size=300)

    eng.prune(st, 0.5, "pair")
    eng_ref.prune(st_ref, 0.5, "pair")
    from kvzip_tpu.cache import FlatKV

    assert isinstance(st.cache, FlatKV)
    np.testing.assert_array_equal(
        np.asarray(jax.device_get(st.cache.lengths)),
        np.asarray(jax.device_get(st_ref.cache.lengths)))

    q = eng.apply_template("What is the hidden token?")
    p = eng.prob(q, st)
    p_ref = eng_ref.prob(q, st_ref)
    np.testing.assert_allclose(p, p_ref, atol=3e-3, rtol=0)

    # O(1) restore: tail resets after generate
    out = eng.generate(q, st)
    assert isinstance(out, str)
    assert int(jax.device_get(st.cache.tail_len)) == 0
