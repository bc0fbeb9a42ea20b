"""Gemma3 hybrid (sliding/static) engine pipeline: scoring only static
layers, sliding layers never pruned, retain-path forced (reference
`model/wrapper.py:74-76`), ring-buffered sliding layers at window-bound
memory (reference ``_sliding_update``, `attention/kvcache.py:402-447`)."""

import jax
import jax.numpy as jnp
import numpy as np

from kvzip_tpu.cache import HybridKV
from kvzip_tpu.config import tiny_config
from kvzip_tpu.engine import Engine

CTX = ("Hybrid attention mixes sliding and static layers. " * 25 +
       "The checkpoint name is osprey-nine. " +
       "Sliding windows cover recent tokens only. " * 25)


def make_engine():
    cfg = tiny_config("gemma3")
    return Engine("tiny-gemma3", kv_type="evict", config=cfg,
                  dtype=jnp.float32, max_new_tokens=6, decode_budget=256,
                  capacity_granularity=256, score_chunk_size=256)


def test_hybrid_forced_retain():
    eng = make_engine()
    assert eng.kv_type == "retain"  # evict request downgraded like reference


def test_hybrid_pipeline():
    eng = make_engine()
    cfg = eng.config
    state = eng.prefill(CTX, prefill_chunk_size=300)
    assert isinstance(state.cache, HybridKV)

    # scores exist for every layer but only static layers' values are used
    assert state.score.shape[0] == cfg.num_layers
    static = cfg.static_layer_ids
    assert 0 < len(static) < cfg.num_layers
    sliding_rows = np.asarray(jax.device_get(state.score))
    for l in range(cfg.num_layers):
        if l not in static:
            assert (sliding_rows[l] == 0).all(), f"sliding layer {l} scored"

    thres, true_ratio = eng.prune(state, 0.5, "pair")
    # valid covers static layers only; some context rows must be pruned
    valid = np.asarray(jax.device_get(state.cache.valid))
    assert valid.shape[0] == len(static)
    ctx_valid = valid[:, :, state.sink:state.prefill_len]
    assert not ctx_valid.all()

    out = eng.generate(eng.apply_template("What is the checkpoint name?"), state)
    assert isinstance(out, str)

    # restore leaves static lengths intact AND the ring contents restored
    # (ring writes are destructive — snapshot backs them up, like the
    # reference's sliding-layer clone, kvcache.py:503-518)
    lens_before = np.asarray(jax.device_get(state.cache.lengths)).copy()
    ring_before = np.asarray(jax.device_get(state.cache.ring_pos)).copy()
    eng.generate(eng.apply_template("Another question?"), state)
    np.testing.assert_array_equal(
        lens_before, np.asarray(jax.device_get(state.cache.lengths)))
    np.testing.assert_array_equal(
        ring_before, np.asarray(jax.device_get(state.cache.ring_pos)))


def test_hybrid_prune_ratio_accounts_static_only():
    eng = make_engine()
    state = eng.prefill(CTX, prefill_chunk_size=300)
    _, true_ratio = eng.prune(state, 0.4, "pair")
    # true_ratio is measured over static layers' scores only; should track 0.4
    assert 0.2 < true_ratio < 0.6


def test_hybrid_ring_memory_window_bound():
    """Sliding layers hold only ~window rows no matter the context length
    (round-1 kept full-capacity sliding buffers)."""
    cfg = tiny_config("gemma3")
    eng = make_engine()
    state = eng.prefill(CTX, prefill_chunk_size=300)
    cache = state.cache
    W = cache.window
    # 128-lane-rounded window, NOT capacity-sized
    assert W == max(128, -(-cfg.sliding_window // 128) * 128)
    assert W < cache.capacity
    L_s = cache.k_ring.shape[0]
    L_t = cache.k_static.shape[0]
    assert L_s + L_t == cfg.num_layers
    # ring bytes independent of capacity; static bytes scale with capacity
    ring_bytes = cache.k_ring.size * cache.k_ring.dtype.itemsize * 2
    assert ring_bytes == L_s * cfg.num_kv_heads * W * cfg.head_dim * 2 * \
        cache.k_ring.dtype.itemsize


def test_hybrid_ring_wraparound_matches_dense():
    """Logits parity: ring-buffered sliding attention == full-cache sliding
    attention (window masking) AFTER the ring has wrapped several times."""
    from kvzip_tpu.models.hybrid import forward_hybrid
    from kvzip_tpu.models.transformer import forward

    cfg = tiny_config("gemma3")
    total = 4 * 128 + 37  # > 4x the ring size (W=128): wraps several times

    eng_ring = make_engine()
    rng = np.random.default_rng(3)
    ids = rng.integers(1, cfg.vocab_size - 1, size=total).astype(np.int32)

    # ring path: engine prefill (hybrid cache)
    st = eng_ring.prefill(ids, prefill_chunk_size=50, do_score=False)
    assert int(jax.device_get(st.cache.ring_pos.max())) > 2 * 128  # wrapped

    # dense path: plain forward with full-capacity cache + window masking
    from kvzip_tpu.cache import init_cache
    dense = init_cache(cfg, 1024, jnp.float32)
    eng2 = Engine("tiny-gemma3", kv_type="retain", config=cfg,
                  dtype=jnp.float32, params=eng_ring.params,
                  tokenizer=eng_ring.tokenizer, max_new_tokens=6,
                  decode_budget=256, capacity_granularity=256,
                  score_chunk_size=256)

    q_ids = np.asarray([5, 7, 11], np.int32)
    logits_ring = forward_hybrid(
        eng_ring.params, cfg, jnp.asarray(q_ids), st.cache,
        collect_logits="all", attn_impl="dense").logits

    full_ids = np.concatenate([st.prefill_ids, q_ids])
    res = forward(eng2.params, cfg, jnp.asarray(full_ids), dense,
                  collect_logits="all", attn_impl="dense")
    logits_dense = res.logits[-3:]

    np.testing.assert_allclose(
        np.asarray(jax.device_get(logits_ring)),
        np.asarray(jax.device_get(logits_dense)), rtol=0, atol=2e-3)
