"""Regression tests for early review findings.

1. (high) Engine.scoring buffer: _place_scores writes a score_width-wide
   window at offsets that advance by score_chunk_size; when chunk < width the
   final writes exceeded round_up(ctx_len, width) and dynamic_slice clamped
   the start — corrupting earlier scores and zeroing the true tail.
2. (medium) FlatInt4KV fell through the FlatKV-only chunk-ladder restriction
   (long queries must take the evicted-cache ladder) and the one-shot
   re-prune guard.
3. (medium) the pool kernel's split count must stay a power of two, >= 1.
4. (low) w8a8 weight dicts crashed parallel._trim, so w8a8 + mesh failed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kvzip_tpu.config import tiny_config
from kvzip_tpu.engine import Engine, _place_scores, _round_up


def test_place_scores_geometry_no_clamp():
    """Mirror Engine.scoring's placement loop for geometries that used to
    clamp (ctx 2001 and the 131072 headline bench with chunk 2000/width 2048),
    using per-chunk sentinels."""
    for ctx_len, chunk, width in [(2001, 2000, 2048), (131072, 2000, 2048),
                                  (601, 100, 128)]:
        buf = jnp.zeros((1, 1, _round_up(ctx_len, width) + width), jnp.float32)
        expect = np.zeros(ctx_len, np.float32)
        off = 0
        i = 1.0
        while off < ctx_len:
            n = min(chunk, ctx_len - off)
            chunk_arr = jnp.full((1, 1, width), i, jnp.float32)
            buf = _place_scores(buf, chunk_arr,
                                jnp.asarray(off, jnp.int32),
                                jnp.asarray(n, jnp.int32))
            expect[off:off + n] = i
            off += n
            i += 1.0
        np.testing.assert_array_equal(
            np.asarray(jax.device_get(buf))[0, 0, :ctx_len], expect)


def test_scoring_tail_positions_scored():
    """End-to-end: chunk (100) < window width (128) with ctx_len 601 triggers
    the old clamp (offset 600 + 128 > 640); every position must get a strictly
    positive score (softmax probabilities are positive everywhere)."""
    cfg = tiny_config("llama")
    eng = Engine("tiny-llama", kv_type="retain", config=cfg,
                 dtype=jnp.float32, max_new_tokens=4, decode_budget=256,
                 capacity_granularity=256, score_chunk_size=100)
    ids = np.arange(601, dtype=np.int32) % (cfg.vocab_size - 2) + 1
    st = eng.prefill(ids, prefill_chunk_size=400)
    s = np.asarray(jax.device_get(st.score))
    assert s.shape[-1] == 601
    assert (s > 0).all(), f"zero-scored positions: {np.where(s.max((0, 1)) == 0)[0]}"


def test_int4_flat_long_query():
    """>=1024-token query against an int4 flat cache must route through the
    evicted-cache chunk ladder (<=64-token chunks)."""
    cfg = tiny_config("llama", head_dim=128, num_heads=4, num_kv_heads=2,
                      hidden_size=128)
    eng = Engine("tiny-llama", kv_type="evict", config=cfg, dtype=jnp.float32,
                 max_new_tokens=4, decode_budget=1152,
                 capacity_granularity=256, score_chunk_size=256,
                 kv_quant="int4", flat_decode="on")
    ids = np.arange(500, dtype=np.int32) % (cfg.vocab_size - 2) + 1
    st = eng.prefill(ids, prefill_chunk_size=300)
    eng.prune(st, 0.5, "pair")

    from kvzip_tpu.pool import PoolInt4KV
    assert isinstance(st.cache, PoolInt4KV)

    q = np.arange(1030, dtype=np.int32) % (cfg.vocab_size - 2) + 1
    out = eng.generate(q, st)
    assert isinstance(out, str)
    assert int(jax.device_get(st.cache.tail_len)) == 0  # restored

    # the one-shot re-prune guard must raise cleanly, not AttributeError
    with pytest.raises(RuntimeError, match="one-shot"):
        eng.prune(st, 0.3, "pair")


def test_pick_splits_power_of_two():
    """Pool kernel splits: a power of two, >= 1, never more than one key
    block per split on an even share of the rows (incl. H=28, T=64)."""
    from kvzip_tpu.ops.pool_decode import pick_splits

    for n_heads in (1, 4, 8):
        for q_tiles in (1, 2, 7):
            for max_rows in (128, 4096, 131072):
                ns = pick_splits(n_heads, q_tiles, max_rows, 64)
                assert ns >= 1 and ns & (ns - 1) == 0, (n_heads, ns)
                assert ns <= max(1, 2 * max_rows // (n_heads * 64))


@pytest.mark.skipif(len(jax.devices()) < 4, reason="needs >=4 devices")
def test_w8a8_with_mesh():
    from kvzip_tpu.parallel import make_mesh

    cfg = tiny_config("llama")
    mesh = make_mesh(4, tp=4)
    eng = Engine("tiny-llama", kv_type="retain", config=cfg,
                 dtype=jnp.float32, max_new_tokens=4, decode_budget=256,
                 capacity_granularity=256, score_chunk_size=256,
                 weight_quant="w8a8", mesh=mesh, seed=3)
    ref = Engine("tiny-llama", kv_type="retain", config=cfg,
                 dtype=jnp.float32, max_new_tokens=4, decode_budget=256,
                 capacity_granularity=256, score_chunk_size=256,
                 weight_quant="w8a8", mesh=None, seed=3)
    ids = np.arange(300, dtype=np.int32) % (cfg.vocab_size - 2) + 1
    st = eng.prefill(ids, prefill_chunk_size=200)
    st_ref = ref.prefill(ids, prefill_chunk_size=200)
    np.testing.assert_allclose(
        np.asarray(jax.device_get(st.score)),
        np.asarray(jax.device_get(st_ref.score)), rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------- round 4


def test_consumed_cache_sentinel_on_failed_pool_build(monkeypatch):
    """(low r4) A pool build that dies mid-way has already gutted the dense
    cache; state.cache must then raise a descriptive error, not NoneType."""
    from kvzip_tpu import engine as engine_mod
    from kvzip_tpu.pool import ConsumedCache

    cfg = tiny_config("llama")
    eng = Engine("tiny-llama", kv_type="evict", config=cfg,
                 dtype=jnp.float32, max_new_tokens=4, decode_budget=256,
                 capacity_granularity=256, score_chunk_size=256,
                 flat_decode="on", seed=0)
    ids = np.arange(200, dtype=np.int32) % (cfg.vocab_size - 2) + 1
    st = eng.prefill(ids, prefill_chunk_size=128)

    def boom(*a, **k):
        raise RuntimeError("synthetic OOM")

    import kvzip_tpu.pool as pool_mod
    monkeypatch.setattr(pool_mod, "build_pool_stepped", boom)
    with pytest.raises(RuntimeError, match="synthetic OOM"):
        eng.prune(st, 0.5, "pair")
    assert isinstance(st.cache, ConsumedCache)
    with pytest.raises(RuntimeError, match="consumed by a pool build"):
        _ = st.cache.k
    with pytest.raises(RuntimeError, match="re-run prefill"):
        st.cache.mem_bytes()


def test_merge_pool_rejects_mismatched_caches():
    """(low r4) _merge_pool must name the mismatch up front instead of
    failing deep inside a concatenate."""
    from kvzip_tpu.pool import synthetic_full_pool
    from kvzip_tpu.serving import _merge_pool

    a = synthetic_full_pool(2, 2, 128, per_head_rows=64, tail_cap=16,
                            int4=False, align=128)
    b = synthetic_full_pool(2, 2, 128, per_head_rows=64, tail_cap=32,
                            int4=False, align=128)
    with pytest.raises(ValueError, match="request 1 .*does not match"):
        _merge_pool([a, b])
