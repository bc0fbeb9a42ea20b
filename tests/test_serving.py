"""Batched decode matches sequential decode (same contexts, same queries)."""

import jax.numpy as jnp
import numpy as np

from kvzip_tpu.config import tiny_config
from kvzip_tpu.engine import Engine
from kvzip_tpu.prune import prune_mask
from kvzip_tpu.serving import batched_generate

CTXS = [
    "The first context hides the word falcon inside filler. " * 20,
    "A second, different context mentions the number 7188 often. " * 22,
]


def test_batched_matches_sequential():
    cfg = tiny_config("llama")
    eng = Engine("tiny-llama", kv_type="retain", config=cfg, dtype=jnp.float32,
                 max_new_tokens=6, decode_budget=256, capacity_granularity=256,
                 score_chunk_size=256, attn_impl="blockwise")

    states = [eng.prefill(c, prefill_chunk_size=300) for c in CTXS]
    for st in states:
        eng.prune(st, 0.6, "pair")
    queries = [eng.apply_template("What word is hidden?"),
               eng.apply_template("Which number appears?")]

    seq_out = [eng.generate(q, st) for q, st in zip(queries, states)]
    bat_out = batched_generate(eng, queries, states, max_new_tokens=6)
    assert bat_out == seq_out

    # caches restored for reuse
    for st in states:
        out2 = eng.generate(queries[0], st)
        assert isinstance(out2, str)


def test_scheduler_mixed_cache_types():
    """The scheduler groups compatible cache types and preserves request
    order: dense retain + flat evict states in one queue."""
    from kvzip_tpu.serving import Scheduler

    cfg = tiny_config("llama", head_dim=128, num_heads=4, num_kv_heads=2,
                      hidden_size=128)
    eng_r = Engine("tiny-llama", kv_type="retain", config=cfg,
                   dtype=jnp.float32, max_new_tokens=5, decode_budget=256,
                   capacity_granularity=256, score_chunk_size=256)
    eng_e = Engine("tiny-llama", kv_type="evict", config=cfg,
                   dtype=jnp.float32, params=eng_r.params,
                   tokenizer=eng_r.tokenizer, max_new_tokens=5,
                   decode_budget=256, capacity_granularity=256,
                   score_chunk_size=256, flat_decode="legacy")

    st_r = eng_r.prefill(CTXS[0], prefill_chunk_size=300)
    eng_r.prune(st_r, 0.5, "pair")
    st_e1 = eng_e.prefill(CTXS[0], prefill_chunk_size=300)
    eng_e.prune(st_e1, 0.5, "pair")
    st_e2 = eng_e.prefill(CTXS[1], prefill_chunk_size=300)
    eng_e.prune(st_e2, 0.5, "pair")

    q = eng_r.apply_template("What word is hidden?")
    want = [eng_e.generate(q, st_e1), eng_r.generate(q, st_r),
            eng_e.generate(q, st_e2)]

    sched = Scheduler(eng_e, max_batch=4)
    sched.submit(q, st_e1)
    sched.submit(q, st_r)
    sched.submit(q, st_e2)
    got = sched.run()
    assert got == want


def test_batched_flat_matches_sequential():
    """Flat (evicted) contexts decode batched through the merged flat
    layout — parity vs sequential single-stream decode."""
    cfg = tiny_config("llama", head_dim=128, num_heads=4, num_kv_heads=2,
                      hidden_size=128)
    eng = Engine("tiny-llama", kv_type="evict", config=cfg, dtype=jnp.float32,
                 max_new_tokens=5, decode_budget=256, capacity_granularity=256,
                 score_chunk_size=256, flat_decode="legacy")

    ctxs = CTXS + ["A third context about the color vermilion. " * 21]
    states = [eng.prefill(c, prefill_chunk_size=300) for c in ctxs]
    for st, r in zip(states, (0.5, 0.4, 0.6)):  # distinct ratios -> r_pads
        eng.prune(st, r, "pair")

    from kvzip_tpu.cache import FlatKV
    assert all(isinstance(st.cache, FlatKV) for st in states)

    queries = [eng.apply_template("What word is hidden?"),
               eng.apply_template("Which number appears?"),
               eng.apply_template("Which color is named?")]
    seq_out = [eng.generate(q, st) for q, st in zip(queries, states)]
    bat_out = batched_generate(eng, queries, states, max_new_tokens=5)
    assert bat_out == seq_out
    # tails restored after the batched run
    import jax
    for st in states:
        assert int(jax.device_get(st.cache.tail_len)) == 0


def test_batched_flat_w4a8_matches_sequential():
    """Fused-W4A8 weights through the merged batched decode (the stacked
    weight dicts stay out of the layer scan; layer selected by scalar)."""
    cfg = tiny_config("llama", head_dim=128, num_heads=4, num_kv_heads=2,
                      hidden_size=128)
    eng = Engine("tiny-llama", kv_type="evict", config=cfg,
                 dtype=jnp.float32, max_new_tokens=5, decode_budget=256,
                 capacity_granularity=256, score_chunk_size=256,
                 flat_decode="legacy", weight_quant="w4a8")
    assert "wqkv" in eng.params["layers"]

    states = [eng.prefill(c, prefill_chunk_size=300) for c in CTXS]
    for st, r in zip(states, (0.5, 0.6)):
        eng.prune(st, r, "pair")
    queries = [eng.apply_template("What word is hidden?"),
               eng.apply_template("Which number appears?")]
    seq_out = [eng.generate(q, st) for q, st in zip(queries, states)]
    bat_out = batched_generate(eng, queries, states, max_new_tokens=5)
    assert bat_out == seq_out


def test_batched_pool_matches_sequential():
    """POOL (the default evict layout since round 4) contexts batch through
    the merged-pool path: every request's live layer rows concatenate with
    no inter-request padding, head ids shift to b*Hkv+h, one kernel launch
    per step serves the batch. Parity vs sequential decode."""
    cfg = tiny_config("llama", head_dim=128, num_heads=4, num_kv_heads=2,
                      hidden_size=128)
    eng = Engine("tiny-llama", kv_type="evict", config=cfg, dtype=jnp.float32,
                 max_new_tokens=5, decode_budget=256, capacity_granularity=256,
                 score_chunk_size=256, flat_decode="on")

    ctxs = CTXS + ["A third context about the color vermilion. " * 21]
    states = [eng.prefill(c, prefill_chunk_size=300) for c in ctxs]
    for st, r in zip(states, (0.5, 0.4, 0.6)):  # distinct pool geometries
        eng.prune(st, r, "pair")

    from kvzip_tpu.pool import PoolKV
    assert all(isinstance(st.cache, PoolKV) for st in states)

    queries = [eng.apply_template("What word is hidden?"),
               eng.apply_template("Which number appears?"),
               eng.apply_template("Which color is named?")]
    seq_out = [eng.generate(q, st) for q, st in zip(queries, states)]
    bat_out = batched_generate(eng, queries, states, max_new_tokens=5)
    assert bat_out == seq_out
    import jax
    for st in states:
        assert int(jax.device_get(st.cache.tail_len)) == 0


def test_batched_pool_int4_matches_sequential():
    """Merged-pool batching on the INT4 pool (quantized scales/zeros merge
    with the nibble columns)."""
    cfg = tiny_config("llama", head_dim=128, num_heads=4, num_kv_heads=2,
                      hidden_size=128)
    eng = Engine("tiny-llama", kv_type="evict", config=cfg, dtype=jnp.float32,
                 max_new_tokens=5, decode_budget=256, capacity_granularity=256,
                 score_chunk_size=256, flat_decode="on", kv_quant="int4")

    states = [eng.prefill(c, prefill_chunk_size=300) for c in CTXS]
    for st, r in zip(states, (0.5, 0.6)):
        eng.prune(st, r, "pair")

    from kvzip_tpu.pool import PoolInt4KV
    assert all(isinstance(st.cache, PoolInt4KV) for st in states)

    queries = [eng.apply_template("What word is hidden?"),
               eng.apply_template("Which number appears?")]
    seq_out = [eng.generate(q, st) for q, st in zip(queries, states)]
    bat_out = batched_generate(eng, queries, states, max_new_tokens=5)
    assert bat_out == seq_out


def test_batched_pool_mixed_aligns():
    """Requests whose pools were built at DIFFERENT aligns (a pool saved by
    another build, or built with another ``align``) merge at the max align
    with replanned offsets — parity vs sequential decode."""
    import jax

    cfg = tiny_config("llama", head_dim=128, num_heads=4, num_kv_heads=2,
                      hidden_size=128)
    eng = Engine("tiny-llama", kv_type="evict", config=cfg, dtype=jnp.float32,
                 max_new_tokens=5, decode_budget=256, capacity_granularity=256,
                 score_chunk_size=256, flat_decode="on")

    from kvzip_tpu.pool import build_pool_stepped

    long_ctx = ("Chronicle entry: the dam at Verlan holds 9200 megaliters. "
                * 90)
    states = [eng.prefill(CTXS[0], prefill_chunk_size=300),
              eng.prefill(long_ctx, prefill_chunk_size=300)]
    eng.prune(states[0], 0.5, "pair")
    # the second pool at a coarser align, through the builder directly
    st = states[1]
    keep, _, _ = prune_mask(st.score, 0.4, "pair", method="histogram")
    st.score = None
    st.cache = build_pool_stepped(st.cache, keep, st.sink,
                                  eng.decode_budget, align=8192)
    st.pruned = True
    st.snapshot()
    aligns = {st.cache.align for st in states}
    assert len(aligns) == 2, f"expected mixed aligns, got {aligns}"

    queries = [eng.apply_template("What word is hidden?"),
               eng.apply_template("How many megaliters?")]
    seq_out = [eng.generate(q, st) for q, st in zip(queries, states)]
    bat_out = batched_generate(eng, queries, states, max_new_tokens=5)
    assert bat_out == seq_out
    for st in states:
        assert int(jax.device_get(st.cache.tail_len)) == 0


def test_continuous_batching_pool():
    """run_continuous over pool states (the default layout): retirement +
    mid-flight admission, outputs match sequential."""
    from kvzip_tpu.serving import Scheduler

    cfg = tiny_config("llama", head_dim=128, num_heads=4, num_kv_heads=2,
                      hidden_size=128)
    eng = Engine("tiny-llama", kv_type="evict", config=cfg,
                 dtype=jnp.float32, max_new_tokens=8, decode_budget=256,
                 capacity_granularity=256, score_chunk_size=256,
                 flat_decode="on")

    ctxs = CTXS + ["A third context about the color vermilion. " * 21]
    states = [eng.prefill(c, prefill_chunk_size=300) for c in ctxs]
    for st, r in zip(states, (0.5, 0.4, 0.6)):
        eng.prune(st, r, "pair")
    queries = [eng.apply_template(q) for q in (
        "What word is hidden?", "Which number appears?",
        "Which color is named?")]
    budgets = [3, 8, 5]

    want = [eng.generate(q, st, max_new_tokens=mn)
            for q, st, mn in zip(queries, states, budgets)]

    sched = Scheduler(eng, max_batch=2)
    for q, st, mn in zip(queries, states, budgets):
        sched.submit(q, st, max_new_tokens=mn)
    got = sched.run_continuous(segment=4)
    assert got == want
    import jax
    for st in states:
        assert int(jax.device_get(st.cache.tail_len)) == 0


def test_continuous_batching_admission():
    """run_continuous: sequences retire mid-flight and queued requests are
    admitted into freed slots; outputs match sequential generation."""
    from kvzip_tpu.serving import Scheduler

    cfg = tiny_config("llama", head_dim=128, num_heads=4, num_kv_heads=2,
                      hidden_size=128)
    eng = Engine("tiny-llama", kv_type="evict", config=cfg,
                 dtype=jnp.float32, max_new_tokens=8, decode_budget=256,
                 capacity_granularity=256, score_chunk_size=256,
                 flat_decode="legacy")

    ctxs = CTXS + ["A third context about the color vermilion. " * 21,
                   "Fourth context: the password is 9441. " * 23]
    states = [eng.prefill(c, prefill_chunk_size=300) for c in ctxs]
    for st, r in zip(states, (0.5, 0.4, 0.6, 0.5)):
        eng.prune(st, r, "pair")
    queries = [eng.apply_template(q) for q in (
        "What word is hidden?", "Which number appears?",
        "Which color is named?", "What is the password?")]
    budgets = [3, 8, 5, 6]  # distinct budgets force mid-flight retirement

    want = [eng.generate(q, st, max_new_tokens=mn)
            for q, st, mn in zip(queries, states, budgets)]

    sched = Scheduler(eng, max_batch=2)  # 4 requests, 2 slots -> admission
    for q, st, mn in zip(queries, states, budgets):
        sched.submit(q, st, max_new_tokens=mn)
    got = sched.run_continuous(segment=4)
    assert got == want
    # caches restored for reuse
    import jax
    for st in states:
        assert int(jax.device_get(st.cache.tail_len)) == 0
