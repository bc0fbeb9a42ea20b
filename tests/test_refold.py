"""Multi-turn beyond decode_budget on the flat evict path: the tail folds into the flat context instead of raising."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kvzip_tpu.cache import FlatInt4KV, FlatKV, refold_flat
from kvzip_tpu.config import tiny_config
from kvzip_tpu.engine import Engine

CTX = ("Multi turn sessions keep appending question and answer tokens. " * 20
       + "The flag word is cormorant. "
       + "Filler sentences pad the context to realistic lengths here. " * 20)


def test_refold_flat_preserves_attention():
    """Attention over a refolded cache == attention over flat+tail."""
    from kvzip_tpu.ops.attention import flat_decode

    rng = np.random.default_rng(0)
    Hkv, G, D = 2, 2, 8
    H = Hkv * G
    R_pad, Tcap, tail_used = 32, 8, 5
    lens = np.asarray([10, 14])

    k_flat = np.zeros((1, R_pad, D), np.float32)
    v_flat = np.zeros((1, R_pad, D), np.float32)
    row_head = np.full((1, R_pad), -1, np.int32)
    r = 0
    for h in range(Hkv):
        k_flat[0, r:r + lens[h]] = rng.standard_normal((lens[h], D))
        v_flat[0, r:r + lens[h]] = rng.standard_normal((lens[h], D))
        row_head[0, r:r + lens[h]] = h
        r += lens[h]
    k_tail = rng.standard_normal((1, Hkv, Tcap, D)).astype(np.float32)
    v_tail = rng.standard_normal((1, Hkv, Tcap, D)).astype(np.float32)

    # tail_used-1 committed rows + one "current step" row at index
    # tail_used-1 (the flat decode always attends the current row via +qi+1)
    committed = tail_used - 1
    cache = FlatKV(
        k_flat=jnp.asarray(k_flat).transpose(0, 2, 1),
        v_flat=jnp.asarray(v_flat),
        row_head=jnp.asarray(row_head),
        k_tail=jnp.asarray(k_tail), v_tail=jnp.asarray(v_tail),
        lengths=jnp.asarray(lens[None], jnp.int32),
        tail_len=jnp.asarray(committed, jnp.int32),
        seen=jnp.asarray(40, jnp.int32))

    q = jnp.asarray(rng.standard_normal((1, H, D)), jnp.float32)
    # before: flat rows + committed tail rows + current row (index committed)
    # (computed BEFORE refold_flat — it donates and deletes the input cache)
    want = flat_decode(
        q, cache.k_flat[0], cache.v_flat[0], cache.row_head[0],
        cache.k_tail[0], cache.v_tail[0],
        jnp.asarray(committed, jnp.int32),
        scale=D ** -0.5)
    cur_k = jnp.asarray(k_tail[0, :, committed:committed + 1])
    cur_v = jnp.asarray(v_tail[0, :, committed:committed + 1])

    folded = refold_flat(cache, r_pad_new=64)
    np.testing.assert_array_equal(
        np.asarray(jax.device_get(folded.lengths)), lens[None] + committed)
    assert int(jax.device_get(folded.tail_len)) == 0

    # after: committed rows live in the flat part; current row re-appended
    # at tail position 0
    got = flat_decode(
        q, folded.k_flat[0], folded.v_flat[0], folded.row_head[0],
        jax.lax.dynamic_update_slice(folded.k_tail[0], cur_k, (0, 0, 0)),
        jax.lax.dynamic_update_slice(folded.v_tail[0], cur_v, (0, 0, 0)),
        jnp.asarray(0, jnp.int32),
        scale=D ** -0.5)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("kv_quant,mode", [
    ("none", "on"), ("int4", "on"), ("int4", "legacy")])
def test_multi_turn_past_budget(kv_quant, mode):
    """10 update_cache=True turns blowing past decode_budget (reference
    unbounded multi-turn, `attention/kvcache.py:82-106`) — through both the
    pool (default) and legacy-flat refold paths."""
    from kvzip_tpu.pool import PoolInt4KV, PoolKV

    cfg = tiny_config("llama", head_dim=128, num_heads=4, num_kv_heads=2,
                      hidden_size=128)
    eng = Engine("tiny-llama", kv_type="evict", config=cfg, dtype=jnp.float32,
                 max_new_tokens=4, decode_budget=160,
                 capacity_granularity=256, score_chunk_size=256,
                 kv_quant=kv_quant, flat_decode=mode)
    st = eng.prefill(CTX, prefill_chunk_size=300)
    eng.prune(st, 0.5, "pair")
    assert isinstance(st.cache, (FlatKV, FlatInt4KV, PoolKV, PoolInt4KV))

    base_rows = int(np.asarray(jax.device_get(st.cache.lengths)).sum())
    refolds = 0
    prev_rows = base_rows
    for turn in range(10):
        out = eng.generate(eng.apply_template(f"Question number {turn}?"),
                           st, update_cache=True)
        assert isinstance(out, str)
        rows = int(np.asarray(jax.device_get(st.cache.lengths)).sum())
        if rows > prev_rows:
            refolds += 1
            prev_rows = rows
    # the tail (160 rows) cannot hold 10 turns x (query+4 tokens): at least
    # one refold must have folded tail rows into the flat context
    assert refolds >= 1
    total = prev_rows + int(jax.device_get(st.cache.tail_len))
    assert total > base_rows + 100  # committed turns accumulated

    # cache still serves queries after refolds
    p = eng.prob(eng.apply_template("What is the flag word?"), st)
    np.testing.assert_allclose(p.sum(-1), 1.0, rtol=1e-4)
