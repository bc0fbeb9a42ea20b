"""Head-level (context-independent) eviction: save → load → prune round trip
(reference `test.py:22-25` + `model/wrapper.py:40-58`)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kvzip_tpu import prune as prune_lib
from kvzip_tpu.config import tiny_config
from kvzip_tpu.engine import Engine

CTX = "Context for head level eviction testing. " * 60


def test_save_load_roundtrip(tmp_path):
    eng = Engine("tiny-llama", kv_type="retain", config=tiny_config("llama"),
                 dtype=jnp.float32, max_new_tokens=4, decode_budget=256,
                 capacity_granularity=256, score_chunk_size=256)
    state = eng.prefill(CTX, prefill_chunk_size=300)

    # save per-head scores (amax over sequence)
    path = prune_lib.save_head_score(state.score, eng.name, "unit", 0,
                                     out_dir=str(tmp_path))
    loaded = prune_lib.load_head_score(eng.name, state.ctx_len,
                                       search_dirs=[str(tmp_path)])
    L, H = eng.config.num_layers, eng.config.num_kv_heads
    assert loaded.shape == (L, H, state.ctx_len)
    # broadcast over the sequence: columns identical
    arr = np.asarray(jax.device_get(loaded))
    assert (arr == arr[:, :, :1]).all()
    want = np.asarray(jax.device_get(
        state.score.astype(jnp.float32).max(axis=-1)))
    np.testing.assert_allclose(arr[:, :, 0], want, rtol=1e-3, atol=1e-4)


def test_head_level_prune_drops_whole_heads(tmp_path):
    eng = Engine("tiny-llama", kv_type="evict", config=tiny_config("llama"),
                 dtype=jnp.float32, max_new_tokens=4, decode_budget=256,
                 capacity_granularity=256, score_chunk_size=256)
    state = eng.prefill(CTX, prefill_chunk_size=300)
    prune_lib.save_head_score(state.score, eng.name, "unit", 0,
                              out_dir=str(tmp_path))

    # reload as head scores and prune at head level
    state2 = eng.prefill(CTX, prefill_chunk_size=300, load_score=True,
                         head_score_dirs=[str(tmp_path)])
    thres, true_ratio = eng.prune(state2, 0.6, "head")
    lens = np.asarray(jax.device_get(state2.cache.lengths))
    ctx_rows = lens - state2.sink
    # whole-head granularity: every head keeps all of the context or none
    assert set(np.unique(ctx_rows)) <= {0, state2.ctx_len}
    kept_frac = (ctx_rows == state2.ctx_len).mean()
    assert 0.3 < kept_frac < 0.9


def test_head_evict_zero_copy_matches_retain(tmp_path):
    """Head-level evict is a zero-copy lengths update (no gather, no flat
    build — the flat build's r_pad is useless padding at head
    granularity). Generations must equal
    the retain-masked head prune on the same scores."""
    cfg = tiny_config("llama")
    eng_e = Engine("tiny-llama", kv_type="evict", config=cfg,
                   dtype=jnp.float32, max_new_tokens=6, decode_budget=256,
                   capacity_granularity=256, score_chunk_size=256)
    st = eng_e.prefill(CTX, prefill_chunk_size=300)
    prune_lib.save_head_score(st.score, eng_e.name, "unit", 0,
                              out_dir=str(tmp_path))

    st_e = eng_e.prefill(CTX, prefill_chunk_size=300, load_score=True,
                         head_score_dirs=[str(tmp_path)])
    eng_r = Engine("tiny-llama", kv_type="retain", config=cfg,
                   dtype=jnp.float32,
                   params=jax.tree.map(jnp.copy, eng_e.params),
                   tokenizer=eng_e.tokenizer, max_new_tokens=6,
                   decode_budget=256, capacity_granularity=256,
                   score_chunk_size=256)
    st_r = eng_r.prefill(CTX, prefill_chunk_size=300, load_score=True,
                         head_score_dirs=[str(tmp_path)])

    full_live = st_e.used_gb()
    eng_e.prune(st_e, 0.6, "head")
    eng_r.prune(st_r, 0.6, "head")
    # zero-copy: same cache class (no flat build), live bytes shrank
    assert type(st_e.cache).__name__ == "KVCache"
    assert st_e.used_gb() < full_live

    q = eng_e.apply_template("What is the passcode?")
    assert eng_e.generate(q, st_e) == eng_r.generate(q, st_r)


@pytest.mark.skipif(
    not os.path.isdir("/root/reference/utils/head_score"),
    reason="reference assets not mounted")
def test_reads_reference_pt_assets():
    """The reference's shipped .pt head scores load directly
    (utils/head_score/*.pt, (L, H) per file — model/wrapper.py:40-58)."""
    s = prune_lib.load_head_score(
        "llama3.1-8b", 100,
        search_dirs=["/root/reference/utils/head_score"])
    assert s.shape == (32, 8, 100)  # llama3.1-8b: 32 layers, 8 kv heads
    s2 = prune_lib.load_head_score(
        "qwen2.5-7b", 50,
        search_dirs=["/root/reference/utils/head_score"])
    assert s2.shape == (28, 4, 50)


def test_multi_file_amax_merge(tmp_path):
    a = np.zeros((2, 3), np.float32)
    b = np.ones((2, 3), np.float32) * 0.5
    a[0, 0] = 0.9
    np.savez(tmp_path / "m-x-0.npz", score=a)
    np.savez(tmp_path / "m-y-1.npz", score=b)
    merged = prune_lib.load_head_score("m", 4, search_dirs=[str(tmp_path)])
    arr = np.asarray(jax.device_get(merged))[:, :, 0]
    assert arr[0, 0] == 0.9
    assert (arr.ravel()[1:] == 0.5).all()
