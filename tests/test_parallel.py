"""Multi-device (8 virtual CPU devices) TP/DP tests: sharded pipeline runs
and matches the single-device result."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kvzip_tpu.config import tiny_config
from kvzip_tpu.engine import Engine
from kvzip_tpu.parallel import make_mesh

CTX = ("Sharded caches should behave identically. " * 30 +
       "The secret word is zanzibar. " +
       "Filler sentence for the long tail of the context. " * 20)


@pytest.mark.skipif(len(jax.devices()) < 4, reason="needs >=4 devices")
def test_tp_matches_single_device():
    cfg = tiny_config("llama")  # 8 q heads, 4 kv heads

    def build(mesh):
        return Engine("tiny-llama", kv_type="evict", config=cfg,
                      dtype=jnp.float32, max_new_tokens=8, decode_budget=256,
                      capacity_granularity=256, score_chunk_size=256,
                      mesh=mesh, seed=3)

    ref = build(None)
    st_ref = ref.prefill(CTX, prefill_chunk_size=300)

    mesh = make_mesh(4, tp=4)
    eng = build(mesh)
    st = eng.prefill(CTX, prefill_chunk_size=300)

    np.testing.assert_allclose(
        np.asarray(jax.device_get(st.score)),
        np.asarray(jax.device_get(st_ref.score)), rtol=2e-4, atol=2e-4)

    ref.prune(st_ref, 0.5, "pair")
    eng.prune(st, 0.5, "pair")
    np.testing.assert_array_equal(
        np.asarray(jax.device_get(st.cache.lengths)),
        np.asarray(jax.device_get(st_ref.cache.lengths)))

    q = eng.apply_template("What is the secret word?")
    p = eng.prob(q, st)
    p_ref = ref.prob(q, st_ref)
    np.testing.assert_allclose(p, p_ref, atol=3e-3, rtol=0)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_histogram_threshold_matches_sort():
    """Distributed histogram quantile == replicated global sort, on
    bf16-quantized scores (what the scoring pass produces), including a
    head-sharded input on the 8-device mesh."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from kvzip_tpu.prune import threshold_global, threshold_histogram

    rng = np.random.default_rng(0)
    score = jnp.asarray(
        rng.gamma(0.4, 1.0, size=(4, 8, 512)).astype(np.float32)
    ).astype(jnp.bfloat16).astype(jnp.float32)

    for ratio in (0.1, 0.3, 0.5, 0.9):
        v_sort, t_sort = threshold_global(score, ratio)
        v_hist, t_hist = threshold_histogram(score, ratio)
        np.testing.assert_array_equal(np.asarray(jax.device_get(v_hist)),
                                      np.asarray(jax.device_get(v_sort)))
        assert abs(t_hist - t_sort) < 1e-6

    # head-level scores = per-head scalars broadcast over the sequence:
    # massive ties — the k-th element sits inside a tie block and the
    # strict `> thres` keep rule must match the sort exactly (histogram is
    # the engine default now, including level="head")
    head = jnp.asarray(rng.gamma(0.4, 1.0, size=(4, 8)).astype(np.float32)
                       ).astype(jnp.bfloat16).astype(jnp.float32)
    bcast = jnp.broadcast_to(head[:, :, None], (4, 8, 512))
    for ratio in (0.3, 0.6):
        v_sort, t_sort = threshold_global(bcast, ratio)
        v_hist, t_hist = threshold_histogram(bcast, ratio)
        np.testing.assert_array_equal(np.asarray(jax.device_get(v_hist)),
                                      np.asarray(jax.device_get(v_sort)))
        assert abs(t_hist - t_sort) < 1e-6

    if len(jax.devices()) >= 8:
        mesh = make_mesh(8, tp=8)
        sharded = jax.device_put(
            score, NamedSharding(mesh, P(None, "model", None)))
        v_hist, _ = threshold_histogram(sharded, 0.3)
        v_sort, _ = threshold_global(score, 0.3)
        np.testing.assert_array_equal(np.asarray(jax.device_get(v_hist)),
                                      np.asarray(jax.device_get(v_sort)))


def test_histogram_rank_guard_pathological():
    """Pathological CONTINUOUS scores (not the bf16 grid the scoring pass
    emits): the rank guard must detect any inexact threshold and fall back
    to the sort, so the returned mask is ALWAYS exact."""
    from kvzip_tpu.prune import threshold_global, threshold_histogram

    rng = np.random.default_rng(3)
    # clustered + heavy-tailed continuous values, far off any bf16 grid
    raw = np.concatenate([
        rng.normal(1.0, 1e-6, size=6000),      # dense near-tie cluster
        rng.gamma(0.2, 5.0, size=2192),
    ]).astype(np.float32)
    score = jnp.asarray(raw.reshape(4, 4, 512))

    for ratio in (0.1, 0.3, 0.7):
        v_sort, t_sort = threshold_global(score, ratio)
        # crippled resolution: 1 iter x 2 bins cannot isolate the k-th
        # value -> the guard MUST trip and the fallback restore exactness
        with pytest.warns(UserWarning, match="rank guard"):
            v_hist, t_hist = threshold_histogram(score, ratio,
                                                 bins=2, iters=1)
        np.testing.assert_array_equal(np.asarray(jax.device_get(v_hist)),
                                      np.asarray(jax.device_get(v_sort)))
        assert abs(t_hist - t_sort) < 1e-12

        # default resolution on the same continuous input: exact either
        # way (guard passes, or trips and falls back — never approximate)
        v_def, t_def = threshold_histogram(score, ratio)
        np.testing.assert_array_equal(np.asarray(jax.device_get(v_def)),
                                      np.asarray(jax.device_get(v_sort)))
        assert abs(t_def - t_sort) < 1e-12


def test_dp_tp_mesh_generate():
    cfg = tiny_config("llama")
    mesh = make_mesh(8, tp=4)  # data=2, model=4
    eng = Engine("tiny-llama", kv_type="retain", config=cfg,
                 dtype=jnp.float32, max_new_tokens=6, decode_budget=256,
                 capacity_granularity=256, score_chunk_size=256, mesh=mesh)
    st = eng.prefill(CTX, prefill_chunk_size=300)
    eng.prune(st, 0.5, "pair")
    out = eng.generate(eng.apply_template("What is the secret word?"), st)
    assert isinstance(out, str)


@pytest.mark.skipif(len(jax.devices()) < 4, reason="needs >=4 devices")
def test_hybrid_mesh_matches_single_device():
    """Gemma3 HybridKV (ring buffers) under TP: head-sharded static stacks
    AND ring buffers produce the single-device scores/probs."""
    cfg = tiny_config("gemma3")

    def build(mesh):
        return Engine("tiny-gemma3", kv_type="retain", config=cfg,
                      dtype=jnp.float32, max_new_tokens=6, decode_budget=64,
                      capacity_granularity=256, score_chunk_size=256,
                      mesh=mesh, seed=5)

    ref = build(None)
    st_ref = ref.prefill(CTX, prefill_chunk_size=300)
    mesh = make_mesh(4, tp=4)
    eng = build(mesh)
    st = eng.prefill(CTX, prefill_chunk_size=300)

    np.testing.assert_allclose(
        np.asarray(jax.device_get(st.score)),
        np.asarray(jax.device_get(st_ref.score)), rtol=2e-4, atol=2e-4)

    ref.prune(st_ref, 0.5, "pair")
    eng.prune(st, 0.5, "pair")
    q = eng.apply_template("What is the secret word?")
    p = eng.prob(q, st)
    p_ref = ref.prob(q, st_ref)
    np.testing.assert_allclose(p, p_ref, atol=3e-3, rtol=0)


@pytest.mark.skipif(len(jax.devices()) < 4, reason="needs >=4 devices")
def test_int4_mesh_matches_single_device():
    """INT4 KV cache under TP: quantized nibble/scale arrays head-sharded,
    evict path compacts shard-locally."""
    cfg = tiny_config("llama", head_dim=128, num_heads=8, num_kv_heads=4,
                      hidden_size=256)

    def build(mesh):
        return Engine("tiny-llama", kv_type="evict", config=cfg,
                      dtype=jnp.float32, max_new_tokens=6, decode_budget=256,
                      capacity_granularity=256, score_chunk_size=256,
                      kv_quant="int4", mesh=mesh, seed=7)

    ref = build(None)
    st_ref = ref.prefill(CTX, prefill_chunk_size=300)
    mesh = make_mesh(4, tp=4)
    eng = build(mesh)
    st = eng.prefill(CTX, prefill_chunk_size=300)

    np.testing.assert_allclose(
        np.asarray(jax.device_get(st.score)),
        np.asarray(jax.device_get(st_ref.score)), rtol=2e-4, atol=2e-4)

    ref.prune(st_ref, 0.5, "pair")
    eng.prune(st, 0.5, "pair")
    # the mesh engine thresholds via histogram quantile; on CONTINUOUS f32
    # scores (no bf16 grid) that is exact up to ties in the final bin —
    # allow a +-2-row wobble per head (exact-equality is covered on the
    # bf16 grid by test_histogram_threshold_matches_sort)
    lens = np.asarray(jax.device_get(st.cache.lengths)).astype(np.int64)
    lens_ref = np.asarray(
        jax.device_get(st_ref.cache.lengths)).astype(np.int64)
    assert np.abs(lens - lens_ref).max() <= 2
    q = eng.apply_template("What is the secret word?")
    p = eng.prob(q, st)
    p_ref = ref.prob(q, st_ref)
    np.testing.assert_allclose(p, p_ref, atol=5e-3, rtol=0)
