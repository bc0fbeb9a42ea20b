"""Sequence-parallel ring-attention prefill (SURVEY §2b net-new component):
exactness vs the single-device forward on the 8-virtual-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kvzip_tpu.config import tiny_config
from kvzip_tpu.engine import Engine
from kvzip_tpu.parallel import make_mesh
from kvzip_tpu.parallel.ring_prefill import reshard_to_cache, ring_prefill


def _engine(mesh=None, params=None, tok=None):
    cfg = tiny_config("llama")
    kw = {}
    if params is not None:
        kw = dict(params=params, tokenizer=tok)
    return Engine("tiny-llama", kv_type="retain", config=cfg,
                  dtype=jnp.float32, max_new_tokens=4, decode_budget=256,
                  capacity_granularity=256, score_chunk_size=256, seed=11,
                  mesh=mesh, **kw), cfg


def _ids(eng, cfg, seed):
    """Context ids such that sys_prompt + ctx is divisible by 8 (the ring
    shards whole token slabs; the sys prompt must be part of the ring run —
    context rows attend to it, so excluding it changes every layer>0 K/V)."""
    rng = np.random.default_rng(seed)
    sink = len(eng.sys_prompt_ids)
    total = ((sink + 512) // 8) * 8
    ctx = rng.integers(1, cfg.vocab_size - 4,
                       size=total - sink).astype(np.int32)
    full = np.concatenate([eng.sys_prompt_ids, ctx]).astype(np.int32)
    return ctx, full, total


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_ring_prefill_matches_sequential():
    eng, cfg = _engine()
    ctx, full, total = _ids(eng, cfg, 0)

    # reference: the engine's sequential chunked prefill (rows 0..total)
    st = eng.prefill(ctx, prefill_chunk_size=256, do_score=False)
    k_ref = np.asarray(jax.device_get(st.cache.k))[:, :, :total]
    v_ref = np.asarray(jax.device_get(st.cache.v))[:, :, :total]

    mesh = make_mesh(8, tp=1)  # data=8, model=1: pure sequence parallelism
    k, v = ring_prefill(eng.params, cfg, jnp.asarray(full), mesh)
    np.testing.assert_allclose(np.asarray(jax.device_get(k)), k_ref,
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(np.asarray(jax.device_get(v)), v_ref,
                               rtol=2e-4, atol=2e-4)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_engine_seq_parallel_full_pipeline():
    """Engine(seq_parallel=True) routes prefill through the ring: the FULL
    pipeline — prefill -> scoring -> prune -> decode — is
    equal to the sequential single-device engine."""
    eng, cfg = _engine()
    rng = np.random.default_rng(7)
    # NOT divisible by the data axis: exercises the ring prefix + the
    # sequential remainder tail
    ctx = rng.integers(1, cfg.vocab_size - 4, size=517).astype(np.int32)

    st = eng.prefill(ctx, prefill_chunk_size=256)

    mesh = make_mesh(8, tp=2)  # data=4, model=2
    eng2, _ = _engine(mesh=mesh, params=eng.params, tok=eng.tokenizer)
    eng2.seq_parallel = True
    st2 = eng2.prefill(ctx, prefill_chunk_size=256)

    np.testing.assert_allclose(
        np.asarray(jax.device_get(st2.score)),
        np.asarray(jax.device_get(st.score)), atol=2e-3, rtol=0)

    eng.prune(st, 0.5, "pair")
    eng2.prune(st2, 0.5, "pair")
    q = eng.apply_template("Summarize.")
    out = eng.generate(q, st, max_new_tokens=4)
    out2 = eng2.generate(q, st2, max_new_tokens=4)
    assert out == out2


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_ring_prefill_reshard_decodes():
    """Ring-prefilled KV resharded into a TP engine cache produces the
    sequential engine's next-token distributions."""
    eng, cfg = _engine()
    ctx, full, total = _ids(eng, cfg, 1)
    rng = np.random.default_rng(2)

    st = eng.prefill(ctx, prefill_chunk_size=256, do_score=False)
    q = rng.integers(1, cfg.vocab_size - 4, size=24).astype(np.int32)
    p_ref = eng.prob(q, st)

    mesh = make_mesh(8, tp=2)  # data=4, model=2
    eng2, _ = _engine(mesh=mesh, params=eng.params, tok=eng.tokenizer)
    st2 = eng2.prefill(ctx, prefill_chunk_size=256, do_score=False)
    k, v = ring_prefill(eng2.params, cfg, jnp.asarray(full), mesh)
    st2.cache = reshard_to_cache(k, v, mesh, st2.cache)
    st2.snapshot()

    p_sp = eng2.prob(q, st2)
    np.testing.assert_allclose(p_sp, p_ref, atol=1e-3, rtol=0)
