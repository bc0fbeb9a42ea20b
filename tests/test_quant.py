"""Quantized paths: INT4 KV semantics/roundtrip, W8A8 linears, and the full
pipeline with quantized cache + weights (config 5 analogue: quant + eviction
combined — beyond the reference, which forces retain-only for quant)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kvzip_tpu.config import tiny_config
from kvzip_tpu.engine import Engine
from kvzip_tpu.ops import attention as attn_ops
from kvzip_tpu.ops.quant import (
    dequantize_int4, int8_linear, quantize_int4, quantize_weight_int8)

CTX = ("Numbers hide in plain sight. The launch code is 4417. " * 20 +
       "Other filler text follows to pad the context further. " * 40)


def test_int4_roundtrip_formula():
    """Exact reference semantics (quantize_int4.cu:114-121): scale=(max-min)/15,
    zero=min, q=clamp(round((x-zero)/scale),0,15), high nibble = even elem."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 256)).astype(np.float32)
    packed, scale, zero = quantize_int4(jnp.asarray(x), group_size=128)
    assert packed.shape == (3, 5, 128) and packed.dtype == jnp.uint8
    assert scale.shape == (3, 5, 2)

    # manual check of one group
    g = x[0, 0, :128]
    s = (g.max() - g.min()) / 15.0 + 1e-8
    q0 = int(np.clip(np.round((g[0] - g.min()) / s), 0, 15))
    q1 = int(np.clip(np.round((g[1] - g.min()) / s), 0, 15))
    assert int(packed[0, 0, 0]) == (q0 << 4) | q1

    out = dequantize_int4(packed, scale, zero, jnp.float32)
    err = np.abs(np.asarray(out) - x).max()
    # max error ~ scale/2 per group
    assert err < float(np.asarray(scale).max())


def test_int4_attention_close_to_fp():
    rng = np.random.default_rng(1)
    T, Hkv, G, C, D = 4, 2, 2, 64, 128
    q = jnp.asarray(rng.standard_normal((T, Hkv * G, D)), jnp.float32)
    k = rng.standard_normal((Hkv, C, D)).astype(np.float32)
    v = rng.standard_normal((Hkv, C, D)).astype(np.float32)
    lens = jnp.asarray([40, 33], jnp.int32)

    ref = attn_ops.attend_dense(q, jnp.asarray(k), jnp.asarray(v), lens, None,
                                scale=D ** -0.5)
    kq, ks, kz = quantize_int4(jnp.asarray(k), pack="split")
    vq, vs, vz = quantize_int4(jnp.asarray(v), pack="split")
    out = attn_ops.attend_blockwise_int4(q, kq, ks, kz, vq, vs, vz, lens, None,
                                         scale=D ** -0.5, kv_block=16)
    diff = np.abs(np.asarray(out) - np.asarray(ref)).max()
    assert diff < 0.15  # int4 quantization noise, not a wrong formula
    corr = np.corrcoef(np.asarray(out).ravel(), np.asarray(ref).ravel())[0, 1]
    assert corr > 0.99


def test_int4_split_pack_roundtrip():
    """Cache layout: element j in the high nibble, j+D/2 low."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 256)).astype(np.float32)
    p, s, z = quantize_int4(jnp.asarray(x), pack="split")
    out = dequantize_int4(p, s, z, jnp.float32, pack="split")
    err = np.abs(np.asarray(out) - x).max()
    assert err < float(np.asarray(s).max())
    # split and pairs layouts decode to identical values
    p2, s2, z2 = quantize_int4(jnp.asarray(x), pack="pairs")
    out2 = dequantize_int4(p2, s2, z2, jnp.float32, pack="pairs")
    np.testing.assert_allclose(np.asarray(out), np.asarray(out2))


def test_int8_linear_close():
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.standard_normal((6, 64)), jnp.float32)
    w = jnp.asarray(rng.standard_normal((64, 32)) * 0.05, jnp.float32)
    wq = quantize_weight_int8(w)
    out = int8_linear(x, wq["q"], wq["s"])
    ref = x @ w
    rel = np.abs(np.asarray(out - ref)).max() / np.abs(np.asarray(ref)).max()
    assert rel < 0.05


@pytest.mark.parametrize("kv_type", ["retain", "evict"])
def test_quant_pipeline_end_to_end(kv_type):
    cfg = tiny_config("llama", head_dim=128, num_heads=4, num_kv_heads=2,
                      hidden_size=128)
    eng = Engine("tiny-llama", kv_type=kv_type, config=cfg, dtype=jnp.float32,
                 max_new_tokens=6, decode_budget=256, capacity_granularity=256,
                 score_chunk_size=256, kv_quant="int4", weight_quant="w8a8")
    state = eng.prefill(CTX, prefill_chunk_size=300)
    assert state.score is not None
    full_mem = state.cache.mem_bytes()

    thres, true_ratio = eng.prune(state, 0.5, "pair")
    assert 0.3 < true_ratio < 0.7
    if kv_type == "evict":
        assert state.cache.mem_bytes() < full_mem
        lens = np.asarray(jax.device_get(state.cache.lengths))
        assert lens.std() > 0  # non-uniform budgets survive quantization

    out = eng.generate(eng.apply_template("What is the launch code?"), state)
    assert isinstance(out, str)

    # int4 cache footprint ~ 4.5x smaller than bf16 (nibbles + scales)
    from kvzip_tpu.cache import init_cache
    dense = init_cache(cfg, state.cache.capacity, jnp.bfloat16)
    assert dense.mem_bytes() / state.cache.mem_bytes() > 2.5


def test_int4_evict_matches_retain():
    """Pruning semantics survive quantization: kept sets identical across
    retain and evict paths with an int4 cache."""
    cfg = tiny_config("llama", head_dim=128, num_heads=4, num_kv_heads=2,
                      hidden_size=128)

    def build(kv_type):
        eng = Engine("tiny-llama", kv_type=kv_type, config=cfg,
                     dtype=jnp.float32, max_new_tokens=4, decode_budget=256,
                     capacity_granularity=256, score_chunk_size=256,
                     kv_quant="int4")
        st = eng.prefill(CTX, prefill_chunk_size=300)
        return eng, st

    eng_r, st_r = build("retain")
    eng_e, st_e = build("evict")
    np.testing.assert_allclose(np.asarray(jax.device_get(st_r.score)),
                               np.asarray(jax.device_get(st_e.score)),
                               rtol=1e-4, atol=1e-4)
    eng_r.prune(st_r, 0.5, "pair")
    eng_e.prune(st_e, 0.5, "pair")
    kept_e = np.asarray(jax.device_get(st_e.cache.lengths))
    kept_r = np.asarray(jax.device_get(
        st_r.cache.valid))[:, :, :st_r.prefill_len].sum(-1)
    np.testing.assert_array_equal(kept_e, kept_r)


def test_embed_head_int8_close():
    """int8 embed lookup + lm_head projection track the bf16 tables."""
    from kvzip_tpu.ops.quant import (embed_lookup, head_logits,
                                     quantize_embed_int8)

    rng = np.random.default_rng(5)
    V, D = 97, 64
    w = jnp.asarray(rng.standard_normal((V, D)), jnp.float32)
    q = quantize_embed_int8(w, jnp.float32)

    ids = jnp.asarray([0, 3, 96, 50])
    x = embed_lookup(q, ids)
    rel = np.abs(np.asarray(x - w[ids])).max() / np.abs(np.asarray(w)).max()
    assert rel < 0.02

    xf = jnp.asarray(rng.standard_normal((2, D)), jnp.float32)
    got = head_logits(q, xf)
    want = xf @ w.T
    rel = np.abs(np.asarray(got - want)).max() / np.abs(np.asarray(want)).max()
    assert rel < 0.05


def test_engine_embed_quant_pipeline():
    cfg = tiny_config("llama", head_dim=128, num_heads=4, num_kv_heads=2,
                      hidden_size=128)
    eng = Engine("tiny-llama", kv_type="evict", config=cfg, dtype=jnp.float32,
                 max_new_tokens=4, decode_budget=256, capacity_granularity=256,
                 score_chunk_size=256, embed_quant="int8", flat_decode="on")
    st = eng.prefill(CTX, prefill_chunk_size=300)
    eng.prune(st, 0.5, "pair")
    out = eng.generate(eng.apply_template("What is the launch code?"), st)
    assert isinstance(out, str)


def test_int4_head_logits_close_to_full():
    """int4h lm_head (group-128, W4A8-v2 kernel storage): logits close to
    the unquantized projection; argmax stable on well-separated logits."""
    import numpy as np
    from kvzip_tpu.ops.quant import head_logits, quantize_head_int4

    rng = np.random.default_rng(0)
    V, D = 512, 256
    head = jnp.asarray(rng.standard_normal((V, D)) * 0.05, jnp.float32)
    x = jnp.asarray(rng.standard_normal((3, D)), jnp.float32)
    ref = np.asarray(head_logits(head, x))
    got = np.asarray(head_logits(quantize_head_int4(head, jnp.float32), x))
    assert got.shape == ref.shape
    # int4 per-weight rounding is ~10% of a gaussian weight's sigma and
    # logit signal and noise BOTH scale with sqrt(D), so relative logit
    # noise is ~10% regardless of D — exactly why int4h stays opt-in and
    # off the official bench config (see quantize_head_int4's docstring)
    err = np.abs(got - ref).max() / (np.abs(ref).max() + 1e-6)
    assert err < 0.2, err
    # rows where the top-2 margin is clear must keep their argmax
    srt = np.sort(ref, axis=1)
    clear = (srt[:, -1] - srt[:, -2]) > 0.3 * np.abs(ref).max()
    assert (ref.argmax(1)[clear] == got.argmax(1)[clear]).all()


def test_engine_int4h_smoke():
    from kvzip_tpu.config import tiny_config
    from kvzip_tpu.engine import Engine

    cfg = tiny_config("llama", head_dim=128, num_heads=4, num_kv_heads=2,
                      hidden_size=128)
    eng = Engine("tiny-llama", kv_type="evict", config=cfg,
                 dtype=jnp.float32, max_new_tokens=6, decode_budget=256,
                 capacity_granularity=256, score_chunk_size=256,
                 weight_quant="w4a8", embed_quant="int4h",
                 flat_decode="on", seed=2)
    st = eng.prefill("The cargo manifest lists twelve crates of cobalt. "
                     * 8, prefill_chunk_size=200)
    eng.prune(st, 0.5, "pair")
    out = eng.generate(eng.apply_template("What is listed?"), st)
    assert isinstance(out, str)
