"""W4A8 int4 weights: quant/dequant roundtrip, storage, and the jnp routes."""

import jax
import jax.numpy as jnp
import numpy as np

from kvzip_tpu.ops.w4a8 import (_w4a8_jnp, dequantize_weight_int4,
                                quantize_weight_int4)


def test_quant_roundtrip_error_bounded():
    rng = np.random.default_rng(0)
    w = jnp.asarray(rng.standard_normal((256, 512)), jnp.float32)
    wq = quantize_weight_int4(w)
    assert wq["q4"].shape == (256, 256) and wq["q4"].dtype == jnp.uint8
    assert wq["s"].shape == (2, 512)
    wd = dequantize_weight_int4(wq, jnp.float32)
    # max error <= scale/2 per element
    err = np.abs(np.asarray(wd) - np.asarray(w))
    smax = np.asarray(wq["s"]).max()
    assert err.max() <= smax / 2 + 1e-6


def test_group_padding():
    """Group counts that don't divide the kernel blocking get zero-padded
    (s = z = 0 on pad groups) and produce identical results."""
    rng = np.random.default_rng(5)
    # IN = 384 -> 3 groups; gpb = 3 (no pad). IN = 2304 -> 18 groups,
    # gpb = 16 -> Gp = 32 (pad).
    from kvzip_tpu.ops.quant import quantize_act_int8

    for IN, Gp_want in ((384, 3), (2304, 32)):
        w = jnp.asarray(rng.standard_normal((IN, 256)) * 0.1, jnp.float32)
        wq = quantize_weight_int4(w)
        assert wq["s"].shape[0] == Gp_want
        x = jnp.asarray(rng.standard_normal((3, IN)), jnp.float32)
        got = _w4a8_jnp(x, wq)
        # pad groups must contribute EXACTLY nothing: compare against the
        # same quantized math restricted to the true IN rows
        xq, xs = quantize_act_int8(x)
        deq = dequantize_weight_int4(wq, jnp.float32)[:IN]
        want = (xq.astype(jnp.float32) * xs) @ deq
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def test_fuse_w4a8_exact():
    """Nibble-level refusion is LOSSLESS: the fused dict dequantizes to the
    column-concat of the individual dequantized weights."""
    from kvzip_tpu.ops.w4a8 import fuse_w4a8

    rng = np.random.default_rng(3)
    ws = [jnp.asarray(rng.standard_normal((2, 256, out)), jnp.float32)
          for out in (128, 256, 384)]
    qs = [quantize_weight_int4(w) for w in ws]
    fused = fuse_w4a8(qs)
    want = jnp.concatenate([dequantize_weight_int4(q, jnp.float32)
                            for q in qs], axis=-1)
    got = dequantize_weight_int4(fused, jnp.float32)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_stacked_matmul_matches_per_layer():
    """The stacked float32 route selects the right layer and matches the
    per-layer jnp linear for every layer index."""
    from kvzip_tpu.ops.w4a8 import w4a8_jnp_stacked

    rng = np.random.default_rng(4)
    L = 3
    w = jnp.asarray(rng.standard_normal((L, 256, 384)), jnp.float32)
    wq = quantize_weight_int4(w)
    for T in (1, 9):
        x = jnp.asarray(rng.standard_normal((T, 256)), jnp.float32)
        for l in range(L):
            got = w4a8_jnp_stacked(x, wq, jnp.int32(l))
            want = _w4a8_jnp(
                x, {k: v[l] for k, v in wq.items()})
            np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                       rtol=2e-4, atol=2e-4)


def test_dequant_route_matches_kernel_semantics():
    """GPU route (dequantize the layer to bf16 + one GEMM): same A8
    activation rounding, bf16 weight expansion adds only sub-percent noise
    vs the exact f32 scale algebra."""
    from kvzip_tpu.ops.w4a8 import w4a8_dequant_matmul

    rng = np.random.default_rng(6)
    L = 2
    w = jnp.asarray(rng.standard_normal((L, 256, 384)), jnp.float32)
    wq = quantize_weight_int4(w)
    x = jnp.asarray(rng.standard_normal((16, 256)), jnp.float32)
    for l in range(L):
        got = w4a8_dequant_matmul(x, wq, jnp.int32(l))
        want = _w4a8_jnp(x, {k: v[l] for k, v in wq.items()})
        # bf16 weight products under f32 accumulation: ~0.4% relative noise
        # on outputs of magnitude ~sqrt(IN); tolerance sized to that
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=2e-2, atol=0.15)


def test_engine_w4a8_end_to_end():
    """weight_quant='w4a8' runs the full pipeline and tracks the bf16
    engine's predictions closely (int4 per-group weights; the routes are
    covered above)."""
    from kvzip_tpu.config import tiny_config
    from kvzip_tpu.engine import Engine

    cfg = tiny_config("llama", hidden_size=128, intermediate_size=256,
                      num_heads=4, num_kv_heads=2, head_dim=128)
    ctx = ("The w4a8 engine context hides the word quartz in it. " * 20)

    ref = Engine("tiny-llama", kv_type="evict", config=cfg,
                 dtype=jnp.float32, max_new_tokens=5, decode_budget=256,
                 capacity_granularity=256, score_chunk_size=256, seed=9)
    eng = Engine("tiny-llama", kv_type="evict", config=cfg,
                 dtype=jnp.float32, params=jax.tree.map(jnp.copy, ref.params),
                 tokenizer=ref.tokenizer, weight_quant="w4a8",
                 max_new_tokens=5, decode_budget=256,
                 capacity_granularity=256, score_chunk_size=256)
    # conversion fuses qkv / gate-up into single GEMMs
    assert "q4" in eng.params["layers"]["wqkv"]
    assert "q4" in eng.params["layers"]["w_gateup"]
    assert "wq" not in eng.params["layers"]

    st_ref = ref.prefill(ctx, prefill_chunk_size=300)
    st = eng.prefill(ctx, prefill_chunk_size=300)
    # int4 weights perturb logits; scores should still correlate strongly
    s_ref = np.asarray(jax.device_get(st_ref.score)).ravel()
    s = np.asarray(jax.device_get(st.score)).ravel()
    cc = np.corrcoef(s_ref, s)[0, 1]
    assert cc > 0.98, cc

    eng.prune(st, 0.5, "pair")
    out = eng.generate(eng.apply_template("What word is hidden?"), st)
    assert isinstance(out, str)
