"""POOL decode layout: decode parity vs the flat layout's reference, the
GPU kernel (interpret mode) vs that reference, build parity vs the round-3
flat build, engine e2e (pair + head levels), refold, and state save/load."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kvzip_tpu.config import tiny_config
from kvzip_tpu.engine import Engine
from kvzip_tpu.ops.attention import (flat_decode, flat_decode_int4,
                                     pool_decode_int4)
from kvzip_tpu.ops.pool_decode import pool_decode_attend
from kvzip_tpu.ops.quant import dequantize_int4, quantize_int4

CTX = ("Pool layouts concatenate every layer's kept rows. " * 25 +
       "The callsign is osprey. " +
       "Padding sentences fill out the rest of the context. " * 25)


def _mk_pool_int4(rng, L, Hkv, D, rows_per_layer, align, Tcap):
    """Build a random pool by hand; returns pool arrays + per-layer dense
    rows for the reference computation."""
    r_pad = [max(align, -(-r // align) * align) for r in rows_per_layer]
    off = np.concatenate([[0], np.cumsum(r_pad)[:-1]]).astype(np.int32)
    alloc = int(off[-1] + max(r_pad))
    max_rows = max(r_pad)

    k_rows, v_rows, heads = [], [], []
    kq_pool = np.zeros((D // 2, alloc), np.uint8)
    vq_pool = np.zeros((D // 2, alloc), np.uint8)
    ks_p = np.zeros((alloc,), np.float32)
    kz_p = np.zeros((alloc,), np.float32)
    vs_p = np.zeros((alloc,), np.float32)
    vz_p = np.zeros((alloc,), np.float32)
    rh = np.full((alloc,), -1, np.int32)
    for l, r in enumerate(rows_per_layer):
        k = rng.standard_normal((r, D)).astype(np.float32)
        v = rng.standard_normal((r, D)).astype(np.float32)
        h = np.sort(rng.integers(0, Hkv, size=r)).astype(np.int32)
        kq, ks, kz = quantize_int4(jnp.asarray(k), pack="split")
        vq, vs, vz = quantize_int4(jnp.asarray(v), pack="split")
        o = int(off[l])
        kq_pool[:, o:o + r] = np.asarray(kq).T
        vq_pool[:, o:o + r] = np.asarray(vq).T
        ks_p[o:o + r] = np.asarray(ks)[:, 0]
        kz_p[o:o + r] = np.asarray(kz)[:, 0]
        vs_p[o:o + r] = np.asarray(vs)[:, 0]
        vz_p[o:o + r] = np.asarray(vz)[:, 0]
        rh[o:o + r] = h
        k_rows.append((kq, ks, kz))
        v_rows.append((vq, vs, vz))
        heads.append(h)
    return (dict(
        k_pool_q=jnp.asarray(kq_pool), v_pool_q=jnp.asarray(vq_pool),
        k_pool_s=jnp.asarray(ks_p)[None], k_pool_z=jnp.asarray(kz_p)[None],
        v_pool_s=jnp.asarray(vs_p)[None], v_pool_z=jnp.asarray(vz_p)[None],
        row_head=jnp.asarray(rh)[None],
        layer_off=jnp.asarray(off),
        layer_rows=jnp.asarray(rows_per_layer, jnp.int32)),
        dict(align=align, max_rows=max_rows),
        k_rows, v_rows, heads)


@pytest.mark.parametrize("layer", [0, 1, 2])
def test_pool_int4_kernel_matches_flat(layer):
    """Per-layer pool attention == the round-3 flat layout fed that layer's
    rows alone (same tail, same quantized values)."""
    rng = np.random.default_rng(0)
    L, Hkv, G, D, T = 3, 2, 2, 128, 1
    H = Hkv * G
    Tcap, tail_used = 8, 3
    rows_per_layer = [40, 64, 17]
    align = 32

    pool, meta, k_rows, v_rows, heads = _mk_pool_int4(
        rng, L, Hkv, D, rows_per_layer, align, Tcap)
    k_tail = rng.standard_normal((Hkv, Tcap, D)).astype(np.float32)
    v_tail = rng.standard_normal((Hkv, Tcap, D)).astype(np.float32)
    q = jnp.asarray(rng.standard_normal((T, H, D)), jnp.float32)

    got = pool_decode_int4(
        q, pool["k_pool_q"], pool["k_pool_s"], pool["k_pool_z"],
        pool["v_pool_q"], pool["v_pool_s"], pool["v_pool_z"],
        pool["row_head"], pool["layer_off"], pool["layer_rows"],
        jnp.asarray(k_tail), jnp.asarray(v_tail),
        jnp.asarray(tail_used, jnp.int32), jnp.asarray(layer, jnp.int32),
        scale=D ** -0.5, max_rows=meta["max_rows"])

    # reference: flat layout over this layer's rows, padded to a block
    r = rows_per_layer[layer]
    r_pad = -(-r // 32) * 32
    kq, ks, kz = k_rows[layer]
    vq, vs, vz = v_rows[layer]

    def pad_t(a):  # (r, D//2) -> (D//2, r_pad)
        return jnp.pad(jnp.asarray(a).T, ((0, 0), (0, r_pad - r)))

    def pad_s(a):
        return jnp.pad(jnp.asarray(a)[:, 0], ((0, r_pad - r),))

    rh_l = np.full((r_pad,), -1, np.int32)
    rh_l[:r] = heads[layer]
    want = flat_decode_int4(
        q, pad_t(kq), pad_s(ks), pad_s(kz), pad_t(vq), pad_s(vs), pad_s(vz),
        jnp.asarray(rh_l), jnp.asarray(k_tail), jnp.asarray(v_tail),
        jnp.asarray(tail_used, jnp.int32), scale=D ** -0.5)

    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


def test_pool_bf16_kernel_matches_flat():
    """The GPU pool kernel (Triton route, interpret mode) == the plain
    segment reference fed each layer's rows alone."""
    rng = np.random.default_rng(1)
    L, Hkv, G, D, T = 2, 2, 2, 128, 4
    H = Hkv * G
    Tcap, tail_used = 8, 2
    rows = [48, 23]
    align = 32
    r_pad = [max(align, -(-r // align) * align) for r in rows]
    off = np.concatenate([[0], np.cumsum(r_pad)[:-1]]).astype(np.int32)
    alloc = int(off[-1] + max(r_pad))

    k_pool = np.zeros((D, alloc), np.float32)
    v_pool = np.zeros((alloc, D), np.float32)
    rh = np.full((alloc,), -1, np.int32)
    layers = []
    for l, r in enumerate(rows):
        k = rng.standard_normal((r, D)).astype(np.float32)
        v = rng.standard_normal((r, D)).astype(np.float32)
        h = np.sort(rng.integers(0, Hkv, size=r)).astype(np.int32)
        o = int(off[l])
        k_pool[:, o:o + r] = k.T
        v_pool[o:o + r] = v
        rh[o:o + r] = h
        layers.append((k, v, h))

    k_tail = rng.standard_normal((Hkv, Tcap, D)).astype(np.float32)
    v_tail = rng.standard_normal((Hkv, Tcap, D)).astype(np.float32)
    q = jnp.asarray(rng.standard_normal((T, H, D)), jnp.float32)

    for layer in range(L):
        got = pool_decode_attend(
            q, jnp.asarray(k_pool), jnp.asarray(v_pool), jnp.asarray(rh)[None],
            jnp.asarray(off), jnp.asarray(rows, jnp.int32),
            jnp.asarray(k_tail), jnp.asarray(v_tail),
            jnp.asarray(tail_used, jnp.int32), jnp.asarray(layer, jnp.int32),
            scale=D ** -0.5, max_rows=max(r_pad), block_k=16,
            interpret=True)

        k, v, h = layers[layer]
        r = rows[layer]
        rp = -(-r // 32) * 32
        rh_l = np.full((rp,), -1, np.int32)
        rh_l[:r] = h
        want = flat_decode(
            q, jnp.pad(jnp.asarray(k.T), ((0, 0), (0, rp - r))),
            jnp.pad(jnp.asarray(v), ((0, rp - r), (0, 0))),
            jnp.asarray(rh_l), jnp.asarray(k_tail), jnp.asarray(v_tail),
            jnp.asarray(tail_used, jnp.int32), scale=D ** -0.5)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=2e-5, atol=2e-5, err_msg=f"layer {layer}")


def test_pool_build_matches_flat_build():
    """build_pool_int4_stepped segments == build_flat_int4 rows (same plan,
    per-layer offsets instead of a uniform r_pad)."""
    from kvzip_tpu.cache import (append_layer_int4, build_flat_int4,
                                 init_int4_cache)
    from kvzip_tpu.pool import build_pool_int4_stepped

    rng = np.random.default_rng(3)
    cfg = tiny_config("llama", head_dim=128, num_heads=4, num_kv_heads=2,
                      hidden_size=128)
    L, H, D = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    C, ctx, sink = 256, 100, 4
    cache = init_int4_cache(cfg, C, jnp.float32)
    for l in range(L):
        k_new = jnp.asarray(rng.standard_normal((sink + ctx, H, D)), jnp.float32)
        v_new = jnp.asarray(rng.standard_normal((sink + ctx, H, D)), jnp.float32)
        layer = tuple(a[l] for a in (cache.k_q, cache.v_q, cache.k_s,
                                     cache.k_z, cache.v_s, cache.v_z))
        layer = append_layer_int4(layer, cache.lengths[l], k_new, v_new)
        cache = dataclasses.replace(
            cache, k_q=cache.k_q.at[l].set(layer[0]),
            v_q=cache.v_q.at[l].set(layer[1]),
            k_s=cache.k_s.at[l].set(layer[2]),
            k_z=cache.k_z.at[l].set(layer[3]),
            v_s=cache.v_s.at[l].set(layer[4]),
            v_z=cache.v_z.at[l].set(layer[5]))
    cache = dataclasses.replace(
        cache, lengths=cache.lengths + sink + ctx,
        seen=jnp.asarray(sink + ctx, jnp.int32))

    keep = jnp.asarray(rng.random((L, H, ctx)) > 0.5)
    want = build_flat_int4(cache, keep, sink, 256, 16, jnp.float32)
    cache2 = jax.tree.map(jnp.copy, cache)
    pool = build_pool_int4_stepped(cache2, keep, sink, 16, jnp.float32,
                                   align=128)

    lens = np.asarray(want.lengths)
    off = np.asarray(pool.layer_off)
    for l in range(L):
        n = int(lens[l].sum())
        assert int(np.asarray(pool.layer_rows)[l]) == n
        o = int(off[l])
        np.testing.assert_array_equal(
            np.asarray(pool.k_pool_q)[:, o:o + n],
            np.asarray(want.k_flat_q)[l, :, :n], err_msg=f"k_q layer {l}")
        np.testing.assert_array_equal(
            np.asarray(pool.v_pool_q)[:, o:o + n],
            np.asarray(want.v_flat_q)[l, :, :n])
        np.testing.assert_allclose(
            np.asarray(pool.k_pool_s)[0, o:o + n],
            np.asarray(want.k_flat_s)[l, :n])
        np.testing.assert_array_equal(
            np.asarray(pool.row_head)[0, o:o + n],
            np.asarray(want.row_head)[l, :n])
        # padding after the live rows is inert
        w = int(np.asarray(pool.layer_off)[l + 1]) if l + 1 < L else \
            pool.capacity
        np.testing.assert_array_equal(
            np.asarray(pool.row_head)[0, o + n:w], -1,
            err_msg=f"padding head ids layer {l}")


@pytest.mark.parametrize("level", ["pair", "head"])
def test_pool_engine_end_to_end(level):
    cfg = tiny_config("llama", head_dim=128, num_heads=4, num_kv_heads=2,
                      hidden_size=128)
    eng = Engine("tiny-llama", kv_type="evict", config=cfg, dtype=jnp.float32,
                 max_new_tokens=6, decode_budget=256, capacity_granularity=256,
                 score_chunk_size=256, kv_quant="int4", flat_decode="on")
    st = eng.prefill(CTX, prefill_chunk_size=300)
    full_used = st.cache.used_bytes()
    eng.prune(st, 0.5, level)

    from kvzip_tpu.pool import PoolInt4KV

    assert isinstance(st.cache, PoolInt4KV)
    assert st.cache.used_bytes() < full_used

    out = eng.generate(eng.apply_template("What is the callsign?"), st)
    assert isinstance(out, str)
    assert int(jax.device_get(st.cache.tail_len)) == 0  # restored

    p = eng.prob(eng.apply_template("What is the callsign?"), st)
    np.testing.assert_allclose(p.sum(-1), 1.0, rtol=1e-4)


def test_pool_engine_bf16_end_to_end():
    cfg = tiny_config("llama", head_dim=128, num_heads=4, num_kv_heads=2,
                      hidden_size=128)
    eng = Engine("tiny-llama", kv_type="evict", config=cfg, dtype=jnp.float32,
                 max_new_tokens=6, decode_budget=256, capacity_granularity=256,
                 score_chunk_size=256, flat_decode="on")
    st = eng.prefill(CTX, prefill_chunk_size=300)
    eng.prune(st, 0.5, "pair")

    from kvzip_tpu.pool import PoolKV

    assert isinstance(st.cache, PoolKV)
    out = eng.generate(eng.apply_template("What is the callsign?"), st)
    assert isinstance(out, str)


def test_pool_matches_legacy_flat_generation():
    """Pool and round-3 flat layouts produce the same greedy output from
    the same prefill+scores (the two layouts hold the same quantized rows)."""
    cfg = tiny_config("llama", head_dim=128, num_heads=4, num_kv_heads=2,
                      hidden_size=128)
    outs = {}
    for mode in ("on", "legacy"):
        eng = Engine("tiny-llama", kv_type="evict", config=cfg,
                     dtype=jnp.float32, max_new_tokens=8, decode_budget=256,
                     capacity_granularity=256, score_chunk_size=256,
                     kv_quant="int4", flat_decode=mode, seed=0)
        st = eng.prefill(CTX, prefill_chunk_size=300)
        eng.prune(st, 0.5, "pair")
        outs[mode] = eng.generate(
            eng.apply_template("What is the callsign?"), st)
    assert outs["on"] == outs["legacy"]


def test_pool_refold_multiturn():
    cfg = tiny_config("llama", head_dim=128, num_heads=4, num_kv_heads=2,
                      hidden_size=128)
    eng = Engine("tiny-llama", kv_type="evict", config=cfg, dtype=jnp.float32,
                 max_new_tokens=4, decode_budget=40, capacity_granularity=256,
                 score_chunk_size=256, kv_quant="int4", flat_decode="on")
    st = eng.prefill(CTX, prefill_chunk_size=300)
    eng.prune(st, 0.5, "pair")
    rows_before = int(np.asarray(st.cache.layer_rows).sum())

    # several update_cache turns force a refold past the 40-row tail
    for i in range(4):
        out = eng.generate(eng.apply_template(f"Question {i}?"), st,
                           update_cache=True)
        assert isinstance(out, str)
    rows_after = int(np.asarray(st.cache.layer_rows).sum())
    assert rows_after > rows_before
    # still serviceable after the fold
    out = eng.generate(eng.apply_template("What is the callsign?"), st)
    assert isinstance(out, str)


def test_pool_refold_matches_unfolded_attention():
    """Refolded pool attention == pool attention with the same rows still in
    the tail (same keys/values, same output) for a single layer."""
    from kvzip_tpu.pool import PoolInt4KV, refold_pool

    rng = np.random.default_rng(9)
    L, Hkv, G, D, T = 2, 2, 2, 128, 1
    H = Hkv * G
    Tcap = 8
    tail_used = 5
    rows = [40, 24]
    align = 32

    pool_d, meta, *_ = _mk_pool_int4(rng, L, Hkv, D, rows, align, Tcap)
    k_tail = np.zeros((L, Hkv, Tcap, D), np.float32)
    v_tail = np.zeros((L, Hkv, Tcap, D), np.float32)
    k_tail[:, :, :tail_used] = rng.standard_normal(
        (L, Hkv, tail_used, D)).astype(np.float32)
    v_tail[:, :, :tail_used] = rng.standard_normal(
        (L, Hkv, tail_used, D)).astype(np.float32)

    cache = PoolInt4KV(
        **pool_d, k_tail=jnp.asarray(k_tail), v_tail=jnp.asarray(v_tail),
        lengths=jnp.asarray(np.stack([np.asarray([r // 2, r - r // 2])
                                      for r in rows]), jnp.int32),
        tail_len=jnp.asarray(tail_used, jnp.int32),
        seen=jnp.asarray(100, jnp.int32), **meta)

    q = jnp.asarray(rng.standard_normal((T, H, D)), jnp.float32)

    def attend(c, layer):
        return pool_decode_int4(
            q, c.k_pool_q, c.k_pool_s, c.k_pool_z, c.v_pool_q, c.v_pool_s,
            c.v_pool_z, c.row_head, c.layer_off, c.layer_rows,
            c.k_tail[layer], c.v_tail[layer], c.tail_len,
            jnp.asarray(layer, jnp.int32), scale=D ** -0.5,
            max_rows=c.max_rows)

    before = [attend(cache, l) for l in range(L)]
    folded = refold_pool(cache)
    assert int(jax.device_get(folded.tail_len)) == 0
    after = [attend(folded, l) for l in range(L)]
    for l in range(L):
        # tail rows are requantized to int4 on fold — tolerance is the
        # 4-bit quantization error of those few rows
        np.testing.assert_allclose(np.asarray(after[l]),
                                   np.asarray(before[l]),
                                   rtol=0.15, atol=0.15, err_msg=f"layer {l}")


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_pool_save_load_roundtrip(tmp_path, dtype):
    # bfloat16 matters: numpy persists ml_dtypes.bfloat16 as a void ("|V2")
    # descriptor that np.load cannot hand back to JAX
    cfg = tiny_config("llama", head_dim=128, num_heads=4, num_kv_heads=2,
                      hidden_size=128)
    eng = Engine("tiny-llama", kv_type="evict", config=cfg, dtype=dtype,
                 max_new_tokens=6, decode_budget=256, capacity_granularity=256,
                 score_chunk_size=256, kv_quant="int4", flat_decode="on")
    st = eng.prefill(CTX, prefill_chunk_size=300)
    eng.prune(st, 0.5, "pair")
    want = eng.generate(eng.apply_template("What is the callsign?"), st)

    path = eng.save_state(st, str(tmp_path / "state"))
    st2 = eng.load_state(path)
    got = eng.generate(eng.apply_template("What is the callsign?"), st2)
    assert got == want

    # geometry survives
    assert st2.cache.align == st.cache.align
    assert st2.cache.max_rows == st.cache.max_rows
    np.testing.assert_array_equal(np.asarray(st2.cache.layer_off),
                                  np.asarray(st.cache.layer_off))

    # an engine with a BIGGER decode budget grows the (empty) tail on load
    # instead of tripping _check_capacity on long generates (bench.py runs
    # 1024-token decodes against states saved by a 512-budget engine)
    eng_big = Engine("tiny-llama", kv_type="evict", config=cfg, dtype=dtype,
                     max_new_tokens=6, decode_budget=512,
                     capacity_granularity=256, score_chunk_size=256,
                     kv_quant="int4", flat_decode="on", params=eng.params,
                     tokenizer=eng.tokenizer)
    st3 = eng_big.load_state(path)
    assert st3.cache.k_tail.shape[2] == 512
    got3 = eng_big.generate(eng_big.apply_template("What is the callsign?"),
                            st3)
    assert got3 == want


def test_synthetic_full_pool_geometry():
    from kvzip_tpu.pool import synthetic_full_pool

    pool = synthetic_full_pool(3, 2, 128, per_head_rows=100, tail_cap=16,
                               int4=True, align=64)
    assert pool.num_layers == 3
    rows = np.asarray(pool.layer_rows)
    np.testing.assert_array_equal(rows, 200)
    off = np.asarray(pool.layer_off)
    assert (np.diff(off) >= 200).all()
    rh = np.asarray(pool.row_head)[0]
    for l in range(3):
        seg = rh[off[l]:off[l] + 200]
        np.testing.assert_array_equal(seg[:100], 0)
        np.testing.assert_array_equal(seg[100:], 1)
