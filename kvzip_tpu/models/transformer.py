"""Pure-functional decoder forward for the kvzip engine.

One ``lax.scan`` over stacked layer parameters (compiled once for the whole
stack), threading the KV cache arrays through the carry so donated buffers are
updated in place. Covers the reference model families (llama3.x / qwen2.5 /
qwen3 / gemma3 text — `model/load.py:5-39`): GQA + RoPE variants, optional
QKV bias (qwen2), per-head QK-norm (qwen3/gemma3), gemma3 pre/post norms,
(1+w) RMSNorm, embedding scaling and hybrid sliding/static attention.

The KVzip hooks of the reference's monkeypatched attention
(`attention/attn.py:52-58`) are first-class here: ``scoring`` mode computes
reconstruction importance scores per layer, and the retain-mask / ragged
lengths of the cache drive pruned attention. Quantized execution is also
first-class: an ``Int4KVCache`` quantizes on append and dequantizes per tile
inside attention, and W8A8 layer weights (``{"q": int8, "s": scales}`` dicts)
run through dynamic-activation int8 matmuls (QServe-style, reference
`model/quant_model/w8a8kv4_llama.py`).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple, Optional, Union

import jax
import jax.numpy as jnp

from kvzip_tpu.cache import (FlatInt4KV, FlatKV, Int4KVCache, KVCache,
                             append_layer, append_layer_int4)
from kvzip_tpu.pool import PoolInt4KV, PoolKV
from kvzip_tpu.config import ModelConfig
from kvzip_tpu.models.rope import apply_rope, rope_cos_sin
from kvzip_tpu.ops import attention as attn_ops
from kvzip_tpu.ops import dispatch
from kvzip_tpu.ops.quant import dequantize_int4, int8_linear


# queries per forward at or below which a dense cache is read blockwise
# (decode steps); larger chunks take the fused route
DECODE_T_MAX = 8


class ForwardResult(NamedTuple):
    logits: Optional[jax.Array]        # (T, V) or (1, V) or None
    cache: Union[KVCache, Int4KVCache]
    chunk_scores: Optional[jax.Array]  # (L, H_kv, score_width) or None


def rms_norm(x: jax.Array, w: jax.Array, eps: float, gemma: bool = False) -> jax.Array:
    xf = x.astype(jnp.float32)
    var = jnp.mean(xf * xf, axis=-1, keepdims=True)
    xn = xf * jax.lax.rsqrt(var + eps)
    if gemma:
        return (xn * (1.0 + w.astype(jnp.float32))).astype(x.dtype)
    return (xn * w.astype(jnp.float32)).astype(x.dtype)


def _act(x: jax.Array, kind: str) -> jax.Array:
    if kind == "silu":
        return jax.nn.silu(x)
    if kind == "gelu_pytorch_tanh":
        return jax.nn.gelu(x, approximate=True)
    raise ValueError(kind)


def _head_norm(x: jax.Array, w: jax.Array, eps: float, gemma: bool) -> jax.Array:
    """Per-head RMSNorm on (T, H, D) with weight (D,) (qwen3/gemma3 qk-norm)."""
    return rms_norm(x, w, eps, gemma=gemma)


def _lin(x: jax.Array, w, bias=None) -> jax.Array:
    """Linear that dispatches on weight type: plain matmul, W8A8 int8, or
    W4A8 int4-packed."""
    if isinstance(w, dict):
        if "q4" in w:
            from kvzip_tpu.ops.w4a8 import w4a8_linear
            return w4a8_linear(x, w, bias)
        return int8_linear(x, w["q"], w["s"], bias)
    y = x @ w
    if bias is not None:
        y = y + bias
    return y


def _lin_shared(x: jax.Array, weights, biases) -> list:
    """Several projections of ONE activation: quantize it once (W8A8) —
    the act-quant fusion the reference does inside RMSNorm/SiLU-mul
    (`w8a8kv4_llama.py:126-163`), here as a shared pre-quantization."""
    if isinstance(weights[0], dict) and "q" in weights[0]:
        from kvzip_tpu.ops.quant import int8_matmul, quantize_act_int8
        xq, xs = quantize_act_int8(x)
        return [int8_matmul(xq, xs, w["q"], w["s"], b, x.dtype)
                for w, b in zip(weights, biases)]
    return [_lin(x, w, b) for w, b in zip(weights, biases)]


@partial(
    jax.jit,
    static_argnames=(
        "cfg", "collect_logits", "scoring", "score_width", "sink",
        "attn_impl", "scoring_attend"),
    donate_argnames=("cache",),
)
def forward(
    params,
    cfg: ModelConfig,
    ids: jax.Array,            # (T,) int32
    cache: Union[KVCache, Int4KVCache],
    *,
    collect_logits: str = "none",   # "none" | "last" | "all"
    scoring: bool = False,
    score_start: Optional[jax.Array] = None,  # () int32 cache row of ctx window
    score_len: Optional[jax.Array] = None,    # () int32 true window length
    score_qlen: Optional[jax.Array] = None,   # () int32 true #repeat queries
    score_width: int = 0,                      # static padded window width
    sink: int = 0,                             # static sink length (sys prompt)
    attn_impl: str = "dense",                  # dense caches: "dense" |
                                               # "blockwise" | "cudnn";
                                               # bf16 pools: "kernel" |
                                               # "plain" (ops.dispatch)
    scoring_attend: str = "full",              # "full" | "window" (O(ctx·win)
                                               # approx; attention.py docs)
) -> ForwardResult:
    T = ids.shape[0]
    is_int4 = isinstance(cache, Int4KVCache)
    is_pool = isinstance(cache, (PoolKV, PoolInt4KV))
    # pool caches share the flat tail/counter plumbing (frozen context +
    # bf16 append tail); only the attention call differs
    is_flat = isinstance(cache, (FlatKV, FlatInt4KV)) or is_pool
    is_flat_int4 = isinstance(cache, (FlatInt4KV, PoolInt4KV))
    L, Hkv = cfg.num_layers, cfg.num_kv_heads
    Dh = cfg.head_dim
    H = cfg.num_heads
    scale = cfg.query_scale if cfg.query_scale is not None else Dh ** -0.5
    emb = params["embed"]
    dtype = emb["s"].dtype if isinstance(emb, dict) else emb.dtype

    from kvzip_tpu.ops.quant import embed_lookup
    x = embed_lookup(emb, ids)
    if cfg.gemma_style_norm:
        x = x * jnp.asarray(cfg.hidden_size ** 0.5, dtype)

    positions = cache.seen + jnp.arange(T, dtype=jnp.int32)
    cos_g, sin_g = rope_cos_sin(cfg.rope, Dh, positions)
    if cfg.rope_local is not None:
        cos_l, sin_l = rope_cos_sin(cfg.rope_local, Dh, positions)
    else:
        cos_l, sin_l = cos_g, sin_g

    is_static_layers = jnp.asarray(
        [cfg.layer_is_static(l) for l in range(L)], jnp.bool_)
    if cfg.sliding_window is not None:
        # per-layer effective window; "no window" encoded as > any position
        windows = jnp.where(is_static_layers, jnp.int32(2 ** 30),
                            jnp.int32(cfg.sliding_window))
    else:
        windows = None

    lp = params["layers"]
    # W4A8 stacks are closed over, not scanned: w4a8_linear_stacked selects
    # the layer itself, so the scan never slices the whole stack up front
    w4 = {k: v for k, v in lp.items()
          if isinstance(v, dict) and "q4" in v}
    lp = {k: v for k, v in lp.items() if k not in w4}
    q_pos0 = cache.seen
    tail_len0 = cache.tail_len if is_flat else None
    if is_flat:
        if is_pool:
            if is_flat_int4:
                flat_arrays = (cache.k_pool_q, cache.k_pool_s,
                               cache.k_pool_z, cache.v_pool_q,
                               cache.v_pool_s, cache.v_pool_z)
            else:
                flat_arrays = (cache.k_pool, cache.v_pool)
        elif is_flat_int4:
            flat_arrays = (cache.k_flat_q, cache.k_flat_s, cache.k_flat_z,
                           cache.v_flat_q, cache.v_flat_s, cache.v_flat_z)
        else:
            flat_arrays = (cache.k_flat, cache.v_flat)
        flat_rh_all = cache.row_head
        if scoring:
            raise ValueError("scoring runs pre-prune; FlatKV is decode-only")

    if is_int4:
        cache_arrays = (cache.k_q, cache.v_q, cache.k_s, cache.k_z,
                        cache.v_s, cache.v_z)
    elif is_flat:
        cache_arrays = (cache.k_tail, cache.v_tail)
    else:
        cache_arrays = (cache.k, cache.v)

    def _cache_attend_flat(q, layer_store, layer_idx):
        """Decode attention over the evicted pool/flat layouts."""
        if is_pool and getattr(cache, "tp", 0):
            # per-shard pools over local kv heads (parallel/pool_tp.py):
            # each "model" shard runs the single-device route on its own
            # pool segment — attention stays collective-free under TP
            from kvzip_tpu.parallel.pool_tp import pool_attend_tp
            return pool_attend_tp(
                q, cache, layer_store[0], layer_store[1], tail_len0,
                layer_idx, scale=scale, route=attn_impl)
        tail = (layer_store[0], layer_store[1], tail_len0)
        if is_pool and is_flat_int4:
            return attn_ops.pool_decode_int4(
                q, *flat_arrays, flat_rh_all, cache.layer_off,
                cache.layer_rows, *tail, layer_idx, scale=scale,
                max_rows=cache.max_rows)
        if is_pool:
            return dispatch.pool_decode(attn_impl)(
                q, *flat_arrays, flat_rh_all, cache.layer_off,
                cache.layer_rows, *tail, layer_idx, scale=scale,
                max_rows=cache.max_rows)
        if is_flat_int4:
            return attn_ops.flat_decode_int4(
                q, *flat_arrays, flat_rh_all, *tail, scale=scale,
                layer=layer_idx)
        return attn_ops.flat_decode(q, *flat_arrays, flat_rh_all, *tail,
                                    scale=scale, layer=layer_idx)

    def layer_fn(carry, xs):
        x, *store = carry
        (layer_params, layer_idx, is_static, base_lens, valid_l) = xs

        if "wqkv" in w4:
            # fused W4A8 qkv: one GEMM, one act quant
            from kvzip_tpu.ops.w4a8 import w4a8_linear_stacked
            h = rms_norm(x, layer_params["ln_attn"], cfg.rms_norm_eps,
                         gemma=cfg.gemma_style_norm)
            qkv = w4a8_linear_stacked(h, w4["wqkv"], layer_idx)
            nq, nk = H * Dh, Hkv * Dh
            q, k, v = (qkv[:, :nq], qkv[:, nq:nq + nk], qkv[:, nq + nk:])
            if "bq" in layer_params:
                q = q + layer_params["bq"]
                k = k + layer_params["bk"]
                v = v + layer_params["bv"]
        elif "wq" in w4:
            from kvzip_tpu.ops.w4a8 import w4a8_linear_stacked
            h = rms_norm(x, layer_params["ln_attn"], cfg.rms_norm_eps,
                         gemma=cfg.gemma_style_norm)
            q, k, v = (
                w4a8_linear_stacked(h, w4[n], layer_idx,
                                    layer_params.get(b))
                for n, b in (("wq", "bq"), ("wk", "bk"), ("wv", "bv")))
        else:
            h = rms_norm(x, layer_params["ln_attn"], cfg.rms_norm_eps,
                         gemma=cfg.gemma_style_norm)
            q, k, v = _lin_shared(
                h, (layer_params["wq"], layer_params["wk"],
                    layer_params["wv"]),
                (layer_params.get("bq"), layer_params.get("bk"),
                 layer_params.get("bv")))
        q = q.reshape(T, H, Dh)
        k = k.reshape(T, Hkv, Dh)
        v = v.reshape(T, Hkv, Dh)
        if cfg.qk_norm:
            q = _head_norm(q, layer_params["q_norm"], cfg.rms_norm_eps,
                           cfg.gemma_style_norm)
            k = _head_norm(k, layer_params["k_norm"], cfg.rms_norm_eps,
                           cfg.gemma_style_norm)

        if cfg.rope_local is not None:
            cos = jnp.where(is_static, cos_g, cos_l)
            sin = jnp.where(is_static, sin_g, sin_l)
        else:
            cos, sin = cos_g, sin_g
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

        # -- cache append (O(T), in-place on donated buffers) --
        # EXCEPT in int4 scoring: the scoring forward is a PURE READ of the
        # cache. Appending the repeat window produced a cache output whose
        # layout XLA could not alias to the donated input ("donated buffers
        # were not usable"), silently copying the full multi-GB cache every
        # scoring chunk. The chunk's own K/V are appended to a local copy
        # of the layer instead.
        readonly = scoring and is_int4
        if is_flat and is_pool and not getattr(cache, "tp", 0):
            # stacked in-place tail append: the pool decode takes the full
            # (L, ...) tail stacks, so the per-layer slice + scatter-back
            # copies are never materialized
            store = [
                jax.lax.dynamic_update_slice(
                    a, jnp.swapaxes(r, 0, 1)[None],
                    (layer_idx, jnp.int32(0), tail_len0, jnp.int32(0)))
                for a, r in zip(store, (k, v))]
            layer_store = (store[0], store[1])
        else:
            layer_store = tuple(a[layer_idx] for a in store)
            if is_int4:
                if not readonly:
                    layer_store = append_layer_int4(layer_store, base_lens,
                                                    k, v)
            elif is_flat:
                # uniform tail append at tail_len (all heads advance
                # together)
                kt = jax.lax.dynamic_update_slice(
                    layer_store[0], jnp.swapaxes(k, 0, 1), (0, tail_len0, 0))
                vt = jax.lax.dynamic_update_slice(
                    layer_store[1], jnp.swapaxes(v, 0, 1), (0, tail_len0, 0))
                layer_store = (kt, vt)
            else:
                layer_store = append_layer(layer_store[0], layer_store[1],
                                           base_lens, k, v)
            if not readonly:
                store = [a.at[layer_idx].set(s)
                         for a, s in zip(store, layer_store)]

        # -- KVzip reconstruction scoring hook (attn.py:53-54) --
        if scoring:
            if is_int4:
                kq_l, _, ks_l, kz_l = layer_store[0], None, layer_store[2], layer_store[3]
                # K nibbles stored transposed (Hkv, D//2, C): slice columns,
                # swap back to rows for dequant (slices are small: sink/2k)
                k_sink = dequantize_int4(
                    jnp.swapaxes(kq_l[:, :, :sink], 1, 2), ks_l[:, :sink],
                    kz_l[:, :sink], dtype, pack="split")
                G4 = ks_l.shape[-1]
                k_ctx = dequantize_int4(
                    jnp.swapaxes(
                        jax.lax.dynamic_slice(kq_l, (0, 0, score_start),
                                              (Hkv, Dh // 2, score_width)),
                        1, 2),
                    jax.lax.dynamic_slice(ks_l, (0, score_start, 0),
                                          (Hkv, score_width, G4)),
                    jax.lax.dynamic_slice(kz_l, (0, score_start, 0),
                                          (Hkv, score_width, G4)), dtype,
                    pack="split")
                # repeat-window keys go through the same quantization the
                # cache stores (reference scores on dequantized keys,
                # quant attn.py:55-57)
                from kvzip_tpu.ops.quant import quantize_int4
                kq_r, ks_r, kz_r = quantize_int4(k, pack="split")
                vq_r, vs_r, vz_r = quantize_int4(v, pack="split")
                k_rep = dequantize_int4(kq_r, ks_r, kz_r, dtype, pack="split")
            else:
                k_cache = layer_store[0]
                k_sink = k_cache[:, :sink]
                k_ctx = jax.lax.dynamic_slice(
                    k_cache, (0, score_start, 0), (Hkv, score_width, Dh))
                k_rep = k
            layer_score = attn_ops.reconstruction_scores(
                q, k_sink, k_ctx, k_rep, score_len, scale=scale,
                q_valid=score_qlen, out_dtype=dtype)
        else:
            layer_score = jnp.zeros((Hkv, 0), dtype)

        # -- windowed scoring attention (opt-in O(ctx·window) mode) --
        win_attn_out = None
        if scoring and scoring_attend == "window":
            if is_int4:
                vq_l, vs_l, vz_l = (layer_store[1], layer_store[4],
                                    layer_store[5])
                v_sink = dequantize_int4(
                    jnp.swapaxes(vq_l[:, :, :sink], 1, 2), vs_l[:, :sink],
                    vz_l[:, :sink], dtype, pack="split")
                G4v = vs_l.shape[-1]
                v_ctx = dequantize_int4(
                    jnp.swapaxes(
                        jax.lax.dynamic_slice(vq_l, (0, 0, score_start),
                                              (Hkv, Dh // 2, score_width)),
                        1, 2),
                    jax.lax.dynamic_slice(vs_l, (0, score_start, 0),
                                          (Hkv, score_width, G4v)),
                    jax.lax.dynamic_slice(vz_l, (0, score_start, 0),
                                          (Hkv, score_width, G4v)), dtype,
                    pack="split")
                # same quantize round-trip as the cache rows (and as k_rep)
                v_rep = dequantize_int4(vq_r, vs_r, vz_r, dtype,
                                        pack="split")
            else:
                v_cache = layer_store[1]
                v_sink = v_cache[:, :sink]
                v_ctx = jax.lax.dynamic_slice(
                    v_cache, (0, score_start, 0), (Hkv, score_width, Dh))
                v_rep = v
            win_attn_out = attn_ops.windowed_scoring_attend(
                q, k_sink, k_ctx, k_rep, v_sink, v_ctx, v_rep,
                score_len, scale=scale, out_dtype=dtype)

        # -- attention over the cache --
        win = None
        if windows is not None:
            win = windows[layer_idx]
        if win_attn_out is not None:
            attn_out = win_attn_out
        elif is_flat:
            # pool/flat arrays closed over and indexed by layer (no
            # per-layer slice copy of the context per scan iteration)
            attn_out = _cache_attend_flat(q, layer_store, layer_idx)
        elif is_int4:
            kq_a, vq_a, ks_a, kz_a, vs_a, vz_a = layer_store
            if readonly:
                # read-only scoring: local append, no carry write
                kq_a, vq_a, ks_a, kz_a, vs_a, vz_a = append_layer_int4(
                    layer_store, base_lens, k, v)
            # K/V nibbles are stored transposed (H, D//2, C); the blockwise
            # form reads rows, so swap back (a full-layer copy per call)
            attn_out = attn_ops.attend_blockwise_int4(
                q, jnp.swapaxes(kq_a, 1, 2), ks_a, kz_a,
                jnp.swapaxes(vq_a, 1, 2), vs_a, vz_a, base_lens,
                valid_l, scale=scale, q_pos0=q_pos0, window=win)
        elif attn_impl == "cudnn" and T > DECODE_T_MAX:
            attn_out = attn_ops.attend_chunk_fused(
                q, layer_store[0], layer_store[1], base_lens, k, v,
                scale=scale)
        elif attn_impl in ("blockwise", "cudnn"):
            attn_out = attn_ops.attend_blockwise(
                q, layer_store[0], layer_store[1], base_lens, valid_l,
                scale=scale, q_pos0=q_pos0, window=win)
        else:
            attn_out = attn_ops.attend_dense(
                q, layer_store[0], layer_store[1], base_lens, valid_l,
                scale=scale, q_pos0=q_pos0, window=win)

        if "wo" in w4:
            from kvzip_tpu.ops.w4a8 import w4a8_linear_stacked
            attn_out = w4a8_linear_stacked(
                attn_out.reshape(T, H * Dh), w4["wo"], layer_idx)
        else:
            attn_out = _lin(attn_out.reshape(T, H * Dh), layer_params["wo"])
        if cfg.post_norms:
            attn_out = rms_norm(attn_out, layer_params["ln_post_attn"],
                                cfg.rms_norm_eps, gemma=cfg.gemma_style_norm)
        x = x + attn_out

        if "w_gateup" in w4:
            from kvzip_tpu.ops.w4a8 import w4a8_linear_stacked
            h2 = rms_norm(x, layer_params["ln_mlp"], cfg.rms_norm_eps,
                          gemma=cfg.gemma_style_norm)
            gu = w4a8_linear_stacked(h2, w4["w_gateup"], layer_idx)
            gate, up = jnp.split(gu, 2, axis=-1)
        elif "w_gate" in w4:
            from kvzip_tpu.ops.w4a8 import w4a8_linear_stacked
            h2 = rms_norm(x, layer_params["ln_mlp"], cfg.rms_norm_eps,
                          gemma=cfg.gemma_style_norm)
            gate = w4a8_linear_stacked(h2, w4["w_gate"], layer_idx)
            up = w4a8_linear_stacked(h2, w4["w_up"], layer_idx)
        else:
            h2 = rms_norm(x, layer_params["ln_mlp"], cfg.rms_norm_eps,
                          gemma=cfg.gemma_style_norm)
            gate, up = _lin_shared(
                h2, (layer_params["w_gate"], layer_params["w_up"]),
                (None, None))
        hidden = _act(gate, cfg.hidden_act) * up
        if "w_down" in w4:
            from kvzip_tpu.ops.w4a8 import w4a8_linear_stacked
            mlp = w4a8_linear_stacked(hidden, w4["w_down"], layer_idx)
        else:
            mlp = _lin(hidden, layer_params["w_down"])
        if cfg.post_norms:
            mlp = rms_norm(mlp, layer_params["ln_post_mlp"], cfg.rms_norm_eps,
                           gemma=cfg.gemma_style_norm)
        x = x + mlp

        return (x, *store), layer_score

    valid_xs = (cache.valid if hasattr(cache, "valid")
                else jnp.ones((L, 1, 1), jnp.bool_))
    xs = (lp, jnp.arange(L, dtype=jnp.int32), is_static_layers,
          cache.lengths, valid_xs)
    (x, *cache_arrays), scores = jax.lax.scan(
        layer_fn, (x, *cache_arrays), xs)

    if is_flat:
        new_cache = dataclasses.replace(
            cache, k_tail=cache_arrays[0], v_tail=cache_arrays[1],
            tail_len=cache.tail_len + jnp.int32(T),
            seen=cache.seen + jnp.int32(T))
    elif is_int4 and scoring:
        # read-only scoring: nothing was appended, counters unchanged
        new_cache = cache
    elif is_int4:
        new_cache = dataclasses.replace(
            cache, k_q=cache_arrays[0], v_q=cache_arrays[1],
            k_s=cache_arrays[2], k_z=cache_arrays[3],
            v_s=cache_arrays[4], v_z=cache_arrays[5],
            lengths=cache.lengths + jnp.int32(T),
            seen=cache.seen + jnp.int32(T))
    else:
        new_cache = dataclasses.replace(
            cache, k=cache_arrays[0], v=cache_arrays[1],
            lengths=cache.lengths + jnp.int32(T),
            seen=cache.seen + jnp.int32(T))

    logits = None
    if collect_logits != "none":
        from kvzip_tpu.ops.quant import head_logits
        xf = x if collect_logits == "all" else x[-1:]
        xf = rms_norm(xf, params["final_norm"], cfg.rms_norm_eps,
                      gemma=cfg.gemma_style_norm)
        logits = head_logits(params.get("lm_head", params["embed"]), xf)

    return ForwardResult(logits, new_cache, scores if scoring else None)
