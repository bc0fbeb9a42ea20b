"""Hybrid (gemma3 sliding/static) forward over the ring-buffered cache.

One ``lax.scan`` over all layers; each step branches with ``lax.cond`` on
the layer kind:

- STATIC (global-attention) layers read/write full-length stacks threaded
  through the carry, indexed by a per-layer ``static_slot`` — these are the
  layers KVzip scores and prunes (reference scores static layers only,
  `attention/kvcache.py:534-562`).
- SLIDING layers read/write ``window``-sized ring buffers (``ring_slot``),
  attending over [pre-append ring ∥ current chunk] with position-stamped
  masking (`ops.attention.attend_ring`). Reference ``_sliding_update``
  semantics (`attention/kvcache.py:402-447`) at window-bound memory — the
  round-1 implementation kept full-capacity sliding buffers instead.

Retain-path only, like the reference (`model/wrapper.py:74-76`).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from kvzip_tpu.cache import HybridKV, append_layer, ring_append
from kvzip_tpu.config import ModelConfig
from kvzip_tpu.models.rope import apply_rope, rope_cos_sin
from kvzip_tpu.models.transformer import (ForwardResult, _act, _head_norm,
                                          _lin, _lin_shared, rms_norm)
from kvzip_tpu.ops import attention as attn_ops


@partial(
    jax.jit,
    static_argnames=(
        "cfg", "collect_logits", "scoring", "score_width", "sink",
        "attn_impl", "scoring_attend"),
    donate_argnames=("cache",),
)
def forward_hybrid(
    params,
    cfg: ModelConfig,
    ids: jax.Array,
    cache: HybridKV,
    *,
    collect_logits: str = "none",
    scoring: bool = False,
    score_start: Optional[jax.Array] = None,
    score_len: Optional[jax.Array] = None,
    score_qlen: Optional[jax.Array] = None,
    score_width: int = 0,
    sink: int = 0,
    attn_impl: str = "dense",
    scoring_attend: str = "full",  # hybrid scoring is always full-cache
                                   # (Engine rejects "window" for gemma3)
) -> ForwardResult:
    T = ids.shape[0]
    L, Hkv = cfg.num_layers, cfg.num_kv_heads
    Dh, H = cfg.head_dim, cfg.num_heads
    scale = cfg.query_scale if cfg.query_scale is not None else Dh ** -0.5
    emb = params["embed"]
    dtype = emb["s"].dtype if isinstance(emb, dict) else emb.dtype
    window = int(cfg.sliding_window)

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

    static_ids = set(cfg.static_layer_ids)
    is_static_np = np.asarray([l in static_ids for l in range(L)])
    slot_np = np.zeros((L,), np.int32)
    s_cnt = r_cnt = 0
    for l in range(L):
        if is_static_np[l]:
            slot_np[l] = s_cnt
            s_cnt += 1
        else:
            slot_np[l] = r_cnt
            r_cnt += 1

    lengths = cache.lengths          # (L_t, H) — same count for all layers
    valid = cache.valid
    seen0 = cache.seen
    lp = params["layers"]

    def layer_fn(carry, xs):
        x, ks, vs, kr, vr, rp = carry
        layer_params, is_static, slot = xs

        h = rms_norm(x, layer_params["ln_attn"], cfg.rms_norm_eps,
                     gemma=cfg.gemma_style_norm)
        q, k, v = _lin_shared(
            h, (layer_params["wq"], layer_params["wk"], layer_params["wv"]),
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
        cos = jnp.where(is_static, cos_g, cos_l)
        sin = jnp.where(is_static, sin_g, sin_l)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

        zero_score = jnp.zeros(
            (Hkv, score_width if scoring else 0), dtype)

        def static_branch(ops):
            ks, vs, kr, vr, rp = ops
            k_l = jax.lax.dynamic_index_in_dim(ks, slot, keepdims=False)
            v_l = jax.lax.dynamic_index_in_dim(vs, slot, keepdims=False)
            base = jax.lax.dynamic_index_in_dim(lengths, slot, keepdims=False)
            k_l, v_l = append_layer(k_l, v_l, base, k, v)
            ks = jax.lax.dynamic_update_index_in_dim(ks, k_l, slot, 0)
            vs = jax.lax.dynamic_update_index_in_dim(vs, v_l, slot, 0)

            if scoring:
                k_sink = k_l[:, :sink]
                k_ctx = jax.lax.dynamic_slice(
                    k_l, (0, score_start, 0), (Hkv, score_width, Dh))
                layer_score = attn_ops.reconstruction_scores(
                    q, k_sink, k_ctx, k, score_len, scale=scale,
                    q_valid=score_qlen, out_dtype=dtype)
            else:
                layer_score = zero_score

            valid_l = jax.lax.dynamic_index_in_dim(valid, slot,
                                                   keepdims=False)
            if cache.capacity <= 4096 or attn_impl == "dense":
                attn = attn_ops.attend_dense(q, k_l, v_l, base, valid_l,
                                             scale=scale, q_pos0=seen0)
            else:
                attn = attn_ops.attend_blockwise(q, k_l, v_l, base, valid_l,
                                                 scale=scale, q_pos0=seen0)
            return attn, ks, vs, kr, vr, rp, layer_score

        def sliding_branch(ops):
            ks, vs, kr, vr, rp = ops
            kr_l = jax.lax.dynamic_index_in_dim(kr, slot, keepdims=False)
            vr_l = jax.lax.dynamic_index_in_dim(vr, slot, keepdims=False)
            rp_l = jax.lax.dynamic_index_in_dim(rp, slot, keepdims=False)
            # attend over the PRE-append ring + current chunk, then append
            attn = attn_ops.attend_ring(q, kr_l, vr_l, rp_l, k, v, seen0,
                                        scale=scale, window=window)
            kr_l, vr_l, rp_l = ring_append(kr_l, vr_l, rp_l, seen0, k, v)
            kr = jax.lax.dynamic_update_index_in_dim(kr, kr_l, slot, 0)
            vr = jax.lax.dynamic_update_index_in_dim(vr, vr_l, slot, 0)
            rp = jax.lax.dynamic_update_index_in_dim(rp, rp_l, slot, 0)
            return attn, ks, vs, kr, vr, rp, zero_score

        attn_out, ks, vs, kr, vr, rp, layer_score = jax.lax.cond(
            is_static, static_branch, sliding_branch, (ks, vs, kr, vr, rp))

        attn_out = _lin(attn_out.reshape(T, H * Dh), layer_params["wo"])
        if cfg.post_norms:
            attn_out = rms_norm(attn_out, layer_params["ln_post_attn"],
                                cfg.rms_norm_eps, gemma=cfg.gemma_style_norm)
        x = x + attn_out

        h2 = rms_norm(x, layer_params["ln_mlp"], cfg.rms_norm_eps,
                      gemma=cfg.gemma_style_norm)
        gate, up = _lin_shared(
            h2, (layer_params["w_gate"], layer_params["w_up"]), (None, None))
        mlp = _lin(_act(gate, cfg.hidden_act) * up, layer_params["w_down"])
        if cfg.post_norms:
            mlp = rms_norm(mlp, layer_params["ln_post_mlp"], cfg.rms_norm_eps,
                           gemma=cfg.gemma_style_norm)
        x = x + mlp

        return (x, ks, vs, kr, vr, rp), layer_score

    xs = (lp, jnp.asarray(is_static_np), jnp.asarray(slot_np))
    carry0 = (x, cache.k_static, cache.v_static,
              cache.k_ring, cache.v_ring, cache.ring_pos)
    (x, ks, vs, kr, vr, rp), scores = jax.lax.scan(layer_fn, carry0, xs)

    new_cache = dataclasses.replace(
        cache, k_static=ks, v_static=vs, k_ring=kr, v_ring=vr, ring_pos=rp,
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
