"""Attention over the KV cache (plain jnp/lax, compiled by XLA).

These are the portable implementations and the references every kernel is
compared with; `kvzip_tpu.ops.dispatch` says which of them, or which kernel,
runs on each platform. Semantics cover every path of the reference
attention forwards (reference `attention/attn.py:19-96`):

- dense causal prefill attention,
- retain-path masked attention (boolean ``valid`` → -inf, reference
  `kvcache.py:312-347` + flash_attn_varlen),
- ragged per-head decode over compacted caches (reference
  `kvcache.py:187-213` packs each kv head as its own varlen sequence; here
  per-head lengths mask the shared capacity buffer).

Masking rule used everywhere: key row ``j`` of head ``h`` is attendable by
query ``i`` (0-based within the new block) iff ``j < base_len[h] + i + 1`` and
``valid[h, j]`` — this single formula covers uniform prefill, masked retain
decode, and post-compaction ragged decode (new rows are appended at
``base_len[h]``).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

NEG_INF = float("-inf")
_HIGHEST = jax.lax.Precision.HIGHEST


def attend_dense(
    q: jax.Array,               # (T, H, D)
    k_cache: jax.Array,         # (H_kv, C, D)
    v_cache: jax.Array,         # (H_kv, C, D)
    base_lens: jax.Array,       # (H_kv,) int32 — lengths before this block's append
    valid: Optional[jax.Array],  # (H_kv, C) bool or None
    *,
    scale: float,
    q_pos0: Optional[jax.Array] = None,  # () int32 — global position of query 0
    window: Optional[int] = None,        # sliding-window size (gemma3 local layers)
) -> jax.Array:
    """Reference jnp attention; returns (T, H, D). float32 products at
    HIGHEST precision (no TF32 on a GPU), float32 softmax."""
    T, H, D = q.shape
    Hkv, C, _ = k_cache.shape
    G = H // Hkv

    qg = q.reshape(T, Hkv, G, D).transpose(1, 2, 0, 3)  # (Hkv, G, T, D)
    scores = jnp.einsum("hgtd,hcd->hgtc", qg.astype(jnp.float32),
                        k_cache.astype(jnp.float32),
                        precision=_HIGHEST) * scale

    col = jax.lax.broadcasted_iota(jnp.int32, (Hkv, T, C), 2)
    row = jax.lax.broadcasted_iota(jnp.int32, (Hkv, T, C), 1)
    mask = col < (base_lens[:, None, None] + row + 1)
    if valid is not None:
        mask = mask & valid[:, None, :]
    if window is not None and q_pos0 is not None:
        # cache row j has global position j in the uniform (never-compacted)
        # phase; sliding layers are retain-only so this always holds for them
        q_pos = q_pos0 + row
        mask = mask & (col > q_pos - window)

    scores = jnp.where(mask[:, None, :, :], scores, NEG_INF)
    probs = jax.nn.softmax(scores, axis=-1)
    out = jnp.einsum("hgtc,hcd->hgtd", probs, v_cache.astype(jnp.float32),
                     precision=_HIGHEST)
    return out.transpose(2, 0, 1, 3).reshape(T, H, D).astype(q.dtype)


def attend_blockwise(
    q: jax.Array,
    k_cache: jax.Array,
    v_cache: jax.Array,
    base_lens: jax.Array,
    valid: Optional[jax.Array],
    *,
    scale: float,
    q_pos0: Optional[jax.Array] = None,
    window: Optional[int] = None,
    kv_block: int = 1024,
) -> jax.Array:
    """Online-softmax attention scanned over KV blocks (flash-style in XLA).

    Never materializes (T, C) probabilities — memory is O(T * kv_block). Works
    on any backend.
    """
    T, H, D = q.shape
    Hkv, C, _ = k_cache.shape
    G = H // Hkv
    kv_block = min(kv_block, C)
    while C % kv_block:
        kv_block //= 2
    nblocks = C // kv_block

    qg = q.reshape(T, Hkv, G, D).transpose(1, 2, 0, 3).astype(jnp.float32)  # (Hkv,G,T,D)
    kb = k_cache.reshape(Hkv, nblocks, kv_block, D)
    vb = v_cache.reshape(Hkv, nblocks, kv_block, D)
    validb = None if valid is None else valid.reshape(Hkv, nblocks, kv_block)

    row = jax.lax.broadcasted_iota(jnp.int32, (Hkv, T, kv_block), 1)
    col_local = jax.lax.broadcasted_iota(jnp.int32, (Hkv, T, kv_block), 2)

    def body(carry, xs):
        m, l, acc = carry  # (Hkv,G,T,1), (Hkv,G,T,1), (Hkv,G,T,D)
        k_blk, v_blk, vmask_blk, blk_idx = xs
        col = col_local + blk_idx * kv_block
        mask = col < (base_lens[:, None, None] + row + 1)
        if vmask_blk is not None:
            mask = mask & vmask_blk[:, None, :]
        if window is not None and q_pos0 is not None:
            mask = mask & (col > (q_pos0 + row) - window)

        s = jnp.einsum("hgtd,hcd->hgtc", qg, k_blk.astype(jnp.float32)) * scale
        s = jnp.where(mask[:, None, :, :], s, NEG_INF)

        m_blk = jnp.max(s, axis=-1, keepdims=True)
        m_new = jnp.maximum(m, m_blk)
        # guard fully-masked state: exp(-inf - -inf) -> use where
        alpha = jnp.where(jnp.isfinite(m), jnp.exp(m - m_new), 0.0)
        p = jnp.where(jnp.isfinite(s), jnp.exp(s - m_new), 0.0)
        l_new = l * alpha + jnp.sum(p, axis=-1, keepdims=True)
        acc_new = acc * alpha + jnp.einsum("hgtc,hcd->hgtd", p, v_blk.astype(jnp.float32))
        return (m_new, l_new, acc_new), None

    m0 = jnp.full((Hkv, G, T, 1), NEG_INF, jnp.float32)
    l0 = jnp.zeros((Hkv, G, T, 1), jnp.float32)
    acc0 = jnp.zeros((Hkv, G, T, D), jnp.float32)

    xs = (jnp.swapaxes(kb, 0, 1), jnp.swapaxes(vb, 0, 1),
          None if validb is None else jnp.swapaxes(validb, 0, 1),
          jnp.arange(nblocks))
    (m, l, acc), _ = jax.lax.scan(body, (m0, l0, acc0), xs)

    out = acc / jnp.maximum(l, 1e-37)
    return out.transpose(2, 0, 1, 3).reshape(T, H, D).astype(q.dtype)


def attend_chunk_fused(
    q: jax.Array,          # (T, H, D) queries at rows [base, base + T)
    k_cache: jax.Array,    # (H_kv, C, D) — rows [0, base) are the prefix
    v_cache: jax.Array,
    base_lens: jax.Array,  # (H_kv,) int32 rows before this chunk
    k_new: jax.Array,      # (T, H_kv, D) this chunk's own keys
    v_new: jax.Array,
    *,
    scale: float,
    implementation: str = "cudnn",
) -> jax.Array:
    """Chunked-prefill attention through ``jax.nn.dot_product_attention``
    (``implementation="cudnn"``: cuDNN's fused flash attention, the role
    FlashAttention-2 has in the reference system).

    The fused kernels align a causal mask at the top-left corner, while a
    chunk's queries sit after ``base`` cached rows. So the chunk attends in
    two calls, each with every kv head as its own batch row (its GQA group
    as the query heads, ragged ``base_lens`` as key lengths): the cached
    prefix without a mask and the chunk itself causally. The two partial
    softmaxes are merged through their log-sum-exp. Same semantics as
    :func:`attend_dense` with ``valid=None``; returns (T, H, D).
    """
    T, H, D = q.shape
    Hkv = k_cache.shape[0]
    G = H // Hkv
    qb = q.reshape(T, Hkv, G, D).transpose(1, 0, 2, 3)       # (Hkv, T, G, D)
    lens = base_lens.astype(jnp.int32)
    o_pre, lse_pre = jax.nn.dot_product_attention(
        qb, k_cache[:, :, None], v_cache[:, :, None], scale=scale,
        query_seq_lengths=jnp.full((Hkv,), T, jnp.int32),
        key_value_seq_lengths=jnp.maximum(lens, 1),
        implementation=implementation, return_residual=True)
    o_new, lse_new = jax.nn.dot_product_attention(
        qb, jnp.swapaxes(k_new, 0, 1)[:, :, None],
        jnp.swapaxes(v_new, 0, 1)[:, :, None], scale=scale, is_causal=True,
        implementation=implementation, return_residual=True)
    lse_pre = jnp.where((lens > 0)[:, None, None],
                        lse_pre.astype(jnp.float32), NEG_INF)
    lse_new = lse_new.astype(jnp.float32)
    lse = jnp.logaddexp(lse_pre, lse_new)                    # (Hkv, T, G)
    out = (o_pre.astype(jnp.float32) * jnp.exp(lse_pre - lse)[..., None]
           + o_new.astype(jnp.float32) * jnp.exp(lse_new - lse)[..., None])
    return out.transpose(1, 0, 2, 3).reshape(T, H, D).astype(q.dtype)


def attend_ring(
    q: jax.Array,          # (T, H, D) queries at positions [seen, seen+T)
    k_ring: jax.Array,     # (H_kv, W, D) PRE-append ring (positions < seen)
    v_ring: jax.Array,
    ring_pos: jax.Array,   # (W,) int32 token position per slot, -1 empty
    k_new: jax.Array,      # (T, H_kv, D) this chunk's keys
    v_new: jax.Array,
    seen,
    *,
    scale: float,
    window: int,
    kv_block: int = 1024,
) -> jax.Array:
    """Sliding-window attention over a position-stamped ring buffer.

    The kv set for query i (position p_i = seen + i) is every column with
    position in (p_i - window, p_i]: the current chunk supplies positions
    [seen, seen+T) and the ring supplies the preceding window. Must see the
    PRE-append ring — appending first would evict rows that early queries
    still need when T ~ window (the reference attends over full current
    keys and only stores the truncated window, `_sliding_update`,
    `attention/kvcache.py:402-447`).
    """
    T, H, D = q.shape
    Hkv, W, _ = k_ring.shape
    G = H // Hkv

    keys = jnp.concatenate([jnp.swapaxes(k_new, 0, 1), k_ring], axis=1)
    vals = jnp.concatenate([jnp.swapaxes(v_new, 0, 1), v_ring], axis=1)
    pos_cols = jnp.concatenate(
        [seen + jnp.arange(T, dtype=jnp.int32), ring_pos.astype(jnp.int32)])

    C = T + W
    blk = min(kv_block, C)
    pad = (-C) % blk
    if pad:
        keys = jnp.pad(keys, ((0, 0), (0, pad), (0, 0)))
        vals = jnp.pad(vals, ((0, 0), (0, pad), (0, 0)))
        pos_cols = jnp.pad(pos_cols, (0, pad), constant_values=-1)
        C += pad
    nblocks = C // blk

    qg = q.reshape(T, Hkv, G, D).transpose(1, 2, 0, 3).astype(jnp.float32)
    q_pos = seen + jnp.arange(T, dtype=jnp.int32)[:, None]      # (T, 1)

    def body(carry, xs):
        m, l, acc = carry
        k_blk, v_blk, p_blk = xs                                 # (Hkv,blk,D)
        ok = (p_blk[None, :] >= 0) & (p_blk[None, :] <= q_pos) \
            & (p_blk[None, :] > q_pos - window)                  # (T, blk)
        s = jnp.einsum("hgtd,hcd->hgtc", qg,
                       k_blk.astype(jnp.float32)) * scale
        s = jnp.where(ok[None, None], s, NEG_INF)
        m_blk = jnp.max(s, axis=-1, keepdims=True)
        m_new = jnp.maximum(m, m_blk)
        alpha = jnp.where(jnp.isfinite(m), jnp.exp(m - m_new), 0.0)
        p = jnp.where(jnp.isfinite(s), jnp.exp(s - m_new), 0.0)
        l_new = l * alpha + jnp.sum(p, axis=-1, keepdims=True)
        acc_new = acc * alpha + jnp.einsum(
            "hgtc,hcd->hgtd", p, v_blk.astype(jnp.float32))
        return (m_new, l_new, acc_new), None

    m0 = jnp.full((Hkv, G, T, 1), NEG_INF, jnp.float32)
    l0 = jnp.zeros((Hkv, G, T, 1), jnp.float32)
    acc0 = jnp.zeros((Hkv, G, T, D), jnp.float32)
    xs = (jnp.swapaxes(keys.reshape(Hkv, nblocks, blk, D), 0, 1),
          jnp.swapaxes(vals.reshape(Hkv, nblocks, blk, D), 0, 1),
          pos_cols.reshape(nblocks, blk))
    (m, l, acc), _ = jax.lax.scan(body, (m0, l0, acc0), xs)

    out = acc / jnp.maximum(l, 1e-37)
    return out.transpose(2, 0, 1, 3).reshape(T, H, D).astype(q.dtype)


def attend_blockwise_int4(
    q: jax.Array,                    # (T, H, D)
    kq: jax.Array, ks: jax.Array, kz: jax.Array,   # packed K + scales/zeros
    vq: jax.Array, vs: jax.Array, vz: jax.Array,   # packed V + scales/zeros
    base_lens: jax.Array,
    valid: Optional[jax.Array],
    *,
    scale: float,
    q_pos0: Optional[jax.Array] = None,
    window: Optional[int] = None,
    kv_block: int = 512,
) -> jax.Array:
    """Online-softmax attention over the INT4 cache, dequantizing per block.

    HBM reads stay at the int4 footprint; only one (kv_block, D) tile is ever
    dequantized at a time (contrast reference `int4_kv.py:242-267` which
    dequantizes the WHOLE cache to fp16 before every attention call).
    """
    from kvzip_tpu.ops.quant import dequantize_int4

    T, H, D = q.shape
    Hkv, C = kq.shape[0], kq.shape[1]
    G = H // Hkv
    kv_block = min(kv_block, C)
    while C % kv_block:
        kv_block //= 2
    nblocks = C // kv_block

    qg = q.reshape(T, Hkv, G, D).transpose(1, 2, 0, 3).astype(jnp.float32)
    row = jax.lax.broadcasted_iota(jnp.int32, (Hkv, T, kv_block), 1)
    col_local = jax.lax.broadcasted_iota(jnp.int32, (Hkv, T, kv_block), 2)

    def reshape_blocks(a):
        return jnp.swapaxes(a.reshape(Hkv, nblocks, kv_block, *a.shape[2:]), 0, 1)

    xs = tuple(reshape_blocks(a) for a in (kq, ks, kz, vq, vs, vz))
    validb = None if valid is None else jnp.swapaxes(
        valid.reshape(Hkv, nblocks, kv_block), 0, 1)

    def body(carry, inp):
        m, l, acc = carry
        (kq_b, ks_b, kz_b, vq_b, vs_b, vz_b), vmask_b, blk_idx = inp
        k_blk = dequantize_int4(kq_b, ks_b, kz_b, jnp.float32, pack="split")
        v_blk = dequantize_int4(vq_b, vs_b, vz_b, jnp.float32, pack="split")

        col = col_local + blk_idx * kv_block
        mask = col < (base_lens[:, None, None] + row + 1)
        if vmask_b is not None:
            mask = mask & vmask_b[:, None, :]
        if window is not None and q_pos0 is not None:
            mask = mask & (col > (q_pos0 + row) - window)

        s = jnp.einsum("hgtd,hcd->hgtc", qg, k_blk) * scale
        s = jnp.where(mask[:, None, :, :], s, NEG_INF)
        m_blk = jnp.max(s, axis=-1, keepdims=True)
        m_new = jnp.maximum(m, m_blk)
        alpha = jnp.where(jnp.isfinite(m), jnp.exp(m - m_new), 0.0)
        p = jnp.where(jnp.isfinite(s), jnp.exp(s - m_new), 0.0)
        l_new = l * alpha + jnp.sum(p, axis=-1, keepdims=True)
        acc_new = acc * alpha + jnp.einsum("hgtc,hcd->hgtd", p, v_blk)
        return (m_new, l_new, acc_new), None

    m0 = jnp.full((Hkv, G, T, 1), NEG_INF, jnp.float32)
    l0 = jnp.zeros((Hkv, G, T, 1), jnp.float32)
    acc0 = jnp.zeros((Hkv, G, T, D), jnp.float32)
    (m, l, acc), _ = jax.lax.scan(
        body, (m0, l0, acc0), (xs, validb, jnp.arange(nblocks)))

    out = acc / jnp.maximum(l, 1e-37)
    return out.transpose(2, 0, 1, 3).reshape(T, H, D).astype(q.dtype)


def reconstruction_scores(
    q: jax.Array,          # (T, H, D) — queries of the repeat pass (post-rope)
    k_sink: jax.Array,     # (H_kv, S_sink, D) — sink keys (system prompt)
    k_ctx: jax.Array,      # (H_kv, S_ctx, D) — context window chunk (padded)
    k_rep: jax.Array,      # (T, H_kv, D) — keys of the repeat window itself
    ctx_len: jax.Array,    # () int32 — true chunk length (<= S_ctx)
    *,
    scale: float,
    q_valid: Optional[jax.Array] = None,  # () int32 — true #queries (<= T)
    out_dtype=jnp.bfloat16,
) -> jax.Array:
    """KVzip importance scores for one layer & one scoring chunk.

    Exact semantics of reference ``KVScore._get_score``
    (`attention/score.py:36-65`): softmax over the concatenated
    [sink ∥ ctx chunk ∥ repeat window] keys (NOT the full cache), causal mask
    only on the trailing T×T block, logits quantized to model dtype before the
    softmax (the reference softmaxes bf16 tensors), then
    ``amax`` over (group, query) of the ctx columns → (H_kv, S_ctx).

    Padding columns of k_ctx beyond ``ctx_len`` are masked out.
    """
    T, H, D = q.shape
    Hkv = k_sink.shape[0]
    G = H // Hkv
    S_sink, S_ctx = k_sink.shape[1], k_ctx.shape[1]

    qg = q.reshape(T, Hkv, G, D).transpose(1, 2, 0, 3)  # (Hkv, G, T, D)
    keys = jnp.concatenate(
        [k_sink, k_ctx, jnp.swapaxes(k_rep, 0, 1)], axis=1)  # (Hkv, S_sink+S_ctx+T, D)

    # model-dtype operands at HIGHEST precision with float32 accumulation:
    # bf16 products are exact in float32 and f32 inputs never drop to TF32
    logits = jnp.einsum("hgtd,hkd->hgtk", qg, keys.astype(qg.dtype),
                        precision=_HIGHEST,
                        preferred_element_type=jnp.float32) * scale

    K = S_sink + S_ctx + T
    col = jax.lax.broadcasted_iota(jnp.int32, (T, K), 1)
    row = jax.lax.broadcasted_iota(jnp.int32, (T, K), 0)
    # causal on the trailing T x T block only (score.py:67-85)
    causal_bad = (col >= S_sink + S_ctx) & (col - (S_sink + S_ctx) > row)
    # mask padded ctx columns (ctx chunk shorter than the static window)
    pad_bad = (col >= S_sink + ctx_len) & (col < S_sink + S_ctx)
    bad = causal_bad | pad_bad

    logits = jnp.where(bad[None, None, :, :], NEG_INF, logits)
    # parity: reference computes softmax on model-dtype (bf16) logits.
    # reduce_precision, not a convert pair: XLA may drop an f32->bf16->f32
    # round trip on the GPU (excess precision), and then this rounding would
    # depend on how the surrounding program fuses
    fi = jnp.finfo(out_dtype)
    logits = jax.lax.reduce_precision(logits, exponent_bits=fi.nexp,
                                      mantissa_bits=fi.nmant)
    probs = jax.nn.softmax(logits, axis=-1)

    ctx_probs = jax.lax.dynamic_slice_in_dim(probs, S_sink, S_ctx, axis=-1)
    if q_valid is not None:
        # exclude padded queries from the amax (the engine pads the repeat
        # pass to a fixed shape so every scoring chunk shares one compile)
        qrow = jax.lax.broadcasted_iota(jnp.int32, (T, 1), 0)
        ctx_probs = jnp.where(qrow[None, None] < q_valid, ctx_probs, 0.0)
    score = ctx_probs.max(axis=(1, 2))  # amax over (group, query) -> (Hkv, S_ctx)
    return score.astype(out_dtype)


def windowed_scoring_attend(
    q: jax.Array,          # (T, H, D) — repeat-pass queries (post-rope)
    k_sink: jax.Array,     # (H_kv, S_sink, D)
    k_ctx: jax.Array,      # (H_kv, S_ctx, D) — scored window chunk (padded)
    k_rep: jax.Array,      # (T, H_kv, D) — repeat window's own keys
    v_sink: jax.Array,
    v_ctx: jax.Array,
    v_rep: jax.Array,
    ctx_len: jax.Array,    # () int32 — true chunk length (<= S_ctx)
    *,
    scale: float,
    out_dtype=jnp.bfloat16,
) -> jax.Array:
    """Attention OUTPUT of the scoring pass in WINDOWED mode: queries attend
    only [sink ∥ scored window ∥ repeat] instead of the full cache.

    This makes reconstruction scoring O(ctx · window) instead of O(ctx²) —
    the exact-parity scoring forward runs a normal model forward over the
    whole cache (reference `model/wrapper.py:223-249`), whose attention
    FLOPs are intrinsically 2× the prefill's. Windowed mode is an OPT-IN
    approximation (`Engine(scoring_attend="window")`): repeat queries see
    less context, so hidden states — and therefore scores — deviate from
    the reference except when one window covers the entire context (then
    the key set is identical and so is everything downstream; tested).
    Masking matches :func:`reconstruction_scores`: padded window columns
    dropped, causal only on the trailing T×T block.

    Padded QUERY rows (``q`` rows beyond the true repeat length) are
    deliberately left unmasked, unlike ``reconstruction_scores``'s
    ``q_valid`` handling: their outputs are attention over real keys and
    therefore finite, and the engine discards those rows' hidden states
    (the scoring pass restores the cache snapshot and only
    ``chunk_scores`` — which IS q_valid-masked — leaves the forward). Any
    future consumer of the full windowed attention output must mask rows
    ``>= q_valid`` itself.
    """
    T, H, D = q.shape
    Hkv = k_sink.shape[0]
    G = H // Hkv
    S_sink, S_ctx = k_sink.shape[1], k_ctx.shape[1]

    qg = q.reshape(T, Hkv, G, D).transpose(1, 2, 0, 3)  # (Hkv, G, T, D)
    keys = jnp.concatenate(
        [k_sink, k_ctx, jnp.swapaxes(k_rep, 0, 1)], axis=1)
    vals = jnp.concatenate(
        [v_sink, v_ctx, jnp.swapaxes(v_rep, 0, 1)], axis=1)

    logits = jnp.einsum("hgtd,hkd->hgtk", qg.astype(jnp.float32),
                        keys.astype(jnp.float32), precision=_HIGHEST,
                        preferred_element_type=jnp.float32) * scale
    K = S_sink + S_ctx + T
    col = jax.lax.broadcasted_iota(jnp.int32, (T, K), 1)
    row = jax.lax.broadcasted_iota(jnp.int32, (T, K), 0)
    causal_bad = (col >= S_sink + S_ctx) & (col - (S_sink + S_ctx) > row)
    pad_bad = (col >= S_sink + ctx_len) & (col < S_sink + S_ctx)
    logits = jnp.where((causal_bad | pad_bad)[None, None], NEG_INF, logits)
    # f32 softmax — this is the model's attention (the flash kernels run an
    # f32 online softmax), NOT the score hook's deliberate bf16 round-trip
    probs = jax.nn.softmax(logits, axis=-1)
    out = jnp.einsum("hgtk,hkd->hgtd", probs, vals.astype(jnp.float32),
                     precision=_HIGHEST, preferred_element_type=jnp.float32)
    return out.transpose(2, 0, 1, 3).reshape(T, H, D).astype(out_dtype)


# ------------------------------------------------ evicted (segment) layouts
# After eviction the context KV is frozen in a "segment" layout: every kv
# head's kept rows back to back, each row tagged with its kv head
# (``row_head``, -1 on padding), plus a small bf16 append tail per head for
# the query/answer tokens (the reference's flattened varlen cache,
# `attention/kvcache.py:152-185` + `attention/attn.py:56-73`). The pool
# (`kvzip_tpu.pool`) concatenates all layers' segments with per-layer
# offsets; the flat layout (`cache.FlatKV`) stacks layers at one padded
# width. Keys are stored transposed, (D, rows).


def dequant_cols(packed: jax.Array, s: jax.Array, z: jax.Array,
                 dtype) -> jax.Array:
    """Split-packed int4 columns (D//2, R) uint8 with per-column scale and
    zero (R,) -> (D, R): byte j holds element j in the high nibble and
    j + D/2 in the low one (`ops.quant` ``pack="split"``)."""
    p = packed.astype(jnp.int32)
    n = jnp.concatenate([p >> 4, p & 0xF], axis=0).astype(jnp.float32)
    return (n * s.astype(jnp.float32) + z.astype(jnp.float32)).astype(dtype)


def pool_segment(arrays, row_head, layer_off, layer_rows, layer, max_rows: int):
    """One layer's window of a pool: ``arrays`` are pool arrays whose LAST
    axis is the pool row (K (D, P), V^T (D, P), scales (1, P), ...). Returns
    the (…, R) windows, R = min(max_rows, P), and the window's row heads
    with every row outside the layer's live range set to -1.

    The window start is clamped into the pool (as ``dynamic_slice`` would)
    and liveness is decided on absolute row numbers, so a clamp never
    shifts a row onto the wrong head."""
    P = row_head.shape[-1]
    R = min(max_rows, P)
    off = layer_off[layer]
    start = jnp.clip(off, 0, P - R)
    take = [jax.lax.dynamic_slice_in_dim(a, start, R, axis=a.ndim - 1)
            for a in arrays]
    rh = jax.lax.dynamic_slice_in_dim(row_head.reshape(P), start, R)
    g = start + jnp.arange(R, dtype=jnp.int32)
    live = (g >= off) & (g < off + layer_rows[layer])
    return take, jnp.where(live, rh, -1)


def segment_decode_attend(
    q: jax.Array,          # (T, H, D)
    k_seg: jax.Array,      # (D, R) keys, transposed
    v_seg: jax.Array,      # (R, D)
    rh_seg: jax.Array,     # (R,) int32 kv head of each row, -1 if not live
    k_tail: jax.Array,     # (Hkv, Tcap, D) — this call's T rows appended
    v_tail: jax.Array,     #   at tail_len already
    tail_len: jax.Array,   # () or (Hkv,) int32 tail rows before this call
    *,
    scale: float,
) -> jax.Array:
    """Decode attention over one layer's evicted segment plus its tail.

    The plain form of the evicted decode and the reference the pool kernel
    is compared with. Query head h reads segment rows with
    ``rh_seg == h // G`` and tail rows ``[0, tail_len + i + 1)`` for its
    i-th query. Merged batches (``n_seq`` sequences) need nothing extra:
    their row heads are already global (``b * Hkv + h``) and their query
    heads sequence-major, so ``h // G`` names the right sequence.
    float32 products at HIGHEST precision, float32 softmax; returns
    (T, H, D) in q's dtype.
    """
    T, H, D = q.shape
    Hkv, Tcap, _ = k_tail.shape
    G = H // Hkv
    f32 = jnp.float32
    qg = q.reshape(T, Hkv, G, D).astype(f32)
    s_ctx = jnp.einsum("thgd,dr->thgr", qg, k_seg.astype(f32),
                       precision=_HIGHEST) * scale
    heads = jnp.arange(Hkv, dtype=jnp.int32)
    s_ctx = jnp.where(rh_seg[None, None, None, :] == heads[None, :, None, None],
                      s_ctx, NEG_INF)
    s_tail = jnp.einsum("thgd,hcd->thgc", qg, k_tail.astype(f32),
                        precision=_HIGHEST) * scale
    tl = jnp.broadcast_to(jnp.asarray(tail_len, jnp.int32), (Hkv,))
    qi = jnp.arange(T, dtype=jnp.int32)
    col = jnp.arange(Tcap, dtype=jnp.int32)
    ok_tail = col[None, None, :] < (tl[None, :, None] + qi[:, None, None] + 1)
    s_tail = jnp.where(ok_tail[:, :, None, :], s_tail, NEG_INF)
    probs = jax.nn.softmax(jnp.concatenate([s_ctx, s_tail], axis=-1), axis=-1)
    R = k_seg.shape[1]
    out = (jnp.einsum("thgr,rd->thgd", probs[..., :R], v_seg.astype(f32),
                      precision=_HIGHEST)
           + jnp.einsum("thgc,hcd->thgd", probs[..., R:], v_tail.astype(f32),
                        precision=_HIGHEST))
    return out.reshape(T, H, D).astype(q.dtype)


def _layer_tail(k_tail, v_tail, layer):
    """(L, Hkv, Tcap, D) stacks -> the layer's (Hkv, Tcap, D) tails; a
    per-layer tail passes through."""
    if k_tail.ndim == 4:
        return k_tail[layer], v_tail[layer]
    return k_tail, v_tail


def pool_decode_reference(q, k_pool, v_pool, row_head, layer_off, layer_rows,
                          k_tail, v_tail, tail_len, layer, *, scale: float,
                          max_rows: int):
    """Plain decode over a bf16 pool (`pool.PoolKV` arrays): K (D, P),
    V (P, D), row_head (1, P); tails stacked (L, ...) or per layer."""
    (k_seg, vt_seg), rh = pool_segment(
        (k_pool, v_pool.T), row_head, layer_off, layer_rows, layer, max_rows)
    kt, vt = _layer_tail(k_tail, v_tail, layer)
    return segment_decode_attend(q, k_seg, vt_seg.T, rh, kt, vt, tail_len,
                                 scale=scale)


def pool_decode_int4(q, k_pool_q, k_pool_s, k_pool_z, v_pool_q, v_pool_s,
                     v_pool_z, row_head, layer_off, layer_rows, k_tail,
                     v_tail, tail_len, layer, *, scale: float, max_rows: int):
    """Decode over an int4 pool (`pool.PoolInt4KV` arrays): dequantise the
    layer's window, then :func:`segment_decode_attend`."""
    (kq, ks, kz, vq, vs, vz), rh = pool_segment(
        (k_pool_q, k_pool_s, k_pool_z, v_pool_q, v_pool_s, v_pool_z),
        row_head, layer_off, layer_rows, layer, max_rows)
    kt, vt = _layer_tail(k_tail, v_tail, layer)
    k_seg = dequant_cols(kq, ks, kz, q.dtype)
    v_seg = dequant_cols(vq, vs, vz, q.dtype).T
    return segment_decode_attend(q, k_seg, v_seg, rh, kt, vt, tail_len,
                                 scale=scale)


def flat_decode(q, k_flat, v_flat, row_head, k_tail, v_tail, tail_len, *,
                scale: float, layer=None):
    """Decode over the flat layout (`cache.FlatKV`): K (D, R), V (R, D),
    row_head (R,), or their (L, ...) stacks with ``layer``. Single and
    merged (sequence-major) caches alike; see :func:`segment_decode_attend`.
    """
    if layer is not None:
        k_flat, v_flat, row_head = k_flat[layer], v_flat[layer], row_head[layer]
    kt, vt = _layer_tail(k_tail, v_tail, layer)
    return segment_decode_attend(q, k_flat, v_flat, row_head, kt, vt,
                                 tail_len, scale=scale)


def flat_decode_int4(q, k_flat_q, k_flat_s, k_flat_z, v_flat_q, v_flat_s,
                     v_flat_z, row_head, k_tail, v_tail, tail_len, *,
                     scale: float, layer=None):
    """Decode over the int4 flat layout (`cache.FlatInt4KV`): nibbles
    (D//2, R) for K and V, scales/zeros (R,), or (L, ...) stacks."""
    arrs = (k_flat_q, k_flat_s, k_flat_z, v_flat_q, v_flat_s, v_flat_z,
            row_head)
    if layer is not None:
        arrs = tuple(a[layer] for a in arrs)
    kq, ks, kz, vq, vs, vz, rh = arrs
    kt, vt = _layer_tail(k_tail, v_tail, layer)
    return segment_decode_attend(
        q, dequant_cols(kq, ks, kz, q.dtype),
        dequant_cols(vq, vs, vz, q.dtype).T, rh, kt, vt, tail_len,
        scale=scale)
