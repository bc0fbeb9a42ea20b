"""Decode attention over the POOL layout (`kvzip_tpu.pool`): a Pallas
kernel for the GPU through the Triton route (``backend="triton"``).

It is the reference system's varlen flash decode (`attention/attn.py:
56-73`): each kv head's kept rows are one variable-length key sequence and
that head's GQA group is packed into the query rows. The plain form, and
the reference this kernel is checked against, is
`ops.attention.pool_decode_reference`.

Split-K flash decoding:

- the grid is (kv head, query tile, split). Within a layer's segment the
  rows of one kv head are contiguous (every pool builder writes head-major
  order), so the wrapper finds each head's [start, end) row range and the
  head's splits divide it; a block still masks its rows by ``row_head``, so
  the range only bounds the work and never decides correctness;
- the last split of every head attends over that head's bf16 tail
  (query/answer rows, causal in the query index);
- every split writes an unnormalised partial (o, m, l); a second pass in
  XLA combines the splits.

The kernel takes the whole pool and tail stacks plus the layer number, so
the decode scan never copies a per-layer slice of them.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltr

# masked logits: finite, so an all-masked block never produces inf - inf
_MASKED = -0.7 * float(np.finfo(np.float32).max)
_SM_COUNT = 132  # H100 SXM streaming multiprocessors


def _pow2_at_least(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def _online(carry, s, ok, v):
    """One flash step on logits ``s`` (rows, blk) with mask ``ok``."""
    o, m, l = carry
    s = jnp.where(ok, s, _MASKED)
    m_new = jnp.maximum(m, s.max(axis=-1))
    corr = jnp.exp(m - m_new)
    p = jnp.where(ok, jnp.exp(s - m_new[:, None]), 0.0)
    l_new = l * corr + p.sum(axis=-1)
    # p.V with p split into two bf16 terms (~16 mantissa bits): with one
    # bf16 p about a third of the bf16 outputs sit an ulp off the float32
    # reference; split, about one in five hundred
    p_hi = p.astype(v.dtype)
    p_lo = (p - p_hi.astype(jnp.float32)).astype(v.dtype)
    o_new = o * corr[:, None] + pl.dot(p_hi, v) + pl.dot(p_lo, v)
    return o_new, m_new, l_new


def _pool_kernel(meta_ref, q_ref, k_ref, v_ref, rh_ref, kt_ref, vt_ref,
                 o_ref, m_ref, l_ref, *, n_splits: int, block_k: int,
                 block_t: int, n_q: int, scale: float):
    h = pl.program_id(0)
    split = pl.program_id(2)
    block_q, D = q_ref.shape
    Tcap = kt_ref.shape[2]
    # [start, end) rows of this head in the pool, tail rows before this
    # call, and the tail stack's layer
    start, end, tail_len, layer = (meta_ref[0], meta_ref[1], meta_ref[2],
                                   meta_ref[3])
    q = q_ref[...]
    rows = pl.program_id(1) * block_q + jnp.arange(block_q)
    qi = rows % n_q
    init = (jnp.zeros((block_q, D), jnp.float32),
            jnp.full((block_q,), _MASKED, jnp.float32),
            jnp.zeros((block_q,), jnp.float32))

    def context():
        chunk = pl.cdiv(pl.cdiv(end - start, n_splits), block_k) * block_k
        lo = start + split * chunk
        hi = jnp.minimum(lo + chunk, end)
        n_blk = pl.cdiv(jnp.maximum(hi - lo, 0), block_k)

        def body(i, carry):
            j = lo + i * block_k
            cols = j + jnp.arange(block_k)
            live = cols < hi
            kT = pltr.load(k_ref.at[:, pl.ds(j, block_k)],
                           mask=live[None, :], other=0.0)
            rh = pltr.load(rh_ref.at[pl.ds(j, block_k)], mask=live, other=-1)
            v = pltr.load(v_ref.at[pl.ds(j, block_k), :],
                          mask=live[:, None], other=0.0)
            s = pl.dot(q, kT) * scale
            ok = jnp.broadcast_to((live & (rh == h))[None, :], s.shape)
            return _online(carry, s, ok, v)

        return jax.lax.fori_loop(0, n_blk, body, init)

    def tail():
        n = jnp.minimum(tail_len + n_q, Tcap)

        def body(i, carry):
            j = i * block_t
            cols = j + jnp.arange(block_t)
            live = cols < n
            kt = pltr.load(kt_ref.at[layer, h, pl.ds(j, block_t), :],
                           mask=live[:, None], other=0.0)
            vt = pltr.load(vt_ref.at[layer, h, pl.ds(j, block_t), :],
                           mask=live[:, None], other=0.0)
            s = pl.dot(q, kt.T) * scale
            ok = live[None, :] & (cols[None, :] < tail_len + qi[:, None] + 1)
            return _online(carry, s, ok, vt)

        return jax.lax.fori_loop(0, pl.cdiv(n, block_t), body, init)

    o, m, l = jax.lax.cond(split == n_splits, tail, context)
    o_ref[...] = o
    m_ref[...] = m
    l_ref[...] = l


def head_ranges(row_head, layer_off, layer_rows, layer, n_heads: int,
                max_rows: int):
    """(n_heads,) [start, end) pool rows of each kv head in the layer's
    live segment (start = end = 0 for a head with no rows): the smallest
    range holding all of the head's rows, whatever their order."""
    P = row_head.shape[-1]
    R = min(max_rows, P)
    off = layer_off[layer]
    base = jnp.clip(off, 0, P - R)
    rh = jax.lax.dynamic_slice_in_dim(row_head.reshape(P), base, R)
    g = base + jnp.arange(R, dtype=jnp.int32)
    live = (g >= off) & (g < off + layer_rows[layer])
    match = live[None, :] & (
        rh[None, :] == jnp.arange(n_heads, dtype=jnp.int32)[:, None])
    end = jnp.max(jnp.where(match, g + 1, 0), axis=1)
    start = jnp.min(jnp.where(match, g, P), axis=1)
    return jnp.where(end > 0, start, 0), end


def pick_splits(n_heads: int, q_tiles: int, max_rows: int,
                block_k: int) -> int:
    """Splits per head: enough programs for two waves over the SMs, but
    no split shorter than one key block on an even share of the rows."""
    want = max(1, (2 * _SM_COUNT) // (n_heads * q_tiles))
    most = max(1, max_rows // (n_heads * block_k))
    return _pow2_at_least(min(want, most))


@functools.partial(
    jax.jit,
    static_argnames=("scale", "max_rows", "block_k", "interpret"))
def pool_decode_attend(
    q: jax.Array,           # (T, H, D)
    k_pool: jax.Array,      # (D, P) keys, transposed
    v_pool: jax.Array,      # (P, D)
    row_head: jax.Array,    # (1, P) int32, -1 on padding
    layer_off: jax.Array,   # (L,) int32 first pool row of each layer
    layer_rows: jax.Array,  # (L,) int32 live rows of each layer
    k_tail: jax.Array,      # (L, Hkv, Tcap, D) or this layer's (Hkv, Tcap, D)
    v_tail: jax.Array,
    tail_len: jax.Array,    # () or (Hkv,) int32 tail rows before this call
    layer: jax.Array,       # () int32
    *,
    scale: float,
    max_rows: int,
    block_k: int = 64,
    interpret: bool = False,
) -> jax.Array:
    """Pool decode attention; same contract as
    `ops.attention.pool_decode_reference`. bf16 operands with float32
    accumulation; returns (T, H, D) in q's dtype. ``block_k``: key rows per
    block (64 and 128 measured alike on an H100; tests use 16 to cross
    several blocks at tiny sizes)."""
    T, H, D = q.shape
    tail_layer = layer
    if k_tail.ndim == 3:  # this layer's tails only
        k_tail, v_tail, tail_layer = k_tail[None], v_tail[None], 0
    _, Hkv, Tcap, _ = k_tail.shape
    G = H // Hkv
    GT = G * T
    block_q = min(64, max(16, _pow2_at_least(GT)))
    GTp = -(-GT // block_q) * block_q
    q_tiles = GTp // block_q
    n_splits = pick_splits(Hkv, q_tiles, max_rows, block_k)
    block_t = min(128, max(16, _pow2_at_least(Tcap)))

    # query rows of kv head h: (g, t) with t fastest
    qh = q.reshape(T, Hkv, G, D).transpose(1, 2, 0, 3).reshape(Hkv, GT, D)
    qh = jnp.pad(qh, ((0, 0), (0, GTp - GT), (0, 0)))
    start, end = head_ranges(row_head, layer_off, layer_rows, layer, Hkv,
                             max_rows)
    tl = jnp.broadcast_to(jnp.asarray(tail_len, jnp.int32), (Hkv,))
    meta = jnp.stack([start, end, tl, jnp.broadcast_to(
        jnp.asarray(tail_layer, jnp.int32), (Hkv,))], axis=1)

    S = n_splits + 1
    kernel = functools.partial(
        _pool_kernel, n_splits=n_splits, block_k=block_k, block_t=block_t,
        n_q=T, scale=scale)
    whole = lambda a: pl.BlockSpec(a.shape, lambda h, i, s: (0,) * a.ndim)
    rh = row_head.reshape(-1).astype(jnp.int32)
    o, m, l = pl.pallas_call(
        kernel,
        grid=(Hkv, q_tiles, S),
        in_specs=[
            pl.BlockSpec((None, 4), lambda h, i, s: (h, 0)),
            pl.BlockSpec((None, block_q, D), lambda h, i, s: (h, i, 0)),
            whole(k_pool), whole(v_pool), whole(rh),
            whole(k_tail), whole(v_tail),
        ],
        out_specs=[
            pl.BlockSpec((None, None, block_q, D),
                         lambda h, i, s: (s, h, i, 0)),
            pl.BlockSpec((None, None, block_q), lambda h, i, s: (s, h, i)),
            pl.BlockSpec((None, None, block_q), lambda h, i, s: (s, h, i)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((S, Hkv, GTp, D), jnp.float32),
            jax.ShapeDtypeStruct((S, Hkv, GTp), jnp.float32),
            jax.ShapeDtypeStruct((S, Hkv, GTp), jnp.float32),
        ],
        compiler_params=pltr.CompilerParams(num_warps=4, num_stages=2),
        backend="triton",
        interpret=interpret,
        name="pool_decode",
    )(meta, qh, k_pool, v_pool, rh, k_tail, v_tail)

    # combine the splits (the tail split always holds >= 1 live row)
    m_all = m.max(axis=0)
    w = jnp.exp(m - m_all[None])
    out = (o * w[..., None]).sum(axis=0) / (l * w).sum(axis=0)[..., None]
    out = out[:, :GT].reshape(Hkv, G, T, D).transpose(2, 0, 1, 3)
    return out.reshape(T, H, D).astype(q.dtype)
