"""Flat POOL decode layout: every layer's kept rows in ONE 1D pool.

The round-3 flat layout (`cache.FlatInt4KV`) stacks layers with a UNIFORM
padded row count ``r_pad = max over layers of kept rows``. That is fine at
pair level (layers keep similar counts) but degenerates at head level: any
layer that keeps all its heads forces r_pad = full capacity, so the "flat"
stack is as large as the dense cache and decode reads full-capacity traffic.

Here every layer's kept rows are concatenated into one pool:

- ``k_pool (D, P)`` keys TRANSPOSED, ``v_pool (P, D)``; the int4 pool keeps
  packed nibbles ``(D//2, P)`` for both with per-row scale/zero;
- per-layer ``layer_off`` row offsets, each a multiple of ``align``;
- per-layer live counts ``layer_rows``: a layer's live rows are
  ``[off, off + rows)``, head-major, and padding rows carry
  ``row_head = -1`` so they can never match a query head.

Decode attention reads the live rows of the CURRENT layer, whatever the
per-layer spread — the reference's flattened varlen view over per-head kept
rows (`attention/kvcache.py:152-185` + `attention/attn.py:56-73`, which the
reference uses for BOTH pair- and head-level eviction).

Memory discipline mirrors ``cache.build_flat_int4_stepped``: the builder
consumes the dense cache array-by-array (donated, synchronized), so peak =
dense + ONE pool array.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from kvzip_tpu.cache import Int4KVCache, KVCache, _flat_plan_int4


# Layer segments start on a 128-row boundary: 256-byte aligned bf16 key
# columns for the decode kernel's loads. The kernel needs nothing coarser
# (it finds each head's rows itself), and padding stays under 128 rows a
# layer.
POOL_ALIGN = 128


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _static(default=0):
    """Fresh static (treedef / jit-key) field per use — a shared
    ``dataclasses.field`` instance breaks dataclass field registration."""
    return dataclasses.field(metadata=dict(static=True), default=default)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class PoolInt4KV:
    """INT4 pool cache: packed context pool + bf16 per-layer append tails.

    Same tail/counter semantics as ``cache.FlatInt4KV`` (O(1)
    snapshot/restore by resetting ``tail_len``); only the frozen context
    storage differs (one (D//2, P) pool instead of a (L, D//2, R_pad)
    stack).
    """

    k_pool_q: jax.Array   # (D//2, P) uint8 — TRANSPOSED nibbles, all layers
    v_pool_q: jax.Array   # (D//2, P) uint8 — TRANSPOSED
    k_pool_s: jax.Array   # (1, P) f32 per-row scale
    k_pool_z: jax.Array   # (1, P) f32 per-row zero point
    v_pool_s: jax.Array
    v_pool_z: jax.Array
    row_head: jax.Array   # (1, P) int32 kv-head id, -1 on padding
    layer_off: jax.Array  # (L,) int32 row offset per layer (multiple of align)
    layer_rows: jax.Array  # (L,) int32 live rows per layer
    k_tail: jax.Array     # (L, H_kv, T_cap, D) bf16
    v_tail: jax.Array
    lengths: jax.Array    # (L, H_kv) int32 kept context rows
    tail_len: jax.Array   # () int32
    seen: jax.Array       # () int32
    # static geometry (host ints; part of the treedef / jit key)
    align: int = _static()    # layer offsets are multiples of this
    max_rows: int = _static()  # max over layers of round_up(live, align)
    # tensor-parallel layout (parallel/pool_tp.py): tp > 0 means the pool
    # columns hold tp uniform per-shard segments (sharded over "model"),
    # layer_off/layer_rows are (tp, L), and row_head holds LOCAL head ids
    tp: int = _static()
    mesh: object = _static(None)

    @property
    def capacity(self) -> int:
        return self.k_pool_q.shape[1]

    @property
    def num_layers(self) -> int:
        return self.layer_off.shape[0]

    @property
    def num_kv_heads(self) -> int:
        return self.k_tail.shape[1]

    def mem_bytes(self) -> int:
        ctx = (self.k_pool_q.size + self.v_pool_q.size
               + 4 * self.k_pool_s.size * self.k_pool_s.dtype.itemsize
               + self.row_head.size * self.row_head.dtype.itemsize)
        tail = self.k_tail.size * self.k_tail.dtype.itemsize * 2
        return ctx + tail

    def used_bytes(self) -> float:
        d = self.k_pool_q.shape[0]
        bytes_per_row = d + 2 * self.k_pool_s.dtype.itemsize
        rows = int(jax.device_get(self.lengths).sum())
        return float(rows * bytes_per_row * 2)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class PoolKV:
    """bf16 pool cache (non-quantized evict path)."""

    k_pool: jax.Array     # (D, P) — K TRANSPOSED
    v_pool: jax.Array     # (P, D)
    row_head: jax.Array   # (1, P) int32
    layer_off: jax.Array  # (L,) int32
    layer_rows: jax.Array  # (L,) int32
    k_tail: jax.Array     # (L, H_kv, T_cap, D)
    v_tail: jax.Array
    lengths: jax.Array    # (L, H_kv)
    tail_len: jax.Array
    seen: jax.Array
    align: int = _static()
    max_rows: int = _static()
    tp: int = _static()          # see PoolInt4KV
    mesh: object = _static(None)

    @property
    def capacity(self) -> int:
        return self.k_pool.shape[1]

    @property
    def num_layers(self) -> int:
        return self.layer_off.shape[0]

    @property
    def num_kv_heads(self) -> int:
        return self.k_tail.shape[1]

    def mem_bytes(self) -> int:
        ctx = ((self.k_pool.size + self.v_pool.size)
               * self.k_pool.dtype.itemsize
               + self.row_head.size * self.row_head.dtype.itemsize)
        tail = self.k_tail.size * self.k_tail.dtype.itemsize * 2
        return ctx + tail

    def used_bytes(self) -> float:
        d = self.k_pool.shape[0]
        rows = int(jax.device_get(self.lengths).sum())
        return float(rows * d * self.k_pool.dtype.itemsize * 2)


class ConsumedCache:
    """Sentinel the engine leaves in ``state.cache`` when a pool build dies
    mid-way: the builders gut the dense cache array-by-array (that IS the
    memory discipline that lets 480k fit), so after a failure the dense
    state is gone. Any attribute access explains that instead of surfacing
    an opaque ``NoneType`` error."""

    def __init__(self, note: str):
        object.__setattr__(self, "_note", note)

    def __getattr__(self, name):
        raise RuntimeError(
            "the dense KV cache was consumed by a pool build that then "
            f"failed ({object.__getattribute__(self, '_note')}); the state "
            "is unusable — re-run prefill")


# --------------------------------------------------------------- planning
def plan_offsets(per_layer_rows: np.ndarray, align: int
                 ) -> Tuple[np.ndarray, int, int, int]:
    """Host-side pool geometry from per-layer LIVE row counts.

    Returns (layer_off row offsets, alloc columns, r_max gather width,
    max_rows). Each layer's segment is padded to an ``align`` multiple
    (>= one ``align`` block even for empty layers); the allocation leaves
    ``r_max`` columns after the
    last offset because the builders write a uniform ``r_max``-wide slab
    per layer (forward order — each later layer's write overwrites the
    previous layer's spill).
    """
    r_pad = np.maximum(align, _round_up_arr(per_layer_rows, align))
    off = np.zeros_like(r_pad)
    off[1:] = np.cumsum(r_pad)[:-1]
    r_max = int(r_pad.max())
    alloc = int(off[-1] + r_max)
    return off.astype(np.int32), alloc, r_max, r_max


def _round_up_arr(a: np.ndarray, m: int) -> np.ndarray:
    return ((a + m - 1) // m) * m


# --------------------------------------------------------------- builders
@partial(jax.jit, donate_argnums=(0,), static_argnums=(4,))
def _pool_gather_kt(a: jax.Array, take: jax.Array, kept: jax.Array,
                    off: jax.Array, alloc: int) -> jax.Array:
    """(L, H, W, C) transposed nibbles/rows -> (W, alloc) pool, donating
    the dense array. Writes a full take-width slab per layer in FORWARD
    order: layer l's spill into [off_l + r_pad_l, off_l + r_max) is
    overwritten by layer l+1's slab (off monotone, slabs uniform width)."""
    L, H, W, C = a.shape
    pool = jnp.zeros((W, alloc), a.dtype)

    def body(l, pool):
        a_l = jax.lax.dynamic_index_in_dim(a, l, 0, keepdims=False)
        av = a_l.transpose(1, 0, 2).reshape(W, H * C)
        t = jax.lax.dynamic_index_in_dim(take, l, 0, keepdims=False)
        kk = jax.lax.dynamic_index_in_dim(kept, l, 0, keepdims=False)
        rows = jnp.take_along_axis(av, t[None, :], axis=1)
        rows = jnp.where(kk[None, :], rows, 0)
        return jax.lax.dynamic_update_slice(pool, rows, (0, off[l]))

    return jax.lax.fori_loop(0, L, body, pool)


@partial(jax.jit, donate_argnums=(0,), static_argnums=(4,))
def _pool_gather_scale(a: jax.Array, take: jax.Array, kept: jax.Array,
                       off: jax.Array, alloc: int) -> jax.Array:
    """(L, H, C, 1) scale/zero rows -> (1, alloc) f32 pool, donated."""
    L, H, C, _ = a.shape
    pool = jnp.zeros((1, alloc), jnp.float32)

    def body(l, pool):
        a_l = jax.lax.dynamic_index_in_dim(a, l, 0, keepdims=False)
        t = jax.lax.dynamic_index_in_dim(take, l, 0, keepdims=False)
        kk = jax.lax.dynamic_index_in_dim(kept, l, 0, keepdims=False)
        row = jnp.take_along_axis(a_l.reshape(H * C), t, axis=0)
        row = jnp.where(kk, row, 0).astype(jnp.float32)
        return jax.lax.dynamic_update_slice(pool, row[None], (0, off[l]))

    return jax.lax.fori_loop(0, L, body, pool)


@partial(jax.jit, static_argnums=(4,))
def _pool_row_head(take: jax.Array, kept: jax.Array, off: jax.Array,
                   C: int, alloc: int) -> jax.Array:
    """(1, alloc) int32 kv-head id per pool row (-1 padding)."""
    L = take.shape[0]
    pool = jnp.full((1, alloc), -1, jnp.int32)

    def body(l, pool):
        t = jax.lax.dynamic_index_in_dim(take, l, 0, keepdims=False)
        kk = jax.lax.dynamic_index_in_dim(kept, l, 0, keepdims=False)
        row = jnp.where(kk, (t // C).astype(jnp.int32), -1)
        return jax.lax.dynamic_update_slice(pool, row[None], (0, off[l]))

    return jax.lax.fori_loop(0, L, body, pool)


def _plan(cache, keep: jax.Array, sink: int, align: int):
    """Shared prologue: host geometry + device gather plan."""
    H = cache.num_kv_heads
    C = cache.capacity
    per_layer = np.asarray(
        jax.device_get(keep.sum(axis=(1, 2)))) + sink * H
    off_np, alloc, r_max, _ = plan_offsets(per_layer, align)
    # the gather slab cannot be wider than the source columns; segments
    # beyond the slab stay at their initialized padding (zeros / -1)
    w = min(r_max, H * C)
    take, kept, lengths, _ = _flat_plan_int4(keep, sink, w, C)
    jax.block_until_ready(take)
    off = jnp.asarray(off_np)
    max_rows = int(np.maximum(align, _round_up_arr(per_layer, align)).max())
    return take, kept, lengths, off, alloc, C, max_rows


def build_pool_int4_stepped(cache: Int4KVCache, keep: jax.Array, sink: int,
                            tail_cap: int, dtype=jnp.bfloat16,
                            align: int = POOL_ALIGN) -> PoolInt4KV:
    """Compact a dense INT4 cache into the pool layout with bounded peak.

    Each gather donates its dense source and synchronizes before the next
    (cf. ``cache.build_flat_int4_stepped``), so compaction fits whenever
    dense + ONE pool array fits. Packed rows move verbatim — no
    requantization. The dense cache is CONSUMED.
    """
    L, H, Dp, C0 = cache.k_q.shape
    assert cache.k_s.shape[-1] == 1, "pool int4 needs one quant group per row"
    take, kept, lengths, off, alloc, C, max_rows = _plan(
        cache, keep, sink, align)

    # Donation of the dense sources is a best-effort hint XLA routinely
    # CANNOT honor here (a (L,H,W,C) input cannot alias a (W,alloc)
    # output — "donated buffers were not usable"). The real memory
    # discipline is dropping each dense reference right after its gather:
    # holding them all on the `cache` dataclass kept dense K resident
    # through the V gather.
    seen = cache.seen
    srcs = dict(k_s=cache.k_s, k_z=cache.k_z, v_s=cache.v_s, v_z=cache.v_z,
                k_q=cache.k_q, v_q=cache.v_q)
    # gut the input dataclass IN PLACE: the caller's state.cache still
    # points at it until we return, so clearing our local alone would
    # keep every dense array alive (the dense cache is CONSUMED)
    for f in srcs:
        setattr(cache, f, None)
    cache = None

    def step(fn, name):
        a = srcs.pop(name)
        out = fn(a, take, kept, off, alloc)
        del a
        jax.block_until_ready(out)
        return out

    # scales first: frees the small dense arrays before the big nibble moves
    k_pool_s = step(_pool_gather_scale, "k_s")
    k_pool_z = step(_pool_gather_scale, "k_z")
    v_pool_s = step(_pool_gather_scale, "v_s")
    v_pool_z = step(_pool_gather_scale, "v_z")
    k_pool_q = step(_pool_gather_kt, "k_q")
    v_pool_q = step(_pool_gather_kt, "v_q")
    row_head = _pool_row_head(take, kept, off, C, alloc)

    return PoolInt4KV(
        k_pool_q=k_pool_q, v_pool_q=v_pool_q,
        k_pool_s=k_pool_s, k_pool_z=k_pool_z,
        v_pool_s=v_pool_s, v_pool_z=v_pool_z,
        row_head=row_head, layer_off=off,
        layer_rows=lengths.sum(axis=1).astype(jnp.int32),
        k_tail=jnp.zeros((L, H, tail_cap, Dp * 2), dtype),
        v_tail=jnp.zeros((L, H, tail_cap, Dp * 2), dtype),
        lengths=lengths, tail_len=jnp.zeros((), jnp.int32), seen=seen,
        align=align, max_rows=max_rows)


@partial(jax.jit, donate_argnums=(0,), static_argnums=(4,))
def _pool_gather_k_bf16(a: jax.Array, take, kept, off, alloc: int):
    """(L, H, C, D) K rows -> (D, alloc) TRANSPOSED pool, donated."""
    L, H, C, D = a.shape
    pool = jnp.zeros((D, alloc), a.dtype)

    def body(l, pool):
        a_l = jax.lax.dynamic_index_in_dim(a, l, 0, keepdims=False)
        av = a_l.reshape(H * C, D)
        t = jax.lax.dynamic_index_in_dim(take, l, 0, keepdims=False)
        kk = jax.lax.dynamic_index_in_dim(kept, l, 0, keepdims=False)
        rows = jnp.take_along_axis(av, t[:, None], axis=0)
        rows = jnp.where(kk[:, None], rows, 0)
        return jax.lax.dynamic_update_slice(pool, rows.T, (0, off[l]))

    return jax.lax.fori_loop(0, L, body, pool)


@partial(jax.jit, donate_argnums=(0,), static_argnums=(4,))
def _pool_gather_v_bf16(a: jax.Array, take, kept, off, alloc: int):
    """(L, H, C, D) V rows -> (alloc, D) pool, donated."""
    L, H, C, D = a.shape
    pool = jnp.zeros((alloc, D), a.dtype)

    def body(l, pool):
        a_l = jax.lax.dynamic_index_in_dim(a, l, 0, keepdims=False)
        av = a_l.reshape(H * C, D)
        t = jax.lax.dynamic_index_in_dim(take, l, 0, keepdims=False)
        kk = jax.lax.dynamic_index_in_dim(kept, l, 0, keepdims=False)
        rows = jnp.take_along_axis(av, t[:, None], axis=0)
        rows = jnp.where(kk[:, None], rows, 0)
        return jax.lax.dynamic_update_slice(pool, rows, (off[l], 0))

    return jax.lax.fori_loop(0, L, body, pool)


def build_pool_stepped(cache: KVCache, keep: jax.Array, sink: int,
                       tail_cap: int, align: int = POOL_ALIGN) -> PoolKV:
    """bf16 variant of :func:`build_pool_int4_stepped` (dense consumed)."""
    L, H, C0, D = cache.k.shape
    take, kept, lengths, off, alloc, C, max_rows = _plan(
        cache, keep, sink, align)

    # drop dense refs step-by-step (see build_pool_int4_stepped): donation
    # cannot alias these shapes, so the reference IS the memory; gut the
    # caller-visible dataclass too (dense cache CONSUMED)
    seen = cache.seen
    dtype = cache.k.dtype
    k_src, v_src = cache.k, cache.v
    cache.k = None
    cache.v = None
    cache = None

    k_pool = _pool_gather_k_bf16(k_src, take, kept, off, alloc)
    del k_src
    jax.block_until_ready(k_pool)
    v_pool = _pool_gather_v_bf16(v_src, take, kept, off, alloc)
    del v_src
    jax.block_until_ready(v_pool)
    row_head = _pool_row_head(take, kept, off, C, alloc)

    return PoolKV(
        k_pool=k_pool, v_pool=v_pool, row_head=row_head, layer_off=off,
        layer_rows=lengths.sum(axis=1).astype(jnp.int32),
        k_tail=jnp.zeros((L, H, tail_cap, D), dtype),
        v_tail=jnp.zeros((L, H, tail_cap, D), dtype),
        lengths=lengths, tail_len=jnp.zeros((), jnp.int32), seen=seen,
        align=align, max_rows=max_rows)


# ------------------------------------------------- full-occupancy baseline
def synthetic_full_pool(num_layers: int, num_kv_heads: int, head_dim: int,
                        per_head_rows: int, tail_cap: int,
                        dtype=jnp.bfloat16, int4: bool = True,
                        align: int = POOL_ALIGN, seen: int = 0):
    """Full-occupancy pool with the exact geometry a real all-rows-kept
    build produces — the honest full-cache decode baseline after the dense
    cache has been donated away (decode time does not depend on the
    values; constant fill avoids jax.random's full-shape int32 temporary).

    cf. ``Engine.synthetic_full_flat_state`` (round-2/3 baseline); the pool
    form serves head-level runs too.
    """
    L, H, D = num_layers, num_kv_heads, head_dim
    rows_l = H * per_head_rows
    per_layer = np.full((L,), rows_l, np.int64)
    off_np, alloc, r_max, _ = plan_offsets(per_layer, align)

    rh = np.full((alloc,), -1, np.int32)
    for l in range(L):
        o = int(off_np[l])
        rh[o:o + rows_l] = np.repeat(
            np.arange(H, dtype=np.int32), per_head_rows)
    row_head = jnp.asarray(rh)[None]

    common = dict(
        row_head=row_head,
        layer_off=jnp.asarray(off_np),
        layer_rows=jnp.full((L,), rows_l, jnp.int32),
        k_tail=jnp.zeros((L, H, tail_cap, D), dtype),
        v_tail=jnp.zeros((L, H, tail_cap, D), dtype),
        lengths=jnp.full((L, H), per_head_rows, jnp.int32),
        tail_len=jnp.zeros((), jnp.int32),
        seen=jnp.asarray(seen or per_head_rows, jnp.int32),
        align=align,
        max_rows=int(np.maximum(align, _round_up_arr(per_layer, align)).max()),
    )
    if int4:
        return PoolInt4KV(
            k_pool_q=jnp.full((D // 2, alloc), 0x5A, jnp.uint8),
            v_pool_q=jnp.full((D // 2, alloc), 0xA5, jnp.uint8),
            k_pool_s=jnp.full((1, alloc), 0.01, jnp.float32),
            k_pool_z=jnp.full((1, alloc), -0.05, jnp.float32),
            v_pool_s=jnp.full((1, alloc), 0.01, jnp.float32),
            v_pool_z=jnp.full((1, alloc), -0.05, jnp.float32),
            **common)
    return PoolKV(
        k_pool=jnp.full((D, alloc), 0.02, dtype),
        v_pool=jnp.full((alloc, D), 0.03, dtype),
        **common)


# --------------------------------------------------------- refold (multi-turn)
def refold_pool(cache, r_hint: int = 0):
    """Fold committed tail rows (query/answer KV of ``update_cache=True``
    turns) into the pool so the tail empties and decoding can continue —
    the pool counterpart of ``cache.refold_flat`` (reference re-gathers its
    flattened cache every ``slice``, `attention/kvcache.py:82-106`).

    Per layer: the segment keeps head-major order, with each head's tail
    rows (quantized for the int4 pool, like every other context row)
    appended after that head's kept rows via one stable argsort + gather.
    Shapes stay uniform across layers (width = old r_max + H*T_cap), so the
    whole fold is one compiled program per geometry.
    """
    from kvzip_tpu.ops.quant import quantize_int4

    is_int4 = isinstance(cache, PoolInt4KV)
    L = cache.num_layers
    H = cache.num_kv_heads
    Tcap = cache.k_tail.shape[2]
    D = cache.k_tail.shape[3]
    align = cache.align

    tail_n = int(jax.device_get(cache.tail_len))
    per_layer = (np.asarray(jax.device_get(cache.layer_rows))
                 + H * tail_n).astype(np.int64)
    off_np, alloc, r_max_new, _ = plan_offsets(per_layer, align)
    width = cache.max_rows + H * Tcap  # uniform per-layer source width
    # the last layer's uniform width-wide slab must fit (a clamped
    # dynamic_update_slice would silently shift the write)
    alloc = max(alloc, int(off_np[-1]) + _round_up(width, align))

    def to_cols(t):  # (L, H, Tcap, W) -> (L, W, H*Tcap), head-major columns
        return t.transpose(0, 3, 1, 2).reshape(L, t.shape[3], H * Tcap)

    if is_int4:
        kq_t, ks_t, kz_t = quantize_int4(cache.k_tail, pack="split")
        vq_t, vs_t, vz_t = quantize_int4(cache.v_tail, pack="split")
        pools_col = dict(
            k_pool_q=(cache.k_pool_q, to_cols(kq_t)),
            v_pool_q=(cache.v_pool_q, to_cols(vq_t)),
            k_pool_s=(cache.k_pool_s,
                      ks_t[..., 0].astype(jnp.float32).reshape(L, 1, H * Tcap)),
            k_pool_z=(cache.k_pool_z,
                      kz_t[..., 0].astype(jnp.float32).reshape(L, 1, H * Tcap)),
            v_pool_s=(cache.v_pool_s,
                      vs_t[..., 0].astype(jnp.float32).reshape(L, 1, H * Tcap)),
            v_pool_z=(cache.v_pool_z,
                      vz_t[..., 0].astype(jnp.float32).reshape(L, 1, H * Tcap)),
        )
        pools_row = {}
    else:
        pools_col = dict(k_pool=(cache.k_pool, to_cols(cache.k_tail)))
        pools_row = dict(
            v_pool=(cache.v_pool, cache.v_tail.reshape(L, H * Tcap, D)))

    # old segment widths: the uniform r_max_old slice read per layer may
    # run into the NEXT layer's rows — mask positions beyond each layer's
    # own allocated width (last layer's width is exactly max_rows)
    off_old = np.asarray(jax.device_get(cache.layer_off))
    seg_w = np.concatenate(
        [np.diff(off_old), [cache.max_rows]]).astype(np.int32)

    out = _refold_gather(
        pools_col, pools_row, cache.row_head, cache.layer_off,
        jnp.asarray(off_np), jnp.asarray(seg_w), cache.tail_len,
        cache.max_rows, Tcap, alloc, width)

    new_lengths = cache.lengths + tail_n
    return dataclasses.replace(
        cache, **out,
        layer_off=jnp.asarray(off_np),
        layer_rows=cache.layer_rows + H * tail_n,
        k_tail=jnp.zeros_like(cache.k_tail),
        v_tail=jnp.zeros_like(cache.v_tail),
        lengths=new_lengths, tail_len=jnp.zeros((), jnp.int32),
        max_rows=int(np.maximum(
            align, _round_up_arr(per_layer, align)).max()))


@partial(jax.jit, static_argnums=(7, 8, 9, 10))
def _refold_gather(pools_col: dict, pools_row: dict, row_head, layer_off,
                   off_new, seg_w, tail_len, r_max_old: int, Tcap: int,
                   alloc: int, width: int):
    """One fori_loop over layers: per layer, concat [old segment, tail rows]
    along the row axis, stable-sort by (head, old-before-tail), write the
    first ``width`` entries into the new pool (forward-overwrite slabs,
    like the builders).

    pools_col: name -> ((W, P) pool, (L, W, H*Tcap) tail columns);
    pools_row: name -> ((P, D) pool, (L, H*Tcap, D) tail rows).
    """
    L = layer_off.shape[0]
    if pools_col:
        HT_tail = next(iter(pools_col.values()))[1].shape[2]
    else:
        HT_tail = next(iter(pools_row.values()))[1].shape[1]
    H = HT_tail // Tcap
    BIG = jnp.int32(2 ** 30)

    t_head = jnp.repeat(jnp.arange(H, dtype=jnp.int32), Tcap)   # (H*Tcap,)
    t_pos = jnp.tile(jnp.arange(Tcap, dtype=jnp.int32), H)

    outs = {k: jnp.zeros((v[0].shape[0], alloc), v[0].dtype)
            for k, v in pools_col.items()}
    outs.update({k: jnp.zeros((alloc, v[0].shape[1]), v[0].dtype)
                 for k, v in pools_row.items()})
    rh_out = jnp.full((1, alloc), -1, jnp.int32)

    def body(l, carry):
        outs, rh_out = carry
        o = layer_off[l]
        rh_seg = jax.lax.dynamic_slice(row_head, (0, o), (1, r_max_old))[0]
        in_seg = jnp.arange(r_max_old, dtype=jnp.int32) < seg_w[l]
        key_old = jnp.where(in_seg & (rh_seg >= 0), rh_seg, BIG)
        key_tail = jnp.where(t_pos < tail_len, t_head, BIG)
        keys = jnp.concatenate([key_old, key_tail])
        order = jnp.argsort(keys, stable=True)[:width]
        okeys = jnp.take(keys, order)
        kept = okeys < BIG
        rh_new = jnp.where(kept, okeys.astype(jnp.int32), -1)
        rh_out = jax.lax.dynamic_update_slice(
            rh_out, rh_new[None], (0, off_new[l]))

        new_outs = dict(outs)
        for name, (pool, tail) in pools_col.items():
            W = pool.shape[0]
            seg = jax.lax.dynamic_slice(pool, (0, o), (W, r_max_old))
            tl = jax.lax.dynamic_index_in_dim(
                tail, l, 0, keepdims=False).astype(pool.dtype)
            src = jnp.concatenate([seg, tl], axis=1)
            cols = jnp.take(src, order, axis=1)
            cols = jnp.where(kept[None, :], cols, 0)
            new_outs[name] = jax.lax.dynamic_update_slice(
                outs[name], cols, (0, off_new[l]))
        for name, (pool, tail) in pools_row.items():
            Dd = pool.shape[1]
            seg = jax.lax.dynamic_slice(pool, (o, 0), (r_max_old, Dd))
            tl = jax.lax.dynamic_index_in_dim(
                tail, l, 0, keepdims=False).astype(pool.dtype)
            src = jnp.concatenate([seg, tl], axis=0)
            rows = jnp.take(src, order, axis=0)
            rows = jnp.where(kept[:, None], rows, 0)
            new_outs[name] = jax.lax.dynamic_update_slice(
                outs[name], rows, (off_new[l], 0))
        return new_outs, rh_out

    outs, rh_out = jax.lax.fori_loop(0, L, body, (outs, rh_out))
    outs["row_head"] = rh_out
    return outs
