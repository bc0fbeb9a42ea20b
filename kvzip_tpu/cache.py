"""KV cache for KVzip-style query-agnostic compression.

Design (vs reference `/root/reference/attention/kvcache.py`):

- Fixed-capacity per-(layer, head) buffers ``k/v: (L, H_kv, C, D)`` with an
  int32 ``lengths: (L, H_kv)`` vector — appends are O(1)
  ``dynamic_update_slice`` writes at ``lengths[l,h]``. This removes the
  reference's realloc-per-token copy (`attention/kvcache.py:57-73` +
  `csrc/csrc/cuda_api.cu:15-66` reallocate the whole flattened cache every
  decode step) and keeps every shape static for XLA.

- ``RetainCache`` semantics (reference `kvcache.py:216-347`) = same buffers +
  a boolean ``valid`` mask consulted by attention (additive -inf). One prefill
  can then be swept over many compression ratios.

- ``EvictCache`` semantics (reference `kvcache.py:14-213`) = one-shot
  compaction gather into a smaller-capacity buffer with ragged per-head
  lengths; decode uses ragged attention over ``lengths``.

- The reference's ``slice`` (drop query/answer KV to reuse the compressed
  context cache, `kvcache.py:82-106`) is O(1) here: appended rows live at
  ``[lengths, lengths+T)`` and attention only reads ``[0, len)``, so restoring
  the ``lengths``/``seen`` counters restores the cache. No gather, no copy.

The cache is a pytree and is threaded functionally through jitted steps;
engine-level code donates it so XLA performs updates in place.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from kvzip_tpu.config import ModelConfig


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class KVCache:
    """KV cache state (batch=1 per sequence, like the reference harness)."""

    k: jax.Array            # (L, H_kv, C, D)
    v: jax.Array            # (L, H_kv, C, D)
    lengths: jax.Array      # (L, H_kv) int32 — valid rows per layer/head
    seen: jax.Array         # ()  int32 — tokens processed (rope position base)
    valid: jax.Array        # (L, H_kv, C) bool — retain-path attendability mask

    @property
    def capacity(self) -> int:
        return self.k.shape[2]

    @property
    def num_layers(self) -> int:
        return self.k.shape[0]

    @property
    def num_kv_heads(self) -> int:
        return self.k.shape[1]

    def mem_bytes(self) -> int:
        """Bytes held by K+V buffers (reference `_mem`, kvcache.py:114-121)."""
        return self.k.size * self.k.dtype.itemsize * 2

    def used_bytes(self) -> float:
        """Bytes of *live* KV (per-head lengths), the post-eviction footprint."""
        d = self.k.shape[-1]
        rows = int(jax.device_get(self.lengths).sum())
        return float(rows * d * self.k.dtype.itemsize * 2)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Int4KVCache:
    """INT4-quantized KV cache: packed nibbles + per-group scale/zero.

    Counterpart of the reference ``OptimINT4KVCache``
    (`model/quant_model/int4_kv.py:274-314`), but composable with BOTH the
    retain and evict paths (the reference forces retain-only,
    `model/wrapper.py:71-73`) and dequantized tile-wise inside attention
    instead of whole-cache-to-fp16 (`int4_kv.py:242-267`).
    """

    k_q: jax.Array          # (L, H_kv, D//2, C) uint8 packed — TRANSPOSED
    v_q: jax.Array          # (L, H_kv, D//2, C) uint8 packed — TRANSPOSED
    k_s: jax.Array          # (L, H_kv, C, D//G) scales
    k_z: jax.Array          # (L, H_kv, C, D//G) zero points
    v_s: jax.Array
    v_z: jax.Array
    lengths: jax.Array      # (L, H_kv) int32
    seen: jax.Array         # () int32
    valid: jax.Array        # (L, H_kv, C) bool

    @property
    def capacity(self) -> int:
        return self.k_s.shape[2]

    @property
    def num_layers(self) -> int:
        return self.k_q.shape[0]

    @property
    def num_kv_heads(self) -> int:
        return self.k_q.shape[1]

    def mem_bytes(self) -> int:
        per = (self.k_q.size * self.k_q.dtype.itemsize
               + self.k_s.size * self.k_s.dtype.itemsize * 2)
        return per * 2

    def used_bytes(self) -> float:
        bytes_per_row = (self.k_q.shape[-2] * self.k_q.dtype.itemsize
                         + 2 * self.k_s.shape[-1] * self.k_s.dtype.itemsize)
        rows = int(jax.device_get(self.lengths).sum())
        return float(rows * bytes_per_row * 2)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class FlatKV:
    """Flat compacted decode cache: frozen context + small append tail.

    Built once at prune time for the evict path. ``k_flat/v_flat`` hold every
    head's kept rows densely concatenated (head-major, original order) so
    decode attention reads exactly the live footprint; ``row_head`` maps each
    flat row to its kv head (-1 on padding). Query/answer KV lands in the
    per-head ``k_tail/v_tail`` buffer and is dropped by resetting
    ``tail_len`` (the reference's ``slice``, `attention/kvcache.py:82-106`,
    without any gather).
    """

    k_flat: jax.Array    # (L, D, R_pad) — K TRANSPOSED (NN score matmul)
    v_flat: jax.Array    # (L, R_pad, D)
    row_head: jax.Array  # (L, R_pad) int32
    k_tail: jax.Array    # (L, H_kv, T_cap, D)
    v_tail: jax.Array
    lengths: jax.Array   # (L, H_kv) int32 — frozen kept context rows
    tail_len: jax.Array  # () int32
    seen: jax.Array      # () int32

    @property
    def capacity(self) -> int:
        return self.k_flat.shape[2]

    @property
    def num_layers(self) -> int:
        return self.k_flat.shape[0]

    @property
    def num_kv_heads(self) -> int:
        return self.k_tail.shape[1]

    def mem_bytes(self) -> int:
        per = (self.k_flat.size + self.k_tail.size) * self.k_flat.dtype.itemsize
        return per * 2

    def used_bytes(self) -> float:
        d = self.k_flat.shape[1]
        rows = int(jax.device_get(self.lengths).sum())
        return float(rows * d * self.k_flat.dtype.itemsize * 2)


def _build_flat(cache: KVCache, keep: jax.Array, sink: int, r_pad: int,
                tail_cap: int,
                static_mask=None) -> FlatKV:
    """Compact a dense cache into the flat decode layout.

    keep: (L, H, ctx_len) bool over the context region. r_pad: static padded
    flat row count (>= max over layers of kept rows). One stable argsort +
    gather per layer — the equivalent of reference ``prepare_init``
    (`attention/kvcache.py:152-185`). Jitted so the gather's broadcast index
    arrays fuse instead of materializing (a multi-GB eager temporary at
    131k).
    """
    L, H, C, D = cache.k.shape
    ctx_len = keep.shape[-1]

    keep_full = jnp.zeros((L, H, C), jnp.bool_)
    keep_full = keep_full.at[:, :, :sink].set(True)
    keep_full = jax.lax.dynamic_update_slice(
        keep_full, keep.astype(jnp.bool_), (0, 0, sink))
    col = jax.lax.broadcasted_iota(jnp.int32, (L, H, C), 2)
    keep_full &= col < sink + ctx_len
    if static_mask is not None:
        keep_full = jnp.where(static_mask[:, None, None], keep_full,
                              col < sink + ctx_len)

    flat_keep = keep_full.reshape(L, H * C)
    order = jnp.argsort(~flat_keep, axis=-1, stable=True)  # kept first,
    take = order[:, :r_pad]                                # head-major order

    kept_flags = jnp.take_along_axis(flat_keep, take, axis=1)
    k_flat = jnp.take_along_axis(cache.k.reshape(L, H * C, D),
                                 take[..., None], axis=1)
    v_flat = jnp.take_along_axis(cache.v.reshape(L, H * C, D),
                                 take[..., None], axis=1)
    k_flat = jnp.where(kept_flags[..., None], k_flat, 0)
    v_flat = jnp.where(kept_flags[..., None], v_flat, 0)
    row_head = jnp.where(kept_flags, (take // C).astype(jnp.int32), -1)

    return FlatKV(
        k_flat=k_flat.transpose(0, 2, 1), v_flat=v_flat, row_head=row_head,
        k_tail=jnp.zeros((L, H, tail_cap, D), cache.k.dtype),
        v_tail=jnp.zeros((L, H, tail_cap, D), cache.k.dtype),
        lengths=keep_full.sum(axis=-1).astype(jnp.int32),
        tail_len=jnp.zeros((), jnp.int32),
        seen=cache.seen,
    )


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class FlatInt4KV:
    """Flat compacted decode cache with INT4 context rows (split packing,
    one quant group per row — head_dim == group_size) + bf16 tail.

    Same structure as :class:`FlatKV`; context K/V live as packed nibbles
    with per-row scale/zero so decode HBM traffic is ~4x below bf16. The
    tail (query/answer KV) stays bf16 — it is tiny and quality-critical.
    """

    k_flat_q: jax.Array  # (L, D//2, R_pad) uint8 — K nibbles TRANSPOSED
    v_flat_q: jax.Array  # (L, D//2, R_pad) uint8 — V nibbles TRANSPOSED too:
    #   the pool and dense int4 caches keep the same (D//2, rows) columns,
    #   so compaction moves packed rows verbatim.
    k_flat_s: jax.Array  # (L, R_pad) scales
    k_flat_z: jax.Array  # (L, R_pad) zero points
    v_flat_s: jax.Array
    v_flat_z: jax.Array
    row_head: jax.Array  # (L, R_pad) int32
    k_tail: jax.Array    # (L, H_kv, T_cap, D) bf16
    v_tail: jax.Array
    lengths: jax.Array   # (L, H_kv) int32
    tail_len: jax.Array  # () int32
    seen: jax.Array      # () int32

    @property
    def capacity(self) -> int:
        return self.k_flat_q.shape[2]

    @property
    def num_layers(self) -> int:
        return self.k_flat_q.shape[0]

    @property
    def num_kv_heads(self) -> int:
        return self.k_tail.shape[1]

    def mem_bytes(self) -> int:
        ctx = (self.k_flat_q.size
               + self.k_flat_s.size * self.k_flat_s.dtype.itemsize * 2)
        tail = self.k_tail.size * self.k_tail.dtype.itemsize
        return (ctx + tail) * 2

    def used_bytes(self) -> float:
        d = self.k_flat_q.shape[1]
        bytes_per_row = d + 2 * self.k_flat_s.dtype.itemsize
        rows = int(jax.device_get(self.lengths).sum())
        return float(rows * bytes_per_row * 2)


def _build_flat_int4(cache: Int4KVCache, keep: jax.Array, sink: int,
                     r_pad: int, tail_cap: int, dtype=jnp.bfloat16) -> FlatInt4KV:
    """Compact an INT4 cache into the flat decode layout (packed rows move
    verbatim — no requantization). K nibbles are already transposed in the
    dense cache, so the K gather lands directly in the flat transposed
    layout."""
    L, H, Dp, C = cache.k_q.shape
    assert cache.k_s.shape[-1] == 1, "flat int4 needs one quant group per row"
    ctx_len = keep.shape[-1]

    keep_full = jnp.zeros((L, H, C), jnp.bool_)
    keep_full = keep_full.at[:, :, :sink].set(True)
    keep_full = jax.lax.dynamic_update_slice(
        keep_full, keep.astype(jnp.bool_), (0, 0, sink))
    col = jax.lax.broadcasted_iota(jnp.int32, (L, H, C), 2)
    keep_full &= col < sink + ctx_len

    flat_keep = keep_full.reshape(L, H * C)
    order = jnp.argsort(~flat_keep, axis=-1, stable=True)
    take = order[:, :r_pad]
    kept = jnp.take_along_axis(flat_keep, take, axis=1)

    def gather3(a):
        out = jnp.take_along_axis(a.reshape(L, H * C, a.shape[-1]),
                                  take[..., None], axis=1)
        return jnp.where(kept[..., None], out, 0)

    def gather_kt(a):
        # a (L, H, Dp, C): flat row r comes from head take[r]//C, col
        # take[r]%C — gather columns of the (Dp, H*C) view. Per-layer
        # lax.map: the all-layer vectorized form materializes the whole
        # transposed cache as one padded temp (8.8 GB at 3B/320k — OOM)
        def one(args):
            a_l, take_l, kept_l = args
            av = a_l.transpose(1, 0, 2).reshape(Dp, H * C)
            out = jnp.take_along_axis(av, take_l[None, :], axis=1)
            return jnp.where(kept_l[None, :], out, 0)

        return jax.lax.map(one, (a, take, kept))

    return FlatInt4KV(
        k_flat_q=gather_kt(cache.k_q),
        v_flat_q=gather_kt(cache.v_q),
        # scales/zeros stored f32: decode dequantises in f32, so storing
        # bf16 would re-cast 4 (R,) arrays per layer every step
        k_flat_s=gather3(cache.k_s)[..., 0].astype(jnp.float32),
        k_flat_z=gather3(cache.k_z)[..., 0].astype(jnp.float32),
        v_flat_s=gather3(cache.v_s)[..., 0].astype(jnp.float32),
        v_flat_z=gather3(cache.v_z)[..., 0].astype(jnp.float32),
        row_head=jnp.where(kept, (take // C).astype(jnp.int32), -1),
        k_tail=jnp.zeros((L, H, tail_cap, Dp * 2), dtype),
        v_tail=jnp.zeros((L, H, tail_cap, Dp * 2), dtype),
        lengths=keep_full.sum(axis=-1).astype(jnp.int32),
        tail_len=jnp.zeros((), jnp.int32),
        seen=cache.seen,
    )


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class HybridKV:
    """Gemma3-style hybrid cache: full-length stacks for STATIC (global
    attention) layers + window-sized RING buffers for sliding layers.

    Counterpart of reference ``RetainHybridCache``
    (`attention/kvcache.py:350-599`): its ``_sliding_update`` keeps only
    ``window`` rows per sliding layer (`:402-447`); round-1 kept
    full-capacity buffers + masking instead, wasting (C - window) rows per
    sliding layer (~43 GB for gemma3-12b at 128k). Ring slots are stamped
    with their token position (``ring_pos``, -1 = empty) so attention masks
    by position, not slot arithmetic; wrap-around needs no re-ordering.

    Retain-path only (the reference forces retain for gemma3,
    `model/wrapper.py:74-76`): ``valid`` masks static context rows.
    """

    k_static: jax.Array   # (L_static, H_kv, C, D)
    v_static: jax.Array
    k_ring: jax.Array     # (L_sliding, H_kv, W, D)
    v_ring: jax.Array
    ring_pos: jax.Array   # (L_sliding, W) int32 token position, -1 empty
    lengths: jax.Array    # (L_static, H_kv) int32
    valid: jax.Array      # (L_static, H_kv, C) bool
    seen: jax.Array       # () int32

    @property
    def capacity(self) -> int:
        return self.k_static.shape[2]

    @property
    def window(self) -> int:
        return self.k_ring.shape[2]

    @property
    def num_kv_heads(self) -> int:
        return self.k_static.shape[1]

    def mem_bytes(self) -> int:
        return ((self.k_static.size + self.k_ring.size)
                * self.k_static.dtype.itemsize * 2)

    def used_bytes(self) -> float:
        d = self.k_static.shape[-1]
        rows = int(jax.device_get(self.lengths).sum())
        ring_rows = int((jax.device_get(self.ring_pos) >= 0).sum()
                        ) * self.num_kv_heads
        return float((rows + ring_rows) * d
                     * self.k_static.dtype.itemsize * 2)


def init_hybrid_cache(cfg: ModelConfig, capacity: int,
                      dtype=jnp.bfloat16) -> HybridKV:
    L, H, D = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    L_t = len(cfg.static_layer_ids)
    L_s = L - L_t
    W = max(128, -(-int(cfg.sliding_window) // 128) * 128)
    return HybridKV(
        k_static=jnp.zeros((L_t, H, capacity, D), dtype),
        v_static=jnp.zeros((L_t, H, capacity, D), dtype),
        k_ring=jnp.zeros((L_s, H, W, D), dtype),
        v_ring=jnp.zeros((L_s, H, W, D), dtype),
        ring_pos=jnp.full((L_s, W), -1, jnp.int32),
        lengths=jnp.zeros((L_t, H), jnp.int32),
        valid=jnp.ones((L_t, H, capacity), jnp.bool_),
        seen=jnp.zeros((), jnp.int32),
    )


def ring_append(k_ring: jax.Array, v_ring: jax.Array, ring_pos: jax.Array,
                seen, k_new: jax.Array, v_new: jax.Array):
    """Append T rows at positions [seen, seen+T) into one layer's ring.

    k_ring/v_ring (H, W, D); ring_pos (W,); k_new/v_new (T, H, D). Keeps
    only the last min(T, W) rows (reference ``_sliding_update``,
    `attention/kvcache.py:402-447`). Returns updated (k_ring, v_ring,
    ring_pos).
    """
    T, H, D = k_new.shape
    W = k_ring.shape[1]
    n = min(T, W)
    pos = seen + T - n + jnp.arange(n, dtype=jnp.int32)   # (n,)
    idx = pos % W
    k_rows = jnp.swapaxes(k_new[T - n:], 0, 1)            # (H, n, D)
    v_rows = jnp.swapaxes(v_new[T - n:], 0, 1)
    k_ring = k_ring.at[:, idx, :].set(k_rows)
    v_ring = v_ring.at[:, idx, :].set(v_rows)
    ring_pos = ring_pos.at[idx].set(pos)
    return k_ring, v_ring, ring_pos


@partial(jax.jit, static_argnums=(1,), donate_argnums=(0,))
def refold_flat(cache, r_pad_new: int):
    """Fold the tail (query/answer KV of committed multi-turn rounds) into
    the flat context so the tail buffer empties and decoding can continue.

    The reference supports unbounded ``update_cache=True`` turns by
    re-gathering the flattened cache (`attention/kvcache.py:82-106`); here
    the equivalent is one stable sort + gather per layer appending each
    head's tail rows after its flat segment. For the INT4 cache the folded
    tail rows are quantized like every other context row (the reference's
    quantized cache quantizes on write, `int4_kv.py:100-267`).

    r_pad_new: static padded row count >= max over layers of
    (kept rows + H_kv * tail_len).
    """
    from kvzip_tpu.ops.quant import quantize_int4

    is_int4 = isinstance(cache, FlatInt4KV)
    L = cache.num_layers
    H = cache.num_kv_heads
    Tcap = cache.k_tail.shape[2]
    R = cache.capacity
    D = cache.k_tail.shape[3]
    tail_len = cache.tail_len  # () int32 traced ok

    BIG = jnp.int32(2 ** 30)
    # sort keys: head id, flat rows before tail rows (stable), pads last
    key_flat = jnp.where(cache.row_head >= 0, cache.row_head, BIG)  # (L, R)
    t_head = jnp.repeat(jnp.arange(H, dtype=jnp.int32), Tcap)       # (H*Tcap,)
    t_pos = jnp.tile(jnp.arange(Tcap, dtype=jnp.int32), H)
    key_tail = jnp.where(t_pos < tail_len, t_head, BIG)             # (H*Tcap,)
    keys_all = jnp.concatenate(
        [key_flat, jnp.broadcast_to(key_tail, (L, H * Tcap))], axis=1)
    order = jnp.argsort(keys_all, axis=-1, stable=True)
    take = order[:, :r_pad_new]                                     # (L, R')
    kept = jnp.take_along_axis(keys_all, take, axis=1) < BIG
    row_head_new = jnp.where(
        kept, jnp.take_along_axis(keys_all, take, axis=1).astype(jnp.int32),
        -1)

    def cat_rows(flat_rows, tail):  # (L, R, W) + (L, H, Tcap, W) -> gather
        allr = jnp.concatenate(
            [flat_rows, tail.reshape(L, H * Tcap, tail.shape[-1])], axis=1)
        out = jnp.take_along_axis(allr, take[..., None], axis=1)
        return jnp.where(kept[..., None], out, 0)

    def cat_cols(flat_cols, tail_rows):  # (L, W, R) + (L, H*Tcap, W) -> cols
        allc = jnp.concatenate(
            [flat_cols, tail_rows.transpose(0, 2, 1)], axis=2)
        out = jnp.take_along_axis(allc, take[:, None, :], axis=2)
        return jnp.where(kept[:, None, :], out, 0)

    lengths_new = cache.lengths + tail_len
    if not is_int4:
        return FlatKV(
            k_flat=cat_cols(cache.k_flat,
                            cache.k_tail.reshape(L, H * Tcap, D)),
            v_flat=cat_rows(cache.v_flat, cache.v_tail),
            row_head=row_head_new,
            k_tail=jnp.zeros_like(cache.k_tail),
            v_tail=jnp.zeros_like(cache.v_tail),
            lengths=lengths_new,
            tail_len=jnp.zeros((), jnp.int32),
            seen=cache.seen,
        )

    ktq, kts, ktz = quantize_int4(
        cache.k_tail.reshape(L, H * Tcap, D), pack="split")
    vtq, vts, vtz = quantize_int4(
        cache.v_tail.reshape(L, H * Tcap, D), pack="split")

    def cat1(flat_sz, tail_sz):  # (L, R) + (L, H*Tcap) scale rows
        allr = jnp.concatenate(
            [flat_sz, tail_sz[..., 0].astype(jnp.float32)], axis=1)
        out = jnp.take_along_axis(allr, take, axis=1)
        return jnp.where(kept, out, 0)

    return FlatInt4KV(
        k_flat_q=cat_cols(cache.k_flat_q, ktq),
        v_flat_q=cat_cols(cache.v_flat_q, vtq),
        k_flat_s=cat1(cache.k_flat_s, kts),
        k_flat_z=cat1(cache.k_flat_z, ktz),
        v_flat_s=cat1(cache.v_flat_s, vts),
        v_flat_z=cat1(cache.v_flat_z, vtz),
        row_head=row_head_new,
        k_tail=jnp.zeros_like(cache.k_tail),
        v_tail=jnp.zeros_like(cache.v_tail),
        lengths=lengths_new,
        tail_len=jnp.zeros((), jnp.int32),
        seen=cache.seen,
    )


# Jitted so the gathers' broadcast index arrays fuse instead of
# materializing multi-GB eager temporaries at long contexts. The *_donated
# variants free each dense array as soon as its gather completes, so the
# dense cache and the flat view need not coexist. Use the donated form
# whenever the dense cache dies with the call (prune); the plain form when
# it must survive (flatten_full).
build_flat = partial(jax.jit, static_argnums=(2, 3, 4))(_build_flat)
build_flat_donated = partial(
    jax.jit, static_argnums=(2, 3, 4), donate_argnums=(0,))(_build_flat)
build_flat_int4 = partial(jax.jit, static_argnums=(2, 3, 4, 5))(
    _build_flat_int4)
build_flat_int4_donated = partial(
    jax.jit, static_argnums=(2, 3, 4, 5), donate_argnums=(0,))(
        _build_flat_int4)


# ---- stepped donated int4 build: bounded-peak compaction at huge ctx ----
# A single donated build cannot alias (output shapes differ from the dense
# inputs), so dense + flat coexist for the whole gather. The stepped form
# gathers ONE dense array per jit call, donating it; block_until_ready
# between steps guarantees the donated buffer is actually released before
# the next gather launches, so peak stays at
#   live dense + ONE flat output + small temps.

@partial(jax.jit, static_argnums=(1, 2, 3))
def _flat_plan_int4(keep: jax.Array, sink: int, r_pad: int, C: int):
    """(take, kept, lengths, row_head) for the flat gather (cf. the prologue
    of :func:`_build_flat_int4`)."""
    L, H, ctx_len = keep.shape
    keep_full = jnp.zeros((L, H, C), jnp.bool_)
    keep_full = keep_full.at[:, :, :sink].set(True)
    keep_full = jax.lax.dynamic_update_slice(
        keep_full, keep.astype(jnp.bool_), (0, 0, sink))
    col = jax.lax.broadcasted_iota(jnp.int32, (L, H, C), 2)
    keep_full &= col < sink + ctx_len
    flat_keep = keep_full.reshape(L, H * C)
    order = jnp.argsort(~flat_keep, axis=-1, stable=True)
    take = order[:, :r_pad]
    kept = jnp.take_along_axis(flat_keep, take, axis=1)
    lengths = keep_full.sum(axis=-1).astype(jnp.int32)
    row_head = jnp.where(kept, (take // C).astype(jnp.int32), -1)
    return take, kept, lengths, row_head


@partial(jax.jit, donate_argnums=(0,))
def _gather_kt_donated(a: jax.Array, take: jax.Array, kept: jax.Array):
    """(L, H, Dp, C) nibbles -> (L, Dp, r_pad), donating the dense array."""
    L, H, Dp, C = a.shape

    def one(args):
        a_l, take_l, kept_l = args
        av = a_l.transpose(1, 0, 2).reshape(Dp, H * C)
        out = jnp.take_along_axis(av, take_l[None, :], axis=1)
        return jnp.where(kept_l[None, :], out, 0)

    return jax.lax.map(one, (a, take, kept))


@partial(jax.jit, donate_argnums=(0,))
def _gather_scale_donated(a: jax.Array, take: jax.Array, kept: jax.Array):
    """(L, H, C, 1) scale/zero rows -> (L, r_pad) f32, donating the input."""
    L, H, C, _ = a.shape
    out = jnp.take_along_axis(a.reshape(L, H * C), take, axis=1)
    return jnp.where(kept, out, 0).astype(jnp.float32)


def build_flat_int4_stepped(cache: Int4KVCache, keep: jax.Array, sink: int,
                            r_pad: int, tail_cap: int,
                            dtype=jnp.bfloat16) -> FlatInt4KV:
    """:func:`_build_flat_int4` semantics with bounded peak memory.

    Consumes the dense cache array-by-array (each gather donates its input
    and synchronizes before the next), so compaction fits whenever
    dense + max(single flat array) fits — the regime of the 480k demo and
    the 320k bench config. Results match ``build_flat_int4`` exactly (same
    plan, same gathers; tested in tests/test_flat_int4.py).
    """
    L, H, Dp, C = cache.k_q.shape
    assert cache.k_s.shape[-1] == 1, "flat int4 needs one quant group per row"
    take, kept, lengths, row_head = _flat_plan_int4(keep, sink, r_pad, C)
    jax.block_until_ready(take)

    def step(fn, a):
        out = fn(a, take, kept)
        jax.block_until_ready(out)   # donated input freed before next step
        return out

    # scales first: frees the dense scale arrays before the two (larger)
    # nibble gathers
    k_flat_s = step(_gather_scale_donated, cache.k_s)
    k_flat_z = step(_gather_scale_donated, cache.k_z)
    v_flat_s = step(_gather_scale_donated, cache.v_s)
    v_flat_z = step(_gather_scale_donated, cache.v_z)
    k_flat_q = step(_gather_kt_donated, cache.k_q)
    v_flat_q = step(_gather_kt_donated, cache.v_q)
    seen = cache.seen

    return FlatInt4KV(
        k_flat_q=k_flat_q, v_flat_q=v_flat_q,
        k_flat_s=k_flat_s, k_flat_z=k_flat_z,
        v_flat_s=v_flat_s, v_flat_z=v_flat_z,
        row_head=row_head,
        k_tail=jnp.zeros((L, H, tail_cap, Dp * 2), dtype),
        v_tail=jnp.zeros((L, H, tail_cap, Dp * 2), dtype),
        lengths=lengths,
        tail_len=jnp.zeros((), jnp.int32),
        seen=seen,
    )


def init_cache(cfg: ModelConfig, capacity: int, dtype=jnp.bfloat16) -> KVCache:
    L, H, D = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    return KVCache(
        k=jnp.zeros((L, H, capacity, D), dtype),
        v=jnp.zeros((L, H, capacity, D), dtype),
        lengths=jnp.zeros((L, H), jnp.int32),
        seen=jnp.zeros((), jnp.int32),
        valid=jnp.ones((L, H, capacity), jnp.bool_),
    )


def init_int4_cache(cfg: ModelConfig, capacity: int, dtype=jnp.bfloat16,
                    group_size: int = 128) -> Int4KVCache:
    L, H, D = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    G = max(D // min(group_size, D), 1)
    return Int4KVCache(
        # K and V nibbles live transposed (D//2, C), as they were laid out
        # for the original accelerator's matrix unit; the attention here
        # swaps them back to rows per call (ROADMAP: an int4 kernel with
        # its own layout)
        k_q=jnp.zeros((L, H, D // 2, capacity), jnp.uint8),
        v_q=jnp.zeros((L, H, D // 2, capacity), jnp.uint8),
        k_s=jnp.zeros((L, H, capacity, G), dtype),
        k_z=jnp.zeros((L, H, capacity, G), dtype),
        v_s=jnp.zeros((L, H, capacity, G), dtype),
        v_z=jnp.zeros((L, H, capacity, G), dtype),
        lengths=jnp.zeros((L, H), jnp.int32),
        seen=jnp.zeros((), jnp.int32),
        valid=jnp.ones((L, H, capacity), jnp.bool_),
    )


def append_layer(k_cache: jax.Array, v_cache: jax.Array, lens: jax.Array,
                 k_new: jax.Array, v_new: jax.Array):
    """Append T new rows per head at each head's current length.

    k_cache/v_cache: (H, C, D); lens: (H,) int32; k_new/v_new: (T, H, D).
    Returns updated (k_cache, v_cache). O(T) per head — contrast with the
    reference's whole-cache realloc (`csrc/cuda_api.cu:68-111`).
    """
    kT = jnp.swapaxes(k_new, 0, 1)  # (H, T, D)
    vT = jnp.swapaxes(v_new, 0, 1)

    def upd(cache_h, new_h, len_h):
        return jax.lax.dynamic_update_slice(cache_h, new_h, (len_h, 0))

    k_out = jax.vmap(upd)(k_cache, kT, lens)
    v_out = jax.vmap(upd)(v_cache, vT, lens)
    return k_out, v_out


def append_layer_int4(cache_arrays: tuple, lens: jax.Array,
                      k_new: jax.Array, v_new: jax.Array,
                      group_size: int = 128) -> tuple:
    """Quantize-on-append for one layer of the INT4 cache.

    cache_arrays: (k_q, v_q, k_s, k_z, v_s, v_z) each (H, C, ...);
    k_new/v_new: (T, H, D). Returns updated arrays.
    """
    from kvzip_tpu.ops.quant import quantize_int4

    k_q, v_q, k_s, k_z, v_s, v_z = cache_arrays
    # split packing: element j in the high nibble, j + D/2 in the low one
    # (see ops/quant.py)
    kq, ks, kz = quantize_int4(jnp.swapaxes(k_new, 0, 1), group_size,
                               pack="split")  # (H, T, ...)
    vq, vs, vz = quantize_int4(jnp.swapaxes(v_new, 0, 1), group_size,
                               pack="split")

    def upd(cache_h, new_h, len_h):
        return jax.lax.dynamic_update_slice(cache_h, new_h, (len_h, 0))

    def upd_t(cache_h, new_h, len_h):
        # K/V nibbles stored transposed (D//2, C): append writes columns
        return jax.lax.dynamic_update_slice(cache_h, new_h, (0, len_h))

    out = [jax.vmap(upd_t)(k_q, jnp.swapaxes(kq, 1, 2), lens),
           jax.vmap(upd_t)(v_q, jnp.swapaxes(vq, 1, 2), lens)]
    for cache_arr, new in ((k_s, ks.astype(k_s.dtype)),
                           (k_z, kz.astype(k_z.dtype)),
                           (v_s, vs.astype(v_s.dtype)),
                           (v_z, vz.astype(v_z.dtype))):
        out.append(jax.vmap(upd)(cache_arr, new, lens))
    return tuple(out)


_RESTORE_FIELDS = ("lengths", "seen", "tail_len")


def snapshot(cache) -> dict:
    """Snapshot of restore state. Counters only for linear caches (O(1)
    restore); hybrid rings must be backed up wholesale — ring writes are
    destructive once wrapped (the reference clones sliding layers around
    non-updating calls for the same reason, `kvcache.py:503-518`)."""
    snap = {f: getattr(cache, f) for f in _RESTORE_FIELDS
            if hasattr(cache, f)}
    if isinstance(cache, HybridKV):
        snap.update(k_ring=cache.k_ring, v_ring=cache.v_ring,
                    ring_pos=cache.ring_pos)
    return snap


def restore(cache, snap: dict):
    """Reference ``slice(seen_token_prev)`` equivalent — O(1) counter reset."""
    return dataclasses.replace(cache, **snap)


def compact(cache: KVCache, keep: jax.Array, sink: int, new_capacity: int,
            static_mask: Optional[jax.Array] = None) -> KVCache:
    """Physically evict KV: gather kept rows to the front of a fresh buffer.

    keep: (L, H, ctx_len) bool over the context region (reference ``valid``
    from `_threshold`, score.py:88-120). Sink rows [0, sink) are always kept;
    rows beyond ``sink + ctx_len`` (none at prune time) are dropped.

    Implemented as a stable argsort per (layer, head) row: indices of kept
    rows first, in original order — one gather per layer, shard-local when KV
    is head-sharded. Replaces reference `prepare_init` (kvcache.py:152-185).

    static_mask: optional (L,) bool — hybrid models evict only static layers;
    sliding layers keep everything (reference scores static layers only,
    `kvcache.py:534-562`).
    """
    L, H, C = cache.valid.shape
    ctx_len = keep.shape[-1]

    keep_full = jnp.zeros((L, H, C), jnp.bool_)
    keep_full = keep_full.at[:, :, :sink].set(True)
    keep_full = jax.lax.dynamic_update_slice(
        keep_full, keep.astype(jnp.bool_), (0, 0, sink))
    if static_mask is not None:
        all_rows = jnp.ones((L, H, C), jnp.bool_)
        all_rows = all_rows & (
            jax.lax.broadcasted_iota(jnp.int32, (L, H, C), 2) < sink + ctx_len)
        keep_full = jnp.where(static_mask[:, None, None], keep_full, all_rows)

    # stable sort: kept rows (key 0) before dropped (key 1), original order
    order = jnp.argsort(~keep_full, axis=-1, stable=True)  # (L, H, C)
    take = order[:, :, :new_capacity]                      # (L, H, C2)
    new_lens = keep_full.sum(axis=-1).astype(jnp.int32)

    col = jax.lax.broadcasted_iota(jnp.int32, (L, H, new_capacity), 2)
    live = col < new_lens[..., None]

    def gather(arr):
        out = jnp.take_along_axis(arr, take[..., None], axis=2)
        # zero the tail beyond each head's kept length (hygiene; attention
        # masks by length so this is not load-bearing)
        return jnp.where(live[..., None], out, 0)

    common = dict(lengths=new_lens, seen=cache.seen,
                  valid=jnp.ones((L, H, new_capacity), jnp.bool_))
    if isinstance(cache, Int4KVCache):
        # K/V nibbles are stored transposed (L, H, D//2, C): gather columns
        def gather_t(arr):
            out = jnp.take_along_axis(arr, take[:, :, None, :], axis=3)
            return jnp.where(live[:, :, None, :], out, 0)

        return Int4KVCache(
            k_q=gather_t(cache.k_q), v_q=gather_t(cache.v_q),
            k_s=gather(cache.k_s), k_z=gather(cache.k_z),
            v_s=gather(cache.v_s), v_z=gather(cache.v_z), **common)
    return KVCache(k=gather(cache.k), v=gather(cache.v), **common)


def set_retain_mask(cache: KVCache, keep: jax.Array, sink: int,
                    static_mask: Optional[jax.Array] = None) -> KVCache:
    """Retain-path prune: store the mask; attention applies it as -inf.

    Reference `RetainCache.prune` (kvcache.py:284-298) + `_get_valid`
    (kvcache.py:300-310): [sink ones ∥ ctx mask ∥ ones for queries...].
    """
    L, H, C = cache.valid.shape
    ctx_len = keep.shape[-1]
    valid = jnp.ones((L, H, C), jnp.bool_)
    valid = jax.lax.dynamic_update_slice(valid, keep.astype(jnp.bool_), (0, 0, sink))
    if static_mask is not None:
        valid = jnp.where(static_mask[:, None, None], valid, True)
    return dataclasses.replace(cache, valid=valid)
