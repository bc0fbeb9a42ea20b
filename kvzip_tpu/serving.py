"""Batched serving utilities: decode many compressed contexts at once.

The reference is strictly single-sequence (SURVEY.md §2b). Here, B per-context
caches (each independently prefilled/scored/pruned — possibly at different
ratios) are stacked on a leading batch axis and decoded together with a
vmapped forward step: weight reads amortize across the batch, and on a mesh
the batch axis shards over "data" (DP) while heads shard over "model" (TP).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from kvzip_tpu.cache import FlatInt4KV, FlatKV, KVCache
from kvzip_tpu.engine import Engine, KVState
from kvzip_tpu.models.transformer import forward
from kvzip_tpu.pool import PoolInt4KV, PoolKV

_MERGEABLE = (FlatKV, FlatInt4KV, PoolKV, PoolInt4KV)


def _pad_capacity(cache, capacity: int):
    if isinstance(cache, (FlatKV, FlatInt4KV)):
        extra = capacity - cache.capacity
        if extra == 0:
            return cache
        if isinstance(cache, FlatKV):
            return dataclasses.replace(
                cache,
                k_flat=jnp.pad(cache.k_flat, ((0, 0), (0, 0), (0, extra))),
                v_flat=jnp.pad(cache.v_flat,
                               ((0, 0), (0, extra), (0, 0))),
                row_head=jnp.pad(cache.row_head, ((0, 0), (0, extra)),
                                 constant_values=-1),
            )
        return dataclasses.replace(
            cache,
            k_flat_q=jnp.pad(cache.k_flat_q, ((0, 0), (0, 0), (0, extra))),
            v_flat_q=jnp.pad(cache.v_flat_q, ((0, 0), (0, 0), (0, extra))),
            k_flat_s=jnp.pad(cache.k_flat_s, ((0, 0), (0, extra))),
            k_flat_z=jnp.pad(cache.k_flat_z, ((0, 0), (0, extra))),
            v_flat_s=jnp.pad(cache.v_flat_s, ((0, 0), (0, extra))),
            v_flat_z=jnp.pad(cache.v_flat_z, ((0, 0), (0, extra))),
            row_head=jnp.pad(cache.row_head, ((0, 0), (0, extra)),
                             constant_values=-1),
        )
    if not isinstance(cache, KVCache):
        raise NotImplementedError(
            "batch STACKING supports dense KVCache and flat "
            "FlatKV/FlatInt4KV states; pool caches batch through the "
            "single-device MERGED-pool path instead (serving._merge_pool) "
            "— on a mesh, prune serving engines with "
            'flat_decode="legacy"')
    if cache.capacity == capacity:
        return cache
    extra = capacity - cache.capacity
    return dataclasses.replace(
        cache,
        k=jnp.pad(cache.k, ((0, 0), (0, 0), (0, extra), (0, 0))),
        v=jnp.pad(cache.v, ((0, 0), (0, 0), (0, extra), (0, 0))),
        valid=jnp.pad(cache.valid, ((0, 0), (0, 0), (0, extra)),
                      constant_values=True),
    )


def stack_caches(caches: Sequence[KVCache]) -> KVCache:
    """Stack caches on a leading batch axis (padded to the max capacity —
    flat caches pad r_pad with head-id -1 rows that can never match)."""
    if len({type(c) for c in caches}) != 1:
        raise ValueError("all caches in a batch must have the same type")
    cap = max(c.capacity for c in caches)
    caches = [_pad_capacity(c, cap) for c in caches]
    return jax.tree.map(lambda *xs: jnp.stack(xs), *caches)


def unstack_caches(batched: KVCache, n: int) -> List[KVCache]:
    return [jax.tree.map(lambda x: x[i], batched) for i in range(n)]


class Scheduler:
    """Minimal admission scheduler for batched decode.

    Requests (query, state) queue up; ``run`` drains them FIFO in batches of
    compatible states (same cache class — flat int4, flat bf16 and dense
    states cannot stack) and decodes each batch with one vmapped loop. The
    reference has no serving layer at all (SURVEY §2b); this is the net-new
    admission path for merged flat/pool decode.
    """

    def __init__(self, engine: Engine, max_batch: int = 8):
        self.engine = engine
        self.max_batch = max_batch
        self._queue: List[tuple] = []

    def submit(self, query, state: KVState, max_new_tokens=None) -> int:
        """Enqueue one request; returns its request id."""
        rid = len(self._queue)
        self._queue.append((rid, query, state, max_new_tokens))
        return rid

    def run_continuous(self, segment: int = 32) -> List[str]:
        """Drain the queue with CONTINUOUS batching: decode in fixed
        ``segment``-step rounds; after each round, finished sequences
        retire (their context cache is restored for reuse) and queued
        requests are admitted into the freed slots mid-flight — the batch
        never drains to refill. Requests whose cache class differs from
        the current batch wait until the batch empties.

        Returns outputs ordered by request id.
        """
        out: dict = {}
        pending = list(self._queue)
        self._queue.clear()
        slots: List[dict] = []

        def admit():
            while pending and len(slots) < self.max_batch:
                head_type = (type(slots[0]["state"].cache) if slots
                             else type(pending[0][2].cache))
                idx = next((i for i, r in enumerate(pending)
                            if isinstance(r[2].cache, head_type)), None)
                if idx is None:
                    break
                rid, q, st, mn = pending.pop(idx)
                st.snapshot()
                logits = self.engine._forward_chunks(
                    np.asarray(q, np.int32), st, "last")
                first = int(jax.device_get(jnp.argmax(logits[-1])))
                slots.append(dict(rid=rid, state=st, tokens=[first],
                                  budget=(mn or self.engine.max_new_tokens)))

        admit()
        while slots:
            n_steps = min(segment,
                          max(s["budget"] - len(s["tokens"]) + 1
                              for s in slots))
            toks = _decode_segment(
                self.engine, [s["state"] for s in slots],
                [s["tokens"][-1] for s in slots], n_steps)
            for s, seq in zip(slots, toks):
                s["tokens"].extend(int(t) for t in seq)
            keep = []
            for s in slots:
                done = (len(s["tokens"]) > s["budget"]
                        or (len(s["tokens"]) > 1 and
                            s["tokens"][-1] in self.engine.eos_ids))
                if done:
                    seq = np.asarray(s["tokens"][:s["budget"]])
                    stop = np.isin(seq, np.asarray(self.engine.eos_ids))
                    if stop.any():
                        seq = seq[:int(np.argmax(stop))]
                    out[s["rid"]] = self.engine.decode(seq)
                    s["state"].restore_snapshot()
                else:
                    keep.append(s)
            slots = keep
            admit()
        return [out[i] for i in sorted(out)]

    def run(self) -> List[str]:
        """Drain the queue; returns outputs ordered by request id."""
        out: dict = {}
        pending = list(self._queue)
        self._queue.clear()
        while pending:
            head_type = type(pending[0][2].cache)
            batch = [r for r in pending
                     if isinstance(r[2].cache, head_type)][:self.max_batch]
            pending = [r for r in pending if r not in batch]
            max_new = max((r[3] or self.engine.max_new_tokens)
                          for r in batch)
            if len(batch) == 1:
                rid, q, st, mn = batch[0]
                out[rid] = self.engine.generate(
                    q, st, max_new_tokens=mn or self.engine.max_new_tokens)
                continue
            results = batched_generate(
                self.engine, [r[1] for r in batch], [r[2] for r in batch],
                max_new_tokens=max_new)
            for (rid, *_), text in zip(batch, results):
                out[rid] = text
        return [out[i] for i in sorted(out)]


# ---------------------------------------------------------- merged decode
# Batched decode over evicted caches: rather than vmapping the
# single-sequence forward, the B flat/pool caches MERGE into ONE cache —
# per-row head ids already isolate sequences inside the decode attention,
# so with seq-major query rows the existing head mapping r // g produces
# merged head ids (b * H_kv + h) verbatim. One attention call and one
# weight read serve the whole batch; per-sequence positions ride a (B,)
# vector and per-sequence tail lengths a (B * H_kv,) vector.

def _merge_flat(caches: Sequence) -> dict:
    """Concatenate flat caches into one merged flat view.

    Each cache is first padded to the max r_pad so every sequence segment
    has EQUAL length."""
    is_int4 = isinstance(caches[0], FlatInt4KV)
    B = len(caches)
    cap = max(c.capacity for c in caches)
    caches = [_pad_capacity(c, cap) for c in caches]
    Hkv = caches[0].k_tail.shape[1]
    row_head = jnp.concatenate(
        [jnp.where(c.row_head >= 0, c.row_head + b * Hkv, -1)
         for b, c in enumerate(caches)], axis=-1)
    out = dict(
        row_head=row_head,
        k_tail=jnp.concatenate([c.k_tail for c in caches], axis=1),
        v_tail=jnp.concatenate([c.v_tail for c in caches], axis=1),
        tail_lens=jnp.concatenate(
            [jnp.broadcast_to(c.tail_len[None], (Hkv,)) for c in caches]),
        seen=jnp.stack([c.seen for c in caches]),
        is_int4=is_int4, B=B,
    )
    if is_int4:
        for f in ("k_flat_q", "v_flat_q"):
            out[f] = jnp.concatenate([getattr(c, f) for c in caches], axis=-1)
        for f in ("k_flat_s", "k_flat_z", "v_flat_s", "v_flat_z"):
            out[f] = jnp.concatenate([getattr(c, f) for c in caches], axis=-1)
    else:
        out["k_flat"] = jnp.concatenate([c.k_flat for c in caches], axis=-1)
        out["v_flat"] = jnp.concatenate([c.v_flat for c in caches], axis=1)
    return out


@partial(jax.jit, static_argnums=(4,))
def _merge_gather_cols(src, take, kept, off, alloc: int, fill):
    """(Wd, ΣP) concat source -> (Wd, alloc) merged pool: per merged layer,
    gather its take columns and write one uniform-width slab (forward
    order — later layers overwrite the previous layer's spill, exactly the
    pool builders' discipline)."""
    L = take.shape[0]
    Wd = src.shape[0]
    pool = jnp.full((Wd, alloc), fill, src.dtype)

    def body(l, pool):
        t = jax.lax.dynamic_index_in_dim(take, l, 0, keepdims=False)
        kk = jax.lax.dynamic_index_in_dim(kept, l, 0, keepdims=False)
        cols = jnp.take(src, t, axis=1)
        cols = jnp.where(kk[None], cols, fill)
        return jax.lax.dynamic_update_slice(pool, cols, (0, off[l]))

    return jax.lax.fori_loop(0, L, body, pool)


@partial(jax.jit, static_argnums=(4,))
def _merge_gather_rows(src, take, kept, off, alloc: int):
    """(ΣP, D) concat source -> (alloc, D) merged pool (row-major V)."""
    L = take.shape[0]
    D = src.shape[1]
    pool = jnp.zeros((alloc, D), src.dtype)

    def body(l, pool):
        t = jax.lax.dynamic_index_in_dim(take, l, 0, keepdims=False)
        kk = jax.lax.dynamic_index_in_dim(kept, l, 0, keepdims=False)
        rows = jnp.take(src, t, axis=0)
        rows = jnp.where(kk[:, None], rows, 0)
        return jax.lax.dynamic_update_slice(pool, rows, (off[l], 0))

    return jax.lax.fori_loop(0, L, body, pool)


def _merge_pool(caches: Sequence) -> dict:
    """Merge B POOL caches into one pool whose kv-head space is B*Hkv.

    Unlike the legacy flat merge (uniform r_pad per sequence), the merged
    layer-l segment holds every request's LIVE layer-l rows back to back —
    no inter-request padding; only layer STARTS stay align-multiples (the
    block granularity the pool kernel's index maps address). Row head ids
    shift to ``b*Hkv + h``, so the kernel's ``row_head == q_kvhead`` match
    isolates sequences with zero extra machinery (same trick as the merged
    flat layout, serving.py round 2)."""
    is_int4 = isinstance(caches[0], PoolInt4KV)
    B = len(caches)
    L = caches[0].num_layers
    Hkv = caches[0].k_tail.shape[1]
    # caches built by one engine always agree on these; a mixed batch
    # would otherwise fail deep inside a concatenate with an opaque shape
    # error
    if any(getattr(c, "tp", 0) for c in caches):
        raise NotImplementedError(
            "merged-pool batching of tensor-parallel pools is not "
            "implemented; serve TP contexts unbatched")
    for b, c in enumerate(caches):
        got = (type(c).__name__, c.num_layers, c.k_tail.shape[1],
               c.k_tail.shape[2])
        want = (type(caches[0]).__name__, L, Hkv, caches[0].k_tail.shape[2])
        if got != want:
            raise ValueError(
                f"merge_pool: request {b} cache (kind/L/Hkv/tail_cap)="
                f"{got} does not match request 0 {want}; batch requests "
                "must come from the same engine configuration")
    align = max(c.align for c in caches)

    rows = np.stack([np.asarray(jax.device_get(c.layer_rows))
                     for c in caches])                       # (B, L)
    offs = np.stack([np.asarray(jax.device_get(c.layer_off))
                     for c in caches])                       # (B, L)
    caps = [c.capacity for c in caches]
    bases = np.concatenate([[0], np.cumsum(caps)[:-1]]).astype(np.int64)

    m_l = np.maximum(align,
                     ((rows.sum(0) + align - 1) // align) * align)  # (L,)
    new_off = np.concatenate([[0], np.cumsum(m_l)[:-1]]).astype(np.int32)
    W = int(m_l.max())
    alloc = int(new_off[-1] + W)

    take = np.zeros((L, W), np.int32)
    kept = np.zeros((L, W), bool)
    bofs = np.zeros((L, W), np.int32)
    for l in range(L):
        col = 0
        for b in range(B):
            r = int(rows[b, l])
            take[l, col:col + r] = bases[b] + offs[b, l] + np.arange(r)
            kept[l, col:col + r] = True
            bofs[l, col:col + r] = b * Hkv
            col += r
    take_j = jnp.asarray(take)
    kept_j = jnp.asarray(kept)
    off_j = jnp.asarray(new_off)

    def cols(name, fill=0):
        src = jnp.concatenate([getattr(c, name) for c in caches], axis=-1)
        return _merge_gather_cols(src, take_j, kept_j, off_j, alloc,
                                  jnp.asarray(fill, src.dtype))

    rh = cols("row_head", fill=-1)
    rh = jnp.where(rh >= 0,
                   rh + _bofs_pool(jnp.asarray(bofs), off_j, alloc), -1)

    out = dict(
        row_head=rh,
        layer_off=off_j,
        layer_rows=jnp.asarray(rows.sum(0).astype(np.int32)),
        align=align, max_rows=W,
        k_tail=jnp.concatenate([c.k_tail for c in caches], axis=1),
        v_tail=jnp.concatenate([c.v_tail for c in caches], axis=1),
        tail_lens=jnp.concatenate(
            [jnp.broadcast_to(c.tail_len[None], (Hkv,)) for c in caches]),
        seen=jnp.stack([c.seen for c in caches]),
        is_int4=is_int4, B=B, is_pool=True,
    )
    if is_int4:
        out["k_flat_q"] = cols("k_pool_q")
        out["v_flat_q"] = cols("v_pool_q")
        for dst, srcn in (("k_flat_s", "k_pool_s"), ("k_flat_z", "k_pool_z"),
                          ("v_flat_s", "v_pool_s"), ("v_flat_z", "v_pool_z")):
            out[dst] = cols(srcn)
    else:
        out["k_flat"] = cols("k_pool")
        src_v = jnp.concatenate([c.v_pool for c in caches], axis=0)
        out["v_flat"] = _merge_gather_rows(src_v, take_j, kept_j, off_j,
                                           alloc)
    return out


@partial(jax.jit, static_argnums=(2,))
def _bofs_pool(bofs, off, alloc: int):
    """Scatter the host-built (L, W) b*Hkv offsets into pool columns."""
    L, W = bofs.shape
    pool = jnp.zeros((1, alloc), jnp.int32)

    def body(l, pool):
        row = jax.lax.dynamic_index_in_dim(bofs, l, 0, keepdims=False)
        return jax.lax.dynamic_update_slice(pool, row[None], (0, off[l]))

    return jax.lax.fori_loop(0, L, body, pool)


def _merged_decode(engine: Engine, states: Sequence[KVState],
                   first_tokens, max_steps: int,
                   stop_on_eos: bool = True, queries=None):
    """Greedy-decode ``max_steps`` tokens for B merged flat sequences.

    ``queries``: optional per-sequence query token id arrays — ingested
    BATCHED through the same merged layer stack (one padded multi-token
    pass instead of B serial single-sequence forwards), producing the
    first tokens; ``first_tokens`` is ignored then.

    Returns (tokens (B, max_steps + 1) incl. the first token, n_steps done,
    per-state grown tails applied back to ``states``). One jitted while
    loop; weights are read once per step for the whole batch.
    """
    import numpy as _np

    cfg = engine.config
    B = len(states)
    H, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    L = cfg.num_layers
    eos = jnp.asarray(engine.eos_ids, jnp.int32)
    is_pool = isinstance(states[0].cache, (PoolKV, PoolInt4KV))
    m = (_merge_pool if is_pool else _merge_flat)(
        [st.cache for st in states])
    is_int4 = m["is_int4"]
    route = engine._impl(states[0])
    scale = cfg.query_scale if cfg.query_scale is not None else Dh ** -0.5

    from kvzip_tpu.cache import append_layer
    from kvzip_tpu.models.rope import apply_rope, rope_cos_sin
    from kvzip_tpu.models.transformer import (_act, _head_norm, _lin,
                                              _lin_shared, rms_norm)
    from kvzip_tpu.ops import attention as attn_ops
    from kvzip_tpu.ops import dispatch
    from kvzip_tpu.ops.quant import embed_lookup, head_logits

    if is_int4:
        flat_args = (m["k_flat_q"], m["k_flat_s"], m["k_flat_z"],
                     m["v_flat_q"], m["v_flat_s"], m["v_flat_z"])
    else:
        flat_args = (m["k_flat"], m["v_flat"])
    if is_pool:
        # per-layer segment metadata rides along with the frozen context
        # arrays as jit arguments (a closed-over array is baked into the
        # program as a constant)
        flat_args = flat_args + (m["layer_off"], m["layer_rows"])

    def stack_fwd(params, toks, seen, tail_lens, k_tail, v_tail, flat,
                  row_head, T):
        """Layer stack over T tokens per sequence (T=1: decode step;
        T>1: merged query ingestion). toks (B, T); returns final hidden
        states (B, T, Dm) + grown tails."""
        BT = B * T
        # fused-W4A8 stacks stay OUT of the scan (same as transformer.py):
        # w4a8_linear_stacked selects the layer itself
        w4 = {kk: vv for kk, vv in params["layers"].items()
              if isinstance(vv, dict) and "q4" in vv}
        x = embed_lookup(params["embed"], toks.reshape(BT))  # (BT, Dm)
        if cfg.gemma_style_norm:
            x = x * jnp.asarray(cfg.hidden_size ** 0.5, x.dtype)
        pos = (seen[:, None] + jnp.arange(T, dtype=jnp.int32)).reshape(BT)
        cos, sin = rope_cos_sin(cfg.rope, Dh, pos)

        def layer_fn(carry, xs):
            x, kt_all, vt_all = carry
            lp, li = xs
            h = rms_norm(x, lp["ln_attn"], cfg.rms_norm_eps,
                         gemma=cfg.gemma_style_norm)
            if "wqkv" in w4:
                from kvzip_tpu.ops.w4a8 import w4a8_linear_stacked
                qkv = w4a8_linear_stacked(h, w4["wqkv"], li)
                nq, nk = H * Dh, Hkv * Dh
                q, k, v = (qkv[:, :nq], qkv[:, nq:nq + nk],
                           qkv[:, nq + nk:])
                if "bq" in lp:
                    q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
            else:
                q, k, v = _lin_shared(
                    h, (lp["wq"], lp["wk"], lp["wv"]),
                    (lp.get("bq"), lp.get("bk"), lp.get("bv")))
            q = q.reshape(BT, H, Dh)
            k = k.reshape(BT, Hkv, Dh)
            v = v.reshape(BT, Hkv, Dh)
            if cfg.qk_norm:
                q = _head_norm(q, lp["q_norm"], cfg.rms_norm_eps,
                               cfg.gemma_style_norm)
                k = _head_norm(k, lp["k_norm"], cfg.rms_norm_eps,
                               cfg.gemma_style_norm)
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)

            # tail append at per-head offsets (seq-major merged heads)
            k_rows = k.reshape(B, T, Hkv, Dh).transpose(1, 0, 2, 3)
            v_rows = v.reshape(B, T, Hkv, Dh).transpose(1, 0, 2, 3)
            kt, vt = append_layer(kt_all[li], vt_all[li], tail_lens,
                                  k_rows.reshape(T, B * Hkv, Dh),
                                  v_rows.reshape(T, B * Hkv, Dh))
            kt_all = kt_all.at[li].set(kt)
            vt_all = vt_all.at[li].set(vt)

            # kernel rows: (T, B*H) seq-major head axis
            q2 = (q.reshape(B, T, H, Dh).transpose(1, 0, 2, 3)
                  .reshape(T, B * H, Dh))
            if is_pool:
                attend = (attn_ops.pool_decode_int4 if is_int4 else
                          dispatch.pool_decode(route))
                attn = attend(q2, *flat[:-2], row_head, flat[-2], flat[-1],
                              kt, vt, tail_lens, li, scale=scale,
                              max_rows=m["max_rows"])
            elif is_int4:
                attn = attn_ops.flat_decode_int4(
                    q2, *flat, row_head, kt, vt, tail_lens, scale=scale,
                    layer=li)
            else:
                attn = attn_ops.flat_decode(
                    q2, *flat, row_head, kt, vt, tail_lens, scale=scale,
                    layer=li)
            attn = (attn.reshape(T, B, H, Dh).transpose(1, 0, 2, 3)
                    .reshape(BT, H * Dh))
            if "wo" in w4:
                from kvzip_tpu.ops.w4a8 import w4a8_linear_stacked
                attn = w4a8_linear_stacked(attn, w4["wo"], li)
            else:
                attn = _lin(attn, lp["wo"])
            if cfg.post_norms:
                attn = rms_norm(attn, lp["ln_post_attn"], cfg.rms_norm_eps,
                                gemma=cfg.gemma_style_norm)
            x = x + attn
            h2 = rms_norm(x, lp["ln_mlp"], cfg.rms_norm_eps,
                          gemma=cfg.gemma_style_norm)
            if "w_gateup" in w4:
                from kvzip_tpu.ops.w4a8 import w4a8_linear_stacked
                gu = w4a8_linear_stacked(h2, w4["w_gateup"], li)
                gate, up = jnp.split(gu, 2, axis=-1)
            else:
                gate, up = _lin_shared(h2, (lp["w_gate"], lp["w_up"]),
                                       (None, None))
            hidden = _act(gate, cfg.hidden_act) * up
            if "w_down" in w4:
                from kvzip_tpu.ops.w4a8 import w4a8_linear_stacked
                mlp = w4a8_linear_stacked(hidden, w4["w_down"], li)
            else:
                mlp = _lin(hidden, lp["w_down"])
            if cfg.post_norms:
                mlp = rms_norm(mlp, lp["ln_post_mlp"], cfg.rms_norm_eps,
                               gemma=cfg.gemma_style_norm)
            return (x + mlp, kt_all, vt_all), None

        xs = ({k: v for k, v in params["layers"].items() if k not in w4},
              jnp.arange(L, dtype=jnp.int32))
        (x, k_tail, v_tail), _ = jax.lax.scan(
            layer_fn, (x, k_tail, v_tail), xs)
        return x.reshape(B, T, -1), k_tail, v_tail

    def step(params, toks, seen, tail_lens, k_tail, v_tail, flat, row_head):
        x, k_tail, v_tail = stack_fwd(params, toks[:, None], seen, tail_lens,
                                      k_tail, v_tail, flat, row_head, 1)
        xf = rms_norm(x[:, 0], params["final_norm"], cfg.rms_norm_eps,
                      gemma=cfg.gemma_style_norm)
        logits = head_logits(params.get("lm_head", params["embed"]), xf)
        return jnp.argmax(logits, axis=-1).astype(jnp.int32), k_tail, v_tail

    @partial(jax.jit, static_argnames=("max_steps",),
             donate_argnames=("k_tail", "v_tail"))
    def run(params, flat, row_head, k_tail, v_tail, tail_lens, seen,
            first, max_steps: int):
        tokens0 = jnp.zeros((B, max_steps + 1), jnp.int32)
        tokens0 = tokens0.at[:, 0].set(first)

        def cond(c):
            i, done = c[0], c[1]
            return (~jnp.all(done)) & (i < max_steps)

        def body(c):
            i, done, tokens, kt, vt, lens, sn = c
            nxt, kt, vt = step(params, tokens[:, i], sn, lens, kt, vt,
                               flat, row_head)
            nxt = jnp.where(done, tokens[:, i], nxt)
            tokens = tokens.at[:, i + 1].set(nxt)
            done = done | (jnp.isin(nxt, eos) if stop_on_eos
                           else jnp.zeros_like(done))
            lens = lens + jnp.where(
                jnp.repeat(done, Hkv), 0, 1).astype(lens.dtype)
            sn = sn + jnp.where(done, 0, 1).astype(sn.dtype)
            return (i + 1, done, tokens, kt, vt, lens, sn)

        done0 = (jnp.isin(first, eos) if stop_on_eos
                 else jnp.zeros((B,), jnp.bool_))
        i, done, tokens, kt, vt, lens, sn = jax.lax.while_loop(
            cond, body, (jnp.int32(0), done0, tokens0, k_tail, v_tail,
                         tail_lens, seen))
        return tokens, i, kt, vt, lens, sn

    @partial(jax.jit, static_argnames=("T",),
             donate_argnames=("k_tail", "v_tail"))
    def ingest(params, flat, row_head, k_tail, v_tail, tail_lens, seen,
               toks, true_lens, T: int):
        x, kt, vt = stack_fwd(params, toks, seen, tail_lens, k_tail, v_tail,
                              flat, row_head, T)
        idx = (true_lens - 1)[:, None, None]
        xl = jnp.take_along_axis(
            x, jnp.broadcast_to(idx, (B, 1, x.shape[-1])), axis=1)[:, 0]
        xf = rms_norm(xl, params["final_norm"], cfg.rms_norm_eps,
                      gemma=cfg.gemma_style_norm)
        logits = head_logits(params.get("lm_head", params["embed"]), xf)
        first = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        lens2 = tail_lens + jnp.repeat(true_lens, Hkv)
        return first, kt, vt, lens2, seen + true_lens

    kt0, vt0 = m["k_tail"], m["v_tail"]
    lens0, seen0 = m["tail_lens"], m["seen"]
    if queries is not None:
        import numpy as np
        true_lens = np.asarray([len(qq) for qq in queries], np.int32)
        Tq = -(-int(true_lens.max()) // 8) * 8   # bucket: fewer recompiles
        Tcap = kt0.shape[2]
        base = int(jax.device_get(lens0).max())
        if base + Tq + max_steps + 1 > Tcap:
            raise ValueError(
                f"merged ingest needs {base + Tq + max_steps + 1} tail rows"
                f" > capacity {Tcap}; raise decode_budget")
        toks = np.zeros((B, Tq), np.int32)
        for b, qq in enumerate(queries):
            toks[b, :len(qq)] = np.asarray(qq, np.int32)
        first_tokens, kt0, vt0, lens0, seen0 = ingest(
            engine.params, flat_args, m["row_head"], kt0, vt0, lens0, seen0,
            jnp.asarray(toks), jnp.asarray(true_lens), Tq)

    tokens, n, kt, vt, lens, sn = run(
        engine.params, flat_args, m["row_head"], kt0, vt0,
        lens0, seen0, jnp.asarray(first_tokens, jnp.int32),
        max_steps)

    # hand each sequence its grown tail back (continuous batching keeps
    # decoding from it; plain batched_generate restores snapshots anyway)
    for b, st in enumerate(states):
        st.cache = dataclasses.replace(
            st.cache,
            k_tail=kt[:, b * Hkv:(b + 1) * Hkv],
            v_tail=vt[:, b * Hkv:(b + 1) * Hkv],
            tail_len=lens[b * Hkv],
            seen=sn[b])
    return _np.asarray(jax.device_get(tokens)), int(jax.device_get(n))


_MUT_FIELDS = ("k_tail", "v_tail", "tail_len", "seen")


def _split_frozen(cache):
    """(mut0, as_cache, get_mut) for a decode loop whose carry must hold
    only the MUTABLE cache pieces. Flat caches freeze their multi-GB
    context arrays during decode — a loop carry that includes them risks a
    full copy per iteration (XLA does not reliably alias pass-through
    carry elements of a vmapped body)."""
    if isinstance(cache, (FlatKV, FlatInt4KV)):
        mut0 = {f: getattr(cache, f) for f in _MUT_FIELDS}
        return (mut0,
                lambda mut: dataclasses.replace(cache, **mut),
                lambda c2: {f: getattr(c2, f) for f in _MUT_FIELDS})
    return cache, (lambda mut: mut), (lambda c2: c2)


def _decode_segment(engine: Engine, states: Sequence[KVState],
                    last_tokens: Sequence[int], n_steps: int) -> np.ndarray:
    """Decode exactly ``n_steps`` greedy tokens for every state, batched.

    Returns (B, n_steps) new tokens; each state's cache keeps its grown
    tail (the continuous-batching round loop owns snapshot/restore).
    Compiles per (B, capacity, n_steps) combination — the scheduler keeps
    ``segment`` fixed so recompiles only happen as the batch shrinks.
    """
    B = len(states)
    cfg = engine.config

    if isinstance(states[0].cache, _MERGEABLE):
        # merged-flat/pool path: one kernel + one weight read per step for
        # the whole batch; no EOS stop (the round loop owns retirement)
        tokens, _ = _merged_decode(engine, states,
                                   np.asarray(last_tokens, np.int32),
                                   n_steps, stop_on_eos=False)
        return tokens[:, 1:]

    batched = stack_caches([st.cache for st in states])
    tok0 = jnp.asarray(np.asarray(last_tokens, np.int32))
    impl = "blockwise"
    step = partial(forward, collect_logits="last", attn_impl=impl)

    @partial(jax.jit, static_argnames=("n",), donate_argnames=("cache",))
    def seg(params, cache, tok, n):
        def one(t, c):
            res = step(params, cfg, t[None], c)
            return jnp.argmax(res.logits[-1]).astype(jnp.int32), res.cache

        # frozen flat context arrays stay OUT of the loop carry (engine
        # _decode_loop design): a multi-GB invariant carry element gets
        # copied every iteration (measured 0.7x aggregate at B=8)
        mut0, as_cache, get_mut = _split_frozen(cache)

        def body(i, carry):
            tok, tokens, mut = carry
            nxt, c2 = jax.vmap(one)(tok, as_cache(mut))
            tokens = tokens.at[:, i].set(nxt)
            return (nxt, tokens, get_mut(c2))

        tokens0 = jnp.zeros((B, n), jnp.int32)
        _, tokens, mut = jax.lax.fori_loop(
            0, n, body, (tok, tokens0, mut0))
        return tokens, as_cache(mut)

    tokens, batched = seg(engine.params, batched, tok0, n_steps)
    tokens = np.asarray(jax.device_get(tokens))
    for b, st in enumerate(states):
        st.cache = jax.tree.map(lambda x: x[b], batched)
    return tokens


def batched_generate(
    engine: Engine,
    queries: Sequence[np.ndarray],
    states: Sequence[KVState],
    max_new_tokens: Optional[int] = None,
) -> List[str]:
    """Greedy-decode one query per compressed context, batched.

    Query tokens are processed per sequence (reusing the engine's single
    sequence jits); the decode loop runs vmapped across the batch so each
    step reads the weights once for all sequences.
    """
    assert len(queries) == len(states)
    B = len(states)
    max_new = max_new_tokens or engine.max_new_tokens
    cfg = engine.config
    eos = jnp.asarray(engine.eos_ids, jnp.int32)

    if isinstance(states[0].cache, _MERGEABLE) and \
            engine.mesh is None:
        # merged-flat/pool path (single device): queries ingest BATCHED
        # through the merged stack, then one kernel launch + one weight
        # read per decode step for the whole batch
        for st in states:
            st.snapshot()
        tokens, n = _merged_decode(
            engine, states, None, max_new - 1,
            queries=[np.asarray(q, np.int32) for q in queries])
        outs = []
        for b, st in enumerate(states):
            seq = tokens[b, :n + 1]
            stop = np.isin(seq, np.asarray(engine.eos_ids))
            if stop.any():
                seq = seq[:int(np.argmax(stop))]
            outs.append(engine.decode(seq))
            st.restore_snapshot()
        return outs

    # per-sequence query ingestion (distinct lengths), collect first tokens
    firsts = []
    for q_ids, st in zip(queries, states):
        st.snapshot()
        logits = engine._forward_chunks(np.asarray(q_ids, np.int32), st, "last")
        firsts.append(jnp.argmax(logits[-1]).astype(jnp.int32))

    batched = stack_caches([st.cache for st in states])
    first_tok = jnp.stack(firsts)

    if engine.mesh is not None:
        # DP: batch over ("replica","data"); weights stay replicated per
        # replica (parallel/mesh.py layout)
        from jax.sharding import NamedSharding, PartitionSpec as P

        from kvzip_tpu.parallel.mesh import batch_axes, shard_batched_cache
        baxes = batch_axes(engine.mesh)
        n_dp = int(np.prod([engine.mesh.shape[a] for a in baxes]))
        if B % n_dp == 0:
            batched = shard_batched_cache(engine.mesh, batched)
            first_tok = jax.device_put(
                first_tok, NamedSharding(engine.mesh, P(baxes)))

    # flat caches pick their own decode route; dense ones read blockwise,
    # the vmap-safe XLA form
    step = partial(forward, collect_logits="last", attn_impl="blockwise")

    @partial(jax.jit, static_argnames=("max_steps",), donate_argnames=("cache",))
    def decode(params, cache, first, max_steps: int):
        tokens0 = jnp.zeros((B, max_steps + 1), jnp.int32)
        tokens0 = tokens0.at[:, 0].set(first)

        def one(tok, c):
            res = step(params, cfg, tok[None], c)
            return jnp.argmax(res.logits[-1]).astype(jnp.int32), res.cache

        # frozen flat context arrays stay OUT of the while carry (see
        # engine._decode_loop): carrying them copies GBs per iteration
        mut0, as_cache, get_mut = _split_frozen(cache)

        def cond(carry):
            i, done, _, _ = carry
            return (~jnp.all(done)) & (i < max_steps)

        def body(carry):
            i, done, tokens, mut = carry
            nxt, c2 = jax.vmap(one, in_axes=(0, 0))(tokens[:, i],
                                                    as_cache(mut))
            # frozen sequences keep emitting their last token (masked out later)
            nxt = jnp.where(done, tokens[:, i], nxt)
            tokens = tokens.at[:, i + 1].set(nxt)
            done = done | jnp.isin(nxt, eos)
            return (i + 1, done, tokens, get_mut(c2))

        done0 = jnp.isin(first, eos)
        i, done, tokens, mut = jax.lax.while_loop(
            cond, body, (jnp.int32(0), done0, tokens0, mut0))
        return tokens, i, as_cache(mut)

    tokens, n, batched = decode(engine.params, batched, first_tok,
                                max_new - 1)
    tokens = np.asarray(jax.device_get(tokens))
    n = int(jax.device_get(n))

    outs = []
    for b, st in enumerate(states):
        seq = tokens[b, :n + 1]
        # trim at first eos
        stop = np.isin(seq, np.asarray(engine.eos_ids))
        if stop.any():
            seq = seq[:int(np.argmax(stop))]
        outs.append(engine.decode(seq))
        st.cache = jax.tree.map(lambda x: x[b], batched)
        st.restore_snapshot()
    return outs
