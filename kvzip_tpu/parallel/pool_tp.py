"""Tensor-parallel POOL decode: per-shard pools over local kv heads.

SURVEY §2b: the POOL layout (the flagship decode path,
`kvzip_tpu/pool.py`) under tensor parallelism.

Design (the composition SURVEY §2b predicts): eviction and compaction are
already shard-local when KV is head-sharded, so each "model"-axis shard
gets its OWN pool over its local heads:

- the pool arrays keep their single-device field names/ranks, with the
  column axis grown to ``tp * P_s`` (uniform per-shard segments padded to
  the largest shard's alloc) and sharded ``P(None, "model")`` — shard s
  owns columns ``[s*P_s, (s+1)*P_s)``;
- ``layer_off``/``layer_rows`` become ``(tp, L)`` (per-shard geometry,
  sharded over the shard axis); ``row_head`` holds LOCAL head ids, so the
  decode's ``row_head == local_q_head`` match needs no translation;
- attention runs under ``shard_map`` over "model": every shard executes
  the SAME single-device decode (`ops.dispatch`) on its local q heads and pool
  segment — no collectives inside attention (the psum after the
  row-parallel o-proj, inserted by GSPMD, is the only cross-shard step,
  exactly as on the dense TP path).

Reference frame: the flattened varlen view is the reference's only fast
decode path (`attention/attn.py:56-73`); this keeps ours first-class under
TP instead of degrading to the dense fallback.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from kvzip_tpu.cache import Int4KVCache, _flat_plan_int4
from kvzip_tpu.pool import (PoolInt4KV, PoolKV, _pool_gather_k_bf16,
                            _pool_gather_kt, _pool_gather_scale,
                            _pool_gather_v_bf16, _pool_row_head,
                            _round_up_arr, plan_offsets)


def _shard_map(fn, mesh, in_specs, out_specs):
    from jax.experimental.shard_map import shard_map

    return shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                     check_rep=False)


def _plan_tp(cache, keep: jax.Array, sink: int, align: int, tp: int):
    """Host geometry + per-shard gather plans stacked on a leading shard
    axis: (take/kept (tp, L, W), lengths (L, H), off (tp, L), rows
    (tp, L), P_s, max_rows)."""
    H = cache.num_kv_heads
    C = cache.capacity
    Hl = H // tp
    per_head = np.asarray(jax.device_get(keep.sum(axis=2)))  # (L, H)
    shard_rows = np.stack([
        per_head[:, s * Hl:(s + 1) * Hl].sum(axis=1) + sink * Hl
        for s in range(tp)]).astype(np.int64)                # (tp, L)

    offs, r_maxs, allocs = [], [], []
    for s in range(tp):
        off_s, alloc_s, r_max_s, _ = plan_offsets(shard_rows[s], align)
        offs.append(off_s)
        allocs.append(alloc_s)
        r_maxs.append(r_max_s)
    W = min(max(r_maxs), Hl * C)
    P_s = max(allocs)

    takes, kepts, lens = [], [], []
    for s in range(tp):
        t, k, ln, _ = _flat_plan_int4(
            keep[:, s * Hl:(s + 1) * Hl], sink, W, C)
        takes.append(t)
        kepts.append(k)
        lens.append(ln)
    take = jnp.stack(takes)                 # local H_l*C indices
    kept = jnp.stack(kepts)
    lengths = jnp.concatenate(lens, axis=1)  # (L, H)
    jax.block_until_ready(take)
    off = jnp.asarray(np.stack(offs), jnp.int32)
    rows = jnp.asarray(shard_rows, jnp.int32)
    max_rows = int(max(
        np.maximum(align, _round_up_arr(shard_rows[s], align)).max()
        for s in range(tp)))
    return take, kept, lengths, off, rows, P_s, max_rows


def build_pool_tp(cache, keep: jax.Array, sink: int, tail_cap: int,
                  dtype, align: int, mesh):
    """Compact a head-sharded dense cache into per-shard pools (the dense
    cache is CONSUMED array-by-array, like the single-device stepped
    builders)."""
    tp = mesh.shape["model"]
    is_int4 = isinstance(cache, Int4KVCache)
    L = cache.lengths.shape[0]
    H = cache.num_kv_heads
    C = cache.capacity
    D = (cache.k_q.shape[2] * 2) if is_int4 else cache.k.shape[3]
    take, kept, lengths, off, rows_tp, P_s, max_rows = _plan_tp(
        cache, keep, sink, align, tp)
    alloc = P_s

    plan_specs = (P("model", None, None), P("model", None, None),
                  P("model", None))
    a_spec = P(None, "model", None, None)

    def cols(body):
        return _shard_map(
            lambda a, t, k, o: body(a, t[0], k[0], o[0], alloc),
            mesh, (a_spec, *plan_specs), P(None, "model"))

    seen = cache.seen
    if is_int4:
        srcs = dict(k_s=cache.k_s, k_z=cache.k_z, v_s=cache.v_s,
                    v_z=cache.v_z, k_q=cache.k_q, v_q=cache.v_q)
        for f in srcs:
            setattr(cache, f, None)
        cache = None

        def step(body, name):
            a = srcs.pop(name)
            out = cols(body)(a, take, kept, off)
            del a
            jax.block_until_ready(out)
            return out

        fields = dict(
            k_pool_s=step(_pool_gather_scale, "k_s"),
            k_pool_z=step(_pool_gather_scale, "k_z"),
            v_pool_s=step(_pool_gather_scale, "v_s"),
            v_pool_z=step(_pool_gather_scale, "v_z"),
            k_pool_q=step(_pool_gather_kt, "k_q"),
            v_pool_q=step(_pool_gather_kt, "v_q"),
        )
        cls = PoolInt4KV
    else:
        k_src, v_src = cache.k, cache.v
        cache.k = None
        cache.v = None
        cache = None
        k_pool = cols(_pool_gather_k_bf16)(k_src, take, kept, off)
        del k_src
        jax.block_until_ready(k_pool)
        v_pool = _shard_map(
            lambda a, t, k, o: _pool_gather_v_bf16(a, t[0], k[0], o[0],
                                                   alloc),
            mesh, (a_spec, *plan_specs), P("model", None))(
                v_src, take, kept, off)
        del v_src
        jax.block_until_ready(v_pool)
        fields = dict(k_pool=k_pool, v_pool=v_pool)
        cls = PoolKV

    row_head = _shard_map(
        lambda t, k, o: _pool_row_head(t[0], k[0], o[0], C, alloc),
        mesh, plan_specs, P(None, "model"))(take, kept, off)

    from kvzip_tpu.parallel.mesh import _CACHE_FIELD_SPECS
    from jax.sharding import NamedSharding

    pool = cls(
        **fields, row_head=row_head, layer_off=off, layer_rows=rows_tp,
        k_tail=jnp.zeros((L, H, tail_cap, D), dtype),
        v_tail=jnp.zeros((L, H, tail_cap, D), dtype),
        lengths=lengths, tail_len=jnp.zeros((), jnp.int32), seen=seen,
        align=align, max_rows=max_rows, tp=tp, mesh=mesh)
    # tails/lengths head-sharded like every other cache
    return dataclasses.replace(
        pool,
        k_tail=jax.device_put(pool.k_tail, NamedSharding(
            mesh, P(None, "model", None, None))),
        v_tail=jax.device_put(pool.v_tail, NamedSharding(
            mesh, P(None, "model", None, None))),
        lengths=jax.device_put(pool.lengths, NamedSharding(
            mesh, P(None, "model"))))


def pool_attend_tp(q, cache, k_tail_l, v_tail_l, tail_len, layer, *,
                   scale: float, route: str):
    """shard_map wrapper: run the single-device pool decode on every
    shard's local q heads + pool segment.

    q (T, H_q, D) sharded over heads; k_tail_l/v_tail_l: the CURRENT
    layer's (Hkv, Tcap, D) tails (head-sharded); ``route``: the bf16 pool's
    `ops.dispatch.segment_route`."""
    from kvzip_tpu.ops import attention as attn_ops
    from kvzip_tpu.ops import dispatch

    mesh = cache.mesh
    is4 = isinstance(cache, PoolInt4KV)
    max_rows = cache.max_rows
    if is4:
        pools = (cache.k_pool_q, cache.k_pool_s, cache.k_pool_z,
                 cache.v_pool_q, cache.v_pool_s, cache.v_pool_z)
        pool_specs = (P(None, "model"),) * 6
        attend = attn_ops.pool_decode_int4
    else:
        pools = (cache.k_pool, cache.v_pool)
        pool_specs = (P(None, "model"), P("model", None))
        attend = dispatch.pool_decode(route)

    def local(q_l, *args):
        (*pools_l, rh_l, off_l, rows_l, kt_l, vt_l, tl, li) = args
        return attend(q_l, *pools_l, rh_l, off_l[0], rows_l[0], kt_l, vt_l,
                      tl, li, scale=scale, max_rows=max_rows)

    return _shard_map(
        local, mesh,
        (P(None, "model", None), *pool_specs, P(None, "model"),
         P("model", None), P("model", None),
         P("model", None, None), P("model", None, None), P(), P()),
        P(None, "model", None),
    )(q, *pools, cache.row_head, cache.layer_off, cache.layer_rows,
      k_tail_l, v_tail_l, tail_len, jnp.asarray(layer, jnp.int32))
