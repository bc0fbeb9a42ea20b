"""Sequence-parallel (ring attention) prefill over the mesh "data" axis.

The reference handles long context purely by sequential chunked prefill on
one device (`model/wrapper.py:173,189-190`); SURVEY §2b calls out
sequence-parallel prefill for >128k contexts as a net-new component. This
module shards the CONTEXT TOKENS across the "data" axis and computes exact
causal attention with a ring schedule:

- each shard projects Q/K/V for its local token slab (weights are
  replicated along "data", sharded along "model" as usual);
- K/V slabs rotate around the ring via ``jax.lax.ppermute`` while every
  shard accumulates online-softmax partial attention of its local Q
  against the visiting slab, masked by ABSOLUTE positions (slab s covers
  positions [s*S, (s+1)*S));
- after N-1 hops every Q row has seen every K/V row ≤ its position: the
  result is bitwise-equivalent math to single-device causal attention (up
  to f32 accumulation order).

Wall-clock model: each hop moves S·H·D·2 bytes between cards while computing
S×S·H·D MACs — compute-bound for S ≥ a few hundred, so the ring pipeline
hides the collectives (scaling-book §ring-attention).

The produced KV stays sequence-sharded; :func:`ring_prefill_cache` then
re-shards it to the engine's head-sharded layout (one all-to-all-ish
device_put) so scoring/prune/decode run unchanged. That boundary is
explicit: SP accelerates the O(ctx²) prefill, the compressed cache after
eviction is small enough that head sharding is the right resident layout.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from kvzip_tpu.config import ModelConfig
from kvzip_tpu.models.rope import apply_rope, rope_cos_sin
from kvzip_tpu.models.transformer import _act, _lin, _lin_shared, rms_norm


def _ring_attend(q, k, v, pos_q, pos_k, scale, axis: str, n_shards: int):
    """Exact causal attention with a ring of K/V slabs.

    q: (S, H, D) local queries; k/v: (S, Hkv, D) local slab.
    pos_q/pos_k: (S,) absolute positions of the local rows.
    Returns (S, H, D).
    """
    S, H, D = q.shape
    Hkv = k.shape[1]
    G = H // Hkv

    qf = q.astype(jnp.float32).reshape(S, Hkv, G, D)

    def partial_attn(k_vis, v_vis, pos_vis, m, l, acc):
        # scores (S, Hkv, G, S_vis)
        s = jnp.einsum("qhgd,khd->qhgk", qf, k_vis.astype(jnp.float32))
        s = s * scale
        causal = pos_vis[None, :] <= pos_q[:, None]          # (S, S_vis)
        s = jnp.where(causal[:, None, None, :], s, -jnp.inf)
        m_new = jnp.maximum(m, s.max(axis=-1))
        alpha = jnp.where(jnp.isfinite(m), jnp.exp(m - m_new), 0.0)
        p = jnp.where(jnp.isfinite(s), jnp.exp(s - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(axis=-1)
        acc = acc * alpha[..., None] + jnp.einsum(
            "qhgk,khd->qhgd", p, v_vis.astype(jnp.float32))
        return m_new, l, acc

    m0 = jnp.full((S, Hkv, G), -jnp.inf, jnp.float32)
    l0 = jnp.zeros((S, Hkv, G), jnp.float32)
    acc0 = jnp.zeros((S, Hkv, G, D), jnp.float32)
    # shard_map's varying-axis typing: the scan carry becomes
    # device-varying after the first hop, so the (constant) initial
    # accumulators must be marked varying too
    try:
        m0, l0, acc0 = (jax.lax.pvary(x, (axis,)) for x in (m0, l0, acc0))
    except AttributeError:  # older jax: no vma typing, nothing to do
        pass

    def hop(carry, _):
        k_vis, v_vis, pos_vis, m, l, acc = carry
        m, l, acc = partial_attn(k_vis, v_vis, pos_vis, m, l, acc)
        perm = [(i, (i + 1) % n_shards) for i in range(n_shards)]
        k_vis = jax.lax.ppermute(k_vis, axis, perm)
        v_vis = jax.lax.ppermute(v_vis, axis, perm)
        pos_vis = jax.lax.ppermute(pos_vis, axis, perm)
        return (k_vis, v_vis, pos_vis, m, l, acc), None

    (_, _, _, m, l, acc), _ = jax.lax.scan(
        hop, (k, v, pos_k, m0, l0, acc0), None, length=n_shards)
    out = acc / jnp.maximum(l[..., None], 1e-37)
    return out.reshape(S, H, D).astype(q.dtype)


def ring_prefill(params, cfg: ModelConfig, ids: jax.Array, mesh: Mesh,
                 *, axis: str = "data") -> Tuple[jax.Array, jax.Array]:
    """Sequence-parallel prefill of ``ids`` ((T,) int32, T divisible by the
    axis size). Returns (k, v) stacked caches of shape (L, Hkv, T, D) laid
    out sequence-sharded on ``axis`` — pass to :func:`reshard_to_cache` or
    gather for the engine. Exactness is tested against the single-device
    forward on the 8-virtual-device mesh (tests/test_ring_prefill.py).
    """
    n = mesh.shape[axis]
    T = ids.shape[0]
    assert T % n == 0, f"token count {T} not divisible by {axis}={n}"
    L, Hkv, Dh, H = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim, cfg.num_heads
    scale = cfg.query_scale if cfg.query_scale is not None else Dh ** -0.5

    def shard_fn(params, ids_local, pos_local):
        emb = params["embed"]
        from kvzip_tpu.ops.quant import embed_lookup
        x = embed_lookup(emb, ids_local)
        if cfg.gemma_style_norm:
            x = x * jnp.asarray(cfg.hidden_size ** 0.5, x.dtype)
        cos, sin = rope_cos_sin(cfg.rope, Dh, pos_local)
        S = ids_local.shape[0]

        ks, vs = [], []
        lp = params["layers"]
        for li in range(L):
            wp = jax.tree.map(lambda a: a[li], lp)
            h = rms_norm(x, wp["ln_attn"], cfg.rms_norm_eps,
                         gemma=cfg.gemma_style_norm)
            q, k, v = _lin_shared(
                h, (wp["wq"], wp["wk"], wp["wv"]),
                (wp.get("bq"), wp.get("bk"), wp.get("bv")))
            q = q.reshape(S, H, Dh)
            k = k.reshape(S, Hkv, Dh)
            v = v.reshape(S, Hkv, Dh)
            if cfg.qk_norm:
                q = rms_norm(q, wp["q_norm"], cfg.rms_norm_eps,
                             gemma=cfg.gemma_style_norm)
                k = rms_norm(k, wp["k_norm"], cfg.rms_norm_eps,
                             gemma=cfg.gemma_style_norm)
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)

            attn = _ring_attend(q, k, v, pos_local, pos_local, scale,
                                axis, n)
            attn = _lin(attn.reshape(S, H * Dh), wp["wo"])
            if cfg.post_norms:
                attn = rms_norm(attn, wp["ln_post_attn"], cfg.rms_norm_eps,
                                gemma=cfg.gemma_style_norm)
            x = x + attn
            h2 = rms_norm(x, wp["ln_mlp"], cfg.rms_norm_eps,
                          gemma=cfg.gemma_style_norm)
            gate, up = _lin_shared(h2, (wp["w_gate"], wp["w_up"]),
                                   (None, None))
            mlp = _lin(_act(gate, cfg.hidden_act) * up, wp["w_down"])
            if cfg.post_norms:
                mlp = rms_norm(mlp, wp["ln_post_mlp"], cfg.rms_norm_eps,
                               gemma=cfg.gemma_style_norm)
            x = x + mlp
            ks.append(k)
            vs.append(v)
        return jnp.stack(ks), jnp.stack(vs)   # (L, S, Hkv, D) local

    try:
        from jax import shard_map
    except ImportError:  # pre-0.8 jax
        from jax.experimental.shard_map import shard_map

    pos = jnp.arange(T, dtype=jnp.int32)
    fn = shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P(axis), P(axis)),
        out_specs=(P(None, axis), P(None, axis)))
    k, v = jax.jit(fn)(params, ids, pos)
    # (L, T, Hkv, D) seq-sharded -> engine layout (L, Hkv, T, D)
    return k.transpose(0, 2, 1, 3), v.transpose(0, 2, 1, 3)


def reshard_to_cache(k: jax.Array, v: jax.Array, mesh: Mesh, cache):
    """Place ring-prefill KV into an engine cache (head-sharded layout).

    k/v: (L, Hkv, T, D). One cross-axis device_put performs the
    sequence->head reshard (GSPMD lowers it to an all-to-all).
    """
    import dataclasses

    sh = NamedSharding(mesh, P(None, "model", None, None))
    T = k.shape[2]
    kc = jax.lax.dynamic_update_slice(cache.k, jax.device_put(k, sh),
                                      (0, 0, 0, 0))
    vc = jax.lax.dynamic_update_slice(cache.v, jax.device_put(v, sh),
                                      (0, 0, 0, 0))
    return dataclasses.replace(
        cache, k=kc, v=vc,
        lengths=jnp.full_like(cache.lengths, T),
        seen=jnp.asarray(T, jnp.int32))
