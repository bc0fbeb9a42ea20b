"""kvzip engine: prefill → reconstruction scoring → prune → decode.

Public API parity with the reference ``ModelKVzip`` wrapper
(`/root/reference/model/wrapper.py:61-306`): ``prefill``, ``scoring``,
``prune``, ``generate``, ``prob``, ``apply_template`` — re-designed around
functional JAX state instead of a mutable HF cache object:

- every forward is a jitted step over a fixed-capacity cache (static shapes;
  token counts are decomposed onto a chunk ladder so the number of distinct
  compilations is logarithmic, not per-length);
- the reference's ``update_cache=False`` snapshot/``slice`` semantics
  (`model/wrapper.py:120-146`) are O(1) counter restores;
- caches are donated through every step so XLA updates buffers in place.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import List, Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from kvzip_tpu import prune as prune_lib
from kvzip_tpu import template as template_lib
from kvzip_tpu.cache import KVCache, compact, init_cache, restore, set_retain_mask
from kvzip_tpu.config import ModelConfig, resolve_config
from kvzip_tpu.models import params as params_lib
from kvzip_tpu.models.transformer import forward
from kvzip_tpu.ops import dispatch
from kvzip_tpu.pool import POOL_ALIGN
from kvzip_tpu.tokenizer import load_tokenizer

# exact-decomposition ladder: any token count splits into a few jit shapes
CHUNK_LADDER = (16384, 4096, 1024, 256, 64, 16, 4, 1)


def ladder_split(n: int, ladder: Sequence[int] = CHUNK_LADDER) -> List[int]:
    out: List[int] = []
    for size in ladder:
        while n >= size:
            out.append(size)
            n -= size
    return out


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _round_flat_rows(n: int) -> int:
    """Flat r_pad bucket: few distinct widths (each one compiles its own
    decode), little padding."""
    return _round_up(n, 8192 if n <= 65536 else 32768)


@dataclasses.dataclass
class KVState:
    """Host-side handle for one context's compressed cache (cf. reference
    EvictCache/RetainCache object state, `attention/kvcache.py:14-40`)."""

    cache: KVCache
    kv_type: str                      # "retain" | "evict"
    sink: int                         # system-prompt rows, never evicted
    ctx_len: int
    prefill_len: int
    score: Optional[jax.Array] = None  # (L, H_kv, ctx_len)
    prefill_ids: Optional[np.ndarray] = None
    ctx_ids: Optional[np.ndarray] = None
    pruned: bool = False
    _snap: Optional[dict] = None

    def snapshot(self):
        from kvzip_tpu.cache import snapshot as cache_snapshot

        snap = cache_snapshot(self.cache)
        # device-side copy for rings: forwards donate the cache, so the
        # live ring buffer gets overwritten in place — a plain reference
        # would alias a dead buffer
        rings = {k: jnp.copy(snap.pop(k))
                 for k in ("k_ring", "v_ring") if k in snap}
        # counters fetch in ONE device_get (one host sync instead of one
        # per counter; generate snapshots on every call)
        fetched = jax.device_get(snap)
        self._snap = {k: np.asarray(v) for k, v in fetched.items()}
        self._snap.update(rings)

    def restore_snapshot(self):
        # device arrays (ring backups) are COPIED in: the restored cache is
        # donated by the next forward, which would delete the snapshot's own
        # buffer and poison any later restore
        self.cache = restore(
            self.cache,
            {k: (jnp.copy(v) if isinstance(v, jax.Array) else jnp.asarray(v))
             for k, v in self._snap.items()})

    def mem_gb(self) -> float:
        return round(self.cache.mem_bytes() / 1e9, 3)

    def used_gb(self) -> float:
        return round(self.cache.used_bytes() / 1e9, 3)


def _score_progress() -> bool:
    import os
    return os.environ.get("KVZIP_PROGRESS", "") not in ("", "0")


@partial(jax.jit, donate_argnames=("score",))
def _place_scores(score, chunk, offset, n):
    """Write the first ``n`` columns of ``chunk`` into score at ``offset``."""
    L, H, W = chunk.shape
    col = jax.lax.broadcasted_iota(jnp.int32, (L, H, W), 2)
    cur = jax.lax.dynamic_slice(score, (0, 0, offset), (L, H, W))
    merged = jnp.where(col < n, chunk.astype(score.dtype), cur)
    return jax.lax.dynamic_update_slice(score, merged, (0, 0, offset))


class Engine:
    """ModelKVzip (reference `model/wrapper.py:61`) on JAX."""

    def __init__(
        self,
        model_name: str,
        kv_type: str = "evict",
        *,
        config: Optional[ModelConfig] = None,
        params=None,
        tokenizer=None,
        dtype=jnp.bfloat16,
        attn_impl: str = "auto",     # "auto" | a dense route | "kernel" |
                                     # "plain" (evicted-cache decode route)
        max_new_tokens: int = 512,
        decode_budget: int = 768,
        capacity_granularity: int = 512,
        score_chunk_size: int = 2000,
        kv_quant: str = "none",      # "none" | "int4"
        weight_quant: str = "none",  # "none" | "w8a8" | "w4a8"
        embed_quant: str = "none",   # "none" | "int8" (embed + lm_head)
        flat_decode: str = "auto",   # "auto"|"on"|"off"|"legacy" (uniform flat)
        scoring_attend: str = "full",  # "full" (reference parity) |
                                       # "window" (O(ctx·window) approx —
                                       # ops/attention.py::windowed_scoring_attend)
        mesh=None,
        seq_parallel: bool = False,  # ring-attention prefill over mesh "data"
        seed: int = 0,
    ):
        self.config = config or resolve_config(model_name)
        # checkpoint-dir names collapse to the basename for result/file tags
        self.name = (model_name.rstrip("/").split("/")[-1]
                     if "/" in model_name else model_name)
        self.dtype = dtype
        if self.config.is_hybrid and kv_type == "evict":
            # parity: reference forces retain for Gemma3 (model/wrapper.py:74-76)
            kv_type = "retain"
        self.kv_type = kv_type
        self.attn_impl = attn_impl
        self.max_new_tokens = max_new_tokens
        self.decode_budget = max(decode_budget, max_new_tokens + 128)
        self.capacity_granularity = capacity_granularity
        # scoring window geometry (reference chunk 2000, model/wrapper.py:200);
        # padded to static shapes so all scoring chunks share one compilation
        self.score_chunk_size = score_chunk_size
        self.score_width = _round_up(score_chunk_size, 128)
        self.score_q_pad = self.score_width + 256

        self.kv_quant = kv_quant
        self.weight_quant = weight_quant
        self.flat_decode = flat_decode
        if scoring_attend not in ("full", "window"):
            raise ValueError(f"scoring_attend: {scoring_attend!r}")
        if scoring_attend == "window" and self.config.is_hybrid:
            raise ValueError(
                "scoring_attend='window' is not supported for hybrid "
                "(gemma3) models — their scoring runs in forward_hybrid")
        self.scoring_attend = scoring_attend
        self.seq_parallel = seq_parallel
        # loader policy lives in params.prepare_params (checkpoint / init /
        # passed-in x quantization forms, all conversion paths chunked)
        params, self.weight_quant = params_lib.prepare_params(
            self.config, model_name, dtype=dtype, weight_quant=weight_quant,
            embed_quant=embed_quant, seed=seed, params=params)
        self.mesh = mesh
        if mesh is not None:
            from kvzip_tpu.parallel import shard_params
            params = shard_params(self.config, mesh, params)
        self.params = params
        self.tokenizer = tokenizer or load_tokenizer(
            model_name, vocab_size=self.config.vocab_size)
        # no silent fallback: an unknown family with a
        # tokenizer that declares no eos would otherwise stop on an
        # arbitrary token id
        _eos = template_lib.eos_ids(model_name, self.tokenizer)
        if not _eos:
            raise ValueError(
                f"no eos ids for {model_name!r}: the tokenizer declares "
                "none and the template table has no entry for this family")
        self.eos_ids = tuple(_eos)
        self.set_chat_template()
        self._decode_fns = {}

    # ------------------------------------------------------------------ text
    def encode(self, text: str) -> np.ndarray:
        ids = self.tokenizer.encode(text, add_special_tokens=False)
        return np.asarray(ids, np.int32).reshape(-1)

    def decode(self, ids) -> str:
        ids = np.asarray(ids).reshape(-1)
        return self.tokenizer.decode(ids, skip_special_tokens=True)

    def set_chat_template(self, task: str = "qa"):
        prefix, postfix = template_lib.template(self.name, task)
        self.sys_prompt_ids = self.encode(prefix)
        self.postfix_ids = self.encode(postfix)

    def apply_template(self, query: str) -> np.ndarray:
        q = f"\n\n{query.strip()}"
        return np.concatenate([self.encode(q), self.postfix_ids])

    # --------------------------------------------------------------- forward
    @staticmethod
    def _fwd_fn(cache):
        """Route to the hybrid (ring-buffered) forward for gemma3 caches."""
        from kvzip_tpu.cache import HybridKV

        if isinstance(cache, HybridKV):
            from kvzip_tpu.models.hybrid import forward_hybrid
            return forward_hybrid
        return forward

    def _pool_tp_ok(self) -> bool:
        """Per-shard pools (parallel/pool_tp.py) apply when kv heads split
        evenly over the "model" axis; legacy flat has no TP form."""
        if self.mesh is None:
            return True
        return ("model" in self.mesh.axis_names
                and self.config.num_kv_heads % self.mesh.shape["model"] == 0
                and self.flat_decode != "legacy")

    def _use_flat(self, state: "KVState") -> bool:
        """Build the flat/pool decode cache at prune time? (evict path;
        bf16 or int4-with-one-group-per-row KV; 128-aligned head_dim).
        ``flat_decode="legacy"`` forces the round-3 uniform-r_pad layout.
        Under a mesh the pool builds per-shard."""
        if self.flat_decode == "off":
            return False
        if self.kv_quant == "int4" and self.config.head_dim != 128:
            return False  # int4 flat layout needs one quant group per row
        if self.mesh is not None and not self._pool_tp_ok():
            return False
        if self.flat_decode in ("on", "legacy"):
            return True
        # the CPU keeps the dense compacted cache by default (fewer layout
        # builds in tests); the evicted layouts are the accelerator's path
        return (self.config.head_dim % 128 == 0
                and dispatch.platform() == "gpu")

    def _impl(self, state: "KVState") -> str:
        """Attention route (a static forward argument): for evicted caches
        `ops.dispatch.segment_route`, for dense ones
        `ops.dispatch.dense_attend`; an explicit ``attn_impl`` that fits the
        cache wins."""
        from kvzip_tpu.cache import FlatInt4KV, FlatKV
        from kvzip_tpu.pool import PoolInt4KV, PoolKV

        if isinstance(state.cache, (FlatKV, FlatInt4KV, PoolKV, PoolInt4KV)):
            if self.attn_impl in dispatch.SEGMENT_ROUTES:
                return self.attn_impl
            return dispatch.segment_route(dispatch.platform())
        if self.attn_impl not in ("auto",) + dispatch.SEGMENT_ROUTES:
            return self.attn_impl
        masked = ((state.pruned and state.kv_type == "retain")
                  or self.config.is_hybrid
                  or self.config.sliding_window is not None)
        return dispatch.dense_attend(dispatch.platform(),
                                     capacity=state.cache.capacity,
                                     masked=masked)

    def _check_capacity(self, state: KVState, need: int, cur=None):
        """Fail loudly instead of letting a clamped dynamic_update_slice
        silently corrupt the cache tail. ``cur``: already-fetched tail_len
        (generate fetches it once and shares it with _maybe_refold)."""
        from kvzip_tpu.cache import FlatInt4KV, FlatKV
        from kvzip_tpu.pool import PoolInt4KV, PoolKV

        cache = state.cache
        if isinstance(cache, (FlatKV, FlatInt4KV, PoolKV, PoolInt4KV)):
            cap = cache.k_tail.shape[2]
            if cur is None:
                cur = int(jax.device_get(cache.tail_len))
            if cur + need > cap:
                raise ValueError(
                    f"query+generation needs {need} tail rows but only "
                    f"{cap - cur} remain (decode_budget={cap}); raise "
                    f"decode_budget or lower max_new_tokens")
        else:
            cur = int(jax.device_get(cache.lengths.max()))
            if cur + need > cache.capacity:
                raise ValueError(
                    f"query+generation needs {need} rows beyond {cur} but "
                    f"capacity is {cache.capacity}; raise decode_budget")

    def _maybe_refold(self, state: KVState, need: int, cur=None):
        """Multi-turn beyond the tail budget on the flat evict path: fold the
        committed tail into the flat context (reference re-gathers the
        flattened cache every ``slice``, `attention/kvcache.py:82-106`; here
        it happens only when the tail is about to overflow). ``cur``: see
        _check_capacity."""
        from kvzip_tpu.cache import FlatInt4KV, FlatKV, refold_flat
        from kvzip_tpu.pool import PoolInt4KV, PoolKV, refold_pool

        cache = state.cache
        if isinstance(cache, (PoolKV, PoolInt4KV)):
            cap = cache.k_tail.shape[2]
            if cur is None:
                cur = int(jax.device_get(cache.tail_len))
            if cur + need <= cap:
                return
            if getattr(cache, "tp", 0):
                raise NotImplementedError(
                    "tail refold of a tensor-parallel pool is not "
                    "implemented; raise decode_budget so committed turns "
                    "fit the tail, or serve this context single-device")
            state.cache = refold_pool(cache)
            state.snapshot()
            return
        if not isinstance(cache, (FlatKV, FlatInt4KV)):
            return
        cap = cache.k_tail.shape[2]
        if cur is None:
            cur = int(jax.device_get(cache.tail_len))
        if cur + need <= cap:
            return
        lens = np.asarray(jax.device_get(cache.lengths))
        rows = int((lens + cur).sum(axis=-1).max())
        state.cache = refold_flat(cache, _round_flat_rows(rows))
        state.snapshot()

    def _ring_prefill(self, state: KVState, prefill_ids: np.ndarray) -> int:
        """Sequence-parallel prefill over the mesh "data" axis (opt-in via
        ``Engine(..., seq_parallel=True)``, SURVEY §2b).

        The largest data-axis-divisible prefix goes through the ring
        (`parallel/ring_prefill.py`: K/V slabs rotate via ppermute while
        every shard accumulates online-softmax attention of its local Q);
        the produced KV is resharded to the engine's head-sharded layout in
        one device_put, and the remainder tokens + scoring/prune/decode run
        on the normal path. Returns the number of tokens prefetched (0 when
        the ring does not apply: no data axis, quantized/hybrid cache, or
        fused-W4A8 weights)."""
        from kvzip_tpu.cache import KVCache as _DenseKV

        if (not self.seq_parallel or self.mesh is None
                or "data" not in self.mesh.axis_names
                or self.mesh.shape["data"] < 2
                or type(state.cache) is not _DenseKV
                or "wq" not in self.params["layers"]):
            return 0
        n = self.mesh.shape["data"]
        t_ring = (len(prefill_ids) // n) * n
        if t_ring < n:
            return 0
        from kvzip_tpu.parallel.ring_prefill import (reshard_to_cache,
                                                     ring_prefill)
        k, v = ring_prefill(self.params, self.config,
                            jnp.asarray(prefill_ids[:t_ring], jnp.int32),
                            self.mesh)
        state.cache = reshard_to_cache(k, v, self.mesh, state.cache)
        self._sync(state)
        return t_ring

    @staticmethod
    def _sync(state: KVState) -> None:
        """Wait for the cache's last chunk: at most one prefill or scoring
        chunk is in flight, so a failing chunk raises at that chunk and the
        per-chunk progress times are device times."""
        seen = getattr(state.cache, "seen", None)
        if seen is not None:
            jax.block_until_ready(seen)

    def _forward_chunks(self, ids: np.ndarray, state: KVState,
                        collect: str = "none") -> Optional[np.ndarray]:
        """Run ids through the model on the chunk ladder; maybe return logits."""
        from kvzip_tpu.cache import FlatInt4KV, FlatKV

        from kvzip_tpu.pool import PoolInt4KV, PoolKV

        impl = self._impl(state)
        ladder = CHUNK_LADDER
        if isinstance(state.cache, (FlatKV, FlatInt4KV, PoolKV, PoolInt4KV)):
            # evicted caches take queries in decode-sized chunks: every
            # chunk re-reads the layer's whole segment, and the plain
            # route's (T, H, rows) logits stay small
            ladder = (64, 16, 4, 1)
        logits_parts = []
        pos = 0
        for size in ladder_split(len(ids), ladder):
            chunk = jnp.asarray(ids[pos:pos + size])
            pos += size
            want = collect if collect == "all" else (
                "last" if pos == len(ids) and collect == "last" else "none")
            res = self._fwd_fn(state.cache)(
                self.params, self.config, chunk, state.cache,
                collect_logits=want, sink=state.sink, attn_impl=impl)
            state.cache = res.cache
            if res.logits is not None:
                logits_parts.append(res.logits)
        if collect == "all":
            return jnp.concatenate(logits_parts, axis=0)
        if collect == "last":
            return logits_parts[-1]
        return None

    # --------------------------------------------------------------- prefill
    def prefill(
        self,
        ctx: Union[str, np.ndarray],
        prefill_chunk_size: int = 16000,
        load_score: bool = False,
        do_score: bool = True,
        head_score_dirs: Sequence[str] = ("./head_score",),
    ) -> KVState:
        """Chunked prefill + (optionally) KV importance scoring.

        Reference `model/wrapper.py:169-195`.
        """
        ctx_ids = self.encode(ctx) if isinstance(ctx, str) else np.asarray(ctx)
        prefill_ids = np.concatenate([self.sys_prompt_ids, ctx_ids])
        sink = int(len(self.sys_prompt_ids))
        prefill_len = int(len(prefill_ids))

        extra = max(self.score_q_pad, self.decode_budget)
        capacity = _round_up(prefill_len + extra, self.capacity_granularity)
        if self.config.is_hybrid:
            # ring-buffered sliding layers (window-bound memory); int4 KV
            # is a llama-family feature in the reference — not composed here
            from kvzip_tpu.cache import init_hybrid_cache
            cache = init_hybrid_cache(self.config, capacity, self.dtype)
        elif self.kv_quant == "int4":
            from kvzip_tpu.cache import init_int4_cache
            cache = init_int4_cache(self.config, capacity, self.dtype)
        else:
            cache = init_cache(self.config, capacity, self.dtype)
        if self.mesh is not None:
            from kvzip_tpu.parallel import shard_cache
            cache = shard_cache(self.mesh, cache)

        state = KVState(
            cache=cache, kv_type=self.kv_type, sink=sink,
            ctx_len=int(len(ctx_ids)), prefill_len=prefill_len,
            prefill_ids=prefill_ids, ctx_ids=ctx_ids)

        import os as _os
        import sys as _sys
        import time as _time
        progress = _os.environ.get("KVZIP_PROGRESS", "") not in ("", "0")

        pos = self._ring_prefill(state, prefill_ids)
        while pos < prefill_len:
            n = min(prefill_chunk_size, prefill_len - pos)
            t0 = _time.time()
            if n < prefill_chunk_size and n % 256 and not self.config.is_hybrid:
                # pad the final partial chunk to a 256 multiple: its ladder
                # then decomposes into the standard {16384,4096,1024,256}
                # shapes instead of compiling fresh 64/16/4/1-token forwards
                # (each one a compilation of the whole model). The
                # pad rows land beyond the live lengths; rolling the
                # counters back makes them invisible and the next append
                # overwrites them (causal masking keeps them out of every
                # real token's attention during the chunk itself).
                p = _round_up(n, 256)
                buf = np.zeros((p,), np.int32)
                buf[:n] = prefill_ids[pos:pos + n]
                self._forward_chunks(buf, state)
                state.cache = dataclasses.replace(
                    state.cache,
                    lengths=state.cache.lengths - (p - n),
                    seen=state.cache.seen - (p - n))
            else:
                self._forward_chunks(prefill_ids[pos:pos + n], state)
            pos += n
            self._sync(state)
            if progress:
                print(f"[prefill] {pos}/{prefill_len} "
                      f"(+{n} tok, {_time.time() - t0:.1f}s)",
                      file=_sys.stderr, flush=True)

        state.snapshot()
        if do_score:
            self.scoring(state, ctx_ids, load_score=load_score,
                         head_score_dirs=head_score_dirs)
        return state

    # --------------------------------------------------------------- scoring
    def self_task(self, ctx_ids: np.ndarray, chunk_size: int = 2000,
                  prev_postfix_size: int = 8) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Build (chunk, repeat-prompt ∥ prev-tail ∥ postfix ∥ chunk) pairs.

        Reference `model/wrapper.py:197-221`.
        """
        chunks = [ctx_ids[i:i + chunk_size]
                  for i in range(0, len(ctx_ids), chunk_size)]
        out = []
        for i, a_ids in enumerate(chunks):
            if i == 0:
                q_ids = self.encode("\n\nRepeat the previous context exactly.")
            else:
                q_ids = self.encode(
                    "\n\nRepeat the part of the previous context exactly, "
                    "starting with ")
                q_ids = np.concatenate([q_ids, chunks[i - 1][-prev_postfix_size:]])
            rep = np.concatenate([q_ids, self.postfix_ids, a_ids])
            out.append((a_ids, rep))
        return out

    def scoring(self, state: KVState, ctx_ids: np.ndarray,
                load_score: bool = False,
                head_score_dirs: Sequence[str] = ("./head_score",)):
        """KV importance scoring via context reconstruction.

        Reference `model/wrapper.py:223-249` + `attention/score.py:36-65`.
        Scores land in ``state.score`` with shape (L, H_kv, ctx_len).
        """
        cfg = self.config
        L, H = cfg.num_layers, cfg.num_kv_heads
        if load_score:
            state.score = prune_lib.load_head_score(
                self.name, state.ctx_len, head_score_dirs)
            return

        impl = self._impl(state)
        # one extra window of slack: chunk offsets advance by score_chunk_size
        # (2000) but each _place_scores write is score_width (2048) wide, so
        # without the slack the last windows would exceed the buffer and
        # dynamic_slice would silently clamp the start — overwriting earlier
        # scores and zeroing the true tail
        score = jnp.zeros(
            (L, H, _round_up(max(state.ctx_len, 1), self.score_width)
             + self.score_width),
            jnp.float32)
        start = state.sink
        for a_ids, rep_ids in self.self_task(ctx_ids, self.score_chunk_size):
            n_q = len(rep_ids)
            if n_q > self.score_q_pad:
                raise ValueError(
                    f"repeat pass needs {n_q} tokens > score_q_pad "
                    f"{self.score_q_pad}; raise score_chunk_size padding")
            rep_padded = np.zeros((self.score_q_pad,), np.int32)
            rep_padded[:n_q] = rep_ids
            res = self._fwd_fn(state.cache)(
                self.params, cfg, jnp.asarray(rep_padded), state.cache,
                scoring=True,
                score_start=jnp.asarray(start, jnp.int32),
                score_len=jnp.asarray(len(a_ids), jnp.int32),
                score_qlen=jnp.asarray(n_q, jnp.int32),
                score_width=self.score_width, sink=state.sink,
                attn_impl=impl, scoring_attend=self.scoring_attend)
            state.cache = res.cache
            score = _place_scores(score, res.chunk_scores,
                                  jnp.asarray(start - state.sink, jnp.int32),
                                  jnp.asarray(len(a_ids), jnp.int32))
            start += len(a_ids)
            state.restore_snapshot()
            self._sync(state)
            if _score_progress():
                import sys as _sys
                print(f"[scoring] {start - state.sink}/{state.ctx_len}",
                      file=_sys.stderr, flush=True)

        assert start - state.sink == state.ctx_len
        state.score = score[:, :, :state.ctx_len]

    # ----------------------------------------------------------------- prune
    def prune(self, state: KVState, ratio: float, level: str = "pair"
              ) -> Tuple[float, float]:
        """Prune the KV cache; returns (threshold, true_ratio).

        Retain path stores the mask (reference `kvcache.py:284-298`); evict
        path physically compacts (reference `prune`+`prepare_init`,
        `kvcache.py:123-185`).
        """
        from kvzip_tpu.cache import FlatInt4KV, FlatKV
        from kvzip_tpu.pool import PoolInt4KV, PoolKV

        # checked BEFORE the score assertion: the evict path frees the score
        # buffer during prune, so a re-prune would otherwise hit the wrong
        # (misleading) error. One-shot matches the reference: EvictCache
        # prune()/prepare_init() physically flattens once and sets
        # self.pruned (`attention/kvcache.py:123-185`); ratio sweeps use
        # kv_type="retain" there too. A second compact here would apply an
        # original-position mask to already-moved rows — silently wrong.
        if isinstance(state.cache,
                      (FlatKV, FlatInt4KV, PoolKV, PoolInt4KV)) or (
                state.kv_type == "evict" and state.pruned):
            raise RuntimeError(
                "evict-path prune is one-shot (the cache was physically "
                "compacted); use kv_type='retain' to sweep multiple ratios")
        assert state.score is not None, "run scoring() first"
        static_layers = (self.config.static_layer_ids
                         if self.config.is_hybrid else None)
        keep, thres, true_ratio = prune_lib.prune_mask(
            state.score, ratio, level, static_layers,
            # histogram quantile everywhere: identical mask to the sort on
            # bf16-grid scores (tests/test_parallel.py), local under
            # sharding, and avoids XLA's slow multi-10M-element sort — the
            # sort was a large, erratic share of prune_s
            method="histogram")

        if state.kv_type == "retain":
            from kvzip_tpu.cache import HybridKV

            if isinstance(state.cache, HybridKV):
                # hybrid valid covers static layers only; sliding layers
                # are never pruned (reference scores/prunes static layers,
                # `attention/kvcache.py:534-562`)
                keep_static = keep[np.asarray(static_layers)]
                L_t, H, C = state.cache.valid.shape
                valid = jnp.ones((L_t, H, C), jnp.bool_)
                valid = jax.lax.dynamic_update_slice(
                    valid, keep_static.astype(jnp.bool_), (0, 0, state.sink))
                state.cache = dataclasses.replace(state.cache, valid=valid)
            else:
                static_mask = None
                if static_layers is not None:
                    m = np.zeros((self.config.num_layers,), bool)
                    m[list(static_layers)] = True
                    static_mask = jnp.asarray(m)
                state.cache = set_retain_mask(state.cache, keep, state.sink,
                                              static_mask)
        elif state.kv_type == "evict" and level == "head" \
                and not self.config.is_hybrid and not self._use_flat(state):
            # head-level keep is constant over the sequence (whole heads
            # kept or dropped), so when no flat/pool layout applies (CPU
            # fallback, sharded cache) eviction is a LENGTHS update — zero
            # data movement. The ragged kernels read only [0, lengths) per
            # head. On the pool path (below) head level compacts like pair
            # level: the pool's per-layer offsets give true memory shrink
            # AND the fast pipelined kernel (round-3's uniform-r_pad flat
            # stack degenerated to full capacity at head granularity and
            # decoded 3x SLOWER than the full cache).
            state.score = None
            head_keep = keep.any(axis=-1)                       # (L, H)
            new_len = jnp.where(head_keep, state.cache.lengths,
                                jnp.int32(state.sink))
            state.cache = dataclasses.replace(state.cache, lengths=new_len)
        elif state.kv_type == "evict":
            # one-shot path: the score buffer is dead once keep is computed —
            # free it before the compaction gather (216 MB at 480k ctx)
            state.score = None
            if self._use_flat(state) and self.flat_decode == "legacy":
                # round-3 uniform-r_pad flat layout (kept for the merged
                # batched-serving path and A/B probes)
                from kvzip_tpu.cache import (Int4KVCache,
                                             build_flat_donated,
                                             build_flat_int4_stepped)

                per_layer = np.asarray(jax.device_get(keep.sum(axis=(1, 2))))
                r_pad = _round_flat_rows(
                    int(per_layer.max())
                    + state.sink * self.config.num_kv_heads)
                if isinstance(state.cache, Int4KVCache):
                    state.cache = build_flat_int4_stepped(
                        state.cache, keep, state.sink, r_pad,
                        self.decode_budget, self.dtype)
                else:
                    state.cache = build_flat_donated(
                        state.cache, keep, state.sink, r_pad,
                        self.decode_budget)
            elif self._use_flat(state):
                # POOL decode layout: every layer's kept rows concatenated
                # with per-layer offsets — HBM reads = the true compressed
                # footprint at ANY per-layer spread (pair AND head levels).
                # Stepped donated builds: the dense cache dies here, array
                # by array (480k does not fit otherwise).
                from kvzip_tpu.cache import Int4KVCache
                from kvzip_tpu.pool import (build_pool_int4_stepped,
                                            build_pool_stepped)

                align = POOL_ALIGN
                try:
                    if self.mesh is not None:
                        # per-shard pools over local kv heads; decode runs
                        # the same kernels under shard_map (pool_tp.py)
                        from kvzip_tpu.parallel.pool_tp import build_pool_tp
                        state.cache = build_pool_tp(
                            state.cache, keep, state.sink,
                            self.decode_budget, self.dtype, align=align,
                            mesh=self.mesh)
                    elif isinstance(state.cache, Int4KVCache):
                        state.cache = build_pool_int4_stepped(
                            state.cache, keep, state.sink,
                            self.decode_budget, self.dtype, align=align)
                    else:
                        state.cache = build_pool_stepped(
                            state.cache, keep, state.sink,
                            self.decode_budget, align=align)
                except BaseException as e:
                    # the builders consume the dense cache array-by-array;
                    # leave a sentinel that says so instead of a half-gutted
                    # dataclass raising NoneType errors
                    from kvzip_tpu.pool import ConsumedCache
                    state.cache = ConsumedCache(
                        f"{type(e).__name__}: {e}")
                    raise
            else:
                kept_rows = int(jax.device_get(
                    keep.sum(axis=-1).max())) + state.sink
                new_cap = _round_up(kept_rows + self.decode_budget,
                                    self.capacity_granularity)
                state.cache = compact(state.cache, keep, state.sink, new_cap)
        else:
            raise NotImplementedError(state.kv_type)

        state.pruned = True
        state.snapshot()
        return thres, true_ratio

    def flatten_full(self, state: KVState) -> KVState:
        """Flat-view the FULL dense cache (keep every context row).

        The honest full-cache decode baseline: the
        baseline decode reads the same flat layout through the same Pallas
        kernels as the evicted cache — just with every row live — so the
        reported speedup isolates eviction, not kernel quality. Returns a
        NEW KVState; the input state and its dense cache are untouched.
        """
        from kvzip_tpu.cache import (FlatInt4KV, FlatKV, Int4KVCache,
                                     build_flat, build_flat_int4)
        from kvzip_tpu.pool import PoolInt4KV, PoolKV

        if isinstance(state.cache, (FlatKV, FlatInt4KV, PoolKV, PoolInt4KV)):
            raise RuntimeError("cache is already flat")
        L, H = self.config.num_layers, self.config.num_kv_heads
        keep = jnp.ones((L, H, state.ctx_len), bool)
        r_pad = _round_flat_rows(H * (state.ctx_len + state.sink))
        if isinstance(state.cache, Int4KVCache):
            cache = build_flat_int4(state.cache, keep, state.sink, r_pad,
                                    self.decode_budget, self.dtype)
        else:
            cache = build_flat(state.cache, keep, state.sink, r_pad,
                               self.decode_budget)
        new_state = dataclasses.replace(state, cache=cache, pruned=True)
        new_state.snapshot()
        return new_state

    def synthetic_full_flat_state(self, state: KVState, flat_int4: bool,
                                  tail_cap: int) -> KVState:
        """Full-occupancy flat cache with the exact shapes/row counts that
        ``flatten_full(state)`` would produce — the honest full-cache decode
        baseline when the dense cache no longer exists (prune donates it).

        Decode time does not depend on the values (no data-dependent
        branches), so constant fill is sufficient — and cheaper: jax.random
        materializes an int32/f32 intermediate of the full shape. Used by
        bench.py and ``cli demo`` after the evicted cache has been freed.
        """
        from kvzip_tpu.cache import FlatInt4KV, FlatKV

        cfg = self.config
        L, H, D = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
        per_head = state.ctx_len + state.sink
        r_pad = _round_flat_rows(H * per_head)
        rh = np.full((r_pad,), -1, np.int32)
        rh[:H * per_head] = np.repeat(np.arange(H, dtype=np.int32), per_head)
        row_head = jnp.asarray(np.broadcast_to(rh, (L, r_pad)))
        common = dict(
            row_head=row_head,
            lengths=jnp.full((L, H), per_head, jnp.int32),
            tail_len=jnp.zeros((), jnp.int32),
            seen=jnp.asarray(per_head, jnp.int32),
        )
        if flat_int4:
            cache = FlatInt4KV(
                k_flat_q=jnp.full((L, D // 2, r_pad), 0x5A, jnp.uint8),
                v_flat_q=jnp.full((L, D // 2, r_pad), 0xA5, jnp.uint8),
                k_flat_s=jnp.full((L, r_pad), 0.01, jnp.float32),
                k_flat_z=jnp.full((L, r_pad), -0.05, jnp.float32),
                v_flat_s=jnp.full((L, r_pad), 0.01, jnp.float32),
                v_flat_z=jnp.full((L, r_pad), -0.05, jnp.float32),
                k_tail=jnp.zeros((L, H, tail_cap, D), self.dtype),
                v_tail=jnp.zeros((L, H, tail_cap, D), self.dtype),
                **common)
        else:
            cache = FlatKV(
                k_flat=jnp.full((L, D, r_pad), 0.02, self.dtype),
                v_flat=jnp.full((L, r_pad, D), 0.03, self.dtype),
                k_tail=jnp.zeros((L, H, tail_cap, D), self.dtype),
                v_tail=jnp.zeros((L, H, tail_cap, D), self.dtype),
                **common)
        st = dataclasses.replace(state, cache=cache, pruned=True)
        st.snapshot()
        return st

    def synthetic_full_pool_state(self, state: KVState, int4: bool,
                                  tail_cap: int) -> KVState:
        """Full-occupancy POOL with the exact geometry an all-rows-kept
        build produces — the honest full-cache decode baseline measured in
        the same run, after the dense cache has been donated into the
        pruned pool (decode time does not depend on the values; reference
        demo compares both modes against a same-run baseline,
        `demo.py:29-50`)."""
        from kvzip_tpu.pool import synthetic_full_pool

        cfg = self.config
        cache = synthetic_full_pool(
            cfg.num_layers, cfg.num_kv_heads, cfg.head_dim,
            state.ctx_len + state.sink, tail_cap, self.dtype, int4=int4,
            align=POOL_ALIGN)
        st = dataclasses.replace(state, cache=cache, pruned=True)
        st.snapshot()
        return st

    # ------------------------------------------------------ state save/load
    def save_state(self, state: KVState, path: str) -> str:
        """Persist a pruned pool state to disk (np.savez + a JSON sidecar)
        so later runs can bench/serve the compressed cache WITHOUT paying
        prefill + scoring again. The reference has no persisted-cache
        equivalent; closest is its head-score assets
        (`utils/head_score/*.pt`)."""
        import json

        from kvzip_tpu.pool import PoolInt4KV, PoolKV

        cache = state.cache
        if not isinstance(cache, (PoolKV, PoolInt4KV)):
            raise ValueError("save_state supports pool caches (post-prune)")
        if getattr(cache, "tp", 0):
            raise ValueError(
                "save_state persists single-device pools; a TP pool's "
                "geometry is mesh-specific — prune without a mesh to save")
        base = path[:-4] if path.endswith(".npz") else path
        arrays = {}
        dtypes = {}
        for f in dataclasses.fields(cache):
            v = getattr(cache, f.name)
            if isinstance(v, jax.Array):
                a = np.asarray(jax.device_get(v))
                dtypes[f.name] = str(jnp.dtype(a.dtype).name)
                if a.dtype == jnp.bfloat16:
                    # numpy persists ml_dtypes.bfloat16 as a void ("|V2")
                    # descriptor that np.load cannot hand back to JAX —
                    # store the raw bits as uint16 and record the dtype
                    a = a.view(np.uint16)
                arrays[f.name] = a
        np.savez(base + ".npz", **arrays)
        meta = dict(
            kind="PoolInt4KV" if isinstance(cache, PoolInt4KV) else "PoolKV",
            align=cache.align, max_rows=cache.max_rows,
            model=self.name, kv_type=state.kv_type, sink=state.sink,
            ctx_len=state.ctx_len, prefill_len=state.prefill_len,
            dtype=str(jnp.dtype(self.dtype).name),
            array_dtypes=dtypes,
        )
        with open(base + ".json", "w") as f:
            json.dump(meta, f)
        return base + ".npz"

    def load_state(self, path: str) -> KVState:
        """Rehydrate a :meth:`save_state` artifact onto the device."""
        import json

        from kvzip_tpu.pool import PoolInt4KV, PoolKV

        base = path[:-4] if path.endswith(".npz") else path
        with open(base + ".json") as f:
            meta = json.load(f)
        if meta["model"] != self.name:
            raise ValueError(
                f"state was saved for {meta['model']!r}, engine is "
                f"{self.name!r}")
        cls = PoolInt4KV if meta["kind"] == "PoolInt4KV" else PoolKV
        data = np.load(base + ".npz")
        adt = meta.get("array_dtypes", {})

        def rehydrate(k, v):
            want = adt.get(k)
            if want and str(v.dtype) != want:
                # bfloat16 persisted as raw uint16 bits (see save_state);
                # jnp.dtype resolves ml_dtypes names numpy alone cannot
                v = v.view(jnp.dtype(want))
            elif v.dtype.kind == "V" and v.dtype.itemsize == 2:
                # artifact from before array_dtypes: numpy stored
                # ml_dtypes.bfloat16 as an opaque void-2 descriptor
                v = v.view(jnp.dtype("bfloat16"))
            return jnp.asarray(v)

        kwargs = {k: rehydrate(k, v) for k, v in data.items()}
        # grow the (empty) decode tail to this engine's budget when the
        # state was saved by an engine with a smaller one — tail capacity
        # is static per artifact, and a longer generate would otherwise
        # trip _check_capacity even though only zeros are stored
        tcap = kwargs["k_tail"].shape[2]
        if self.decode_budget > tcap:
            pad = ((0, 0), (0, 0), (0, self.decode_budget - tcap), (0, 0))
            kwargs["k_tail"] = jnp.pad(kwargs["k_tail"], pad)
            kwargs["v_tail"] = jnp.pad(kwargs["v_tail"], pad)
        cache = cls(**kwargs, align=int(meta["align"]),
                    max_rows=int(meta["max_rows"]))
        state = KVState(
            cache=cache, kv_type=meta["kv_type"], sink=int(meta["sink"]),
            ctx_len=int(meta["ctx_len"]),
            prefill_len=int(meta["prefill_len"]), pruned=True)
        state.snapshot()
        return state

    # -------------------------------------------------------------- generate
    def _decode_loop(self, max_steps: int, capacity: int, impl: str):
        # eos_ids is baked into the traced fn, so it must be part of the key:
        # benches toggle engine.eos_ids=(-1,) to disable early stop, and a
        # stale cached fn would silently keep the old eos semantics
        key = (max_steps, capacity, impl, tuple(self.eos_ids))
        if key in self._decode_fns:
            return self._decode_fns[key]

        cfg = self.config
        eos = jnp.asarray(self.eos_ids, jnp.int32)

        # the flat context arrays are FROZEN during decode — keep them OUT of
        # the while_loop carry (an invariant multi-GB carry risks a
        # per-iteration copy; only the tail/counters actually change)
        _MUT = ("k_tail", "v_tail", "tail_len", "seen")

        @partial(jax.jit, donate_argnames=("cache",))
        def run(params, cache: KVCache, first_token):
            from kvzip_tpu.cache import FlatInt4KV, FlatKV
            from kvzip_tpu.pool import PoolInt4KV, PoolKV

            tokens0 = jnp.zeros((max_steps + 1,), jnp.int32)
            tokens0 = tokens0.at[0].set(first_token)
            is_flat = isinstance(cache,
                                 (FlatKV, FlatInt4KV, PoolKV, PoolInt4KV))

            if is_flat:
                mut0 = {f: getattr(cache, f) for f in _MUT}

                def as_cache(mut):
                    return dataclasses.replace(cache, **mut)
            else:
                mut0 = cache

                def as_cache(mut):
                    return mut

            def cond(carry):
                i, done, _, _ = carry
                return (~done) & (i < max_steps)

            def body(carry):
                i, done, tokens, mut = carry
                c = as_cache(mut)
                res = Engine._fwd_fn(c)(
                    params, cfg, tokens[i][None], c,
                    collect_logits="last", attn_impl=impl)
                nxt = jnp.argmax(res.logits[-1]).astype(jnp.int32)
                tokens = tokens.at[i + 1].set(nxt)
                done = jnp.any(nxt == eos)
                if is_flat:
                    mut = {f: getattr(res.cache, f) for f in _MUT}
                else:
                    mut = res.cache
                return (i + 1, done, tokens, mut)

            first_done = jnp.any(first_token == eos)
            i, done, tokens, mut = jax.lax.while_loop(
                cond, body, (jnp.int32(0), first_done, tokens0, mut0))
            return tokens, i, done, as_cache(mut)

        self._decode_fns[key] = run
        return run

    def generate(self, query: Union[str, np.ndarray], state: KVState,
                 update_cache: bool = False,
                 max_new_tokens: Optional[int] = None) -> str:
        """Greedy generation against the (compressed) cache.

        Reference `model/wrapper.py:251-284`; default restores the context
        cache afterwards (multi-query reuse), ``update_cache=True`` keeps the
        query+answer KV for multi-turn.
        """
        query_ids = self.encode(query) if isinstance(query, str) else np.asarray(query)
        max_new = max_new_tokens or self.max_new_tokens
        # refold regardless of update_cache: the tail only ever holds
        # COMMITTED rows between generates (read-only queries are restored
        # away), so folding them into the flat/pool context is always sound
        # — and a read-only query after many committed turns must not be
        # blocked by a full tail. tail_len is fetched ONCE and shared (one
        # host sync per generate instead of two)
        from kvzip_tpu.cache import FlatInt4KV as _FI4, FlatKV as _FK
        from kvzip_tpu.pool import PoolInt4KV as _PI4, PoolKV as _PK
        cur = (int(jax.device_get(state.cache.tail_len))
               if isinstance(state.cache, (_FK, _FI4, _PK, _PI4)) else None)
        cache_before = state.cache
        self._maybe_refold(state, len(query_ids) + max_new, cur)
        if state.cache is not cache_before:
            cur = 0  # refold emptied the tail
        self._check_capacity(state, len(query_ids) + max_new, cur)
        state.snapshot()

        logits = self._forward_chunks(query_ids.astype(np.int32), state, "last")
        first = jnp.argmax(logits[-1]).astype(jnp.int32)

        run = self._decode_loop(max_new - 1, state.cache.capacity,
                                self._impl(state))
        tokens, n, done, cache = run(self.params, state.cache, first)
        state.cache = cache

        # ONE host transfer for all three results (3 round trips -> 1)
        n, done, tokens = jax.device_get((n, done, tokens))
        n = int(n)
        done = bool(done)
        tokens = np.asarray(tokens)[:n + 1]
        if done and len(tokens) and tokens[-1] in self.eos_ids:
            tokens = tokens[:-1]

        if not update_cache:
            state.restore_snapshot()
        else:
            state.prefill_ids = np.concatenate(
                [state.prefill_ids, query_ids, tokens]).astype(np.int32)
            state.snapshot()
        return self.decode(tokens)

    # --------------------------------------------------------------- __call__
    def forward_ids(self, input_ids: np.ndarray, state: KVState,
                    update_cache: bool = False,
                    return_logits: bool = False) -> Optional[np.ndarray]:
        """Plain forward pass (reference ``ModelKVzip.__call__``,
        `model/wrapper.py:120-146`): by default the cache is restored after
        the call; ``update_cache=True`` keeps the new KV."""
        if not update_cache:
            state.snapshot()
        logits = self._forward_chunks(
            np.asarray(input_ids, np.int32), state,
            "all" if return_logits else "none")
        if not update_cache:
            state.restore_snapshot()
        if return_logits:
            return np.asarray(jax.device_get(logits))
        return None

    # ------------------------------------------------------------------ prob
    def prob(self, input_ids: np.ndarray, state: KVState) -> np.ndarray:
        """Next-token probabilities for every position (reference ``_prob``,
        `model/wrapper.py:286-306`); restores the cache afterwards."""
        state.snapshot()
        logits = self._forward_chunks(
            np.asarray(input_ids, np.int32), state, "all")
        state.restore_snapshot()
        probs = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
        return np.asarray(jax.device_get(probs))
