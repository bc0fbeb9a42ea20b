"""Thresholding / pruning of KV importance scores.

Parity with reference `attention/score.py:88-120` (``_threshold`` /
``_threshold_uniform``) and the head-level context-independent path
(`model/wrapper.py:40-58`). Scores here are a dense (L, H_kv, ctx_len) array
rather than a per-layer list.
"""

from __future__ import annotations

import glob
import os
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def threshold_global(score: jax.Array, ratio: float,
                     static_layers: Optional[Sequence[int]] = None
                     ) -> Tuple[jax.Array, float]:
    """Single global threshold → non-uniform per-head budgets.

    Reference `_threshold` (score.py:88-102): sort all scores descending,
    threshold at the ratio-quantile, keep score > thres (strict).

    static_layers: for hybrid (gemma3) models, only these layers' scores
    participate (the reference scores only static layers); other layers'
    rows come back all-True.
    """
    if ratio >= 1:
        return jnp.ones_like(score, dtype=jnp.bool_), 0.0

    pool = score[jnp.asarray(static_layers)] if static_layers is not None else score
    flat = pool.reshape(-1).astype(jnp.float32)
    sorted_desc = jnp.sort(flat)[::-1]
    n = max(int(flat.shape[0] * ratio) - 1, 0)
    thres = sorted_desc[n]
    valid = score.astype(jnp.float32) > thres
    if static_layers is not None:
        mask = np.zeros((score.shape[0],), dtype=bool)
        mask[np.asarray(static_layers)] = True
        valid = jnp.where(jnp.asarray(mask)[:, None, None], valid, True)
    return valid, float(jax.device_get(thres))


def threshold_histogram(score: jax.Array, ratio: float,
                        static_layers: Optional[Sequence[int]] = None,
                        bins: int = 4096, iters: int = 4
                        ) -> Tuple[jax.Array, float]:
    """Global threshold via iterative histogram refinement — the
    distributed form of :func:`threshold_global` (SURVEY §7 multi-host
    design).

    ``threshold_global`` sorts the full (L, H, ctx) score array, which
    under head-sharding forces an all-gather + replicated O(n log n) sort.
    Here each refinement round scatter-adds a (bins,) histogram — local
    work + one small all-reduce under GSPMD — then narrows the value range
    around the k-th largest element. Scores originate from bf16 ``amax``
    (a quantized value grid), so ``iters x log2(bins)`` bits of range
    resolution isolates the exact k-th value and the resulting mask is
    IDENTICAL to the sort-based one (verified in tests/test_parallel.py).

    A runtime RANK GUARD verifies that property on every call: the exact
    k-th-order-statistic invariants ``#{x > thres} <= k`` and
    ``#{x >= thres} >= k+1`` are checked on device, and any violation
    (e.g. pathological continuous inputs where float rounding at a bin
    edge misplaces the k-th value) falls back to the sort-based
    :func:`threshold_global` instead of silently returning an
    approximate threshold.
    """
    if ratio >= 1:
        return jnp.ones_like(score, dtype=jnp.bool_), 0.0

    pool = (score[jnp.asarray(static_layers)]
            if static_layers is not None else score).astype(jnp.float32)
    n = pool.size
    k = max(int(n * ratio) - 1, 0)  # descending rank of the threshold value

    def hist_refine(carry, _):
        lo, hi, k = carry
        width = jnp.maximum((hi - lo) / bins, 1e-30)
        idx = jnp.clip(((pool - lo) / width).astype(jnp.int32), 0, bins - 1)
        counts = jnp.zeros((bins,), jnp.int32).at[idx].add(
            ((pool >= lo) & (pool <= hi)).astype(jnp.int32))
        cum = jnp.cumsum(counts[::-1])  # cum[j] = #elements in top j+1 bins
        j = jnp.argmax(cum >= k + 1)
        b = bins - 1 - j
        k = k - (cum[j] - counts[b])
        return (lo + b.astype(jnp.float32) * width,
                lo + (b + 1).astype(jnp.float32) * width, k), None

    lo0 = pool.min()
    hi0 = jnp.nextafter(pool.max(), jnp.inf)
    (lo, hi, _), _ = jax.lax.scan(hist_refine, (lo0, hi0, k), None,
                                  length=iters)
    # exact k-th value: the largest element inside the final bin
    thres = jnp.max(jnp.where((pool >= lo) & (pool < hi), pool, -jnp.inf))
    thres = jnp.where(jnp.isfinite(thres), thres, lo)

    # rank guard: thres must be the exact k-th largest element (ties
    # included). One fused reduction pass; ~free next to the histogram.
    n_gt = jnp.sum(pool > thres)
    n_ge = jnp.sum(pool >= thres)
    thres_v, n_gt_v, n_ge_v = (
        np.asarray(v) for v in jax.device_get((thres, n_gt, n_ge)))
    if not (n_gt_v <= k and n_ge_v >= k + 1):
        import warnings
        warnings.warn(
            f"threshold_histogram rank guard tripped "
            f"(#>thres={int(n_gt_v)}, #>=thres={int(n_ge_v)}, k={k}); "
            "falling back to the sort-based global threshold")
        return threshold_global(score, ratio, static_layers)

    valid = score.astype(jnp.float32) > thres
    if static_layers is not None:
        mask = np.zeros((score.shape[0],), dtype=bool)
        mask[np.asarray(static_layers)] = True
        valid = jnp.where(jnp.asarray(mask)[:, None, None], valid, True)
    return valid, float(thres_v)


def threshold_uniform(score: jax.Array, ratio: float,
                      static_layers: Optional[Sequence[int]] = None
                      ) -> Tuple[jax.Array, float]:
    """Per-head top-k → uniform budgets (reference `_threshold_uniform`)."""
    if ratio >= 1:
        return jnp.ones_like(score, dtype=jnp.bool_), 0.0
    L, H, n_seq = score.shape
    k = int(n_seq * ratio)
    _, idx = jax.lax.top_k(score.astype(jnp.float32), k)  # (L, H, k)
    valid = jnp.zeros((L, H, n_seq), jnp.bool_)
    valid = valid.at[
        jnp.arange(L)[:, None, None], jnp.arange(H)[None, :, None], idx].set(True)
    if static_layers is not None:
        mask = np.zeros((L,), dtype=bool)
        mask[np.asarray(static_layers)] = True
        valid = jnp.where(jnp.asarray(mask)[:, None, None], valid, True)
    return valid, 0.0


def prune_mask(score: jax.Array, ratio: float, level: str = "pair",
               static_layers: Optional[Sequence[int]] = None,
               method: str = "sort"
               ) -> Tuple[jax.Array, float, float]:
    """Compute the keep-mask for a compression ratio.

    Returns (valid (L,H,ctx) bool, threshold, true_ratio). ``level`` follows
    the reference flags (`args.py:11-16`): "pair" (global threshold), "head"
    (same math on head-broadcast scores), "pair-uniform" (per-head top-k).
    method="histogram" computes the global threshold without a replicated
    sort (use when scores are sharded across a mesh).
    """
    if "uniform" in level:
        valid, thres = threshold_uniform(score, ratio, static_layers)
    elif method == "histogram":
        valid, thres = threshold_histogram(score, ratio, static_layers)
    else:
        valid, thres = threshold_global(score, ratio, static_layers)
    # parity: the reference reports the ratio over the scored (static) layers
    # only — its valid tensor never includes sliding layers
    pool = valid[jnp.asarray(static_layers)] if static_layers is not None else valid
    true_ratio = int(jax.device_get(pool.sum())) / pool.size
    return valid, thres, true_ratio


def head_scores_to_pair(head_score: jax.Array, ctx_len: int) -> jax.Array:
    """Broadcast per-(layer, head) scores over the sequence.

    Reference `load_head_score` (model/wrapper.py:40-58): per-head scalar →
    (L, H, ctx_len); pruning then drops whole heads' context KV with zero
    runtime scoring cost (DuoAttention-style).
    """
    return jnp.broadcast_to(head_score[:, :, None], (*head_score.shape, ctx_len))


def load_head_score(model_name: str, ctx_len: int,
                    search_dirs: Sequence[str] = ("./head_score",)) -> jax.Array:
    """Load precomputed head scores (.npy/.npz/.pt), amax-merge across files.

    File layout mirrors the reference assets (`utils/head_score/*.pt`,
    (L, H) per file); we additionally accept numpy formats. The torch loader
    is optional (torch-cpu is available in this image).
    """
    key = model_name
    for prefix, short in (("Qwen2.5-7B", "qwen2.5-7b"),
                          ("Qwen2.5-14B", "qwen2.5-14b"),
                          ("Llama-3.1-8B", "llama3.1-8b")):
        if model_name.startswith(prefix):
            key = short

    def _matches(key):
        out = []
        for d in search_dirs:
            out += sorted(glob.glob(os.path.join(d, f"{key}-*.np[yz]")) +
                          glob.glob(os.path.join(d, f"{key}-*.pt")))
        return out

    paths = _matches(key)
    if not paths:
        # fallback: any asset whose stem is a (case-insensitive) prefix of
        # the model id or vice versa — unknown abbreviations should not
        # silently glob nothing
        cand = []
        for d in search_dirs:
            cand += glob.glob(os.path.join(d, "*.np[yz]"))
            cand += glob.glob(os.path.join(d, "*.pt"))
        low = key.lower()
        for path in sorted(cand):
            stem = os.path.basename(path).rsplit(".", 1)[0].lower()
            prefix = stem.split("-")[0]
            if low.startswith(prefix) or prefix.startswith(low):
                paths.append(path)

    arrays = []
    for path in paths:
        if path.endswith(".pt"):
            import torch
            t = torch.load(path, map_location="cpu", weights_only=True)
            arr = np.asarray(t.to(torch.float32)).squeeze()
        elif path.endswith(".npz"):
            arr = np.load(path)["score"].squeeze()
        else:
            arr = np.load(path).squeeze()
        arrays.append(arr.astype(np.float32))
    if not arrays:
        raise FileNotFoundError(
            f"no head-score files for {key!r} in {list(search_dirs)}")
    merged = jnp.asarray(np.stack(arrays, 0)).max(axis=0)  # (L, H)
    return head_scores_to_pair(merged, ctx_len)


def save_head_score(score: jax.Array, model_name: str, data_name: str, idx: int,
                    out_dir: str = "./head_score") -> str:
    """Persist per-head scores = amax over sequence (reference test.py:22-25)."""
    os.makedirs(out_dir, exist_ok=True)
    head = np.asarray(jax.device_get(score.astype(jnp.float32).max(axis=-1)))
    path = os.path.join(out_dir, f"{model_name}-{data_name}-{idx}.npz")
    np.savez(path, score=head)
    return path
