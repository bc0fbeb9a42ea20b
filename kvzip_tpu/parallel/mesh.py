"""Device mesh + sharding layout for multi-chip serving.

The reference has no distributed execution (SURVEY.md §2b — its only
multi-GPU mechanism is accelerate ``device_map="auto"`` layer placement,
`model/load.py:60`). Here parallelism is first-class:

- mesh axes ``("data", "model")`` over the cards of one host (four H100s
  reach each other all to all over NVLink, so the mesh follows the
  algorithm alone); ``model`` = tensor parallelism over attention heads
  (Megatron-style), ``data`` = batch/continuous batching.
- KV caches are sharded over the kv-head axis — which composes naturally with
  KVzip's per-head ragged eviction: each shard's lengths/scores/compaction are
  fully shard-local, so *eviction requires no collectives* beyond the global
  threshold (a scalar) computed at prune time.
- XLA GSPMD inserts the actual collectives (psum after o_proj/down_proj when
  activations stay replicated) — nothing hand-written on the compute path.
"""

from __future__ import annotations

import math
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from kvzip_tpu.config import ModelConfig


def make_mesh(n_devices: Optional[int] = None, tp: Optional[int] = None,
              devices=None, replicas: int = 1) -> Mesh:
    """Build a ("data", "model") mesh — or ("replica", "data", "model") when
    ``replicas`` > 1 (independent device groups).

    tp defaults to all devices (pure tensor parallelism); pass tp < n to get
    a data axis for batch parallelism.

    ``replicas`` splits the devices into independent groups (e.g. one per
    host): the replica axis is the mesh's MAJOR (slowest-varying) axis, so
    with the standard device enumeration each replica is a contiguous
    device group. Every param/cache PartitionSpec in this module omits
    "replica", which makes weights and caches fully replicated per replica
    — the link between replicas carries *no tensor traffic on the serving
    hot path* (batches shard over ("replica", "data"); the only
    cross-replica collective is a request-level batch split).
    """
    devices = devices if devices is not None else jax.devices()
    n = n_devices or len(devices)
    devices = np.asarray(devices[:n])
    tp = tp or (n // replicas)
    assert n % replicas == 0, f"{n} devices not divisible by {replicas} replicas"
    per = n // replicas
    assert per % tp == 0, f"{per} devices/replica not divisible by tp={tp}"
    if replicas > 1:
        return Mesh(devices.reshape(replicas, per // tp, tp),
                    ("replica", "data", "model"))
    return Mesh(devices.reshape(per // tp, tp), ("data", "model"))


def param_pspecs(cfg: ModelConfig) -> dict:
    """PartitionSpecs for the parameter pytree (Megatron TP over heads).

    qkv projections column-parallel (heads on "model"), o_proj row-parallel;
    MLP gate/up column-, down row-parallel; embeddings/lm_head sharded over
    vocab. Activations remain replicated — XLA inserts the psum after the
    row-parallel matmuls.
    """
    lp = {
        "wq": P(None, None, "model"),
        "wk": P(None, None, "model"),
        "wv": P(None, None, "model"),
        "wo": P(None, "model", None),
        "w_gate": P(None, None, "model"),
        "w_up": P(None, None, "model"),
        "w_down": P(None, "model", None),
        "ln_attn": P(), "ln_mlp": P(),
        "bq": P(None, "model"), "bk": P(None, "model"), "bv": P(None, "model"),
        "q_norm": P(), "k_norm": P(),
        "ln_post_attn": P(), "ln_post_mlp": P(),
    }
    return {
        "embed": P("model", None),
        "layers": lp,
        "final_norm": P(),
        "lm_head": P("model", None),
    }


def cache_pspecs() -> "P":
    """KV cache spec: kv heads on "model" (k/v/lengths/valid head-sharded)."""
    return {
        "k": P(None, "model", None, None),
        "v": P(None, "model", None, None),
        "lengths": P(None, "model"),
        "seen": P(),
        "valid": P(None, "model", None),
    }


# Field-name -> PartitionSpec for EVERY cache dataclass (dense KVCache,
# Int4KVCache, gemma3 HybridKV): the kv-head axis rides "model" wherever it
# appears; per-layer scalars/rings' position stamps stay replicated.
# Eviction stays fully shard-local (per-head lengths/compaction), matching
# the head-sharded design in the module docstring.
_CACHE_FIELD_SPECS = {
    # dense
    "k": P(None, "model", None, None),
    "v": P(None, "model", None, None),
    # int4 (nibbles transposed (L, H, D/2, C); scales (L, H, C, G))
    "k_q": P(None, "model", None, None),
    "v_q": P(None, "model", None, None),
    "k_s": P(None, "model", None, None),
    "k_z": P(None, "model", None, None),
    "v_s": P(None, "model", None, None),
    "v_z": P(None, "model", None, None),
    # gemma3 hybrid: static stacks + sliding ring buffers
    "k_static": P(None, "model", None, None),
    "v_static": P(None, "model", None, None),
    "k_ring": P(None, "model", None, None),
    "v_ring": P(None, "model", None, None),
    "ring_pos": P(),
    # common metadata
    "lengths": P(None, "model"),
    "valid": P(None, "model", None),
    "seen": P(),
}


def _trim(tree_specs: dict, tree: dict) -> dict:
    """Keep only spec entries present in the actual pytree.

    W8A8 weights are {"q": int8 (..., in, out), "s": (..., out)} dicts under
    a leaf spec — expand the weight's spec onto the quantized form (scales
    follow the output-channel axis, the spec's last dim)."""
    out = {}
    for k, v in tree.items():
        spec = tree_specs.get(k)
        if isinstance(v, dict):
            if isinstance(spec, P) and set(v) == {"q", "s"}:
                out[k] = {"q": spec, "s": P(*spec[:-2], spec[-1])}
            elif set(v) == {"q4", "s", "z"}:
                # W4A8 stays REPLICATED under a mesh: the split packing
                # interleaves output columns j and j+OUT/2 into one byte, so
                # a contiguous "model" split of the packed axis would strand
                # each shard's nibble halves in different shards. w4a8 is a
                # single-chip decode bandwidth/memory optimization; use
                # w8a8 for tensor-parallel serving.
                out[k] = {"q4": P(), "s": P(), "z": P()}
            else:
                out[k] = _trim(spec or {}, v)
        else:
            out[k] = spec if spec is not None else P()
    return out


def param_sharding(cfg: ModelConfig, mesh: Mesh, params: dict) -> dict:
    specs = _trim(param_pspecs(cfg), params)
    return jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                        is_leaf=lambda x: isinstance(x, P))


def cache_sharding(mesh: Mesh) -> dict:
    return {k: NamedSharding(mesh, v) for k, v in cache_pspecs().items()}


def shard_params(cfg: ModelConfig, mesh: Mesh, params: dict) -> dict:
    """device_put parameters with TP shardings (validates divisibility)."""
    tp = mesh.shape["model"]
    assert cfg.num_kv_heads % tp == 0 or tp % cfg.num_kv_heads == 0, (
        f"model axis {tp} incompatible with {cfg.num_kv_heads} kv heads")
    shardings = param_sharding(cfg, mesh, params)
    return jax.tree.map(jax.device_put, params, shardings)


def shard_cache(mesh: Mesh, cache):
    """device_put any cache dataclass (dense / int4 / hybrid) with the
    head-on-"model" layout from ``_CACHE_FIELD_SPECS``."""
    import dataclasses

    updates = {}
    for f in dataclasses.fields(cache):
        spec = _CACHE_FIELD_SPECS.get(f.name)
        if spec is None:
            continue
        updates[f.name] = jax.device_put(
            getattr(cache, f.name), NamedSharding(mesh, spec))
    return dataclasses.replace(cache, **updates)


def batch_axes(mesh: Mesh) -> tuple:
    """Mesh axes a batch dimension shards over: ("replica", "data") on a
    replicated mesh (DP across replicas AND across each replica's data
    axis), plain ("data",) otherwise."""
    return (("replica", "data") if "replica" in mesh.axis_names
            else ("data",))


def shard_batched_cache(mesh: Mesh, cache):
    """device_put a batch-stacked cache (leading batch axis on every array,
    as built by ``serving.stack_caches``): batch rides ("replica","data"),
    kv heads stay on "model" per ``_CACHE_FIELD_SPECS``.

    Flat compacted caches (FlatKV/FlatInt4KV) have no head axis to shard —
    their per-field fallback is batch-axis-only, which is the right layout
    for the batched flat-decode kernel (each sequence's rows stay local to
    its data shard)."""
    import dataclasses

    baxes = batch_axes(mesh)
    updates = {}
    for f in dataclasses.fields(cache):
        v = getattr(cache, f.name)
        if not hasattr(v, "ndim"):
            continue
        inner = _CACHE_FIELD_SPECS.get(f.name)
        if inner is not None and len(inner) == v.ndim - 1:
            spec = P(baxes, *inner)
        elif v.ndim >= 1:
            spec = P(baxes)
        else:
            spec = P()
        updates[f.name] = jax.device_put(v, NamedSharding(mesh, spec))
    return dataclasses.replace(cache, **updates)
