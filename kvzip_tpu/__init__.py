"""kvzip: a query-agnostic KV-cache compression engine.

Rebuilds the capabilities of snu-mllab/KVzip (NeurIPS'25) — context
reconstruction importance scoring, pair/head-level eviction, ragged
compressed-cache decoding, quantized inference, and the eval harness — as an
idiomatic JAX/XLA/Pallas inference engine for NVIDIA GPUs.
"""

from kvzip_tpu.config import ModelConfig, PRESETS, get_model_id, resolve_config, tiny_config
from kvzip_tpu.engine import Engine, KVState
from kvzip_tpu.prune import load_head_score, prune_mask, save_head_score

__all__ = [
    "Engine", "KVState", "ModelConfig", "PRESETS", "get_model_id",
    "resolve_config", "tiny_config", "prune_mask", "load_head_score",
    "save_head_score",
]

__version__ = "0.1.0"
