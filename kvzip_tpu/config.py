"""Model configuration for the kvzip framework.

Mirrors the capability surface of the reference model zoo
(`/root/reference/model/load.py:5-39`): llama3.x, qwen2.5-*-1M, qwen3-*,
gemma3-* families. We own the model code (no HuggingFace modeling classes on
the compute path), so the config captures everything the pure-JAX decoder
needs: GQA geometry, RoPE variant, norm placement, and attention flavor.

The primary config source for real checkpoints is the HF ``config.json``
(parsed by :func:`ModelConfig.from_hf_dict`); the presets below let tests and
benchmarks construct architecture-faithful models offline.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class RopeConfig:
    """Rotary embedding settings; covers default/llama3/yarn/linear variants."""

    theta: float = 10000.0
    # one of: "default", "llama3", "yarn", "linear"
    scaling_type: str = "default"
    scaling_factor: float = 1.0
    # llama3 scaling params
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position_embeddings: int = 8192


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "tiny"
    vocab_size: int = 32000
    hidden_size: int = 2048
    intermediate_size: int = 8192
    num_layers: int = 16
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 64
    rms_norm_eps: float = 1e-5
    rope: RopeConfig = dataclasses.field(default_factory=RopeConfig)
    # local (sliding-window) rope for gemma3 hybrid layers
    rope_local: Optional[RopeConfig] = None
    tie_word_embeddings: bool = False
    attention_bias: bool = False          # qwen2.5 uses qkv bias
    qk_norm: bool = False                 # qwen3 / gemma3 per-head RMSNorm on q,k
    max_position_embeddings: int = 131072

    # --- attention flavor ---
    # scaling applied to q before attention; None -> 1/sqrt(head_dim)
    query_scale: Optional[float] = None
    # gemma3 hybrid attention: sliding window size for local layers
    sliding_window: Optional[int] = None
    # every `sliding_window_pattern`-th layer is global/static (gemma3: 6)
    sliding_window_pattern: Optional[int] = None

    # --- family-specific flags ---
    # "llama" | "qwen2" | "qwen3" | "gemma3"
    family: str = "llama"
    # gemma3: embeddings scaled by sqrt(hidden), pre+post norms around attn/mlp,
    # rmsnorm computes (1+w)*x̂; activation gelu_tanh instead of silu
    gemma_style_norm: bool = False
    post_norms: bool = False
    hidden_act: str = "silu"

    @property
    def num_kv_groups(self) -> int:
        return self.num_heads // self.num_kv_heads

    @property
    def is_hybrid(self) -> bool:
        """Gemma3-style mixed sliding/static attention stack."""
        return self.sliding_window_pattern is not None

    def layer_is_static(self, layer_idx: int) -> bool:
        """Whether layer uses global (static) attention.

        Gemma3 pattern (reference `attention/kvcache.py:390-395`): every
        `pattern`-th layer starting at pattern-1 is static; all layers static
        for non-hybrid models.
        """
        if not self.is_hybrid:
            return True
        p = self.sliding_window_pattern
        return (layer_idx % p) == (p - 1)

    @property
    def static_layer_ids(self) -> Tuple[int, ...]:
        return tuple(l for l in range(self.num_layers) if self.layer_is_static(l))

    @staticmethod
    def from_hf_dict(d: dict, name: str = "") -> "ModelConfig":
        """Build from a HuggingFace ``config.json`` dict (text config)."""
        if "text_config" in d:  # gemma3 multimodal wrapper
            d = {**d, **d["text_config"]}
        model_type = d.get("model_type", "llama")
        family = {
            "llama": "llama",
            "qwen2": "qwen2",
            "qwen3": "qwen3",
            "gemma3": "gemma3",
            "gemma3_text": "gemma3",
        }.get(model_type, "llama")

        rope_scaling = d.get("rope_scaling") or {}
        scaling_type = rope_scaling.get("rope_type", rope_scaling.get("type", "default"))
        rope = RopeConfig(
            theta=float(d.get("rope_theta", 10000.0)),
            scaling_type=scaling_type if scaling_type else "default",
            scaling_factor=float(rope_scaling.get("factor", 1.0)),
            low_freq_factor=float(rope_scaling.get("low_freq_factor", 1.0)),
            high_freq_factor=float(rope_scaling.get("high_freq_factor", 4.0)),
            original_max_position_embeddings=int(
                rope_scaling.get("original_max_position_embeddings", 8192)),
        )
        rope_local = None
        if family == "gemma3":
            rope_local = RopeConfig(theta=float(d.get("rope_local_base_freq", 10000.0)))

        num_heads = int(d["num_attention_heads"])
        hidden = int(d["hidden_size"])
        qps = d.get("query_pre_attn_scalar")
        return ModelConfig(
            name=name or d.get("_name_or_path", model_type),
            vocab_size=int(d["vocab_size"]),
            hidden_size=hidden,
            intermediate_size=int(d["intermediate_size"]),
            num_layers=int(d["num_hidden_layers"]),
            num_heads=num_heads,
            num_kv_heads=int(d.get("num_key_value_heads", num_heads)),
            head_dim=int(d.get("head_dim", hidden // num_heads)),
            rms_norm_eps=float(d.get("rms_norm_eps", 1e-6)),
            rope=rope,
            rope_local=rope_local,
            tie_word_embeddings=bool(
                d.get("tie_word_embeddings", family == "gemma3")),
            attention_bias=bool(d.get("attention_bias", family == "qwen2")),
            qk_norm=family in ("qwen3", "gemma3"),
            max_position_embeddings=int(d.get("max_position_embeddings", 131072)),
            query_scale=(qps ** -0.5) if qps else None,
            sliding_window=d.get("sliding_window") if family == "gemma3" else None,
            sliding_window_pattern=d.get("sliding_window_pattern") if family == "gemma3" else None,
            family=family,
            gemma_style_norm=family == "gemma3",
            post_norms=family == "gemma3",
            hidden_act="gelu_pytorch_tanh" if family == "gemma3" else d.get("hidden_act", "silu"),
        )

    @staticmethod
    def from_json(path: str, name: str = "") -> "ModelConfig":
        with open(path) as f:
            return ModelConfig.from_hf_dict(json.load(f), name=name)


def _llama3_rope(factor: float) -> RopeConfig:
    return RopeConfig(theta=500000.0, scaling_type="llama3", scaling_factor=factor,
                      low_freq_factor=1.0, high_freq_factor=4.0,
                      original_max_position_embeddings=8192)


# Offline presets for the reference model zoo (`model/load.py:5-39`). Values
# follow the public HF config.json files; real checkpoints override these via
# from_hf_dict.
PRESETS = {
    "llama3.2-1b": ModelConfig(
        name="llama3.2-1b", vocab_size=128256, hidden_size=2048, intermediate_size=8192,
        num_layers=16, num_heads=32, num_kv_heads=8, head_dim=64, rms_norm_eps=1e-5,
        rope=_llama3_rope(32.0), tie_word_embeddings=True, family="llama"),
    "llama3.2-3b": ModelConfig(
        name="llama3.2-3b", vocab_size=128256, hidden_size=3072, intermediate_size=8192,
        num_layers=28, num_heads=24, num_kv_heads=8, head_dim=128, rms_norm_eps=1e-5,
        rope=_llama3_rope(32.0), tie_word_embeddings=True, family="llama"),
    "llama3.1-8b": ModelConfig(
        name="llama3.1-8b", vocab_size=128256, hidden_size=4096, intermediate_size=14336,
        num_layers=32, num_heads=32, num_kv_heads=8, head_dim=128, rms_norm_eps=1e-5,
        rope=_llama3_rope(8.0), family="llama"),
    "llama3.0-8b": ModelConfig(
        name="llama3.0-8b", vocab_size=128256, hidden_size=4096, intermediate_size=14336,
        num_layers=32, num_heads=32, num_kv_heads=8, head_dim=128, rms_norm_eps=1e-5,
        rope=RopeConfig(theta=500000.0), family="llama"),
    # DuoAttention baseline model (gradientai Llama-3-8B-Instruct-Gradient-1048k)
    "duo": ModelConfig(
        name="duo", vocab_size=128256, hidden_size=4096, intermediate_size=14336,
        num_layers=32, num_heads=32, num_kv_heads=8, head_dim=128,
        rms_norm_eps=1e-5, rope=RopeConfig(theta=3580165449.0),
        max_position_embeddings=1048576, family="llama"),
    "qwen2.5-7b": ModelConfig(
        name="qwen2.5-7b", vocab_size=152064, hidden_size=3584, intermediate_size=18944,
        num_layers=28, num_heads=28, num_kv_heads=4, head_dim=128, rms_norm_eps=1e-6,
        rope=RopeConfig(theta=10000000.0), attention_bias=True, family="qwen2",
        max_position_embeddings=1010000),
    "qwen2.5-14b": ModelConfig(
        name="qwen2.5-14b", vocab_size=152064, hidden_size=5120, intermediate_size=13824,
        num_layers=48, num_heads=40, num_kv_heads=8, head_dim=128, rms_norm_eps=1e-5,
        rope=RopeConfig(theta=10000000.0), attention_bias=True, family="qwen2",
        max_position_embeddings=1010000),
    "qwen3-0.6b": ModelConfig(
        name="qwen3-0.6b", vocab_size=151936, hidden_size=1024, intermediate_size=3072,
        num_layers=28, num_heads=16, num_kv_heads=8, head_dim=128, rms_norm_eps=1e-6,
        rope=RopeConfig(theta=1000000.0), qk_norm=True, tie_word_embeddings=True,
        family="qwen3"),
    "qwen3-4b": ModelConfig(
        name="qwen3-4b", vocab_size=151936, hidden_size=2560, intermediate_size=9728,
        num_layers=36, num_heads=32, num_kv_heads=8, head_dim=128, rms_norm_eps=1e-6,
        rope=RopeConfig(theta=1000000.0), qk_norm=True, tie_word_embeddings=True,
        family="qwen3"),
    "qwen3-8b": ModelConfig(
        name="qwen3-8b", vocab_size=151936, hidden_size=4096, intermediate_size=12288,
        num_layers=36, num_heads=32, num_kv_heads=8, head_dim=128, rms_norm_eps=1e-6,
        rope=RopeConfig(theta=1000000.0), qk_norm=True, family="qwen3"),
    "qwen3-14b": ModelConfig(
        name="qwen3-14b", vocab_size=151936, hidden_size=5120, intermediate_size=17408,
        num_layers=40, num_heads=40, num_kv_heads=8, head_dim=128, rms_norm_eps=1e-6,
        rope=RopeConfig(theta=1000000.0), qk_norm=True, family="qwen3"),
    "qwen3-32b": ModelConfig(
        name="qwen3-32b", vocab_size=151936, hidden_size=5120, intermediate_size=25600,
        num_layers=64, num_heads=64, num_kv_heads=8, head_dim=128, rms_norm_eps=1e-6,
        rope=RopeConfig(theta=1000000.0), qk_norm=True, family="qwen3"),
    "gemma3-1b": ModelConfig(
        name="gemma3-1b", vocab_size=262144, hidden_size=1152, intermediate_size=6912,
        num_layers=26, num_heads=4, num_kv_heads=1, head_dim=256, rms_norm_eps=1e-6,
        rope=RopeConfig(theta=1000000.0), rope_local=RopeConfig(theta=10000.0),
        qk_norm=True, tie_word_embeddings=True, query_scale=256 ** -0.5,
        sliding_window=512, sliding_window_pattern=6, family="gemma3",
        gemma_style_norm=True, post_norms=True, hidden_act="gelu_pytorch_tanh"),
    "gemma3-4b": ModelConfig(
        name="gemma3-4b", vocab_size=262208, hidden_size=2560, intermediate_size=10240,
        num_layers=34, num_heads=8, num_kv_heads=4, head_dim=256, rms_norm_eps=1e-6,
        rope=RopeConfig(theta=1000000.0, scaling_type="linear", scaling_factor=8.0),
        rope_local=RopeConfig(theta=10000.0),
        qk_norm=True, tie_word_embeddings=True, query_scale=256 ** -0.5,
        sliding_window=1024, sliding_window_pattern=6, family="gemma3",
        gemma_style_norm=True, post_norms=True, hidden_act="gelu_pytorch_tanh"),
    "gemma3-12b": ModelConfig(
        name="gemma3-12b", vocab_size=262208, hidden_size=3840, intermediate_size=15360,
        num_layers=48, num_heads=16, num_kv_heads=8, head_dim=256, rms_norm_eps=1e-6,
        rope=RopeConfig(theta=1000000.0, scaling_type="linear", scaling_factor=8.0),
        rope_local=RopeConfig(theta=10000.0),
        qk_norm=True, tie_word_embeddings=True, query_scale=256 ** -0.5,
        sliding_window=1024, sliding_window_pattern=6, family="gemma3",
        gemma_style_norm=True, post_norms=True, hidden_act="gelu_pytorch_tanh"),
    "gemma3-27b": ModelConfig(
        name="gemma3-27b", vocab_size=262208, hidden_size=5376, intermediate_size=21504,
        num_layers=62, num_heads=32, num_kv_heads=16, head_dim=128, rms_norm_eps=1e-6,
        rope=RopeConfig(theta=1000000.0, scaling_type="linear", scaling_factor=8.0),
        rope_local=RopeConfig(theta=10000.0),
        # gemma3-27b scales queries by 1/sqrt(hidden/heads)=168^-0.5, not head_dim
        qk_norm=True, tie_word_embeddings=True, query_scale=168 ** -0.5,
        sliding_window=1024, sliding_window_pattern=6, family="gemma3",
        gemma_style_norm=True, post_norms=True, hidden_act="gelu_pytorch_tanh"),
}


def tiny_config(family: str = "llama", **kw) -> ModelConfig:
    """A small architecture-faithful config for tests (fast on CPU)."""
    base = dict(
        name=f"tiny-{family}", vocab_size=512, hidden_size=128, intermediate_size=256,
        num_layers=4, num_heads=8, num_kv_heads=4, head_dim=16, rms_norm_eps=1e-6,
        rope=RopeConfig(theta=10000.0), family=family)
    if family == "qwen2":
        base["attention_bias"] = True
    elif family == "qwen3":
        base["qk_norm"] = True
    elif family == "gemma3":
        base.update(qk_norm=True, gemma_style_norm=True, post_norms=True,
                    hidden_act="gelu_pytorch_tanh", sliding_window=16,
                    sliding_window_pattern=2, query_scale=16 ** -0.5,
                    rope_local=RopeConfig(theta=10000.0))
    base.update(kw)
    return ModelConfig(**base)


# Abbreviated-name -> HF model id mapping (parity with reference
# `model/load.py:5-39`); used when resolving checkpoint paths.
def get_model_id(name: str) -> str:
    size = name.split("-")[-1].split("b")[0]
    if name == "llama3.1-8b":
        return "meta-llama/Llama-3.1-8B-Instruct"
    if name == "llama3.0-8b":
        return "meta-llama/Meta-Llama-3-8B-Instruct"
    if name == "duo":
        return "gradientai/Llama-3-8B-Instruct-Gradient-1048k"
    if name == "llama3-8b-4m-w8a8kv4":
        return "mit-han-lab/Llama-3-8B-Instruct-Gradient-4194k-w8a8kv4-per-channel"
    if name.startswith("llama3.2-"):
        return f"meta-llama/Llama-3.2-{size}B-Instruct"
    if name.startswith("qwen2.5-"):
        return f"Qwen/Qwen2.5-{size}B-Instruct-1M"
    if name.startswith("qwen3-"):
        return f"Qwen/Qwen3-{size}B"
    if name.startswith("gemma3-"):
        return f"google/gemma-3-{size}b-it"
    return name


def resolve_config(name: str) -> ModelConfig:
    """Resolve a model name to a config: local checkpoint dir > preset."""
    if os.path.isdir(name) and os.path.exists(os.path.join(name, "config.json")):
        cfg = ModelConfig.from_json(os.path.join(name, "config.json"), name=name)
    elif name in PRESETS:
        cfg = PRESETS[name]
    elif name.startswith("tiny-"):
        return tiny_config(name.split("tiny-")[1])
    else:
        raise ValueError(
            f"Unknown model {name!r}; provide a checkpoint dir with "
            f"config.json, a preset ({sorted(PRESETS)}), or 'tiny-<family>'.")

    # parity: the reference force-enables yarn x4 long-context scaling for
    # every qwen3 load (`model/load.py:49-55`)
    base = os.path.basename(name.rstrip("/")).lower()
    if cfg.family == "qwen3" and ("qwen3" in base) and \
            cfg.rope.scaling_type == "default":
        cfg = dataclasses.replace(
            cfg,
            rope=dataclasses.replace(
                cfg.rope, scaling_type="yarn", scaling_factor=4.0,
                original_max_position_embeddings=32768),
            max_position_embeddings=131072)
    return cfg
