"""Parameter pytrees: random init + HF safetensors conversion.

Layout: a dict with stacked per-layer arrays (leading ``L`` dim) so the whole
decoder runs as one ``lax.scan`` over layers — compiled once, not per layer.
Linear weights are stored as (in, out) so forward is ``x @ w`` (no
transposes).
"""

from __future__ import annotations

import glob
import json
import os
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from kvzip_tpu.config import ModelConfig

Params = Dict[str, Any]


def init_params(cfg: ModelConfig, key: jax.Array, dtype=jnp.bfloat16) -> Params:
    """Random small-scale init (tests/benchmarks; real use loads safetensors)."""
    D, H, Hkv, Dh = cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    L, I, V = cfg.num_layers, cfg.intermediate_size, cfg.vocab_size
    ks = jax.random.split(key, 8)

    def nrm(k, shape, scale=0.02):
        return (jax.random.normal(k, shape, jnp.float32) * scale).astype(dtype)

    params: Params = {
        "embed": nrm(ks[0], (V, D)),
        "layers": {
            "wq": nrm(ks[1], (L, D, H * Dh)),
            "wk": nrm(ks[2], (L, D, Hkv * Dh)),
            "wv": nrm(ks[3], (L, D, Hkv * Dh)),
            "wo": nrm(ks[4], (L, H * Dh, D)),
            "w_gate": nrm(ks[5], (L, D, I)),
            "w_up": nrm(ks[6], (L, D, I)),
            "w_down": nrm(ks[7], (L, I, D)),
            "ln_attn": jnp.ones((L, D), dtype),
            "ln_mlp": jnp.ones((L, D), dtype),
        },
        "final_norm": jnp.ones((D,), dtype),
    }
    lp = params["layers"]
    if cfg.attention_bias:
        lp["bq"] = jnp.zeros((L, H * Dh), dtype)
        lp["bk"] = jnp.zeros((L, Hkv * Dh), dtype)
        lp["bv"] = jnp.zeros((L, Hkv * Dh), dtype)
    if cfg.qk_norm:
        lp["q_norm"] = jnp.ones((L, Dh), dtype)
        lp["k_norm"] = jnp.ones((L, Dh), dtype)
    if cfg.post_norms:
        lp["ln_post_attn"] = jnp.ones((L, D), dtype)
        lp["ln_post_mlp"] = jnp.ones((L, D), dtype)
    if not cfg.tie_word_embeddings:
        params["lm_head"] = nrm(jax.random.fold_in(key, 99), (V, D))
    return params


# HF tensor-name -> (slot, needs_transpose) mapping for one layer
_LAYER_MAP = {
    "self_attn.q_proj.weight": ("wq", True),
    "self_attn.k_proj.weight": ("wk", True),
    "self_attn.v_proj.weight": ("wv", True),
    "self_attn.o_proj.weight": ("wo", True),
    "self_attn.q_proj.bias": ("bq", False),
    "self_attn.k_proj.bias": ("bk", False),
    "self_attn.v_proj.bias": ("bv", False),
    "self_attn.q_norm.weight": ("q_norm", False),
    "self_attn.k_norm.weight": ("k_norm", False),
    "mlp.gate_proj.weight": ("w_gate", True),
    "mlp.up_proj.weight": ("w_up", True),
    "mlp.down_proj.weight": ("w_down", True),
    "input_layernorm.weight": ("ln_attn", False),
    "post_attention_layernorm.weight": ("ln_mlp", False),
    # gemma3 extra norms: HF's post_attention_layernorm is applied to the attn
    # output (our ln_post_attn) and pre/post_feedforward to the MLP
    "pre_feedforward_layernorm.weight": ("ln_mlp_pre", False),
    "post_feedforward_layernorm.weight": ("ln_post_mlp", False),
}


def _read_raw(ckpt_dir: str) -> Dict[str, np.ndarray]:
    """Read every model tensor from a safetensors checkpoint directory."""
    from safetensors import safe_open

    files = sorted(glob.glob(os.path.join(ckpt_dir, "*.safetensors")))
    if not files:
        raise FileNotFoundError(f"no safetensors under {ckpt_dir}")

    raw: Dict[str, np.ndarray] = {}
    wanted_prefixes = ("model.", "lm_head.", "language_model.")
    for path in files:
        with safe_open(path, framework="np") as f:
            for name in f.keys():
                if name.startswith(wanted_prefixes):
                    raw[name.replace("language_model.", "")] = f.get_tensor(name)
    return raw


def _get_tensor(raw: Dict[str, np.ndarray], name: str):
    t = raw[name]
    if t.dtype == np.uint16:  # bfloat16 stored raw
        t = t.view(np.uint16)
        t = jnp.asarray(t).view(jnp.bfloat16)
    return jnp.asarray(t)


def _host_tensor(raw: Dict[str, np.ndarray], name: str) -> np.ndarray:
    """Tensor as a HOST numpy array (bf16 via ml_dtypes view, zero copy) —
    the streaming loader keeps weights on host until their chunk is
    quantized, so a 7B bf16 checkpoint never fully materializes on device."""
    t = raw[name]
    if t.dtype == np.uint16:
        import ml_dtypes
        t = t.view(ml_dtypes.bfloat16)
    return t


def checkpoint_is_w8a8(ckpt_dir: str) -> bool:
    """True when the safetensors checkpoint stores pre-quantized int8
    projection weights (QServe ``*-w8a8kv4-per-channel`` layout)."""
    from safetensors import safe_open

    files = sorted(glob.glob(os.path.join(ckpt_dir, "*.safetensors")))
    for path in files:
        with safe_open(path, framework="np") as f:
            for name in f.keys():
                if name.endswith("_proj.weight"):
                    return f.get_slice(name).get_dtype() in ("I8", "int8")
    return False


# the seven big projection stacks (everything else is norms/biases)
_BIG_SLOTS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def load_hf_params(cfg: ModelConfig, ckpt_dir: str, dtype=jnp.bfloat16,
                   weight_quant: str = "none",
                   chunk_layers: int = 4) -> Params:
    """Convert a HuggingFace safetensors checkpoint directory to our pytree.

    Supports the reference model zoo families (llama/qwen2/qwen3/gemma3 text).

    ``weight_quant`` in ("w8a8", "w4a8") STREAM-quantizes the projection
    stacks: weights stay on host until their ``chunk_layers``-layer chunk is
    pushed and quantized, so a 7B bf16 checkpoint converts with a device
    peak of roughly the final quantized size + one chunk's f32 temps —
    materializing the full bf16 stacks first (~15 GB at 7B) would double
    the device peak (the QServe reference sidesteps this by shipping
    pre-quantized exports, `model/quant_model/w8a8kv4_llama.py:627-748`).
    """
    raw = _read_raw(ckpt_dir)

    def get(name):
        return _get_tensor(raw, name)

    L = cfg.num_layers
    layer_stacks: Dict[str, list] = {}
    for l in range(L):
        prefix = f"model.layers.{l}."
        for hf_suffix, (slot, transpose) in _LAYER_MAP.items():
            name = prefix + hf_suffix
            if name not in raw:
                continue
            if weight_quant != "none" and slot in _BIG_SLOTS:
                t = _host_tensor(raw, name)          # stays on host
                layer_stacks.setdefault(slot, []).append(t.T if transpose
                                                         else t)
                continue
            t = get(name)
            if transpose:
                t = t.T
            layer_stacks.setdefault(slot, []).append(t)

    if weight_quant == "none":
        quant_fn = None
    elif weight_quant == "w8a8":
        from kvzip_tpu.ops.quant import quantize_weight_int8
        quant_fn = quantize_weight_int8
    elif weight_quant == "w4a8":
        from kvzip_tpu.ops.w4a8 import quantize_weight_int4
        quant_fn = quantize_weight_int4
    else:
        raise ValueError(weight_quant)

    layers: Dict[str, Any] = {}
    for k, v in layer_stacks.items():
        if quant_fn is not None and k in _BIG_SLOTS:
            layers[k] = _stream_quantize_stack(v, quant_fn, dtype,
                                               chunk_layers)
        else:
            layers[k] = jnp.stack(v).astype(dtype)
    # gemma3 naming: HF post_attention_layernorm is our ln_post_attn; HF
    # pre_feedforward_layernorm is the pre-MLP norm (our ln_mlp)
    if cfg.post_norms and "ln_mlp_pre" in layers:
        layers["ln_post_attn"] = layers.pop("ln_mlp")
        layers["ln_mlp"] = layers.pop("ln_mlp_pre")

    params: Params = {
        "embed": get("model.embed_tokens.weight").astype(dtype),
        "layers": layers,
        "final_norm": get("model.norm.weight").astype(dtype),
    }
    # some checkpoints (gemma3, small qwen3) omit lm_head when tied
    if not cfg.tie_word_embeddings and "lm_head.weight" in raw:
        params["lm_head"] = get("lm_head.weight").astype(dtype)
    return params


def _stream_quantize_stack(host_parts: list, quant_fn, dtype,
                           chunk_layers: int = 4):
    """Stack per-layer HOST arrays and quantize in ``chunk_layers`` chunks:
    device peak = quantized output + one chunk's bf16 input + f32 temps."""
    parts = []
    qj = jax.jit(lambda w: quant_fn(w.astype(dtype)))
    for l0 in range(0, len(host_parts), chunk_layers):
        chunk = np.stack([np.ascontiguousarray(t)
                          for t in host_parts[l0:l0 + chunk_layers]])
        part = qj(jnp.asarray(chunk))
        jax.block_until_ready(jax.tree.leaves(part)[0])
        parts.append(part)
    return (parts[0] if len(parts) == 1 else
            jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=0), *parts))


def quantize_layer_stacks(layers: dict, quant_fn, chunk_layers: int = 4
                          ) -> dict:
    """Chunked conversion of already-materialized bf16 layer stacks: each
    jit call quantizes ``chunk_layers`` layers, so the f32 temporaries never
    exceed one chunk (the unchunked form broadcast a 7.08 GB f32 temp per
    stack at 7B)."""
    out = dict(layers)
    for name in _BIG_SLOTS:
        w = layers.get(name)
        if w is None or isinstance(w, dict):
            continue
        L = w.shape[0]
        parts = []
        qj = jax.jit(quant_fn)
        for l0 in range(0, L, chunk_layers):
            part = qj(w[l0:l0 + chunk_layers])
            jax.block_until_ready(jax.tree.leaves(part)[0])
            parts.append(part)
        out[name] = (parts[0] if len(parts) == 1 else
                     jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=0),
                                  *parts))
    return out


# per-linear scale-tensor suffix aliases seen across QServe-style exports
_W8A8_SCALE_SUFFIXES = ("dequant_scale", "weight_scale", "s1_scale", "scales")

# HF proj name -> our stacked slot (weights land as {"q": int8, "s": f32})
_W8A8_LAYER_MAP = {
    "self_attn.q_proj": "wq",
    "self_attn.k_proj": "wk",
    "self_attn.v_proj": "wv",
    "self_attn.o_proj": "wo",
    "mlp.gate_proj": "w_gate",
    "mlp.up_proj": "w_up",
    "mlp.down_proj": "w_down",
}

# non-quantized tensors (kept fp16/bf16 by QServe — `w8a8kv4_llama.py`)
_W8A8_FLOAT_MAP = {
    "input_layernorm.weight": "ln_attn",
    "post_attention_layernorm.weight": "ln_mlp",
    "self_attn.q_proj.bias": "bq",
    "self_attn.k_proj.bias": "bk",
    "self_attn.v_proj.bias": "bv",
}


def load_hf_params_w8a8(cfg: ModelConfig, ckpt_dir: str,
                        dtype=jnp.bfloat16) -> Params:
    """Load a QServe-style pre-quantized W8A8 checkpoint.

    Serves real ``*-w8a8kv4-per-channel`` exports (reference loads these via
    `model/quant_model/w8a8kv4_llama.py:627-748`): per-linear ``.weight``
    int8 ``(out, in)`` plus a per-output-channel dequant scale tensor
    (suffix ``dequant_scale``/``weight_scale``/``s1_scale``/``scales``),
    fp16/bf16 embeddings, norms and lm_head. Converted to our stacked
    ``{"q": (L, in, out) int8, "s": (L, out) f32}`` layout. Unlike the
    reference we do not need qkv/gate_up fusion at load time — the forward's
    ``_lin`` dispatch consumes the per-projection stacks directly.
    """
    raw = _read_raw(ckpt_dir)
    L = cfg.num_layers

    def find_scale(prefix: str):
        for suf in _W8A8_SCALE_SUFFIXES:
            name = f"{prefix}.{suf}"
            if name in raw:
                return _get_tensor(raw, name)
        raise KeyError(
            f"no dequant scale for {prefix} (tried {_W8A8_SCALE_SUFFIXES})")

    layer_stacks: Dict[str, list] = {}
    for l in range(L):
        prefix = f"model.layers.{l}."
        for hf_name, slot in _W8A8_LAYER_MAP.items():
            wname = f"{prefix}{hf_name}.weight"
            if wname not in raw:
                raise KeyError(f"missing {wname}")
            w = _get_tensor(raw, wname)
            assert w.dtype == jnp.int8, f"{wname}: expected int8, got {w.dtype}"
            s = find_scale(prefix + hf_name).reshape(-1)
            # HF stores (out, in); our matmul layout is (in, out)
            assert s.shape[0] == w.shape[0], \
                f"{wname}: scale len {s.shape[0]} != out dim {w.shape[0]}"
            layer_stacks.setdefault(slot + ".q", []).append(w.T)
            layer_stacks.setdefault(slot + ".s", []).append(
                s.astype(jnp.float32))
        for hf_name, slot in _W8A8_FLOAT_MAP.items():
            name = prefix + hf_name
            if name in raw:
                layer_stacks.setdefault(slot, []).append(
                    _get_tensor(raw, name))

    layers: Dict[str, Any] = {}
    for key, stack in layer_stacks.items():
        arr = jnp.stack(stack)
        if key.endswith(".q"):
            layers.setdefault(key[:-2], {})["q"] = arr
        elif key.endswith(".s"):
            layers.setdefault(key[:-2], {})["s"] = arr
        else:
            layers[key] = arr.astype(dtype)

    params: Params = {
        "embed": _get_tensor(raw, "model.embed_tokens.weight").astype(dtype),
        "layers": layers,
        "final_norm": _get_tensor(raw, "model.norm.weight").astype(dtype),
    }
    if not cfg.tie_word_embeddings and "lm_head.weight" in raw:
        params["lm_head"] = _get_tensor(raw, "lm_head.weight").astype(dtype)
    return params


def init_params_w8a8(cfg: ModelConfig, key: jax.Array,
                     dtype=jnp.bfloat16) -> Params:
    """Random-init directly in W8A8 form, one weight stack at a time — a 7B
    bf16-init-then-quantize would transiently need ~21 GB; stack-wise the
    peak overhead is a single bf16 stack."""
    from kvzip_tpu.ops.quant import quantize_weight_int8
    return _init_params_quantized(cfg, key, dtype, quantize_weight_int8)


def init_params_w4a8(cfg: ModelConfig, key: jax.Array,
                     dtype=jnp.bfloat16) -> Params:
    """Random-init directly in W4A8 form (int4 per-group weights)."""
    from kvzip_tpu.ops.w4a8 import quantize_weight_int4
    return _init_params_quantized(cfg, key, dtype, quantize_weight_int4)


def _init_params_quantized(cfg: ModelConfig, key: jax.Array, dtype,
                           quant_fn) -> Params:
    D, H, Hkv, Dh = (cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads,
                     cfg.head_dim)
    L, I, V = cfg.num_layers, cfg.intermediate_size, cfg.vocab_size

    shapes = {
        "wq": (L, D, H * Dh), "wk": (L, D, Hkv * Dh), "wv": (L, D, Hkv * Dh),
        "wo": (L, H * Dh, D), "w_gate": (L, D, I), "w_up": (L, D, I),
        "w_down": (L, I, D),
    }
    lp = {}
    # chunk the random init along layers: a whole (L, D, I) f32 stack is
    # 7.6 GB at 7B — materializing it before quantization doubles the peak
    # once other stacks are resident. Each chunk's f32/bf16 temps die (block_until_ready) before the next starts.
    CH = 4
    for i, name in enumerate(shapes):
        s = shapes[name]
        parts = []
        for j0 in range(0, L, CH):
            n = min(CH, L - j0)
            part = jax.jit(
                lambda k, sub=(n,) + s[1:]: quant_fn(
                    (jax.random.normal(k, sub, jnp.float32) * 0.02)
                    .astype(dtype))
            )(jax.random.fold_in(key, i * 1009 + j0))
            jax.block_until_ready(jax.tree.leaves(part)[0])
            parts.append(part)
        lp[name] = (parts[0] if len(parts) == 1 else jax.tree.map(
            lambda *xs: jnp.concatenate(xs, axis=0), *parts))
        jax.block_until_ready(jax.tree.leaves(lp[name])[0])
    lp["ln_attn"] = jnp.ones((L, D), dtype)
    lp["ln_mlp"] = jnp.ones((L, D), dtype)
    if cfg.attention_bias:
        lp["bq"] = jnp.zeros((L, H * Dh), dtype)
        lp["bk"] = jnp.zeros((L, Hkv * Dh), dtype)
        lp["bv"] = jnp.zeros((L, Hkv * Dh), dtype)
    if cfg.qk_norm:
        lp["q_norm"] = jnp.ones((L, Dh), dtype)
        lp["k_norm"] = jnp.ones((L, Dh), dtype)
    if cfg.post_norms:
        lp["ln_post_attn"] = jnp.ones((L, D), dtype)
        lp["ln_post_mlp"] = jnp.ones((L, D), dtype)

    params: Params = {
        "embed": (jax.random.normal(jax.random.fold_in(key, 98), (V, D),
                                    jnp.float32) * 0.02).astype(dtype),
        "layers": lp,
        "final_norm": jnp.ones((D,), dtype),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = (jax.random.normal(
            jax.random.fold_in(key, 99), (V, D), jnp.float32) * 0.02
        ).astype(dtype)
    return params


def param_bytes(params: Params) -> int:
    return sum(x.size * x.dtype.itemsize for x in jax.tree.leaves(params))


def prepare_params(cfg: ModelConfig, model_name: str, *, dtype,
                   weight_quant: str = "none", embed_quant: str = "none",
                   seed: int = 0, params: Optional[Params] = None):
    """Loader policy: resolve (checkpoint dir | random init | passed-in
    params) x (none | w8a8 | w4a8) x embed quant into a ready param pytree.

    Returns ``(params, effective_weight_quant)`` — the effective value can
    differ from the request when a checkpoint is itself pre-quantized (a
    QServe W8A8 export forces "w8a8"). Centralizing this here keeps
    ``Engine.__init__`` free of loader special cases.

    Memory discipline: every conversion path is chunked — stream-quantize
    for checkpoints, layer-chunked init for random weights, layer-chunked
    requantization for passed-in bf16 stacks — so no step materializes a
    full-model f32/bf16 temporary.
    """
    if params is None:
        is_ckpt = os.path.isdir(model_name) and glob.glob(
            os.path.join(model_name, "*.safetensors"))
        if is_ckpt:
            if checkpoint_is_w8a8(model_name):
                # QServe-style pre-quantized export (reference
                # `model/quant_model/w8a8kv4_llama.py:627-748`)
                params = load_hf_params_w8a8(cfg, model_name, dtype)
                weight_quant = "w8a8"
            else:
                params = load_hf_params(cfg, model_name, dtype,
                                        weight_quant=weight_quant)
        elif weight_quant == "w8a8":
            params = init_params_w8a8(cfg, jax.random.PRNGKey(seed), dtype)
        elif weight_quant == "w4a8":
            params = init_params_w4a8(cfg, jax.random.PRNGKey(seed), dtype)
        else:
            params = init_params(cfg, jax.random.PRNGKey(seed), dtype)

    # passed-in (or loaded-as-float) stacks that still need quantizing
    lp = params["layers"]
    if weight_quant == "w8a8" and not isinstance(lp.get("wq"), dict):
        from kvzip_tpu.ops.quant import quantize_weight_int8
        params = dict(params)
        params["layers"] = quantize_layer_stacks(lp, quantize_weight_int8)
    if weight_quant == "w4a8":
        from kvzip_tpu.ops.w4a8 import fuse_w4a8_params, quantize_weight_int4
        params = dict(params)
        lp = dict(params["layers"])
        if not isinstance(lp.get("wq"), dict) and "wqkv" not in lp:
            # int4 per-group weights (beyond reference: QServe geometry) —
            # halves the decode-dominant weight read vs W8A8
            lp = quantize_layer_stacks(lp, quantize_weight_int4)
        # fused qkv / gate-up stacks: one GEMM each with one shared
        # activation quant (no-op if already fused)
        lp = fuse_w4a8_params(lp)
        # v2 storage: byte rows trimmed to the true input dim (v1 group
        # padding was 12% of the 7B decode weight read), scales split by
        # nibble half + pre-folded
        from kvzip_tpu.ops.w4a8_v2 import repack_w4a8_layers
        D, I = cfg.hidden_size, cfg.intermediate_size
        att = cfg.num_heads * cfg.head_dim
        params["layers"] = repack_w4a8_layers(
            lp, {"wqkv": D, "wq": D, "wk": D, "wv": D, "wo": att,
                 "w_gateup": D, "w_gate": D, "w_up": D, "w_down": I})

    if embed_quant == "int4h":
        # int8 embed + INT4 lm_head (group-128 asymmetric, W4A8-v2 storage).
        # Accuracy unvalidated without real checkpoints — opt-in only.
        from kvzip_tpu.ops.quant import quantize_embed_int8, quantize_head_int4
        params = dict(params)
        if "lm_head" not in params:
            raise ValueError(
                "embed_quant='int4h' needs an untied lm_head (int4 input "
                "embeddings would degrade token representations); use "
                "'int8' for tied-embedding models")
        if not isinstance(params["lm_head"], dict):
            params["lm_head"] = quantize_head_int4(params["lm_head"], dtype)
        if not isinstance(params["embed"], dict):
            params["embed"] = quantize_embed_int8(params["embed"], dtype)
    elif embed_quant == "int8" and not isinstance(params["embed"], dict):
        # halves the ~1.1 GB bf16 embed/lm_head tables of a 7B model
        # (QServe keeps them fp16, so this is opt-in)
        from kvzip_tpu.ops.quant import quantize_embed_int8
        params = dict(params)
        params["embed"] = quantize_embed_int8(params["embed"], dtype)
        if "lm_head" in params:
            params["lm_head"] = quantize_embed_int8(params["lm_head"], dtype)
    return params, weight_quant
