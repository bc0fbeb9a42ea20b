"""QServe-style pre-quantized W8A8 checkpoint loading.

Fabricates a tiny checkpoint in the on-disk layout the reference consumes via
`model/quant_model/w8a8kv4_llama.py:627-748` (per-linear int8 ``.weight`` in
(out, in) plus a per-output-channel ``dequant_scale``; fp norms/embeds) and
checks: format detection, logits parity vs quantize-on-load of the source
bf16 checkpoint, and Engine auto-dispatch.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from kvzip_tpu.cache import init_cache  # noqa: E402
from kvzip_tpu.config import ModelConfig  # noqa: E402
from kvzip_tpu.models.params import (  # noqa: E402
    checkpoint_is_w8a8, load_hf_params, load_hf_params_w8a8)
from kvzip_tpu.models.transformer import forward  # noqa: E402
from kvzip_tpu.ops.quant import EPS, quantize_params_w8a8  # noqa: E402

_PROJS = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
          "self_attn.o_proj", "mlp.gate_proj", "mlp.up_proj",
          "mlp.down_proj")


def _build_bf16_ckpt(tmp_path):
    import transformers

    # hidden >= 128: the W4A8 per-group quantization needs at least one full
    # 128-wide input group (stream-quantize test below covers w4a8 too)
    config = transformers.Qwen2Config(
        vocab_size=256, hidden_size=128, intermediate_size=256,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=512, torch_dtype="float32",
        rope_theta=10000.0, rms_norm_eps=1e-6, tie_word_embeddings=False)
    torch.manual_seed(0)
    model = transformers.Qwen2ForCausalLM(config)
    model.eval()
    out = tmp_path / "bf16"
    model.save_pretrained(out, safe_serialization=True)
    return str(out)


def _export_qserve(src_dir, dst_dir):
    """Per-channel int8 quantize every projection; QServe-style layout."""
    import os

    from safetensors import safe_open
    from safetensors.numpy import save_file

    src = {}
    with safe_open(os.path.join(src_dir, "model.safetensors"),
                   framework="np") as f:
        for name in f.keys():
            src[name] = f.get_tensor(name)

    out = {}
    for name, t in src.items():
        if any(name.endswith(p + ".weight") for p in _PROJS):
            w = t.astype(np.float32)              # (out, in)
            s = np.abs(w).max(axis=1) / 127.0 + EPS
            q = np.clip(np.round(w / s[:, None]), -127, 127).astype(np.int8)
            out[name] = q
            out[name.replace(".weight", ".dequant_scale")] = \
                s.astype(np.float32)
        else:
            out[name] = t
    os.makedirs(dst_dir, exist_ok=True)
    save_file(out, os.path.join(dst_dir, "model.safetensors"))
    import shutil
    shutil.copy(os.path.join(src_dir, "config.json"),
                os.path.join(dst_dir, "config.json"))


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("qserve")
    bf16 = _build_bf16_ckpt(tmp)
    quant = str(tmp / "w8a8")
    _export_qserve(bf16, quant)
    return bf16, quant


def test_detection(ckpts):
    bf16, quant = ckpts
    assert not checkpoint_is_w8a8(bf16)
    assert checkpoint_is_w8a8(quant)


def test_logits_match_quantize_on_load(ckpts):
    bf16, quant = ckpts
    cfg = ModelConfig.from_json(f"{bf16}/config.json", name="tiny-qwen2")

    ref = quantize_params_w8a8(load_hf_params(cfg, bf16, dtype=jnp.float32))
    got = load_hf_params_w8a8(cfg, quant, dtype=jnp.float32)

    for slot in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        np.testing.assert_array_equal(
            np.asarray(ref["layers"][slot]["q"]),
            np.asarray(got["layers"][slot]["q"]), err_msg=slot)
        np.testing.assert_allclose(
            np.asarray(ref["layers"][slot]["s"]),
            np.asarray(got["layers"][slot]["s"]), rtol=1e-6, err_msg=slot)
    for slot in ("ln_attn", "ln_mlp", "bq", "bk", "bv"):
        np.testing.assert_array_equal(
            np.asarray(ref["layers"][slot]), np.asarray(got["layers"][slot]),
            err_msg=slot)

    ids = jnp.asarray([3, 17, 92, 45, 8, 120], jnp.int32)
    cache = init_cache(cfg, 32, jnp.float32)
    lr = forward(ref, cfg, ids, cache, collect_logits="all").logits
    cache = init_cache(cfg, 32, jnp.float32)
    lg = forward(got, cfg, ids, cache, collect_logits="all").logits
    np.testing.assert_allclose(np.asarray(lr), np.asarray(lg),
                               rtol=1e-5, atol=1e-5)


def test_stream_quantize_matches_unchunked(ckpts):
    """Streaming bf16->quant loader: chunked host->device
    conversion produces EXACTLY the same quantized stacks as materializing
    the full bf16 params first — for both W8A8 and W4A8 forms."""
    bf16, _ = ckpts
    cfg = ModelConfig.from_json(f"{bf16}/config.json", name="tiny-qwen2")

    full = load_hf_params(cfg, bf16, dtype=jnp.bfloat16)

    ref8 = quantize_params_w8a8(full)
    got8 = load_hf_params(cfg, bf16, dtype=jnp.bfloat16, weight_quant="w8a8",
                          chunk_layers=1)
    for slot in ("wq", "wo", "w_down"):
        np.testing.assert_array_equal(
            np.asarray(ref8["layers"][slot]["q"]),
            np.asarray(got8["layers"][slot]["q"]), err_msg=slot)

    from kvzip_tpu.ops.w4a8 import quantize_weight_int4
    got4 = load_hf_params(cfg, bf16, dtype=jnp.bfloat16, weight_quant="w4a8",
                          chunk_layers=1)
    for slot in ("wq", "w_gate"):
        ref4 = quantize_weight_int4(full["layers"][slot])
        np.testing.assert_array_equal(np.asarray(ref4["q4"]),
                                      np.asarray(got4["layers"][slot]["q4"]),
                                      err_msg=slot)


def test_prepare_params_streams_bf16_checkpoint(ckpts):
    """Engine init on a bf16 checkpoint dir + weight_quant goes through the
    streaming loader and ends with fused stacked W4A8 weights."""
    from kvzip_tpu.models.params import prepare_params

    bf16, _ = ckpts
    cfg = ModelConfig.from_json(f"{bf16}/config.json", name="tiny-qwen2")
    p, wq = prepare_params(cfg, bf16, dtype=jnp.bfloat16,
                           weight_quant="w4a8")
    assert wq == "w4a8"
    assert "q4" in p["layers"]["wqkv"] and "q4" in p["layers"]["w_gateup"]
    assert "wq" not in p["layers"]


def test_engine_autodetects_w8a8(ckpts):
    from kvzip_tpu.engine import Engine

    _, quant = ckpts
    cfg = ModelConfig.from_json(f"{quant}/config.json", name="tiny-qwen2")
    eng = Engine(quant, kv_type="retain", config=cfg, max_new_tokens=4,
                 decode_budget=8)
    assert eng.weight_quant == "w8a8"
    assert isinstance(eng.params["layers"]["wq"], dict)
