"""Quantization ops: INT4 KV (group-wise asymmetric) + W8A8 linears.

Parity targets:
- INT4 KV semantics of reference `model/quant_model/quantize_int4.cu:73-144`:
  per group of 128 contiguous head-dim elements, ``scale=(max-min)/15+1e-8``,
  ``zero=min``, ``q=clamp(round((x-zero)/scale),0,15)``, two nibbles per byte
  (even element in the high nibble).
- W8A8 semantics of QServe-style `model/quant_model/w8a8kv4_llama.py`:
  per-output-channel int8 weights + dynamic per-token int8 activations, int8
  matmul with int32 accumulation.

Unlike the reference (which dequantizes the whole KV cache to fp16 before
attention, `int4_kv.py:242-267`), attention here dequantizes one key block
(dense caches) or one layer's segment (evicted caches) at a time.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

INT4_GROUP = 128
EPS = 1e-8


def quantize_int4(x: jax.Array, group_size: int = INT4_GROUP,
                  pack: str = "pairs"
                  ) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """x: (..., D) -> packed (..., D//2) uint8, scale/zero (..., D//g).

    pack="pairs": reference byte layout (element 2j in the high nibble,
    2j+1 low — `quantize_int4.cu:123-139`). pack="split": element j high,
    j + D/2 low — nibble unpack becomes a concat instead of an interleave;
    the cache uses this layout.
    """
    *lead, D = x.shape
    g = min(group_size, D)
    xg = x.reshape(*lead, D // g, g).astype(jnp.float32)
    mn = xg.min(axis=-1)
    mx = xg.max(axis=-1)
    scale = (mx - mn) / 15.0 + EPS
    zero = mn
    q = jnp.clip(jnp.round((xg - zero[..., None]) / scale[..., None]), 0, 15)
    q = q.astype(jnp.uint8).reshape(*lead, D)
    if pack == "pairs":
        packed = (q[..., 0::2] << 4) | q[..., 1::2]
    else:
        half = D // 2
        packed = (q[..., :half] << 4) | q[..., half:]
    return packed, scale.astype(x.dtype), zero.astype(x.dtype)


def dequantize_int4(packed: jax.Array, scale: jax.Array, zero: jax.Array,
                    out_dtype=jnp.bfloat16, pack: str = "pairs") -> jax.Array:
    """packed (..., D//2) + scale/zero (..., D//g) -> (..., D)."""
    hi = (packed >> 4).astype(jnp.int32)
    lo = (packed & 0xF).astype(jnp.int32)
    if pack == "pairs":
        q = jnp.stack([hi, lo], axis=-1).reshape(*packed.shape[:-1],
                                                 packed.shape[-1] * 2)
    else:
        q = jnp.concatenate([hi, lo], axis=-1)
    D = q.shape[-1]
    g = D // scale.shape[-1]
    qg = q.reshape(*packed.shape[:-1], D // g, g)
    x = qg.astype(jnp.float32) * scale[..., None].astype(jnp.float32) \
        + zero[..., None].astype(jnp.float32)
    return x.reshape(*packed.shape[:-1], D).astype(out_dtype)


# ------------------------------------------------------------------- W8A8
def quantize_weight_int8(w: jax.Array) -> dict:
    """w (..., in, out) -> {"q": int8, "s": f32 (..., out)} per-channel."""
    wf = w.astype(jnp.float32)
    amax = jnp.max(jnp.abs(wf), axis=-2)
    s = amax / 127.0 + EPS
    q = jnp.clip(jnp.round(wf / s[..., None, :]), -127, 127).astype(jnp.int8)
    return {"q": q, "s": s.astype(jnp.float32)}


def quantize_act_int8(x: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Dynamic per-token symmetric int8 activation quant.

    Factored out of the matmul so one quantization feeds several projections
    (reference fuses this into RMSNorm / SiLU-mul precisely to avoid repeated
    activation passes, `w8a8kv4_llama.py:126-163`): qkv share one, gate/up
    share one.
    """
    xf = x.astype(jnp.float32)
    xs = jnp.max(jnp.abs(xf), axis=-1, keepdims=True) / 127.0 + EPS
    xq = jnp.clip(jnp.round(xf / xs), -127, 127).astype(jnp.int8)
    return xq, xs


def int8_matmul(xq: jax.Array, xs: jax.Array, wq: jax.Array, ws: jax.Array,
                bias=None, out_dtype=jnp.bfloat16) -> jax.Array:
    """int8 x int8 -> int32 matmul with pre-quantized activations."""
    acc = jax.lax.dot_general(xq, wq, (((1,), (0,)), ((), ())),
                              preferred_element_type=jnp.int32)
    out = acc.astype(jnp.float32) * xs * ws[None, :]
    if bias is not None:
        out = out + bias.astype(jnp.float32)
    return out.astype(out_dtype)


def int8_linear(x: jax.Array, wq: jax.Array, ws: jax.Array,
                bias=None) -> jax.Array:
    """Dynamic per-token activation quant + int8 matmul.

    x (T, in) any float dtype; wq (in, out) int8; ws (out,) f32.
    """
    xq, xs = quantize_act_int8(x)
    return int8_matmul(xq, xs, wq, ws, bias, x.dtype)


def quantize_embed_int8(w: jax.Array, model_dtype=jnp.bfloat16) -> dict:
    """Embedding / lm_head table (V, D) -> {"q": int8, "s": (V,)}.

    Per-row (= per vocab entry) scales: exact per-channel semantics for the
    lm_head matmul (logits_v = s_v * (x . q_v)) and a cheap row-rescale for
    embedding lookups. Halves the 2x ~1.1 GB bf16 tables of a 7B model.
    (The QServe reference keeps these fp16; opt-in via
    Engine(embed_quant="int8").)
    """
    wf = w.astype(jnp.float32)
    amax = jnp.max(jnp.abs(wf), axis=-1)
    s = amax / 127.0 + EPS
    q = jnp.clip(jnp.round(wf / s[:, None]), -127, 127).astype(jnp.int8)
    return {"q": q, "s": s.astype(model_dtype)}


def embed_lookup(emb, ids: jax.Array):
    """Row lookup for a plain or int8-quantized embedding table."""
    if isinstance(emb, dict):
        dtype = emb["s"].dtype
        return emb["q"][ids].astype(dtype) * emb["s"][ids][:, None]
    return emb[ids]


def quantize_head_int4(head: jax.Array, model_dtype=jnp.bfloat16) -> dict:
    """lm_head table (V, D) -> W4A8 v2 storage (1-layer stack).

    Per-group-128 asymmetric int4 along D (the same geometry as the W4A8
    projections): the 545 MB int8 head read of a 7B decode step drops to
    ~292 MB. CAUTION: logit noise does
    NOT average out — per-weight int4 rounding is ~10% of a weight sigma,
    and signal and noise both grow as sqrt(D), leaving ~10% relative logit
    noise at any D (tests/test_quant.py measures it). That can flip argmax
    on close decisions, so this stays opt-in (embed_quant="int4h") and OFF
    the official bench config; int8 (~0.6% noise) is the validated-enough
    default."""
    from kvzip_tpu.ops.w4a8 import quantize_weight_int4
    from kvzip_tpu.ops.w4a8_v2 import repack_scales_v2

    D = head.shape[1]
    w = repack_scales_v2(quantize_weight_int4(head.T[None]), in_dim=D)
    w["s2"] = w["s2"].astype(model_dtype)
    w["z2"] = w["z2"].astype(model_dtype)
    return w


def head_logits(head, xf: jax.Array) -> jax.Array:
    """lm_head projection for a plain (V, D) table, an int8 dict, or a
    W4A8-v2 int4 dict (quantize_head_int4)."""
    if isinstance(head, dict) and "q4" in head:
        from kvzip_tpu.ops.w4a8 import w4a8_linear_stacked
        return w4a8_linear_stacked(xf, head, jnp.int32(0))
    if isinstance(head, dict):
        xq, xs = quantize_act_int8(xf)
        acc = jax.lax.dot_general(xq, head["q"], (((1,), (1,)), ((), ())),
                                  preferred_element_type=jnp.int32)
        return (acc.astype(jnp.float32) * xs
                * head["s"].astype(jnp.float32)[None]).astype(xf.dtype)
    return xf @ head.T


def quantize_params_w8a8(params: dict) -> dict:
    """Quantize every projection weight to W8 per-channel (QServe-style).

    Embedding / lm_head / norms / biases stay high-precision (the reference
    keeps them fp16, `w8a8kv4_llama.py`). Stacked (L, in, out) layer weights
    become {"q": int8, "s": (L, out)} dicts handled by the forward's
    ``_lin`` dispatch.
    """
    out = dict(params)
    lp = dict(params["layers"])
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        if name in lp and not isinstance(lp[name], dict):
            lp[name] = quantize_weight_int8(lp[name])
    out["layers"] = lp
    return out
