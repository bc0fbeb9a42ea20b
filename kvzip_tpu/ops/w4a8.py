"""W4A8 linear: INT4 weights (per-group-128 asymmetric) with per-token
int8 activations.

Beyond the reference's W8A8 stack (`model/quant_model/w8a8kv4_llama.py` keeps
8-bit weights): 4-bit weights halve the decode-time weight read — the
dominant memory term of a single-stream decode step — at QServe-style
per-group granularity (group of 128 input channels per output channel,
asymmetric scale/zero, the same geometry as QServe's W4A8 checkpoints).

Layout:

- packed ``(INp, OUT//2)`` uint8, split packing along OUT: byte column j
  holds weight column j in the HIGH nibble and column j + OUT/2 in the LOW
  nibble, stored XOR 0x80. INp pads the input dim to a multiple of
  ``MAX_GPB`` groups (pad groups carry scale = zero = 0 and contribute
  nothing).
- scale/zero ``(Gp, OUT)`` per (input-group, output-channel), bf16.

Compute is plain XLA: the weight is dequantised and multiplied
(`ops.dispatch.w4a8_stacked` picks the form per platform).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

GROUP = 128
MAX_GPB = 16          # group padding multiple of the v1 storage


def _pad_groups(n_groups: int) -> int:
    gpb = min(MAX_GPB, n_groups)
    return -(-n_groups // gpb) * gpb, gpb


def quantize_weight_int4(w: jax.Array, group: int = GROUP) -> dict:
    """w (..., IN, OUT) -> {"q4": (..., INp, OUT//2) uint8, "s"/"z":
    (..., Gp, OUT) f32} — per-(input-group, output-channel) asymmetric
    uint4, split-packed along OUT, padded to ``MAX_GPB`` groups (pad
    groups have s = z = 0 and contribute nothing)."""
    *lead, IN, OUT = w.shape
    assert IN % group == 0 and OUT % 2 == 0
    G = IN // group
    Gp, _ = _pad_groups(G)
    wf = w.astype(jnp.float32).reshape(*lead, G, group, OUT)
    mn = wf.min(axis=-2)
    mx = wf.max(axis=-2)
    s = (mx - mn) / 15.0 + 1e-8                      # (..., G, OUT)
    z = mn
    # scales/zeros stored bf16, re-rounded BEFORE quantizing q so the
    # stored grid is exactly consistent
    s = s.astype(jnp.bfloat16).astype(jnp.float32)
    z = z.astype(jnp.bfloat16).astype(jnp.float32)
    q = jnp.clip(jnp.round((wf - z[..., None, :]) / s[..., None, :]), 0, 15)
    q = q.astype(jnp.uint8).reshape(*lead, IN, OUT)
    half = OUT // 2
    # bytes stored PRE-BIASED (^ 0x80, i.e. b - 128 as s8); the low
    # nibble is untouched by the bias (bit 7 is in the high nibble)
    packed = ((q[..., :half] << 4) | q[..., half:]) ^ 0x80
    lead_pad = [(0, 0)] * len(lead)
    if Gp != G:
        packed = jnp.pad(packed, lead_pad + [(0, (Gp - G) * group), (0, 0)])
        s = jnp.pad(s, lead_pad + [(0, Gp - G), (0, 0)])
        z = jnp.pad(z, lead_pad + [(0, Gp - G), (0, 0)])
    # stored bf16: the values are exactly on the bf16 grid already
    return {"q4": packed, "s": s.astype(jnp.bfloat16),
            "z": z.astype(jnp.bfloat16)}


def dequantize_weight_int4(wq: dict, dtype=jnp.bfloat16) -> jax.Array:
    """Reference expansion to (..., INp, OUT) — pad rows are zero."""
    packed, s, z = wq["q4"] ^ 0x80, wq["s"], wq["z"]  # un-bias stored bytes
    *lead, INp, half = packed.shape
    hi = (packed >> 4).astype(jnp.float32)
    lo = (packed & 0xF).astype(jnp.float32)
    q = jnp.concatenate([hi, lo], axis=-1)           # (..., INp, OUT)
    Gp = s.shape[-2]
    qg = q.reshape(*lead, Gp, INp // Gp, 2 * half)
    x = qg * s[..., None, :] + z[..., None, :]
    # pad groups expand to q = 8/0 nibbles (stored 0x00 un-biases to 0x80),
    # but s = z = 0 there, so pad rows are exactly zero.
    return x.reshape(*lead, INp, 2 * half).astype(dtype)


def w4a8_dequant_matmul(x: jax.Array, w: dict, layer: jax.Array,
                         bias=None) -> jax.Array:
    """Layer ``layer`` of stacked W4A8 weights: dequantise it to bf16 and
    take one bf16 GEMM with float32 accumulation. Activations still round
    through s8 (A8 semantics); the bf16 weight expansion adds ~0.4%
    rounding on top of the int4 grid — far below the int4 error."""
    from kvzip_tpu.ops.quant import quantize_act_int8

    wl = {k: jax.lax.dynamic_index_in_dim(v, layer, 0, keepdims=False)
          for k, v in w.items()}
    if "s2" in wl:
        from kvzip_tpu.ops.w4a8_v2 import dequantize_weight_int4_v2
        deq = dequantize_weight_int4_v2(wl, jnp.bfloat16)  # (IN, OUT)
    else:
        deq = dequantize_weight_int4(wl, jnp.bfloat16)     # (INp, OUT)
    xq, xs = quantize_act_int8(x)
    INp = deq.shape[0]
    if INp != x.shape[-1]:
        xq = jnp.pad(xq, ((0, 0), (0, INp - x.shape[-1])))
    acc = jax.lax.dot_general(xq.astype(jnp.bfloat16), deq,
                              (((1,), (0,)), ((), ())),
                              preferred_element_type=jnp.float32)
    y = (acc * xs).astype(x.dtype)
    return y if bias is None else y + bias


def w4a8_jnp_stacked(x: jax.Array, w: dict, layer: jax.Array,
                     bias=None) -> jax.Array:
    """Layer ``layer`` of stacked W4A8 weights through the float32
    expansion (:func:`_w4a8_jnp` / `w4a8_v2.w4a8_jnp_v2`)."""
    wl = {k: jax.lax.dynamic_index_in_dim(v, layer, 0, keepdims=False)
          for k, v in w.items()}
    if "s2" in wl:
        from kvzip_tpu.ops.w4a8_v2 import w4a8_jnp_v2
        return w4a8_jnp_v2(x, wl, bias)
    return _w4a8_jnp(x, wl, bias)


def w4a8_linear_stacked(x: jax.Array, w: dict, layer: jax.Array,
                        bias=None) -> jax.Array:
    """Stacked-layer W4A8 linear: w holds (L, ...) stacks (v1 ``{"q4", "s",
    "z"}`` or v2 ``{"q4", "s2", "z2"}`` storage), ``layer`` selects."""
    from kvzip_tpu.ops import dispatch
    return dispatch.w4a8_stacked(dispatch.platform())(x, w, layer, bias)


def w4a8_linear(x: jax.Array, w: dict, bias=None) -> jax.Array:
    """Linear over one layer's {"q4","s","z"} int4 weight dict."""
    return _w4a8_jnp(x, w, bias)


def _unpack_nibbles(packed: jax.Array) -> jax.Array:
    """Stored split-packed bytes -> logical uint4 columns (..., OUT)."""
    b = packed ^ 0x80                                    # undo the s8 pre-bias
    return jnp.concatenate([b >> 4, b & 0xF], axis=-1)


def fuse_w4a8(ws: list) -> dict:
    """Concatenate several int4 weight dicts along OUT into one (exactly:
    per-(group, out-column) scales make column-concat lossless). Repacks at
    the nibble level so the fused byte layout is canonical split packing —
    the fused output is the plain [w0 | w1 | ...] column order."""
    q = jnp.concatenate([_unpack_nibbles(w["q4"]) for w in ws], axis=-1)
    half = q.shape[-1] // 2
    packed = ((q[..., :half] << 4) | q[..., half:]) ^ 0x80
    return {"q4": packed,
            "s": jnp.concatenate([w["s"] for w in ws], axis=-1),
            "z": jnp.concatenate([w["z"] for w in ws], axis=-1)}


def fuse_w4a8_params(layers: dict, chunk_layers: int = 4) -> dict:
    """Fuse wq/wk/wv -> wqkv and w_gate/w_up -> w_gateup in a stacked W4A8
    layer dict (one GEMM and one shared activation quant each).

    Processed in layer chunks: the nibble-unpacked transient of a 7B gate/up
    stack is ~3.8 GB — chunking bounds it to ~chunk_layers/L of that.
    """
    lp = dict(layers)

    def _fused(names):
        parts = []
        L = lp[names[0]]["q4"].shape[0]
        fuse_j = jax.jit(lambda *ws: fuse_w4a8(list(ws)))
        for l0 in range(0, L, chunk_layers):
            sl = slice(l0, min(l0 + chunk_layers, L))
            part = fuse_j(*[
                {k: v[sl] for k, v in lp[n].items()} for n in names])
            jax.block_until_ready(part["q4"])
            parts.append(part)
        return (parts[0] if len(parts) == 1 else
                jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=0), *parts))

    if all(isinstance(lp.get(n), dict) and "q4" in lp[n]
           for n in ("wq", "wk", "wv")):
        lp["wqkv"] = _fused(("wq", "wk", "wv"))
        for n in ("wq", "wk", "wv"):
            del lp[n]
    if all(isinstance(lp.get(n), dict) and "q4" in lp[n]
           for n in ("w_gate", "w_up")):
        lp["w_gateup"] = _fused(("w_gate", "w_up"))
        for n in ("w_gate", "w_up"):
            del lp[n]
    return lp


def _w4a8_jnp(x: jax.Array, w: dict, bias=None) -> jax.Array:
    """Dequantized matmul: per-token s8 activation rounding (A8), float32
    weight expansion."""
    from kvzip_tpu.ops.quant import quantize_act_int8

    xq, xs = quantize_act_int8(x)
    INp = w["q4"].shape[0]
    if INp != x.shape[-1]:
        xq = jnp.pad(xq, ((0, 0), (0, INp - x.shape[-1])))
    deq = dequantize_weight_int4(w, jnp.float32)
    y = ((xq.astype(jnp.float32) * xs) @ deq).astype(x.dtype)
    return y if bias is None else y + bias
