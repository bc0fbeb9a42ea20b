"""W4A8 v2 storage: split-packed int4 bytes trimmed to the true input dim,
scales/zeros split by nibble half and pre-folded.

- bytes ``q4 (L, IN, OUT//2)``: the v1 split packing (`ops/w4a8.py`) with
  the group padding rows trimmed;
- scales/zeros ``s2/z2 (L, 2, Gp8, OUT//2)``: ``[:, 0]`` scales the
  high-nibble columns and ``[:, 1]`` the low ones, with the hi scale
  stored as s/16 and the hi zero as z + 8 s (the nibble shift and the
  stored bytes' +128 bias folded in). Group rows pad to a multiple of 8
  with s = z = 0.

Loaders (`models/params.py`) write this layout; `w4a8_jnp_v2` computes
with it.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from kvzip_tpu.ops.w4a8 import GROUP


def repack_scales_v2(w: dict, in_dim: int = 0) -> dict:
    """{"q4","s","z"} (v1 stacked storage) -> {"q4","s2","z2"} with
    scales/zeros split by nibble half ((L, Gp, OUT) -> (L, 2, Gp8, half))
    and PRE-FOLDED:

    - hi scale stored as s_hi/16 (exact in bf16: exponent shift);
    - hi zero stored as z_hi + 8*s_hi — folds the +128 bias of the stored
      s8 bytes (b' = B - 128, so q·B = m1 + 128*Σq and the whole Σq term
      collapses into the zero-point dot). bf16 re-round adds ≤ 2^-9 |z|,
      far below the int4 grid itself;
    - when ``in_dim`` is given, the BYTE rows are trimmed to exactly
      in_dim (v1 pads groups to MAX_GPB multiples); scales keep
      zero-padding to a multiple of 8 groups (Gp8), whose s = z = 0 rows
      contribute nothing.
    """
    L, Gp, OUT = w["s"].shape
    half = OUT // 2

    def split(a):
        return a.reshape(L, Gp, 2, half).transpose(0, 2, 1, 3)

    s2 = split(w["s"]).astype(jnp.float32)
    z2 = split(w["z"]).astype(jnp.float32)
    s2 = s2.at[:, 0].multiply(1.0 / 16.0)
    z2 = z2.at[:, 0].add(8.0 * s2[:, 0] * 16.0)
    q4 = w["q4"]
    if in_dim:
        assert in_dim % GROUP == 0
        G = in_dim // GROUP
        Gp8 = -(-G // 8) * 8
        q4 = q4[:, :in_dim]
        s2 = s2[:, :, :Gp8]
        z2 = z2[:, :, :Gp8]
        if Gp8 > Gp:  # true groups not a multiple of the old pad
            pad = [(0, 0), (0, 0), (0, Gp8 - Gp), (0, 0)]
            s2 = jnp.pad(s2, pad)
            z2 = jnp.pad(z2, pad)
    return {"q4": q4, "s2": s2.astype(jnp.bfloat16),
            "z2": z2.astype(jnp.bfloat16)}


def repack_w4a8_layers(lp: dict, in_dims: dict) -> dict:
    """Repack every stacked v1 W4A8 dict in a layer-param tree to v2
    storage (see :func:`repack_scales_v2`); ``in_dims`` maps weight name ->
    true input dim (for byte-row trimming). Processes one matrix at a time
    with a sync between (the gate/up trim transient is ~2 GB at 7B)."""
    out = dict(lp)
    for name, w in lp.items():
        if not (isinstance(w, dict) and "q4" in w):
            continue
        out[name] = repack_scales_v2(w, in_dims.get(name, 0))
        jax.block_until_ready(out[name]["q4"])
    return out


def dequantize_weight_int4_v2(w: dict, dtype=jnp.bfloat16) -> jax.Array:
    """Reference expansion of ONE layer's v2 dict slice {"q4": (IN, half),
    "s2"/"z2": (2, Gp8, half)} -> (IN, OUT).

    Un-primes in f32 from the stored (bf16-rounded) values rather than
    from the original quantization grid."""
    packed = w["q4"]
    IN, half = packed.shape
    G = IN // GROUP
    s2 = w["s2"].astype(jnp.float32)[:, :G]      # (2, G, half)
    z2 = w["z2"].astype(jnp.float32)[:, :G]
    s_hi, s_lo = s2[0] * 16.0, s2[1]
    z_hi, z_lo = z2[0] - 8.0 * (s2[0] * 16.0), z2[1]
    b = (packed ^ 0x80).astype(jnp.int32)        # un-bias stored bytes
    hi = (b >> 4).astype(jnp.float32).reshape(G, GROUP, half)
    lo = (b & 0xF).astype(jnp.float32).reshape(G, GROUP, half)
    cols_hi = hi * s_hi[:, None] + z_hi[:, None]
    cols_lo = lo * s_lo[:, None] + z_lo[:, None]
    out = jnp.concatenate([cols_hi, cols_lo], axis=-1)  # (G, GROUP, OUT)
    return out.reshape(IN, 2 * half).astype(dtype)


def w4a8_jnp_v2(x: jax.Array, w: dict, bias=None) -> jax.Array:
    """Linear over a single-layer v2 dict slice: per-token s8 activation
    rounding (A8), float32 weight expansion."""
    from kvzip_tpu.ops.quant import quantize_act_int8

    xq, xs = quantize_act_int8(x)
    deq = dequantize_weight_int4_v2(w, jnp.float32)
    y = ((xq.astype(jnp.float32) * xs) @ deq).astype(x.dtype)
    return y if bias is None else y + bias
