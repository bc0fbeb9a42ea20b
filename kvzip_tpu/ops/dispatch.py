"""Which implementation runs each role, per platform.

Every choice between a hand-written kernel and the plain jnp/lax form is
made here and nowhere else:

- ``gpu`` gets the route measured fastest on the card (`PERF.md`, "Kernel
  decisions"). Kernels run compiled: nothing on this route passes
  ``interpret=True``, which only tests use.
- ``cpu`` gets the plain path, which is also the reference for tests.
- any other platform raises.

Roles with one implementation on every platform (int4 and flat decode,
windowed scoring, reconstruction scores) call `ops.attention` directly.
"""

from __future__ import annotations

import jax

from kvzip_tpu.ops import attention as attn_ops

PLATFORMS = ("gpu", "cpu")


def platform() -> str:
    """The platform JAX computes on, checked against :data:`PLATFORMS`."""
    return _check(jax.default_backend())


def _check(name: str) -> str:
    if name not in PLATFORMS:
        raise NotImplementedError(
            f"no implementations for platform {name!r}; kvzip runs on "
            f"{' and '.join(PLATFORMS)}")
    return name


SEGMENT_ROUTES = ("kernel", "plain")


def segment_route(name: str) -> str:
    """Decode over a bf16 pool: the hand-written kernel on the GPU, the
    plain form elsewhere. An engine may ask for ``"plain"`` explicitly
    (``Engine.attn_impl``) to compare the two end to end."""
    return "kernel" if _check(name) == "gpu" else "plain"


def pool_decode(route: str):
    """The pool decode of a :func:`segment_route`; both take the arguments
    of `ops.attention.pool_decode_reference`."""
    if route == "kernel":
        from kvzip_tpu.ops.pool_decode import pool_decode_attend
        return pool_decode_attend
    if route == "plain":
        return attn_ops.pool_decode_reference
    raise ValueError(f"pool decode route {route!r}; one of {SEGMENT_ROUTES}")


def dense_attend(name: str, *, capacity: int, masked: bool) -> str:
    """Attention over a dense (unevicted) cache: ``"cudnn"`` (cuDNN's fused
    attention for multi-token chunks; decode steps fall to blockwise),
    ``"blockwise"`` (online softmax over key blocks in XLA) or ``"dense"``.
    ``masked``: a retain-mask or sliding window must be honoured, which only
    the jnp forms do."""
    if _check(name) == "gpu":
        return "blockwise" if masked else "cudnn"
    return "dense" if capacity <= 4096 else "blockwise"


def w4a8_stacked(name: str):
    """Linear over one layer of stacked W4A8 weights: on the GPU the layer
    is dequantised to bf16 and XLA runs one GEMM (it can fuse the int4
    convert into the GEMM's operand load); on the CPU the float32
    expansion keeps tests exact."""
    from kvzip_tpu.ops import w4a8
    if _check(name) == "gpu":
        return w4a8.w4a8_dequant_matmul
    return w4a8.w4a8_jnp_stacked
