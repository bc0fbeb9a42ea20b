"""The choice of implementation per platform (`ops/dispatch.py`), the
compile-cache policy, the fused-attention chunk merge, the W4A8 routes,
chip_smoke's refusal of a CPU, and — on a GPU only (``-m gpu``) — the
compiled kernels against their references."""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kvzip_tpu.ops import attention as attn_ops
from kvzip_tpu.ops import dispatch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pallas_calls(jaxpr):
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "pallas_call":
            out.append(eqn.params)
        for v in eqn.params.values():
            sub = getattr(v, "jaxpr", v)
            if hasattr(sub, "eqns"):
                out += _pallas_calls(sub)
    return out


def _pool_args(T=1, Hkv=2, G=2, D=32, P=64, L=2, Tcap=8):
    return (jnp.zeros((T, Hkv * G, D)), jnp.zeros((D, P)), jnp.zeros((P, D)),
            jnp.zeros((1, P), jnp.int32), jnp.asarray([0, 32], jnp.int32),
            jnp.asarray([20, 30], jnp.int32), jnp.zeros((L, Hkv, Tcap, D)),
            jnp.zeros((L, Hkv, Tcap, D)), jnp.int32(0), jnp.int32(1))


@pytest.mark.parametrize("T", [1, 64])
def test_gpu_pool_route_never_interprets(T):
    fn = dispatch.pool_decode(dispatch.segment_route("gpu"))
    jaxpr = jax.make_jaxpr(
        lambda *a: fn(*a, scale=1.0, max_rows=32))(*_pool_args(T=T))
    calls = _pallas_calls(jaxpr.jaxpr)
    assert calls, "the GPU route runs a Pallas kernel"
    for params in calls:
        assert params["interpret"] is False
        assert params["backend"] == "triton"


@pytest.mark.parametrize("role", ["segment_route", "dense_attend",
                                  "w4a8_stacked"])
def test_unknown_platform_raises(role):
    fn = getattr(dispatch, role)
    kw = dict(capacity=1024, masked=False) if role == "dense_attend" else {}
    with pytest.raises(NotImplementedError, match="neuron"):
        fn("neuron", **kw)


def test_platform_checked(monkeypatch):
    monkeypatch.setattr(dispatch.jax, "default_backend", lambda: "rocm")
    with pytest.raises(NotImplementedError, match="rocm"):
        dispatch.platform()


def test_unknown_route_raises():
    with pytest.raises(ValueError, match="flash"):
        dispatch.pool_decode("flash")


@pytest.mark.parametrize("name,capacity,masked,want", [
    ("gpu", 65536, False, "cudnn"),
    ("gpu", 65536, True, "blockwise"),
    ("gpu", 1024, False, "cudnn"),
    ("cpu", 4096, False, "dense"),
    ("cpu", 8192, False, "blockwise"),
    ("cpu", 8192, True, "blockwise"),
])
def test_dense_attend_table(name, capacity, masked, want):
    assert dispatch.dense_attend(name, capacity=capacity,
                                 masked=masked) == want


def test_cpu_routes_are_plain():
    from kvzip_tpu.ops import w4a8
    from kvzip_tpu.ops.pool_decode import pool_decode_attend

    assert dispatch.segment_route("cpu") == "plain"
    assert dispatch.pool_decode("plain") is attn_ops.pool_decode_reference
    assert dispatch.pool_decode("kernel") is pool_decode_attend
    assert dispatch.w4a8_stacked("cpu") is w4a8.w4a8_jnp_stacked
    assert dispatch.w4a8_stacked("gpu") is w4a8.w4a8_dequant_matmul


# ---------------------------------------------------------- compile cache
_CACHE_KEYS = ("jax_compilation_cache_dir",
               "jax_persistent_cache_min_entry_size_bytes",
               "jax_persistent_cache_min_compile_time_secs")


@pytest.fixture
def saved_cache_config():
    before = {k: getattr(jax.config, k) for k in _CACHE_KEYS}
    yield
    for k, v in before.items():
        jax.config.update(k, v)


def test_compile_cache_env_wins(monkeypatch, tmp_path, saved_cache_config):
    from kvzip_tpu.utils.compile_cache import ENV, enable_compile_cache

    monkeypatch.setenv(ENV, str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_in_checkout(monkeypatch, saved_cache_config):
    from kvzip_tpu.utils.compile_cache import (DEFAULT_DIR, ENV,
                                               enable_compile_cache)

    monkeypatch.delenv(ENV, raising=False)
    assert DEFAULT_DIR == os.path.join(REPO, ".jax_cache")
    assert enable_compile_cache() == DEFAULT_DIR
    assert jax.config.jax_compilation_cache_dir == DEFAULT_DIR
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


# ---------------------------------------------------------- fused prefill
def _chunk_case(rng, base, T=8, Hkv=2, G=3, D=16, C=64, dtype=jnp.float32):
    q = jnp.asarray(rng.standard_normal((T, Hkv * G, D)), dtype)
    kc, vc = (jnp.asarray(rng.standard_normal((Hkv, C, D)), dtype)
              for _ in range(2))
    kn, vn = (jnp.asarray(rng.standard_normal((T, Hkv, D)), dtype)
              for _ in range(2))
    bl = jnp.asarray(base, jnp.int32)

    def put(cache, new):
        return jax.vmap(lambda c, n, b: jax.lax.dynamic_update_slice(
            c, n, (b, 0)))(cache, jnp.swapaxes(new, 0, 1), bl)

    return q, put(kc, kn), put(vc, vn), bl, kn, vn


@pytest.mark.parametrize("base", [(0, 0), (5, 5), (9, 4), (40, 0)])
def test_chunk_fused_matches_dense(base):
    """The two-call log-sum-exp merge (XLA's implementation of the same
    jax.nn call) == dense attention over the appended cache, ragged heads
    and an empty prefix included."""
    q, k, v, bl, kn, vn = _chunk_case(np.random.default_rng(0), base)
    want = attn_ops.attend_dense(q, k, v, bl, None, scale=0.25)
    got = attn_ops.attend_chunk_fused(q, k, v, bl, kn, vn, scale=0.25,
                                      implementation="xla")
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------- W4A8 routes
@pytest.mark.parametrize("T", [1, 16])
@pytest.mark.parametrize("storage", ["v1", "v2"])
@pytest.mark.parametrize("route", ["w4a8_jnp_stacked", "w4a8_dequant_matmul"])
def test_w4a8_routes_match_dequantized_matmul(route, storage, T):
    from kvzip_tpu.ops import w4a8
    from kvzip_tpu.ops.quant import quantize_act_int8
    from kvzip_tpu.ops.w4a8_v2 import (dequantize_weight_int4_v2,
                                       repack_scales_v2)

    rng = np.random.default_rng(T)
    L, IN, OUT = 2, 256, 384
    wq = w4a8.quantize_weight_int4(
        jnp.asarray(rng.standard_normal((L, IN, OUT)), jnp.float32))
    if storage == "v2":
        wq = repack_scales_v2(wq, in_dim=IN)
    x = jnp.asarray(rng.standard_normal((T, IN)), jnp.float32)
    xq, xs = quantize_act_int8(x)
    for l in range(L):
        wl = {k: a[l] for k, a in wq.items()}
        deq = (dequantize_weight_int4_v2(wl, jnp.float32) if storage == "v2"
               else w4a8.dequantize_weight_int4(wl, jnp.float32)[:IN])
        want = (xq.astype(jnp.float32) * xs) @ deq
        got = getattr(w4a8, route)(x, wq, jnp.int32(l))
        # the dequant route expands weights to bf16: ~0.4% relative noise
        tol = 2e-2 if route == "w4a8_dequant_matmul" else 1e-4
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=tol, atol=tol * 10)


# ---------------------------------------------------------- chip_smoke
def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_chip_smoke_refuses_cpu():
    proc = _run_smoke(REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "needs a GPU" in proc.stderr


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


# ---------------------------------------------------------- GPU lane
@pytest.mark.gpu
def test_gpu_routes(gpu_device):
    assert dispatch.platform() == "gpu"
    assert dispatch.segment_route(dispatch.platform()) == "kernel"
    assert dispatch.dense_attend("gpu", capacity=1 << 16,
                                 masked=False) == "cudnn"


@pytest.mark.gpu
@pytest.mark.parametrize("T", [1, 4, 64])
def test_pool_kernel_compiled_matches_reference(gpu_device, T):
    """The compiled Triton kernel at the 7B head geometry (G = 7, D = 128)
    on a pool built by the engine's builder."""
    from kvzip_tpu.cache import KVCache
    from kvzip_tpu.ops.pool_decode import pool_decode_attend
    from kvzip_tpu.pool import build_pool_stepped

    rng = np.random.default_rng(T)
    L, Hkv, G, D, C, sink, ctx = 3, 4, 7, 128, 1024, 8, 1000
    bf = jnp.bfloat16
    k, v = (jnp.asarray(rng.standard_normal((L, Hkv, C, D)), bf)
            for _ in range(2))
    cache = KVCache(k=k, v=v, lengths=jnp.full((L, Hkv), sink + ctx),
                    seen=jnp.int32(sink + ctx),
                    valid=jnp.ones((L, Hkv, C), bool))
    keep = jnp.asarray(rng.random((L, Hkv, ctx)) < 0.3)
    pool = build_pool_stepped(cache, keep, sink, tail_cap=128)
    q = jnp.asarray(rng.standard_normal((T, Hkv * G, D)), bf)
    kt, vt = (jnp.asarray(rng.standard_normal((L, Hkv, 128, D)), bf)
              for _ in range(2))
    for layer in range(L):
        args = (q, pool.k_pool, pool.v_pool, pool.row_head, pool.layer_off,
                pool.layer_rows, kt, vt, jnp.int32(17), jnp.int32(layer))
        kw = dict(scale=D ** -0.5, max_rows=pool.max_rows)
        got = pool_decode_attend(*args, **kw)
        want = attn_ops.pool_decode_reference(*args, **kw)
        np.testing.assert_allclose(np.asarray(got, np.float32),
                                   np.asarray(want, np.float32),
                                   rtol=2e-2, atol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("base", [(0, 0, 0, 0), (512, 512, 512, 512),
                                  (700, 100, 0, 333)])
def test_chunk_fused_cudnn_matches_dense(gpu_device, base):
    """cuDNN's fused attention through the chunk merge, bf16 at the 7B
    head geometry, against float32 dense attention."""
    q, k, v, bl, kn, vn = _chunk_case(
        np.random.default_rng(1), base, T=256, Hkv=4, G=7, D=128, C=1024,
        dtype=jnp.bfloat16)
    want = attn_ops.attend_dense(q, k, v, bl, None, scale=128 ** -0.5)
    got = attn_ops.attend_chunk_fused(q, k, v, bl, kn, vn,
                                      scale=128 ** -0.5)
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)
