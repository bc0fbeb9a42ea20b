"""Decode over the evicted layouts: the plain segment decode against a dense
float64 oracle, and the GPU pool kernel (Triton route, interpret mode)
against the plain form.

Grid: quantisation (none / int4) x layout (pool / flat) x tail length x
queries per call (the engine's query ladder) x merged sequences (``n_seq``,
serving's batched decode: global head ids ``b * Hkv + h``), every layer.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from kvzip_tpu.ops.attention import (flat_decode, flat_decode_int4,
                                     pool_decode_int4, pool_decode_reference,
                                     pool_segment, segment_decode_attend)
from kvzip_tpu.ops.pool_decode import head_ranges, pool_decode_attend

L, HKV, G, D = 2, 2, 2, 32
TCAP = 72
ALIGN = 16


def _layers(rng, n_seq, quant):
    """Per layer: head-major rows over n_seq * HKV global heads, as dense
    float64 values (the oracle's) and as stored (packed for int4)."""
    out = []
    for _ in range(L):
        counts = rng.integers(0, 13, size=n_seq * HKV)
        counts[rng.integers(0, len(counts))] += 5       # never all empty
        heads = np.repeat(np.arange(n_seq * HKV, dtype=np.int32), counts)
        r = len(heads)
        if quant == "int4":
            kq = rng.integers(0, 256, size=(D // 2, r), dtype=np.uint8)
            vq = rng.integers(0, 256, size=(D // 2, r), dtype=np.uint8)
            ks, vs = (rng.uniform(0.05, 0.2, r).astype(np.float32)
                      for _ in range(2))
            kz, vz = (rng.uniform(-1.0, 0.0, r).astype(np.float32)
                      for _ in range(2))

            def deq(p, s, z):
                n = np.concatenate([p >> 4, p & 0xF], axis=0).astype(np.float64)
                return (n * s + z).T                         # (r, D)

            stored = (kq, ks, kz, vq, vs, vz)
            k, v = deq(kq, ks, kz), deq(vq, vs, vz)
        else:
            k = rng.standard_normal((r, D)).astype(np.float32)
            v = rng.standard_normal((r, D)).astype(np.float32)
            stored = (k.T.copy(), v)
            k, v = k.astype(np.float64), v.astype(np.float64)
        out.append(dict(heads=heads, k=k, v=v, stored=stored))
    return out


# how each stored array lays out its rows: key/nibble columns (W, rows),
# value rows (rows, D), per-row scale/zero vectors (rows,)
_KINDS = {"none": ("cols", "rows"),
          "int4": ("cols", "vec", "vec", "cols", "vec", "vec")}


def _empty(kind, quant, n):
    if kind == "rows":
        return np.zeros((n, D), np.float32)
    if kind == "vec":
        return np.zeros((n,), np.float32)
    if quant == "int4":
        return np.zeros((D // 2, n), np.uint8)
    return np.zeros((D, n), np.float32)


def _place(dst, src, kind, o):
    r = src.shape[1] if kind == "cols" else src.shape[0]
    if kind == "cols":
        dst[:, o:o + r] = src
    else:
        dst[o:o + r] = src


def _pool(layers, quant):
    """Pool arrays: per-layer segments at ALIGN-multiple offsets."""
    rows = [len(x["heads"]) for x in layers]
    seg = [max(ALIGN, -(-r // ALIGN) * ALIGN) for r in rows]
    off = np.concatenate([[0], np.cumsum(seg)[:-1]]).astype(np.int32)
    P = int(off[-1] + max(seg))
    kinds = _KINDS[quant]
    arrs = [_empty(k, quant, P) for k in kinds]
    rh = np.full((P,), -1, np.int32)
    for x, o in zip(layers, off):
        for a, src, k in zip(arrs, x["stored"], kinds):
            _place(a, src, k, o)
        rh[o:o + len(x["heads"])] = x["heads"]
    # pool scales/zeros and row heads are (1, P)
    arrs = [jnp.asarray(a[None] if k == "vec" else a)
            for a, k in zip(arrs, kinds)]
    return (arrs, jnp.asarray(rh)[None], jnp.asarray(off),
            jnp.asarray(rows, jnp.int32), max(seg))


def _flat(layers, quant):
    """Flat stacks: every layer at one padded width R."""
    R = max(len(x["heads"]) for x in layers) + 8
    kinds = _KINDS[quant]
    arrs = [np.stack([_empty(k, quant, R) for _ in range(L)]) for k in kinds]
    rh = np.full((L, R), -1, np.int32)
    for l, x in enumerate(layers):
        for a, src, k in zip(arrs, x["stored"], kinds):
            _place(a[l], src, k, 0)
        rh[l, :len(x["heads"])] = x["heads"]
    return [jnp.asarray(a) for a in arrs], jnp.asarray(rh)


def _oracle(q, x, k_tail, v_tail, tail_len):
    """Dense float64 attention per query head over its kv head's rows and
    the tail rows [0, tail_len + i + 1)."""
    T, H_all, _ = q.shape
    out = np.zeros((T, H_all, D))
    for t in range(T):
        for hq in range(H_all):
            h = hq // G
            keys = np.concatenate(
                [x["k"][x["heads"] == h], k_tail[h, :tail_len[h] + t + 1]])
            vals = np.concatenate(
                [x["v"][x["heads"] == h], v_tail[h, :tail_len[h] + t + 1]])
            s = keys @ q[t, hq] * D ** -0.5
            p = np.exp(s - s.max())
            out[t, hq] = (p / p.sum()) @ vals
    return out


def _case(seed, quant, tail, T, n_seq):
    rng = np.random.default_rng(seed)
    layers = _layers(rng, n_seq, quant)
    H_all = n_seq * HKV * G
    q = rng.standard_normal((T, H_all, D)).astype(np.float32)
    k_tail = rng.standard_normal((L, n_seq * HKV, TCAP, D)).astype(np.float32)
    v_tail = rng.standard_normal((L, n_seq * HKV, TCAP, D)).astype(np.float32)
    tl = np.full((n_seq * HKV,), tail, np.int32)
    if n_seq > 1:
        tl[::2] = max(tail - 2, 0)          # per-sequence tail lengths
    return layers, q, k_tail, v_tail, tl


@pytest.mark.parametrize("n_seq", [1, 2])
@pytest.mark.parametrize("T", [1, 4, 64])
@pytest.mark.parametrize("tail", [0, 5])
@pytest.mark.parametrize("layout", ["pool", "flat"])
@pytest.mark.parametrize("quant", ["none", "int4"])
def test_segment_decode_matches_oracle(quant, layout, tail, T, n_seq):
    layers, q, k_tail, v_tail, tl = _case(T * 7 + tail, quant, tail, T, n_seq)
    args = (jnp.asarray(k_tail), jnp.asarray(v_tail), jnp.asarray(tl))
    if layout == "pool":
        arrs, rh, off, rows, max_rows = _pool(layers, quant)
        fn = pool_decode_int4 if quant == "int4" else pool_decode_reference
    else:
        arrs, rh = _flat(layers, quant)
        fn = flat_decode_int4 if quant == "int4" else flat_decode
    for l in range(L):
        if layout == "pool":
            got = fn(jnp.asarray(q), *arrs, rh, off, rows, *args,
                     jnp.int32(l), scale=D ** -0.5, max_rows=max_rows)
        else:
            got = fn(jnp.asarray(q), *arrs, rh, *args, scale=D ** -0.5,
                     layer=jnp.int32(l))
        want = _oracle(q, layers[l], k_tail[l], v_tail[l], tl)
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4,
                                   atol=1e-4, err_msg=f"layer {l}")


@pytest.mark.parametrize("stacked_tail", [True, False])
@pytest.mark.parametrize("n_seq", [1, 2])
@pytest.mark.parametrize("T", [1, 4, 64])
@pytest.mark.parametrize("tail", [0, 5])
def test_pool_kernel_interpret_matches_reference(tail, T, n_seq,
                                                 stacked_tail):
    """The Triton-route kernel, run by the Pallas interpreter, against the
    plain pool decode; tails as the decode scan passes them (whole (L, ...)
    stacks) and as tensor parallelism and merged batches do (this layer's)."""
    layers, q, k_tail, v_tail, tl = _case(T * 11 + tail, "none", tail, T,
                                          n_seq)
    arrs, rh, off, rows, max_rows = _pool(layers, "none")
    for l in range(L):
        kt, vt = ((k_tail, v_tail) if stacked_tail
                  else (k_tail[l], v_tail[l]))
        args = (jnp.asarray(q), *arrs, rh, off, rows, jnp.asarray(kt),
                jnp.asarray(vt), jnp.asarray(tl), jnp.int32(l))
        got = pool_decode_attend(*args, scale=D ** -0.5, max_rows=max_rows,
                                 block_k=16, interpret=True)
        want = pool_decode_reference(*args, scale=D ** -0.5,
                                     max_rows=max_rows)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-5, atol=1e-5, err_msg=f"layer {l}")


def test_head_ranges_cover_each_head():
    layers, *_ = _case(3, "none", 0, 1, 2)
    _, rh, off, rows, max_rows = _pool(layers, "none")
    for l in range(L):
        start, end = head_ranges(rh, off, rows, jnp.int32(l), 2 * HKV,
                                 max_rows)
        heads = layers[l]["heads"]
        o = int(off[l])
        for h in range(2 * HKV):
            idx = np.nonzero(heads == h)[0]
            if len(idx):
                assert (int(start[h]), int(end[h])) == (o + idx[0],
                                                        o + idx[-1] + 1)
            else:
                assert int(start[h]) == int(end[h]) == 0


def test_pool_segment_clamped_window_keeps_heads():
    """A window that runs past the pool's end is clamped; rows outside the
    layer's live range read as dead (-1), never as another layer's."""
    P, R = 40, 32
    rh = jnp.asarray(np.arange(P, dtype=np.int32) % 3)[None]
    vals = jnp.arange(P, dtype=jnp.float32)[None]
    (win,), rh_seg = pool_segment((vals,), rh, jnp.asarray([0, 24]),
                                  jnp.asarray([24, 10]), jnp.int32(1), R)
    win = np.asarray(win)[0]
    rh_seg = np.asarray(rh_seg)
    assert win[0] == P - R                     # clamped start
    live = rh_seg >= 0
    np.testing.assert_array_equal(win[live], np.arange(24, 34))


def test_segment_decode_empty_context_reads_tail_only():
    """A head with no kept rows attends over its tail alone."""
    rng = np.random.default_rng(0)
    q = jnp.asarray(rng.standard_normal((1, HKV * G, D)), jnp.float32)
    kt = jnp.asarray(rng.standard_normal((HKV, 8, D)), jnp.float32)
    vt = jnp.asarray(rng.standard_normal((HKV, 8, D)), jnp.float32)
    k_seg = jnp.zeros((D, 4))
    v_seg = jnp.zeros((4, D))
    got = segment_decode_attend(q, k_seg, v_seg, jnp.full((4,), -1),
                                kt, vt, jnp.int32(0), scale=1.0)
    # one visible tail row per head: the output is that row's value
    want = jnp.repeat(vt[:, 0], G, axis=0)[None]
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-6)
    assert bool(jnp.isfinite(got).all())
