"""Kernel decisions, measured on the GPU: each hand-written kernel against
the plain form XLA compiles, at the smoke pipeline's state
(`chip_smoke.py`: qwen2.5-7b, 32,768-token context, pair prune at 0.3).

    python tools/kernel_timing.py [--out timing.json] [--trace DIR]

Measures, all warm, each number the median of its runs with
``block_until_ready`` inside the timed region:

- prefill attention: one 16,384-token chunk through the 28-layer forward
  against the 32k cache, cuDNN fused attention vs the blockwise XLA form;
- pool decode: a 28-layer decode-attention step (every layer's pool
  attention, one query) on the pruned pool and on its synthetic full pool,
  Triton kernel vs the plain segment decode (>= 20 runs);
- end to end: ``Engine.generate`` ms/token on both pools, kernel route vs
  plain route;
- one scoring chunk under ``jax.profiler`` (``--trace``): device time per
  kernel, to split the full-cache attention from the reconstruction-score
  fusions.

Prints one line per number, each labelled with the card, and writes them
all as JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import sys
import time
from collections import defaultdict

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as smoke  # noqa: E402


def median_ms(fn, runs):
    import jax

    jax.block_until_ready(fn())
    ts = []
    for _ in range(runs):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(ts)), [1e3 * t for t in ts]


def prefill_candidates(eng, st, ctx_ids, out, card):
    """The second 16,384-token chunk against the 32k cache, re-run in
    place: counters reset to the chunk's start, the chunk's rows rewritten
    with the same values each run."""
    import jax.numpy as jnp

    from kvzip_tpu.models.transformer import forward

    n = smoke.PREFILL_CHUNK
    ids = jnp.asarray(st.prefill_ids[st.prefill_len - n:])
    for impl in ("cudnn", "blockwise"):
        box = {"cache": st.cache}

        def run():
            c = box["cache"]
            c = dataclasses.replace(c, lengths=c.lengths * 0 + (
                st.prefill_len - n), seen=c.seen * 0 + (st.prefill_len - n))
            res = forward(eng.params, eng.config, ids, c, attn_impl=impl)
            box["cache"] = res.cache
            return res.cache.seen

        ms, runs = median_ms(run, 5)
        st.cache = box["cache"]
        out[f"prefill_chunk_{impl}_ms"] = ms
        out[f"prefill_chunk_{impl}_runs_ms"] = runs
        smoke.log(f"[{card}] prefill chunk {n} vs {st.prefill_len}-row "
                  f"cache, 28 layers, {impl}: {ms:.1f} ms")
    # put the cache back as prefill left it
    st.restore_snapshot()


def scoring_trace(eng, st, ctx_ids, out, card, trace_dir):
    """One scoring chunk (the forward + the score hook) under the
    profiler: device time per kernel name."""
    import jax
    from jax.profiler import ProfileData

    tasks = eng.self_task(ctx_ids[:eng.score_chunk_size],
                          eng.score_chunk_size)
    a_ids, rep_ids = tasks[0]
    pad = np.zeros((eng.score_q_pad,), np.int32)
    pad[:len(rep_ids)] = rep_ids

    def chunk():
        from kvzip_tpu.models.transformer import forward
        res = forward(eng.params, eng.config, jax.numpy.asarray(pad),
                      st.cache, scoring=True,
                      score_start=jax.numpy.int32(st.sink),
                      score_len=jax.numpy.int32(len(a_ids)),
                      score_qlen=jax.numpy.int32(len(rep_ids)),
                      score_width=eng.score_width, sink=st.sink,
                      attn_impl=eng._impl(st))
        st.cache = res.cache
        st.restore_snapshot()
        return res.chunk_scores

    jax.block_until_ready(chunk())
    ms, _ = median_ms(chunk, 3)
    out["scoring_chunk_ms"] = ms
    smoke.log(f"[{card}] one scoring chunk ({eng.score_q_pad} queries), "
              f"28 layers: {ms:.1f} ms")
    jax.profiler.start_trace(trace_dir)
    jax.block_until_ready(chunk())
    jax.profiler.stop_trace()
    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    # per device line ("XLA Ops" names HLO ops, stream lines name the
    # kernels): total device ms per event name
    per = defaultdict(lambda: defaultdict(float))
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            kind = "ops" if line.name == "XLA Ops" else (
                "kernels" if "Stream" in line.name else None)
            if kind is None:
                continue
            for ev in line.events:
                per[kind][ev.name] += ev.duration_ns / 1e6
    for kind, d in per.items():
        total = sum(d.values())
        top = sorted(d.items(), key=lambda kv: -kv[1])[:20]
        out[f"scoring_trace_{kind}_total_ms"] = total
        out[f"scoring_trace_{kind}_top"] = top
        smoke.log(f"[{card}] scoring chunk trace, {kind}: {total:.1f} ms")
        for name, t in top:
            smoke.log(f"    {t:9.3f} ms {100 * t / total:5.1f}%  {name[:110]}")


def decode_step(cache, num_heads, route, out, card, label):
    """Every layer's pool attention for one query: the decode step's
    attention work, without the rest of the model."""
    import jax
    import jax.numpy as jnp

    from kvzip_tpu.ops import dispatch

    fn = dispatch.pool_decode(route)
    L, Hkv, Tcap, D = cache.k_tail.shape
    q = jax.random.normal(jax.random.key(0), (1, num_heads, D), jnp.bfloat16)

    @jax.jit
    def step(q, k_pool, v_pool, rh, off, rows, kt, vt):
        def body(c, l):
            return c, fn(q, k_pool, v_pool, rh, off, rows, kt, vt,
                         jnp.int32(7), l, scale=D ** -0.5,
                         max_rows=cache.max_rows)
        return jax.lax.scan(body, 0, jnp.arange(L, dtype=jnp.int32))[1]

    args = (q, cache.k_pool, cache.v_pool, cache.row_head, cache.layer_off,
            cache.layer_rows, cache.k_tail, cache.v_tail)
    ms, runs = median_ms(lambda: step(*args), 20)
    out[f"decode_step_{label}_{route}_ms"] = ms
    smoke.log(f"[{card}] 28-layer pool attention, {label} pool, {route}: "
              f"{ms:.3f} ms (median of {len(runs)})")


def generate_ms(eng, st, route, out, card, label, tokens=256):
    eng.attn_impl = route
    ids = eng.apply_template(smoke.QUERIES[0])
    try:
        ms, runs = median_ms(
            lambda: eng.generate(ids, st, max_new_tokens=tokens), 5)
    finally:
        eng.attn_impl = "auto"
    out.setdefault(f"generate_{label}_{route}_ms_per_token", []).append(
        ms / tokens)
    smoke.log(f"[{card}] Engine.generate {tokens} tokens, {label} pool, "
              f"{route}: {ms / tokens:.3f} ms/token (median of {len(runs)})")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="kernel_timing.json")
    ap.add_argument("--trace", default="kernel_timing_trace")
    args = ap.parse_args(argv)

    devs, card = smoke.device_phase()
    from kvzip_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    out = {"card": card, "device_kind": devs[0].device_kind}

    eng = smoke.make_engine()
    ctx_ids = np.random.default_rng(smoke.SEED).integers(
        1, eng.config.vocab_size - 10, size=smoke.CTX_TOKENS).astype(np.int32)
    st = smoke.prefill_and_score(
        eng, card, ctx_ids,
        on_dense=lambda s: (prefill_candidates(eng, s, ctx_ids, out, card),
                            scoring_trace(eng, s, ctx_ids, out, card,
                                          args.trace)))
    smoke.prune(eng, card, st)
    H = eng.config.num_heads
    full = dataclasses.replace(
        st, cache=smoke.random_full_pool(eng, st, smoke.SEED + 2))
    full.snapshot()
    for label, state in (("pruned", st), ("full", full)):
        for route in ("kernel", "plain"):
            decode_step(state.cache, H, route, out, card, label)
        for route in ("kernel", "plain", "kernel", "plain"):
            generate_ms(eng, state, route, out, card, label)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    smoke.log(f"wrote {args.out}")


if __name__ == "__main__":
    main()
