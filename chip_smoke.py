"""Smoke test on an NVIDIA GPU: the main path, end to end, at full width.

    python chip_smoke.py                # one card
    python chip_smoke.py --four-cards   # four cards: tensor parallel vs one

One card runs, in one process:

1. device: fail unless JAX computes on a GPU; print the card's name and
   power limit;
2. pipeline: ``Engine("qwen2.5-7b", kv_type="evict")`` at its published
   width (random bf16 weights from a seed, bf16 KV cache), a 32,768-token
   context from the seed prefilled in 16,384-token chunks, exact
   reconstruction scoring, ``prune(ratio=0.3, level="pair")`` into the
   pool, three queries of 32 greedy tokens through ``Engine.generate``;
3. parity: every kept kernel and route against its plain reference at
   these widths — the reconstruction scores against a float32 HIGHEST
   scoring pass, the pool decode kernel on the pruned pool and on its
   synthetic full pool, and the first decode step's logits through the
   GPU route against the plain route on the same pruned state (top-1 equal
   up to a tie within ``LOGIT_ATOL``);
4. the ``gpu``-marked tests (``pytest -m gpu -n 0``), in this process.

``--four-cards`` runs only the pipeline on ``make_mesh(4, tp=4)`` and on one
card, and compares their greedy tokens and first-step logits
(:func:`four_cards`).

Any failure exits non-zero. The last line of standard output is one JSON
object: ``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

MODEL = "qwen2.5-7b"
CTX_TOKENS = 32768
PREFILL_CHUNK = 16384
RATIO = 0.3
NEW_TOKENS = 32
SEED = 0
QUERIES = ("What is the first number in the context?",
           "Repeat the last sentence of the context.",
           "Which token appears most often?")

# D limits. Pool kernel: bf16 inputs, float32 accumulation; the bf16 output
# allows 2e-2 absolute + relative.
POOL_ATOL = POOL_RTOL = 2e-2
# scores are softmax probabilities (<= 1) from bf16-rounded logits on both
# sides; pairs at the r = 0.3 threshold tie, so a few may swap
SCORE_ATOL = 1e-2
KEPT_OVERLAP_MIN = 0.995
# logits of two forwards of one bf16 model on one state: the plain route
# alone, fed the query in chunks or one token at a time, differs by up to
# 0.258 in a logit on an H100 (PERF.md); the bound is a little over twice
# that. Two tokens closer than the bound are a tie: either is a right top-1.
LOGIT_ATOL = 0.6


def log(msg: str) -> None:
    print(msg, flush=True)


class IdTokenizer:
    """Byte-level encode (what the engine uses without a checkpoint) and a
    decode that keeps every token id, so greedy outputs compare exactly."""

    eos_token_id = None

    def encode(self, text, add_special_tokens=False):
        return list(text.encode("utf-8"))

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(int(i)) for i in np.asarray(ids).reshape(-1))


def device_phase():
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU, JAX found "
                         f"{devs[0].platform!r}")
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    for line in cards.splitlines():
        log(f"card: {line}")
    card = cards.splitlines()[0]
    log(f"jax: {jax.__version__}, {len(devs)} x {devs[0].device_kind}")
    return devs, card


def make_engine(mesh=None):
    import jax.numpy as jnp

    from kvzip_tpu.engine import Engine

    eng = Engine(MODEL, kv_type="evict", dtype=jnp.bfloat16, seed=SEED,
                 max_new_tokens=NEW_TOKENS, tokenizer=IdTokenizer(),
                 mesh=mesh)
    eng.eos_ids = (-1,)  # exactly NEW_TOKENS tokens per query
    return eng


def timed(card, label, fn):
    t0 = time.perf_counter()
    out = fn()
    log(f"[{card}] {label}: {time.perf_counter() - t0:.2f} s")
    return out


def prefill_and_score(eng, card, ctx_ids, on_dense=None, on_scored=None):
    """Prefill + scoring; ``on_dense(state)`` runs between them, on the
    dense cache, and ``on_scored(state)`` after scoring."""
    import jax

    def prefill():
        st = eng.prefill(ctx_ids, prefill_chunk_size=PREFILL_CHUNK,
                         do_score=False)
        jax.block_until_ready(jax.tree.leaves(st.cache))
        return st

    st = timed(card, f"prefill {len(ctx_ids)} tokens", prefill)
    if on_dense is not None:
        on_dense(st)
    timed(card, "scoring (exact)", lambda: (
        eng.scoring(st, ctx_ids), jax.block_until_ready(st.score)))
    if on_scored is not None:
        on_scored(st)
    return st


def prune(eng, card, st):
    import jax

    thres, ratio = timed(card, f"prune pair@{RATIO} into the pool",
                         lambda: eng.prune(st, RATIO, "pair"))
    jax.block_until_ready(jax.tree.leaves(st.cache))
    log(f"kept ratio {ratio:.4f}, KV {st.used_gb():.3f} GB live")
    return st


def first_logits(eng, st, ids, route):
    """Logits of the first decode step (the token after the query)."""
    eng.attn_impl = route
    try:
        return eng.forward_ids(ids, st, return_logits=True)[-1].astype(
            np.float32)
    finally:
        eng.attn_impl = "auto"


def generate_all(eng, card, st):
    outs = []
    for i, q in enumerate(QUERIES):
        ids = eng.apply_template(q)
        t0 = time.perf_counter()
        text = eng.generate(ids, st, max_new_tokens=NEW_TOKENS)
        dt = time.perf_counter() - t0
        toks = [int(t) for t in text.split()]
        if len(toks) != NEW_TOKENS:
            raise AssertionError(f"query {i}: {len(toks)} tokens")
        log(f"[{card}] generate query {i}: {NEW_TOKENS} tokens in "
            f"{dt:.3f} s ({1e3 * dt / NEW_TOKENS:.2f} ms/token incl. query)")
        outs.append(toks)
    return outs


def check(label, value, limit, ok):
    log(f"{label}: {value:.4e} (limit {limit}) {'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError(label)


# ------------------------------------------------------------------ parity
def score_parity(eng, st, ctx_ids, card):
    """Reconstruction scores through the card's route (model-dtype operands,
    float32 accumulation) against the float32 HIGHEST reference, on the
    same queries and keys. A second scoring pass wraps the score hook: each
    (layer, chunk) call computes both and sends them to the host, and
    returns the card's. Both round logits to bf16 before the softmax, as
    the reference does. Each context chunk is scored by exactly one call,
    so the calls together hold every pair's score. The pipeline's scores
    are restored afterwards; jit caches are cleared around the pass so it
    traces its own hook."""
    import jax
    import jax.numpy as jnp

    from kvzip_tpu.ops import attention as attn_ops

    pipeline_scores = st.score
    hook = attn_ops.reconstruction_scores
    calls = []

    def keep(got, want, n):
        n = int(n)
        calls.append((np.asarray(got, np.float32)[:, :n],
                      np.asarray(want, np.float32)[:, :n]))

    def both(q, k_sink, k_ctx, k_rep, ctx_len, **kw):
        got = hook(q, k_sink, k_ctx, k_rep, ctx_len, **kw)
        f32 = jnp.float32
        want = hook(q.astype(f32), k_sink.astype(f32), k_ctx.astype(f32),
                    k_rep.astype(f32), ctx_len, **kw)
        jax.debug.callback(keep, got, want, ctx_len)
        return got

    attn_ops.reconstruction_scores = both
    jax.clear_caches()
    try:
        eng.scoring(st, ctx_ids)
        jax.effects_barrier()
    finally:
        attn_ops.reconstruction_scores = hook
        jax.clear_caches()
    st.score = pipeline_scores
    if not calls:
        raise AssertionError("the score hook was never called")
    got = np.concatenate([g.ravel() for g, _ in calls])
    want = np.concatenate([w.ravel() for _, w in calls])
    log(f"[{card}] score parity over {len(calls)} (layer, chunk) calls, "
        f"{got.size} pairs")
    err = float(np.abs(got - want).max())
    check(f"[{card}] scores vs float32 HIGHEST: max|dp|", err, SCORE_ATOL,
          err <= SCORE_ATOL)
    # keep exactly the top r of pairs on each side, ties broken by
    # position as a stable sort does: bf16 scores tie in large groups, and
    # a group either side of the threshold must not count as a disagreement
    k = int(RATIO * got.size)

    def top_k(x):
        keep = np.zeros(x.size, bool)
        keep[np.argsort(-x.ravel(), kind="stable")[:k]] = True
        return keep

    overlap = float((top_k(got) & top_k(want)).sum() / k)
    check(f"[{card}] kept-pair overlap at r={RATIO}", overlap,
          f">= {KEPT_OVERLAP_MIN}", overlap >= KEPT_OVERLAP_MIN)


def pool_parity(cache, num_heads, card, label, seed):
    """Pool kernel vs the plain segment decode over every layer of one
    pool, for one query and for the 64-query ladder step, with a random
    40-row tail."""
    import jax
    import jax.numpy as jnp

    from kvzip_tpu.ops.attention import pool_decode_reference
    from kvzip_tpu.ops.pool_decode import pool_decode_attend

    L, Hkv, Tcap, D = cache.k_tail.shape
    H = num_heads
    key = jax.random.key(seed)
    kt = jax.random.normal(jax.random.fold_in(key, 1), cache.k_tail.shape,
                           jnp.bfloat16)
    vt = jax.random.normal(jax.random.fold_in(key, 2), cache.k_tail.shape,
                           jnp.bfloat16)
    kw = dict(scale=D ** -0.5, max_rows=cache.max_rows)
    for T in (1, 64):
        q = jax.random.normal(jax.random.fold_in(key, T), (T, H, D),
                              jnp.bfloat16)
        worst, excess = 0.0, 0.0
        for l in range(L):
            args = (q, cache.k_pool, cache.v_pool, cache.row_head,
                    cache.layer_off, cache.layer_rows, kt, vt,
                    jnp.int32(40), jnp.int32(l))
            got = np.asarray(pool_decode_attend(*args, **kw), np.float32)
            want = np.asarray(pool_decode_reference(*args, **kw), np.float32)
            d = np.abs(got - want)
            worst = max(worst, float(d.max()))
            excess = max(excess, float(
                (d - POOL_ATOL - POOL_RTOL * np.abs(want)).max()))
        check(f"[{card}] pool kernel vs segment_decode_attend, {label}, "
              f"T={T}: max|d|", worst,
              f"atol {POOL_ATOL} + rtol {POOL_RTOL}", excess <= 0)


def random_full_pool(eng, st, seed):
    """The state's synthetic full pool (every context row live), filled
    with random bf16 keys and values so the comparison means something."""
    import jax
    import jax.numpy as jnp

    full = eng.synthetic_full_pool_state(st, False, st.cache.k_tail.shape[2])
    c = full.cache
    key = jax.random.key(seed)
    return dataclasses.replace(
        c,
        k_pool=jax.random.normal(jax.random.fold_in(key, 1), c.k_pool.shape,
                                 jnp.bfloat16),
        v_pool=jax.random.normal(jax.random.fold_in(key, 2), c.v_pool.shape,
                                 jnp.bfloat16))


def logits_parity(eng, st, card):
    """First-step logits through the GPU route vs the plain route."""
    pairs = [(first_logits(eng, st, eng.apply_template(q), "kernel"),
              first_logits(eng, st, eng.apply_template(q), "plain"))
             for q in QUERIES]
    compare_logits(card, "kernel vs plain route", pairs)


def top1_agrees(ref, tok) -> bool:
    """``tok`` is the top-1 of the reference logits ``ref``, or ties it
    within LOGIT_ATOL."""
    return tok == int(ref.argmax()) or ref[tok] >= ref.max() - LOGIT_ATOL


def compare_logits(card, label, pairs):
    """Per query (logits ``a`` against the reference ``b``): top-1 agrees
    up to a tie, and max|d| stays within LOGIT_ATOL. Each line gives the
    reference's top-1 margin (top-1 minus top-2 logit)."""
    worst = 0.0
    for i, (a, b) in enumerate(pairs):
        d = float(np.abs(a - b).max())
        worst = max(worst, d)
        top2 = np.sort(b)[-2:]
        tok = int(a.argmax())
        verdict = ("same" if tok == int(b.argmax()) else
                   "tie" if top1_agrees(b, tok) else "DIFFERENT")
        log(f"[{card}] {label}, query {i}: top-1 {tok} / {int(b.argmax())} "
            f"({verdict}), max|d| {d:.4e}, reference margin "
            f"{float(top2[1] - top2[0]):.4e}, max|logit| "
            f"{float(np.abs(b).max()):.3f}")
        if not top1_agrees(b, tok):
            raise AssertionError(f"{label}, query {i}: top-1 differs")
    check(f"[{card}] first-step logits, {label}: max|d|", worst, LOGIT_ATOL,
          worst <= LOGIT_ATOL)


# ------------------------------------------------------------------ runs
def one_card(card) -> None:
    import gc

    import pytest

    from kvzip_tpu.pool import PoolKV

    eng = make_engine()
    ctx_ids = np.random.default_rng(SEED).integers(
        1, eng.config.vocab_size - 10, size=CTX_TOKENS).astype(np.int32)
    st = prefill_and_score(
        eng, card, ctx_ids,
        on_scored=lambda s: score_parity(eng, s, ctx_ids, card))
    prune(eng, card, st)
    if not isinstance(st.cache, PoolKV):
        raise AssertionError(f"pruned cache is {type(st.cache).__name__}")
    generate_all(eng, card, st)
    H = eng.config.num_heads
    pool_parity(st.cache, H, card, "pruned pool", SEED + 1)
    logits_parity(eng, st, card)
    full = random_full_pool(eng, st, SEED + 2)
    pool_parity(full, H, card, "synthetic full pool", SEED + 3)
    del full, st, eng
    gc.collect()

    log("gpu tests: pytest -m gpu -n 0")
    here = os.path.dirname(os.path.abspath(__file__))
    rc = pytest.main(["-m", "gpu", "-n", "0", "-q", "-p", "no:cacheprovider",
                      os.path.join(here, "tests")])
    if rc != 0:
        raise AssertionError(f"gpu tests failed (pytest exit {int(rc)})")


def four_cards(card) -> None:
    """The pipeline on ``make_mesh(4, tp=4)``, then on one card. First-step
    logits compare as in :func:`compare_logits`. Greedy tokens must match
    until the first step where one card's top-1 is a tie: there, tp=4's
    token must tie one card's top-1 within LOGIT_ATOL (one card's logits at
    that step, recomputed on its own tokens), and the two sequences may
    part from then on."""
    from kvzip_tpu.parallel import make_mesh

    runs = {}
    for name, mesh in (("tp=4", make_mesh(4, tp=4)), ("one card", None)):
        eng = make_engine(mesh)
        ctx_ids = np.random.default_rng(SEED).integers(
            1, eng.config.vocab_size - 10, size=CTX_TOKENS).astype(np.int32)
        label = f"{card} {name}"
        st = prefill_and_score(eng, label, ctx_ids)
        prune(eng, label, st)
        toks = generate_all(eng, label, st)
        logits = [first_logits(eng, st, eng.apply_template(q), "auto")
                  for q in QUERIES]
        runs[name] = (toks, logits)
        if mesh is not None:
            del st, eng
    # eng, st: the one-card engine and its pruned state
    (t_tp, l_tp), (t_one, l_one) = runs["tp=4"], runs["one card"]
    compare_logits(card, "tp=4 vs one card", list(zip(l_tp, l_one)))
    for i, q in enumerate(QUERIES):
        at = next((j for j, (x, y) in enumerate(zip(t_tp[i], t_one[i]))
                   if x != y), None)
        if at is None:
            log(f"[{card}] query {i}: tp=4 tokens == one card's "
                f"({NEW_TOKENS} tokens)")
            continue
        ids = np.concatenate([eng.apply_template(q),
                              np.asarray(t_one[i][:at], np.int32)])
        ref = first_logits(eng, st, ids, "auto")
        top2 = np.sort(ref)[-2:]
        log(f"[{card}] query {i}: tp=4 tokens == one card's for {at} "
            f"tokens; at token {at} tp=4 {t_tp[i][at]} vs one card "
            f"{t_one[i][at]}, one card's margin "
            f"{float(top2[1] - top2[0]):.4e}, tp=4's token "
            f"{float(ref.max() - ref[t_tp[i][at]]):.4e} below its top-1")
        if not top1_agrees(ref, t_tp[i][at]):
            raise AssertionError(f"query {i}: tp=4 greedy token {at} is "
                                 "not a tie of one card's")
    log(f"greedy tokens: tp=4 agrees with one card on all {len(QUERIES)} "
        "queries")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the tensor-parallel comparison on 4 cards")
    args = ap.parse_args(argv)

    devs, card = device_phase()
    from kvzip_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    if args.four_cards:
        if len(devs) < 4:
            raise SystemExit(f"--four-cards needs 4 GPUs, found {len(devs)}")
        four_cards(card)
    else:
        one_card(card)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
