"""End-of-round benchmark: decode throughput with a KVzip-compressed cache.

Measures the reference's headline scenario (BASELINE.md: ≈2× decode speedup,
3–4× KV reduction at ratio 0.3) on one accelerator: prefill a long context,
run reconstruction scoring, evict at ratio 0.3, and compare decode tokens/s
and KV bytes against a full-occupancy cache decoded through the SAME layout
and kernels.

Budget discipline:

- STAGED EMISSION: the ladder runs cheap → flagship and a complete JSON
  result line is printed (flushed) after EVERY completed stage, so whatever
  the harness timeout, the last complete line parses. Stages are ordered so
  later lines strictly supersede earlier ones.
- SAVED STATE: after a full pipeline completes, the pruned pool cache is
  persisted under ``.bench_state/`` (Engine.save_state). Re-runs load it and
  bench decode directly, skipping prefill and scoring. Pipeline-phase
  timings for a from-saved-state run are
  reported from the sidecar (measured when the state was created) and marked
  ``"archived": true`` in the detail block.

Prints one JSON line per completed stage to stdout; phase details on stderr.
"""

import json
import os
import sys
import time

import numpy as np

STATE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         ".bench_state")


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def _scoring_attend():
    return os.environ.get("BENCH_SCORING_ATTEND", "full")


def _state_base(model, ctx, wq, kq, eq, ratio):
    tag = f"{model}_{ctx}_{wq}_{kq}_{eq}_r{ratio}".replace("/", "-")
    if _scoring_attend() != "full":
        # windowed scoring produces different scores -> different pruned
        # state; never overwrite the exact-mode artifact
        tag += f"_{_scoring_attend()}"
    return os.path.join(STATE_DIR, tag)


def _bench_decode(eng, st, tag, decode_tokens, repeats: int = 4):
    import jax  # noqa: F401

    q = eng.apply_template("Summarize the context.")
    # warmup at the measured shape (compile), then take the BEST of
    # ``repeats`` timed runs; min-of-repeats, applied identically to the
    # pruned AND full sides, keeps the comparison fair
    eng.generate(q, st, max_new_tokens=decode_tokens)
    best = float("inf")
    for _ in range(max(1, repeats)):
        t0 = time.time()
        eng.generate(q, st, max_new_tokens=decode_tokens)
        best = min(best, time.time() - t0)
    log(f"decode[{tag}]: {decode_tokens} tokens in {best:.2f}s (best of "
        f"{repeats}) -> {1000 * best / decode_tokens:.2f} ms/tok")
    return best / decode_tokens


def _full_baseline_ms(eng, state, decode_tokens):
    """Honest full-cache baseline: decode a full-occupancy cache through the
    same layout/kernels as the evicted one, measured in the SAME run. The
    evicted cache is freed first; decode time does not depend on the values,
    so the synthetic fill is equivalent to a real flatten_full(state)."""
    import gc

    from kvzip_tpu.cache import FlatInt4KV as _FI4
    from kvzip_tpu.pool import PoolInt4KV, PoolKV

    cache = state.cache
    is_pool = isinstance(cache, (PoolKV, PoolInt4KV))
    int4 = isinstance(cache, (_FI4, PoolInt4KV))
    tail_cap = cache.k_tail.shape[2]
    state.cache = None
    state._snap = None
    gc.collect()
    if is_pool:
        state_full = eng.synthetic_full_pool_state(state, int4, tail_cap)
    else:
        state_full = eng.synthetic_full_flat_state(state, int4, tail_cap)
    ms_full = _bench_decode(eng, state_full, "full-cache", decode_tokens)
    del state_full
    gc.collect()
    return ms_full


def run(model_name: str, ctx_tokens: int, decode_tokens: int, ratio: float,
        weight_quant: str = "none", kv_quant: str = "none",
        embed_quant: str = "none", save_state: bool = True):
    import jax
    import jax.numpy as jnp

    from kvzip_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    from kvzip_tpu.config import resolve_config
    from kvzip_tpu.engine import Engine

    cfg = resolve_config(model_name)
    log(f"model={model_name} L={cfg.num_layers} H={cfg.num_heads}/"
        f"{cfg.num_kv_heads} D={cfg.hidden_size} ctx={ctx_tokens}")

    eng = Engine(model_name, kv_type="evict", config=cfg, dtype=jnp.bfloat16,
                 max_new_tokens=decode_tokens,
                 decode_budget=decode_tokens + 256,
                 weight_quant=weight_quant, kv_quant=kv_quant,
                 embed_quant=embed_quant, scoring_attend=_scoring_attend())
    # benchmark decodes a fixed token count: disable EOS stopping
    eng.eos_ids = (-1,)

    base = _state_base(model_name, ctx_tokens, weight_quant, kv_quant,
                       embed_quant, ratio)
    phases = {}
    archived = False
    state = None

    if (os.environ.get("BENCH_NO_SAVED_STATE") != "1"
            and os.path.exists(base + ".npz")
            and os.path.exists(base + ".json")):
        try:
            t0 = time.time()
            state = eng.load_state(base)
            jax.block_until_ready(jax.tree.leaves(state.cache))
            with open(base + ".json") as f:
                meta = json.load(f)
            phases = {k: meta[k] for k in
                      ("prefill_s", "scoring_s", "prune_s") if k in meta}
            phases["full_bytes"] = meta.get("full_bytes", 0.0)
            archived = True
            log(f"loaded saved pruned state {base}.npz in "
                f"{time.time() - t0:.1f}s (prefill/scoring timings archived "
                f"from the run that created it)")
        except Exception:
            import traceback
            traceback.print_exc(file=sys.stderr)
            state = None

    rng = np.random.default_rng(0)
    ctx_ids = rng.integers(1, cfg.vocab_size - 10,
                           size=ctx_tokens).astype(np.int32)

    if state is None:
        t0 = time.time()
        # 16384-token chunks decompose to ONE jit call each on the chunk
        # ladder (the reference's 16000 fragments into 4096/1024/256/...)
        state = eng.prefill(ctx_ids, prefill_chunk_size=16384, do_score=False)
        jax.block_until_ready(jax.tree.leaves(state.cache))
        phases["prefill_s"] = time.time() - t0
        log(f"prefill: {phases['prefill_s']:.2f}s "
            f"({ctx_tokens / phases['prefill_s']:.0f} tok/s), "
            f"cache {state.mem_gb()} GB")

        t0 = time.time()
        eng.scoring(state, ctx_ids)
        jax.block_until_ready(state.score)
        phases["scoring_s"] = time.time() - t0
        log(f"scoring: {phases['scoring_s']:.2f}s")

        full_bytes = state.cache.used_bytes()
        phases["full_bytes"] = full_bytes

        t0 = time.time()
        thres, true_ratio = eng.prune(state, ratio, "pair")
        jax.block_until_ready(jax.tree.leaves(state.cache))
        phases["prune_s"] = time.time() - t0
        pruned_bytes = state.cache.used_bytes()
        log(f"prune: {phases['prune_s']:.2f}s, true ratio {true_ratio:.3f}, "
            f"KV {full_bytes / 1e9:.2f} -> {pruned_bytes / 1e9:.2f} GB "
            f"({full_bytes / max(pruned_bytes, 1):.2f}x)")

        if save_state:
            try:
                from kvzip_tpu.pool import PoolInt4KV, PoolKV
                if isinstance(state.cache, (PoolKV, PoolInt4KV)):
                    os.makedirs(STATE_DIR, exist_ok=True)
                    t0 = time.time()
                    eng.save_state(state, base)
                    with open(base + ".json") as f:
                        meta = json.load(f)
                    meta.update({k: round(v, 3) for k, v in phases.items()})
                    with open(base + ".json", "w") as f:
                        json.dump(meta, f)
                    log(f"saved pruned state -> {base}.npz "
                        f"({time.time() - t0:.1f}s); future runs skip "
                        f"prefill+scoring")
            except Exception:
                import traceback
                traceback.print_exc(file=sys.stderr)

    full_bytes = phases.get("full_bytes") or state.cache.used_bytes()
    pruned_bytes = state.cache.used_bytes()

    ms_pruned = _bench_decode(eng, state, f"evict@{ratio}", decode_tokens)
    ms_full = _full_baseline_ms(eng, state, decode_tokens)

    speedup = ms_full / ms_pruned
    kv_reduction = full_bytes / max(pruned_bytes, 1)
    toks_per_s = 1.0 / ms_pruned
    log(f"decode speedup {speedup:.2f}x, KV reduction {kv_reduction:.2f}x, "
        f"{toks_per_s:.1f} tok/s post-eviction")
    out = {
        "toks_per_s": toks_per_s,
        "speedup": speedup,
        "kv_reduction": kv_reduction,
        "ms_tok_pruned": 1000.0 * ms_pruned,
        "ms_tok_full": 1000.0 * ms_full,
    }
    out.update({k: phases[k] for k in ("prefill_s", "scoring_s", "prune_s")
                if k in phases})
    if archived:
        out["archived"] = True  # phase timings from the state-creating run
    return out


# Ladder: cheap insurance first, flagship last — each completed stage prints
# a full JSON line, so the LAST complete line is always the best result the
# budget allowed. The flagship re-runs from saved state in minutes.
LADDER = [
    dict(model="llama3.2-3b", ctx=32768, wq="none", kq="none", eq="none",
         timeout=900),
    dict(model="qwen2.5-7b", ctx=131072, wq="w8a8", kq="int4", eq="int8",
         timeout=1800),
    # the reference's own headline scenario — qwen2.5-7b at 480k ctx
    # (demo.py / images/demo.png). W4A8 weights shrink the decode-constant
    # weight read to ~4 GB so the KV bytes eviction removes dominate decode.
    dict(model="qwen2.5-7b", ctx=480000, wq="w4a8", kq="int4", eq="int8",
         timeout=5400),
]


def _result_line(cfg_i, r, ratio):
    tag = "".join(f"+{v}" for v in (cfg_i["wq"], cfg_i["kq"])
                  if v != "none")
    # reference headline: 2.03x decode speedup at ratio 0.3 (demo.png)
    return {
        "metric": f"decode tokens/s/chip post-eviction (r={ratio}, "
                  f"{cfg_i['model']}{tag}, {cfg_i['ctx']} ctx); "
                  f"speedup vs full cache",
        "value": round(r["toks_per_s"], 2),
        "unit": "tokens/s",
        "vs_baseline": round(r["speedup"] / 2.03, 3),
        "detail": {k: (round(v, 3) if isinstance(v, float) else v)
                   for k, v in r.items()},
    }


def main():
    # 1024 decode tokens: each generate pays a fixed cost (host syncs +
    # query ingestion) regardless of token count; 1024 tokens amortize it
    # so ms/tok reflects the steady-state decode rate
    dec = int(os.environ.get("BENCH_DECODE", 1024))
    ratio = float(os.environ.get("BENCH_RATIO", 0.3))

    if os.environ.get("BENCH_CHILD") == "1" or "BENCH_MODEL" in os.environ \
            or "BENCH_CTX" in os.environ:
        cfg_i = dict(
            model=os.environ.get("BENCH_MODEL", "llama3.2-3b"),
            ctx=int(os.environ.get("BENCH_CTX", 32768)),
            wq=os.environ.get("BENCH_WEIGHT_QUANT", "none"),
            kq=os.environ.get("BENCH_KV_QUANT", "none"),
            eq=os.environ.get("BENCH_EMBED_QUANT", "none"))
        try:
            r = run(cfg_i["model"], cfg_i["ctx"], dec, ratio,
                    weight_quant=cfg_i["wq"], kv_quant=cfg_i["kq"],
                    embed_quant=cfg_i["eq"])
            print(json.dumps(_result_line(cfg_i, r, ratio)), flush=True)
        except Exception as e:
            import traceback
            traceback.print_exc(file=sys.stderr)
            print(json.dumps({"metric": "bench failed", "value": 0,
                              "unit": "", "vs_baseline": 0,
                              "error": str(e)}), flush=True)
            sys.exit(1)
        return

    # parent mode: run each ladder stage in a SUBPROCESS, one at a time —
    # the parent never imports JAX, so only one process holds the device,
    # and a failed config (e.g. OOM) cannot leak device memory into later
    # stages. Each successful stage's line is printed immediately; failures
    # stay on stderr so the last stdout line is always the best completed
    # result. A stage that hangs past its timeout has failed.
    import subprocess

    def run_stage(cfg_i, timeout):
        env = dict(os.environ,
                   BENCH_CHILD="1",
                   BENCH_MODEL=cfg_i["model"],
                   BENCH_CTX=str(cfg_i["ctx"]),
                   BENCH_WEIGHT_QUANT=cfg_i["wq"],
                   BENCH_KV_QUANT=cfg_i["kq"],
                   BENCH_EMBED_QUANT=cfg_i["eq"])
        try:
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__)],
                env=env, stdout=subprocess.PIPE, timeout=timeout)
        except subprocess.TimeoutExpired as e:
            log(f"stage {cfg_i['model']}/{cfg_i['ctx']} timed out: {e}")
            return None
        lines = proc.stdout.decode().strip().splitlines()
        out = json.loads(lines[-1]) if lines else None
        if out and out.get("value", 0) > 0:
            return out
        log(f"stage {cfg_i['model']}/{cfg_i['ctx']} failed: "
            f"{out.get('error') if out else 'no output'}")
        return None

    def has_state(cfg_i):
        base = _state_base(cfg_i["model"], cfg_i["ctx"], cfg_i["wq"],
                           cfg_i["kq"], cfg_i["eq"], ratio)
        return (os.path.exists(base + ".npz")
                and os.path.exists(base + ".json"))

    # FLAGSHIP-FIRST fast path: when the best stage already has a saved
    # pruned state, benching it is minutes (state load + decode), so run
    # it immediately and STOP on success — the driver parses the LAST
    # stdout line, and emitting cheaper stages afterwards would supersede
    # the flagship number. On failure, fall through to the insurance
    # ladder (cheap -> flagship) so a budget kill still leaves the best
    # completed line on stdout.
    if os.environ.get("BENCH_NO_SAVED_STATE") != "1":
        for cfg_i in reversed(LADDER):
            if has_state(cfg_i):
                # warm budget: the stage's own timeout, overridable — a
                # healthy-but-slow warm run must not be killed into paying
                # the full cold ladder
                warm = int(os.environ.get(
                    "BENCH_WARM_TIMEOUT", cfg_i.get("timeout", 3300)))
                out = run_stage(cfg_i, timeout=warm)
                if out:
                    print(json.dumps(out), flush=True)
                    return
                break

    best = None
    for cfg_i in LADDER:
        out = run_stage(cfg_i, timeout=cfg_i.get("timeout", 3300))
        if out:
            best = out
            print(json.dumps(best), flush=True)
    if best is None:
        print(json.dumps({"metric": "bench failed", "value": 0, "unit": "",
                          "vs_baseline": 0, "error": "all stages failed"}),
              flush=True)


if __name__ == "__main__":
    main()
