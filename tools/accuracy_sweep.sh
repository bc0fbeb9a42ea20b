#!/usr/bin/env bash
# One-shot accuracy sweep for the moment REAL WEIGHTS appear. Without a
# checkpoint every run uses random weights + the byte tokenizer; mount a HuggingFace
# checkpoint dir (config.json + *.safetensors + tokenizer files — bf16 or
# QServe W8A8 exports are auto-detected, kvzip_tpu/models/params.py) and run
# the config matching the checkpoint's model:
#
#     tools/accuracy_sweep.sh <config> /path/to/checkpoint [num_samples]
#
# Configs mirror BASELINE.json's five driver rows:
#   1  qwen2.5-7b     + squad                (retain sweep; 0.3 is in it)
#   2  llama3.1-8b    + NIAH needle          (evict spot-check at 0.3 + sweep)
#   3  qwen2.5-7b-1M  + scbench_kv           (non-uniform pair budgets)
#   4  llama3.1-8b    + squad --level head   (ratio 0.6, precomputed scores)
#   5  Llama3-8B-W8A8KV4 + scbench_repoqa_short (INT4 KV + INT8 W + evict)
#   all  run every config against the one checkpoint
#
# Expected vs BASELINE.md (Qwen2.5-7B-Instruct-1M reference numbers): SQuAD
# ~93% at ratio 0.2, NIAH ~100% down to 0.1, GSM8K ~61% at 0.2, RepoQA ~60%
# at 0.2; head-level operates at ratio 0.6.
#
# The ratio sweep uses kv_type=retain from ONE prefill per sample exactly as
# the reference does (eval.py:18); retain-mask and evict decode agree by
# construction (property-tested: tests/test_engine.py evict==retain). Evict
# configs additionally run a `cli test` spot-check at their operating ratio
# through the physical-compaction path.
set -euo pipefail

CONFIG=${1:?usage: tools/accuracy_sweep.sh <1|2|3|4|5|all> /path/to/ckpt [num]}
CKPT=${2:?usage: tools/accuracy_sweep.sh <1|2|3|4|5|all> /path/to/ckpt [num]}
NUM=${3:-10}
cd "$(dirname "$0")/.."
TAG=$(basename "${CKPT%/}")

run_eval () {  # run_eval <data> [extra eval flags...]
    local DATA=$1; shift
    echo "== eval $DATA ($NUM samples) $* =="
    python -m kvzip_tpu.cli eval -m "$CKPT" -d "$DATA" --num "$NUM" "$@"
    python -m kvzip_tpu.cli parse -m "$TAG" -d "$DATA" "$@"
}

spot_evict () {  # spot_evict <data> <ratio> [extra flags...]
    local DATA=$1 RATIO=$2; shift 2
    echo "== evict spot-check $DATA ratio=$RATIO $* =="
    python -m kvzip_tpu.cli test -m "$CKPT" -d "$DATA" --kv_type evict \
        --ratio "$RATIO" "$@"
}

ensure_head_scores () {
    # head-level needs precomputed (L, H) scores; the reference ships .pt
    # assets for qwen2.5-7b/14b, llama3.1-8b and duo
    mkdir -p ./head_score
    if compgen -G "/root/reference/utils/head_score/*.pt" > /dev/null; then
        cp -n /root/reference/utils/head_score/*.pt ./head_score/ || true
    fi
}

cfg1 () { run_eval squad; }
cfg2 () { run_eval needle; spot_evict needle 0.3; }
cfg3 () { run_eval scbench_kv; spot_evict scbench_kv 0.3; }
cfg4 () { ensure_head_scores; run_eval squad --level head; }
cfg5 () { run_eval scbench_repoqa_short --kv_quant int4
          spot_evict scbench_repoqa_short 0.3 --kv_quant int4; }

case "$CONFIG" in
    1) cfg1 ;;
    2) cfg2 ;;
    3) cfg3 ;;
    4) cfg4 ;;
    5) cfg5 ;;
    all) cfg1; cfg2; cfg3; cfg4; cfg5 ;;
    *) echo "unknown config '$CONFIG' (want 1..5 or all)" >&2; exit 2 ;;
esac
