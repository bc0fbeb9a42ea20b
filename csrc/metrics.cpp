// Native metric kernels for the kvzip eval harness.
//
// Ratio sweeps evaluate thousands of (prediction, reference) pairs per run
// (reference results/parse.py:106-140 loops evaluate_answer over every ratio
// and sample); rouge-L (O(n*m) LCS) and sentence-BLEU dominate. These are
// the C++ equivalents of the hot paths in results/metric.py /
// repo_qa_utils.py, exposed through cffi (see kvzip_tpu/native.py).
//
// Token ids are interned by the Python side: each metric call receives two
// int32 arrays (token-id sequences over a shared vocabulary).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <unordered_map>
#include <vector>

extern "C" {

// Longest common subsequence length between two token-id sequences.
// Rolling 1-D DP: O(n*m) time, O(min(n,m)) memory.
int32_t kvz_lcs_length(const int32_t* a, int32_t na,
                       const int32_t* b, int32_t nb) {
  if (na <= 0 || nb <= 0) return 0;
  if (nb > na) {  // keep the DP row short
    std::swap(a, b);
    std::swap(na, nb);
  }
  std::vector<int32_t> row(nb + 1, 0);
  for (int32_t i = 0; i < na; ++i) {
    int32_t prev = 0;  // row[j] from the previous iteration (i-1, j-1)
    const int32_t ai = a[i];
    for (int32_t j = 0; j < nb; ++j) {
      const int32_t tmp = row[j + 1];
      row[j + 1] = (ai == b[j]) ? prev + 1 : std::max(row[j + 1], row[j]);
      prev = tmp;
    }
  }
  return row[nb];
}

// rouge-L F1 from the LCS (beta = 1).
double kvz_rouge_l_f(const int32_t* pred, int32_t np_,
                     const int32_t* ref, int32_t nr) {
  if (np_ <= 0 || nr <= 0) return 0.0;
  const int32_t lcs = kvz_lcs_length(pred, np_, ref, nr);
  if (lcs == 0) return 0.0;
  const double p = static_cast<double>(lcs) / np_;
  const double r = static_cast<double>(lcs) / nr;
  return 2.0 * p * r / (p + r);
}

namespace {
// 64-bit rolling hash of an n-gram of int32 token ids.
inline uint64_t ngram_hash(const int32_t* t, int n) {
  uint64_t h = 1469598103934665603ull;  // FNV-1a basis
  for (int i = 0; i < n; ++i) {
    h ^= static_cast<uint64_t>(static_cast<uint32_t>(t[i]));
    h *= 1099511628211ull;
    h ^= h >> 29;
  }
  return h;
}
}  // namespace

// Smoothed sentence-BLEU (uniform 1..4-gram weights, chen-cherry method-4
// style smoothing for zero counts + brevity penalty) between token-id
// sequences. Mirrors nltk's sentence_bleu(..., method4) closely enough for
// repoqa similarity thresholds (reference repo_qa_utils.py:60-70).
double kvz_sentence_bleu(const int32_t* ref, int32_t nr,
                         const int32_t* cand, int32_t nc) {
  if (nc <= 0) return 0.0;
  double log_sum = 0.0;
  int invcnt = 0;
  for (int n = 1; n <= 4; ++n) {
    if (nc - n + 1 <= 0) {
      // method4: p_n for too-short candidates handled via smoothing below
      invcnt += 1;
      const double p = 1.0 / (2.0 * invcnt);
      log_sum += 0.25 * std::log(p);
      continue;
    }
    std::unordered_map<uint64_t, int32_t> ref_counts;
    for (int32_t i = 0; i + n <= nr; ++i) ref_counts[ngram_hash(ref + i, n)]++;
    std::unordered_map<uint64_t, int32_t> cand_counts;
    for (int32_t i = 0; i + n <= nc; ++i) cand_counts[ngram_hash(cand + i, n)]++;
    int64_t overlap = 0, total = 0;
    for (const auto& kv : cand_counts) {
      total += kv.second;
      auto it = ref_counts.find(kv.first);
      if (it != ref_counts.end())
        overlap += std::min(kv.second, it->second);
    }
    double p;
    if (overlap == 0) {
      // method4: 1 / (invcnt * ln-scaled candidate length)
      invcnt += 1;
      double scale = 5.0 / std::log(static_cast<double>(nc) + 1.0);
      p = 1.0 / (static_cast<double>(total) * std::max(scale * invcnt, 1.0));
    } else {
      p = static_cast<double>(overlap) / static_cast<double>(total);
    }
    log_sum += 0.25 * std::log(p);
  }
  const double bp =
      (nc >= nr) ? 1.0
                 : std::exp(1.0 - static_cast<double>(nr) /
                                      static_cast<double>(nc));
  return bp * std::exp(log_sum);
}

// Token-level F1 over bags of token ids (reference metric.py:66-78).
double kvz_token_f1(const int32_t* pred, int32_t np_,
                    const int32_t* ref, int32_t nr) {
  if (np_ <= 0 || nr <= 0) return 0.0;
  std::unordered_map<int32_t, int32_t> pc, rc;
  for (int32_t i = 0; i < np_; ++i) pc[pred[i]]++;
  for (int32_t i = 0; i < nr; ++i) rc[ref[i]]++;
  int64_t same = 0;
  for (const auto& kv : pc) {
    auto it = rc.find(kv.first);
    if (it != rc.end()) same += std::min(kv.second, it->second);
  }
  if (same == 0) return 0.0;
  const double precision = static_cast<double>(same) / np_;
  const double recall = static_cast<double>(same) / nr;
  return 2.0 * precision * recall / (precision + recall);
}

}  // extern "C"
