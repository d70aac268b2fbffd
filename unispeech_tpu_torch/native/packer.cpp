// Host kernels of the data and scoring paths, with a C interface for ctypes:
//   * batch_by_size_vec: token-budget batch packing, one linear scan over
//     length-ordered indices with bsz-multiple alignment (the scan of
//     data/batching.py's batch_by_size_plain);
//   * edit_distance / edit_distance_batch: Levenshtein distances for WER
//     scoring (decode/wer.py's edit_distance_plain).
// The port's copy of the JAX package's native/packer.cpp; native/__init__.py
// builds it with g++.

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" {

// Pack `n` length-ordered indices into batches under a token budget.
// sizes[i] is the cost of element i (aligned with the caller's order).
// Writes batch boundary end-offsets into out_ends (capacity n) and returns
// the number of batches.
int64_t batch_by_size_vec(const int64_t* sizes, int64_t n,
                          int64_t max_tokens, int64_t max_sentences,
                          int64_t bsz_mult, int64_t* out_ends) {
  int64_t n_batches = 0;
  int64_t start = 0;
  int64_t sample_len = 0;
  for (int64_t i = 0; i < n; ++i) {
    sample_len = std::max(sample_len, sizes[i]);
    int64_t num_sentences = i - start;
    int64_t num_tokens = (num_sentences + 1) * sample_len;
    bool full = num_sentences > 0 &&
                ((max_sentences > 0 && num_sentences == max_sentences) ||
                 (max_tokens > 0 && num_tokens > max_tokens));
    if (full) {
      int64_t mod = num_sentences % bsz_mult;
      int64_t take =
          num_sentences > bsz_mult ? num_sentences - mod : num_sentences;
      if (take < 1) take = 1;
      out_ends[n_batches++] = start + take;
      start += take;
      sample_len = 0;
      for (int64_t j = start; j <= i; ++j)
        sample_len = std::max(sample_len, sizes[j]);
    }
  }
  if (start < n) out_ends[n_batches++] = n;
  return n_batches;
}

// Levenshtein distance between two int32 sequences.
int64_t edit_distance(const int32_t* a, int64_t la, const int32_t* b,
                      int64_t lb) {
  if (la == 0) return lb;
  if (lb == 0) return la;
  std::vector<int64_t> prev(lb + 1), cur(lb + 1);
  for (int64_t j = 0; j <= lb; ++j) prev[j] = j;
  for (int64_t i = 1; i <= la; ++i) {
    cur[0] = i;
    for (int64_t j = 1; j <= lb; ++j) {
      int64_t sub = prev[j - 1] + (a[i - 1] != b[j - 1]);
      cur[j] = std::min({prev[j] + 1, cur[j - 1] + 1, sub});
    }
    std::swap(prev, cur);
  }
  return prev[lb];
}

// Batched edit distance: sequences are packed flat with per-row lengths.
void edit_distance_batch(const int32_t* a_flat, const int64_t* a_len,
                         const int64_t* a_off, const int32_t* b_flat,
                         const int64_t* b_len, const int64_t* b_off,
                         int64_t batch, int64_t* out) {
  for (int64_t r = 0; r < batch; ++r) {
    out[r] = edit_distance(a_flat + a_off[r], a_len[r], b_flat + b_off[r],
                           b_len[r]);
  }
}

}  // extern "C"
