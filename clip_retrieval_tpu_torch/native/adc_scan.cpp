// Native ADC scan for IVF-PQ host-path search (mmap'd indices beyond the
// device-memory cap).  Copy of `clip_retrieval_tpu/native/adc_scan.cpp`.
//
// Plays the role of FAISS's C++ IndexIVFPQ scan loop, which the reference
// gets for free via faiss (the reference's clip_retrieval/clip_back.py:362).
// Device-resident indices scan on the GPU (kernel K4, csrc/adc_scan.cu);
// this covers the memory-mapped tier where the scan must run on the host
// against disk-backed pages.
//
// score[i] = sum_m lut[m][codes[i][m]]   (+ caller-added coarse term)
//
// Layout: codes row-major (n, m) uint8; lut row-major (m, 256) float32.
// OpenMP over rows; the inner loop is a pure table gather that vectorizes
// with AVX2 gathers where available (-march=native).

#include <algorithm>
#include <cstdint>
#include <cstddef>
#include <queue>
#include <utility>
#include <vector>

extern "C" {

// Score one contiguous code block.
void adc_scan_block(const uint8_t* codes, int64_t n, int32_t m,
                    const float* lut, float base, float* out) {
#pragma omp parallel for schedule(static) if (n > 4096)
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* row = codes + i * m;
    float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;
    int32_t j = 0;
    for (; j + 4 <= m; j += 4) {
      acc0 += lut[(size_t)(j + 0) * 256 + row[j + 0]];
      acc1 += lut[(size_t)(j + 1) * 256 + row[j + 1]];
      acc2 += lut[(size_t)(j + 2) * 256 + row[j + 2]];
      acc3 += lut[(size_t)(j + 3) * 256 + row[j + 3]];
    }
    float acc = (acc0 + acc1) + (acc2 + acc3);
    for (; j < m; ++j) acc += lut[(size_t)j * 256 + row[j]];
    out[i] = acc + base;
  }
}

// Scan multiple inverted lists for one query.
//   offsets: (nlist+1) CSR offsets into codes/ids
//   probes:  (n_probe) list ids to scan
//   coarse:  (n_probe) per-list additive term (q · centroid)
// Writes concatenated scores and copies ids; returns total candidates.
int64_t adc_scan_lists(const uint8_t* codes, const int64_t* ids,
                       const int64_t* offsets, const int32_t* probes,
                       int32_t n_probe, const float* lut, int32_t m,
                       const float* coarse, float* out_scores,
                       int64_t* out_ids) {
  int64_t cursor = 0;
  for (int32_t p = 0; p < n_probe; ++p) {
    const int64_t s = offsets[probes[p]];
    const int64_t e = offsets[probes[p] + 1];
    const int64_t len = e - s;
    if (len <= 0) continue;
    adc_scan_block(codes + s * m, len, m, lut, coarse[p], out_scores + cursor);
    for (int64_t i = 0; i < len; ++i) out_ids[cursor + i] = ids[s + i];
    cursor += len;
  }
  return cursor;
}

// Batched top-k ADC search: one call per query batch, OpenMP over queries
// (each query's probed lists are disjoint work; per-query parallelism maps
// to serving's micro-batched request shape better than per-block threads).
//   probes: (batch, n_probe) list ids; coarse: (batch, n_probe) q·centroid
//   luts:   (batch, m, 256) float32
//   out_vals/out_ids: (batch, k), pre-filled by the callee with -inf / -1
void adc_search_batch(const uint8_t* codes, const int64_t* ids,
                      const int64_t* offsets, const int32_t* probes,
                      int32_t n_probe, const float* luts, int32_t m,
                      const float* coarse, int32_t batch, int32_t k,
                      float* out_vals, int64_t* out_ids) {
  if (k <= 0) return;  // empty-heap top() below would be UB
#pragma omp parallel
  {
    std::vector<float> scratch;  // per-thread block-score buffer
#pragma omp for schedule(dynamic)
    for (int32_t b = 0; b < batch; ++b) {
      const float* lut = luts + (size_t)b * m * 256;
      const int32_t* my_probes = probes + (size_t)b * n_probe;
      const float* my_coarse = coarse + (size_t)b * n_probe;
      // min-heap of the k best (score, position) pairs
      using Entry = std::pair<float, int64_t>;
      std::priority_queue<Entry, std::vector<Entry>, std::greater<Entry>> heap;
      for (int32_t p = 0; p < n_probe; ++p) {
        const int64_t s = offsets[my_probes[p]];
        const int64_t e = offsets[my_probes[p] + 1];
        const int64_t len = e - s;
        if (len <= 0) continue;
        if ((int64_t)scratch.size() < len) scratch.resize(len);
        // reuse the vectorized block scorer, single-threaded inside a
        // parallel region (its `if (n > 4096)` clause stays serial here)
        adc_scan_block(codes + s * m, len, m, lut, my_coarse[p],
                       scratch.data());
        for (int64_t i = 0; i < len; ++i) {
          const float sc = scratch[i];
          if ((int64_t)heap.size() < k) {
            heap.emplace(sc, s + i);
          } else if (sc > heap.top().first) {
            heap.pop();
            heap.emplace(sc, s + i);
          }
        }
      }
      int64_t n_found = (int64_t)heap.size();
      float* ov = out_vals + (size_t)b * k;
      int64_t* oi = out_ids + (size_t)b * k;
      for (int64_t i = n_found - 1; i >= 0; --i) {  // ascending pop → desc out
        ov[i] = heap.top().first;
        oi[i] = ids[heap.top().second];
        heap.pop();
      }
    }
  }
}

}  // extern "C"
