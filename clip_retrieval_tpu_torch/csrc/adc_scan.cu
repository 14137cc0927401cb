// IVF-PQ asymmetric-distance scan of a chunk worklist on Hopper (sm_90a): kernel K4.
//
// Replaces the Pallas TPU kernel `clip_retrieval_tpu/ops/adc_scan.py::adc_scan`
// (body `_adc_kernel`).  Same function, from f32 inputs:
//
//   out[i, r] = Σ_m lut[owner[i], m, codes[blocks[i]·C + r, m]] + coarse[i]   for r < nvalid[i]
//   out[i, r] = −inf                                                           for r ≥ nvalid[i]
//
// over a worklist of NC chunks of C = 128 code rows each (the inverted lists
// start at multiples of C in `codes`), with the (B, M, 256) f32 look-up
// tables of the batch's queries.  The output is (NC, C) f32.
//
// Design, and what bounds it on this card:
// - The TPU kernel had no fast gather, so it expanded the codes into a
//   (C, 256·M) one-hot matrix and multiplied it with every query's LUT on the
//   MXU in bf16, then picked the owner's column with a second product.  None
//   of that carries over: here the owner's LUT sits in shared memory and each
//   thread looks up its own code row directly, in f32, so the result is exact
//   f32 (no bf16 LUT) and costs M lookups per row instead of 256·M·B MACs.
// - One thread per code row, 128 threads per block.  A block takes a run of
//   up to 16 consecutive worklist chunks.  The worklist is ordered by owner
//   (every query owns a contiguous range of chunks), so a block stages its
//   owner's LUT once and reuses it for every chunk of the run: 64 KB of LUT
//   (mostly from L2, where every query's table stays) per up to 128 KB of
//   codes, instead of 64 KB of LUT per 8 KB chunk.
// - A LUT of M sub-quantizers is M KB.  Shared memory holds 64 sub-quantizers
//   (64 KB) at a time; larger M (96..256) walks the LUT in slices of 64, and
//   the per-chunk sums live in registers across slices, so every row still
//   adds its M terms in sub-quantizer order.
// - Code rows are read straight from device memory, 16 bytes at a time when
//   M % 16 == 0 (4 or 1 byte otherwise); a warp's 32 rows are 32·M
//   contiguous bytes, read whole by the 16-byte loads of one slice.
// - Order of the sums: acc = 0, then acc += lut[m][code_m] for m = 0..M−1 in
//   f32 round-to-nearest, then + coarse.  The plain version
//   (`ops/adc_scan.py::adc_scan_reference`) adds in the same order, so the
//   two are bit-identical.
// - What bounds it: bytes.  A chunk moves C·M code bytes and 512 output
//   bytes for C·M shared-memory lookups (32 a clock per SM at best, fewer
//   under bank conflicts of random codes); at the served shapes the codes'
//   device-memory traffic is the larger of the two bounds.  This first
//   version issues its loads without a cp.async ring, so it does not hide
//   their latency behind the lookups of the previous chunk.
// - A chunk whose block index or owner lies outside the arrays gets NaN in
//   every row (no out-of-range read); a chunk with nvalid ≤ 0 is not read.
//
// Bound from Python with ctypes (plain C interface below); the wrapper is
// `clip_retrieval_tpu_torch/ops/adc_scan.py::adc_scan`.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kC = 128;      // code rows per chunk = threads per block
constexpr int kSlice = 64;   // sub-quantizers per LUT slice in shared memory (64 KB)
constexpr int kMaxRun = 16;  // worklist chunks per block

template <int VEC>
__device__ __forceinline__ float add_codes(float a, const uint8_t* __restrict__ row, const float* s_lut, int ms) {
  if (VEC == 16) {
    for (int q = 0; q < ms; q += 16) {
      const uint4 w = *reinterpret_cast<const uint4*>(row + q);
      const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const uint32_t code = (words[e >> 2] >> (8 * (e & 3))) & 0xffu;
        a = __fadd_rn(a, s_lut[(q + e) * 256 + code]);
      }
    }
  } else if (VEC == 4) {
    for (int q = 0; q < ms; q += 4) {
      const uint32_t w = *reinterpret_cast<const uint32_t*>(row + q);
#pragma unroll
      for (int e = 0; e < 4; ++e) a = __fadd_rn(a, s_lut[(q + e) * 256 + ((w >> (8 * e)) & 0xffu)]);
    }
  } else {
    for (int q = 0; q < ms; ++q) a = __fadd_rn(a, s_lut[q * 256 + row[q]]);
  }
  return a;
}

template <int VEC>
__global__ void __launch_bounds__(kC)
    adc_scan_kernel(const uint8_t* __restrict__ codes, long long n_blocks, const float* __restrict__ lut,
                    int batch, int m, const int* __restrict__ blocks, const int* __restrict__ nvalid,
                    const int* __restrict__ owner, const float* __restrict__ coarse, float* __restrict__ out, int nc,
                    int per_block) {
  extern __shared__ __align__(16) float s_lut[];  // [kSlice][256]
  const int r = threadIdx.x;
  const int i1 = min((blockIdx.x + 1) * per_block, nc);
  for (int i = blockIdx.x * per_block; i < i1;) {
    const int b = owner[i];
    int j = i + 1;
    while (j < i1 && owner[j] == b) ++j;  // [i, j): one owner's run of chunks
    const bool owner_ok = b >= 0 && b < batch;
    float acc[kMaxRun];
#pragma unroll
    for (int t = 0; t < kMaxRun; ++t) acc[t] = 0.f;
    for (int m0 = 0; m0 < m; m0 += kSlice) {
      const int ms = min(kSlice, m - m0);
      __syncthreads();  // every thread is done with the previous slice
      if (owner_ok) {
        const float4* src = reinterpret_cast<const float4*>(lut + ((size_t)b * m + m0) * 256);
        float4* dst = reinterpret_cast<float4*>(s_lut);
        for (int e = r; e < ms * 64; e += kC) dst[e] = src[e];
      }
      __syncthreads();
      if (!owner_ok) continue;
#pragma unroll
      for (int t = 0; t < kMaxRun; ++t) {
        const int c = i + t;
        if (c < j) {
          const long long blk = blocks[c];
          if (blk >= 0 && blk < n_blocks && nvalid[c] > 0)
            acc[t] = add_codes<VEC>(acc[t], codes + ((size_t)blk * kC + r) * m + m0, s_lut, ms);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < kMaxRun; ++t) {
      const int c = i + t;
      if (c < j) {
        const long long blk = blocks[c];
        float v;
        if (!owner_ok || blk < 0 || blk >= n_blocks)
          v = NAN;
        else
          v = r < nvalid[c] ? __fadd_rn(acc[t], coarse[c]) : -INFINITY;
        out[(size_t)c * kC + r] = v;
      }
    }
    i = j;
  }
}

template <int VEC>
cudaError_t launch(const void* codes, long long n_blocks, const void* lut, int batch, int m, const void* blocks,
                   const void* nvalid, const void* owner, const void* coarse, void* out, int nc,
                   cudaStream_t stream) {
  const int smem = (m < kSlice ? m : kSlice) * 256 * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(adc_scan_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // runs of 16 chunks once there are enough chunks for ~2 blocks per SM;
  // shorter runs below that keep every SM busy
  int per_block = nc / (2 * 132);
  per_block = per_block < 1 ? 1 : (per_block > kMaxRun ? kMaxRun : per_block);
  const int grid = (nc + per_block - 1) / per_block;
  adc_scan_kernel<VEC><<<grid, kC, smem, stream>>>(
      static_cast<const uint8_t*>(codes), n_blocks, static_cast<const float*>(lut), batch, m,
      static_cast<const int*>(blocks), static_cast<const int*>(nvalid), static_cast<const int*>(owner),
      static_cast<const float*>(coarse), static_cast<float*>(out), nc, per_block);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// codes: (n_blocks·128, m) uint8; lut: (batch, m, 256) f32; blocks, nvalid,
// owner: (nc,) int32; coarse: (nc,) f32; out: (nc, 128) f32 — contiguous
// device buffers.  vec: 16 when m % 16 == 0 and codes is 16-byte aligned, 4
// when m % 4 == 0 and 4-byte aligned, else 1.  Returns a cudaError_t value
// (0 on success); the caller checks it: a refused launch never runs.
int crt_adc_scan(const void* codes, long long n_blocks, const void* lut, int batch, int m, const void* blocks,
                 const void* nvalid, const void* owner, const void* coarse, void* out, int nc, int vec,
                 void* stream) {
  if (n_blocks <= 0 || batch <= 0 || m <= 0 || nc <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 16 && m % 16 == 0)
    return (int)launch<16>(codes, n_blocks, lut, batch, m, blocks, nvalid, owner, coarse, out, nc, st);
  if (vec == 4 && m % 4 == 0)
    return (int)launch<4>(codes, n_blocks, lut, batch, m, blocks, nvalid, owner, coarse, out, nc, st);
  if (vec == 1) return (int)launch<1>(codes, n_blocks, lut, batch, m, blocks, nvalid, owner, coarse, out, nc, st);
  return (int)cudaErrorInvalidValue;
}

const char* crt_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
