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
// - Order of the sums: acc = 0, then acc += lut[m][code_m] for m = 0..M−1 in
//   f32 round-to-nearest, then + coarse.  The plain version
//   (`ops/adc_scan.py::adc_scan_reference`) adds in the same order, so the
//   two are bit-identical.  A row's running sum may move between lanes from
//   one group of 16 sub-quantizers to the next (below), never its order.
// - What bounds it: a chunk moves C·M code bytes and 512 output bytes for
//   C·M shared-memory lookups.  All 32 lanes of a warp read one 256-entry
//   table at random positions, so bank conflicts (about 3.5 requests on the
//   busiest bank) cut the lookup rate to about 9 of 32 a clock per SM; at the
//   served shapes that floor and the codes' device-memory traffic are of the
//   same order, and the kernel has to overlap the two.
// - Work split: the grid is sized from the kernel's occupancy on this card
//   (kWaves waves of resident blocks), and each block takes one contiguous
//   span of ⌈NC / grid⌉ worklist chunks (at least kMinSpan where that still
//   fills one wave, so that a LUT copy feeds that many; at least kMinPer).
//   The worklist is ordered by owner, so a span holds few owner runs; the
//   block stages the owner's LUT once per run inside its span (a run may be
//   split across blocks).  A run whose chunks are all empty (nvalid ≤ 0, the
//   static budget's tail) stages nothing: its rows are written −inf in one
//   flat pass, every thread on consecutive floats, since such chunks make
//   up half to four fifths of a served worklist.  The empty
//   tails make the spans' work uneven; the many short spans of 8 waves let
//   the SMs whose spans were empty take further blocks.
// - Route (a), M ≤ 64: the whole f32 LUT (≤ 64 KB) stays in shared memory.
//   256 threads in two groups of 128, each group on its own chunk, so one
//   LUT copy feeds 8 warps and an SM holds 3 blocks (24 warps) to cover the
//   conflicted lookups.  The LUT is staged with cp.async in slices of 16
//   sub-quantizers (16 KB), one commit group each: the lookups of slice s
//   start while slices s+1.. are still landing.  With 16-byte codes (M % 16
//   == 0, aligned) the codes stay in registers: a group loads its next
//   chunk's codes before the current chunk's lookups, and the chunk's
//   scalars (block, nvalid, coarse) a step before that, so neither latency
//   stands in the way of the lookups.  The loads are coalesced (each warp
//   reads its 32 rows as 512-byte pieces, not 64-byte rows a lane); a lane
//   then holds one 16-code quad of each of 4 rows, and a row's running sum
//   follows its quads by one warp shuffle per 16 sub-quantizers (`Lanes`).
//   Rows read one per lane (16-byte loads at a 64-byte stride) cost four
//   times the L1 wavefronts, on the pipe the lookups need.
// - Route (b), M > 64: the LUT is walked in slices of 64 sub-quantizers; the
//   sums of a run of up to kMaxRun chunks live in registers across slices, so
//   every row still adds its M terms in sub-quantizer order.  128 threads,
//   one row each, code rows read straight from device memory.
// - A chunk whose block index or owner lies outside the arrays gets NaN in
//   every row (no out-of-range read); a chunk with nvalid ≤ 0 is not read.
//
// Bound from Python with ctypes (plain C interface below); the wrapper is
// `clip_retrieval_tpu_torch/ops/adc_scan.py::adc_scan`.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kC = 128;       // code rows per chunk
constexpr int kResM = 64;     // route (a): sub-quantizers whose whole LUT stays in shared memory (64 KB)
constexpr int kSliceM = 16;   // route (a): sub-quantizers per cp.async commit group (16 KB)
constexpr int kThreads = 256; // route (a): groups of 128 threads, one chunk each
constexpr int kSlice = 64;    // route (b): sub-quantizers per LUT slice in shared memory (64 KB)
constexpr int kMaxRun = 16;   // route (b): worklist chunks per block (sums held in registers)
constexpr int kWaves = 8;     // blocks launched per resident block slot
constexpr int kMinSpan = 8;   // route (a): chunks a LUT copy should feed, where the worklist allows
constexpr int kMinPer = kThreads / kC;  // route (a): least chunks per block (one per group)

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most n of this thread's commit groups are still in flight
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::); break;
  }
}

// 16 sub-quantizers of one row whose codes are the 16 bytes of w
__device__ __forceinline__ float add_quad(float a, const uint4 w, const float* s_lut) {
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int e = 0; e < 16; ++e) a = __fadd_rn(a, s_lut[e * 256 + ((words[e >> 2] >> (8 * (e & 3))) & 0xffu)]);
  return a;
}

// sub-quantizers [m0, m1) of one row, codes read from device memory (s_lut indexed from sub-quantizer 0)
template <int VEC>
__device__ __forceinline__ float add_range(float a, const uint8_t* __restrict__ row, const float* s_lut, int m0,
                                           int m1) {
  if (VEC == 16) {
    for (int q = m0; q < m1; q += 16) a = add_quad(a, __ldg(reinterpret_cast<const uint4*>(row + q)), s_lut + q * 256);
  } else if (VEC == 4) {
    for (int q = m0; q < m1; q += 4) {
      const uint32_t w = __ldg(reinterpret_cast<const unsigned int*>(row + q));
#pragma unroll
      for (int e = 0; e < 4; ++e) a = __fadd_rn(a, s_lut[(q + e) * 256 + ((w >> (8 * e)) & 0xffu)]);
    }
  } else {
    for (int q = m0; q < m1; ++q) a = __fadd_rn(a, s_lut[q * 256 + __ldg(row + q)]);
  }
  return a;
}

// One owner run of a block's span: chunks [i, end) share owner[i]; any: some
// chunk of them has rows.  Every warp computes it alike, 32 chunks a step.
struct Run {
  int end;
  bool any;
};

__device__ __forceinline__ Run owner_run(const int* __restrict__ owner, const int* __restrict__ nvalid, int i,
                                         int s1) {
  const int lane = threadIdx.x & 31;
  const int b = owner[i];
  bool found = false;
  for (int base = i; base < s1; base += 32) {
    const int c = base + lane;
    const unsigned other = __ballot_sync(0xffffffffu, c < s1 && owner[c] != b);
    const int end = other ? base + __ffs(other) - 1 : min(base + 32, s1);
    found |= __any_sync(0xffffffffu, c < end && nvalid[c] > 0);
    if (other) return {end, found};
  }
  return {s1, found};
}

// A worklist chunk's scalars; past the run's end, an empty chunk.
struct Chunk {
  long long blk;
  int nv;
  float co;
};

__device__ __forceinline__ Chunk chunk_at(const int* __restrict__ blocks, const int* __restrict__ nvalid,
                                          const float* __restrict__ coarse, int c, int j) {
  if (c >= j) return {0, 0, 0.f};
  return {blocks[c], nvalid[c], coarse[c]};
}

// The 16-byte code quads a thread holds for its warp's 32 rows of a chunk
// (nq quads of 16 codes per row, m = 16·nq).  With nq ∈ {1, 2, 4} the loads
// are coalesced: load i of the warp reads the 512 contiguous bytes of rows
// 32i/nq.., lane L = nq·g + k taking quad (k + i) mod nq of row 32i/nq + g.
// In phase q (sub-quantizers 16q..16q+15) lane L then holds quad q of row
// (32/nq)·((q − k) mod nq) + g, in register (q − k) mod nq; from one phase
// to the next a row moves to lane nq·g + (k + 1) mod nq, so its running sum
// follows it by one shuffle and every row still adds its terms in
// sub-quantizer order.  With nq = 3 each lane reads its own row.
struct Lanes {
  int lane, k, g;
  bool coalesced;
  __device__ __forceinline__ Lanes(int r, int nq)
      : lane(r & 31), k(0), g(r & 31), coalesced((nq & (nq - 1)) == 0) {
    if (coalesced) {
      k = lane & (nq - 1);
      g = lane / nq;
    }
  }
  // register of phase q's quad
  __device__ __forceinline__ int slot(int q, int nq) const { return coalesced ? (q - k) & (nq - 1) : q; }
  // the row (0..127) this thread sums in the last phase, when its sum is complete
  __device__ __forceinline__ int last_row(int r, int nq) const {
    return coalesced ? (r - lane) + (32 / nq) * ((nq - 1 - k) & (nq - 1)) + g : r;
  }
};

__device__ __forceinline__ void load_codes(uint4 (&w)[4], const uint8_t* __restrict__ block, int r, int nq,
                                           const Lanes& ln) {
  if (ln.coalesced) {
    const uint4* rows = reinterpret_cast<const uint4*>(block) + (r - ln.lane) * nq;  // the warp's 32 rows
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i < nq) w[i] = __ldg(rows + 32 * i + nq * ln.g + ((ln.k + i) & (nq - 1)));
  } else {
    const uint4* row = reinterpret_cast<const uint4*>(block) + r * nq;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i < nq) w[i] = __ldg(row + i);
  }
}

__device__ __forceinline__ uint4 pick(const uint4 (&w)[4], int s) {
  uint4 v = w[0];
  if (s == 1) v = w[1];
  if (s == 2) v = w[2];
  if (s == 3) v = w[3];
  return v;
}

// Route (a): M ≤ 64, the owner's whole LUT resident; see the notes above.
// kGroups groups of 128 threads take kGroups consecutive chunks at a time.
template <int VEC>
__global__ void __launch_bounds__(kThreads, kThreads >= 384 ? 2 : 3)
    adc_resident_kernel(const uint8_t* __restrict__ codes, long long n_blocks, const float* __restrict__ lut,
                        int batch, int m, const int* __restrict__ blocks, const int* __restrict__ nvalid,
                        const int* __restrict__ owner, const float* __restrict__ coarse, float* __restrict__ out,
                        int nc, int per_block) {
  constexpr int kGroups = kThreads / kC;
  extern __shared__ __align__(16) float s_lut[];  // [m][256]
  const int r = threadIdx.x % kC, h = threadIdx.x / kC;
  const int ns = (m + kSliceM - 1) / kSliceM;  // commit groups of the LUT copy, ≤ 4
  const int nq = m / 16;                       // 16-byte quads per code row (VEC 16)
  const Lanes ln(r, VEC == 16 ? nq : 1);
  const int ro = VEC == 16 ? ln.last_row(r, nq) : r;  // the row whose sum this thread completes
  const int src = (ln.lane & ~(nq - 1)) | ((ln.k + nq - 1) & (nq - 1));  // the lane a row comes from
  const int s0 = blockIdx.x * per_block, s1 = min(s0 + per_block, nc);
  auto block_of = [&](const Chunk& k) { return codes + (size_t)k.blk * kC * m; };
  uint4 cur[4], nxt[4];
  // phase q of a 16-byte-code row: its running sum moves in from the lane that held it, then 16 lookups
  auto phase = [&](float a, int q) {
    if (q > 0 && ln.coalesced && nq > 1) a = __shfl_sync(0xffffffffu, a, src);
    return add_quad(a, pick(cur, ln.slot(q, nq)), s_lut + q * kSliceM * 256);
  };
  for (int i = s0; i < s1;) {
    const Run run = owner_run(owner, nvalid, i, s1);
    const int j = run.end;
    const int b = owner[i];
    const bool owner_ok = b >= 0 && b < batch;
    if (!owner_ok || !run.any) {  // nothing to look up: every row is −inf (NaN where out of range), written flat
      for (long long e = (long long)i * kC + threadIdx.x; e < (long long)j * kC; e += kThreads) {
        const long long blk = blocks[e / kC];
        out[e] = !owner_ok || blk < 0 || blk >= n_blocks ? NAN : -INFINITY;
      }
      i = j;
      continue;
    }
    auto scanned = [&](const Chunk& k) { return k.nv > 0 && k.blk >= 0 && k.blk < n_blocks; };
    __syncthreads();  // every thread is done with the previous run's LUT
    const float* src_lut = lut + (size_t)b * m * 256;
    for (int s = 0; s < ns; ++s) {
      const int e0 = s * kSliceM * 64, e1 = min(s * kSliceM + kSliceM, m) * 64;  // 16-byte pieces
      for (int e = e0 + threadIdx.x; e < e1; e += kThreads) cp_async16(s_lut + 4 * e, src_lut + 4 * e);
      cp_async_commit();
    }
    // this group's chunks c, c + kGroups, ...: the scalars two steps ahead of the lookups, the codes one step
    int c = i + h;
    Chunk k0 = chunk_at(blocks, nvalid, coarse, c, j), k1 = chunk_at(blocks, nvalid, coarse, c + kGroups, j);
    if (VEC == 16 && scanned(k0)) load_codes(cur, block_of(k0), r, nq, ln);
    const int steps = (j - i + kGroups - 1) / kGroups;
    for (int p = 0; p < steps; ++p) {
      const Chunk k2 = chunk_at(blocks, nvalid, coarse, c + 2 * kGroups, j);
      if (VEC == 16 && scanned(k1)) load_codes(nxt, block_of(k1), r, nq, ln);
      const bool scan = scanned(k0);  // uniform over the group
      float a = 0.f;
      if (p == 0) {  // the LUT is still landing: slice s waits for its own commit group only
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          if (s < ns) {
            cp_async_wait_pending(ns - 1 - s);
            __syncthreads();
            if (scan) {
              if (VEC == 16)
                a = phase(a, s);
              else
                a = add_range<VEC>(a, block_of(k0) + (size_t)r * m, s_lut, s * kSliceM,
                                   min(s * kSliceM + kSliceM, m));
            }
          }
        }
      } else if (scan) {
        if (VEC == 16) {
#pragma unroll
          for (int s = 0; s < 4; ++s)
            if (s < nq) a = phase(a, s);
        } else {
          a = add_range<VEC>(a, block_of(k0) + (size_t)r * m, s_lut, 0, m);
        }
      }
      if (c < j) {
        float v;
        if (k0.blk < 0 || k0.blk >= n_blocks)
          v = NAN;
        else
          v = ro < k0.nv ? __fadd_rn(a, k0.co) : -INFINITY;
        out[(size_t)c * kC + ro] = v;
      }
      c += kGroups;
      k0 = k1;
      k1 = k2;
      if (VEC == 16) {
#pragma unroll
        for (int q = 0; q < 4; ++q) cur[q] = nxt[q];
      }
    }
    i = j;
  }
}

// Route (b): M > 64, the LUT walked in slices of kSlice sub-quantizers.
template <int VEC>
__global__ void __launch_bounds__(kC)
    adc_sliced_kernel(const uint8_t* __restrict__ codes, long long n_blocks, const float* __restrict__ lut,
                      int batch, int m, const int* __restrict__ blocks, const int* __restrict__ nvalid,
                      const int* __restrict__ owner, const float* __restrict__ coarse, float* __restrict__ out, int nc,
                      int per_block) {
  extern __shared__ __align__(16) float s_lut[];  // [kSlice][256]
  const int r = threadIdx.x;
  const int s1 = min((blockIdx.x + 1) * per_block, nc);
  for (int i = blockIdx.x * per_block; i < s1;) {
    // [i, j): one owner's run of chunks, j − i ≤ per_block ≤ kMaxRun; a serial scan (route (a)'s warp-wide
    // `owner_run` made ptxas spill the sums here)
    const int b = owner[i];
    int j = i + 1;
    bool any = nvalid[i] > 0;
    while (j < s1 && owner[j] == b) any |= nvalid[j++] > 0;
    const bool owner_ok = b >= 0 && b < batch;
    const bool stage = owner_ok && any;
    float acc[kMaxRun];
#pragma unroll
    for (int t = 0; t < kMaxRun; ++t) acc[t] = 0.f;
    for (int m0 = 0; stage && m0 < m; m0 += kSlice) {
      const int ms = min(kSlice, m - m0);
      __syncthreads();  // every thread is done with the previous slice
      const float4* src = reinterpret_cast<const float4*>(lut + ((size_t)b * m + m0) * 256);
      float4* dst = reinterpret_cast<float4*>(s_lut);
      for (int e = r; e < ms * 64; e += kC) dst[e] = src[e];
      __syncthreads();
#pragma unroll
      for (int t = 0; t < kMaxRun; ++t) {
        const int c = i + t;
        if (c < j) {
          const long long blk = blocks[c];
          if (blk >= 0 && blk < n_blocks && nvalid[c] > 0)
            acc[t] = add_range<VEC>(acc[t], codes + ((size_t)blk * kC + r) * m + m0, s_lut, 0, ms);
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

// Chunks per block: kWaves waves of the blocks the card holds at once, but
// at least min_span chunks (so that one LUT copy feeds that many) where the
// worklist fills one wave of blocks at that span (a smaller one, such as a
// single query's, keeps every block it can); then at least min_per and at
// most max_per (0: no cap).
template <typename Kernel>
cudaError_t split(Kernel kernel, int threads, int smem, int nc, int min_span, int min_per, int max_per, int* per,
                  int* grid) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, fit = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel, threads, smem)) != cudaSuccess) return err;
  const long long resident = (long long)(fit > 0 ? fit : 1) * sms;
  long long p = (nc + kWaves * resident - 1) / (kWaves * resident);
  if ((nc + resident - 1) / resident >= min_span && p < min_span) p = min_span;
  if (p < min_per) p = min_per;
  if (max_per > 0 && p > max_per) p = max_per;
  *per = (int)p;
  *grid = (int)((nc + p - 1) / p);
  return cudaSuccess;
}

template <int VEC>
cudaError_t launch(const void* codes, long long n_blocks, const void* lut, int batch, int m, const void* blocks,
                   const void* nvalid, const void* owner, const void* coarse, void* out, int nc,
                   cudaStream_t stream) {
  const auto* c8 = static_cast<const uint8_t*>(codes);
  const auto* lf = static_cast<const float*>(lut);
  const auto *bl = static_cast<const int*>(blocks), *nv = static_cast<const int*>(nvalid);
  const auto* ow = static_cast<const int*>(owner);
  const auto* co = static_cast<const float*>(coarse);
  auto* o = static_cast<float*>(out);
  int per = 0, grid = 0;
  cudaError_t err;
  if (m <= kResM) {
    const int smem = m * 256 * (int)sizeof(float);
    if ((err = split(adc_resident_kernel<VEC>, kThreads, smem, nc, kMinSpan, kMinPer, 0, &per, &grid)) != cudaSuccess)
      return err;
    adc_resident_kernel<VEC><<<grid, kThreads, smem, stream>>>(c8, n_blocks, lf, batch, m, bl, nv, ow, co, o, nc, per);
  } else {
    const int smem = kSlice * 256 * (int)sizeof(float);
    if ((err = split(adc_sliced_kernel<VEC>, kC, smem, nc, 1, 1, kMaxRun, &per, &grid)) != cudaSuccess) return err;
    adc_sliced_kernel<VEC><<<grid, kC, smem, stream>>>(c8, n_blocks, lf, batch, m, bl, nv, ow, co, o, nc, per);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// codes: (n_blocks·128, m) uint8; lut: (batch, m, 256) f32, 16-byte aligned;
// blocks, nvalid, owner: (nc,) int32; coarse: (nc,) f32; out: (nc, 128) f32
// — contiguous device buffers.  vec: 16 when m % 16 == 0 and codes is
// 16-byte aligned, 4 when m % 4 == 0 and 4-byte aligned, else 1.  The route
// follows from m alone (the whole LUT in shared memory for m ≤ 64, slices of
// it above).  Returns a cudaError_t value (0 on success); the caller checks
// it: a refused launch never runs.
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
