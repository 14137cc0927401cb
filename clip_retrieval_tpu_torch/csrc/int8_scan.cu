// Fused gather-scan of the IVF-int8 probed union on Hopper (sm_90a): kernel K3.
//
// Replaces the Pallas TPU kernel `clip_retrieval_tpu/ops/int8scan.py::
// int8_gather_scan` (body `_scan_kernel`, one grid step per selected chunk with
// the chunk index in scalar prefetch).  Same result, bit for bit: for each
// position i of the selection `sel` (U,) into the chunked CSR image
// rows (nchunks, Lc, d) int8,
//   acc[b, j]         = sum_k qq[b, k] * rows[sel[i], j, k]            int32, exact
//   out[b, i*Lc + j]  = (f32(acc) * q_scale[b]) * scales[sel[i], j]   two f32 roundings, in that order
//   out[b, i*Lc + j]  = -inf where pos[sel[i], j] < 0                  padding rows
// into a (B, U*Lc) f32 output.  The int32 sums are exact in any order, and the
// epilogue rounds as the JAX kernel and the plain version do, so the kernel and
// `int8_gather_scan_reference` agree exactly.
//
// Design, and what bounds it on this card:
// - Bytes bound it, not operations.  Every selected row is read once
//   (U*Lc*d bytes, plus 8 bytes of scale and position per row) and B*U*Lc*4
//   bytes of scores are written.  At the served shape (B=32, d=768) that is
//   ~900 bytes per row against 2*32*768 int8 operations: ~54 operations per
//   byte, far below the ~590 at which the int8 tensor cores would be the limit
//   (1,979 TOP/s over 3.35 TB/s).  So the design keeps the row stream moving
//   and never copies the union: the gather and the product are one pass.
// - One block per selected chunk (grid.x = U) and per 16/32/64 query rows
//   (grid.y).  The block reads sel[i] itself (no scalar prefetch here), loads
//   its query rows once into shared memory (zero past B and past d), then
//   streams the chunk in tiles of 64 rows x 128 bytes of d through a 4-stage
//   cp.async ring, so ~24 KB per block are in flight while the tensor cores
//   work on the previous stage.  The (tile, d-slice) sequence is one flat
//   pipeline, so it does not drain between the chunk's row tiles.
// - Product: `mma.sync.m16n8k32.s32.s8.s8.s32`, A = 16 query rows, B = 8 chunk
//   rows (stored row-major along d, i.e. exactly the "col" operand).  Each of
//   the 4 warps owns 16 chunk rows of a tile.  d is zero-padded on chip to a
//   multiple of 128; shared-memory row strides are 16 mod 32 bytes, so the
//   32-bit fragment loads of a warp hit 32 distinct banks.
// - Epilogue from the accumulators: the two f32 multiplies (__fmul_rn: no
//   contraction), then the mask, stored straight to the score buffer; the
//   two stores of each column pair fill whole 32-byte sectors of 8 score rows.
// - A selection outside [0, nchunks) writes NaN scores for that chunk rather
//   than reading outside the image.
//
// Bound from Python with ctypes (plain C interface below); the wrapper is
// `clip_retrieval_tpu_torch/ops/int8scan.py::int8_gather_scan`.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;       // 4 warps
constexpr int kTileRows = 64;       // chunk rows per tile: 16 per warp
constexpr int kSlice = 128;         // bytes of d per pipeline stage
constexpr int kStages = 4;          // cp.async ring depth
constexpr int kLdR = kSlice + 16;   // shared row stride of a stage (16 mod 32)
constexpr int kMaxD = 2048;         // the largest d the wrapper passes

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8_16832(int (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Bytes [c, c+16) of row r of a (nrows, d) int8 matrix into shared `dst`, zero
// where r >= nrows or a column >= d.  vec: cp.async (d % 16 == 0, 16-byte
// aligned base, so a 16-byte piece is all inside d or all outside); otherwise
// plain byte loads.
__device__ __forceinline__ void load16(int8_t* dst, const int8_t* base, int r, int nrows, int c, int d, bool vec) {
  if (vec) {
    const bool ok = r < nrows && c < d;
    cp_async16(dst, ok ? base + (size_t)r * d + c : base, ok ? 16 : 0);
  } else {
#pragma unroll
    for (int e = 0; e < 16; ++e)
      dst[e] = (r < nrows && c + e < d) ? base[(size_t)r * d + c + e] : int8_t(0);
  }
}

// MT 16-row query tiles per block.
template <int MT>
__global__ void __launch_bounds__(kThreads)
    int8_scan_kernel(const int8_t* __restrict__ qq, const float* __restrict__ q_scale,
                     const int8_t* __restrict__ rows, const float* __restrict__ scales,
                     const int32_t* __restrict__ pos, const int32_t* __restrict__ sel, float* __restrict__ out,
                     int batch, int d, int lc, int nchunks, int u, int dk, int vec) {
  constexpr int BM = 16 * MT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldq = dk + 16;
  int8_t* sQ = reinterpret_cast<int8_t*>(smem_raw);  // [BM][ldq]
  int8_t* sR = sQ + BM * ldq;                         // [kStages][kTileRows][kLdR]

  const int i = blockIdx.x;
  const int b0 = blockIdx.y * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;  // mma fragment row group / column group
  const size_t out_stride = (size_t)u * lc;
  float* out_i = out + (size_t)i * lc;

  const int c = sel[i];
  if (c < 0 || c >= nchunks) {
    for (int idx = threadIdx.x; idx < BM * lc; idx += kThreads) {
      const int m = idx / lc, j = idx % lc;
      if (b0 + m < batch) out_i[(size_t)(b0 + m) * out_stride + j] = __int_as_float(0x7fc00000);
    }
    return;
  }
  const bool use_vec = vec != 0;
  const int8_t* chunk = rows + (size_t)c * lc * d;
  const float* cscale = scales + (size_t)c * lc;
  const int32_t* cpos = pos + (size_t)c * lc;
  const int nslices = dk / kSlice;
  const int total = ((lc + kTileRows - 1) / kTileRows) * nslices;

  // the block's query rows, all of d (they join the first cp.async group)
  const int qpieces = dk / 16;
  for (int idx = threadIdx.x; idx < BM * qpieces; idx += kThreads) {
    const int r = idx / qpieces, cc = (idx % qpieces) * 16;
    load16(sQ + r * ldq + cc, qq, b0 + r, batch, cc, d, use_vec);
  }

  // step `it` of the flat pipeline = row tile it / nslices, d-slice it % nslices
  auto load_stage = [&](int it) {
    const int t = it / nslices, s = it % nslices;
    int8_t* dst = sR + (it % kStages) * (kTileRows * kLdR);
    constexpr int kPieces = kSlice / 16;
    for (int idx = threadIdx.x; idx < kTileRows * kPieces; idx += kThreads) {
      const int r = idx / kPieces, cc = (idx % kPieces) * 16;
      load16(dst + r * kLdR + cc, chunk, t * kTileRows + r, lc, s * kSlice + cc, d, use_vec);
    }
  };

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < total) load_stage(st);
    cp_async_commit();  // empty groups keep the group count uniform
  }

  int acc[MT][2][4];
  for (int it = 0; it < total; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage `it` visible to all; stage it-1 consumed by all
    if (it + kStages - 1 < total) load_stage(it + kStages - 1);
    cp_async_commit();

    const int t = it / nslices, s = it % nslices;
    if (s == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;
    }
    const int8_t* tile = sR + (it % kStages) * (kTileRows * kLdR) + (warp * 16) * kLdR;
#pragma unroll
    for (int kk = 0; kk < kSlice; kk += 32) {
      uint32_t bf[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int8_t* p = tile + (nt * 8 + g) * kLdR + kk + 4 * t4;
        bf[nt][0] = *reinterpret_cast<const uint32_t*>(p);
        bf[nt][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int8_t* p = sQ + (mt * 16 + g) * ldq + s * kSlice + kk + 4 * t4;
        uint32_t af[4];
        af[0] = *reinterpret_cast<const uint32_t*>(p);
        af[1] = *reinterpret_cast<const uint32_t*>(p + 8 * ldq);
        af[2] = *reinterpret_cast<const uint32_t*>(p + 16);
        af[3] = *reinterpret_cast<const uint32_t*>(p + 8 * ldq + 16);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) mma_s8_16832(acc[mt][nt], af, bf[nt][0], bf[nt][1]);
      }
    }

    if (s == nslices - 1) {  // row tile t complete: dequantize, mask, store
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = t * kTileRows + warp * 16 + nt * 8 + 2 * t4 + e;
          if (j >= lc) continue;
          const float rs = cscale[j];
          const bool valid = cpos[j] >= 0;
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int b = b0 + mt * 16 + g + 8 * h;
              if (b < batch) {
                const float v = __fmul_rn(__fmul_rn(__int2float_rn(acc[mt][nt][2 * h + e]), q_scale[b]), rs);
                out_i[(size_t)b * out_stride + j] = valid ? v : -INFINITY;
              }
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();  // no cp.async may outlive the block
}

template <int MT>
int launch(const void* qq, const void* q_scale, const void* rows, const void* scales, const void* pos,
           const void* sel, void* out, int batch, int d, int lc, int nchunks, int u, int vec, cudaStream_t st) {
  const int dk = (d + kSlice - 1) / kSlice * kSlice;
  const size_t smem = (size_t)16 * MT * (dk + 16) + (size_t)kStages * kTileRows * kLdR;
  cudaError_t err = cudaFuncSetAttribute(int8_scan_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(u, (batch + 16 * MT - 1) / (16 * MT));
  int8_scan_kernel<MT><<<grid, kThreads, smem, st>>>(
      static_cast<const int8_t*>(qq), static_cast<const float*>(q_scale), static_cast<const int8_t*>(rows),
      static_cast<const float*>(scales), static_cast<const int32_t*>(pos), static_cast<const int32_t*>(sel),
      static_cast<float*>(out), batch, d, lc, nchunks, u, dk, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// qq (batch, d) int8, q_scale (batch,) f32, rows (nchunks, lc, d) int8,
// scales (nchunks, lc) f32, pos (nchunks, lc) int32, sel (u,) int32, out
// (batch, u*lc) f32: contiguous device buffers.  vec: 1 when d % 16 == 0 and
// qq and rows are 16-byte aligned.  Returns a cudaError_t value (0 on
// success); the caller checks it: a refused launch never runs.
int crt_int8_gather_scan(const void* qq, const void* q_scale, const void* rows, const void* scales,
                         const void* pos, const void* sel, void* out, int batch, int d, int lc, int nchunks, int u,
                         int vec, void* stream) {
  if (batch <= 0 || d <= 0 || d > kMaxD || lc <= 0 || nchunks <= 0 || u <= 0 || batch > 65535 * 64)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (batch <= 16) return launch<1>(qq, q_scale, rows, scales, pos, sel, out, batch, d, lc, nchunks, u, vec, st);
  if (batch <= 32) return launch<2>(qq, q_scale, rows, scales, pos, sel, out, batch, d, lc, nchunks, u, vec, st);
  return launch<4>(qq, q_scale, rows, scales, pos, sel, out, batch, d, lc, nchunks, u, vec, st);
}

const char* crt_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
