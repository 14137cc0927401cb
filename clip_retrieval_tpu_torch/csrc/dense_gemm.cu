// A dense of the CLIP towers in one kernel on Hopper (sm_90a): out =
// residual + act(x @ w + bias) in bf16, the product accumulated in f32 in
// registers by wgmma and the epilogue applied to those registers, so that the
// f32 product never reaches device memory.
//
// It replaces no Pallas kernel of `clip_retrieval_tpu/`: on the TPU, XLA fuses
// the bias add, the activation, the residual add and the casts into the
// matmul's output.  Before it the port ran cuBLAS's product with an f32 output
// and `crt_dense_epilogue` (block_fused.cu) over it: at SigLIP So400m's image
// rows (186,624 × 1152 → 4304) that writes and re-reads 3.2 GB of f32 per MLP
// product, ~18 GB a block where the bf16 output and the residual are ~4.6 GB.
//
// What bounds it: operations.  At the towers' shapes a product does 2·K
// FLOPs per output element against ~4 bytes moved (K ≥ 588), far above the
// ~295 FLOPs a byte at which an H100's tensor cores are the limit.  So the
// design keeps the tensor cores fed and takes the epilogue off their path
// (what each choice bought is in PERF.md, from tools/ab_dense.py):
//
// - Operands by TMA in the 128-byte swizzle: A = x, row-major (M, K) with a
//   row stride `lda` (a multiple of 8: the im2col of a patch embedding pads
//   its rows of 588), boxes of 192 rows × 64 columns; B = w, row-major (K,
//   N), read as the transposed (N-major) operand of wgmma, so no copy of w is
//   made: boxes of 64 rows × 64 columns, three a tile.  Loads past M, N or K
//   read zeros, so the ragged edges (N = 4304, K = 4304 or 2736, M = 256·77)
//   need no masks in the main loop.
// - 192 × 192 tiles, three consumer warpgroups sharing each, consumer c its
//   rows [64c, 64c + 64): one m64n192k16 wgmma a 16-deep step, both operands
//   read from shared memory.  The L2 → SM traffic (x and w read once per
//   tile column and row) held 128 × 128 and 128 × 256 tiles to ~60-70 % of
//   cuBLAS's rate; 192 moreover divides 1152 (six tiles, where 256 wastes a
//   tenth).  Clusters sharing w by TMA multicast ran slower here.
// - A ring of kStages stages, full/empty mbarriers; one producer thread
//   keeps it full.  Persistent blocks, one per SM, walk the output tiles
//   with N fastest, so the blocks in flight share a few row blocks of x and
//   all of w in L2, and the producer loads the next tile's first stages
//   while the consumers finish a tile.
// - The epilogue leaves the tensor cores' path.  A consumer writes t =
//   round(acc + bias) of its rows into a staged tile in shared memory and
//   goes on to the next tile's products; three finisher warps apply the
//   activation, add the residual and write bf16 from there, in 16-byte
//   chunks, while those products run.  Where an element's activation costs
//   more than the finishers keep up with (tanh GELU, quick_gelu's sigmoid
//   and division), the consumers run the whole epilogue of the first
//   `direct` 64-column groups of each tile themselves, from their
//   registers (`block_fused.GEMM_DIRECT` chooses by activation and
//   residual); a kernel instance without that path serves direct = 0.
//   Registers are shared out by setmaxnreg: 144 a consumer thread, 80 in the
//   producer's and finishers' warpgroup.  The arithmetic of each element is
//   `dense_epilogue.cuh`'s, shared with `crt_dense_epilogue`.
// - f32 accumulation over the whole of K in one pass: no split-K, no partial
//   sums in a narrower type.  `out_f32` writes the raw f32 product instead
//   (no bias, activation or residual), which the tests hold to an f64 product.
//
// Bound from Python with ctypes (plain C interface below); the wrapper is
// `clip_retrieval_tpu_torch/ops/block_fused.py::dense_gemm`, and
// `block_fused.dense_route` chooses between it and the split route.

#include <cuda.h>  // CUtensorMap and its enums; libcuda's encoder is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dense_epilogue.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kConsumers = 3;                 // consumer warpgroups, 64 rows of a tile each
constexpr int kBN = 192;                      // columns of a tile: 64-column panels of w
constexpr int kBM = 64 * kConsumers;          // rows of a tile
constexpr int kBK = 64;                       // depth of a k-block: one 128-byte swizzle row of bf16
constexpr int kPanels = kBN / 64;
constexpr int kABytes = kBM * kBK * 2;
constexpr int kPanelBytes = kBK * 64 * 2;     // 8 KB: 64 rows of w × 64 columns
constexpr int kStageBytes = kABytes + kPanels * kPanelBytes;
constexpr int kLd = kBN + 8;                  // the staged tile's row stride: rows 16 bytes apart in the banks
constexpr int kStagingBytes = kBM * kLd * 2;
constexpr int kFinishers = 96;                // warps 1-3 of the last warpgroup finish the staged tiles
constexpr int kThreads = 128 * (kConsumers + 1);  // the consumers, then the producer's and the finishers' warpgroup
// registers a thread after setmaxnreg: an SM quadrant holds one warp of the
// last warpgroup and one of each consumer, 16,384 registers in all
constexpr int kOtherRegs = 80, kConsumerRegs = 144;
static_assert(kOtherRegs + kConsumers * kConsumerRegs <= 512, "the warps of a quadrant share 16,384 registers");

constexpr int kStages = 3;
constexpr size_t kSmem = 1024 + (size_t)kStages * kStageBytes + kStagingBytes + (2 * kStages + 2) * sizeof(uint64_t);
static_assert(kSmem <= 232448, "the ring and the staged tile do not fit in an SM's shared memory");

struct Maps {
  CUtensorMap a, b;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}
// Until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra LAB_WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// The box of `map` at (c0, c1) (innermost first) into shared memory at dst;
// its bytes count down `bar`'s transaction count.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::
          "r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// wgmma descriptors of 128-byte-swizzled panels (rows of 128 bytes, 8-row
// groups 1024 bytes apart).  A is K-major.  B is N-major (the transposed
// operand): its 64-column panels lie 8 KB apart (the leading byte offset).
__device__ __forceinline__ uint64_t desc_a(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}
__device__ __forceinline__ uint64_t desc_b(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(kPanelBytes >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d[64×N] (+)= A[64×16]·B[16×N], A K-major and B N-major in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d);
template <>
__device__ __forceinline__ void wgmma_ss<192>(float (&d)[96], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "%96, %97, p, 1, 1, 0, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(scale_d));
}


__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// A consumer's epilogue from its accumulators d[kBN / 2]: thread (warp w,
// lane l) holds, for n8 block j, rows 16w + l/4 and 16w + l/4 + 8 of its 64
// and columns 8j + 2(l % 4) (+1).  Per 64 columns the bias pairs are read
// once.  The first `direct` 64-column groups it finishes itself: bias,
// activation and residual, bf16 written, a row's residual pairs all read
// before any is used, so that their loads overlap.  Of the others it writes
// t = round(acc + bias) into the staged tile (bf16, rows kLd apart), which
// the finishers take from there.
template <int ACT, bool kMixed>
__device__ __forceinline__ void consume_tile(const float (&d)[kBN / 2], const float* __restrict__ bias,
                                             const bf16* __restrict__ res, bf16* __restrict__ out,
                                             bf16* __restrict__ staged, int m, int n, int m0, int n0, int row,
                                             int col0, int direct) {
  const bool has_res = res != nullptr;
#pragma unroll
  for (int jc = 0; jc < kBN / 64; ++jc) {
    float2 b[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = n0 + col0 + 8 * (8 * jc + j);
      b[j] = bias != nullptr && c < n ? *reinterpret_cast<const float2*>(bias + c) : make_float2(0.0f, 0.0f);
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = row + 8 * e;
      if (!kMixed || jc >= direct) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int i = 4 * (8 * jc + j) + 2 * e;
          *reinterpret_cast<__nv_bfloat162*>(staged + r * kLd + col0 + 8 * (8 * jc + j)) =
              __floats2bfloat162_rn(epilogue_sum<bf16>(d[i], b[j].x), epilogue_sum<bf16>(d[i + 1], b[j].y));
        }
      } else if (m0 + r < m) {
        const long long off = (long long)(m0 + r) * n + n0;
        __nv_bfloat162 rv[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = col0 + 8 * (8 * jc + j);
          rv[j] = has_res && n0 + c < n ? *reinterpret_cast<const __nv_bfloat162*>(res + off + c)
                                        : __floats2bfloat162_rn(0.0f, 0.0f);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = col0 + 8 * (8 * jc + j), i = 4 * (8 * jc + j) + 2 * e;
          if (n0 + c >= n) continue;
          const float2 r2 = __bfloat1622float2(rv[j]);
          const float y0 = epilogue_one<bf16, ACT>(d[i], b[j].x, has_res, r2.x);
          const float y1 = epilogue_one<bf16, ACT>(d[i + 1], b[j].y, has_res, r2.y);
          *reinterpret_cast<__nv_bfloat162*>(out + off + c) = __floats2bfloat162_rn(y0, y1);
        }
      }
    }
  }
}

// The second half of a staged tile's epilogue, by the finishers while the
// consumers run the next tile's products: each of the kFinishers threads
// takes 8-column chunks of the staged columns [64·direct, kBN) (16 bytes;
// consecutive threads along a row, so that the residual's loads and the
// output's stores are whole lines), four at a time with their residual loads
// issued together, applies the activation, adds the residual and writes bf16.
template <int ACT>
__device__ __forceinline__ void finish_tile(const bf16* __restrict__ staged, const bf16* __restrict__ res,
                                            bf16* __restrict__ out, int m, int n, int m0, int n0, int direct,
                                            int f) {
  const bool has_res = res != nullptr;
  const int chunks = kBN / 8 - 8 * direct, total = kBM * chunks;  // a row's staged chunks, the tile's
  constexpr int kBatch = 4;
  for (int q0 = f; q0 < total; q0 += kBatch * kFinishers) {
    uint4 tv[kBatch], rv[kBatch];
    long long off[kBatch];
    bool live[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int q = q0 + b * kFinishers, r = q / chunks, c = 64 * direct + 8 * (q % chunks);
      live[b] = q < total && m0 + r < m && n0 + c < n;
      off[b] = (long long)(m0 + r) * n + n0 + c;
      tv[b] = live[b] ? *reinterpret_cast<const uint4*>(staged + r * kLd + c) : make_uint4(0, 0, 0, 0);
      rv[b] = live[b] && has_res ? *reinterpret_cast<const uint4*>(res + off[b]) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (!live[b]) continue;
      const __nv_bfloat162* t2 = reinterpret_cast<const __nv_bfloat162*>(&tv[b]);
      const __nv_bfloat162* r2 = reinterpret_cast<const __nv_bfloat162*>(&rv[b]);
      uint4 yv;
      __nv_bfloat162* y2 = reinterpret_cast<__nv_bfloat162*>(&yv);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 t = __bfloat1622float2(t2[i]), rr = __bfloat1622float2(r2[i]);
        y2[i] = __floats2bfloat162_rn(epilogue_act<bf16, ACT>(t.x, has_res, rr.x),
                                      epilogue_act<bf16, ACT>(t.y, has_res, rr.y));
      }
      *reinterpret_cast<uint4*>(out + off[b]) = yv;
    }
  }
}

// The raw f32 product of the consumer's rows (out_f32).
__device__ __forceinline__ void store_tile_f32(const float (&d)[kBN / 2], float* __restrict__ out, int m, int n,
                                               int row0, int col0) {
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = row0 + 8 * e;
    if (r >= m) continue;
    const long long off = (long long)r * n;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int c = col0 + 8 * j;
      if (c < n) *reinterpret_cast<float2*>(out + off + c) = make_float2(d[4 * j + 2 * e], d[4 * j + 2 * e + 1]);
    }
  }
}

// kMixed: the consumers finish `direct` of a tile's 64-column groups; without
// it (direct 0) they stage all, and the code holds no direct epilogue.
template <bool kMixed>
__global__ void __launch_bounds__(kThreads, 1)
    dense_gemm_kernel(const __grid_constant__ Maps maps, const float* __restrict__ bias,
                      const bf16* __restrict__ res, void* __restrict__ out, int m, int n, int k, int act,
                      int out_f32, int direct) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the ring at a 1024-byte boundary, where the swizzle pattern starts
  const uint32_t base = smem_u32(smem_raw);
  unsigned char* ring = smem_raw + ((1024 - (base & 1023)) & 1023);  // [kStages][A, B panels]
  bf16* staged = reinterpret_cast<bf16*>(ring + kStages * kStageBytes);  // [kBM][kLd]: a tile's t
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStageBytes + kStagingBytes);
  uint64_t* empty = full + kStages;
  uint64_t* stage_full = empty + kStages;  // the consumers have staged a tile
  uint64_t* stage_free = stage_full + 1;   // the finishers have read it
  const int tiles_n = (n + kBN - 1) / kBN;
  const int tiles = (m + kBM - 1) / kBM * tiles_n;
  const int nkb = (k + kBK - 1) / kBK;
  const bool staging = !out_f32 && direct < kBN / 64;  // some columns go through the finishers
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumers);
    }
    mbar_init(stage_full, 128 * kConsumers);
    mbar_init(stage_free, kFinishers);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");  // the inits, before the copies use them
  }
  __syncthreads();
  // warp-uniform by construction (a shuffle from lane 0), so that ptxas
  // neither serialises the consumers' wgmma nor ignores setmaxnreg
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (wg == kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kOtherRegs) : "memory");
    const int warp = __shfl_sync(0xffffffffu, (int)threadIdx.x / 32, 0) - 4 * kConsumers;
    if (warp == 0) {
      if (threadIdx.x == 128 * kConsumers) {  // the producer
        int p = 0;                            // the ring position: this block's k-blocks in order
        for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
          const int m0 = t / tiles_n * kBM, n0 = t % tiles_n * kBN;
          for (int kb = 0; kb < nkb; ++kb, ++p) {
            const int s = p % kStages;
            if (p >= kStages) mbar_wait(empty + s, (p / kStages - 1) & 1);  // released by the position kStages back
            unsigned char* st = ring + s * kStageBytes;
            expect_tx(full + s, kStageBytes);
            tma_load(st, &maps.a, full + s, kb * kBK, m0);
            for (int q = 0; q < kPanels; ++q)
              tma_load(st + kABytes + q * kPanelBytes, &maps.b, full + s, n0 + 64 * q, kb * kBK);
          }
        }
      }
    } else if (staging) {  // the finishers
      const int f = threadIdx.x - 128 * kConsumers - 32;
      bf16* y = static_cast<bf16*>(out);
      int j = 0;  // this block's tiles so far
      for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++j) {
        const int m0 = t / tiles_n * kBM, n0 = t % tiles_n * kBN;
        mbar_wait(stage_full, j & 1);
        switch (act) {
          case kQuickGelu: finish_tile<kQuickGelu>(staged, res, y, m, n, m0, n0, direct, f); break;
          case kGelu: finish_tile<kGelu>(staged, res, y, m, n, m0, n0, direct, f); break;
          case kGeluTanh: finish_tile<kGeluTanh>(staged, res, y, m, n, m0, n0, direct, f); break;
          default: finish_tile<kNone>(staged, res, y, m, n, m0, n0, direct, f); break;
        }
        mbar_arrive(stage_free);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs) : "memory");
    const int c = wg;  // this consumer's rows of a tile: [64c, 64c + 64)
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    float d[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) d[i] = 0.0f;
    int p = 0;  // the ring position, as the producer counts it
    int j = 0;  // this block's tiles so far
    for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++j) {
      const int m0 = t / tiles_n * kBM, n0 = t % tiles_n * kBN;
      if (res != nullptr) {  // the residual rows into L2 while the products run, 128-byte lines
        for (int q = tid; q < 64 * kPanels; q += 128) {
          const int r = m0 + 64 * c + q / kPanels, col = n0 + 64 * (q % kPanels);
          if (r < m && col < n) asm volatile("prefetch.global.L2 [%0];\n" ::"l"(res + (long long)r * n + col));
        }
      }
      for (int kb = 0; kb < nkb; ++kb, ++p) {
        const int s = p % kStages;
        mbar_wait(full + s, (p / kStages) & 1);
        const uint32_t sa = smem_u32(ring + s * kStageBytes);
        const uint64_t da = desc_a(sa + 64 * 128 * c), db = desc_b(sa + kABytes);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)  // +32 bytes of depth in A's rows, +16 rows of w in B's panels
          wgmma_ss<kBN>(d, da + 2 * kk, db + 128 * kk, kb > 0 || kk > 0);
        wgmma_commit();
        if (kb > 0) {
          wgmma_wait<1>();  // the previous k-block's products have read their stage
          if (tid == 0) mbar_arrive(empty + (p - 1) % kStages);
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) asm volatile("" : "+f"(d[i])::"memory");  // written now, not at issue
      if (tid == 0) mbar_arrive(empty + (p - 1) % kStages);
      const int row = 64 * c + warp * 16 + lane / 4, col0 = 2 * (lane % 4);  // within the tile
      if (out_f32) {
        store_tile_f32(d, static_cast<float*>(out), m, n, m0 + row, n0 + col0);
        continue;
      }
      if (staging && j > 0) mbar_wait(stage_free, (j - 1) & 1);  // the finishers have read the previous tile
      bf16* y = static_cast<bf16*>(out);
      switch (act) {
        case kQuickGelu:
          consume_tile<kQuickGelu, kMixed>(d, bias, res, y, staged, m, n, m0, n0, row, col0, direct);
          break;
        case kGelu:
          consume_tile<kGelu, kMixed>(d, bias, res, y, staged, m, n, m0, n0, row, col0, direct);
          break;
        case kGeluTanh:
          consume_tile<kGeluTanh, kMixed>(d, bias, res, y, staged, m, n, m0, n0, row, col0, direct);
          break;
        default:
          consume_tile<kNone, kMixed>(d, bias, res, y, staged, m, n, m0, n0, row, col0, direct);
          break;
      }
      if (staging) mbar_arrive(stage_full);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the CUDA runtime (nothing links libcuda).
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const bool ok = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) == cudaSuccess &&
                    found == cudaDriverEntryPointSuccess;
    return ok ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// The map of a row-major bf16 matrix (rows, cols) with `stride` elements a
// row, in boxes of box_rows × 64 columns in the 128-byte swizzle; reads past
// either edge give zeros.
bool encode(CUtensorMap* map, const void* ptr, long long rows, long long cols, long long stride, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)(2 * stride)};
  const cuuint32_t box[2] = {64u, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool aligned(const void* p, uintptr_t bytes) { return p == nullptr || reinterpret_cast<uintptr_t>(p) % bytes == 0; }

}  // namespace

extern "C" {

// x: (m, k) bf16, row stride lda (a multiple of 8, ≥ k), 16-byte aligned;
// w: contiguous (k, n) bf16, n a multiple of 8, 16-byte aligned; bias: (n,)
// f32 or null; res: contiguous (m, n) bf16 or null, 16-byte aligned; out:
// contiguous (m, n), 16-byte aligned, bf16 = res + act(x·w + bias) with act
// 0 none, 1 quick_gelu, 2 gelu, 3 gelu_tanh, or with out_f32 f32 = x·w
// (bias and res null, act 0).  direct: the 64-column groups of each
// 192-column tile whose epilogue the consumer warps run (0-3).  Returns a
// cudaError_t value (0 on success); a refused launch never runs.
int crt_dense_gemm(const void* x, const void* w, const void* bias, const void* res, void* out, long long m, int n,
                   int k, long long lda, int act, int out_f32, int direct, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (k <= 0 || m > 0x7fffffffLL || n % 8 || lda % 8 || lda < k || act < 0 || act > 3)
    return (int)cudaErrorInvalidValue;
  if (out_f32 && (bias != nullptr || res != nullptr || act != 0)) return (int)cudaErrorInvalidValue;
  if (direct < 0 || direct > kBN / 64) return (int)cudaErrorInvalidValue;
  if (!aligned(x, 16) || !aligned(w, 16) || !aligned(bias, 8) || !aligned(res, 16) || !aligned(out, 16))
    return (int)cudaErrorInvalidValue;
  if (encode_tiled() == nullptr) return (int)cudaErrorNotSupported;
  Maps maps;
  if (!encode(&maps.a, x, m, k, lda, kBM) || !encode(&maps.b, w, k, n, n, kBK)) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (m + kBM - 1) / kBM * ((n + kBN - 1) / kBN);
  const int grid = (int)(tiles < sms ? tiles : sms);
  const auto kernel = direct > 0 ? dense_gemm_kernel<true> : dense_gemm_kernel<false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      maps, static_cast<const float*>(bias), static_cast<const bf16*>(res), out, (int)m, n, k, act, out_f32, direct);
  return (int)cudaGetLastError();
}

const char* crt_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
