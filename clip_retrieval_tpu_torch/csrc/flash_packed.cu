// Fused attention for the CLIP towers on Hopper (sm_90a): kernels K1 and K2.
//
// K1 replaces the Pallas TPU kernel `clip_retrieval_tpu/ops/flash.py::
// flash_attention_packed` (body `_kern_packed`), K2 the Pallas kernel
// `flash_attention` (body `_attn_kernel`).  Same math for both: for every
// (batch, head), softmax(q·kᵀ·dh^-½ [+ causal mask]) · v, logits, softmax and
// accumulation in f32, the output in the input's dtype and layout.  They are
// one device body with two entry points that differ only in the strides they
// hand it:
// - K1 (`crt_flash_packed`): q, k, v are the packed (B, S, W = heads·dh)
//   projection outputs and each head is the column slice [h·dh, (h+1)·dh);
// - K2 (`crt_flash_bhsd`): q is (B, H, Sq, dh), k and v are (B, H, Sk, dh),
//   and Sk may differ from Sq.  The causal mask keeps key j ≤ query row i
//   (top-left aligned, as the JAX kernel's iota comparison does).
//
// Design, and what bounds it on this card:
// - The TPU kernel holds a whole head's K/V in VMEM.  At S=577, dh=88 that is
//   ~203 KB of the 227 KB a block may use here, and one block per (batch,
//   head) would leave most SMs idle, so this kernel streams instead: one
//   block covers one (batch, head, 64-row query tile) and walks 64-key K/V
//   tiles through shared memory with an online softmax kept in f32
//   (FlashAttention-2 style).  The S×S logits never reach device memory.
// - Heads are read through strides (`Layout`: batch, head and row strides of
//   q/o and of k/v): K1's packed layout has row stride W and head offset
//   h·dh, K2's (B, H, S, dh) layout row stride dh and head offset S·dh.  No
//   head transpose exists before or after the kernel, as on the TPU.
// - bf16: tensor-core `mma.sync` m16n8k16 with f32 accumulation; each of the
//   4 warps owns 16 query rows.  dh is zero-padded on chip to a multiple of
//   16 (the bf16 MMA K-step), so dh=80 and dh=88 (padded to 96) work.
//   The probabilities stay in registers and feed the P·V product directly.
// - What bounds it: at CLIP's shapes the roofline bound is bytes, not
//   operations.  ViT-L/14 at batch 256 moves q, k, v and o once (~0.54 GB;
//   the re-reads of a head's K/V by its 5 query tiles hit L2) against ~17
//   GFLOP of MMA work, i.e. ~0.16 ms at 3.35 TB/s against ~0.02 ms at the
//   bf16 tensor-core peak.  This first version sits well above that bound
//   because nothing hides load latency: each K/V tile is loaded with plain
//   loads between two block barriers (no cp.async/TMA double buffering, no
//   wgmma), and padding costs work (S=257 runs 5 query tiles of 64 for 4.02
//   tiles of rows).  Those are the levers a later version pulls.
// - f32: a scalar-FMA kernel with the same tiling and online softmax.  It
//   exists for f32 callers and parity checks, not for speed.
// - Masking: keys ≥ S (the ragged last tile at S=257, 577) and, under the
//   causal flag, keys > query row get -inf before the row max.  Key tiles
//   above the diagonal are skipped, and the running max is guarded so that
//   exp(-inf - -inf) never occurs.  K/V rows past S are zero-filled so that
//   0·V stays 0.
//
// Bound from Python with ctypes (plain C interface below); the wrappers are
// `clip_retrieval_tpu_torch/ops/flash.py::flash_attention_packed` (K1) and
// `::flash_attention` (K2).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;       // query rows per block
constexpr int kBN = 64;       // keys per streamed tile
constexpr int kThreads = 128; // 4 warps
constexpr float kLog2e = 1.4426950408889634f;

// Element strides of one attention call: q and o share theirs, k and v theirs.
struct Layout {
  int sq, sk;                  // query rows, keys
  int q_row, k_row;            // row strides of q / o and of k / v
  long long q_batch, q_head;   // q / o
  long long k_batch, k_head;   // k / v
};

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&p);
}

// Copy rows [r0, r0 + 64) of one head into a [64][LD] shared tile; rows at or
// past `seq` and columns at or past `dh` are zero.  `width` is the row stride
// in elements.  `vec` selects 16-byte loads (dh and every stride % 8 == 0,
// 16-byte aligned base pointers).
template <int DP, int LD>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src, int r0,
                                               int seq, int width, int dh, bool vec) {
  if (vec) {
    constexpr int kChunks = DP / 8;
    for (int idx = threadIdx.x; idx < 64 * kChunks; idx += kThreads) {
      const int r = idx / kChunks, c = (idx % kChunks) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (r0 + r < seq && c < dh)
        val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * width + c);
      *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
    }
  } else {
    for (int idx = threadIdx.x; idx < 64 * DP; idx += kThreads) {
      const int r = idx / DP, c = idx % DP;
      __nv_bfloat16 val = __float2bfloat16(0.f);
      if (r0 + r < seq && c < dh) val = src[(size_t)(r0 + r) * width + c];
      dst[r * LD + c] = val;
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
    flash_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, Layout L, int dh,
                      float scale_log2, int causal, int vec) {
  // +8 halves per row: the 32-bit fragment loads of 8 row groups x 4 column
  // pairs then hit 32 distinct banks for every DP used here
  constexpr int LD = DP + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + kBM * LD;
  __nv_bfloat16* sV = sK + kBN * LD;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;  // mma fragment row group / column pair
  const int m0 = blockIdx.x * kBM;
  const size_t qbase = (size_t)blockIdx.z * L.q_batch + (size_t)blockIdx.y * L.q_head;
  const size_t kbase = (size_t)blockIdx.z * L.k_batch + (size_t)blockIdx.y * L.k_head;
  const bool use_vec = vec != 0;

  load_tile_bf16<DP, LD>(sQ, q + qbase, m0, L.sq, L.q_row, dh, use_vec);
  __syncthreads();

  // this warp's 16 query rows as A fragments, one per 16-wide K-step
  uint32_t qa[DP / 16][4];
  {
    const __nv_bfloat16* qw = sQ + (warp * 16) * LD;
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) {
      const int c = ks * 16 + t4 * 2;
      qa[ks][0] = *reinterpret_cast<const uint32_t*>(qw + g * LD + c);
      qa[ks][1] = *reinterpret_cast<const uint32_t*>(qw + (g + 8) * LD + c);
      qa[ks][2] = *reinterpret_cast<const uint32_t*>(qw + g * LD + c + 8);
      qa[ks][3] = *reinterpret_cast<const uint32_t*>(qw + (g + 8) * LD + c + 8);
    }
  }

  float acc[DP / 8][4];
#pragma unroll
  for (int i = 0; i < DP / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // running max (log2 domain), rows g and g+8
  float l_run[2] = {0.f, 0.f};              // this thread's partial row sums

  const int row0 = m0 + warp * 16 + g;  // global query row of fragment elements 0,1
  const int n_end = causal ? min(L.sk, m0 + kBM) : L.sk;
  const unsigned short* sVu = reinterpret_cast<const unsigned short*>(sV);

  for (int n0 = 0; n0 < n_end; n0 += kBN) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile_bf16<DP, LD>(sK, k + kbase, n0, L.sk, L.k_row, dh, use_vec);
    load_tile_bf16<DP, LD>(sV, v + kbase, n0, L.sk, L.k_row, dh, use_vec);
    __syncthreads();

    // S = Q·Kᵀ for 16 rows x 64 keys: 8 n-tiles of m16n8
    float s[kBN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) {
#pragma unroll
      for (int nt = 0; nt < kBN / 8; ++nt) {
        const __nv_bfloat16* kr = sK + (nt * 8 + g) * LD + ks * 16 + t4 * 2;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + 8);
        mma_bf16_16816(s[nt], qa[ks], b0, b1);
      }
    }

    // scale into the log2 domain, mask, online softmax update
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n0 + nt * 8 + t4 * 2 + (e & 1);
        const int row = row0 + (e >> 1) * 8;
        float x = s[nt][e] * scale_log2;
        if (col >= L.sk || (causal && col > row)) x = -INFINITY;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffff, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffff, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      m_use[r] = (m_new == -INFINITY) ? 0.f : m_new;  // no (-inf) - (-inf)
      alpha[r] = exp2f(m_run[r] - m_use[r]);
      m_run[r] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[nt][e] - m_use[e >> 1]);
        s[nt][e] = p;
        rs[e >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rs[r];
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }

    // O += P·V: the C fragments of two adjacent n-tiles are the A fragment
    // of one 16-key K-step, so P never leaves registers
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const int kr = kk * 16 + t4 * 2;
#pragma unroll
      for (int dt = 0; dt < DP / 8; ++dt) {
        const int c = dt * 8 + g;
        const uint32_t b0 = (uint32_t)sVu[kr * LD + c] | ((uint32_t)sVu[(kr + 1) * LD + c] << 16);
        const uint32_t b1 = (uint32_t)sVu[(kr + 8) * LD + c] | ((uint32_t)sVu[(kr + 9) * LD + c] << 16);
        mma_bf16_16816(acc[dt], pa, b0, b1);
      }
    }
  }

  // full row sums live across the 4 threads of a quad
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffff, l, 1);
    l += __shfl_xor_sync(0xffffffff, l, 2);
    inv[r] = 1.f / l;
  }
  __nv_bfloat16* ob = o + qbase;
#pragma unroll
  for (int dt = 0; dt < DP / 8; ++dt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + (e >> 1) * 8;
      const int col = dt * 8 + t4 * 2 + (e & 1);
      if (row < L.sq && col < dh) ob[(size_t)row * L.q_row + col] = __float2bfloat16(acc[dt][e] * inv[e >> 1]);
    }
  }
}

// f32: 32 query rows per block, 4 threads per row.  Scalar FMAs throughout.
constexpr int kBMF = 32;

template <int DP>
__global__ void __launch_bounds__(kThreads)
    flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                     float* __restrict__ o, Layout L, int dh, float scale_log2, int causal) {
  constexpr int LDK = DP + 1;  // conflict-free column walk over K rows
  constexpr int LDS = kBN + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sK = sQ + kBMF * DP;
  float* sV = sK + kBN * LDK;
  float* sS = sV + kBN * DP;

  const int tid = threadIdx.x;
  const int r_loc = tid >> 2, part = tid & 3;  // this thread's row and quarter
  const int m0 = blockIdx.x * kBMF;
  const int row = m0 + r_loc;
  const size_t qbase = (size_t)blockIdx.z * L.q_batch + (size_t)blockIdx.y * L.q_head;
  const size_t kbase = (size_t)blockIdx.z * L.k_batch + (size_t)blockIdx.y * L.k_head;

  for (int idx = tid; idx < kBMF * DP; idx += kThreads) {
    const int r = idx / DP, c = idx % DP;
    sQ[idx] = (m0 + r < L.sq && c < dh) ? q[qbase + (size_t)(m0 + r) * L.q_row + c] : 0.f;
  }

  float acc[DP / 4];
#pragma unroll
  for (int j = 0; j < DP / 4; ++j) acc[j] = 0.f;
  float m_run = -INFINITY, l_run = 0.f;
  const int n_end = causal ? min(L.sk, m0 + kBMF) : L.sk;

  for (int n0 = 0; n0 < n_end; n0 += kBN) {
    __syncthreads();
    for (int idx = tid; idx < kBN * DP; idx += kThreads) {
      const int r = idx / DP, c = idx % DP;
      const bool ok = n0 + r < L.sk && c < dh;
      const size_t off = kbase + (size_t)(n0 + r) * L.k_row + c;
      sK[r * LDK + c] = ok ? k[off] : 0.f;
      sV[r * DP + c] = ok ? v[off] : 0.f;
    }
    __syncthreads();

    for (int idx = tid; idx < kBMF * kBN; idx += kThreads) {
      const int r = idx / kBN, c = idx % kBN;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < DP; ++d) dot = fmaf(sQ[r * DP + d], sK[c * LDK + d], dot);
      float x = dot * scale_log2;
      if (n0 + c >= L.sk || (causal && n0 + c > m0 + r)) x = -INFINITY;
      sS[r * LDS + c] = x;
    }
    __syncthreads();

    float* srow = sS + r_loc * LDS + part * 16;
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < 16; ++c) mx = fmaxf(mx, srow[c]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 2));
    const float m_new = fmaxf(m_run, mx);
    const float m_use = (m_new == -INFINITY) ? 0.f : m_new;
    const float alpha = exp2f(m_run - m_use);
    m_run = m_new;
    float rs = 0.f;
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const float p = exp2f(srow[c] - m_use);
      srow[c] = p;
      rs += p;
    }
    l_run = l_run * alpha + rs;
#pragma unroll
    for (int j = 0; j < DP / 4; ++j) acc[j] *= alpha;
    __syncwarp();  // the quad's probabilities are written before any lane reads them

    const float* prow = sS + r_loc * LDS;
    for (int n = 0; n < kBN; ++n) {
      const float p = prow[n];
#pragma unroll
      for (int j = 0; j < DP / 4; ++j) acc[j] = fmaf(p, sV[n * DP + part + 4 * j], acc[j]);
    }
  }

  float l = l_run;
  l += __shfl_xor_sync(0xffffffff, l, 1);
  l += __shfl_xor_sync(0xffffffff, l, 2);
  const float inv = 1.f / l;
  if (row < L.sq) {
#pragma unroll
    for (int j = 0; j < DP / 4; ++j) {
      const int c = part + 4 * j;
      if (c < dh) o[qbase + (size_t)row * L.q_row + c] = acc[j] * inv;
    }
  }
}

template <int DP>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, const Layout& L, int batch,
                        int heads, int dh, float scale_log2, int causal, int vec, cudaStream_t stream) {
  const size_t smem = (size_t)(kBM + 2 * kBN) * (DP + 8) * sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(flash_bf16_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((L.sq + kBM - 1) / kBM, heads, batch);
  flash_bf16_kernel<DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), L, dh, scale_log2, causal, vec);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, const Layout& L, int batch, int heads,
                       int dh, float scale_log2, int causal, int /*vec*/, cudaStream_t stream) {
  const size_t smem = ((size_t)kBMF * DP + (size_t)kBN * (DP + 1) + (size_t)kBN * DP +
                       (size_t)kBMF * (kBN + 1)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_f32_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((L.sq + kBMF - 1) / kBMF, heads, batch);
  flash_f32_kernel<DP><<<grid, kThreads, smem, stream>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                                         static_cast<const float*>(v), static_cast<float*>(o), L,
                                                         dh, scale_log2, causal);
  return cudaGetLastError();
}

#define CRT_DISPATCH_DP(DPVAL, LAUNCH) \
  case DPVAL:                          \
    return LAUNCH<DPVAL>(q, k, v, o, L, batch, heads, dh, scale_log2, causal, vec, st)

// One device body, either entry: dispatch on dtype (0 = float32, 1 =
// bfloat16) and on dh padded to the MMA K-step of 16.
int launch(const void* q, const void* k, const void* v, void* o, const Layout& L, int batch, int heads, int dh,
           int causal, int dtype, int vec, void* stream) {
  if (batch <= 0 || heads <= 0 || L.sq <= 0 || L.sk <= 0 || dh <= 0 || dh > 128 || batch > 65535 || heads > 65535)
    return (int)cudaErrorInvalidValue;
  const float scale_log2 = kLog2e / sqrtf((float)dh);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int dp = (dh + 15) / 16 * 16;
  if (dtype == 1) {
    switch (dp) {
      CRT_DISPATCH_DP(16, launch_bf16);
      CRT_DISPATCH_DP(32, launch_bf16);
      CRT_DISPATCH_DP(48, launch_bf16);
      CRT_DISPATCH_DP(64, launch_bf16);
      CRT_DISPATCH_DP(80, launch_bf16);
      CRT_DISPATCH_DP(96, launch_bf16);
      CRT_DISPATCH_DP(112, launch_bf16);
      CRT_DISPATCH_DP(128, launch_bf16);
    }
  } else if (dtype == 0) {
    switch (dp) {
      CRT_DISPATCH_DP(16, launch_f32);
      CRT_DISPATCH_DP(32, launch_f32);
      CRT_DISPATCH_DP(48, launch_f32);
      CRT_DISPATCH_DP(64, launch_f32);
      CRT_DISPATCH_DP(80, launch_f32);
      CRT_DISPATCH_DP(96, launch_f32);
      CRT_DISPATCH_DP(112, launch_f32);
      CRT_DISPATCH_DP(128, launch_f32);
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// K1. q, k, v, o: contiguous (batch, seq, heads*dh) device buffers of one
// dtype (0 = float32, 1 = bfloat16).  vec: bf16 only, 1 when dh % 8 == 0 and
// every pointer is 16-byte aligned.  Returns a cudaError_t value (0 on
// success); the caller checks it: a refused launch never runs.
int crt_flash_packed(const void* q, const void* k, const void* v, void* o, int batch, int seq, int heads,
                     int dh, int causal, int dtype, int vec, void* stream) {
  const int w = heads * dh;
  const Layout L{seq, seq, w, w, (long long)seq * w, dh, (long long)seq * w, dh};
  return launch(q, k, v, o, L, batch, heads, dh, causal, dtype, vec, stream);
}

// K2. q, o: contiguous (batch, heads, seq_q, dh); k, v: contiguous (batch,
// heads, seq_k, dh); one dtype as above.  vec and the return value as K1's.
int crt_flash_bhsd(const void* q, const void* k, const void* v, void* o, int batch, int heads, int seq_q,
                   int seq_k, int dh, int causal, int dtype, int vec, void* stream) {
  const Layout L{seq_q, seq_k, dh, dh, (long long)heads * seq_q * dh, (long long)seq_q * dh,
                 (long long)heads * seq_k * dh, (long long)seq_k * dh};
  return launch(q, k, v, o, L, batch, heads, dh, causal, dtype, vec, stream);
}

const char* crt_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
