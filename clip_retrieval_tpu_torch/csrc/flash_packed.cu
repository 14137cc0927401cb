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
// Design (bf16), and what bounds it on this card:
// - On paper bytes bound the call: ViT-L/14 at batch 256 moves q, k, v and o
//   once (~0.54 GB, 0.161 ms at 3.35 TB/s) for ~17 GFLOP of MMA work.  On the
//   card the on-chip work bounds it instead (tools/ab_flash.py ablations on an
//   H100, 700 W: 0.38 ms with no global load at all against 0.43 ms in full;
//   0.30 ms without the softmax, 0.35 ms without the products): the tensor
//   products (1.86× the needed work at S=257, from the 64-row granularity)
//   and the softmax's ~3e8 ex2 on the 16-per-clock MUFU pipe run largely one
//   after the other, not overlapped.
// - Two routes, both entries, chosen by the caller (`ops/flash.py::
//   kernel_route`, the `vec` argument).  Every bf16 call with dh % 8 == 0 and
//   16-byte-aligned pointers takes the wgmma route: `flash_wgmma_kernel` at
//   dh ≤ 64 (every CLIP tower), `wide::flash_wgmma_kernel<DP>` above (SigLIP
//   So400m's 72, ViT-H/14's 80, ViT-g/14's 88; its note is at the kernel).
//   Other bf16 calls take the mma.sync route.
// - Above dh 64 the wgmma route beat the mma.sync route at every padded width
//   (tools/ab_flash.py, H100 80GB HBM3, 700 W, one call: (256, 257, 16×80)
//   0.4625 against 0.5145 ms, 16×88 0.7689 against 0.9087, 8×128 0.4219
//   against 0.5373).  At SigLIP's image shape (256, 729, 16×72) the bound is
//   0.634 ms (6.27e11 FLOP of products at 989 TFLOP/s; 1.72 GB of q, k, v and
//   o take 0.513 ms); the wide kernel takes 2.22 ms (28.5 % of it) against
//   the mma.sync route's 3.58 and F.scaled_dot_product_attention's 2.35.
// - wgmma route at dh ≤ 64: a warpgroup (4 warps) owns 64 query rows; a head's ⌈S/64⌉
//   groups are split evenly over ⌈groups/2⌉ blocks of up to 2 warpgroups
//   (grid (splits, heads, batch)), so at S=257 each head's K/V crosses L2 3×
//   (5× with the earlier 64-row blocks).  S = Q·Kᵀ and O += P·V are wgmma
//   m64n64k16 with A from registers (Q by ldmatrix, then P) and B read by the
//   tensor cores from the K/V tile in shared memory, once per warpgroup: V as
//   the transposed operand, so no V fragment is built by hand.  Tiles are
//   64 keys × 64 columns in the 128-byte swizzle (dh < 64 zero-padded).
//   Per warpgroup the products are software-pipelined: S(t) and P(t-1)·V(t-1)
//   are issued together and the softmax of tile t runs while the second is in
//   flight.  Every warpgroup issues every product, needed or not: ptxas
//   serialises (a wait after each wgmma) any wgmma on a path it cannot prove
//   uniform, which cost more than the work it would skip (measured: idle
//   warpgroups leaving early, an n16 product for a one-group last tile, and a
//   second S buffer to issue S(t+1) before the softmax were all slower).
// - mma.sync route (bf16 without 16-byte loads: dh % 8 ≠ 0 or a pointer off
//   16 bytes): one warp per 16-row strip (a head's ⌈S/16⌉ strips split over
//   ⌈strips/8⌉ blocks), m16n8k16 with Q and K fragments by `ldmatrix.x4` and V
//   by `ldmatrix.x4.trans`; shared rows padded by 8 halves ((DP+8)·2 is an
//   odd number of 16-byte units), so the 8 rows of each 8×8 matrix fall in 8
//   distinct bank groups: conflict-free ldmatrix.  A tile that
//   is full and needs no mask runs a straight-line body; only the ragged one
//   is guarded (branches between each ldmatrix and its MMAs had stalled every
//   fragment load).
// - Both: rows and keys are cut to the sequence at 16.  The softmax runs only
//   on a warp's rows and on the 16-key groups that hold data; a tile past the
//   last key (or, causal, past the block's last row) loads only its groups,
//   causal tiles above a warp's diagonal get P = 0, and the mask runs only on
//   tiles that cross the last key or the diagonal.  K/V stream through a
//   kStages-deep ring (on the wgmma route at dh ≤ 64 by 16-byte cp.async.cg,
//   zero-fill past the sequence and past dh, one commit group and one block
//   barrier per tile; on the mma.sync route by element copies); Q is loaded
//   once per warp, and its slot later stages the output for the stores.
// - Math: logits, softmax and accumulation in f32.  Logits are scaled into
//   the log2 domain by one FFMA with the running max folded in and
//   exponentiated with ex2.approx; the running max is guarded so that (-inf) -
//   (-inf) never occurs.  The probabilities stay in registers (the C
//   fragments of two n-tiles are the A fragment of one k-step), rounded to
//   bf16 before P·V as the plain version casts them to v's dtype; row sums
//   stay f32.
// - f32: a scalar-FMA kernel with 32-row query tiles streaming 64-key tiles.
//   It exists for f32 callers and parity checks, not for speed.
//
// Bound from Python with ctypes (plain C interface below); the wrappers are
// `clip_retrieval_tpu_torch/ops/flash.py::flash_attention_packed` (K1) and
// `::flash_attention` (K2).

#include <cuda.h>  // CUtensorMap and its enums; libcuda's encoder is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBN = 64;        // keys per streamed tile
constexpr int kStages = 4;     // depth of the K/V cp.async ring (tiles ahead: 3 on mma.sync, 2 on wgmma)
constexpr int kMaxWarps = 8;   // warps of an mma.sync block, one 16-row strip each
constexpr int kThreads = 128;  // threads of an f32 block
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

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&p);
}

// Rows [r0, r0 + nrows) of up to two same-layout sources (q, or k and v) into
// shared tiles dst[s][nrows][DP + 8]; rows at or past `seq` and columns at or
// past `dh` are zero.  `stride` is the row stride in elements; threads t of nt
// share the work.  VEC: 16-byte cp.async (dh and every stride % 8 == 0,
// 16-byte aligned base pointers), in the caller's commit group, each thread
// keeping one column chunk and walking rows; otherwise synchronous element
// copies.
template <int DP, bool VEC, int NSRC>
__device__ __forceinline__ void load_rows(__nv_bfloat16* const (&dst)[NSRC], const __nv_bfloat16* const (&src)[NSRC],
                                          int r0, int nrows, int seq, int stride, int dh, int t, int nt) {
  constexpr int LD = DP + 8;
  if constexpr (VEC) {
    constexpr int kChunks = DP / 8;
    const int step = nt / kChunks, c = (t % kChunks) * 8;
    if (t >= step * kChunks) return;
    for (int r = t / kChunks; r < nrows; r += step) {
      const bool ok = r0 + r < seq && c < dh;
      const size_t off = ok ? (size_t)(r0 + r) * stride + c : 0;
#pragma unroll
      for (int i = 0; i < NSRC; ++i) cp_async16(dst[i] + r * LD + c, src[i] + off, ok ? 16 : 0);
    }
  } else {
    for (int idx = t; idx < nrows * DP; idx += nt) {
      const int r = idx / DP, c = idx % DP;
      const bool ok = r0 + r < seq && c < dh;
#pragma unroll
      for (int i = 0; i < NSRC; ++i)
        dst[i][r * LD + c] = ok ? src[i][(size_t)(r0 + r) * stride + c] : __float2bfloat16(0.f);
    }
  }
}

// The online softmax over one 16-row strip × kBN-key tile of logits s (the
// m16n8 C-fragment layout of 8 n-tiles, raw q·k): mask where `need_mask` says,
// update the running max m_run (log2 domain) and partial row sums l_run, turn
// s into p = 2^(s·scale − m) in place, and return in alpha the factor by which
// the caller rescales the output accumulators of rows g and g+8.  Only the
// first kg 16-key groups hold computed logits unless FULL (all of them, no
// mask).
template <bool FULL>
__device__ __forceinline__ void online_softmax(float (&s)[kBN / 8][4], float (&alpha)[2], float (&m_run)[2],
                                               float (&l_run)[2], int kg, bool need_mask, int n0, int w_row, int sk,
                                               int causal, float scale_log2, int lane) {
  constexpr int NT = kBN / 8;
  const int g = lane >> 2, t4 = lane & 3;
  if (!FULL && need_mask) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n0 + nt * 8 + t4 * 2 + (e & 1);
        const int row = w_row + g + (e >> 1) * 8;
        if (col >= sk || (causal && col > row)) s[nt][e] = -INFINITY;
      }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
    if (FULL || nt < 2 * kg) {
      mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
    }
  float m_use[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffff, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffff, mx[r], 2));
    const float m_new = fmaxf(m_run[r], mx[r] * scale_log2);
    m_use[r] = (m_new == -INFINITY) ? 0.f : m_new;  // no (-inf) - (-inf)
    alpha[r] = ex2(m_run[r] - m_use[r]);
    m_run[r] = m_new;
    l_run[r] *= alpha[r];
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
    if (FULL || nt < 2 * kg) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(fmaf(s[nt][e], scale_log2, -m_use[e >> 1]));
        s[nt][e] = p;
        l_run[e >> 1] += p;
      }
    }
}

// Scale the output accumulators of rows g and g+8 (NA n-tiles of 8 columns).
template <int NA>
__device__ __forceinline__ void rescale(float (&acc)[NA][4], const float (&alpha)[2]) {
#pragma unroll
  for (int dt = 0; dt < NA; ++dt) {
    acc[dt][0] *= alpha[0];
    acc[dt][1] *= alpha[0];
    acc[dt][2] *= alpha[1];
    acc[dt][3] *= alpha[1];
  }
}

// P of 16 keys (two n-tiles of p) as the bf16 A fragment of one k-step.
__device__ __forceinline__ void pack_p(uint32_t (&pa)[4], const float (&p0)[4], const float (&p1)[4]) {
  pa[0] = pack_bf16(p0[0], p0[1]);
  pa[1] = pack_bf16(p0[2], p0[3]);
  pa[2] = pack_bf16(p1[0], p1[1]);
  pa[3] = pack_bf16(p1[2], p1[3]);
}

// One K/V tile for one warp's 16-row strip on mma.sync: S = Q·Kᵀ, the online
// softmax, O += P·V.  FULL: all kBN keys hold data and need no mask, so the
// body is straight-line code (the compiler hoists each ldmatrix above the MMAs
// before it); otherwise only the first kg 16-key groups are computed.
template <int DP, bool FULL>
__device__ __forceinline__ void attend_tile(const __nv_bfloat16* sK, const __nv_bfloat16* sV,
                                            const uint32_t (&qa)[DP / 16][4], float (&acc)[DP / 8][4],
                                            float (&m_run)[2], float (&l_run)[2], int kg, bool need_mask, int n0,
                                            int w_row, int sk, int causal, float scale_log2, int lane) {
  constexpr int LD = DP + 8, KT = DP / 16, NG = kBN / 16;
  // ldmatrix lane offsets: K (non-transposed) and V (transposed) 16×16 blocks
  const int k_key = (lane & 7) + ((lane >> 4) << 3), k_col = ((lane >> 3) & 1) * 8;
  const int v_key = (lane & 7) + (((lane >> 3) & 1) << 3), v_col = (lane >> 4) * 8;

  float s[2 * NG][4];
#pragma unroll
  for (int nt = 0; nt < 2 * NG; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < KT; ++ks)
#pragma unroll
    for (int np = 0; np < NG; ++np)
      if (FULL || np < kg) {
        uint32_t b[4];
        ldsm_x4(b, sK + (np * 16 + k_key) * LD + ks * 16 + k_col);
        mma_bf16_16816(s[2 * np], qa[ks], b[0], b[1]);
        mma_bf16_16816(s[2 * np + 1], qa[ks], b[2], b[3]);
      }

  float alpha[2];
  online_softmax<FULL>(s, alpha, m_run, l_run, kg, need_mask, n0, w_row, sk, causal, scale_log2, lane);
  rescale(acc, alpha);

  // O += P·V: P in registers as bf16 A fragments, V by ldmatrix.trans
#pragma unroll
  for (int kk = 0; kk < NG; ++kk)
    if (FULL || kk < kg) {
      uint32_t pa[4];
      pack_p(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dp = 0; dp < DP / 16; ++dp) {
        uint32_t b[4];
        ldsm_x4_trans(b, sV + (kk * 16 + v_key) * LD + dp * 16 + v_col);
        mma_bf16_16816(acc[2 * dp], pa, b[0], b[1]);
        mma_bf16_16816(acc[2 * dp + 1], pa, b[2], b[3]);
      }
    }
}

// O / l of one warp's 16-row strip as bf16 through its shared slot sQ
// ([16][DP + 8], free once Q is in registers), then whole rows out.
template <int DP, bool VEC>
__device__ __forceinline__ void store_strip(__nv_bfloat16* ob, __nv_bfloat16* sQ, const float (&acc)[DP / 8][4],
                                            const float (&l_run)[2], int w_row, int sq, int q_row, int dh, int lane) {
  constexpr int LD = DP + 8;
  const int g = lane >> 2, t4 = lane & 3;
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffff, l, 1);
    l += __shfl_xor_sync(0xffffffff, l, 2);
    inv[r] = 1.f / l;
  }
  __syncwarp();
#pragma unroll
  for (int dt = 0; dt < DP / 8; ++dt) {
    __nv_bfloat16* dst = sQ + g * LD + dt * 8 + t4 * 2;
    *reinterpret_cast<uint32_t*>(dst) = pack_bf16(acc[dt][0] * inv[0], acc[dt][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(dst + 8 * LD) = pack_bf16(acc[dt][2] * inv[1], acc[dt][3] * inv[1]);
  }
  __syncwarp();
  const int rows = min(16, sq - w_row);
  if constexpr (VEC) {
    constexpr int kChunks = DP / 8;
    for (int idx = lane; idx < rows * kChunks; idx += 32) {
      const int r = idx / kChunks, c = (idx % kChunks) * 8;
      if (c < dh)
        *reinterpret_cast<uint4*>(ob + (size_t)(w_row + r) * q_row + c) =
            *reinterpret_cast<const uint4*>(sQ + r * LD + c);
    }
  } else {
    for (int idx = lane; idx < rows * DP; idx += 32) {
      const int r = idx / DP, c = idx % DP;
      if (c < dh) ob[(size_t)(w_row + r) * q_row + c] = sQ[r * LD + c];
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kMaxWarps * 32)
    flash_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, Layout L, int dh,
                      float scale_log2, int causal) {
  constexpr int LD = DP + 8;   // see the note above: conflict-free ldmatrix and cp.async
  constexpr int KT = DP / 16;  // MMA k-steps over dh
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sKV = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kStages][K, V][kBN][LD]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __nv_bfloat16* sQ = sKV + kStages * 2 * kBN * LD + warp * 16 * LD;  // this warp's [16][LD]

  // this block's strips of the head, split evenly over gridDim.x blocks; one per warp
  const int strips = (L.sq + 15) / 16;
  const int s_begin = (int)((long long)blockIdx.x * strips / gridDim.x);
  const int s_end = (int)((long long)(blockIdx.x + 1) * strips / gridDim.x);
  const bool has_rows = s_begin + warp < s_end;
  const int w_row = (s_begin + warp) * 16;    // this warp's first query row
  const int row_end = min(s_end * 16, L.sq);  // past the block's last query row
  // keys the block needs, and this warp: causal stops at the last row
  const int kv_end = causal ? min(L.sk, row_end) : L.sk;
  const int w_kv_end = !has_rows ? 0 : causal ? min(L.sk, min(w_row + 16, L.sq)) : L.sk;
  const int ntiles = (kv_end + kBN - 1) / kBN;

  const size_t qbase = (size_t)blockIdx.z * L.q_batch + (size_t)blockIdx.y * L.q_head;
  const size_t kbase = (size_t)blockIdx.z * L.k_batch + (size_t)blockIdx.y * L.k_head;
  const __nv_bfloat16* const kv_src[2] = {k + kbase, v + kbase};

  // prologue: this warp's Q rows (its own group), then the first kStages-1 K/V tiles
  {
    __nv_bfloat16* const dst[1] = {sQ};
    const __nv_bfloat16* const src[1] = {q + qbase};
    load_rows<DP, false>(dst, src, w_row, has_rows ? 16 : 0, L.sq, L.q_row, dh, lane, 32);
  }
  cp_async_commit();
  auto load_tile = [&](int t) {
    __nv_bfloat16* const dst[2] = {sKV + (t % kStages) * 2 * kBN * LD, sKV + ((t % kStages) * 2 + 1) * kBN * LD};
    const int n0 = t * kBN;
    load_rows<DP, false>(dst, kv_src, n0, min(kBN, (kv_end - n0 + 15) / 16 * 16), L.sk, L.k_row, dh, threadIdx.x,
                       blockDim.x);
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < ntiles) load_tile(t);
    cp_async_commit();  // empty groups keep the count uniform
  }
  cp_async_wait<kStages - 1>();
  __syncwarp();

  // Q as A fragments, one per k-step
  uint32_t qa[KT][4];
#pragma unroll
  for (int ks = 0; ks < KT; ++ks) ldsm_x4(qa[ks], sQ + (lane & 15) * LD + ks * 16 + (lane >> 4) * 8);

  float acc[DP / 8][4];
#pragma unroll
  for (int i = 0; i < DP / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // running max (log2 domain), rows g and g+8
  float l_run[2] = {0.f, 0.f};              // this thread's partial row sums

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile t have landed
    __syncthreads();               // everyone's have, and tile t-1's slot is free
    if (t + kStages - 1 < ntiles) load_tile(t + kStages - 1);
    cp_async_commit();

    const int n0 = t * kBN;
    const int kn = min(kBN, w_kv_end - n0);  // keys of this tile the warp needs
    if (kn <= 0) continue;                   // no rows, or causal: the tile is above the warp's diagonal
    const int kg = (kn + 15) / 16;           // 16-key groups computed
    // mask only where the computed keys cross the last key or the causal diagonal
    const bool need_mask = n0 + kg * 16 > L.sk || (causal && n0 + kg * 16 - 1 > w_row);
    const __nv_bfloat16* sK = sKV + (t % kStages) * 2 * kBN * LD;
    const __nv_bfloat16* sV = sK + kBN * LD;
    if (kg == kBN / 16 && !need_mask)
      attend_tile<DP, true>(sK, sV, qa, acc, m_run, l_run, kg, false, n0, w_row, L.sk, causal, scale_log2, lane);
    else
      attend_tile<DP, false>(sK, sV, qa, acc, m_run, l_run, kg, need_mask, n0, w_row, L.sk, causal, scale_log2, lane);
  }
  cp_async_wait<0>();
  if (!has_rows) return;

  store_strip<DP, false>(o + qbase, sQ, acc, l_run, w_row, L.sq, L.q_row, dh, lane);
}

// ---------------------------------------------------------------------------
// The wgmma route: dh ≤ 64 (zero-padded to 64 on chip), vectorised loads.  A
// warpgroup (4 warps) owns 64 query rows; both products are wgmma m64n64k16
// with A from registers (Q, then P: each warp's 16 rows in the mma.sync A
// layout) and B read by the tensor cores straight from the K/V tile in shared
// memory, once per warpgroup instead of once per warp.

constexpr int kWgMax = 2;                // warpgroups per block
constexpr int kTileBytes = kBN * 128;    // a 64-key tile of 64 bf16 columns: 128-byte rows

// Descriptor of a shared panel of ROW_BYTES-byte rows in the swizzle of that
// width (16-byte chunk c of row r at chunk c ^ ((r·ROW_BYTES / 128) mod
// chunks); 8-row groups 8·ROW_BYTES bytes apart).  The same form serves K as
// Bᵀ (K-major) and V as B (N-major, transposed operand).
template <int ROW_BYTES>
__device__ __forceinline__ uint64_t sw_desc(const void* p) {
  constexpr uint64_t kMode = ROW_BYTES == 128 ? 1 : ROW_BYTES == 64 ? 2 : 3;  // 128-, 64-, 32-byte swizzle
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(8 * ROW_BYTES >> 4) << 32) |
         (kMode << 62);
}


// d[OFF .. OFF + N/8) of the 64×N accumulator (+)= A[64×16]·B[16×N] for the
// warpgroup.  TRANS_B = 1: B is stored N-contiguous (V rows); 0: B is stored
// as Bᵀ, K-contiguous (K rows).
template <int TRANS_B, int NA = kBN / 8, int OFF = 0>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[NA][4], const uint32_t (&a)[4], uint64_t desc,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %37;\n}\n"
      : "+f"(d[OFF + 0][0]), "+f"(d[OFF + 0][1]), "+f"(d[OFF + 0][2]), "+f"(d[OFF + 0][3]), "+f"(d[OFF + 1][0]),
        "+f"(d[OFF + 1][1]), "+f"(d[OFF + 1][2]), "+f"(d[OFF + 1][3]), "+f"(d[OFF + 2][0]), "+f"(d[OFF + 2][1]),
        "+f"(d[OFF + 2][2]), "+f"(d[OFF + 2][3]), "+f"(d[OFF + 3][0]), "+f"(d[OFF + 3][1]), "+f"(d[OFF + 3][2]),
        "+f"(d[OFF + 3][3]), "+f"(d[OFF + 4][0]), "+f"(d[OFF + 4][1]), "+f"(d[OFF + 4][2]), "+f"(d[OFF + 4][3]),
        "+f"(d[OFF + 5][0]), "+f"(d[OFF + 5][1]), "+f"(d[OFF + 5][2]), "+f"(d[OFF + 5][3]), "+f"(d[OFF + 6][0]),
        "+f"(d[OFF + 6][1]), "+f"(d[OFF + 6][2]), "+f"(d[OFF + 6][3]), "+f"(d[OFF + 7][0]), "+f"(d[OFF + 7][1]),
        "+f"(d[OFF + 7][2]), "+f"(d[OFF + 7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(TRANS_B), "r"(scale_d));
}

// d[64×64] (+)= A[64×16]·B[16×64] with both operands read by the tensor cores
// from shared memory: A (Q) and Bᵀ (K) K-contiguous.
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[kBN / 8][4], uint64_t desc_a, uint64_t desc_b,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
        "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]),
        "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

template <int TRANS_B, int NA, int OFF>
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[NA][4], const uint32_t (&a)[4], uint64_t desc,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %22, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, %21;\n}\n"
      : "+f"(d[OFF + 0][0]), "+f"(d[OFF + 0][1]), "+f"(d[OFF + 0][2]), "+f"(d[OFF + 0][3]), "+f"(d[OFF + 1][0]),
        "+f"(d[OFF + 1][1]), "+f"(d[OFF + 1][2]), "+f"(d[OFF + 1][3]), "+f"(d[OFF + 2][0]), "+f"(d[OFF + 2][1]),
        "+f"(d[OFF + 2][2]), "+f"(d[OFF + 2][3]), "+f"(d[OFF + 3][0]), "+f"(d[OFF + 3][1]), "+f"(d[OFF + 3][2]),
        "+f"(d[OFF + 3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(TRANS_B), "r"(scale_d));
}

template <int TRANS_B, int NA, int OFF>
__device__ __forceinline__ void wgmma_m64n16k16(float (&d)[NA][4], const uint32_t (&a)[4], uint64_t desc,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, %13;\n}\n"
      : "+f"(d[OFF + 0][0]), "+f"(d[OFF + 0][1]), "+f"(d[OFF + 0][2]), "+f"(d[OFF + 0][3]), "+f"(d[OFF + 1][0]),
        "+f"(d[OFF + 1][1]), "+f"(d[OFF + 1][2]), "+f"(d[OFF + 1][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(TRANS_B), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// After the wait: the accumulators are written now, not when the wgmma was issued.
template <int NA>
__device__ __forceinline__ void wgmma_settle(float (&d)[NA][4]) {
#pragma unroll
  for (int i = 0; i < NA; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[i][e])::"memory");
}

// cp.async writes (generic proxy) before wgmma reads (async proxy) of shared memory.
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// mbarriers in shared memory, and the CTA's named barriers (0 is __syncthreads).
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
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
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// K and V rows [n0, n0 + kBN) into 128-byte-swizzled tiles; rows ≥ sk and
// columns ≥ dh are zero, so a ragged tile's unused keys are finite.
__device__ __forceinline__ void load_kv_sw128(unsigned char* dK, unsigned char* dV, const __nv_bfloat16* k,
                                              const __nv_bfloat16* v, int n0, int sk, int stride, int dh, int t,
                                              int nt) {
  const int c = t & 7, step = nt >> 3;
  for (int r = t >> 3; r < kBN; r += step) {
    const bool ok = n0 + r < sk && c * 8 < dh;
    const size_t off = ok ? (size_t)(n0 + r) * stride + c * 8 : 0;
    const int so = r * 128 + ((c ^ (r & 7)) << 4);
    cp_async16(dK + so, k + off, ok ? 16 : 0);
    cp_async16(dV + so, v + off, ok ? 16 : 0);
  }
}

__global__ void __launch_bounds__(kWgMax * 128)
    flash_wgmma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, Layout L, int dh,
                       float scale_log2, int causal) {
  constexpr int DP = 64, LD = DP + 8, NG = kBN / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the K/V ring at a 1024-byte boundary, where the swizzle pattern starts
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  unsigned char* ring = smem_raw + ((1024 - (base & 1023)) & 1023);  // [kStages][K, V][kTileBytes]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(ring + kStages * 2 * kTileBytes) + warp * 16 * LD;

  // this block's 64-row groups of the head, split evenly over gridDim.x blocks; one per warpgroup
  const int groups = (L.sq + 63) / 64;
  const int g_begin = (int)((long long)blockIdx.x * groups / gridDim.x);
  const int g_end = (int)((long long)(blockIdx.x + 1) * groups / gridDim.x);
  const int w_row = g_begin * 64 + warp * 16;  // this warp's first query row
  const bool has_rows = w_row < min(g_end * 64, L.sq);
  const int row_end = min(g_end * 64, L.sq);
  // keys the block and this warp need: causal stops at the last row
  const int kv_end = causal ? min(L.sk, row_end) : L.sk;
  const int w_kv_end = !has_rows ? 0 : causal ? min(L.sk, min(w_row + 16, L.sq)) : L.sk;
  const int ntiles = (kv_end + kBN - 1) / kBN;

  const size_t qbase = (size_t)blockIdx.z * L.q_batch + (size_t)blockIdx.y * L.q_head;
  const size_t kbase = (size_t)blockIdx.z * L.k_batch + (size_t)blockIdx.y * L.k_head;

  {
    __nv_bfloat16* const dst[1] = {sQ};
    const __nv_bfloat16* const src[1] = {q + qbase};
    load_rows<DP, true>(dst, src, w_row, has_rows ? 16 : 0, L.sq, L.q_row, dh, lane, 32);
  }
  cp_async_commit();
  auto load_tile = [&](int t) {
    unsigned char* dst = ring + (t % kStages) * 2 * kTileBytes;
    load_kv_sw128(dst, dst + kTileBytes, k + kbase, v + kbase, t * kBN, L.sk, L.k_row, dh, threadIdx.x, blockDim.x);
  };
#pragma unroll
  for (int t = 0; t < kStages - 2; ++t) {
    if (t < ntiles) load_tile(t);
    cp_async_commit();
  }
  cp_async_wait<kStages - 2>();
  __syncwarp();

  uint32_t qa[DP / 16][4];  // zero for a warp past the sequence: its rows are computed and dropped
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks) {
    if (has_rows)
      ldsm_x4(qa[ks], sQ + (lane & 15) * LD + ks * 16 + (lane >> 4) * 8);
    else
      qa[ks][0] = qa[ks][1] = qa[ks][2] = qa[ks][3] = 0u;
  }

  float acc[DP / 8][4];
#pragma unroll
  for (int i = 0; i < DP / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  // Software pipeline over the tiles, per warpgroup: S(t) = Q·K(t)ᵀ and O +=
  // P(t-1)·V(t-1) are issued together, the softmax of tile t runs while the
  // second product is in flight, and the output is rescaled once it has landed.
  // So the ring refills the slot of tile t-2 at step t (kStages ≥ 3).
  uint32_t pa[NG][4] = {};  // P of the previous tile; zero before the first
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<kStages - 3>();  // this thread's copies of tile t have landed
    fence_proxy_async();
    __syncthreads();               // everyone's have, and tile t-2's products are done
    if (t + kStages - 2 < ntiles) load_tile(t + kStages - 2);
    cp_async_commit();

    // Every warpgroup runs both products on every tile, whether it needs the
    // tile or not (a warpgroup past the sequence, or causal above its diagonal):
    // a wgmma on a path ptxas cannot prove uniform is serialised.  Rows and
    // keys a warp does not need get P = 0.
    const int n0 = t * kBN;
    const unsigned char* tK = ring + (t % kStages) * 2 * kTileBytes;
    const unsigned char* tV = ring + ((t + kStages - 1) % kStages) * 2 * kTileBytes + kTileBytes;  // tile t-1
    const uint64_t dK = sw_desc<128>(tK), dV = sw_desc<128>(t > 0 ? tV : tK + kTileBytes);

    float s[kBN / 8][4];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) wgmma_m64n64k16<0>(s, qa[ks], dK + 2 * ks, ks > 0);  // +32 bytes of dh
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < NG; ++kk) wgmma_m64n64k16<1>(acc, pa[kk], dV + kk * (16 * 128 / 16), 1);  // +16 keys
    wgmma_commit();
    wgmma_wait<1>();  // S(t) has landed; P(t-1)·V(t-1) may still run
    wgmma_settle(s);

    float alpha[2] = {1.f, 1.f};
    const int kn = min(kBN, w_kv_end - n0);
    if (kn > 0) {
      const int kg = (kn + 15) / 16;
      const bool need_mask = n0 + kg * 16 > L.sk || (causal && n0 + kg * 16 - 1 > w_row);
      if (kg == NG && !need_mask)
        online_softmax<true>(s, alpha, m_run, l_run, kg, false, n0, w_row, L.sk, causal, scale_log2, lane);
      else
        online_softmax<false>(s, alpha, m_run, l_run, kg, need_mask, n0, w_row, L.sk, causal, scale_log2, lane);
    }
    wgmma_wait<0>();
    wgmma_settle(acc);
    rescale(acc, alpha);
    const int kg = kn > 0 ? (kn + 15) / 16 : 0;  // no rows here, or above the warp's diagonal: P = 0
#pragma unroll
    for (int kk = 0; kk < NG; ++kk) {
      if (kk < kg)
        pack_p(pa[kk], s[2 * kk], s[2 * kk + 1]);
      else
        pa[kk][0] = pa[kk][1] = pa[kk][2] = pa[kk][3] = 0u;
    }
  }
  // O += P·V of the last tile
  if (ntiles > 0) {
    const uint64_t dV = sw_desc<128>(ring + ((ntiles - 1) % kStages) * 2 * kTileBytes + kTileBytes);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NG; ++kk) wgmma_m64n64k16<1>(acc, pa[kk], dV + kk * (16 * 128 / 16), 1);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_settle(acc);
  }
  cp_async_wait<0>();
  if (!has_rows) return;
  store_strip<DP, true>(o + qbase, sQ, acc, l_run, w_row, L.sq, L.q_row, dh, lane);
}

// ---------------------------------------------------------------------------
// The wgmma route above dh 64 (SigLIP's 72, ViT-H/14's 80, ViT-g/14's 88):
// dh zero-padded to DP = 80, 96 or 128 (dh 97..112 as 128).  Same grid, rows
// and math as at DP 64; what differs:
// - A tile of Q, K or V is two column panels, each one swizzle atom wide:
//   columns [0, 64) in the 128-byte swizzle, columns [64, DP) in the swizzle
//   as wide as they are (32 bytes at DP 80, 64 at 96, 128 at 128).  S = Q·Kᵀ
//   is DP/16 k-steps (5 at DP 80, none past DP), P·V an n64 product on panel 0
//   and an n(DP − 64) one on panel 1 per 16 keys.
// - Q is read by the tensor cores from shared memory (both operands of S from
//   descriptors), which keeps DP 80 at ≤ 128 registers: two blocks an SM.
// - TMA copies every tile (two boxes of 64 rows per operand, zero past the
//   sequence and past dh): one thread issues them, and no other thread spends
//   an instruction on a load (cp.async by every thread cost ~19 % of the call
//   at (256, 729, 16×72)).  Slots are handed over by mbarriers: full[s]
//   completes when the bytes of slot s have landed, empty[s] when every
//   thread is done with the tile it held.
// - 64-key tiles, and no ping-pong between a block's warpgroups: at DP 80,
//   128-key tiles (171 registers, one block an SM) and a ping-pong by named
//   barriers were both slower (tools/ab_flash.py, H100).
namespace wide {

// O's columns [64, DP) (+)= P[64×16]·V over panel 1 (N = DP − 64).
template <int DP>
__device__ __forceinline__ void wgmma_panel1_pv(float (&d)[DP / 8][4], const uint32_t (&a)[4], uint64_t desc) {
  if constexpr (DP == 80)
    wgmma_m64n16k16<1, DP / 8, 8>(d, a, desc, 1);
  else if constexpr (DP == 96)
    wgmma_m64n32k16<1, DP / 8, 8>(d, a, desc, 1);
  else
    wgmma_m64n64k16<1, DP / 8, 8>(d, a, desc, 1);
}

// The TMA maps of one call: Q, K and V, each as panel 0 and panel 1.
struct Maps {
  CUtensorMap q0, q1, k0, k1, v0, v1;
};

__device__ __forceinline__ void expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// The box of `map` at coordinates (c0, c1, c2, c3) into shared memory at dst;
// its bytes count down `bar`'s transaction count.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], "
      "[%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

// rows_outer: the maps order their dimensions (dh, heads, rows, batch) (K1's
// packed layout) rather than (dh, rows, heads, batch) (K2's), so that strides
// grow.
template <int DP>
__global__ void __launch_bounds__(kWgMax * 128)
    flash_wgmma_kernel(__nv_bfloat16* __restrict__ o, Layout L, int dh, float scale_log2, int causal, int rows_outer,
                       const __grid_constant__ Maps maps) {
  constexpr int LD = DP + 8, NG = kBN / 16;
  constexpr int kTile = kBN * 2 * DP;   // bytes of a Q, K or V tile: panel 0 (kTileBytes), then panel 1
  constexpr int kRow1 = 2 * (DP - 64);  // panel 1's row bytes
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the K/V ring at a 1024-byte boundary, where the swizzle pattern starts
  const uint32_t base = smem_u32(smem_raw);
  unsigned char* ring = smem_raw + ((1024 - (base & 1023)) & 1023);  // [kStages][K, V][kTile]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wg = warp >> 2, wgs = blockDim.x >> 7;
  // per warpgroup 64·LD·2 bytes: its 64 rows of Q, then each warp's 16 output rows [16][LD] staged for the stores
  unsigned char* qs = ring + kStages * 2 * kTile;
  unsigned char* wgQ = qs + wg * 64 * LD * 2;
  __nv_bfloat16* sO = reinterpret_cast<__nv_bfloat16*>(wgQ) + (warp & 3) * 16 * LD;
  uint64_t* full = reinterpret_cast<uint64_t*>(qs + wgs * 64 * LD * 2);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;

  // this block's 64-row groups of the head, split evenly over gridDim.x blocks; one per warpgroup
  const int groups = (L.sq + 63) / 64;
  const int g_begin = (int)((long long)blockIdx.x * groups / gridDim.x);
  const int g_end = (int)((long long)(blockIdx.x + 1) * groups / gridDim.x);
  const int w_row = g_begin * 64 + warp * 16;  // this warp's first query row
  const bool has_rows = w_row < min(g_end * 64, L.sq);
  const int row_end = min(g_end * 64, L.sq);
  // keys the block and this warp need: causal stops at the last row
  const int kv_end = causal ? min(L.sk, row_end) : L.sk;
  const int w_kv_end = !has_rows ? 0 : causal ? min(L.sk, min(w_row + 16, L.sq)) : L.sk;
  const int ntiles = (kv_end + kBN - 1) / kBN;
  const int head = blockIdx.y, batch = blockIdx.z;

  // both panels of 64 rows from `row` on of one operand into dst, on `bar`
  auto load = [&](unsigned char* dst, const CUtensorMap& p0, const CUtensorMap& p1, uint64_t* bar, int row) {
    const int c1 = rows_outer ? head : row, c2 = rows_outer ? row : head;
    tma_load(dst, &p0, bar, 0, c1, c2, batch);
    tma_load(dst + kTileBytes, &p1, bar, 64, c1, c2, batch);
  };
  auto load_tile = [&](int t) {
    unsigned char* dst = ring + (t % kStages) * 2 * kTile;
    uint64_t* bar = full + t % kStages;
    expect_tx(bar, 2 * kTile);
    load(dst, maps.k0, maps.k1, bar, t * kBN);
    load(dst + kTile, maps.v0, maps.v1, bar, t * kBN);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, blockDim.x);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");  // the inits, before the copies use them
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    expect_tx(qbar, wgs * kTile);
    for (int w = 0; w < wgs; ++w) load(qs + w * 64 * LD * 2, maps.q0, maps.q1, qbar, g_begin * 64 + w * 64);
    for (int t = 0; t < kStages - 2 && t < ntiles; ++t) load_tile(t);
  }
  const uint64_t dQ = sw_desc<128>(wgQ), dQ1 = sw_desc<kRow1>(wgQ + kTileBytes);

  float acc[DP / 8][4];
#pragma unroll
  for (int i = 0; i < DP / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  // Per warpgroup the same software pipeline as at DP 64: S(t) and P(t-1)·V(t-1)
  // issued together, the softmax of tile t under the second.  Tile t+2 is
  // loaded at the end of step t into the slot of tile t-2 (kStages = 4).
  mbar_wait(qbar, 0);
  uint32_t pa[NG][4] = {};  // P of the previous tile; zero before the first
  for (int t = 0; t < ntiles; ++t) {
    mbar_wait(full + t % kStages, (t / kStages) & 1);  // tile t has landed

    // Every warpgroup runs both products on every tile, whether it needs the
    // tile or not (a warpgroup past the sequence, or causal above its diagonal):
    // a wgmma on a path ptxas cannot prove uniform is serialised.  Rows and
    // keys a warp does not need get P = 0.
    const int n0 = t * kBN;
    const unsigned char* tK = ring + (t % kStages) * 2 * kTile;
    const unsigned char* pV = t > 0 ? ring + ((t + kStages - 1) % kStages) * 2 * kTile + kTile : tK + kTile;
    const uint64_t dK = sw_desc<128>(tK), dK1 = sw_desc<kRow1>(tK + kTileBytes);
    const uint64_t dV = sw_desc<128>(pV), dV1 = sw_desc<kRow1>(pV + kTileBytes);

    float s[kBN / 8][4];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) wgmma_ss_m64n64k16(s, dQ + 2 * ks, dK + 2 * ks, ks > 0);  // +32 bytes of dh
#pragma unroll
    for (int ks = 4; ks < DP / 16; ++ks) wgmma_ss_m64n64k16(s, dQ1 + 2 * (ks - 4), dK1 + 2 * (ks - 4), 1);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < NG; ++kk) {
      wgmma_m64n64k16<1, DP / 8>(acc, pa[kk], dV + kk * (16 * 128 / 16), 1);  // +16 keys
      wgmma_panel1_pv<DP>(acc, pa[kk], dV1 + kk * (16 * kRow1 / 16));
    }
    wgmma_commit();
    wgmma_wait<1>();  // S(t) has landed; P(t-1)·V(t-1) may still run
    wgmma_settle(s);

    float alpha[2] = {1.f, 1.f};
    const int kn = min(kBN, w_kv_end - n0);
    if (kn > 0) {
      const int kg = (kn + 15) / 16;
      const bool need_mask = n0 + kg * 16 > L.sk || (causal && n0 + kg * 16 - 1 > w_row);
      if (kg == NG && !need_mask)
        online_softmax<true>(s, alpha, m_run, l_run, kg, false, n0, w_row, L.sk, causal, scale_log2, lane);
      else
        online_softmax<false>(s, alpha, m_run, l_run, kg, need_mask, n0, w_row, L.sk, causal, scale_log2, lane);
    }
    wgmma_wait<0>();
    wgmma_settle(acc);
    if (t > 0) mbar_arrive(empty + (t - 1) % kStages);  // tile t-1: read by S(t-1) and P(t-1)·V(t-1)
    if (warp == 0) {
      const int next = t + kStages - 2, prev = next - kStages;  // the tile to load, the slot's last tile
      if (lane == 0 && next < ntiles) {
        if (prev >= 0) mbar_wait(empty + next % kStages, (prev / kStages) & 1);
        load_tile(next);
      }
      __syncwarp();
    }
    rescale(acc, alpha);
    const int kg = kn > 0 ? (kn + 15) / 16 : 0;  // no rows here, or above the warp's diagonal: P = 0
#pragma unroll
    for (int kk = 0; kk < NG; ++kk) {
      if (kk < kg)
        pack_p(pa[kk], s[2 * kk], s[2 * kk + 1]);
      else
        pa[kk][0] = pa[kk][1] = pa[kk][2] = pa[kk][3] = 0u;
    }
  }
  // O += P·V of the last tile
  const unsigned char* lV = ring + ((ntiles - 1) % kStages) * 2 * kTile + kTile;
  const uint64_t dV = sw_desc<128>(lV), dV1 = sw_desc<kRow1>(lV + kTileBytes);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NG; ++kk) {
    wgmma_m64n64k16<1, DP / 8>(acc, pa[kk], dV + kk * (16 * 128 / 16), 1);
    wgmma_panel1_pv<DP>(acc, pa[kk], dV1 + kk * (16 * kRow1 / 16));
  }
  wgmma_commit();
  wgmma_wait<0>();
  wgmma_settle(acc);
  named_sync(1 + wg, 128);  // the warpgroup's products have read Q before its rows are overwritten
  if (!has_rows) return;
  const size_t qbase = (size_t)batch * L.q_batch + (size_t)head * L.q_head;
  store_strip<DP, true>(o + qbase, sO, acc, l_run, w_row, L.sq, L.q_row, dh, lane);
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

// The map of columns [col, col + width) of one operand (rows, heads, batch;
// element strides row, head, bat), boxes of one head's 64 rows in the swizzle
// `sw`; columns ≥ dh and rows ≥ rows read as zero.
bool encode(CUtensorMap* map, const void* ptr, int dh, int rows, int heads, int batch, long long row, long long head,
            long long bat, int width, CUtensorMapSwizzle sw, bool rows_outer) {
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)(rows_outer ? heads : rows),
                              (cuuint64_t)(rows_outer ? rows : heads), (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)(2 * (rows_outer ? head : row)), (cuuint64_t)(2 * (rows_outer ? row : head)),
                                 (cuuint64_t)(2 * bat)};
  const cuuint32_t box[4] = {(cuuint32_t)width, rows_outer ? 1u : (cuuint32_t)kBN, rows_outer ? (cuuint32_t)kBN : 1u, 1u};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, sw, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, const Layout& L, int batch, int heads, int dh,
                   float scale_log2, int causal, cudaStream_t stream) {
  if (encode_tiled() == nullptr) return cudaErrorNotSupported;
  constexpr CUtensorMapSwizzle kSw1 =
      DP == 80 ? CU_TENSOR_MAP_SWIZZLE_32B : DP == 96 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
  const bool rows_outer = L.k_head < L.k_row;
  Maps m;
  const bool ok =
      encode(&m.q0, q, dh, L.sq, heads, batch, L.q_row, L.q_head, L.q_batch, 64, CU_TENSOR_MAP_SWIZZLE_128B, rows_outer) &&
      encode(&m.q1, q, dh, L.sq, heads, batch, L.q_row, L.q_head, L.q_batch, DP - 64, kSw1, rows_outer) &&
      encode(&m.k0, k, dh, L.sk, heads, batch, L.k_row, L.k_head, L.k_batch, 64, CU_TENSOR_MAP_SWIZZLE_128B, rows_outer) &&
      encode(&m.k1, k, dh, L.sk, heads, batch, L.k_row, L.k_head, L.k_batch, DP - 64, kSw1, rows_outer) &&
      encode(&m.v0, v, dh, L.sk, heads, batch, L.k_row, L.k_head, L.k_batch, 64, CU_TENSOR_MAP_SWIZZLE_128B, rows_outer) &&
      encode(&m.v1, v, dh, L.sk, heads, batch, L.k_row, L.k_head, L.k_batch, DP - 64, kSw1, rows_outer);
  if (!ok) return cudaErrorInvalidValue;
  const int groups = (L.sq + 63) / 64;
  const int splits = (groups + kWgMax - 1) / kWgMax;
  const int wgs = (groups + splits - 1) / splits;
  const size_t smem = 1024 + (size_t)kStages * 2 * kBN * 2 * DP + (size_t)wgs * 64 * (DP + 8) * sizeof(__nv_bfloat16) +
                      (2 * kStages + 1) * sizeof(uint64_t);
  auto kern = flash_wgmma_kernel<DP>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(splits, heads, batch);
  kern<<<grid, wgs * 128, smem, stream>>>(static_cast<__nv_bfloat16*>(o), L, dh, scale_log2, causal, rows_outer, m);
  return cudaGetLastError();
}

}  // namespace wide

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
cudaError_t launch_bf16_route(const void* q, const void* k, const void* v, void* o, const Layout& L, int batch,
                              int heads, int dh, float scale_log2, int causal, cudaStream_t stream) {
  const int strips = (L.sq + 15) / 16;
  const int splits = (strips + kMaxWarps - 1) / kMaxWarps;
  const int warps = (strips + splits - 1) / splits;
  const size_t smem = ((size_t)kStages * 2 * kBN + (size_t)warps * 16) * (DP + 8) * sizeof(__nv_bfloat16);
  auto kern = flash_bf16_kernel<DP>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(splits, heads, batch);
  kern<<<grid, warps * 32, smem, stream>>>(static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
                                          static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), L, dh,
                                          scale_log2, causal);
  return cudaGetLastError();
}

cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o, const Layout& L, int batch, int heads,
                        int dh, float scale_log2, int causal, cudaStream_t stream) {
  const int groups = (L.sq + 63) / 64;
  const int splits = (groups + kWgMax - 1) / kWgMax;
  const int wgs = (groups + splits - 1) / splits;
  const size_t smem = 1024 + (size_t)kStages * 2 * kTileBytes + (size_t)wgs * 64 * (64 + 8) * sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(flash_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(splits, heads, batch);
  flash_wgmma_kernel<<<grid, wgs * 128, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(o), L, dh, scale_log2, causal);
  return cudaGetLastError();
}

// vec (`ops/flash.py::kernel_route` sets it) takes the wgmma route: the DP-64
// kernel for dh ≤ 64, `wide` above (DP 112 as 128); the others take mma.sync.
template <int DP>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, const Layout& L, int batch,
                        int heads, int dh, float scale_log2, int causal, int vec, cudaStream_t stream) {
  if (!vec) return launch_bf16_route<DP>(q, k, v, o, L, batch, heads, dh, scale_log2, causal, stream);
  if constexpr (DP <= 64)
    return launch_wgmma(q, k, v, o, L, batch, heads, dh, scale_log2, causal, stream);
  else
    return wide::launch<DP == 112 ? 128 : DP>(q, k, v, o, L, batch, heads, dh, scale_log2, causal, stream);
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
// dtype (0 = float32, 1 = bfloat16).  vec: bf16 only, 1 takes the wgmma route,
// which needs dh % 8 == 0 and every pointer 16-byte aligned (the caller's
// `ops/flash.py::kernel_route` decides).  Returns a cudaError_t value (0 on
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
