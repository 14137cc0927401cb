// A transformer block's elementwise work in single passes over device memory,
// on Hopper (sm_90a): the epilogue after each dense, a one-pass LayerNorm,
// and for EVA02's image tower the rotation of q and k and the SwiGLU gate
// with its LayerNorm.
//
// They replace no Pallas kernel of `clip_retrieval_tpu/`: on the TPU, XLA
// fuses the bias add, the activation, the residual add and the casts into the
// matmul's consumer, and LayerNorm's statistics and affine step into one
// pass, so the JAX package never wrote them by hand (it has no EVA02 either).
// Eager PyTorch runs each of those ops as its own pass, and at ViT-L/14 and
// SigLIP So400m they moved more bytes than the GEMMs took time for.
//
// What bounds them: bytes.  Each does a few operations per byte (the tanh
// GELU about 20 FLOPs per 8 bytes), far below the ~295 FLOPs a byte at which
// an H100's tensor cores would be the limit.  So the design moves each
// element once, in 16-byte accesses, and keeps every intermediate in
// registers:
//
// - `crt_dense_epilogue` reads the f32 accumulator that cuBLAS wrote (4 bytes
//   an element), adds the f32 bias, applies the activation, adds the residual
//   (2 bytes in bf16) and writes the output dtype (2 bytes in bf16): 6 or 8
//   bytes an element against the eager chain's 14 to 28.  A thread owns 8
//   consecutive elements of the flat (M·N) tensor: two float4 loads of the
//   accumulator, one 16-byte load of a bf16 residual and one 16-byte store.
//   The bias is read as two float4 when N % 8 == 0 (the chunk then never
//   crosses a row), element by element with the column wrapping otherwise;
//   the last M·N % 8 elements, or every chunk where a pointer is not 16-byte
//   aligned, take the scalar path.
// - `crt_layernorm` gives each row one warp; the row stays in registers
//   (8 elements a lane per 256 of width, 2048 wide at most), so it is read
//   once and written once: 4 bytes an element in bf16 against the eager
//   chain's 20 (upcast, normalise in f32, cast back).  Mean and variance are
//   two warp-shuffle sums over the registers (the variance about the mean, not
//   Welford's running update), rsqrtf as PyTorch's kernel, and the affine step
//   gamma·(rstd·(x − mean)) + beta in f32.
// - `crt_rope` is the epilogue of the q and k products of a rotary tower: the
//   f32 accumulator (B, S, W) plus the f32 bias, each head's pairs (2i, 2i+1)
//   of the rows from `prefix` on turned by the table's angle (a·cos − b·sin,
//   b·cos + a·sin) in f32, written once in the output dtype: 6 bytes an
//   element in bf16 against the eager chain's ~40 (bias, split, four products,
//   stack, concatenate, cast).  A thread owns 8 consecutive elements, four
//   whole pairs of one head; the cos and sin of a row's pairs (the table,
//   (2, S − prefix, dh/2) f32, ~150 KB at EVA02-L) are read from L2.
// - `crt_glu_layernorm` is the SwiGLU MLP's middle: the gate GEMM writes one
//   f32 accumulator (M, 2·hp), g in columns [0, h) and x in [hp, hp + h) (hp ≥
//   h, the hidden padded so that rows stay 16-byte aligned); the pass adds the
//   f32 biases, forms silu(g)·x, normalises it over its h columns and writes
//   (M, hp) once in the output dtype, zeros in the pad columns, which the next
//   product then sums exactly: 10 bytes an element in bf16 against the eager
//   chain's ~60.  The row stays in registers, as in `crt_layernorm`, but
//   spread over a block of 128 threads (24 values a thread at hp 2736, 4096
//   wide at most) with the two sums taken through shared memory: a warp a
//   row needed 164 registers a thread there, three blocks an SM, and ran at
//   half the HBM rate.
//
// Rounding follows the eager chain (`dense_epilogue.cuh`, the per-element
// arithmetic this file shares with `dense_gemm.cu`): t = round(acc + b), the
// activation with the eager ops' own roundings, then round(res + t).  In f32
// the rounding is the identity.  Without an activation the result is
// bit-identical to the eager chain's.  The rotation and the gate have no JAX
// counterpart to follow: they stay in f32 from the accumulator on and round
// once, where they write.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "dense_epilogue.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kChunk = 8;              // elements a thread owns at once
constexpr int kEpilogueThreads = 256;
constexpr int kLnWarps = 4;            // rows per LayerNorm block
constexpr int kGluThreads = 128;       // threads a gate row

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16_rn(x); }

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const bf16* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(bf16* p, const float* v) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// acc (total = rows·n, f32), bias (n, f32, or null), res (total, T, or null)
// → out (total, T).  vec: every pointer 16-byte aligned.
template <typename T, int ACT>
__global__ void __launch_bounds__(kEpilogueThreads)
    dense_epilogue_kernel(const float* __restrict__ acc, const float* __restrict__ bias, const T* __restrict__ res,
                          T* __restrict__ out, long long total, int n, int vec) {
  const long long e0 = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * kChunk;
  const bool has_res = res != nullptr;
  if (e0 < total) {
    const int col0 = (int)(e0 % n);
    if (vec && e0 + kChunk <= total) {
      float a[kChunk], b[kChunk], r[kChunk];
      load8(acc + e0, a);
      if (bias == nullptr) {
#pragma unroll
        for (int k = 0; k < kChunk; ++k) b[k] = 0.0f;
      } else if (n % kChunk == 0) {
        load8(bias + col0, b);
      } else {
        int col = col0;
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
          b[k] = bias[col];
          if (++col == n) col = 0;
        }
      }
      if (has_res) {
        load8(res + e0, r);
      } else {
#pragma unroll
        for (int k = 0; k < kChunk; ++k) r[k] = 0.0f;
      }
#pragma unroll
      for (int k = 0; k < kChunk; ++k) a[k] = epilogue_one<T, ACT>(a[k], b[k], has_res, r[k]);
      store8(out + e0, a);
    } else {  // the ragged last chunk, or unaligned pointers
      int col = col0;
      for (long long e = e0; e < e0 + kChunk && e < total; ++e) {
        const float b = bias == nullptr ? 0.0f : bias[col];
        const float r = has_res ? to_f32(res[e]) : 0.0f;
        out[e] = from_f32<T>(epilogue_one<T, ACT>(acc[e], b, has_res, r));
        if (++col == n) col = 0;
      }
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, int MAXC>
__device__ __forceinline__ void layernorm_row(const T* __restrict__ xr, const float* __restrict__ gamma,
                                              const float* __restrict__ beta, T* __restrict__ yr, int w, float eps,
                                              int vec, int lane) {
  float v[MAXC][kChunk];
  float sum = 0.0f;
#pragma unroll
  for (int j = 0; j < MAXC; ++j) {
    const int e0 = (j * 32 + lane) * kChunk;
    if (vec && e0 < w) {
      load8(xr + e0, v[j]);
    } else {
#pragma unroll
      for (int k = 0; k < kChunk; ++k) v[j][k] = e0 + k < w ? to_f32(xr[e0 + k]) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) sum += v[j][k];
  }
  const float mean = warp_sum(sum) / w;
  float sq = 0.0f;
#pragma unroll
  for (int j = 0; j < MAXC; ++j) {
    const int e0 = (j * 32 + lane) * kChunk;
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const float d = e0 + k < w ? v[j][k] - mean : 0.0f;
      sq += d * d;
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / w + eps);
#pragma unroll
  for (int j = 0; j < MAXC; ++j) {
    const int e0 = (j * 32 + lane) * kChunk;
    if (e0 >= w) continue;
    float g[kChunk], b[kChunk], o[kChunk];
    if (vec) {
      load8(gamma + e0, g);
      load8(beta + e0, b);
    } else {
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        g[k] = e0 + k < w ? gamma[e0 + k] : 0.0f;
        b[k] = e0 + k < w ? beta[e0 + k] : 0.0f;
      }
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) o[k] = g[k] * (rstd * (v[j][k] - mean)) + b[k];
    if (vec) {
      store8(yr + e0, o);
    } else {
      for (int k = 0; k < kChunk && e0 + k < w; ++k) yr[e0 + k] = from_f32<T>(o[k]);
    }
  }
}

// One warp per row of width w ≤ 256·MAXC; lane l holds the chunks l, l + 32,
// … of 8 elements.  vec: w % 8 == 0 and every pointer 16-byte aligned.
template <typename T, int MAXC>
__global__ void __launch_bounds__(kLnWarps * 32)
    layernorm_kernel(const T* __restrict__ x, const float* __restrict__ gamma, const float* __restrict__ beta,
                     T* __restrict__ y, long long rows, int w, float eps, int vec) {
  const long long row = (long long)blockIdx.x * kLnWarps + threadIdx.x / 32;
  if (row < rows) layernorm_row<T, MAXC>(x + row * w, gamma, beta, y + row * w, w, eps, vec, threadIdx.x % 32);
}

// ---------------------------------------------------------------------------
// rotary epilogue
// ---------------------------------------------------------------------------

// acc (rows·w, f32, rows = batch·seq), bias (w, f32, or null), table (2, seq −
// prefix, dh/2) f32: cos then sin of each rotated row's pairs → out (rows·w,
// T).  vec: w % 8 == 0, dh % 8 == 0 and every pointer 16-byte aligned.
template <typename T>
__global__ void __launch_bounds__(kEpilogueThreads)
    rope_epilogue_kernel(const float* __restrict__ acc, const float* __restrict__ bias,
                         const float* __restrict__ table, T* __restrict__ out, long long total, int seq, int prefix,
                         int w, int dh, int vec) {
  const long long e0 = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * kChunk;
  if (e0 >= total) return;
  const int half = dh / 2;
  const long long plane = (long long)(seq - prefix) * half;  // the sin table's offset
  if (vec) {  // 4 whole pairs of one head of one row
    const long long row = e0 / w;
    const int col0 = (int)(e0 - row * w);
    const int s = (int)(row % seq);
    float a[kChunk], b[kChunk];
    load8(acc + e0, a);
    if (bias != nullptr) {
      load8(bias + col0, b);
#pragma unroll
      for (int k = 0; k < kChunk; ++k) a[k] += b[k];
    }
    if (s >= prefix) {
      const float* c = table + (long long)(s - prefix) * half + (col0 % dh) / 2;
      const float4 cs = *reinterpret_cast<const float4*>(c);
      const float4 sn = *reinterpret_cast<const float4*>(c + plane);
      const float cv[4] = {cs.x, cs.y, cs.z, cs.w}, sv[4] = {sn.x, sn.y, sn.z, sn.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x = a[2 * i], y = a[2 * i + 1];
        a[2 * i] = x * cv[i] - y * sv[i];
        a[2 * i + 1] = y * cv[i] + x * sv[i];
      }
    }
    store8(out + e0, a);
  } else {
    for (long long e = e0; e < e0 + kChunk && e < total; ++e) {
      const long long row = e / w;
      const int col = (int)(e - row * w);
      const int s = (int)(row % seq);
      float v = acc[e] + (bias == nullptr ? 0.0f : bias[col]);
      if (s >= prefix) {
        const int d = col % dh;
        const int mate = d % 2 == 0 ? col + 1 : col - 1;  // the other element of the pair
        const float m = acc[row * w + mate] + (bias == nullptr ? 0.0f : bias[mate]);
        const long long t = (long long)(s - prefix) * half + d / 2;
        const float c = table[t], sn = table[t + plane];
        v = d % 2 == 0 ? v * c - m * sn : v * c + m * sn;
      }
      out[e] = from_f32<T>(v);
    }
  }
}

// ---------------------------------------------------------------------------
// SwiGLU gate and its LayerNorm
// ---------------------------------------------------------------------------

__device__ __forceinline__ float silu(float g) { return g / (1.0f + expf(-g)); }

// The sum of v over the block's kGluThreads threads, through `part`
// (kGluThreads / 32 floats of shared memory, one array for each reduction).
__device__ __forceinline__ float block_sum(float v, float* part) {
  v = warp_sum(v);
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = v;
  __syncthreads();
  float t = 0.0f;
#pragma unroll
  for (int w = 0; w < kGluThreads / 32; ++w) t += part[w];
  return t;
}

// One block of kGluThreads per row; thread t holds the chunks t, t +
// kGluThreads, … of 8 hidden columns (hp ≤ 8·kGluThreads·C), so that few
// registers a thread keep many rows in flight on each SM.  acc row: g in [0,
// hp), x in [hp, 2·hp); bias likewise or null; gamma, beta (h).  vec: hp % 8
// == 0 and every pointer 16-byte aligned.
template <typename T, int C>
__global__ void __launch_bounds__(kGluThreads)
    glu_layernorm_kernel(const float* __restrict__ acc, const float* __restrict__ bias,
                         const float* __restrict__ gamma, const float* __restrict__ beta, T* __restrict__ out,
                         int h, int hp, float eps, int vec) {
  __shared__ float part[2][kGluThreads / 32];
  const long long row = blockIdx.x;
  const int tid = threadIdx.x;
  const float* gr = acc + row * 2 * hp;
  const float* xr = gr + hp;
  T* yr = out + row * hp;
  float v[C][kChunk];
  float sum = 0.0f;
#pragma unroll
  for (int j = 0; j < C; ++j) {
    const int e0 = (j * kGluThreads + tid) * kChunk;
    if (vec && e0 < hp) {
      float g[kChunk], x[kChunk];
      load8(gr + e0, g);
      load8(xr + e0, x);
      if (bias != nullptr) {
        float bg[kChunk], bx[kChunk];
        load8(bias + e0, bg);
        load8(bias + hp + e0, bx);
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
          g[k] += bg[k];
          x[k] += bx[k];
        }
      }
#pragma unroll
      for (int k = 0; k < kChunk; ++k) v[j][k] = e0 + k < h ? silu(g[k]) * x[k] : 0.0f;
    } else {
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        const int c = e0 + k;
        if (c < h) {
          const float g = gr[c] + (bias == nullptr ? 0.0f : bias[c]);
          const float x = xr[c] + (bias == nullptr ? 0.0f : bias[hp + c]);
          v[j][k] = silu(g) * x;
        } else {
          v[j][k] = 0.0f;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) sum += v[j][k];
  }
  const float mean = block_sum(sum, part[0]) / h;
  float sq = 0.0f;
#pragma unroll
  for (int j = 0; j < C; ++j) {
    const int e0 = (j * kGluThreads + tid) * kChunk;
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const float d = e0 + k < h ? v[j][k] - mean : 0.0f;
      sq += d * d;
    }
  }
  const float rstd = rsqrtf(block_sum(sq, part[1]) / h + eps);
#pragma unroll
  for (int j = 0; j < C; ++j) {
    const int e0 = (j * kGluThreads + tid) * kChunk;
    if (e0 >= hp) continue;
    float g[kChunk], b[kChunk], o[kChunk];
    if (vec && e0 + kChunk <= h) {
      load8(gamma + e0, g);
      load8(beta + e0, b);
    } else {
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        g[k] = e0 + k < h ? gamma[e0 + k] : 0.0f;
        b[k] = e0 + k < h ? beta[e0 + k] : 0.0f;
      }
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) o[k] = e0 + k < h ? g[k] * (rstd * (v[j][k] - mean)) + b[k] : 0.0f;
    if (vec) {
      store8(yr + e0, o);
    } else {
      for (int k = 0; k < kChunk && e0 + k < hp; ++k) yr[e0 + k] = from_f32<T>(o[k]);
    }
  }
}

bool aligned16(const void* p) { return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
int launch_epilogue(const void* acc, const void* bias, const void* res, void* out, long long rows, int n, int act,
                    cudaStream_t stream) {
  const long long total = rows * n;
  const long long chunks = (total + kChunk - 1) / kChunk;
  const long long blocks = (chunks + kEpilogueThreads - 1) / kEpilogueThreads;
  const int vec = aligned16(acc) && aligned16(bias) && aligned16(res) && aligned16(out);
  const auto* a = static_cast<const float*>(acc);
  const auto* b = static_cast<const float*>(bias);
  const auto* r = static_cast<const T*>(res);
  auto* o = static_cast<T*>(out);
  const dim3 grid((unsigned)blocks), block(kEpilogueThreads);
  switch (act) {
    case kNone: dense_epilogue_kernel<T, kNone><<<grid, block, 0, stream>>>(a, b, r, o, total, n, vec); break;
    case kQuickGelu: dense_epilogue_kernel<T, kQuickGelu><<<grid, block, 0, stream>>>(a, b, r, o, total, n, vec); break;
    case kGelu: dense_epilogue_kernel<T, kGelu><<<grid, block, 0, stream>>>(a, b, r, o, total, n, vec); break;
    case kGeluTanh: dense_epilogue_kernel<T, kGeluTanh><<<grid, block, 0, stream>>>(a, b, r, o, total, n, vec); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_layernorm(const void* x, const void* gamma, const void* beta, void* y, long long rows, int w, float eps,
                     cudaStream_t stream) {
  const int vec = w % kChunk == 0 && aligned16(x) && aligned16(gamma) && aligned16(beta) && aligned16(y);
  const dim3 grid((unsigned)((rows + kLnWarps - 1) / kLnWarps)), block(kLnWarps * 32);
  const auto* xp = static_cast<const T*>(x);
  const auto* g = static_cast<const float*>(gamma);
  const auto* b = static_cast<const float*>(beta);
  auto* yp = static_cast<T*>(y);
  if (w <= 256 * 4) {
    layernorm_kernel<T, 4><<<grid, block, 0, stream>>>(xp, g, b, yp, rows, w, eps, vec);
  } else if (w <= 256 * 6) {
    layernorm_kernel<T, 6><<<grid, block, 0, stream>>>(xp, g, b, yp, rows, w, eps, vec);
  } else if (w <= 256 * 8) {
    layernorm_kernel<T, 8><<<grid, block, 0, stream>>>(xp, g, b, yp, rows, w, eps, vec);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_rope(const void* acc, const void* bias, const void* table, void* out, long long rows, int seq, int prefix,
                int w, int dh, cudaStream_t stream) {
  const long long total = rows * w;
  const long long blocks = (total + (long long)kChunk * kEpilogueThreads - 1) / ((long long)kChunk * kEpilogueThreads);
  const int vec = w % kChunk == 0 && dh % kChunk == 0 && aligned16(acc) && aligned16(bias) && aligned16(table) &&
                  aligned16(out);
  rope_epilogue_kernel<T><<<dim3((unsigned)blocks), dim3(kEpilogueThreads), 0, stream>>>(
      static_cast<const float*>(acc), static_cast<const float*>(bias), static_cast<const float*>(table),
      static_cast<T*>(out), total, seq, prefix, w, dh, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_glu_layernorm(const void* acc, const void* bias, const void* gamma, const void* beta, void* out,
                         long long rows, int h, int hp, float eps, cudaStream_t stream) {
  const int vec = hp % kChunk == 0 && aligned16(acc) && aligned16(bias) && aligned16(gamma) && aligned16(beta) &&
                  aligned16(out);
  const dim3 grid((unsigned)rows), block(kGluThreads);
  const auto* a = static_cast<const float*>(acc);
  const auto* bi = static_cast<const float*>(bias);
  const auto* g = static_cast<const float*>(gamma);
  const auto* b = static_cast<const float*>(beta);
  auto* o = static_cast<T*>(out);
  constexpr int kRow = kChunk * kGluThreads;  // hidden columns a block holds at once
  if (hp <= kRow) {
    glu_layernorm_kernel<T, 1><<<grid, block, 0, stream>>>(a, bi, g, b, o, h, hp, eps, vec);
  } else if (hp <= 2 * kRow) {
    glu_layernorm_kernel<T, 2><<<grid, block, 0, stream>>>(a, bi, g, b, o, h, hp, eps, vec);
  } else if (hp <= 3 * kRow) {
    glu_layernorm_kernel<T, 3><<<grid, block, 0, stream>>>(a, bi, g, b, o, h, hp, eps, vec);
  } else if (hp <= 4 * kRow) {
    glu_layernorm_kernel<T, 4><<<grid, block, 0, stream>>>(a, bi, g, b, o, h, hp, eps, vec);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// acc: contiguous (rows, n) f32; bias: (n,) f32 or null; res: contiguous
// (rows, n) of the output dtype or null; out: contiguous (rows, n).  act: 0
// none, 1 quick_gelu, 2 gelu, 3 gelu_tanh.  dtype: 0 = float32, 1 = bfloat16.
// Returns a cudaError_t value (0 on success); a refused launch never runs.
int crt_dense_epilogue(const void* acc, const void* bias, const void* res, void* out, long long rows, int n, int act,
                       int dtype, void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_epilogue<float>(acc, bias, res, out, rows, n, act, s);
  if (dtype == 1) return launch_epilogue<bf16>(acc, bias, res, out, rows, n, act, s);
  return (int)cudaErrorInvalidValue;
}

// x, y: contiguous (rows, w) of one dtype (0 = float32, 1 = bfloat16), w ≤
// 2048; gamma, beta: (w,) f32.  Returns a cudaError_t value as above.
int crt_layernorm(const void* x, const void* gamma, const void* beta, void* y, long long rows, int w, float eps,
                  int dtype, void* stream) {
  if (rows <= 0 || w <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_layernorm<float>(x, gamma, beta, y, rows, w, eps, s);
  if (dtype == 1) return launch_layernorm<bf16>(x, gamma, beta, y, rows, w, eps, s);
  return (int)cudaErrorInvalidValue;
}

// acc, out: contiguous (rows, w), rows = batch·seq, acc f32, out of `dtype`
// (0 = float32, 1 = bfloat16); bias: (w,) f32 or null; table: (2, seq −
// prefix, dh/2) f32, cos then sin.  Rows whose position in the sequence is
// below `prefix` are not turned.  Returns a cudaError_t value as above.
int crt_rope(const void* acc, const void* bias, const void* table, void* out, long long rows, int seq, int prefix,
             int w, int dh, int dtype, void* stream) {
  if (rows <= 0 || w <= 0) return 0;
  if (seq <= prefix || dh <= 0 || dh % 2 || w % dh) return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_rope<float>(acc, bias, table, out, rows, seq, prefix, w, dh, s);
  if (dtype == 1) return launch_rope<bf16>(acc, bias, table, out, rows, seq, prefix, w, dh, s);
  return (int)cudaErrorInvalidValue;
}

// acc: contiguous (rows, 2·hp) f32, g in [0, h) and x in [hp, hp + h) of each
// row; bias: (2·hp,) f32 laid out alike, or null; gamma, beta: (h,) f32; out:
// contiguous (rows, hp) of `dtype`, zeros written in [h, hp).  h ≤ hp ≤ 4096.
// Returns a cudaError_t value as above.
int crt_glu_layernorm(const void* acc, const void* bias, const void* gamma, const void* beta, void* out,
                      long long rows, int h, int hp, float eps, int dtype, void* stream) {
  if (rows <= 0) return 0;
  if (h <= 0 || hp < h || rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;  // a block a row
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_glu_layernorm<float>(acc, bias, gamma, beta, out, rows, h, hp, eps, s);
  if (dtype == 1) return launch_glu_layernorm<bf16>(acc, bias, gamma, beta, out, rows, h, hp, eps, s);
  return (int)cudaErrorInvalidValue;
}

const char* crt_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
