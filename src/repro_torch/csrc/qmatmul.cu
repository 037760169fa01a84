// Fused k-bit dequant-GEMM on the CUDA cores (sm_90a): the decode GEMV and
// the f32-activation tiled product.
//
// Replaces, with qgemm_sm90.cu (bf16 activations at prefill), the TPU kernel
// src/repro/kernels/qmatmul.py::qmatmul_pallas (bodies _qmatmul_kernel,
// _unpack_tile, _dequant_codes).
//
//   y[M, N] = x[M, K] . W^T,   W[n, k] = dq(code[n, k]) * scale[n, k / B]
//
// code[n, k] is `bits` wide, packed cpw = 32 / bits to a 32-bit word, low
// bits first; dq is the codebook of every type (for int it equals the TPU
// kernel's clip(c - h, -h, h) / h, h = 2^(bits-1) - 1, bit for bit).  The
// weight is rounded to the activation type before the product, as the TPU
// kernel does (qmatmul.py:80-85), so the result equals the
// dequant-then-matmul path up to f32 summation order.  Sums run in f32; y is
// written in x's type (f32 or bf16).
//
// What bounds it on an H100 SXM (3.35 TB/s): at decode (M = batch, a few
// rows) bytes — the packed codes and bf16 scales of W, about 0.28 of the
// bf16 weight at 4 bits, b64.
//
// Design: both kernels decode a code with a shift, a mask and a read of a
// 2^bits-entry table in shared memory, the codebook copied there once per
// block: the TPU's compare-select tree (qmatmul.py:28-33) is a VPU
// constraint.
//   qgemv (M <= 8, decode, for what kernels/qmatmul.py:gemv_route does not
//     send to qgemv_sm90.cu's tensor cores: f32 x, bf16 x at 3, 5 and 6 bits
//     or with scale blocks that split a word): a block owns 4 output columns
//     and splits their K among its 4 warps, which read interleaved 128-byte
//     runs of packed words
//     (2 words a column in flight per lane), so every packed byte is read
//     from device memory once; the K split keeps enough warps in flight for
//     the 512-column wk/wv and the long-K w_down.  A lane reads the
//     activations its word multiplies straight from global memory (x is at
//     most a few hundred KB and stays in L1/L2) with the widest aligned
//     vector loads and sums all rows at once; shuffles and a pass through
//     shared memory reduce the block.  The row count is a template parameter
//     (1, 2, 4, 8), so a batch-1 step does an eighth of a batch-8 step's
//     arithmetic.  On the CUDA cores this is bound by instructions (~6 per
//     decoded code and column, plus an FMA per row), not by bytes: without
//     its decode a decode step's launches take 40 % less time, without its
//     word loads 15 % less (scripts/qgemm_ablate.py --gemv, PERF.md).
//   qgemm_simt (M > 8, f32 x): a tiled CUDA-core product in f32, since the
//     tensor cores would round f32 activations.
// Both take K from the wrapper already tile-aligned: K == n_words * cpw and
// K % B == 0 (kernels/ops.py pads, as the reference's ops.qmatmul does).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

template <typename T>
struct Act;

template <>
struct Act<float> {
  using Raw = float;
  static __device__ __forceinline__ float from_raw(float v) { return v; }
  static __device__ __forceinline__ float store(float v) { return v; }
  static __device__ __forceinline__ float round(float v) { return v; }
};

template <>
struct Act<bf16> {
  using Raw = unsigned short;
  static __device__ __forceinline__ float from_raw(unsigned short v) {
    return __uint_as_float(static_cast<unsigned>(v) << 16);
  }
  static __device__ __forceinline__ bf16 store(float v) { return __float2bfloat16_rn(v); }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

// The code -> value table in shared memory: a copy of the codebook.
__device__ __forceinline__ void fill_lut(float* lut, int n, const float* codebook) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) lut[i] = codebook[i];
}

template <int BYTES>
struct VecOf;
template <>
struct VecOf<16> { using type = uint4; };
template <>
struct VecOf<8> { using type = uint2; };
template <>
struct VecOf<4> { using type = unsigned; };
template <>
struct VecOf<2> { using type = unsigned short; };

__host__ __device__ constexpr int widest_vec(int bytes) {
  return bytes % 16 == 0 ? 16 : bytes % 8 == 0 ? 8 : bytes % 4 == 0 ? 4 : 2;
}

// The N activations at p, widened to f32.  p is aligned to the widest
// power of two (<= 16) that divides N * sizeof(T): x's base is 16-byte
// aligned (the wrapper checks), and every row and word offset is a multiple
// of N * sizeof(T) since K is a multiple of cpw = N.
template <typename T, int N>
__device__ __forceinline__ void load_run(const T* __restrict__ p, float (&v)[N]) {
  using Raw = typename Act<T>::Raw;
  constexpr int BYTES = N * static_cast<int>(sizeof(T));
  constexpr int VB = widest_vec(BYTES);
  using V = typename VecOf<VB>::type;
  union {
    V vec[BYTES / VB];
    Raw raw[N];
  } u;
#pragma unroll
  for (int i = 0; i < BYTES / VB; ++i) u.vec[i] = __ldg(reinterpret_cast<const V*>(p) + i);
#pragma unroll
  for (int j = 0; j < N; ++j) v[j] = Act<T>::from_raw(u.raw[j]);
}

constexpr int GV_WARPS = 4;   // warps per block, splitting K
constexpr int GV_COLS = 4;    // output columns per block
constexpr int GV_UNROLL = 2;  // packed words per column and lane in flight
constexpr int GV_STRIDE = 32 * GV_WARPS;  // words between a lane's successive words

template <typename T, int BITS, int MR>
__global__ void __launch_bounds__(GV_WARPS * 32)
qgemv_kernel(const T* __restrict__ x, const uint32_t* __restrict__ packed,
             const bf16* __restrict__ scales, const float* __restrict__ codebook,
             T* __restrict__ y, int M, int N, int K, int n_words, int block_size) {
  constexpr int CPW = 32 / BITS;
  constexpr unsigned MASK = (1u << BITS) - 1u;
  static_assert(GV_COLS * MR <= 32, "one lane per (column, row) sum");
  __shared__ float lut[1 << BITS];
  __shared__ float part[GV_WARPS][GV_COLS * MR];
  fill_lut(lut, 1 << BITS, codebook);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * GV_COLS;
  const int n_blocks = K / block_size;
  // columns past N re-read column N - 1 and are never written
  const uint32_t* wrow[GV_COLS];
  const bf16* srow[GV_COLS];
#pragma unroll
  for (int c = 0; c < GV_COLS; ++c) {
    const int n = min(n0 + c, N - 1);
    wrow[c] = packed + static_cast<size_t>(n) * n_words;
    srow[c] = scales + static_cast<size_t>(n) * n_blocks;
  }

  float acc[GV_COLS][MR];
#pragma unroll
  for (int c = 0; c < GV_COLS; ++c)
#pragma unroll
    for (int r = 0; r < MR; ++r) acc[c][r] = 0.f;

  for (int wb = warp * 32 + lane; wb < n_words; wb += GV_STRIDE * GV_UNROLL) {
    uint32_t words[GV_UNROLL][GV_COLS];
#pragma unroll
    for (int u = 0; u < GV_UNROLL; ++u) {
      const int w = wb + GV_STRIDE * u;
#pragma unroll
      for (int c = 0; c < GV_COLS; ++c) words[u][c] = w < n_words ? __ldg(wrow[c] + w) : 0u;
    }
#pragma unroll
    for (int u = 0; u < GV_UNROLL; ++u) {
      const int w = wb + GV_STRIDE * u;
      if (w >= n_words) break;
      const int k0 = w * CPW;
      float xv[MR][CPW];
#pragma unroll
      for (int r = 0; r < MR; ++r) {
        if (r < M) {
          load_run<T, CPW>(x + static_cast<size_t>(r) * K + k0, xv[r]);
        } else {
#pragma unroll
          for (int j = 0; j < CPW; ++j) xv[r][j] = 0.f;
        }
      }
      int blk = k0 / block_size;
      int rem = k0 - blk * block_size;
      float s[GV_COLS];
#pragma unroll
      for (int c = 0; c < GV_COLS; ++c) s[c] = __bfloat162float(srow[c][blk]);
#pragma unroll
      for (int j = 0; j < CPW; ++j) {
        if (rem == block_size) {  // this word straddles two scale blocks
          ++blk;
          rem = 0;
#pragma unroll
          for (int c = 0; c < GV_COLS; ++c) s[c] = __bfloat162float(srow[c][blk]);
        }
        ++rem;
#pragma unroll
        for (int c = 0; c < GV_COLS; ++c) {
          const float wv = Act<T>::round(lut[(words[u][c] >> (j * BITS)) & MASK] * s[c]);
#pragma unroll
          for (int r = 0; r < MR; ++r) acc[c][r] = fmaf(xv[r][j], wv, acc[c][r]);
        }
      }
    }
  }

#pragma unroll
  for (int c = 0; c < GV_COLS; ++c)
#pragma unroll
    for (int r = 0; r < MR; ++r)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[c][r] += __shfl_xor_sync(0xffffffffu, acc[c][r], off);

  // every lane holds its warp's sums; lane c * MR + r hands (r, n0 + c) on
#pragma unroll
  for (int c = 0; c < GV_COLS; ++c)
#pragma unroll
    for (int r = 0; r < MR; ++r)
      if (lane == c * MR + r) part[warp][c * MR + r] = acc[c][r];
  __syncthreads();
  if (threadIdx.x < GV_COLS * MR) {
    const int c = threadIdx.x / MR;
    const int r = threadIdx.x - c * MR;
    float sum = 0.f;
#pragma unroll
    for (int wp = 0; wp < GV_WARPS; ++wp) sum += part[wp][threadIdx.x];
    if (n0 + c < N && r < M) y[static_cast<size_t>(r) * N + n0 + c] = Act<T>::store(sum);
  }
}

constexpr int TG_M = 64;          // output rows per block
constexpr int TG_N = 64;          // output columns per block
constexpr int TG_WORDS = 4;       // packed words per column per K step
constexpr int TG_THREADS = 256;   // 16 x 16 threads, 4 x 4 outputs each
constexpr int TG_MAX_KC = TG_WORDS * 10;  // codes per K step; cpw <= 10 (bits >= 3)

__global__ void __launch_bounds__(TG_THREADS)
qgemm_simt_kernel(const float* __restrict__ x, const uint32_t* __restrict__ packed,
                  const bf16* __restrict__ scales, const float* __restrict__ codebook,
                  float* __restrict__ y, int M, int N, int K, int n_words, int bits,
                  int block_size) {
  __shared__ float lut[256];
  __shared__ __align__(16) float ws[TG_MAX_KC][TG_N + 4];  // W^T tile [k][n]
  __shared__ __align__(16) float xs[TG_MAX_KC][TG_M + 4];  // x tile [k][m]
  const int cpw = 32 / bits;
  const unsigned mask = (1u << bits) - 1u;
  const int kc = TG_WORDS * cpw;
  const int n_blocks = K / block_size;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int n0 = blockIdx.x * TG_N;
  const int m0 = blockIdx.y * TG_M;
  fill_lut(lut, 1 << bits, codebook);

  // the one packed word of the weight tile this thread decodes per K step
  const int wc = tid / TG_WORDS;
  const int wi = tid % TG_WORDS;
  const int wn = n0 + wc;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int w0 = 0; w0 < n_words; w0 += TG_WORDS) {
    __syncthreads();  // the previous tiles are consumed (first step: lut is filled)
    {
      const int w = w0 + wi;
      const bool ok = wn < N && w < n_words;
      const uint32_t word = ok ? packed[static_cast<size_t>(wn) * n_words + w] : 0u;
      const int k0 = w * cpw;
      int blk = k0 / block_size;
      int rem = k0 - blk * block_size;
      float s = ok ? __bfloat162float(scales[static_cast<size_t>(wn) * n_blocks + blk]) : 0.f;
      for (int j = 0; j < cpw; ++j) {
        if (rem == block_size) {
          ++blk;
          rem = 0;
          s = ok ? __bfloat162float(scales[static_cast<size_t>(wn) * n_blocks + blk]) : 0.f;
        }
        ++rem;
        ws[wi * cpw + j][wc] = ok ? lut[(word >> (j * bits)) & mask] * s : 0.f;
      }
    }
    for (int i = tid; i < TG_M * kc; i += TG_THREADS) {
      const int r = i / kc;
      const int kk = i - r * kc;
      const int m = m0 + r;
      const int k = w0 * cpw + kk;
      xs[kk][r] = (m < M && k < K) ? x[static_cast<size_t>(m) * K + k] : 0.f;
    }
    __syncthreads();
    for (int kk = 0; kk < kc; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) y[static_cast<size_t>(m) * N + n] = acc[i][j];
    }
  }
}

struct Args {
  const void* x;
  const uint32_t* packed;
  const bf16* scales;
  const float* codebook;
  void* y;
  int M, N, K, n_words, block_size;
  cudaStream_t stream;
};

template <typename T, int BITS, int MR>
void gemv_launch(const Args& a) {
  const dim3 grid((a.N + GV_COLS - 1) / GV_COLS);
  qgemv_kernel<T, BITS, MR><<<grid, GV_WARPS * 32, 0, a.stream>>>(
      static_cast<const T*>(a.x), a.packed, a.scales, a.codebook, static_cast<T*>(a.y), a.M,
      a.N, a.K, a.n_words, a.block_size);
}

template <typename T, int BITS>
void gemv_rows(const Args& a) {
  if (a.M <= 1) {
    gemv_launch<T, BITS, 1>(a);
  } else if (a.M <= 2) {
    gemv_launch<T, BITS, 2>(a);
  } else if (a.M <= 4) {
    gemv_launch<T, BITS, 4>(a);
  } else {
    gemv_launch<T, BITS, 8>(a);
  }
}

template <typename T>
bool gemv_bits(int bits, const Args& a) {
  switch (bits) {
    case 3: gemv_rows<T, 3>(a); return true;
    case 4: gemv_rows<T, 4>(a); return true;
    case 5: gemv_rows<T, 5>(a); return true;
    case 6: gemv_rows<T, 6>(a); return true;
    case 7: gemv_rows<T, 7>(a); return true;
    case 8: gemv_rows<T, 8>(a); return true;
    default: return false;
  }
}

Args make_args(const void* x, const void* packed, const void* scales, const void* codebook,
               void* y, int M, int N, int K, int n_words, int block_size, void* stream) {
  return Args{x, static_cast<const uint32_t*>(packed), static_cast<const bf16*>(scales),
              static_cast<const float*>(codebook), y, M, N, K, n_words, block_size,
              static_cast<cudaStream_t>(stream)};
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape or bit width it does not take.

extern "C" int qmatmul_gemv(const void* x, const void* packed, const void* scales,
                            const void* codebook, void* y, int M, int N, int K, int n_words,
                            int bits, int block_size, int x_is_bf16, void* stream) {
  if (M < 1 || M > 8 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Args a = make_args(x, packed, scales, codebook, y, M, N, K, n_words, block_size,
                           stream);
  const bool ok = x_is_bf16 ? gemv_bits<bf16>(bits, a) : gemv_bits<float>(bits, a);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int qmatmul_gemm_f32(const void* x, const void* packed, const void* scales,
                                const void* codebook, void* y, int M, int N, int K,
                                int n_words, int bits, int block_size, void* stream) {
  if (M < 1 || N < 1 || bits < 3 || bits > 8) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + TG_N - 1) / TG_N, (M + TG_M - 1) / TG_M);
  qgemm_simt_kernel<<<grid, TG_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const uint32_t*>(packed),
      static_cast<const bf16*>(scales), static_cast<const float*>(codebook),
      static_cast<float*>(y), M, N, K, n_words, bits, block_size);
  return static_cast<int>(cudaGetLastError());
}
