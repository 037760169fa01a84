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
//     send to qgemv_sm90.cu's tensor cores: f32 x, and bf16 x whose scale
//     blocks split a group of 4 codes, or at 4 bits a word): a block owns 4 output columns
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
//     tensor cores would round f32 activations (TF32 keeps ~3 digits).
//     Bound by its f32 operations (67 TFLOP/s outside the tensor cores):
//     0.061 ms for the paper sweep's 12 matrices at M = 1024.  A block
//     owns 128 rows x 64 columns, each of its 128 threads 8 x 8 outputs
//     (rows tm + 16i, columns 4tn .. 4tn + 3 and 32 + 4tn ..), so a k costs
//     a thread 64 FMAs against 4 shared-memory loads of 16 bytes.  K runs
//     in steps of KW whole packed words a column (whole uint4s, 32 to 48
//     codes): the step's x tile [128][BK] and words [64][KW] are copied by
//     16-byte cp.async (4-byte where rows are not whole uint4s) into a
//     double buffer while the block computes the previous step, then the
//     words are decoded once, scaled, into an f32 tile [BK][64] in shared
//     memory.  The x tile's pitch is BK + 4 floats, so the 4 rows a warp
//     reads at one k lie in 4 bank groups; the weight tile is read as 8
//     distinct float4s a warp.  Three blocks fit an SM (168 registers a
//     thread); where one 1024-row call would have fewer than 3 blocks an SM,
//     K is split across blocks (kernels/qmatmul.py:
//     simt_split, from N, K and the bit width only, so a row's sums do not
//     depend on the rows sharing the call), each writing f32 partial sums
//     that a second pass adds in a fixed order.
// Both take K % B == 0.  qgemv takes K == n_words * cpw (the wrapper pads K
// to whole words, kernels/qmatmul.py:pad_to_whole_words); qgemm_simt takes
// the rows as stored, n_words == ceil(K / cpw), since its copies zero x
// past K and the words past a row's end and its decode zeroes the scales
// past K.

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

// qgemm_simt: BM x BN output tiles, 8 x 8 a thread, K in steps of KW whole
// packed words a column (whole uint4s, at least 64 codes), staged by a
// cp.async double buffer and decoded once a step into shared memory.
constexpr int SG_BN = 64;                  // output columns a block
constexpr int SG_THREADS = 128;            // 8 x 8 outputs each
constexpr int SG_TN = SG_BN / 8;           // threads across a tile's columns
constexpr int SG_TM = SG_THREADS / SG_TN;  // threads across its rows
constexpr int SG_BM = 8 * SG_TM;           // rows of x a block
// blocks an SM must hold (caps the registers at 168); kernels/qmatmul.py:
// SIMT_BLOCKS_PER_SM splits K to bring a call's blocks to this many an SM
constexpr int SG_MIN_BLOCKS = 3;
constexpr int SG_MAX_DEVICES = 64;
static_assert(SG_THREADS % SG_BN == 0, "whole threads a decoded column");

template <int BITS>
struct SimtCfg {
  static constexpr int CPW = 32 / BITS;
  // words a column and K step: whole uint4s, at least 32 codes (4, 4, 8, 8,
  // 8 and 8 at 3 to 8 bits: 40, 32, 48, 40, 32 and 32 codes), which keeps a
  // block's shared memory at 46-71 KB, so 3 blocks fit an SM (steps of 64
  // codes, 2 blocks an SM, were slower on the card)
  static constexpr int KW = (32 + 4 * CPW - 1) / (4 * CPW) * 4;
  static constexpr int BK = KW * CPW;
  // x tile pitch in floats: BK + 4, so that the rows a warp reads at one k
  // fall in different 16-byte bank groups (pitch / 4 odd)
  static constexpr int XP = BK + 4;
  static constexpr int SP = SG_BN + 4;  // decoded weight tile pitch [BK][SP]
  static_assert(BK % 8 == 0 && (XP / 4) % 2 == 1, "conflict-free x rows");
  // words a thread decodes a step: the threads of a column split its KW words
  static constexpr int DW = KW / (SG_THREADS / SG_BN);
  static_assert(KW % (SG_THREADS / SG_BN) == 0, "whole words a decoding thread");
  static constexpr int X_FLOATS = SG_BM * XP;  // one x stage
  static constexpr int W_WORDS = SG_BN * KW;   // one stage of words
  static constexpr int SMEM = (2 * X_FLOATS + BK * SP + 256) * 4 + 2 * W_WORDS * 4;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 (or 4) bytes global -> shared, asynchronously; zero-filled when !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

struct SimtProblem {
  const float* x;
  const uint32_t* packed;
  const bf16* scales;
  const float* codebook;
  float* out;  // y [M, N], or the split's partial sums [split, M, N]
  int M, N, K, n_words, block_size, lg_block, split;
  bool x16, w16;  // x rows and word rows are whole, 16-byte aligned uint4s
};

// K step t's x tile [BM][BK] and words [BN][KW] into stage buffers, by
// cp.async (zero past M, K, N and the row's words)
template <int BITS>
__device__ __forceinline__ void simt_issue(const SimtProblem& p, float* xs, uint32_t* wr, int m0,
                                           int n0, int t) {
  using C = SimtCfg<BITS>;
  const int k0 = t * C::BK;
  if (p.x16) {
    for (int i = threadIdx.x; i < SG_BM * (C::BK / 4); i += SG_THREADS) {
      const int r = i / (C::BK / 4);
      const int c = i - r * (C::BK / 4);
      const int m = m0 + r;
      const int k = k0 + 4 * c;
      const bool ok = m < p.M && k < p.K;
      cp_async16(xs + r * C::XP + 4 * c, p.x + (ok ? static_cast<size_t>(m) * p.K + k : 0), ok);
    }
  } else {
    for (int i = threadIdx.x; i < SG_BM * C::BK; i += SG_THREADS) {
      const int r = i / C::BK;
      const int c = i - r * C::BK;
      const int m = m0 + r;
      const bool ok = m < p.M && k0 + c < p.K;
      cp_async4(xs + r * C::XP + c, p.x + (ok ? static_cast<size_t>(m) * p.K + k0 + c : 0), ok);
    }
  }
  const int w0 = t * C::KW;
  if (p.w16) {
    for (int i = threadIdx.x; i < SG_BN * (C::KW / 4); i += SG_THREADS) {
      const int r = i / (C::KW / 4);
      const int c = i - r * (C::KW / 4);
      const int n = n0 + r;
      const int w = w0 + 4 * c;
      const bool ok = n < p.N && w < p.n_words;
      cp_async16(wr + r * C::KW + 4 * c,
                 p.packed + (ok ? static_cast<size_t>(n) * p.n_words + w : 0), ok);
    }
  } else {
    for (int i = threadIdx.x; i < SG_BN * C::KW; i += SG_THREADS) {
      const int r = i / C::KW;
      const int c = i - r * C::KW;
      const int n = n0 + r;
      const bool ok = n < p.N && w0 + c < p.n_words;
      cp_async4(wr + r * C::KW + c,
                p.packed + (ok ? static_cast<size_t>(n) * p.n_words + w0 + c : 0), ok);
    }
  }
  cp_async_commit();
}

// The decoding thread's column (thread % BN) and first word of a step (the
// threads of a column take DW words each): a warp writes 32 consecutive
// columns of one k.
template <int BITS>
struct SimtDecoder {
  using C = SimtCfg<BITS>;
  int dn, q0, n;
  const bf16* srow;

  __device__ __forceinline__ SimtDecoder(const SimtProblem& p, int n0)
      : dn(threadIdx.x % SG_BN), q0((threadIdx.x / SG_BN) * C::DW), n(n0 + threadIdx.x % SG_BN) {
    srow = p.scales + static_cast<size_t>(min(n, p.N - 1)) * (p.K / p.block_size);
  }

  __device__ __forceinline__ int block_at(const SimtProblem& p, int k) const {
    return p.lg_block >= 0 ? k >> p.lg_block : k / p.block_size;
  }

  // where each word has one scale (B % cpw == 0): the scales of step t's
  // words, loaded a step ahead of their decode
  __device__ __forceinline__ void scales(const SimtProblem& p, int t, float (&s)[C::DW]) const {
#pragma unroll
    for (int q = 0; q < C::DW; ++q) {
      const int k = (t * C::KW + q0 + q) * C::CPW;
      s[q] = n < p.N && k < p.K ? __bfloat162float(srow[block_at(p, k)]) : 0.f;
    }
  }

  // step t's words (wr), decoded and scaled, into ws[k][n]
  __device__ __forceinline__ void decode(const SimtProblem& p, const uint32_t* wr,
                                         const float* lut, float* ws, int t,
                                         const float (&s)[C::DW]) const {
    constexpr unsigned MASK = (1u << BITS) - 1u;
    if (p.block_size % C::CPW == 0) {
#pragma unroll
      for (int q = 0; q < C::DW; ++q) {
        const uint32_t word = wr[dn * C::KW + q0 + q];
#pragma unroll
        for (int j = 0; j < C::CPW; ++j)
          ws[((q0 + q) * C::CPW + j) * C::SP + dn] = lut[(word >> (j * BITS)) & MASK] * s[q];
      }
    } else {  // words that straddle scale blocks: the block of each code
#pragma unroll 1
      for (int q = 0; q < C::DW; ++q) {
        const uint32_t word = wr[dn * C::KW + q0 + q];
        const int k0 = (t * C::KW + q0 + q) * C::CPW;
#pragma unroll
        for (int j = 0; j < C::CPW; ++j) {
          const int k = k0 + j;
          const float sc = n < p.N && k < p.K ? __bfloat162float(srow[block_at(p, k)]) : 0.f;
          ws[((q0 + q) * C::CPW + j) * C::SP + dn] = lut[(word >> (j * BITS)) & MASK] * sc;
        }
      }
    }
  }
};

template <int BITS>
__global__ void __launch_bounds__(SG_THREADS, SG_MIN_BLOCKS) qgemm_simt_kernel(SimtProblem p) {
  using C = SimtCfg<BITS>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);               // [2][BM][XP]
  float* ws = xs + 2 * C::X_FLOATS;                          // [BK][SP]
  float* lut = ws + C::BK * C::SP;                           // [256]
  uint32_t* wr = reinterpret_cast<uint32_t*>(lut + 256);     // [2][BN][KW]
  const int n0 = blockIdx.x * SG_BN;
  const int m0 = blockIdx.y * SG_BM;
  const int nk = (p.K + C::BK - 1) / C::BK;
  // this split's K steps, a fixed partition of nk that depends on K alone
  const int t_begin = static_cast<int>(static_cast<long>(blockIdx.z) * nk / p.split);
  const int t_end = static_cast<int>(static_cast<long>(blockIdx.z + 1) * nk / p.split);
  for (int i = threadIdx.x; i < (1 << BITS); i += SG_THREADS) lut[i] = p.codebook[i];
  const SimtDecoder<BITS> dec(p, n0);

  // thread (tm, tn): rows tm + TM i, i < 8; columns 4 tn .. 4 tn + 3 and
  // BN / 2 + 4 tn .. BN / 2 + 4 tn + 3
  const int tn = threadIdx.x % SG_TN;
  const int tm = threadIdx.x / SG_TN;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  float sc[C::DW];
  if (t_begin < t_end) {
    simt_issue<BITS>(p, xs, wr, m0, n0, t_begin);
    dec.scales(p, t_begin, sc);
  }
  for (int t = t_begin; t < t_end; ++t) {
    const int buf = (t - t_begin) & 1;
    cp_async_wait_all();
    __syncthreads();  // step t has landed for every thread; step t - 1 is consumed
    float sc_next[C::DW];
    if (t + 1 < t_end) {
      simt_issue<BITS>(p, xs + (buf ^ 1) * C::X_FLOATS, wr + (buf ^ 1) * C::W_WORDS, m0, n0,
                       t + 1);
      dec.scales(p, t + 1, sc_next);
    }
    dec.decode(p, wr + buf * C::W_WORDS, lut, ws, t, sc);
    __syncthreads();
    const float* xb = xs + buf * C::X_FLOATS + tm * C::XP;
#pragma unroll 2
    for (int kk = 0; kk < C::BK; kk += 4) {
      float4 a[8];  // rows tm + TM i, k kk .. kk + 3
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(xb + SG_TM * i * C::XP + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* wrow = ws + (kk + u) * C::SP + 4 * tn;
        const float4 b0 = *reinterpret_cast<const float4*>(wrow);
        const float4 b1 = *reinterpret_cast<const float4*>(wrow + SG_BN / 2);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float av = u == 0 ? a[i].x : u == 1 ? a[i].y : u == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < C::DW; ++q) sc[q] = sc_next[q];
  }

  float* out = p.out + static_cast<size_t>(blockIdx.z) * p.M * p.N;
  const bool vec = p.N % 4 == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + tm + SG_TM * i;
    if (m >= p.M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + SG_BN / 2 * h + 4 * tn;
      float* dst = out + static_cast<size_t>(m) * p.N + n;
      if (vec && n < p.N) {
        *reinterpret_cast<float4*>(dst) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < p.N) dst[j] = acc[i][4 * h + j];
      }
    }
  }
}

// y = sum over z of partial[z], z in order, 4 floats a thread (mn % 4 == 0)
// or 1
template <int V>
__global__ void simt_split_sum_kernel(const float* __restrict__ partial, float* __restrict__ y,
                                      size_t mn, int split) {
  const size_t i = (static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x) * V;
  if (i >= mn) return;
  if constexpr (V == 4) {
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int z = 0; z < split; ++z) {
      const float4 v = *reinterpret_cast<const float4*>(partial + static_cast<size_t>(z) * mn + i);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    *reinterpret_cast<float4*>(y + i) = s;
  } else {
    float s = 0.f;
    for (int z = 0; z < split; ++z) s += partial[static_cast<size_t>(z) * mn + i];
    y[i] = s;
  }
}

template <int BITS>
int simt_launch(SimtProblem p, float* y, float* workspace, cudaStream_t stream) {
  using C = SimtCfg<BITS>;
  const int nk = (p.K + C::BK - 1) / C::BK;
  if (p.split < 1 || p.split > nk || (p.split > 1 && workspace == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  static bool attr_set[SG_MAX_DEVICES] = {};  // the attribute is per device
  if (dev >= SG_MAX_DEVICES || !attr_set[dev]) {
    e = cudaFuncSetAttribute(qgemm_simt_kernel<BITS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < SG_MAX_DEVICES) attr_set[dev] = true;
  }
  p.out = p.split > 1 ? workspace : y;
  const dim3 grid((p.N + SG_BN - 1) / SG_BN, (p.M + SG_BM - 1) / SG_BM, p.split);
  qgemm_simt_kernel<BITS><<<grid, SG_THREADS, C::SMEM, stream>>>(p);
  if (p.split > 1) {
    const size_t mn = static_cast<size_t>(p.M) * p.N;
    if (mn % 4 == 0)
      simt_split_sum_kernel<4><<<static_cast<unsigned>((mn / 4 + 255) / 256), 256, 0, stream>>>(
          workspace, y, mn, p.split);
    else
      simt_split_sum_kernel<1><<<static_cast<unsigned>((mn + 255) / 256), 256, 0, stream>>>(
          workspace, y, mn, p.split);
  }
  return static_cast<int>(cudaGetLastError());
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
  if (M < 1 || M > 8 || N < 1 || bits < 3 || bits > 8 || block_size < 1 ||
      K % block_size != 0 || K != n_words * (32 / bits))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = make_args(x, packed, scales, codebook, y, M, N, K, n_words, block_size,
                           stream);
  const bool ok = x_is_bf16 ? gemv_bits<bf16>(bits, a) : gemv_bits<float>(bits, a);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// `workspace` is f32 [split, M, N] when split > 1 (kernels/qmatmul.py:
// simt_split picks the split from N, K and the bit width), else unused.
extern "C" int qmatmul_gemm_f32(const void* x, const void* packed, const void* scales,
                                const void* codebook, void* y, void* workspace, int M, int N,
                                int K, int n_words, int bits, int block_size, int split,
                                void* stream) {
  if (M < 1 || N < 1 || bits < 3 || bits > 8 || block_size < 1 || K % block_size != 0 ||
      n_words != (K + 32 / bits - 1) / (32 / bits))
    return static_cast<int>(cudaErrorInvalidValue);
  int lg = (block_size & (block_size - 1)) == 0 ? 0 : -1;  // log2 of a power-of-two block
  while (lg >= 0 && (1 << lg) < block_size) ++lg;
  const SimtProblem p{static_cast<const float*>(x), static_cast<const uint32_t*>(packed),
                      static_cast<const bf16*>(scales), static_cast<const float*>(codebook),
                      nullptr, M, N, K, n_words, block_size, lg, split,
                      K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0,
                      n_words % 4 == 0 && reinterpret_cast<uintptr_t>(packed) % 16 == 0};
  float* out = static_cast<float*>(y);
  float* ws = static_cast<float*>(workspace);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 3: return simt_launch<3>(p, out, ws, s);
    case 4: return simt_launch<4>(p, out, ws, s);
    case 5: return simt_launch<5>(p, out, ws, s);
    case 6: return simt_launch<6>(p, out, ws, s);
    case 7: return simt_launch<7>(p, out, ws, s);
    case 8: return simt_launch<8>(p, out, ws, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
