// Fused k-bit dequant-GEMM for the operands qgemv_sm90.cu and qgemm_sm90.cu
// do not take (sm_90a): the decode GEMV for f32 activations (and bf16 ones
// whose scale blocks split a group of 4 codes), on the tensor cores in TF32,
// and the f32-activation tiled product on the CUDA cores.
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
// written in x's type (f32 or bf16).  Both kernels take K % B == 0 and the
// rows as stored, n_words == ceil(K / cpw): words past a row's end read as
// zero, x past K as zero (so the last word's spare codes multiply zero),
// and scales past K / B as zero, so no caller pads the weight.
//
//   qgemv (M <= 8, decode, what kernels/qmatmul.py:gemv_route does not send
//     to qgemv_sm90.cu: f32 x, and bf16 x whose scale blocks split a group
//     of 4 codes).  Bound on an H100 SXM by bytes: the packed words and bf16
//     scales, with x in and y out (1.134 ms for a Qwen2-7B decode step's 197
//     matrices at 4 bits, b64, f32 x, M = 4, at 3.35 TB/s).  Multiplied on
//     the CUDA cores, an FMA a code, column and row after a table read and
//     a scale product a code and column, it runs at 5.3x that (PERF.md).
//     Here mma.sync.m16n8k8 in TF32 takes the products: A is 16 output
//     columns x 8 codes decoded from the packed words, B x's M <= 8 rows
//     (rows >= M are zero), which fit n8 exactly, and a row's sums do not
//     depend on the other rows (bit-identical at M = 1 and 8).  TF32 keeps
//     11 significant bits, so an f32 operand v is split, hi = cvt.rna.tf32(v),
//     lo = v - hi, and three products are summed, lo.hi + hi.lo + hi.hi
//     (3xTF32; the dropped lo.lo is ~2^-22 of a product).  The codebook is
//     split once a block into a table of (hi, lo) pairs in shared memory; a
//     code decodes with a shift and a mask (at 4 bits a byte permute) and
//     one table read.  Where every value is TF32 already (the float
//     codebooks at 3 and 4 bits), the block reads hi alone (4 bytes a code)
//     and skips lo.hi.  x is split where a lane loads it.  With f32 x and
//     scale blocks that hold whole groups (B % (4 * run) == 0 below: B = 64
//     at 4, 7 and 8 bits), the scale is taken out of the products: a group's
//     products are summed unscaled, one accumulator a product so that they
//     do not wait on each other, and the sums scaled once (s * sum(cb . x)
//     differs from sum(f32(cb * s) . x) by f32 rounding alone).  Elsewhere
//     (3, 5 and 6 bits at B = 64, odd blocks, and bf16 x, whose weight the
//     TPU kernel rounds to bf16 before the product) each code is scaled,
//     rounded to x's type and then split; a bf16 weight and bf16 x are TF32
//     already, so one product a step is exact.
//     Layout: a block owns GV_COLS = 32 output columns, two m16 tiles a warp
//     (grid ceil(N / 32)); lane (g, t) reads columns n0 + 8 r + g, r < 4.  A
//     column's words are cut into groups of 4 runs of 2 words, lane t taking
//     run t by one 8-byte load: 20, 16, 12, 10, 8 and 8 codes at 3 to 8 bits.
//     Step s of a group takes codes 2s and 2s + 1 of every lane's run as
//     logical k t and t + 4, so a step's 8 codes lie in one group, and lane
//     (g, t)'s B fragment is x[g] at its own two codes: neighbours in x.
//     The block's warps take the groups in turn, from N alone 4, 8 or 16
//     warps a block so that a launch puts 32 warps on every SM where the
//     columns allow; their accumulator tiles are summed through shared
//     memory in warp order.  What holds it at ~4x its bound (PERF.md,
//     scripts/gemv_f32.py --ablate): no single part; cutting the products,
//     the decode, the word loads, the x loads or the scale loads each saves
//     5-15 %.  A 512-column launch costs ~10 us on latency alone.
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
  static constexpr bool IS_F32 = true;
  static __device__ __forceinline__ float from_raw(float v) { return v; }
  static __device__ __forceinline__ float store(float v) { return v; }
  static __device__ __forceinline__ float round(float v) { return v; }
};

template <>
struct Act<bf16> {
  using Raw = unsigned short;
  static constexpr bool IS_F32 = false;
  static __device__ __forceinline__ float from_raw(unsigned short v) {
    return __uint_as_float(static_cast<unsigned>(v) << 16);
  }
  static __device__ __forceinline__ bf16 store(float v) { return __float2bfloat16_rn(v); }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

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

// The N activations at p, widened to f32, by the widest vector loads that
// N * sizeof(T) bytes allow; p lies on a multiple of that width (the
// caller checks).
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float bf16_bits_to_float(unsigned short v) {
  return __uint_as_float(static_cast<unsigned>(v) << 16);
}

// ---------------------------------------------------------------------------
// qgemv: M <= 8 rows, on the tensor cores in TF32

// warps a block: the fewest of GV_MIN_WARPS, 2 * GV_MIN_WARPS, ...
// GV_MAX_WARPS that put GV_FILL_PER_SM warps on every SM (from N alone)
constexpr int GV_MIN_WARPS = 4;
constexpr int GV_MAX_WARPS = 16;
constexpr int GV_FILL_PER_SM = 32;
constexpr int GV_OCCUPANCY = 24;  // warps an SM must hold (caps the registers)
constexpr int GV_TILES = 2;       // m16 tiles a warp: 16 * GV_TILES output columns a block
constexpr int GV_COLS = 16 * GV_TILES;
constexpr int GV_LANE_WORDS = 2;  // words a lane reads of each of its columns a chunk

template <int BITS>
struct GvCfg {
  static constexpr int CPW = 32 / BITS;
  static constexpr int RUN = 2;                      // words of a column a lane takes a group
  static constexpr int RUN_CODES = RUN * CPW;        // 20, 16, 12, 10, 8, 8 at 3 to 8 bits
  static constexpr int STEPS = RUN_CODES / 2;        // k8 products a group
  static constexpr int GROUP_WORDS = 4 * RUN;        // a column's words a group: 4 lanes' runs
  static constexpr int GROUP_CODES = 4 * RUN_CODES;  // 80, 64, 48, 40, 32, 32
  static constexpr int UNROLL = GV_LANE_WORDS / RUN;  // groups a chunk
};

// v rounded to TF32 (10 mantissa bits, to nearest, ties away), as an f32
__device__ __forceinline__ float to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return __uint_as_float(r);
}

// the f32 (pair) at shared address `addr`: a table's address plus a code's
// byte offset, which ptxas folds into one LDS with an immediate base
__device__ __forceinline__ float lds_f32(uint32_t addr) {
  float v;
  asm("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}
__device__ __forceinline__ float2 lds_f32x2(uint32_t addr) {
  float2 v;
  asm("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr));
  return v;
}

// d += A . B on the tensor cores, m16n8k8, TF32 operands (the 13 low bits
// of each f32 are not read), f32 sums
__device__ __forceinline__ void mma_tf32(float (&d)[4], const float (&a)[4], float b0, float b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])), "r"(__float_as_uint(a[2])),
        "r"(__float_as_uint(a[3])), "r"(__float_as_uint(b0)), "r"(__float_as_uint(b1)));
}

// A lane's run of one column: its RUN words, and the byte offset into the
// table (8-byte entries) of its code j (word j / CPW, bits (j % CPW) *
// BITS).  At 4 bits a word's 8 offsets come from two shifts and masks
// (even: codes 0, 2, 4, 6, odd: 1, 3, 5, 7, one a byte) and a byte permute
// each; elsewhere from a shift and a mask each.
template <int BITS, int RUN>
struct Run {
  static constexpr int CPW = 32 / BITS;
  uint32_t w[RUN];
  uint32_t even[RUN], odd[RUN];

  __device__ __forceinline__ void prepare() {
    if constexpr (BITS == 4) {
#pragma unroll
      for (int q = 0; q < RUN; ++q) {
        even[q] = (w[q] << 3) & 0x78787878u;
        odd[q] = (w[q] >> 1) & 0x78787878u;
      }
    }
  }
  __device__ __forceinline__ uint32_t offset(int j) const {
    if constexpr (BITS == 4) {
      const int q = j / 8;
      return __byte_perm(j % 2 ? odd[q] : even[q], 0u, 0x4440u + (j % 8) / 2);
    } else {
      constexpr uint32_t MASK8 = ((1u << BITS) - 1u) << 3;
      const uint32_t word = w[j / CPW];
      const int sh = (j % CPW) * BITS;
      return (sh >= 3 ? word >> (sh - 3) : word << (3 - sh)) & MASK8;
    }
  }
};

// A lane's columns n0 + 8 r + g: their packed rows and scale rows.
template <int ROWS>
struct LaneCols {
  const uint32_t* w[ROWS];
  const unsigned short* s[ROWS];
};

// The warp's chunks (warp, warp + WARPS, ...) of the lane's columns into
// d.  GS: the scale blocks hold whole groups (B % GROUP_CODES == 0), so a
// group's codes share one scale a column.  With f32 x that scale is taken
// out of the products (FACTOR): a group's products are summed unscaled
// from the table's TF32 parts (hi, lo) of each code value, then scaled
// once; EXACT: every value is TF32 (lo = 0), so the table's hi alone is
// read and the lo . hi product is not issued.  Otherwise each code is
// scaled, rounded to x's type and split after its table read.
template <typename T, int BITS, int WARPS, bool GS, bool EXACT>
__device__ __forceinline__ void qgemv_chunks(const T* __restrict__ xrow, bool has_x,
                                             const LaneCols<2 * GV_TILES>& cols,
                                             uint32_t tab_addr, float (&d)[GV_TILES][4], int K,
                                             int n_words, int block, int lg_block, int n_blocks) {
  using C = GvCfg<BITS>;
  using Raw = typename Act<T>::Raw;
  constexpr bool F32 = Act<T>::IS_F32;
  constexpr bool FACTOR = F32 && GS;
  // products a step: lo . hi (unless EXACT), hi . lo, hi . hi (3xTF32), or
  // the one product of bf16 operands, which are TF32 already
  constexpr int P = !F32 ? 1 : FACTOR && EXACT ? 2 : 3;
  constexpr int ROWS = 2 * GV_TILES;
  constexpr int VB = widest_vec(C::RUN_CODES * static_cast<int>(sizeof(T)));
  const int t = threadIdx.x & 3;
  // every row's runs start on a multiple of VB bytes (x does, the wrapper checks)
  const bool xvec = static_cast<long>(K) * static_cast<long>(sizeof(T)) % VB == 0;
  // a lane's two words are one aligned 8-byte load
  const bool wvec = n_words % 2 == 0 && reinterpret_cast<uintptr_t>(cols.w[0]) % 8 == 0;
  const auto scale_at = [&](int r, int b) {
    return b < n_blocks ? bf16_bits_to_float(__ldg(cols.s[r] + b)) : 0.f;
  };
  const int n_groups = (n_words + C::GROUP_WORDS - 1) / C::GROUP_WORDS;
  const int n_chunks = (n_groups + C::UNROLL - 1) / C::UNROLL;
  for (int c = threadIdx.x / 32; c < n_chunks; c += WARPS) {
    // the chunk's words, zero past the row's end
    Run<BITS, C::RUN> run[C::UNROLL][ROWS];
#pragma unroll
    for (int u = 0; u < C::UNROLL; ++u)
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int w = (c * C::UNROLL + u) * C::GROUP_WORDS + t * C::RUN;
        if (wvec) {
          const uint2 v = w < n_words ? __ldg(reinterpret_cast<const uint2*>(cols.w[r] + w))
                                      : make_uint2(0u, 0u);
          run[u][r].w[0] = v.x;
          run[u][r].w[1] = v.y;
        } else {
#pragma unroll
          for (int q = 0; q < C::RUN; ++q)
            run[u][r].w[q] = w + q < n_words ? __ldg(cols.w[r] + w + q) : 0u;
        }
      }
    // x[g] at each group's run (zero past K: the last word's spare codes),
    // by vector loads where the chunk lies inside K, and each column's scale
    // at each run's first code; all issued before the chunk's products
    const int kc = c * C::UNROLL * C::GROUP_CODES + t * C::RUN_CODES;  // group 0's run
    float xv[C::UNROLL][C::RUN_CODES];
    if (has_x && xvec && kc + (C::UNROLL - 1) * C::GROUP_CODES + C::RUN_CODES <= K) {
#pragma unroll
      for (int u = 0; u < C::UNROLL; ++u)
        load_run<T, C::RUN_CODES>(xrow + kc + u * C::GROUP_CODES, xv[u]);
    } else {
#pragma unroll
      for (int u = 0; u < C::UNROLL; ++u)
#pragma unroll
        for (int j = 0; j < C::RUN_CODES; ++j) {
          const int k = kc + u * C::GROUP_CODES + j;
          xv[u][j] = has_x && k < K
                         ? Act<T>::from_raw(__ldg(reinterpret_cast<const Raw*>(xrow) + k))
                         : 0.f;
        }
    }
    float sg[C::UNROLL][ROWS];
#pragma unroll
    for (int u = 0; u < C::UNROLL; ++u) {
      const int k0 = kc + u * C::GROUP_CODES;
      const int b = lg_block >= 0 ? k0 >> lg_block : k0 / block;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) sg[u][r] = scale_at(r, b);
    }
#pragma unroll
    for (int u = 0; u < C::UNROLL; ++u) {
      const int k0 = kc + u * C::GROUP_CODES;  // the run's first code
      // (!GS) the run's block and the code where the next begins
      int b = lg_block >= 0 ? k0 >> lg_block : k0 / block;
      int next = (b + 1) * block;
      float s[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        s[r] = sg[u][r];
        run[u][r].prepare();
      }
      // the group's sums, one accumulator a product, so that a step's
      // products do not wait on each other
      float cs[GV_TILES][P][4] = {};
#pragma unroll
      for (int st = 0; st < C::STEPS; ++st) {
        // codes 2 st and 2 st + 1 of the run are logical k t and t + 4:
        // a0 (column g, k t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
        float ahi[GV_TILES][4], alo[GV_TILES][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = 2 * st + h;
          if constexpr (!GS) {
            if (k0 + j == next) {
              ++b;
              next += block;
#pragma unroll
              for (int r = 0; r < ROWS; ++r) s[r] = scale_at(r, b);
            }
          }
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            const int e = r % 2 + 2 * h;
            if constexpr (FACTOR && EXACT) {
              ahi[r / 2][e] = lds_f32(tab_addr + run[u][r].offset(j));
            } else if constexpr (FACTOR) {
              const float2 v = lds_f32x2(tab_addr + run[u][r].offset(j));
              ahi[r / 2][e] = v.x;
              alo[r / 2][e] = v.y;
            } else {
              const float w = Act<T>::round(lds_f32(tab_addr + run[u][r].offset(j)) * s[r]);
              const float hi = F32 ? to_tf32(w) : w;
              ahi[r / 2][e] = hi;
              alo[r / 2][e] = w - hi;
            }
          }
        }
        const float x0 = xv[u][2 * st], x1 = xv[u][2 * st + 1];
        const float xh0 = F32 ? to_tf32(x0) : x0;
        const float xh1 = F32 ? to_tf32(x1) : x1;
#pragma unroll
        for (int tile = 0; tile < GV_TILES; ++tile) {
          if constexpr (P == 3) mma_tf32(cs[tile][0], alo[tile], xh0, xh1);
          if constexpr (P >= 2) mma_tf32(cs[tile][P - 2], ahi[tile], x0 - xh0, x1 - xh1);
          mma_tf32(cs[tile][P - 1], ahi[tile], xh0, xh1);
        }
      }
#pragma unroll
      for (int tile = 0; tile < GV_TILES; ++tile)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float sum = cs[tile][0][e];
#pragma unroll
          for (int q = 1; q < P; ++q) sum += cs[tile][q][e];
          d[tile][e] = FACTOR ? fmaf(s[2 * tile + e / 2], sum, d[tile][e]) : d[tile][e] + sum;
        }
    }
  }
}

template <typename T, int BITS, int WARPS, bool GS>
__global__ void __launch_bounds__(WARPS * 32, GV_OCCUPANCY > WARPS ? GV_OCCUPANCY / WARPS : 1)
qgemv_kernel(const T* __restrict__ x, const uint32_t* __restrict__ packed,
             const unsigned short* __restrict__ scales, const float* __restrict__ codebook,
             T* __restrict__ y, int M, int N, int K, int n_words, int block, int lg_block) {
  constexpr bool FACTOR = Act<T>::IS_F32 && GS;
  constexpr int ROWS = 2 * GV_TILES;
  __shared__ float2 tab[1 << BITS];
  __shared__ float part[WARPS][32][4 * GV_TILES];
  bool tf32 = true;
  for (int i = threadIdx.x; i < (1 << BITS); i += blockDim.x) {
    const float v = codebook[i];
    const float hi = to_tf32(v);
    tab[i] = FACTOR ? make_float2(hi, v - hi) : make_float2(v, 0.f);
    tf32 = tf32 && hi == v;
  }
  // every code value is TF32 (the float codebooks at 3 and 4 bits among them)
  const bool exact = __syncthreads_and(tf32);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int n0 = blockIdx.x * GV_COLS;
  const int n_blocks = K / block;
  // row r is column n0 + 8 r + g (past N: column N - 1, never written)
  LaneCols<ROWS> cols;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int n = min(n0 + 8 * r + g, N - 1);
    cols.w[r] = packed + static_cast<size_t>(n) * n_words;
    cols.s[r] = scales + static_cast<size_t>(n) * n_blocks;
  }
  const bool has_x = g < M;
  const T* xrow = x + static_cast<size_t>(has_x ? g : 0) * K;
  const uint32_t tab_addr = smem_addr(tab);
  float d[GV_TILES][4] = {};
  if (FACTOR && exact) {
    if constexpr (FACTOR)
      qgemv_chunks<T, BITS, WARPS, GS, true>(xrow, has_x, cols, tab_addr, d, K, n_words, block,
                                             lg_block, n_blocks);
  } else {
    qgemv_chunks<T, BITS, WARPS, GS, false>(xrow, has_x, cols, tab_addr, d, K, n_words, block,
                                            lg_block, n_blocks);
  }

  // y[m, n0 + 16 tile + n] is e = 4 tile + 2 (n / 8) + m % 2 of lane
  // 4 (n % 8) + m / 2 in every warp; the warps' sums are added in order
#pragma unroll
  for (int tile = 0; tile < GV_TILES; ++tile)
#pragma unroll
    for (int e = 0; e < 4; ++e) part[warp][lane][4 * tile + e] = d[tile][e];
  __syncthreads();
  for (int i = threadIdx.x; i < 8 * GV_COLS; i += WARPS * 32) {
    const int m = i / GV_COLS;
    const int n = i % GV_COLS;
    const int src = (n & 7) * 4 + (m >> 1);
    const int e = 4 * (n / 16) + ((n >> 3) & 1) * 2 + (m & 1);
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) sum += part[w][src][e];
    if (m < M && n0 + n < N) y[static_cast<size_t>(m) * N + n0 + n] = Act<T>::store(sum);
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

struct GemvArgs {
  const void* x;
  const uint32_t* packed;
  const unsigned short* scales;
  const float* codebook;
  void* y;
  int M, N, K, n_words, block, lg_block;
  cudaStream_t stream;
};

template <typename T, int BITS, int WARPS>
void gemv_launch(const GemvArgs& a) {
  const dim3 grid((a.N + GV_COLS - 1) / GV_COLS);
  const T* x = static_cast<const T*>(a.x);
  T* y = static_cast<T*>(a.y);
  if (a.block % GvCfg<BITS>::GROUP_CODES == 0)
    qgemv_kernel<T, BITS, WARPS, true><<<grid, WARPS * 32, 0, a.stream>>>(
        x, a.packed, a.scales, a.codebook, y, a.M, a.N, a.K, a.n_words, a.block, a.lg_block);
  else
    qgemv_kernel<T, BITS, WARPS, false><<<grid, WARPS * 32, 0, a.stream>>>(
        x, a.packed, a.scales, a.codebook, y, a.M, a.N, a.K, a.n_words, a.block, a.lg_block);
}

// streaming multiprocessors of the current device, read once per device
int sm_count() {
  static int counts[SG_MAX_DEVICES] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= SG_MAX_DEVICES) return 132;
  if (counts[dev] == 0 &&
      cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    counts[dev] = 132;
  return counts[dev];
}

template <typename T, int BITS>
void gemv_warps(const GemvArgs& a) {
  static_assert(GV_MIN_WARPS >= 4 && GV_MAX_WARPS <= 16, "4, 8 or 16 warps a block");
  const long blocks = (a.N + GV_COLS - 1) / GV_COLS;
  const long fill = static_cast<long>(sm_count()) * GV_FILL_PER_SM;
  int warps = GV_MIN_WARPS;
  while (warps < GV_MAX_WARPS && blocks * warps < fill) warps *= 2;
  if (warps == 4) gemv_launch<T, BITS, 4>(a);
  else if (warps == 8) gemv_launch<T, BITS, 8>(a);
  else gemv_launch<T, BITS, 16>(a);
}

template <typename T>
bool gemv_bits(int bits, const GemvArgs& a) {
  switch (bits) {
    case 3: gemv_warps<T, 3>(a); return true;
    case 4: gemv_warps<T, 4>(a); return true;
    case 5: gemv_warps<T, 5>(a); return true;
    case 6: gemv_warps<T, 6>(a); return true;
    case 7: gemv_warps<T, 7>(a); return true;
    case 8: gemv_warps<T, 8>(a); return true;
    default: return false;
  }
}

// log2 of v, or -1 where v is not a power of two
int log2_or_minus1(int v) {
  if (v & (v - 1)) return -1;
  int lg = 0;
  while ((1 << lg) < v) ++lg;
  return lg;
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape or bit width it does not take.

// Rows as stored: n_words == ceil(K / cpw), the last word's spare codes
// multiplying zero x; K % B == 0; x on a 16-byte boundary.
extern "C" int qmatmul_gemv(const void* x, const void* packed, const void* scales,
                            const void* codebook, void* y, int M, int N, int K, int n_words,
                            int bits, int block_size, int x_is_bf16, void* stream) {
  if (M < 1 || M > 8 || N < 1 || K < 1 || bits < 3 || bits > 8 || block_size < 1 ||
      K % block_size != 0 || n_words != (K + 32 / bits - 1) / (32 / bits) ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const GemvArgs a{x, static_cast<const uint32_t*>(packed),
                   static_cast<const unsigned short*>(scales),
                   static_cast<const float*>(codebook), y, M, N, K, n_words, block_size,
                   log2_or_minus1(block_size), static_cast<cudaStream_t>(stream)};
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
  const int lg = log2_or_minus1(block_size);
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
