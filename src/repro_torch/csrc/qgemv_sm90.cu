// Fused k-bit dequant-GEMV at decode on Hopper's tensor cores (sm_90a):
// mma.sync with each packed word as its lane's A fragment.
//
// Replaces, for bf16 activations at 4, 7 and 8 bits, the decode half of the
// TPU kernel src/repro/kernels/qmatmul.py:97 (qmatmul_pallas; bodies
// _qmatmul_kernel, _unpack_tile, _dequant_codes).  csrc/qmatmul.cu's
// CUDA-core qgemv keeps f32 activations and 3, 5 and 6 bits; kernels/
// qmatmul.py:gemv_route picks between the two.
//
//   y[M, N] = x[M, K] . W^T,   W[n, k] = bf16_rn(dq(code[n, k]) * scale[n, k / B])
//
// M <= 8 rows (a decode batch), x and y bf16, sums f32.  code[n, k] is
// `bits` wide, packed cpw = 32 / bits to a 32-bit word (8 at 4 bits, 4 at 7
// and 8), low bits first; dq is the f32 codebook, scale bf16 [N, K / B].
// B % cpw == 0, so every word has one scale.  The weight is rounded to bf16
// after an f32 product, once, as the TPU kernel does (qmatmul.py:80-85);
// only the order of the f32 sums differs from dequantize-then-matmul.
//
// Bound on an H100 SXM (3.35 TB/s): bytes, the packed words and scales of W
// (1.13 ms for a Qwen2-7B decode step at 4 bits, b64).  The CUDA-core kernel
// issues ~12 instructions a code (decode, one FMA per row, x widened to f32
// for every word).  Here the tensor cores take the products and x as it is
// stored; what is left on the CUDA cores is the decode: the code's byte
// offset into the 2^bits-entry table in shared memory (at 4 bits one shift
// and one mask for four codes, then a byte permute each), the table read
// (one LDS, the table's address folded into it), an f32 product with the
// scale, and one cvt.rn.bf16x2.f32 a pair: about 4 instructions a code,
// whose issue alone takes about as long as the bytes.
//
// Products: mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 with
//   A = 16 output columns x k16 of W,  B = k16 x 8 rows of x (rows >= M are
//   zero),  D = the 16 x 8 f32 tile of y^T.
// Fragments (PTX ISA, "Matrix Fragments for mma.m16n8k16", .bf16), lane =
// 4g + t:
//   A  a0: row g,     k 2t, 2t+1    a1: row g + 8, k 2t, 2t+1
//      a2: row g,     k 2t+8, 2t+9  a3: row g + 8, k 2t+8, 2t+9
//   B  b0: k 2t, 2t+1, column g     b1: k 2t+8, 2t+9, column g
//   D  d0, d1: row g, columns 2t, 2t+1    d2, d3: row g + 8, the same
// A dot product does not depend on the order of k, so the kernel may pair
// codes and activations in any order that W and x share.  Each lane's word
// gives the logical k {2t, 2t+1, 2t+8, 2t+9} of a k16 step (4 codes, in
// order): the physical k then depends on (t, word, code) and not on g, and
// lane (g, t)'s B fragment is x[g] at the same physical k as its A.  Codes
// that are neighbours in a word are neighbours in k, so the B registers are
// x's bf16 pairs as stored: no conversion.
//
// Layout: a block owns 16 output columns (grid ceil(N / 16)).  Row n's words
// are cut into chunks of 16; in chunk c, lane (g, t) takes words 16c + 4t ..
// 16c + 4t + 3 of rows n0 + g and n0 + g + 8, one uint4 each (a row's 4
// lanes read 64 contiguous bytes).  Word q of lane t holds physical k =
// cpw * (16c + 4t + q) + j, j < cpw, and feeds cpw / 4 k16 steps (codes 4s
// .. 4s + 3 in step s); its x are cpw consecutive bf16 of row g, 16 bytes at
// 4 bits.  Where a row's word count is not a multiple of 4, or the words do
// not start on 16 bytes, the same words are read one at a time.  The
// block's warps take the chunks in turn (warp w: chunks w, w + WARPS, ...),
// loading each chunk's words, scales and x straight into registers; their
// accumulator tiles are summed through shared memory in warp order.  WARPS is 4, 8 or 16, the fewest
// that put 32 warps on every SM: 4 for gate/up and the lm_head (each warp
// keeps more K), 16 for the 3584- and 512-column shapes.  Registers are
// capped so that an SM holds 40 warps.  K and N tails are masked here:
// words past a row's end get zero x and a zero scale; columns past N read
// column N - 1 and are not written.
// Tried on the card and not kept (PERF.md): the next chunk's loads
// in registers ahead of the decode, and a per-warp cp.async ring of words
// in shared memory (both slower: more registers, or more shared-memory
// traffic beside the table reads), two m16 tiles a warp, 8 words a lane,
// two accumulator tiles a warp.
// K comes from kernels/ops.py padded to lcm(cpw, B): K == n_words * cpw.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

// warps a block: the fewest of MIN_WARPS, 2 * MIN_WARPS, ... MAX_WARPS that
// put FILL_PER_SM warps on every SM (a few thousand columns take 4, so each
// warp has more K to itself; Qwen2-7B's 3584- and 512-column shapes take
// 16, so that K is split finely enough to fill the card)
constexpr int MIN_WARPS = 4;
constexpr int MAX_WARPS = 16;
constexpr int FILL_PER_SM = 32;
constexpr int OCCUPANCY = 40;   // warps an SM must hold, if > 0 (caps the registers)
constexpr int ROWS = 2;         // W rows a lane reads: g and g + 8
constexpr int WPL = 4;          // words a lane takes per row and chunk: a uint4
constexpr int CHUNK = 4 * WPL;  // words per row and chunk: the row's 4 lanes

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // cvt.rn.bf16x2.f32
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float bf16_bits_to_float(unsigned short v) {
  return __uint_as_float(static_cast<unsigned>(v) << 16);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the f32 at shared address `addr`: a table's address plus a code's byte
// offset, which ptxas folds into one LDS with an immediate base
__device__ __forceinline__ float lds_f32(uint32_t addr) {
  float v;
  asm("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

// the byte offset into the table of code j of `word`
template <int BITS>
__device__ __forceinline__ uint32_t code_offset(uint32_t word, int j) {
  constexpr uint32_t MASK4 = ((1u << BITS) - 1u) << 2;
  return (j * BITS >= 2 ? word >> (j * BITS - 2) : word << (2 - j * BITS)) & MASK4;
}

// d += A . B on the tensor cores, bf16 operands, f32 sums
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a word's CPW codes, decoded and scaled, as bf16 pairs: pair p holds codes
// 2p (low) and 2p + 1.  lut is the table's shared address.
template <int BITS>
__device__ __forceinline__ void decode_word(uint32_t word, float s, uint32_t lut,
                                            uint32_t (&pr)[32 / BITS / 2]) {
  constexpr int PAIRS = 32 / BITS / 2;
  if constexpr (BITS == 4) {
    // the byte offsets of codes 0, 2, 4, 6 (even) and 1, 3, 5, 7 (odd), one
    // a byte, from one shift and one mask each; a byte permute takes each out
    const uint32_t even = (word << 2) & 0x3C3C3C3Cu;
    const uint32_t odd = (word >> 2) & 0x3C3C3C3Cu;
#pragma unroll
    for (int p = 0; p < PAIRS; ++p)
      pr[p] = pack_bf16x2(lds_f32(lut + __byte_perm(even, 0u, 0x4440u + p)) * s,
                          lds_f32(lut + __byte_perm(odd, 0u, 0x4440u + p)) * s);
  } else {
#pragma unroll
    for (int p = 0; p < PAIRS; ++p)
      pr[p] = pack_bf16x2(lds_f32(lut + code_offset<BITS>(word, 2 * p)) * s,
                          lds_f32(lut + code_offset<BITS>(word, 2 * p + 1)) * s);
  }
}

// a lane's view of the weight: its rows' words and scales, and the shape
struct Rows {
  const uint32_t* w[ROWS];        // packed words of columns n0 + g and n0 + g + 8
  const unsigned short* s[ROWS];  // their bf16 scales
  int n_words, wpb, lg_wpb;       // words a row, words a scale block and its log2 (or -1)
};

// the scale block of word w
__device__ __forceinline__ int block_of(const Rows& r, int w) {
  return r.lg_wpb >= 0 ? w >> r.lg_wpb : w / r.wpb;
}

// each of the lane's words from w0 on, zero past the row's end: one uint4
// a row, or single words where rows are not whole uint4s
template <bool VEC>
__device__ __forceinline__ void load_words(const Rows& r, int w0, uint32_t (&words)[ROWS][WPL]) {
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    if constexpr (VEC) {  // n_words % 4 == 0: the lane's four words are all in or all out
      const uint4 v = w0 < r.n_words ? __ldg(reinterpret_cast<const uint4*>(r.w[i] + w0))
                                     : make_uint4(0u, 0u, 0u, 0u);
      words[i][0] = v.x;
      words[i][1] = v.y;
      words[i][2] = v.z;
      words[i][3] = v.w;
    } else {
#pragma unroll
      for (int q = 0; q < WPL; ++q)
        words[i][q] = w0 + q < r.n_words ? __ldg(r.w[i] + w0 + q) : 0u;
    }
  }
}

// the scale of each of the lane's words from w0 on, zero past the row's
// end; the lane's words share one block when wpb is a multiple of WPL
// (their first word is a multiple of WPL)
__device__ __forceinline__ void load_scales(const Rows& r, int w0, float (&s)[ROWS][WPL]) {
  if (r.wpb % WPL == 0) {
    const bool ok = w0 < r.n_words;
    const int b = block_of(r, w0);
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const float v = ok ? bf16_bits_to_float(__ldg(r.s[i] + b)) : 0.f;
#pragma unroll
      for (int q = 0; q < WPL; ++q) s[i][q] = v;
    }
  } else {
#pragma unroll
    for (int q = 0; q < WPL; ++q) {
      const bool ok = w0 + q < r.n_words;
      const int b = block_of(r, w0 + q);
#pragma unroll
      for (int i = 0; i < ROWS; ++i) s[i][q] = ok ? bf16_bits_to_float(__ldg(r.s[i] + b)) : 0.f;
    }
  }
}

// the bf16 pairs of x row g that words w0 .. w0 + 3 multiply: pairs
// xv[q][p] of word q, zero past n_words and for rows >= M
template <int CPW, bool VEC>
__device__ __forceinline__ void load_x(const bf16* xrow, bool has_x, int w0, int n_words,
                                       uint32_t (&xv)[WPL][CPW / 2]) {
  if (VEC) {  // the lane's WPL * CPW activations are contiguous and 16-byte aligned
    constexpr int N16 = WPL * CPW / 8;
    union {
      uint4 v[N16];
      uint32_t u[WPL][CPW / 2];
    } b;
    const bool ok = has_x && w0 < n_words;
#pragma unroll
    for (int i = 0; i < N16; ++i)
      b.v[i] = ok ? __ldg(reinterpret_cast<const uint4*>(xrow + static_cast<size_t>(w0) * CPW) + i)
                  : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int q = 0; q < WPL; ++q)
#pragma unroll
      for (int p = 0; p < CPW / 2; ++p) xv[q][p] = b.u[q][p];
  } else {  // one word's CPW activations: 16 bytes at 4 bits, 8 at 7 and 8
#pragma unroll
    for (int q = 0; q < WPL; ++q) {
      const bool ok = has_x && w0 + q < n_words;
      const bf16* p = xrow + static_cast<size_t>(w0 + q) * CPW;
      if constexpr (CPW == 8) {
        const uint4 v = ok ? __ldg(reinterpret_cast<const uint4*>(p)) : make_uint4(0u, 0u, 0u, 0u);
        xv[q][0] = v.x;
        xv[q][1] = v.y;
        xv[q][2] = v.z;
        xv[q][3] = v.w;
      } else {
        const uint2 v = ok ? __ldg(reinterpret_cast<const uint2*>(p)) : make_uint2(0u, 0u);
        xv[q][0] = v.x;
        xv[q][1] = v.y;
      }
    }
  }
}

template <int BITS, bool VEC, int WARPS>
__global__ void __launch_bounds__(WARPS * 32, OCCUPANCY > WARPS ? OCCUPANCY / WARPS : 1)
qgemv_tc_kernel(const bf16* __restrict__ x, const uint32_t* __restrict__ packed,
                const unsigned short* __restrict__ scales, const float* __restrict__ codebook,
                bf16* __restrict__ y, int M, int N, int n_words, int wpb, int lg_wpb) {
  constexpr int CPW = 32 / BITS;
  constexpr int STEPS = CPW / 4;  // k16 steps a word feeds
  static_assert(CPW % 4 == 0, "whole k16 steps in a word");
  __shared__ float lut[1 << BITS];
  __shared__ float part[WARPS][32][4];
  for (int i = threadIdx.x; i < (1 << BITS); i += blockDim.x) lut[i] = codebook[i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n0 = blockIdx.x * 16;
  // row i is column n0 + 8i + g (past N: column N - 1, never written)
  Rows r;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int n = min(n0 + 8 * i + g, N - 1);
    r.w[i] = packed + static_cast<size_t>(n) * n_words;
    r.s[i] = scales + static_cast<size_t>(n) * (n_words / wpb);
  }
  r.n_words = n_words;
  r.wpb = wpb;
  r.lg_wpb = lg_wpb;
  const bool has_x = g < M;
  const bf16* xrow = x + static_cast<size_t>(has_x ? g : 0) * n_words * CPW;
  const uint32_t lut_addr = smem_u32(lut);

  float d[4] = {};
  const int n_chunks = (n_words + CHUNK - 1) / CHUNK;
  for (int c = warp; c < n_chunks; c += WARPS) {
    const int w0 = c * CHUNK + t * WPL;
    uint32_t words[ROWS][WPL];
    float sc[ROWS][WPL];
    uint32_t xv[WPL][CPW / 2];
    load_words<VEC>(r, w0, words);
    load_scales(r, w0, sc);
    load_x<CPW, VEC>(xrow, has_x, w0, n_words, xv);
#pragma unroll
    for (int q = 0; q < WPL; ++q) {
      uint32_t pr[ROWS][CPW / 2];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) decode_word<BITS>(words[i][q], sc[i][q], lut_addr, pr[i]);
#pragma unroll
      for (int st = 0; st < STEPS; ++st) {
        const uint32_t a[4] = {pr[0][2 * st], pr[1][2 * st], pr[0][2 * st + 1],
                               pr[1][2 * st + 1]};
        mma_16816(d, a, xv[q][2 * st], xv[q][2 * st + 1]);
      }
    }
  }

#pragma unroll
  for (int e = 0; e < 4; ++e) part[warp][lane][e] = d[e];
  __syncthreads();
  if (threadIdx.x < 16 * 8) {
    // y[m, n0 + n] is e = 2 (n / 8) + m % 2 of lane 4 (n % 8) + m / 2 in every warp
    const int m = threadIdx.x / 16;
    const int n = threadIdx.x % 16;
    const int src = (n & 7) * 4 + (m >> 1);
    const int e = (n >> 3) * 2 + (m & 1);
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) sum += part[w][src][e];
    if (m < M && n0 + n < N) y[static_cast<size_t>(m) * N + n0 + n] = __float2bfloat16_rn(sum);
  }
}

struct Args {
  const bf16* x;
  const uint32_t* packed;
  const unsigned short* scales;
  const float* codebook;
  bf16* y;
  int M, N, n_words, wpb, lg_wpb;
};

template <int BITS, bool VEC, int WARPS>
int launch_kernel(const Args& a, unsigned grid, cudaStream_t stream) {
  qgemv_tc_kernel<BITS, VEC, WARPS><<<grid, WARPS * 32, 0, stream>>>(
      a.x, a.packed, a.scales, a.codebook, a.y, a.M, a.N, a.n_words, a.wpb, a.lg_wpb);
  return static_cast<int>(cudaGetLastError());
}

template <int BITS, int WARPS>
int launch_warps(const Args& a, bool vec, unsigned grid, cudaStream_t stream) {
  return vec ? launch_kernel<BITS, true, WARPS>(a, grid, stream)
             : launch_kernel<BITS, false, WARPS>(a, grid, stream);
}

// streaming multiprocessors of the current device, read once per device
int sm_count() {
  static int counts[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (counts[dev] == 0 &&
      cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    counts[dev] = 132;
  return counts[dev];
}

template <int BITS>
int launch(const Args& a, bool vec, cudaStream_t stream) {
  static_assert(MIN_WARPS >= 4 && MAX_WARPS <= 16, "4, 8 or 16 warps a block");
  const unsigned grid = (a.N + 15) / 16;
  const long fill = static_cast<long>(sm_count()) * FILL_PER_SM;
  int warps = MIN_WARPS;
  while (warps < MAX_WARPS && static_cast<long>(grid) * warps < fill) warps *= 2;
  if (warps == 4) return launch_warps<BITS, 4>(a, vec, grid, stream);
  if (warps == 8) return launch_warps<BITS, 8>(a, vec, grid, stream);
  return launch_warps<BITS, 16>(a, vec, grid, stream);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape, bit width or block size it does not
// take: 1 <= M <= 8, bits 4, 7 or 8, B % cpw == 0, K == n_words * cpw,
// K % B == 0, and x on a 16-byte boundary (the wrapper checks).
extern "C" int qmatmul_gemv_tc(const void* x, const void* packed, const void* scales,
                               const void* codebook, void* y, int M, int N, int K, int n_words,
                               int bits, int block_size, void* stream) {
  if (bits != 4 && bits != 7 && bits != 8) return static_cast<int>(cudaErrorInvalidValue);
  const int cpw = 32 / bits;
  if (M < 1 || M > 8 || N < 1 || n_words < 1 || block_size < cpw || block_size % cpw != 0 ||
      K != n_words * cpw || K % block_size != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int wpb = block_size / cpw;
  int lg = -1;
  if ((wpb & (wpb - 1)) == 0) {
    lg = 0;
    while ((1 << lg) < wpb) ++lg;
  }
  const Args a{static_cast<const bf16*>(x), static_cast<const uint32_t*>(packed),
               static_cast<const unsigned short*>(scales), static_cast<const float*>(codebook),
               static_cast<bf16*>(y), M, N, n_words, wpb, lg};
  const bool vec = n_words % 4 == 0 && reinterpret_cast<uintptr_t>(packed) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 4: return launch<4>(a, vec, s);
    case 7: return launch<7>(a, vec, s);
    case 8: return launch<8>(a, vec, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
