// The decode GEMV for f32 activations on the CUDA cores: the design that
// scripts/gemv_f32.py times beside csrc/qmatmul.cu's TF32 qgemv (the one the
// port uses).  Not built by the port.
//
//   y[M, N] = x[M, K] . W^T,   W[n, k] = dq(code[n, k]) * scale[n, k / B]
//
// M <= 8 f32 rows, codes of 3 to 8 bits packed cpw = 32 / bits to a word,
// rows as stored (ceil(K / cpw) words; x past K reads as zero), K % B == 0.
// A block owns COLS output columns and splits their words among its 4 warps
// (thread i takes words i, i + 128, ...), so every packed word is read from
// device memory once and the x of a word, loaded once, serves COLS columns.
// Against an FMA a code, column and row, what it cuts:
//   * the scale is taken out of the products where a word lies in one scale
//     block (B % cpw == 0): a word's products are summed unscaled and the
//     sum scaled once a row, instead of a scale product a code;
//   * at 3 to 5 bits two neighbouring codes decode with one table read, from
//     a table of code pairs (2^(2 bits) float2s in shared memory);
//   * 8 columns a block, so each warp's shuffle reduction serves 8 columns.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int COLS = 8;

template <int BITS>
struct Cfg {
  static constexpr int CPW = 32 / BITS;
  static constexpr bool PAIRS = BITS <= 5;  // a table of code pairs
  static constexpr int TABLE = PAIRS ? 1 << (2 * BITS) : 1 << BITS;
};

template <int BITS, int MR, bool ONE>
__global__ void __launch_bounds__(THREADS)
gemv_f32_simt(const float* __restrict__ x, const uint32_t* __restrict__ packed,
              const unsigned short* __restrict__ scales, const float* __restrict__ codebook,
              float* __restrict__ y, int M, int N, int K, int n_words, int block) {
  using C = Cfg<BITS>;
  constexpr int CPW = C::CPW;
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  __shared__ float2 pairs[C::PAIRS ? C::TABLE : 1];
  __shared__ float lut[1 << BITS];
  __shared__ float part[WARPS][COLS * MR];
  for (int i = threadIdx.x; i < (1 << BITS); i += THREADS) lut[i] = codebook[i];
  if constexpr (C::PAIRS)
    for (int i = threadIdx.x; i < C::TABLE; i += THREADS)
      pairs[i] = make_float2(codebook[i & MASK], codebook[i >> BITS]);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * COLS;
  const int n_blocks = K / block;
  const uint32_t* wrow[COLS];
  const unsigned short* srow[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    const int n = min(n0 + c, N - 1);
    wrow[c] = packed + static_cast<size_t>(n) * n_words;
    srow[c] = scales + static_cast<size_t>(n) * n_blocks;
  }
  const bool xvec = (K % 2 == 0);
  float acc[COLS][MR] = {};
  for (int w = threadIdx.x; w < n_words; w += THREADS) {
    uint32_t words[COLS];
#pragma unroll
    for (int c = 0; c < COLS; ++c) words[c] = __ldg(wrow[c] + w);
    const int k0 = w * CPW;
    float xv[MR][CPW];
#pragma unroll
    for (int r = 0; r < MR; ++r) {
      const float* p = x + static_cast<size_t>(r) * K + k0;
      if (r < M && xvec && CPW % 2 == 0 && k0 + CPW <= K) {
#pragma unroll
        for (int j = 0; j < CPW; j += 2) {
          const float2 v = __ldg(reinterpret_cast<const float2*>(p + j));
          xv[r][j] = v.x;
          xv[r][j + 1] = v.y;
        }
      } else {
#pragma unroll
        for (int j = 0; j < CPW; ++j) xv[r][j] = r < M && k0 + j < K ? __ldg(p + j) : 0.f;
      }
    }
    if constexpr (ONE) {  // the word lies in one scale block
      const int b = k0 / block;
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        const float s = b < n_blocks ? __uint_as_float(static_cast<unsigned>(__ldg(srow[c] + b)) << 16) : 0.f;
        float p[MR] = {};
        if constexpr (C::PAIRS) {
#pragma unroll
          for (int j = 0; j + 1 < CPW; j += 2) {
            const float2 v = pairs[(words[c] >> (j * BITS)) & ((1u << (2 * BITS)) - 1u)];
#pragma unroll
            for (int r = 0; r < MR; ++r) p[r] = fmaf(xv[r][j + 1], v.y, fmaf(xv[r][j], v.x, p[r]));
          }
          if constexpr (CPW % 2) {
            const float v = lut[(words[c] >> ((CPW - 1) * BITS)) & MASK];
#pragma unroll
            for (int r = 0; r < MR; ++r) p[r] = fmaf(xv[r][CPW - 1], v, p[r]);
          }
        } else {
#pragma unroll
          for (int j = 0; j < CPW; ++j) {
            const float v = lut[(words[c] >> (j * BITS)) & MASK];
#pragma unroll
            for (int r = 0; r < MR; ++r) p[r] = fmaf(xv[r][j], v, p[r]);
          }
        }
#pragma unroll
        for (int r = 0; r < MR; ++r) acc[c][r] = fmaf(s, p[r], acc[c][r]);
      }
    } else {  // words straddle blocks: each code scaled
#pragma unroll
      for (int j = 0; j < CPW; ++j) {
        const int b = (k0 + j) / block;
#pragma unroll
        for (int c = 0; c < COLS; ++c) {
          const float s = b < n_blocks ? __uint_as_float(static_cast<unsigned>(__ldg(srow[c] + b)) << 16) : 0.f;
          const float v = lut[(words[c] >> (j * BITS)) & MASK] * s;
#pragma unroll
          for (int r = 0; r < MR; ++r) acc[c][r] = fmaf(xv[r][j], v, acc[c][r]);
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < COLS; ++c)
#pragma unroll
    for (int r = 0; r < MR; ++r)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[c][r] += __shfl_xor_sync(0xffffffffu, acc[c][r], off);
  if (lane == 0)
#pragma unroll
    for (int c = 0; c < COLS; ++c)
#pragma unroll
      for (int r = 0; r < MR; ++r) part[warp][c * MR + r] = acc[c][r];
  __syncthreads();
  if (threadIdx.x < COLS * MR) {
    const int c = threadIdx.x / MR;
    const int r = threadIdx.x - c * MR;
    float sum = 0.f;
#pragma unroll
    for (int wp = 0; wp < WARPS; ++wp) sum += part[wp][threadIdx.x];
    if (n0 + c < N && r < M) y[static_cast<size_t>(r) * N + n0 + c] = sum;
  }
}

template <int BITS, int MR>
void launch(const float* x, const uint32_t* packed, const unsigned short* scales,
            const float* codebook, float* y, int M, int N, int K, int n_words, int block,
            cudaStream_t stream) {
  const dim3 grid((N + COLS - 1) / COLS);
  if (block % Cfg<BITS>::CPW == 0)
    gemv_f32_simt<BITS, MR, true><<<grid, THREADS, 0, stream>>>(x, packed, scales, codebook, y,
                                                               M, N, K, n_words, block);
  else
    gemv_f32_simt<BITS, MR, false><<<grid, THREADS, 0, stream>>>(x, packed, scales, codebook,
                                                                y, M, N, K, n_words, block);
}

template <int BITS>
void rows(const float* x, const uint32_t* packed, const unsigned short* scales,
          const float* codebook, float* y, int M, int N, int K, int n_words, int block,
          cudaStream_t s) {
  if (M <= 1) launch<BITS, 1>(x, packed, scales, codebook, y, M, N, K, n_words, block, s);
  else if (M <= 2) launch<BITS, 2>(x, packed, scales, codebook, y, M, N, K, n_words, block, s);
  else if (M <= 4) launch<BITS, 4>(x, packed, scales, codebook, y, M, N, K, n_words, block, s);
  else launch<BITS, 8>(x, packed, scales, codebook, y, M, N, K, n_words, block, s);
}

}  // namespace

extern "C" int qgemv_f32_simt(const void* x, const void* packed, const void* scales,
                              const void* codebook, void* y, int M, int N, int K, int n_words,
                              int bits, int block_size, void* stream) {
  if (M < 1 || M > 8 || N < 1 || bits < 3 || bits > 8 || block_size < 1 ||
      K % block_size != 0 || n_words != (K + 32 / bits - 1) / (32 / bits))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* xf = static_cast<const float*>(x);
  const auto* pk = static_cast<const uint32_t*>(packed);
  const auto* sc = static_cast<const unsigned short*>(scales);
  const auto* cb = static_cast<const float*>(codebook);
  auto* yf = static_cast<float*>(y);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 3: rows<3>(xf, pk, sc, cb, yf, M, N, K, n_words, block_size, s); break;
    case 4: rows<4>(xf, pk, sc, cb, yf, M, N, K, n_words, block_size, s); break;
    case 5: rows<5>(xf, pk, sc, cb, yf, M, N, K, n_words, block_size, s); break;
    case 6: rows<6>(xf, pk, sc, cb, yf, M, N, K, n_words, block_size, s); break;
    case 7: rows<7>(xf, pk, sc, cb, yf, M, N, K, n_words, block_size, s); break;
    case 8: rows<8>(xf, pk, sc, cb, yf, M, N, K, n_words, block_size, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
