// Blockwise absmax encode straight from the stored weight to the stored
// k-bit form, for Hopper (sm_90a).
//
// Replaces, for every row-structured item (cols % B == 0), the TPU kernel
// src/repro/kernels/quantize.py::quantize_blocks_pallas (body
// _quantize_kernel) together with the chain around it that the reference
// runs as jnp and the port used to run as eager PyTorch: the transpose and
// f32 copy of core/blockwise.encode, the uint8 cast, core/packing.pack and
// the row repack of core/qtensor.to_structured.  csrc/quantize.cu keeps the
// TPU kernel's own contract for flat items (cols % B != 0).
//
// One item, the logical matrix w [rows, cols], blocks of B along cols:
//
//   scale[r, j]  = bf16_rn(max(max_{c in block j} |w[r, c]|, 1e-12))
//   code[r, c]   = #{ i : bounds[i] < w[r, c] / s },  s the f32 scale
//   packed[r, q] = sum_j code[r, q * cpw + j] << (j * bits),  cpw = 32 / bits
//
// w is read as it is stored, bf16 or f32: either w itself, row-major, or
// (transposed) the matrix [cols, rows] whose transpose it is, as
// models/quantize.py stores every [In, Out] weight as its [Out, In]
// transpose.  Each row starts on a word; the last word of a row carries an
// inert zero tail where cpw does not divide cols.  The arithmetic is the
// plain version's: an f32 absmax, the IEEE division __fdiv_rn (no
// reciprocal), the count of the 2^bits - 1 sorted midpoints below the
// quotient, and one round-to-nearest-even of the scale to bf16, so words
// and scale bits are bit-exact with kernels/quantize.quantize_pack_plain.
//
// What bounds it on an H100 SXM: bytes, 2 (bf16) in and bits / 8 + 2 / B
// out a value: 17.9 GB, 5.3 ms at 3.35 TB/s, for Qwen2-7B's 7.07 G
// quantized weights at 4 bits and B = 64 (the old contract, f32 in and
// int32 codes out, moved 8.06 bytes a value).  The work is near that line:
// a division (about 8 instructions) and a search of `bits` steps a value.
//
// Design: a warp owns 32 rows (a lane owns one) and a segment of columns
// that starts on a word and a block (a multiple of lcm(B, cpw)); warps are
// independent.  In the transposed layout the lane's values are one column
// of the stored matrix, so the warp's 32 lanes read 32 neighbouring values
// of one stored row: coalesced, one load a value.  In the row-major layout
// a lane reads its own row cpw values at a time with one vector load (16
// bytes for 8 bf16 codes at 4 bits).  Each block is read twice: once for
// its absmax and once for its codes, the second time from L1 or L2 (a block
// of B = 1024 does not fit a lane's registers).  Where cpw divides B a word
// lies in one block and its codes are found in an unrolled loop; otherwise
// (3, 5, 6 bits) words straddle blocks and a code at a time goes into the
// word.  The lanes' words go to a shared tile (a row of 33 words each) and
// leave it as whole row runs of up to 32 words, so the stores coalesce
// where each lane's own would land in a sector of its own.  The bounds sit
// in shared memory and the search takes exactly `bits` steps with no
// branch.  One launch an item.  The work is a chain of dependent shared
// loads (the search) and the division for every value, so the kernel needs
// warps to hide their latency: registers are capped so that an SM holds at
// least three CTAs (ptxas gives 51 to 56, four CTAs, 32 warps), with two
// words of loads in flight in the absmax pass and one word of codes at a
// time.  Unrolled four and two deep, the kernel held 122 to 168 registers,
// one CTA an SM, and took 21.8 ms for Qwen2-7B against 18.0 ms now, 3.4x
// the bytes' bound (PERF.md says what is left).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int WARPS = 8;               // warps a CTA, each on its own rows and columns
constexpr int MIN_CTAS = 3;            // CTAs an SM must hold: registers capped at 85 a lane
constexpr int TILE_WORDS = 32;         // words a row staged before they are stored
constexpr int TILE_STRIDE = TILE_WORDS + 1;

// raw element types: float, or the bits of a bf16
__device__ __forceinline__ float as_f32(float v) { return v; }
__device__ __forceinline__ float as_f32(unsigned short v) {
  return __uint_as_float(static_cast<unsigned>(v) << 16);
}

// the count of bounds below v; sb holds the 2^BITS - 1 sorted midpoints
template <int BITS>
__device__ __forceinline__ uint32_t search(const float* sb, float v) {
  int lo = 0;
#pragma unroll
  for (int step = 1 << (BITS - 1); step > 0; step >>= 1) lo += sb[lo + step - 1] < v ? step : 0;
  return static_cast<uint32_t>(lo);
}

// N values of the lane's row from column c on.  Transposed: one coalesced
// load each.  Row-major: one or two vector loads where N values fill 8, 16
// or 32 bytes (c is a multiple of N and rows start on 16 bytes), else one
// load each.
template <typename T, bool TRANS, int N>
__device__ __forceinline__ void load_run(const T* __restrict__ x, long long stride, long long r,
                                         long long c, float (&v)[N]) {
  if constexpr (TRANS) {
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] = as_f32(__ldg(x + (c + j) * stride + r));
  } else {
    const T* p = x + r * stride + c;
    constexpr int BYTES = N * static_cast<int>(sizeof(T));
    if constexpr (BYTES == 8 || BYTES == 16 || BYTES == 32) {
      using V = typename std::conditional<BYTES == 8, uint2, uint4>::type;
      constexpr int PER = static_cast<int>(sizeof(V) / sizeof(T));
#pragma unroll
      for (int k = 0; k < N / PER; ++k) {
        union {
          V vec;
          T e[PER];
        } u;
        u.vec = __ldg(reinterpret_cast<const V*>(p) + k);
#pragma unroll
        for (int j = 0; j < PER; ++j) v[k * PER + j] = as_f32(u.e[j]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j) v[j] = as_f32(__ldg(p + j));
    }
  }
}

template <typename T, int BITS, bool TRANS, bool WHOLE>
__global__ void __launch_bounds__(WARPS * 32, MIN_CTAS)
    quantize_pack_kernel(const T* __restrict__ x, const float* __restrict__ bounds,
                         uint32_t* __restrict__ packed, unsigned short* __restrict__ scales,
                         int rows, int cols, int block, int seg_cols, int n_segs) {
  constexpr int CPW = 32 / BITS;
  constexpr int N_BOUNDS = (1 << BITS) - 1;
  __shared__ float sb[N_BOUNDS];
  __shared__ uint32_t tiles[WARPS][32 * TILE_STRIDE];
  for (int i = threadIdx.x; i < N_BOUNDS; i += blockDim.x) sb[i] = bounds[i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long n_groups = (rows + 31) / 32;
  const long long unit = static_cast<long long>(blockIdx.x) * WARPS + warp;
  if (unit >= n_groups * n_segs) return;  // the whole warp leaves together
  // neighbouring warps take neighbouring rows of one segment: in the
  // transposed layout they read the two halves of the same 128-byte lines
  const int seg = static_cast<int>(unit / n_groups);
  const int row0 = static_cast<int>(unit - static_cast<long long>(seg) * n_groups) * 32;
  const bool live = row0 + lane < rows;
  const long long r = live ? row0 + lane : rows - 1;  // spare lanes repeat the last row
  const long long stride = TRANS ? rows : cols;
  const int c_begin = seg * seg_cols;
  const int c_end = min(cols, c_begin + seg_cols);
  const int n_words = (cols + CPW - 1) / CPW;
  const int n_blocks = cols / block;
  uint32_t* tile = tiles[warp];
  int w_out = c_begin / CPW;  // the row's word that the tile's first column holds
  int staged = 0;             // words staged, the same count for every lane

  auto flush = [&]() {
    __syncwarp();
    for (int i = 0; i < 32; ++i) {
      if (row0 + i < rows && lane < staged)
        packed[static_cast<long long>(row0 + i) * n_words + w_out + lane] =
            tile[i * TILE_STRIDE + lane];
    }
    __syncwarp();
    w_out += staged;
    staged = 0;
  };
  auto emit = [&](uint32_t word) {
    tile[lane * TILE_STRIDE + staged] = word;
    if (++staged == TILE_WORDS) flush();
  };
  auto put_scale = [&](int c0, float s) {
    if (live) scales[r * n_blocks + c0 / block] = __bfloat16_as_ushort(__float2bfloat16_rn(s));
  };

  if constexpr (WHOLE) {  // cpw divides B: a word lies in one block
    for (int cb = c_begin; cb < c_end; cb += block) {
      float m = 0.f;
#pragma unroll 2
      for (int c = cb; c < cb + block; c += CPW) {
        float v[CPW];
        load_run<T, TRANS, CPW>(x, stride, r, c, v);
#pragma unroll
        for (int j = 0; j < CPW; ++j) m = fmaxf(m, fabsf(v[j]));
      }
      const float s = fmaxf(m, 1e-12f);
      put_scale(cb, s);
      for (int c = cb; c < cb + block; c += CPW) {
        float v[CPW];
        load_run<T, TRANS, CPW>(x, stride, r, c, v);
        uint32_t word = 0;
#pragma unroll
        for (int j = 0; j < CPW; ++j) word |= search<BITS>(sb, __fdiv_rn(v[j], s)) << (j * BITS);
        emit(word);
      }
    }
  } else {  // words straddle blocks: one code at a time
    uint32_t word = 0;
    int pos = 0;
    for (int cb = c_begin; cb < c_end; cb += block) {
      float m = 0.f;
#pragma unroll 4
      for (int c = cb; c < cb + block; ++c) {
        float v[1];
        load_run<T, TRANS, 1>(x, stride, r, c, v);
        m = fmaxf(m, fabsf(v[0]));
      }
      const float s = fmaxf(m, 1e-12f);
      put_scale(cb, s);
      for (int c = cb; c < cb + block; ++c) {
        float v[1];
        load_run<T, TRANS, 1>(x, stride, r, c, v);
        word |= search<BITS>(sb, __fdiv_rn(v[0], s)) << (pos * BITS);
        if (++pos == CPW) {
          emit(word);
          word = 0;
          pos = 0;
        }
      }
    }
    if (pos) emit(word);  // the row's last word, its tail zero
  }
  if (staged) flush();
}

template <typename T, int BITS, bool TRANS>
cudaError_t launch(const void* x, const void* bounds, void* packed, void* scales, int rows,
                   int cols, int block, int seg_cols, cudaStream_t stream) {
  const long long n_segs = (cols + seg_cols - 1) / seg_cols;
  const long long units = (rows + 31LL) / 32 * n_segs;
  const long long grid = (units + WARPS - 1) / WARPS;
  if (grid > 2147483647LL) return cudaErrorInvalidValue;
  const auto* xp = static_cast<const T*>(x);
  const auto* bp = static_cast<const float*>(bounds);
  auto* pp = static_cast<uint32_t*>(packed);
  auto* sp = static_cast<unsigned short*>(scales);
  const int ns = static_cast<int>(n_segs);
  if (block % (32 / BITS) == 0) {
    quantize_pack_kernel<T, BITS, TRANS, true><<<static_cast<unsigned>(grid), WARPS * 32, 0,
                                                 stream>>>(xp, bp, pp, sp, rows, cols, block,
                                                           seg_cols, ns);
  } else {
    quantize_pack_kernel<T, BITS, TRANS, false><<<static_cast<unsigned>(grid), WARPS * 32, 0,
                                                  stream>>>(xp, bp, pp, sp, rows, cols, block,
                                                            seg_cols, ns);
  }
  return cudaGetLastError();
}

template <typename T, bool TRANS>
cudaError_t launch_bits(int bits, const void* x, const void* bounds, void* packed, void* scales,
                        int rows, int cols, int block, int seg_cols, cudaStream_t stream) {
  switch (bits) {
    case 3: return launch<T, 3, TRANS>(x, bounds, packed, scales, rows, cols, block, seg_cols, stream);
    case 4: return launch<T, 4, TRANS>(x, bounds, packed, scales, rows, cols, block, seg_cols, stream);
    case 5: return launch<T, 5, TRANS>(x, bounds, packed, scales, rows, cols, block, seg_cols, stream);
    case 6: return launch<T, 6, TRANS>(x, bounds, packed, scales, rows, cols, block, seg_cols, stream);
    case 7: return launch<T, 7, TRANS>(x, bounds, packed, scales, rows, cols, block, seg_cols, stream);
    case 8: return launch<T, 8, TRANS>(x, bounds, packed, scales, rows, cols, block, seg_cols, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for bits outside 3..8, cols not a multiple of
// block, or seg_cols not a positive multiple of lcm(block, 32 / bits).
// x is [rows, cols] row-major, or with `transposed` [cols, rows]; bf16 when
// x_is_bf16, else f32.  Row-major x must start on 16 bytes.  packed is int32
// [rows, ceil(cols / cpw)], scales bf16 [rows, cols / block].
extern "C" int quantize_pack(const void* x, int x_is_bf16, int transposed, const void* bounds,
                             int bits, void* packed, void* scales, int rows, int cols,
                             int block, int seg_cols, void* stream) {
  if (bits < 3 || bits > 8 || rows < 1 || cols < 1 || block < 1 || cols % block ||
      seg_cols < 1 || seg_cols % block || seg_cols % (32 / bits)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (x_is_bf16) {
    e = transposed ? launch_bits<unsigned short, true>(bits, x, bounds, packed, scales, rows,
                                                       cols, block, seg_cols, st)
                   : launch_bits<unsigned short, false>(bits, x, bounds, packed, scales, rows,
                                                        cols, block, seg_cols, st);
  } else {
    e = transposed ? launch_bits<float, true>(bits, x, bounds, packed, scales, rows, cols, block,
                                              seg_cols, st)
                   : launch_bits<float, false>(bits, x, bounds, packed, scales, rows, cols,
                                               block, seg_cols, st);
  }
  return static_cast<int>(e);
}
