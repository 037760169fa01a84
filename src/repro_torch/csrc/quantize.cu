// Blockwise absmax encode for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/quantize.py::quantize_blocks_pallas
// (body _quantize_kernel).
//
//   scale[b]   = max(max_i |x[b, i]|, 1e-12)
//   code[b, i] = #{ j : bounds[j] < x[b, i] / scale[b] }
//
// over x f32 [n_blocks, B], bounds = the sorted codebook's midpoints (f32
// (c[j] + c[j + 1]) / 2, computed here as core/codebooks.codebook_boundaries
// computes them, from the codebook f32 [2^k], k <= 8), codes int32
// [n_blocks, B], scales f32 [n_blocks].  Because the bounds are sorted, the count equals the TPU
// kernel's compare-count and the plain version's left searchsorted.  x /
// scale is an IEEE f32 division (__fdiv_rn, never a reciprocal multiply), so
// codes and scales are bit-exact with the plain version for finite inputs.
// fmaxf drops a NaN where the plain version's amax propagates it; NaN is
// outside the contract, as in the reference.
//
// What bounds it on an H100 SXM: bytes.  Per value it reads 4 bytes and
// writes 4 bytes of code, plus 4 bytes of scale per block: 8.06 bytes a
// value at B = 64, about 57 GB (17 ms at 3.35 TB/s) for Qwen2-7B's 7.07 G
// quantized weights.  The work per value (a division and a search of at
// most 8 steps) is small beside that.
//
// Design, for B % 4 == 0 and B <= 1024 (the paper sweep's blocks, 32 to
// 1024) on a 16-byte aligned x: a thread owns 4 consecutive values of a
// block, loaded as one float4 and kept in registers (x is read once); a
// block's B / 4 threads, a group of GS lanes (the next power of two, the
// spare lanes idle), reduce the absmax with width-limited __shfl_xor_sync
// (past a warp, through shared memory); the codes leave as one int4 store.
// So a warp's loads and stores are whole 512-byte runs.  The search is
// branchless: the bounds are padded with +inf to 2^K in shared memory, and
// K steps of binary lifting (K the template parameter, unrolled) count the
// bounds below the value.  The bounds are computed from the codebook in
// shared memory (no kernels ahead of this one).  A CTA takes one round:
// each thread loads two blocks' float4s, in flight together and while the
// bounds are staged.  Other
// blocks (B % 4 != 0, B > 1024, or x off 16 bytes) keep the first design:
// one warp a block, lanes striding over its values with scalar loads, a
// binary search over the bounds in shared memory; the shape picks it.  The
// narrow contract (the stored bf16 weight in, packed words and bf16 scales
// out) is csrc/quantize_pack.cu, which encodes every row-structured item
// (cols % B == 0: every serving weight); this kernel keeps the TPU
// kernel's contract for the flat items (cols % B != 0, some of the paper
// sweep's) and for kernels/ops.prepare_operand.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_BOUNDS = 255;
constexpr int THREADS = 256;
constexpr int ITEMS = 2;          // rounds of blocks a CTA loads at once
constexpr int WARPS = 8;          // the generic kernel's warps a CTA

// #{ j : sb[j] < v } over 2^K sorted bounds (+inf past the real ones):
// binary lifting, every b[0 .. pos) below v at each step
// bound j: the codebook's midpoint, IEEE add then halve, as the plain version
__device__ __forceinline__ float midpoint(const float* cb, int j) {
  return __fdiv_rn(__fadd_rn(cb[j], cb[j + 1]), 2.0f);
}

template <int K>
__device__ __forceinline__ int count_below(const float* sb, float v) {
  int pos = 0;
#pragma unroll
  for (int step = 1 << (K - 1); step > 0; step >>= 1) pos += sb[pos + step - 1] < v ? step : 0;
  return pos;
}

// GS lanes a quantization block (a power of two); WIDE: GS > 32.  A CTA
// takes ITEMS rounds of THREADS / GS blocks, their loads in flight together.
template <int K, bool WIDE>
__global__ void __launch_bounds__(THREADS)
    quantize_blocks_vec_kernel(const float4* __restrict__ x, const float* __restrict__ codebook,
                               int n_bounds, int4* __restrict__ codes,
                               float* __restrict__ scales, long long n_blocks, int T, int GS) {
  __shared__ float sb[1 << K];
  __shared__ float wmax[ITEMS][THREADS / 32];
  const int gpc = THREADS / GS;   // quantization blocks a CTA an item
  const int g = threadIdx.x / GS, lane = threadIdx.x % GS;
  long long blk[ITEMS];
  float4 v[ITEMS];
  float m[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {   // the loads are in flight while the bounds are staged
    blk[i] = (static_cast<long long>(blockIdx.x) * ITEMS + i) * gpc + g;
    v[i] = blk[i] < n_blocks && lane < T ? x[blk[i] * T + lane]
                                         : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int i = threadIdx.x; i < (1 << K); i += THREADS)
    sb[i] = i < n_bounds ? midpoint(codebook, i) : INFINITY;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    m[i] = fmaxf(fmaxf(fabsf(v[i].x), fabsf(v[i].y)), fmaxf(fabsf(v[i].z), fabsf(v[i].w)));
    if (!WIDE) {
      for (int off = GS >> 1; off > 0; off >>= 1)
        m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], off, GS));
    } else {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], off));
      if ((threadIdx.x & 31) == 0) wmax[i][threadIdx.x >> 5] = m[i];
    }
  }
  __syncthreads();   // the bounds, and past a warp the warps' maxima
  if (WIDE) {
    const int w0 = g * (GS >> 5);
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      m[i] = wmax[i][w0];
      for (int w = 1; w < (GS >> 5); ++w) m[i] = fmaxf(m[i], wmax[i][w0 + w]);
    }
  }
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    if (blk[i] >= n_blocks) continue;
    const float scale = fmaxf(m[i], 1e-12f);
    if (lane < T) {
      codes[blk[i] * T + lane] = make_int4(count_below<K>(sb, __fdiv_rn(v[i].x, scale)),
                                           count_below<K>(sb, __fdiv_rn(v[i].y, scale)),
                                           count_below<K>(sb, __fdiv_rn(v[i].z, scale)),
                                           count_below<K>(sb, __fdiv_rn(v[i].w, scale)));
    }
    if (lane == 0) scales[blk[i]] = scale;
  }
}

// any block: one warp a block, lanes striding over its values
__global__ void quantize_blocks_kernel(const float* __restrict__ x,
                                       const float* __restrict__ codebook, int n_bounds,
                                       int32_t* __restrict__ codes, float* __restrict__ scales,
                                       long long n_blocks, int block_size) {
  __shared__ float sb[MAX_BOUNDS];
  for (int i = threadIdx.x; i < n_bounds; i += blockDim.x) sb[i] = midpoint(codebook, i);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long blk = static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (blk >= n_blocks) return;  // the whole warp leaves together
  const float* xb = x + blk * block_size;
  int32_t* cb = codes + blk * block_size;

  float m = 0.f;
  for (int i = lane; i < block_size; i += 32) m = fmaxf(m, fabsf(xb[i]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  const float scale = fmaxf(m, 1e-12f);

  for (int i = lane; i < block_size; i += 32) {
    const float v = __fdiv_rn(xb[i], scale);
    int lo = 0, hi = n_bounds;  // first j with sb[j] >= v, i.e. #{sb[j] < v}
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (sb[mid] < v) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    cb[i] = lo;
  }
  if (lane == 0) scales[blk] = scale;
}

template <int K>
void launch_vec(const float* x, const float* codebook, int n_bounds, int32_t* codes,
                float* scales, long long n_blocks, int T, int GS, unsigned grid,
                cudaStream_t st) {
  const auto* x4 = reinterpret_cast<const float4*>(x);
  auto* c4 = reinterpret_cast<int4*>(codes);
  if (GS > 32) {
    quantize_blocks_vec_kernel<K, true><<<grid, THREADS, 0, st>>>(x4, codebook, n_bounds, c4,
                                                                   scales, n_blocks, T, GS);
  } else {
    quantize_blocks_vec_kernel<K, false><<<grid, THREADS, 0, st>>>(x4, codebook, n_bounds, c4,
                                                                    scales, n_blocks, T, GS);
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for n_codes outside [2, 256], block_size < 1 or a
// grid past 2^31 - 1 CUDA blocks.  codes must be 16-byte aligned (a fresh
// allocation is).
extern "C" int quantize_blocks(const void* x, const void* codebook, void* codes, void* scales,
                               long long n_blocks, int block_size, int n_codes, void* stream) {
  const int n_bounds = n_codes - 1;
  if (n_bounds < 1 || n_bounds > MAX_BOUNDS || block_size < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_blocks == 0) return 0;
  const auto* xf = static_cast<const float*>(x);
  const auto* bf = static_cast<const float*>(codebook);
  auto* cf = static_cast<int32_t*>(codes);
  auto* sf = static_cast<float*>(scales);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (block_size % 4 || block_size > 4 * THREADS || reinterpret_cast<uintptr_t>(x) % 16) {
    const long long grid = (n_blocks + WARPS - 1) / WARPS;
    if (grid > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
    quantize_blocks_kernel<<<static_cast<unsigned>(grid), WARPS * 32, 0, st>>>(
        xf, bf, n_bounds, cf, sf, n_blocks, block_size);
    return static_cast<int>(cudaGetLastError());
  }
  const int T = block_size / 4;
  int GS = 1;
  while (GS < T) GS <<= 1;
  const long long per_cta = static_cast<long long>(THREADS / GS) * ITEMS;
  const long long n_cta = (n_blocks + per_cta - 1) / per_cta;
  if (n_cta > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(n_cta);
  int K = 1;
  while ((1 << K) < n_bounds + 1) ++K;
  switch (K) {
    case 1: launch_vec<1>(xf, bf, n_bounds, cf, sf, n_blocks, T, GS, grid, st); break;
    case 2: launch_vec<2>(xf, bf, n_bounds, cf, sf, n_blocks, T, GS, grid, st); break;
    case 3: launch_vec<3>(xf, bf, n_bounds, cf, sf, n_blocks, T, GS, grid, st); break;
    case 4: launch_vec<4>(xf, bf, n_bounds, cf, sf, n_blocks, T, GS, grid, st); break;
    case 5: launch_vec<5>(xf, bf, n_bounds, cf, sf, n_blocks, T, GS, grid, st); break;
    case 6: launch_vec<6>(xf, bf, n_bounds, cf, sf, n_blocks, T, GS, grid, st); break;
    case 7: launch_vec<7>(xf, bf, n_bounds, cf, sf, n_blocks, T, GS, grid, st); break;
    default: launch_vec<8>(xf, bf, n_bounds, cf, sf, n_blocks, T, GS, grid, st); break;
  }
  return static_cast<int>(cudaGetLastError());
}
