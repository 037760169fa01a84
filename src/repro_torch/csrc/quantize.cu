// Blockwise absmax encode for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/quantize.py::quantize_blocks_pallas
// (body _quantize_kernel).
//
//   scale[b]   = max(max_i |x[b, i]|, 1e-12)
//   code[b, i] = #{ j : bounds[j] < x[b, i] / scale[b] }
//
// over x f32 [n_blocks, B], bounds f32 [n_bounds] = the sorted codebook's
// midpoints (n_bounds = 2^k - 1 <= 255), codes int32 [n_blocks, B], scales f32
// [n_blocks].  Because the bounds are sorted, the count equals the TPU
// kernel's compare-count and the plain version's left searchsorted; it is
// found here by a lower-bound binary search (at most 8 steps).  x / scale is
// an IEEE f32 division (__fdiv_rn, never a reciprocal multiply), so codes and
// scales are bit-exact with the plain version for finite inputs.  fmaxf drops
// a NaN where the plain version's amax propagates it; NaN is outside the
// contract, as in the reference.
//
// What bounds it on an H100 SXM: bytes.  Per value it reads 4 bytes and
// writes 4 bytes of code, plus 4 bytes of scale per block: 8.06 bytes a
// value at B = 64, about 57 GB (17 ms at 3.35 TB/s) for Qwen2-7B's 7.07 G
// quantized weights.  The work per value (a division and <= 8 compares
// against shared memory) is small beside that.
//
// Design: one warp per quantization block.  Lanes stride over the block's B
// values (any B: 16 and 32 leave lanes idle, 1024 gives each lane 32), so a
// warp's loads and stores are coalesced; the absmax is a __shfl_xor_sync max
// reduction, and the second pass re-reads the block from L1.  The bounds sit
// in shared memory, loaded once per CUDA block of 8 warps.  The narrow
// contract (the stored bf16 weight in, packed words and bf16 scales out) is
// csrc/quantize_pack.cu, which encodes every row-structured item (cols % B
// == 0: every serving weight); this kernel keeps the TPU kernel's contract
// for the flat items (cols % B != 0, some of the paper sweep's) and for
// kernels/ops.prepare_operand.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int MAX_BOUNDS = 255;

__global__ void quantize_blocks_kernel(const float* __restrict__ x,
                                       const float* __restrict__ bounds, int n_bounds,
                                       int32_t* __restrict__ codes, float* __restrict__ scales,
                                       long long n_blocks, int block_size) {
  __shared__ float sb[MAX_BOUNDS];
  for (int i = threadIdx.x; i < n_bounds; i += blockDim.x) sb[i] = bounds[i];
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

}  // namespace

// Launches on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for n_bounds outside [1, 255], block_size < 1 or a
// grid past 2^31 - 1 CUDA blocks.
extern "C" int quantize_blocks(const void* x, const void* bounds, void* codes, void* scales,
                               long long n_blocks, int block_size, int n_bounds, void* stream) {
  if (n_bounds < 1 || n_bounds > MAX_BOUNDS || block_size < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_blocks == 0) return 0;
  const long long grid = (n_blocks + WARPS - 1) / WARPS;
  if (grid > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  quantize_blocks_kernel<<<static_cast<unsigned>(grid), WARPS * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(bounds), n_bounds,
      static_cast<int32_t*>(codes), static_cast<float*>(scales), n_blocks, block_size);
  return static_cast<int>(cudaGetLastError());
}
