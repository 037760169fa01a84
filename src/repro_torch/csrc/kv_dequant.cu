// k-bit KV-cache row dequant for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/kv_dequant.py::dequant_rows_pallas
// (body _dequant_kernel).
//
//   out[r, f] = bf16(dq(code[r, f]) * scale[r, f / bs])
//
// over flattened cache rows r: packed [R, n_words] 32-bit words (cpw = 32 /
// bits codes each, low bits first), scales bf16 [R, n_blocks], out bf16
// [R, n_words * cpw].  dq is the codebook of every type (for int it equals
// the TPU kernel's clip(c - h, -h, h) / h, h = 2^(bits-1) - 1, bit for bit).
// The product is taken in f32 and rounded to bf16 once, as the plain version
// does, so the two agree exactly.
//
// What bounds it on an H100 SXM: bytes.  Per value it reads bits/8 bytes of
// code and 2/bs of scale, and writes 2 bytes of bf16: at kv4 the write is
// about 3.8x the read.  At a decode step's shapes (a few hundred KB per
// call) launch latency, not bandwidth, sets its time.
//
// Design: one thread per packed word, the bit width a template parameter;
// the codebook sits in shared memory (the TPU's compare-select tree is a VPU
// constraint).  A thread reads its scale once per word (again only where a
// word straddles two blocks) and writes its cpw values with one vector
// store (16 bytes at kv4, 8 at kv8), so adjacent threads read adjacent
// words and write adjacent vectors.  The decode path reads the cache
// through csrc/kv_decode_attention.cu, which dequantizes in registers and
// never writes bf16 K/V back; this kernel stays as the standalone row
// dequant (kernels/kv_dequant.dequant_rows), off the decode path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int BYTES>
struct VecOf;
template <>
struct VecOf<16> { using type = uint4; };
template <>
struct VecOf<8> { using type = uint2; };

template <int BITS>
__global__ void kv_dequant_kernel(const uint32_t* __restrict__ packed,
                                  const __nv_bfloat16* __restrict__ scales,
                                  const float* __restrict__ codebook,
                                  __nv_bfloat16* __restrict__ out, long long total_words,
                                  int n_words, int n_blocks, int block_size) {
  constexpr int CPW = 32 / BITS;
  constexpr unsigned MASK = (1u << BITS) - 1u;
  using V = typename VecOf<CPW * 2>::type;
  __shared__ float lut[1 << BITS];
  for (int i = threadIdx.x; i < (1 << BITS); i += blockDim.x) lut[i] = codebook[i];
  __syncthreads();
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total_words) return;
  const long long r = idx / n_words;
  const int f0 = static_cast<int>(idx - r * n_words) * CPW;
  const uint32_t word = packed[idx];
  const __nv_bfloat16* srow = scales + r * n_blocks;
  int blk = f0 / block_size;
  int rem = f0 - blk * block_size;
  float s = __bfloat162float(srow[blk]);
  union {
    V vec;
    unsigned short raw[CPW];
  } u;
#pragma unroll
  for (int j = 0; j < CPW; ++j) {
    if (rem == block_size) {  // this word straddles two scale blocks
      ++blk;
      rem = 0;
      s = __bfloat162float(srow[blk]);
    }
    ++rem;
    u.raw[j] = __bfloat16_as_ushort(__float2bfloat16_rn(lut[(word >> (j * BITS)) & MASK] * s));
  }
  // a row holds n_words * CPW values, so word idx's values start at idx * CPW
  reinterpret_cast<V*>(out)[idx] = u.vec;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for a bit width other than 4 or 8.  `out` must be
// aligned to 2 * 32 / bits bytes (a fresh allocation is).
extern "C" int kv_dequant(const void* packed, const void* scales, const void* codebook,
                          void* out, long long total_words, int n_words, int n_blocks,
                          int bits, int block_size, void* stream) {
  const int threads = 256;
  const long long blocks = (total_words + threads - 1) / threads;
  if (blocks == 0) return 0;
  const auto* p = static_cast<const uint32_t*>(packed);
  const auto* sc = static_cast<const __nv_bfloat16*>(scales);
  const auto* cb = static_cast<const float*>(codebook);
  auto* o = static_cast<__nv_bfloat16*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(blocks);
  if (bits == 4) {
    kv_dequant_kernel<4><<<grid, threads, 0, st>>>(p, sc, cb, o, total_words, n_words, n_blocks,
                                                   block_size);
  } else if (bits == 8) {
    kv_dequant_kernel<8><<<grid, threads, 0, st>>>(p, sc, cb, o, total_words, n_words, n_blocks,
                                                   block_size);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
