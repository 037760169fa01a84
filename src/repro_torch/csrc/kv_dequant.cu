// k-bit KV-cache dequant for Hopper (sm_90a): a layer's K and V in one
// launch, rows read as stored or through a page map.
//
// Replaces the TPU kernel src/repro/kernels/kv_dequant.py::dequant_rows_pallas
// (body _dequant_kernel).
//
//   out[r, f] = bf16(dq(code[src(r), f]) * scale[src(r), f / bs])
//
// for each leaf (K, and V where given): packed [rows, n_words] 32-bit words
// (cpw = 32 / bits codes each, low bits first), scales bf16 [rows,
// n_blocks], out bf16 [R, n_words * cpw].  src(r) = r, or through a page
// map [B, P] over page-major leaves [n_pages, ps, ...] (ps = 2^lps):
// output row r = b * P * ps + t reads row map[b, t / ps] * ps + t % ps,
// which is map[r >> lps] << lps | (r & (ps - 1)) since the map is [B, P]
// contiguous (the addressing of csrc/kv_decode_attention.cu).  dq is the
// codebook of every type (for int it equals the TPU kernel's clip(c - h,
// -h, h) / h, h = 2^(bits-1) - 1, bit for bit).  The product is taken in
// f32 and rounded to bf16 once, as the plain version does, so the two agree
// exactly.
//
// Where it runs: the decode read of the shapes the fused attention does not
// take (kernels/kv_attention.fused_takes: head dims other than 32, 64 and
// 128, more than 8 query heads a KV head, blocks that split a word, caches
// whose scores do not fit an SM, about 39.8 K slots at Qwen2-7B's heads),
// one launch a layer, inside the captured decode step.
//
// What bounds it on an H100 SXM: bytes.  Per value it reads bits/8 bytes of
// code and 2/bs of scale, and writes 2 bytes of bf16: at kv4 the write is
// about 3.8x the read.  A 40,960-slot Qwen2-7B kv4 cache moves 106 MB a
// layer (32 us at 3.35 TB/s); a decode step's caches of a few hundred
// slots move about 3 MB a layer, where the launch's fixed cost counts.
//
// Design: one launch for both leaves (blockIdx.y picks K or V), so a layer
// costs one launch, not two, and a paged cache is read through its map with
// no gathered copy.  A warp takes 128 consecutive output words a round, a
// lane the words lane + 32 i (i < 4): the lane's four 4-byte loads are in
// flight together, each warp load covers 128 consecutive bytes of a row and
// each warp store 512 consecutive bytes of output at kv4 (a word's 8 bf16 as
// one 16-byte store; at kv8 4 bf16, 8 bytes).  A lane that owns 4 adjacent
// words stores 64 adjacent bytes, and the warp's stores then stride 64
// bytes apart, which is slower (scripts/kv_dequant_layouts.py times both
// layouts; PERF.md).  A word's scale is read once (once a code only where a word
// straddles two blocks, the WHOLE = false instantiation).  The codebook
// sits in shared memory.  The grid is sized to the SMs (8 blocks of 256 an
// SM) with a grid-stride loop.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 2048 / THREADS;
constexpr int WPL = 4;            // words a lane a round: loads in flight
constexpr int SPAN = 32 * WPL;    // words a warp a round
constexpr int MAX_DEVICES = 64;   // devices whose SM count is remembered

struct Leaf {
  const uint32_t* packed;       // [rows, n_words]
  const unsigned short* scales;  // bf16 [rows, n_blocks]
  unsigned short* out;          // bf16 [R, n_words * cpw]
};

struct Args {
  Leaf leaf[2];
  const int* map;   // [B, P] page ids, or null: src(r) = r
  int lps;          // log2 of the page size
  unsigned words;   // R * n_words, the words of a leaf's output
  int n_words, n_blocks, bs;
};

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // each rounded once, to nearest even
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float bf16_bits(unsigned short v) {
  return __uint_as_float(static_cast<unsigned>(v) << 16);
}

template <int BITS, bool WHOLE>
__global__ void __launch_bounds__(THREADS)
    kv_dequant_kernel(const Args a, const float* __restrict__ codebook) {
  constexpr int CPW = 32 / BITS;
  constexpr unsigned MASK = (1u << BITS) - 1u;
  __shared__ float lut[1 << BITS];
  for (int i = threadIdx.x; i < (1 << BITS); i += THREADS) lut[i] = codebook[i];
  __syncthreads();
  const Leaf L = blockIdx.y ? a.leaf[1] : a.leaf[0];
  const unsigned ps_mask = (1u << a.lps) - 1u;
  const unsigned lane = threadIdx.x & 31u;
  const unsigned warps = gridDim.x * (THREADS / 32);
  for (unsigned span = blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
       span * SPAN < a.words; span += warps) {
    // lane takes words span * SPAN + lane + 32 i: each load and each store
    // of the warp covers consecutive words
    uint32_t w[WPL];
    unsigned src[WPL], col[WPL];
#pragma unroll
    for (int i = 0; i < WPL; ++i) {
      // past the last word a lane reads the last word again and stores nothing
      const unsigned g = min(span * SPAN + lane + 32u * i, a.words - 1u);
      const unsigned r = g / a.n_words;
      col[i] = g - r * a.n_words;
      src[i] = a.map ? (static_cast<unsigned>(a.map[r >> a.lps]) << a.lps) | (r & ps_mask) : r;
      w[i] = L.packed[static_cast<size_t>(src[i]) * a.n_words + col[i]];
    }
#pragma unroll
    for (int i = 0; i < WPL; ++i) {
      const unsigned g = span * SPAN + lane + 32u * i;
      if (g >= a.words) break;
      const unsigned short* srow = L.scales + static_cast<size_t>(src[i]) * a.n_blocks;
      const int f0 = static_cast<int>(col[i]) * CPW;
      float s = bf16_bits(srow[f0 / a.bs]);
      uint32_t o[CPW / 2];
#pragma unroll
      for (int j = 0; j < CPW; j += 2) {
        if (!WHOLE && j) s = bf16_bits(srow[(f0 + j) / a.bs]);
        const float lo = lut[(w[i] >> (j * BITS)) & MASK] * s;
        if (!WHOLE) s = bf16_bits(srow[(f0 + j + 1) / a.bs]);
        o[j / 2] = pack_bf16x2(lo, lut[(w[i] >> ((j + 1) * BITS)) & MASK] * s);
      }
      // a word's CPW values: 16 bytes at kv4, 8 at kv8, at value g * CPW
      unsigned short* dst = L.out + static_cast<size_t>(g) * CPW;
      if constexpr (CPW == 8) {
        *reinterpret_cast<uint4*>(dst) = make_uint4(o[0], o[1], o[2], o[3]);
      } else {
        *reinterpret_cast<uint2*>(dst) = make_uint2(o[0], o[1]);
      }
    }
  }
}

}  // namespace

// Dequantizes one leaf (vp, vs, vo null) or two (K and V, the same shapes)
// on `stream` and returns cudaGetLastError(), or cudaErrorInvalidValue for a
// shape it does not take: bits other than 4 or 8, 2^31 output words or
// more, or a row of values that is not whole blocks.  rows is R, the output
// rows; page_map (int32 [R >> lps], page ids) is null for rows read as
// stored.  The outputs must be aligned to 16 bytes (a fresh allocation is).
extern "C" int kv_dequant(const void* kp, const void* ks, void* ko, const void* vp,
                          const void* vs, void* vo, const void* codebook, const void* page_map,
                          int lps, long long rows, int n_words, int n_blocks, int bits, int bs,
                          void* stream) {
  if ((bits != 4 && bits != 8) || n_words < 1 || bs < 1 ||
      static_cast<long long>(n_blocks) * bs != static_cast<long long>(n_words) * (32 / bits) ||
      lps < 0 || lps > 30 || rows < 0 || rows * n_words >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return 0;
  Args a;
  a.leaf[0] = {static_cast<const uint32_t*>(kp), static_cast<const unsigned short*>(ks),
               static_cast<unsigned short*>(ko)};
  a.leaf[1] = {static_cast<const uint32_t*>(vp), static_cast<const unsigned short*>(vs),
               static_cast<unsigned short*>(vo)};
  a.map = static_cast<const int*>(page_map);
  a.lps = page_map ? lps : 0;
  a.words = static_cast<unsigned>(rows * n_words);
  a.n_words = n_words;
  a.n_blocks = n_blocks;
  a.bs = bs;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  static int sms[MAX_DEVICES] = {};  // the SM count, per device
  int n_sm = dev < MAX_DEVICES ? sms[dev] : 0;
  if (n_sm == 0) {
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < MAX_DEVICES) sms[dev] = n_sm;
  }
  const long long spans = (static_cast<long long>(a.words) + SPAN - 1) / SPAN;
  const long long need = (spans + THREADS / 32 - 1) / (THREADS / 32);
  const long long most = static_cast<long long>(n_sm) * BLOCKS_PER_SM;
  const dim3 grid(static_cast<unsigned>(need < most ? need : most), vp ? 2 : 1);
  const auto* cb = static_cast<const float*>(codebook);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool whole = bs % (32 / bits) == 0;
  if (bits == 4) {
    if (whole) kv_dequant_kernel<4, true><<<grid, THREADS, 0, st>>>(a, cb);
    else kv_dequant_kernel<4, false><<<grid, THREADS, 0, st>>>(a, cb);
  } else {
    if (whole) kv_dequant_kernel<8, true><<<grid, THREADS, 0, st>>>(a, cb);
    else kv_dequant_kernel<8, false><<<grid, THREADS, 0, st>>>(a, cb);
  }
  return static_cast<int>(cudaGetLastError());
}
