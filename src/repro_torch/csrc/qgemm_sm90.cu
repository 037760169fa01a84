// Fused k-bit dequant-GEMM at prefill for Hopper (sm_90a): wgmma on tiles
// fed by the copy engine and cp.async, the weight dequantized into shared
// memory while the tensor cores multiply the previous K step.
//
// Replaces the bf16 half of the TPU kernel src/repro/kernels/qmatmul.py:97
// (qmatmul_pallas; bodies _qmatmul_kernel, _unpack_tile, _dequant_codes):
//
//   y[M, N] = x[M, K] . W^T,   W[n, k] = bf16_rn(dq(code[n, k]) * scale[n, k / B])
//
// x is bf16 [M, K]; code[n, k] is `bits` wide (3 to 8), packed
// cpw = 32 / bits to a 32-bit word, low bits first; dq is the f32 codebook;
// scale is bf16 [N, K / B].  The weight is rounded to bf16 after an f32
// product, once, as the TPU kernel does (qmatmul.py:80-85).  Sums are f32,
// y is bf16.  M and N are masked here; K comes from kernels/ops.py padded to
// lcm(cpw, B), a multiple of 8.
//
// Bound on an H100 SXM at prefill (M ~ 1000): operations, 2*M*N*K at 989
// TFLOP/s bf16 (13.5 ms for a Qwen2-7B prefill of 1024 rows).  wgmma is the
// only route to that rate; the design keeps the dequant and the copies off
// the tensor cores' path:
//   - an output tile of BM x 128 per block (BM = 256 at 4 and 8 bits, 128 at
//     3, 5, 6 and 7): two consumer warpgroups, each with BM / 128 m64n128k16
//     slabs, and a producer warpgroup that hands its registers to them
//     (setmaxnreg) and copies with one warp.  Every weight is decoded M / BM
//     times.
//   - a K step is KC codes (64 at 4, 7 and 8 bits, 80 at 3 and 6, 96 at 5: whole
//     packed words, whole k16 slices).  tile_x_kernel first writes x as one
//     image per (row tile, K step) in the shared-memory layout, so that the
//     producer moves a step's x with one bulk copy (cp.async.bulk, no tensor
//     map) and its packed words with 16-byte cp.async, into a ring of
//     STAGES stages; full and empty mbarriers per stage pace it.
//   - both bf16 tiles are K-major core matrices (8 rows x 16 bytes) that
//     wgmma reads through a descriptor: at KC = 64 in the 128-byte swizzle,
//     otherwise without swizzle.
//   - iteration it decodes step it + 1 into one of two W tiles (a thread
//     turns whole words into values: table read in shared memory, f32
//     product with the scale, cvt.rn.bf16x2.f32 in pairs, 16-byte stores)
//     and issues step it's wgmmas a few between its decode groups, so the
//     tensor cores run while the CUDA cores decode.  The scales come from
//     global memory a step ahead, into registers.
//   - grids with fewer tiles than SMs (the 512-wide k/v projections, the
//     paper sweep's narrow models) split K across blocks: the wrapper picks
//     the split (kernels/qmatmul.py:split_k), allocates an f32 workspace
//     [split, M, N], and a second kernel sums the splits in a fixed order.
//     No atomics, so the result is deterministic.
// The f32-activation path stays in qmatmul.cu (qgemm_simt).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BN = 128;       // output columns per block: the wgmma's n
constexpr int CONSUMERS = 256;            // two warpgroups: decode and products
constexpr int THREADS = CONSUMERS + 128;  // and a producer warpgroup, one warp of
                                          // which issues the copies
// registers a thread after setmaxnreg: the producers give theirs to the
// consumers (128 * 40 + 256 * 232 <= 65536), whose accumulators and decode
// need more than the 168 an even split of 384 threads would leave
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int WS_SLOTS = 2;   // decoded W tiles: one in the products, one being decoded
constexpr int MAX_STAGES = 8;
constexpr int LBO = 128;      // bytes between core matrices adjacent along K
constexpr int SMEM_BUDGET = 220 * 1024;  // dynamic shared memory a block may take
constexpr int MAX_DEVICES = 64;          // devices whose shared-memory attribute is remembered

__host__ __device__ constexpr int cgcd(int a, int b) { return b == 0 ? a : cgcd(b, a % b); }
__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }

// rows per block by bit width (kernels/qmatmul.py TILE_M): two warpgroups,
// each with SLABS m64 slabs.  256 rows halve the decodes per product; the
// wider codes' decode groups (40 values at 3 and 6 bits, 24 at 5) leave
// registers for one slab only; 7 bits keeps one slab too.
template <int BITS>
constexpr int tile_m() { return BITS == 4 || BITS == 8 ? 256 : 128; }

template <int BITS>
struct Cfg {
  static constexpr int BM = tile_m<BITS>();
  static constexpr int SLABS = BM / 128;
  static constexpr int CPW = 32 / BITS;
  static constexpr unsigned MASK = (1u << BITS) - 1u;
  // codes per K step: whole words and whole k16 slices, at least 64
  static constexpr int LCM16 = CPW * 16 / cgcd(CPW, 16);
  static constexpr int KC = LCM16 * ((64 + LCM16 - 1) / LCM16);
  static constexpr int KW = KC / CPW;    // packed words per column and step
  static constexpr int CH = KC / 8;      // 16-byte chunks per tile row and step
  // a decode group: whole words that fill whole 16-byte chunks
  static constexpr int GV = CPW * 8 / cgcd(CPW, 8);
  static constexpr int GW = GV / CPW;
  static constexpr int GPR = KC / GV;    // groups per column and step
  // a bf16 tile is 8-row groups of CH core matrices, LBO bytes apart; at
  // KC = 64 a row is 128 bytes, and its 16-byte chunks are stored swizzled
  // (chunk c of row r at c ^ r % 8, the 128-byte swizzle wgmma reads at full
  // rate); the wider steps of 3, 5 and 6 bits keep the plain layout
  static constexpr int SBO = CH * LBO;
  static constexpr bool SW128 = KC == 64;
  // WS_SLOTS W tiles, then the ring's stages: x tile and packed words
  static constexpr int X_BYTES = BM / 8 * SBO;
  static constexpr int P_BYTES = BN * KW * 4;
  static constexpr int STAGE_BYTES = X_BYTES + P_BYTES;
  static constexpr int W_BYTES = BN / 8 * SBO;
  static constexpr int STAGES =
      cmin(MAX_STAGES, (SMEM_BUDGET - WS_SLOTS * W_BYTES) / STAGE_BYTES);
  static constexpr int SMEM = STAGES * STAGE_BYTES + WS_SLOTS * W_BYTES + 1024;
  static_assert(KC % GV == 0 && KW % 4 == 0, "a step holds whole groups and 16-byte word runs");
  static_assert((BN * GPR) % CONSUMERS == 0, "whole rounds of threads");
  static constexpr int GROUPS = BN * GPR / CONSUMERS;  // decode groups per thread and step
  static constexpr int MMAS = SLABS * KC / 16;          // wgmmas per warpgroup and step
  static_assert(STAGES >= 3, "the ring needs a stage in flight beyond the two in use");
  static_assert(!SW128 || (SBO == 1024 && X_BYTES % 1024 == 0 && W_BYTES % 1024 == 0 &&
                           STAGE_BYTES % 1024 == 0), "swizzled tiles start on 1024 bytes");

  // byte offset of 16-byte chunk c (along K) of tile row `row`
  static __device__ __forceinline__ int chunk(int row, int c) {
    const int r8 = row & 7;
    return (row >> 3) * SBO + (SW128 ? (r8 * 128 + ((c ^ r8) << 4)) : (c * LBO + r8 * 16));
  }
  // descriptor of k16 slice kk of the 64 rows from `rows` (a shared address)
  static __device__ __forceinline__ uint64_t desc(uint32_t rows, int kk);
  static_assert(SMEM >= BM * (BN + 4) * 4, "the epilogue's f32 tile reuses the ring");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared, asynchronously; the first `src_bytes`
// are copied and the rest zero-filled
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// mbarriers: a stage is full once its bulk copy's bytes and the producer's
// cp.async copies have landed, empty once every consumer thread is done
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// an arrival on `bar` once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}
// the consumer warpgroups' own barrier (the producer warp runs ahead)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// `bytes` contiguous bytes global -> shared by the copy engine, completing
// on `bar`
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, int bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// this thread's shared-memory stores (the decoded W tile) made visible to
// wgmma, which reads through the async proxy
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma.  Only after the last wait: inside the main loop the
// empty asm would count as a write of the accumulators while a wgmma is in
// flight, and ptxas would serialise every wgmma (warning C7515).
__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor, no swizzle (layout_type 0, base_offset 0):
// start address, LBO (byte offset between core matrices adjacent along K)
// and SBO (between 8-row groups), each in 16-byte units.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32);
}

// d[64 x 128] += A[64 x 16] . B[128 x 16]^T, both bf16 K-major in shared
// memory.  Thread t of the warpgroup holds rows 16 * (t / 32) + (t % 32) / 4
// (+ 8) and columns 8 * c + 2 * (t % 4) (+ 1): d[4c + 2i + j] is row + 8i,
// column + j.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <int BITS>
__device__ __forceinline__ uint64_t Cfg<BITS>::desc(uint32_t rows, int kk) {
  if (SW128)  // layout_type 1; LBO unused; the slice starts 32 bytes on per kk
    return make_desc(rows + kk * 32, 16, SBO) | (1ull << 62);
  return make_desc(rows + kk * 2 * LBO, LBO, SBO);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // cvt.rn.bf16x2.f32
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float bf16_bits_to_float(unsigned short v) {
  return __uint_as_float(static_cast<unsigned>(v) << 16);
}

struct Problem {
  const unsigned char* x_tiles;  // x in tile images (tile_x_kernel)
  const uint32_t* packed;
  const unsigned short* scales;  // bf16 bits
  const float* codebook;
  int M, N, K, n_words, block_size, lg_block, n_blocks, nk;
  bool words_vec;  // rows of packed words start on 16-byte boundaries
};

template <int BITS>
struct Tile {
  using C = Cfg<BITS>;
  Problem p;
  unsigned char* smem;
  const uint64_t* full;   // per stage: its copies have landed
  const uint64_t* empty;  // per stage: the consumers are done with it
  int m0, n0, tid;

  __device__ unsigned char* stage(int s) const {
    return smem + WS_SLOTS * C::W_BYTES + s * C::STAGE_BYTES;
  }
  __device__ unsigned char* wtile(int w) const { return smem + w * C::W_BYTES; }

  // K step t into ring stage s, by the producer warp (lane = tid - 256):
  // the x tile image by the copy engine and the packed words of the block's
  // BN columns by cp.async, both completing on full[s]
  __device__ void issue_copies(int t, int s, int lane) const {
    unsigned char* st = stage(s);
    const uint32_t bar = smem_u32(full + s);
    const int k0 = t * C::KC;
    if (lane == 0) {
      const size_t tile = static_cast<size_t>(m0 / C::BM) * p.nk + t;
      bulk_copy(smem_u32(st), p.x_tiles + tile * C::X_BYTES, C::X_BYTES, bar);
    }
    const uint32_t ps = smem_u32(st + C::X_BYTES);
    const int w0 = t * C::KW;
    if (p.words_vec) {
#pragma unroll 4
      for (int i = lane; i < BN * C::KW / 4; i += 32) {
        const int n = i / (C::KW / 4);
        const int w = w0 + (i % (C::KW / 4)) * 4;
        const bool ok = n0 + n < p.N && w < p.n_words;
        cp_async16(ps + i * 16,
                   p.packed + (ok ? static_cast<size_t>(n0 + n) * p.n_words + w : 0), ok);
      }
    } else {
      for (int i = lane; i < BN * C::KW; i += 32) {
        const int n = i / C::KW;
        const int w = w0 + i % C::KW;
        const bool ok = n0 + n < p.N && w < p.n_words;
        cp_async4(ps + i * 4, p.packed + (ok ? static_cast<size_t>(n0 + n) * p.n_words + w : 0),
                  ok ? 4 : 0);
      }
    }
    cp_async_arrive(bar);
  }

  // wgmmas [i0, i1) of this warpgroup's MMAS on stage s and W tile w:
  // slab i / (KC / 16), k16 slice i % (KC / 16)
  __device__ void mma(int s, int w, int wg, float (&acc)[C::SLABS][64], int i0, int i1) const {
    const uint32_t wb = smem_u32(wtile(w));
#pragma unroll
    for (int i = 0; i < C::MMAS; ++i) {
      if (i < i0 || i >= i1) continue;
      const int j = i / (C::KC / 16);
      const int kk = i % (C::KC / 16);
      const uint32_t xa = smem_u32(stage(s)) + (wg * C::SLABS + j) * 8 * C::SBO;  // 64 rows
      wgmma_m64n128k16(acc[j], C::desc(xa, kk), C::desc(wb, kk));
    }
  }

  // column n (of the tile) and K group gq of this thread's decode group r
  __device__ void group_of(int r, int& n, int& gq) const {
    const int q = tid + r * CONSUMERS;
    gq = (q >> 3) % C::GPR;
    n = (q >> 3) / C::GPR * 8 + (q & 7);
  }
  // block b's scale of tile column n, 0 past N and past K
  __device__ unsigned short scale_bits(int n, int b) const {
    return n0 + n < p.N && b < p.n_blocks
               ? __ldg(p.scales + static_cast<size_t>(n0 + n) * p.n_blocks + b)
               : static_cast<unsigned short>(0);
  }
  // a group never straddles a scale block when B is a multiple of its length
  __device__ bool one_scale() const { return p.block_size % C::GV == 0; }
  // the one scale of each of this thread's decode groups of step t (read
  // from global memory a step ahead of the decode that uses them)
  __device__ void load_scales(int t, unsigned short (&sc)[C::GROUPS]) const {
#pragma unroll
    for (int r = 0; r < C::GROUPS; ++r) {
      int n, gq;
      group_of(r, n, gq);
      const int kg = t * C::KC + gq * C::GV;
      sc[r] = scale_bits(n, p.lg_block >= 0 ? kg >> p.lg_block : kg / p.block_size);
    }
  }

  // the packed words of step t, in stage s, to the bf16 W tile w, with the
  // scales load_scales(t) gave where one_scale(); before decode group r,
  // before_group(r) runs (the products of the step before, issued a few at a
  // time so that their issue does not hold the decode up)
  template <typename F>
  __device__ void decode(int t, int s, int w, const float* lut,
                         const unsigned short (&sc)[C::GROUPS], F&& before_group) const {
    const uint32_t* pk = reinterpret_cast<const uint32_t*>(stage(s) + C::X_BYTES);
    unsigned char* ws = wtile(w);
    const int B = p.block_size;
    const int k0 = t * C::KC;
#pragma unroll
    for (int r = 0; r < C::GROUPS; ++r) {
      before_group(r);
      int n, gq;
      group_of(r, n, gq);
      uint32_t words[C::GW];
#pragma unroll
      for (int j = 0; j < C::GW; ++j) words[j] = pk[n * C::KW + gq * C::GW + j];
      const int kg = k0 + gq * C::GV;
      float vals[C::GV];
      if (one_scale()) {
        const float sv = bf16_bits_to_float(sc[r]);
#pragma unroll
        for (int j = 0; j < C::GV; ++j)
          vals[j] = lut[(words[j / C::CPW] >> ((j % C::CPW) * BITS)) & C::MASK] * sv;
      } else {
        int b = kg / B;
        int rem = kg - b * B;
        float sv = bf16_bits_to_float(scale_bits(n, b));
#pragma unroll
        for (int j = 0; j < C::GV; ++j) {
          if (rem == B) {  // the group crosses into the next scale block
            ++b;
            rem = 0;
            sv = bf16_bits_to_float(scale_bits(n, b));
          }
          ++rem;
          vals[j] = lut[(words[j / C::CPW] >> ((j % C::CPW) * BITS)) & C::MASK] * sv;
        }
      }
#pragma unroll
      for (int c = 0; c < C::GV / 8; ++c) {
        uint4 v;
        v.x = pack_bf16x2(vals[8 * c + 0], vals[8 * c + 1]);
        v.y = pack_bf16x2(vals[8 * c + 2], vals[8 * c + 3]);
        v.z = pack_bf16x2(vals[8 * c + 4], vals[8 * c + 5]);
        v.w = pack_bf16x2(vals[8 * c + 6], vals[8 * c + 7]);
        *reinterpret_cast<uint4*>(ws + C::chunk(n, gq * C::GV / 8 + c)) = v;
      }
    }
  }
};

template <int BITS>
__global__ void __launch_bounds__(THREADS, 1)
qgemm_sm90_kernel(Problem p, bf16* __restrict__ y, float* __restrict__ partial,
                  int steps_per_split) {
  using C = Cfg<BITS>;
  constexpr int S = C::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzle pattern repeats every 1024 bytes: start the tiles on one
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  __shared__ float lut[1 << BITS];
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  __shared__ uint64_t full[S];
  __shared__ uint64_t empty[S];
  const Tile<BITS> tile{p, smem, full, empty, static_cast<int>(blockIdx.y) * C::BM,
                        static_cast<int>(blockIdx.x) * BN, tid};
  for (int i = tid; i < (1 << BITS); i += THREADS) lut[i] = p.codebook[i];
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(smem_u32(full + s), 32 + 1);  // the producer's lanes, its bulk copy
      mbar_init(smem_u32(empty + s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int t0 = blockIdx.z * steps_per_split;
  const int n_steps = min(p.nk, t0 + steps_per_split) - t0;

  if (tid >= CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid >= CONSUMERS + 32) return;
    // the producer warp: step t into stage t % S once the consumers have
    // released the stage's previous step
    for (int t = 0; t < n_steps; ++t) {
      const int s = t % S;
      if (t >= S) mbar_wait(smem_u32(empty + s), (t / S - 1) & 1);
      tile.issue_copies(t0 + t, s, tid - CONSUMERS);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));

  float acc[C::SLABS][64];
#pragma unroll
  for (int j = 0; j < C::SLABS; ++j)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[j][i] = 0.f;

  // Step it's x and words sit in stage it % S, its decoded weight in W
  // tile it % 2.  Iteration it issues step it's wgmmas a few before each
  // decode group of step it + 1, so the tensor cores run step it while the
  // CUDA cores decode the next, and loads step it + 2's scales; then it
  // waits for the products, releases stage it % S to the producer, and one
  // barrier publishes the new W tile.
  auto none = [](int) {};
  unsigned short sc[C::GROUPS] = {}, sc_next[C::GROUPS] = {};
  const bool prefetch = tile.one_scale();
  if (n_steps > 0) {
    if (prefetch) tile.load_scales(t0, sc);
    mbar_wait(smem_u32(full), 0);
    tile.decode(t0, 0, 0, lut, sc, none);
    if (prefetch && n_steps > 1) tile.load_scales(t0 + 1, sc);
  }
  fence_async_shared();
  consumer_sync();
  // `cur` holds step it + 1's scales; step it + 2's load into `next`, and the
  // two swap roles every iteration (a copy would wait for the load)
  auto iteration = [&](int it, const unsigned short (&cur)[C::GROUPS],
                       unsigned short (&next)[C::GROUPS]) {
    const int s = it % S;
    const int w = it % WS_SLOTS;
    wgmma_fence();
    if (it + 1 < n_steps) {
      const int s1 = (it + 1) % S;
      if (prefetch && it + 2 < n_steps) tile.load_scales(t0 + it + 2, next);
      mbar_wait(smem_u32(full + s1), ((it + 1) / S) & 1);
      tile.decode(t0 + it + 1, s1, (it + 1) % WS_SLOTS, lut, cur, [&](int r) {
        tile.mma(s, w, wg, acc, r * C::MMAS / C::GROUPS, (r + 1) * C::MMAS / C::GROUPS);
      });
    } else {
      tile.mma(s, w, wg, acc, 0, C::MMAS);
    }
    wgmma_commit();
    wgmma_wait<0>();
    mbar_arrive(smem_u32(empty + s));
    fence_async_shared();
    consumer_sync();
  };
  int it = 0;
  for (; it + 1 < n_steps; it += 2) {
    iteration(it, sc, sc_next);
    iteration(it + 1, sc_next, sc);
  }
  if (it < n_steps) iteration(it, sc, sc_next);
#pragma unroll
  for (int j = 0; j < C::SLABS; ++j) fence_operands(acc[j]);

  // epilogue: the accumulators through shared memory (the ring is free) to
  // 16-byte stores of y, or of this split's f32 partial sums
  const int lane = tid & 31;
  const int row0 = wg * C::SLABS * 64 + ((tid & 127) >> 5) * 16 + (lane >> 2);
  const int col = (lane & 3) * 2;
  const int m0 = tile.m0, n0 = tile.n0;
  if (partial == nullptr) {
    constexpr int LD = BN + 8;
    bf16* t = reinterpret_cast<bf16*>(smem);
#pragma unroll
    for (int j = 0; j < C::SLABS; ++j)
#pragma unroll
      for (int c = 0; c < BN / 8; ++c)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          *reinterpret_cast<uint32_t*>(t + (row0 + 64 * j + 8 * i) * LD + 8 * c + col) =
              pack_bf16x2(acc[j][4 * c + 2 * i], acc[j][4 * c + 2 * i + 1]);
    consumer_sync();
    const bool vec = p.N % 8 == 0;
    for (int i = tid; i < C::BM * BN / 8; i += CONSUMERS) {
      const int r = i / (BN / 8);
      const int c = (i % (BN / 8)) * 8;
      const int m = m0 + r;
      const int n = n0 + c;
      if (m >= p.M || n >= p.N) continue;
      bf16* dst = y + static_cast<size_t>(m) * p.N + n;
      const bf16* src = t + r * LD + c;
      if (vec) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int e = 0; e < 8 && n + e < p.N; ++e) dst[e] = src[e];
      }
    }
  } else {
    constexpr int LD = BN + 4;
    float* t = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int j = 0; j < C::SLABS; ++j)
#pragma unroll
      for (int c = 0; c < BN / 8; ++c)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          *reinterpret_cast<float2*>(t + (row0 + 64 * j + 8 * i) * LD + 8 * c + col) =
              make_float2(acc[j][4 * c + 2 * i], acc[j][4 * c + 2 * i + 1]);
    consumer_sync();
    float* out = partial + static_cast<size_t>(blockIdx.z) * p.M * p.N;
    const bool vec = p.N % 4 == 0;
    for (int i = tid; i < C::BM * BN / 4; i += CONSUMERS) {
      const int r = i / (BN / 4);
      const int c = (i % (BN / 4)) * 4;
      const int m = m0 + r;
      const int n = n0 + c;
      if (m >= p.M || n >= p.N) continue;
      float* dst = out + static_cast<size_t>(m) * p.N + n;
      const float* src = t + r * LD + c;
      if (vec) {
        *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
      } else {
        for (int e = 0; e < 4 && n + e < p.N; ++e) dst[e] = src[e];
      }
    }
  }
}

// x [M, K] -> tile images: for each 128-row tile mt and K step t, the
// X_BYTES of the x tile in the core-matrix layout the main kernel's stage
// holds, rows past M and K past the end zero; one 16-byte chunk a thread
template <int BITS>
__global__ void tile_x_kernel(const bf16* __restrict__ x, unsigned char* __restrict__ x_tiles,
                              int M, int K, int nk, size_t n_chunks) {
  using C = Cfg<BITS>;
  const size_t j = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= n_chunks) return;
  const size_t per_row = static_cast<size_t>(nk) * C::CH;
  const int row_g = static_cast<int>(j / per_row);
  const int cg = static_cast<int>(j % per_row);
  const int t = cg / C::CH;
  const int c = cg % C::CH;
  const int k = t * C::KC + c * 8;
  const int row = row_g % C::BM;
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (row_g < M && k < K) v = *reinterpret_cast<const uint4*>(x + static_cast<size_t>(row_g) * K + k);
  unsigned char* tile = x_tiles + (static_cast<size_t>(row_g / C::BM) * nk + t) * C::X_BYTES;
  *reinterpret_cast<uint4*>(tile + C::chunk(row, c)) = v;
}

// y = bf16(sum over z of partial[z]), z in order
__global__ void splitk_sum_kernel(const float* __restrict__ partial, bf16* __restrict__ y,
                                  size_t mn, int split) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float s = 0.f;
  for (int z = 0; z < split; ++z) s += partial[static_cast<size_t>(z) * mn + i];
  y[i] = __float2bfloat16_rn(s);
}

template <int BITS>
int launch(const Problem& p, const bf16* x, unsigned char* x_tiles, bf16* y, float* workspace,
           int split, cudaStream_t stream) {
  using C = Cfg<BITS>;
  const int nk = (p.K + C::KC - 1) / C::KC;
  if (split < 1 || nk % split != 0 || (split > 1 && workspace == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  static bool attr_set[MAX_DEVICES] = {};  // the attribute is per device
  if (dev >= MAX_DEVICES || !attr_set[dev]) {
    e = cudaFuncSetAttribute(qgemm_sm90_kernel<BITS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < MAX_DEVICES) attr_set[dev] = true;
  }
  Problem q = p;
  q.nk = nk;
  q.x_tiles = x_tiles;
  const int m_tiles = (p.M + C::BM - 1) / C::BM;
  const size_t n_chunks = static_cast<size_t>(m_tiles) * C::BM * nk * C::CH;
  tile_x_kernel<BITS><<<static_cast<unsigned>((n_chunks + 255) / 256), 256, 0, stream>>>(
      x, x_tiles, p.M, p.K, nk, n_chunks);
  const dim3 grid((p.N + BN - 1) / BN, m_tiles, split);
  qgemm_sm90_kernel<BITS><<<grid, THREADS, C::SMEM, stream>>>(
      q, y, split > 1 ? workspace : nullptr, nk / split);
  if (split > 1) {
    const size_t mn = static_cast<size_t>(p.M) * p.N;
    splitk_sum_kernel<<<static_cast<unsigned>((mn + 255) / 256), 256, 0, stream>>>(workspace, y,
                                                                                   mn, split);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() after both launches,
// or cudaErrorInvalidValue for a shape, bit width or split it does not take.
// `x_tiles` holds ceil(M / 128) * 128 * ceil(K / KC) * KC bf16 (the tile
// images of x); `workspace` is f32 [split, M, N] when split > 1, else unused.
extern "C" int qgemm_sm90(const void* x, const void* packed, const void* scales,
                          const void* codebook, void* y, void* x_tiles, void* workspace, int M,
                          int N, int K, int n_words, int bits, int block_size, int split,
                          void* stream) {
  if (M < 1 || N < 1 || K < 8 || K % 8 != 0 || block_size < 1 || K % block_size != 0 ||
      bits < 3 || bits > 8 || K != n_words * (32 / bits))
    return static_cast<int>(cudaErrorInvalidValue);
  int lg = -1;
  if ((block_size & (block_size - 1)) == 0) {
    lg = 0;
    while ((1 << lg) < block_size) ++lg;
  }
  const Problem p{nullptr,
                  static_cast<const uint32_t*>(packed),
                  static_cast<const unsigned short*>(scales),
                  static_cast<const float*>(codebook),
                  M, N, K, n_words, block_size, lg, K / block_size, 0,
                  n_words % 4 == 0 && reinterpret_cast<uintptr_t>(packed) % 16 == 0};
  const bf16* xb = static_cast<const bf16*>(x);
  unsigned char* xt = static_cast<unsigned char*>(x_tiles);
  bf16* out = static_cast<bf16*>(y);
  float* ws = static_cast<float*>(workspace);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 3: return launch<3>(p, xb, xt, out, ws, split, s);
    case 4: return launch<4>(p, xb, xt, out, ws, split, s);
    case 5: return launch<5>(p, xb, xt, out, ws, split, s);
    case 6: return launch<6>(p, xb, xt, out, ws, split, s);
    case 7: return launch<7>(p, xb, xt, out, ws, split, s);
    case 8: return launch<8>(p, xb, xt, out, ws, split, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
