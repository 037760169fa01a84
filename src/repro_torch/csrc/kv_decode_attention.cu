// Decode attention over the packed k-bit KV cache, for Hopper (sm_90a): the
// cache is dequantized in registers on its way to the tensor cores, so bf16
// K and V never land in device memory.
//
// Replaces, on the decode path, the TPU kernel
// src/repro/kernels/kv_dequant.py::dequant_rows_pallas (body
// _dequant_kernel) together with the attention that reads its output: the
// reference's dequant_cache_kv + decode_attention_partial + combine_partials
// (src/repro/models/attention.py:465-550), which the port used to run as two
// launches of csrc/kv_dequant.cu and some fifteen eager PyTorch kernels a
// layer.  csrc/kv_dequant.cu stays as the standalone row dequant.
//
// For batch row b and query head h = kh * G + g (G = H / K query heads a
// KV head kh), over the cache's S slots:
//
//   K[t, d]  = bf16_rn(codebook[code] * scale)      (V alike), as B2 computes
//   s[t]     = (sum_d f32(q[h, d]) * f32(K[t, d])) * Dh^-0.5
//   s[t]     = cap * tanh(s[t] / cap)                 (with a logit soft-cap)
//   valid[t] = pos_arr[t] >= 0 && pos_arr[t] <= pos
//   m        = max(max_{valid t} s[t], NEG_INF / 2)  over the whole cache
//   p[t]     = valid[t] ? exp(s[t] - m) : 0,   l = sum_t p[t]   (f32)
//   out[h]   = bf16_rn((sum_t f32(bf16_rn(p[t])) * f32(V[t, :])) / max(l, 1e-30))
//
// (no window: the wrapper refuses one).  p is rounded
// to bf16 against the global max, as the plain version rounds it; a split
// over S that rescaled partial results would round p differently, so the
// cache's slots are split across the CTAs of a thread-block cluster that
// agree on m before any p is formed.  Only the order of f32 sums differs
// from the plain version.
//
// What bounds it on an H100 SXM: bytes, the packed K and V and their scales
// (8.9 MB a layer for Qwen2-7B at batch 4, 4096 slots, kv4: 2.7 us at 3.35
// TB/s; 0.63 MB at 288 slots).  The products (4 * B * H * S * Dh) are far
// below the tensor cores' line.  The dequant's issue, about 4 instructions a
// value, is the work to keep small.
//
// Design: a cluster of 8 CTAs per (batch row, KV head); CTA c takes the
// slots [c * tpc, (c + 1) * tpc).  Each CTA copies its slots' packed K and V
// words of its head, and their scales, into shared memory with cp.async
// (K and V both in flight from the start; slots past S zero-filled), in
// rounds of `cap` slots where the cache is too long for one.  Products run
// on mma.sync m16n8k16 (bf16 in, f32 sums), the G <= 8 query heads as the
// n = 8 side:
//   scores  A = 16 slots x 16 features of K, B = 16 features x 8 heads of q.
//           Lane (g, t) decodes words t * Dh/32 .. of slots g and g + 8 of
//           its 16-slot tile (at kv4 one 16-byte load a slot): feature
//           t * Dh/4 + 4 s + i is code i of k-step s, so q's B fragment is
//           q as stored, read once into registers.
//   values  A = 16 features x 16 slots of V^T, B = 16 slots x 8 heads of
//           bf16(p).  Lane (g, t) decodes features g * Dh/8 .. g * Dh/8 +
//           Dh/8 - 1 of slots 2t, 2t+1, 2t+8, 2t+9: m-tile i's rows g and
//           g + 8 are features g * Dh/8 + i and g * Dh/8 + Dh/16 + i.
// The scores of the CTA's slots sit in shared memory; the CTAs exchange
// their per-head maxima through distributed shared memory, form p (bf16 in
// shared memory, l in f32) and multiply V; partial l and p.V are summed
// over the CTA's warps, then over the cluster in rank order, and each CTA
// writes an eighth of the [G, Dh] output.  The codebook sits in shared
// memory; a word's scale is the block that covers its first feature (the
// wrapper requires blocks of whole words), wherever blocks fall in a head.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int CLUSTER = 8;   // CTAs sharing one (batch row, KV head)
constexpr int WARPS = 4;     // 8 were 20 % slower at 288 slots, 4 % faster at 4096 (PERF.md)
constexpr int THREADS = WARPS * 32;
constexpr int MAX_G = 8;     // query heads a KV head: the mma's n
constexpr int MAX_SMEM = 232448;
constexpr float NEG_HALF = -5e29f;   // NEG_INF / 2 of models/attention.py
constexpr int MAX_DEVICES = 64;      // devices whose shared-memory attribute is remembered

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // cvt.rn.bf16x2.f32
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float bf16_bits(unsigned short v) {
  return __uint_as_float(static_cast<unsigned>(v) << 16);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// d += A . B on the tensor cores, bf16 operands, f32 sums
__device__ __forceinline__ void mma_16816(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                          uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

struct Args {
  const unsigned short* q;    // bf16 [B, H, Dh]
  const uint32_t* kp;         // [B, S, W] packed words
  const uint32_t* vp;
  const unsigned short* ks;   // bf16 [B, S, NB] scales
  const unsigned short* vs;
  const float* codebook;      // f32 [2^bits]
  const int* pos_arr;         // [S]
  unsigned short* out;        // bf16 [B, H, Dh]
  int S, W, NB, bs, H, G, pos, cap, sw;  // cap: slots a round
  float sm_scale, softcap;                // softcap: the logit soft-cap, 0 for none
};

// shared memory, in 4-byte words, shared by the host (its size, the slots
// a round) and the kernel (its offsets)
struct Layout {
  int tpc, tpcp, tpc2, k_words, v_words;
  int o_lut, o_m, o_mg, o_l, o_redm, o_pvc, o_sc, o_p, o_k, o_v, words;
};

__host__ __device__ inline Layout make_layout(int S, int G, int dh, int wph, int sw, int cap) {
  Layout L;
  L.tpc = ((S + CLUSTER - 1) / CLUSTER + 15) / 16 * 16;  // slots a CTA, whole 16-slot tiles
  L.tpcp = L.tpc + 4;                                    // score row stride (f32)
  L.tpc2 = L.tpc + 8;                                    // p row stride (bf16)
  const int red = WARPS * MAX_G * dh;                    // per-warp p.V, aliases the K buffer
  const int stage = cap * (wph + sw);
  L.k_words = ((stage > red ? stage : red) + 3) / 4 * 4;
  L.v_words = (stage + 3) / 4 * 4;
  L.o_lut = 0;
  L.o_m = 256;
  L.o_mg = L.o_m + MAX_G;
  L.o_l = L.o_mg + MAX_G;
  L.o_redm = L.o_l + MAX_G;
  L.o_pvc = L.o_redm + WARPS * MAX_G;
  L.o_sc = L.o_pvc + MAX_G * dh;
  L.o_p = L.o_sc + G * L.tpcp;
  L.o_k = (L.o_p + (G * L.tpc2 + 1) / 2 + 3) / 4 * 4;    // 16-byte aligned
  L.o_v = L.o_k + L.k_words;
  L.words = L.o_v + L.v_words;
  return L;
}

template <int BITS, int DH>
struct Shape {
  static constexpr int CPW = 32 / BITS;
  static constexpr int WPH = DH * BITS / 32;  // words of one head in a slot
  static constexpr int WPL = WPH / 4;         // a lane's words of a slot (scores)
  static constexpr int MT = DH / 16;          // k-steps (scores), m-tiles (values)
  static constexpr int FPL = DH / 8;          // a lane's features of a slot (values)
  static constexpr int NWV = FPL >= CPW ? FPL / CPW : 1;   // their words
};

// copy round `rnd`'s slots of one head's packed words and scales into buf
template <int WPH>
__device__ __forceinline__ void stage(uint32_t* buf, const uint32_t* words,
                                      const unsigned short* scales, const Args& a, int b,
                                      int kh, int t0, int n, int b_lo, int nbh) {
  uint32_t* bw = buf;
  uint32_t* bsc = buf + n * WPH;
  for (int idx = threadIdx.x; idx < n * (WPH / 4); idx += THREADS) {
    const int i = idx / (WPH / 4), k = idx - i * (WPH / 4);
    const int t = t0 + i;
    const bool ok = t < a.S;
    const uint32_t* src =
        ok ? words + (static_cast<long long>(b) * a.S + t) * a.W + kh * WPH + 4 * k : words;
    cp_async16(bw + i * WPH + 4 * k, src, ok ? 16 : 0);
  }
  for (int idx = threadIdx.x; idx < n * a.sw; idx += THREADS) {
    const int i = idx / a.sw, k = idx - i * a.sw;
    const int t = t0 + i;
    const long long e0 = (static_cast<long long>(b) * a.S + t) * a.NB + b_lo;
    const long long e = (e0 & ~1LL) + 2 * k;  // first element of this 4-byte word
    long long avail = (e0 + nbh - e) * 2;
    avail = avail < 0 ? 0 : (avail > 4 ? 4 : avail);
    const int bytes = t < a.S ? static_cast<int>(avail) : 0;
    cp_async4(bsc + i * a.sw + k, bytes ? scales + e : scales, bytes);
  }
}

template <int BITS, int DH>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS)
    kv_decode_attention_kernel(const Args a) {
  using Sh = Shape<BITS, DH>;
  constexpr int CPW = Sh::CPW, WPH = Sh::WPH, WPL = Sh::WPL, MT = Sh::MT, FPL = Sh::FPL,
                NWV = Sh::NWV;
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  extern __shared__ uint4 smem4[];
  uint32_t* smem = reinterpret_cast<uint32_t*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();

  const int rank = static_cast<int>(cluster.block_rank());
  const int kh = blockIdx.y, b = blockIdx.z;
  const int G = a.G;
  const Layout L = make_layout(a.S, G, DH, WPH, a.sw, a.cap);
  float* lut = reinterpret_cast<float*>(smem + L.o_lut);
  float* mloc = reinterpret_cast<float*>(smem + L.o_m);
  float* mg = reinterpret_cast<float*>(smem + L.o_mg);
  float* lloc = reinterpret_cast<float*>(smem + L.o_l);
  float* redm = reinterpret_cast<float*>(smem + L.o_redm);
  float* pvc = reinterpret_cast<float*>(smem + L.o_pvc);
  float* sc = reinterpret_cast<float*>(smem + L.o_sc);
  unsigned short* P = reinterpret_cast<unsigned short*>(smem + L.o_p);
  uint32_t* kbuf = smem + L.o_k;
  uint32_t* vbuf = smem + L.o_v;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int tok0 = rank * L.tpc;                          // the CTA's first slot
  const int nt = max(0, min(a.S, tok0 + L.tpc) - tok0);   // its slots in the cache
  const int nt16 = (nt + 15) / 16 * 16;
  const int rounds = (nt16 + a.cap - 1) / a.cap;
  const int b_lo = kh * DH / a.bs;
  const int nbh = (kh * DH + DH - 1) / a.bs - b_lo + 1;

  // K and V of the first round in flight from the start
  if (rounds > 0) {
    const int n = min(a.cap, nt16);
    stage<WPH>(kbuf, a.kp, a.ks, a, b, kh, tok0, n, b_lo, nbh);
    cp_async_commit();
    stage<WPH>(vbuf, a.vp, a.vs, a, b, kh, tok0, n, b_lo, nbh);
    cp_async_commit();
  }
  for (int i = tid; i < (1 << BITS); i += THREADS) lut[i] = a.codebook[i];

  // the lane's q: head g, features t * DH/4 .. t * DH/4 + DH/4 - 1 (B fragments)
  uint32_t qf[DH / 8];
  {
    const bool live = g < G;
    const uint4* src = reinterpret_cast<const uint4*>(
        a.q + (static_cast<long long>(b) * a.H + kh * G + (live ? g : 0)) * DH + t * (DH / 4));
#pragma unroll
    for (int k = 0; k < DH / 32; ++k) {
      const uint4 v = live ? __ldg(src + k) : make_uint4(0u, 0u, 0u, 0u);
      qf[4 * k] = v.x;
      qf[4 * k + 1] = v.y;
      qf[4 * k + 2] = v.z;
      qf[4 * k + 3] = v.w;
    }
  }
  // the scale block (from b_lo) of each of the lane's words: scores, values
  int lbk[WPL], lbv[NWV];
#pragma unroll
  for (int j = 0; j < WPL; ++j) lbk[j] = (kh * DH + (t * WPL + j) * CPW) / a.bs - b_lo;
  const int wv0 = g * FPL / CPW;                   // the lane's first word of a slot (values)
  const int vshift = (g * FPL % CPW) * BITS;       // its first code's bit (FPL < CPW)
#pragma unroll
  for (int j = 0; j < NWV; ++j) lbv[j] = (kh * DH + (wv0 + j) * CPW) / a.bs - b_lo;

  // --- scores: s[h][slot] for the CTA's slots, and the lane's maxima ---
  float mx0 = -INFINITY, mx1 = -INFINITY;  // heads 2t, 2t + 1
  for (int rnd = 0; rnd < rounds; ++rnd) {
    const int r0 = rnd * a.cap;
    const int n = min(a.cap, nt16 - r0);
    if (rnd == 0) {
      cp_async_wait<1>();  // K of round 0; V may still be in flight
    } else {
      stage<WPH>(kbuf, a.kp, a.ks, a, b, kh, tok0 + r0, n, b_lo, nbh);
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t* bw = kbuf;
    const unsigned short* bsc = reinterpret_cast<const unsigned short*>(kbuf + n * WPH);
    for (int tile = warp; tile < n / 16; tile += WARPS) {
      uint32_t pr[2][WPL][CPW / 2];  // decoded pairs of slots g, g + 8
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = tile * 16 + g + 8 * hh;
        const int tok = tok0 + r0 + i;
        const int par = static_cast<int>(((static_cast<long long>(b) * a.S + tok) * a.NB + b_lo) & 1);
        const unsigned short* srow = bsc + i * 2 * a.sw + par;
        uint32_t w[WPL];
        if constexpr (WPL % 4 == 0) {
#pragma unroll
          for (int k = 0; k < WPL / 4; ++k) {
            const uint4 v = *reinterpret_cast<const uint4*>(bw + i * WPH + t * WPL + 4 * k);
            w[4 * k] = v.x;
            w[4 * k + 1] = v.y;
            w[4 * k + 2] = v.z;
            w[4 * k + 3] = v.w;
          }
        } else {
#pragma unroll
          for (int k = 0; k < WPL; ++k) w[k] = bw[i * WPH + t * WPL + k];
        }
#pragma unroll
        for (int j = 0; j < WPL; ++j) {
          const float s = bf16_bits(srow[lbk[j]]);
#pragma unroll
          for (int p = 0; p < CPW / 2; ++p)
            pr[hh][j][p] = pack_bf16x2(lut[(w[j] >> (2 * p * BITS)) & MASK] * s,
                                       lut[(w[j] >> ((2 * p + 1) * BITS)) & MASK] * s);
        }
      }
      float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int st = 0; st < MT; ++st) {
        const int j = st / (CPW / 4), h2 = 2 * (st % (CPW / 4));
        mma_16816(d, pr[0][j][h2], pr[1][j][h2], pr[0][j][h2 + 1], pr[1][j][h2 + 1],
                  qf[2 * st], qf[2 * st + 1]);
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = tile * 16 + g + 8 * hh;
        const int tok = tok0 + r0 + i;
        bool valid = tok < a.S;
        if (valid) {
          const int pa = __ldg(a.pos_arr + tok);
          valid = pa >= 0 && pa <= a.pos;
        }
        float s0 = d[2 * hh] * a.sm_scale, s1 = d[2 * hh + 1] * a.sm_scale;
        if (a.softcap > 0.f) {
          s0 = a.softcap * tanhf(s0 / a.softcap);
          s1 = a.softcap * tanhf(s1 / a.softcap);
        }
        s0 = valid ? s0 : -INFINITY;
        s1 = valid ? s1 : -INFINITY;
        if (2 * t < G) sc[(2 * t) * L.tpcp + r0 + i] = s0;
        if (2 * t + 1 < G) sc[(2 * t + 1) * L.tpcp + r0 + i] = s1;
        mx0 = fmaxf(mx0, s0);
        mx1 = fmaxf(mx1, s1);
      }
    }
    __syncthreads();
  }

  // --- the maximum over the whole cache, agreed across the cluster ---
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  if (g == 0) {
    redm[warp * MAX_G + 2 * t] = mx0;
    redm[warp * MAX_G + 2 * t + 1] = mx1;
  }
  __syncthreads();
  if (tid < MAX_G) {
    float m = -INFINITY;
    for (int w = 0; w < WARPS; ++w) m = fmaxf(m, redm[w * MAX_G + tid]);
    mloc[tid] = m;
  }
  cluster.sync();
  if (tid < MAX_G) {
    float m = -INFINITY;
    for (int r = 0; r < CLUSTER; ++r) m = fmaxf(m, cluster.map_shared_rank(mloc, r)[tid]);
    mg[tid] = fmaxf(m, NEG_HALF);
  }
  __syncthreads();

  // --- p = exp(s - m) as bf16 for the products, l in f32 ---
  for (int h = warp; h < G; h += WARPS) {
    const float m = mg[h];
    float l = 0.f;
    for (int i = lane; i < nt16; i += 32) {
      const float p = expf(sc[h * L.tpcp + i] - m);  // 0 for a masked slot (-inf)
      l += p;
      P[h * L.tpc2 + i] = __bfloat16_as_ushort(__float2bfloat16_rn(p));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    if (lane == 0) lloc[h] = l;
  }
  if (tid >= G && tid < MAX_G) lloc[tid] = 0.f;
  __syncthreads();

  // --- out^T += V^T . p^T, 16 slots a k-step ---
  float acc[MT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  for (int rnd = 0; rnd < rounds; ++rnd) {
    const int r0 = rnd * a.cap;
    const int n = min(a.cap, nt16 - r0);
    if (rnd > 0) {
      __syncthreads();  // every warp is done with the previous round's V
      stage<WPH>(vbuf, a.vp, a.vs, a, b, kh, tok0 + r0, n, b_lo, nbh);
      cp_async_commit();
    }
    cp_async_wait<0>();
    __syncthreads();
    const uint32_t* bw = vbuf;
    const unsigned short* bsc = reinterpret_cast<const unsigned short*>(vbuf + n * WPH);
    for (int tile = warp; tile < n / 16; tile += WARPS) {
      // slots 2t, 2t + 1 (pairs a0/a1) and 2t + 8, 2t + 9 (a2/a3)
      float v[4][FPL];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = tile * 16 + 2 * t + (k & 1) + 8 * (k >> 1);
        const int tok = tok0 + r0 + i;
        const int par = static_cast<int>(((static_cast<long long>(b) * a.S + tok) * a.NB + b_lo) & 1);
        const unsigned short* srow = bsc + i * 2 * a.sw + par;
#pragma unroll
        for (int j = 0; j < NWV; ++j) {
          const uint32_t w = bw[i * WPH + wv0 + j] >> (FPL < CPW ? vshift : 0);
          const float s = bf16_bits(srow[lbv[j]]);
          constexpr int PER = FPL < CPW ? FPL : CPW;
#pragma unroll
          for (int c = 0; c < PER; ++c) v[k][j * PER + c] = lut[(w >> (c * BITS)) & MASK] * s;
        }
      }
      const bool live = g < G;
      const int pi = g * L.tpc2 + r0 + tile * 16 + 2 * t;
      const uint32_t b0 = live ? *reinterpret_cast<const uint32_t*>(P + pi) : 0u;
      const uint32_t b1 = live ? *reinterpret_cast<const uint32_t*>(P + pi + 8) : 0u;
#pragma unroll
      for (int i = 0; i < MT; ++i)
        mma_16816(acc[i], pack_bf16x2(v[0][i], v[1][i]), pack_bf16x2(v[0][MT + i], v[1][MT + i]),
                  pack_bf16x2(v[2][i], v[3][i]), pack_bf16x2(v[2][MT + i], v[3][MT + i]), b0,
                  b1);
    }
  }
  __syncthreads();  // the K buffer becomes the per-warp sums

  // --- sums over the CTA's warps, then over the cluster ---
  float* red = reinterpret_cast<float*>(kbuf);  // [WARPS][MAX_G][DH]
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int f0 = g * FPL + i, f1 = g * FPL + MT + i;
    float* rw = red + warp * MAX_G * DH;
    rw[(2 * t) * DH + f0] = acc[i][0];
    rw[(2 * t + 1) * DH + f0] = acc[i][1];
    rw[(2 * t) * DH + f1] = acc[i][2];
    rw[(2 * t + 1) * DH + f1] = acc[i][3];
  }
  __syncthreads();
  for (int idx = tid; idx < G * DH; idx += THREADS) {
    float s = 0.f;
    for (int w = 0; w < WARPS; ++w) s += red[w * MAX_G * DH + idx];
    pvc[idx] = s;
  }
  cluster.sync();
  for (int idx = rank * THREADS + tid; idx < G * DH; idx += CLUSTER * THREADS) {
    const int h = idx / DH;
    float pv = 0.f, l = 0.f;
    for (int r = 0; r < CLUSTER; ++r) {
      pv += cluster.map_shared_rank(pvc, r)[idx];
      l += cluster.map_shared_rank(lloc, r)[h];
    }
    a.out[(static_cast<long long>(b) * a.H + kh * G) * DH + idx] =
        __bfloat16_as_ushort(__float2bfloat16_rn(pv / fmaxf(l, 1e-30f)));
  }
  cluster.sync();  // no CTA leaves while another reads its shared memory
}

// the most slots a round (a multiple of 16, at most a CTA's share) whose
// layout fits an SM, and the scale words a slot; cudaErrorInvalidValue
// where not even 16 slots fit beside the scores of a CTA's share
template <int BITS, int DH>
int launch(Args a, int B, int K, cudaStream_t stream) {
  using Sh = Shape<BITS, DH>;
  int nbh = 1;  // the scale blocks a head spans, at most
  for (int kh = 0; kh < K; ++kh) {
    const int n = (kh * DH + DH - 1) / a.bs - kh * DH / a.bs + 1;
    nbh = n > nbh ? n : nbh;
  }
  a.sw = (nbh + 2) / 2;  // 4-byte words that hold them from either parity
  a.cap = make_layout(a.S, a.G, DH, Sh::WPH, a.sw, 16).tpc;
  while (a.cap > 16 && make_layout(a.S, a.G, DH, Sh::WPH, a.sw, a.cap).words * 4 > MAX_SMEM)
    a.cap -= 16;
  const Layout L = make_layout(a.S, a.G, DH, Sh::WPH, a.sw, a.cap);
  const size_t bytes = static_cast<size_t>(L.words) * 4;
  if (bytes > static_cast<size_t>(MAX_SMEM)) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  static bool attr[MAX_DEVICES] = {};  // the attribute is per device
  if (dev >= MAX_DEVICES || !attr[dev]) {
    e = cudaFuncSetAttribute(kv_decode_attention_kernel<BITS, DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < MAX_DEVICES) attr[dev] = true;
  }
  kv_decode_attention_kernel<BITS, DH><<<dim3(CLUSTER, K, B), THREADS, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape it does not take: bits other than 4 or
// 8, dh other than 32, 64 or 128, more than 8 query heads a KV head, a row
// of words or scales that does not fit the heads, blocks that split a word,
// or a cache whose scores do not fit the shared memory of an SM (about 39 K
// slots with 7 query heads a KV head at dh 128).  q, out bf16 [B, H, dh];
// k/v packed int32 [B, S, W] and their scales bf16 [B, S, NB], all
// contiguous, the words 16-byte aligned; codebook f32 [2^bits]; pos_arr
// int32 [S].  softcap > 0 caps the scores as cap * tanh(s / cap).
extern "C" int kv_decode_attention(const void* q, const void* kp, const void* ks, const void* vp,
                                   const void* vs, const void* codebook, const void* pos_arr,
                                   void* out, int B, int H, int K, int S, int W, int NB, int bs,
                                   int bits, int dh, int pos, float sm_scale, float softcap,
                                   void* stream) {
  if ((bits != 4 && bits != 8) || (dh != 32 && dh != 64 && dh != 128) || K < 1 || H % K ||
      H / K > MAX_G || S < 1 || B < 1 || B > 65535 || K > 65535 || W * 32 != K * dh * bits ||
      bs < 1 || NB * bs != K * dh || bs % (32 / bits)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.q = static_cast<const unsigned short*>(q);
  a.kp = static_cast<const uint32_t*>(kp);
  a.vp = static_cast<const uint32_t*>(vp);
  a.ks = static_cast<const unsigned short*>(ks);
  a.vs = static_cast<const unsigned short*>(vs);
  a.codebook = static_cast<const float*>(codebook);
  a.pos_arr = static_cast<const int*>(pos_arr);
  a.out = static_cast<unsigned short*>(out);
  a.S = S;
  a.W = W;
  a.NB = NB;
  a.bs = bs;
  a.H = H;
  a.G = H / K;
  a.pos = pos;
  a.sm_scale = sm_scale;
  a.softcap = softcap;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bits * 1000 + dh) {
    case 4032: return launch<4, 32>(a, B, K, st);
    case 4064: return launch<4, 64>(a, B, K, st);
    case 4128: return launch<4, 128>(a, B, K, st);
    case 8032: return launch<8, 32>(a, B, K, st);
    case 8064: return launch<8, 64>(a, B, K, st);
    case 8128: return launch<8, 128>(a, B, K, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
