// Ragged paged attention with the KV-cache write, hand-written for Hopper
// (sm_90a). Plain C interface, loaded with ctypes by
// agentfield_tpu_torch/ops/cuda/ragged_paged_attention.py.
//
// Replaces: agentfield_tpu/ops/pallas/ragged_paged_attention_kernel.py,
// function _ragged_kernel (launched by ragged_paged_attention_pallas, whose
// dense packing dense_causal_attention also lands here), with its int8/fp8
// "quant" branches: pools of int8 or fp8 (e4m3) values with one f32 scale
// per (page, KV head, slot).
//
// What it computes (the TPU kernel's phases, not its grid):
//   A  online-softmax walk over the row's CACHED pool pages, key positions
//      < ctx_lens[r], with sliding-window skipping;
//   B  attention over the launch's own new keys: every row r' with the same
//      seq_id, key position row_starts[r'] + j (j < n_tokens[r']), causal on
//      absolute positions (k_pos <= q_pos), window k_pos > q_pos - window;
//   finalize  acc / max(l, 1e-30): padding rows and padding tokens give 0;
//   C  the new K/V land in pool slot (page_tables[r, pos / ps], pos % ps);
//      tokens past n_tokens or past the page table write nothing.
// Masking follows the TPU kernel: masked logits are -1e30, p = 0 where the
// logit is <= -5e29, l is floored at 1e-30.
//
// Quantized pools (ops/kv_quant.py has the format): phase A dequantizes each
// cached key on load (value * its slot's scale, in f32), phase B reads
// k_new/v_new unquantized (same-launch keys never round-trip the pool).
// Phase C quantizes each written (token, KV head) row with kv_quantize's
// formula, one warp per row: max |x| over hd by shuffles (order-free, so
// exact), scale = max(max * f32(1/QMAX), 1e-20), an IEEE division x / scale
// (__fdiv_rn: the build never sets fast math), then round half to even and
// clamp to +-127 (int8) or a round-to-nearest-even cast to e4m3 (fp8). The
// pool bytes and scales equal kv_quantize's bit for bit.
//
// The card (H100 SXM): 3.35 TB/s HBM, 989 TFLOP/s bf16 on the tensor cores,
// 67 TFLOP/s f32 on the CUDA cores, 132 SMs of 227 KB shared memory. A
// launch takes one of three paths, by the packed query rows of a (row, KV
// head), nq = W * rep (W query tokens, rep = H / Kh heads per KV head):
//
// Path 1, nq > 8 in bf16 (dense, chunked and suffix prefill): a CTA of 4
//   warps holds 64 packed query rows (token w = i / rep, head kvh*rep +
//   i % rep), 16 a warp. Long chunks are bound by the 4 * q * k * hd FLOPs,
//   so the FLOPs go to the tensor cores: mma.sync m16n8k16 bf16 -> f32 fed by
//   ldmatrix (.trans for V), the FlashAttention-2 register layout. Q stays in
//   registers as A fragments; S = Q K^T and O += P V accumulate in f32
//   registers; the online softmax runs in registers with row max and sum
//   over the quad of lanes that share a row. Key/value tiles of 64 keys
//   arrive raw through a 2-stage cp.async ring, rows padded by 16 bytes so
//   that ldmatrix hits no bank conflict; the next tile loads while this one
//   computes, and a tile costs one __syncthreads (two on quantized pools,
//   whose raw tile is first widened to bf16 in shared memory). Q passes
//   through the second ring stage before the ring first needs it, so a CTA
//   holds 70 KB (bf16 pools) and 2 CTAs fit an SM at about 220 registers.
//   mma.sync, not wgmma: wgmma's 64-row warpgroup tile would have to carry
//   the ragged tokens x rep packing and its B operand in shared memory
//   descriptors; a later change can take that step. Numerics: Q and K/V
//   are bf16 and so exact in the MMA; sm_scale (times log2 e: scores are
//   kept in log2 units for exp2f) is applied to S in f32.
//   Quantized pools: int8 values and every e4m3 value convert to bf16
//   exactly, so the MMA runs on the raw values, score column j is scaled by
//   its slot's K scale in f32 and the V scale is folded into P's column j.
//   P goes to the MMA split in two, P_hi = bf16(P) and P_lo = bf16(P -
//   P_hi) (two P V products, relative error about 2^-17 instead of bf16's
//   2^-9): near-zero outputs are held to an absolute 1e-5, which a single
//   rounding of P can exceed. Tiles past the tile's last query are skipped;
//   only tiles that straddle the diagonal, the window edge or ctx are
//   masked element by element.
//
// Path 2, nq <= 8, f32 or bf16 (decode): bound by the bytes of cached pages
//   (ctx * Kh * hd values of K and of V per row, 2 bytes each in bf16, 1 plus
//   a 4-byte scale per slot when quantized). One CTA per (row, KV head) would
//   give 256 CTAs walking 2k keys each for 132 SMs, so the context is split:
//   a CTA takes 256 cached keys of one (row, KV head) (2048 CTAs at 32 rows x
//   8 KV heads x 2k), keeps a cp.async ring of 32-key raw page tiles in
//   flight (4 stages of int8/fp8, 3 of bf16/f32; the split's page ids are
//   read once into shared memory) and converts to f32 in registers at use.
//   A lane holds 8 values of hd for every query row in registers; hd / 8
//   lanes (a power of two of them) share a key and reduce its dot products
//   by shuffles, a warp scores 32 / (hd / 8) keys at once, and a tile's
//   dots are all taken before its one online-softmax step per row, so the
//   shuffles overlap.
//   Query rows past nq are not computed (a 4-row instance serves rep 4
//   decode). Scores are kept in log2 units (exp2f). Each split writes a
//   partial (m, l, acc) in f32 to scratch the wrapper allocates; one more CTA
//   per (row, KV head) runs phase B, and a combine launch merges the
//   partials with the online-softmax recurrence and finalizes. Splits past
//   ctx or before the window's first key, and padding rows, do no work.
//   Phase B packs its tiles densely with the keys of consecutive same-seq_id
//   rows: a mixed tick's prefill chunk arrives as W = 1 rows (one token
//   each), and a tile per row would cost a cp.async round trip and two
//   barriers per key. Each such row still walks its chunk's cached prefix
//   in phase A on its own (ROADMAP B1 e).
//
// Path 3, nq > 8 in f32: the CUDA-core tile of the first port (64 query
//   rows, keys widened to f32 in shared memory). Tensor-core TF32 would not
//   meet the f32 bound, and f32 is not served.
//
// Head dims: one build of this source per head dim (-DAFP_HEAD_DIM=16, 32,
//   64, 96, 128 or 256; ops/cuda/build.py runs the six nvcc processes in
//   parallel). Path 2 gives a key G = hd / 8 lanes rounded up to a power of
//   two (hd 96: 12 live lanes of 16, the other 4 hold zeros) and takes a
//   ring tile of max(32, 4 * 32 / G) keys, so each warp scores at least one
//   step of keys (hd 16: 64-key tiles). Path 1 at hd 256 splits the output
//   dims over two CTAs of 128 each (both compute S = Q K^T over all 256):
//   the f32 O accumulator of 16 rows x 256 would not fit the registers
//   beside Q. Path 3 at hd 256 takes 32 query rows a CTA.
//
// Phase C is a separate launch after the attention on the same stream:
// attention reads only cached positions < ctx <= row_starts, which no token
// of the launch writes, so the final pool bytes equal the TPU kernel's
// copy-then-patch. PERF.md has the measured times.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NT = 128;  // threads per CTA
constexpr int KB = 32;   // path 3: keys per shared-memory block (one per lane)
constexpr float NEG_INF = -1e30f;
constexpr int NO_KEY = 0x7fffffff;  // key-position marker: slot holds no key
constexpr unsigned FULL = 0xffffffffu;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 x) { return (float)x; }  // exact
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round-to-nearest-even, like a torch/jax cast
}

// kv_quantize's per-mode constants: f32(1/QMAX), as jnp/torch multiply an
// f32 tensor by the Python float 1/QMAX, and the scale floor.
template <typename PT> struct Quant;
template <> struct Quant<int8_t> {
  static constexpr float inv_qmax = (float)(1.0 / 127.0);
  static __device__ __forceinline__ int8_t cast(float y) {
    return (int8_t)fminf(fmaxf(rintf(y), -127.f), 127.f);  // rintf: half to even
  }
};
template <> struct Quant<__nv_fp8_e4m3> {
  static constexpr float inv_qmax = (float)(1.0 / 448.0);
  static __device__ __forceinline__ __nv_fp8_e4m3 cast(float y) {
    return __nv_fp8_e4m3(y);  // round to nearest even (|y| <= 448 here)
  }
};
constexpr float SCALE_FLOOR = 1e-20f;

struct Args {
  const void* q;       // [R, W, H, HD]
  const void* k_new;   // [R, W, Kh, HD]
  const void* v_new;
  void* k_pages;       // [P, Kh, ps, HD], T or (quantized) int8 / fp8
  void* v_pages;
  float* k_scales;     // [P, Kh, ps] per-slot scales; null for plain pools
  float* v_scales;
  void* out;           // [R, W, H, HD]
  const int* page_tables;  // [R, maxp]
  const int* row_starts;   // [R]
  const int* n_tokens;
  const int* ctx_lens;
  const int* seq_ids;
  float* part;         // path 2: [R, Kh, nsplit + 1] partials (decode_part_floats)
  int R, W, H, Kh, ps, maxp;
  float sm_scale;
  int window;    // 0 = no sliding window
  int ps_shift;  // log2(ps) when ps is a power of two, else -1
};

// Pool row (page, KV head, slot) of cached key position kp, through the
// page id of kp's page (kp / ps): one shift when ps is a power of two.
__device__ __forceinline__ int page_index(const Args& a, int kp) {
  return a.ps_shift >= 0 ? kp >> a.ps_shift : kp / a.ps;
}
__device__ __forceinline__ long long pool_row(const Args& a, int page, int kvh, int kp) {
  const int slot = a.ps_shift >= 0 ? kp & (a.ps - 1) : kp % a.ps;
  return ((long long)page * a.Kh + kvh) * a.ps + slot;
}

// ---------------------------------------------------------------------------
// cp.async (sm_80+) with zero fill: src_size 0 writes zeros and reads nothing.

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Eight consecutive values as f32 (16-byte aligned for 2-byte types, 8-byte
// for 1-byte types, 32 bytes for f32).
__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}
__device__ __forceinline__ void load8(const bf16* p, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 x = __bfloat1622float2(h[k]);
    f[2 * k] = x.x;
    f[2 * k + 1] = x.y;
  }
}
template <typename PT>
__device__ __forceinline__ void load8_byte(const PT* p, float* f) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const PT* c = reinterpret_cast<const PT*>(&u);
#pragma unroll
  for (int e = 0; e < 8; ++e) f[e] = to_f32(c[e]);
}
__device__ __forceinline__ void load8(const int8_t* p, float* f) { load8_byte(p, f); }
__device__ __forceinline__ void load8(const __nv_fp8_e4m3* p, float* f) { load8_byte(p, f); }

// ---------------------------------------------------------------------------
// Path 2: split-context decode.

constexpr int DEC_NQ = 8;       // most packed query rows of a decode (row, KV head)
constexpr int DEC_SPLIT = 256;  // cached keys per split CTA
constexpr int VEC = 8;          // hd values a lane holds per query row
constexpr float LOG2E = 1.4426950408889634f;  // scores are kept in log2 units: exp2f

__host__ __device__ constexpr int pow2_at_least(int n) { return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2); }

// Path 2's lane layout for head dim HD: GL = HD / VEC lanes hold a key's
// values, G (GL rounded up to a power of two) lanes share the key, a warp
// scores KPW keys at once, a ring tile holds TK keys (at least one step of
// KPW keys for each of the 4 warps), and a warp takes STEPS steps of a tile.
template <int HD>
struct DecGeom {
  static_assert(HD % VEC == 0 && HD / VEC <= 32, "head_dim must be 8 * (1..32)");
  static constexpr int GL = HD / VEC;
  static constexpr int G = pow2_at_least(GL);
  static constexpr int KPW = 32 / G;
  static constexpr int TK = 4 * KPW > 32 ? 4 * KPW : 32;
  static constexpr int STEPS = TK / 4 / KPW;
};

__host__ __device__ constexpr int decode_nsplit(int ps, int maxp) {
  return (ps * maxp + DEC_SPLIT - 1) / DEC_SPLIT;
}
// f32 values of one partial: m[DEC_NQ] (log2 units), l[DEC_NQ], acc[DEC_NQ][hd]
__host__ __device__ constexpr int decode_part_floats(int hd) { return DEC_NQ * (2 + hd); }

// One tile of keys for one warp: STEPS steps of KPW = 32 / G keys, key j =
// j0 + step * KPW at position kpos0 + j, a key only for jlo <= j < jhi; with
// KPOS the positions come from kpos[j] instead (NO_KEY: no key), for a tile
// packed from several rows (phase B). The
// G = hd / VEC lanes of a group hold one key's values and reduce its dot
// products by shuffles; every dot of the tile is taken before the softmax,
// so the shuffles of all keys and rows overlap. The running max m is shared
// by the warp's groups; l and acc are per group until the final merge.
// Rows from nq on are skipped; ALL_ROWS (nq == NQ) drops those checks.
template <int G, int GL, int STEPS, int NQ, int HD, bool SCALED, bool ALL_ROWS, bool KPOS,
          typename S>
__device__ __forceinline__ void decode_tile(const S* kt, const S* vt, const float* ksc,
                                            const float* vsc, const int* kpos, int j0, int kpos0,
                                            int jlo, int jhi, bool causal, int nq, int window,
                                            const int* qp, int gl, float (&q)[NQ][VEC],
                                            float (&acc)[NQ][VEC], float (&m)[NQ],
                                            float (&l)[NQ]) {
  constexpr int KPW = 32 / G;
  const bool live = GL == G || gl < GL;  // lanes past GL hold zeros
  float sc[STEPS][NQ];
#pragma unroll
  for (int st = 0; st < STEPS; ++st) {
    float kf[VEC] = {};
    if (live) load8(kt + (j0 + st * KPW) * HD + gl * VEC, kf);
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      if (!ALL_ROWS && i >= nq) continue;  // nq is uniform over the CTA
      float d0 = 0.f, d1 = 0.f;
#pragma unroll
      for (int e = 0; e < VEC; e += 2) {
        d0 = fmaf(q[i][e], kf[e], d0);
        d1 = fmaf(q[i][e + 1], kf[e + 1], d1);
      }
      sc[st][i] = d0 + d1;
    }
  }
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1)
#pragma unroll
    for (int st = 0; st < STEPS; ++st)
#pragma unroll
      for (int i = 0; i < NQ; ++i)
        if (i < nq) sc[st][i] += __shfl_xor_sync(FULL, sc[st][i], o);
  float tmax[NQ];
#pragma unroll
  for (int i = 0; i < NQ; ++i) tmax[i] = NEG_INF;
#pragma unroll
  for (int st = 0; st < STEPS; ++st) {
    const int j = j0 + st * KPW;
    const int kp = KPOS ? kpos[j] : kpos0 + j;
    const bool valid = KPOS ? kp != NO_KEY : j >= jlo && j < jhi;
    float ks = 1.f;
    if constexpr (SCALED) ks = ksc[j];
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      if (!ALL_ROWS && i >= nq) continue;
      const bool keep = valid && (!causal || kp <= qp[i]) && (window == 0 || kp > qp[i] - window);
      const float x = keep ? sc[st][i] * ks : NEG_INF;
      sc[st][i] = x;
      tmax[i] = fmaxf(tmax[i], x);
    }
  }
#pragma unroll
  for (int o = G; o < 32; o <<= 1)
#pragma unroll
    for (int i = 0; i < NQ; ++i)
      if (i < nq) tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(FULL, tmax[i], o));
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    if (!ALL_ROWS && i >= nq) continue;
    const float m_new = fmaxf(m[i], tmax[i]);
    const float alpha = exp2f(m[i] - m_new);
    m[i] = m_new;
    l[i] *= alpha;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[i][e] *= alpha;
  }
#pragma unroll
  for (int st = 0; st < STEPS; ++st) {
    const int j = j0 + st * KPW;
    float vf[VEC] = {};
    if (live) load8(vt + j * HD + gl * VEC, vf);
    float vs = 1.f;
    if constexpr (SCALED) vs = vsc[j];
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      if (!ALL_ROWS && i >= nq) continue;
      const float p = (sc[st][i] <= NEG_INF / 2) ? 0.f : exp2f(sc[st][i] - m[i]);
      l[i] += p;
      const float pv = SCALED ? p * vs : p;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[i][e] = fmaf(pv, vf[e], acc[i][e]);
    }
  }
}

template <typename T, typename PT, int HD>
struct DecodeSmem {
  static constexpr int TK = DecGeom<HD>::TK;
  static constexpr int stages = sizeof(PT) == 1 ? 4 : 3;  // raw tiles in flight
  static constexpr int ring_tile = TK * HD * (int)sizeof(PT);  // bytes of one K or V tile
  static constexpr int stage = 2 * ring_tile + 2 * TK * 4;      // K, V, k/v scales
  static constexpr int ring = stages * stage;
  static constexpr int newkeys = 2 * TK * HD * (int)sizeof(T);  // phase B: K, V
  static constexpr int merge = 4 * DEC_NQ * (HD + 2) * 4;           // per-warp partials
  static constexpr int a_ = ring > newkeys ? ring : newkeys;
  static constexpr size_t bytes = a_ > merge ? a_ : merge;
};

// grid (R, Kh, nsplit + 1): z < nsplit is the split of cached keys
// [z * DEC_SPLIT, (z + 1) * DEC_SPLIT) of phase A; z == nsplit runs phase B.
// NQ (4 or 8) bounds the live query rows nq = min(W, n_tokens) * rep.
// bf16 with at most 4 query rows (the served shape): registers capped for 4
// CTAs an SM (16 warps in flight), which ran faster than 3 without the cap;
// not at hd 256, whose ring leaves room for 2 CTAs an SM
template <typename T, typename PT, int HD, int NQ>
__global__ void __launch_bounds__(NT, (NQ <= 4 && sizeof(T) == 2 && HD <= 128) ? 4 : 1)
    decode_split_kernel(Args a) {
  constexpr bool QUANT = !std::is_same<T, PT>::value;
  using D = DecGeom<HD>;
  constexpr int G = D::G, GL = D::GL;   // lanes per key; of them, lanes with values
  constexpr int TK = D::TK;             // keys per ring tile
  constexpr int STEPS = D::STEPS;       // a warp takes a quarter of each tile
  static_assert(TK % (4 * D::KPW) == 0, "tile must split over the warps");
  using L = DecodeSmem<T, PT, HD>;
  constexpr int STAGES = L::stages;
  extern __shared__ __align__(16) unsigned char dsmem[];
  __shared__ int pg_s[DEC_SPLIT + 2];  // page ids of this split's keys

  const int r = blockIdx.x, kvh = blockIdx.y, sp = blockIdx.z;
  const int nsplit = gridDim.z - 1;
  const int ntok = a.n_tokens[r];
  if (ntok <= 0) return;  // padding row: the combine writes its zeros
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane / G, gl = lane % G;
  const int rep = a.H / a.Kh, W = a.W, Kh = a.Kh, ps = a.ps;
  const int nq = min(W, ntok) * rep;  // live query rows
  const int start = a.row_starts[r], window = a.window;
  const int qpos_hi = start + min(W, ntok) - 1;
  const int ctx_eff = min(a.ctx_lens[r], a.maxp * ps);  // keys past the table are no keys
  const int k_lo = window > 0 ? max(0, start - window + 1) : 0;

  int lo = 0, hi = 0;
  if (sp < nsplit) {  // phase A split: keys [lo, hi)
    lo = max(sp * DEC_SPLIT, k_lo);
    hi = min((sp + 1) * DEC_SPLIT, ctx_eff);
    if (lo >= hi) return;  // nothing cached here: the combine skips this split
  }

  // query rows in registers, times sm_scale and log2(e)
  const T* qg = reinterpret_cast<const T*>(a.q);
  const float qscale = a.sm_scale * LOG2E;
  float q[NQ][VEC], acc[NQ][VEC], m[NQ], l[NQ];
  int qp[NQ];
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    qp[i] = start + i / rep;
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[i][e] = 0.f;
    if (i < nq && gl < GL) {
      const int w = i / rep, h = kvh * rep + i % rep;
      load8(qg + (((long long)r * W + w) * a.H + h) * HD + gl * VEC, q[i]);
#pragma unroll
      for (int e = 0; e < VEC; ++e) q[i][e] *= qscale;
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) q[i][e] = 0.f;
    }
  }
  const int j0 = warp * (TK / 4) + grp;  // this lane group's first key of a tile
  const bool all_rows = nq == NQ;  // rows fill the instance: skip the row checks

  if (sp < nsplit) {
    // --- phase A: a STAGES-deep ring of raw page tiles
    const PT* kpool = reinterpret_cast<const PT*>(a.k_pages);
    const PT* vpool = reinterpret_cast<const PT*>(a.v_pages);
    const int base = lo & ~(TK - 1);
    const int n_tiles = (hi - base + TK - 1) / TK;
    const int page0 = page_index(a, base);
    for (int k = tid; k <= page_index(a, hi - 1) - page0; k += NT)
      pg_s[k] = a.page_tables[(long long)r * a.maxp + page0 + k];
    __syncthreads();
    constexpr int CPR = HD * (int)sizeof(PT) / 16;  // 16-byte pieces per key row
    constexpr int CHUNKS = TK * CPR;                 // pieces of a K (or V) tile
    auto load_tile = [&](int t, int stage) {
      unsigned char* st = dsmem + stage * L::stage;
#pragma unroll
      for (int k = 0; k < (CHUNKS + NT - 1) / NT; ++k) {
        const int c = tid + k * NT;
        if (CHUNKS % NT == 0 || c < CHUNKS) {
          const int j = c / CPR, piece = c % CPR;
          const int kp = base + t * TK + j;
          const bool ok = kp >= lo && kp < hi;
          const long long src =
              ok ? pool_row(a, pg_s[page_index(a, kp) - page0], kvh, kp) * HD : 0;
          const int dst = j * HD * (int)sizeof(PT) + piece * 16;
          const int off = piece * (16 / (int)sizeof(PT));
          cp16(st + dst, kpool + src + off, ok);
          cp16(st + L::ring_tile + dst, vpool + src + off, ok);
        }
      }
      if constexpr (QUANT) {
        if (tid < TK) {
          const int kp = base + t * TK + tid;
          const bool ok = kp >= lo && kp < hi;
          const long long row = ok ? pool_row(a, pg_s[page_index(a, kp) - page0], kvh, kp) : 0;
          float* sc = reinterpret_cast<float*>(st + 2 * L::ring_tile) + tid;
          cp4(sc, a.k_scales + row, ok);
          cp4(sc + TK, a.v_scales + row, ok);
        }
      }
    };
#pragma unroll
    for (int t = 0; t < STAGES - 1; ++t) {
      if (t < n_tiles) load_tile(t, t);
      cp_commit();
    }
    for (int t = 0; t < n_tiles; ++t) {
      cp_wait<STAGES - 2>();  // tile t has landed (this thread's copies)
      __syncthreads();        // ... everyone's; tile t - 1 fully consumed
      if (t + STAGES - 1 < n_tiles) load_tile(t + STAGES - 1, (t + STAGES - 1) % STAGES);
      cp_commit();
      const unsigned char* st = dsmem + (t % STAGES) * L::stage;
      const float* ksc = reinterpret_cast<const float*>(st + 2 * L::ring_tile);
      const int kpos0 = base + t * TK;
      const PT* kt = reinterpret_cast<const PT*>(st);
      const PT* vt = reinterpret_cast<const PT*>(st + L::ring_tile);
      if (all_rows)
        decode_tile<G, GL, STEPS, NQ, HD, QUANT, true, false>(kt, vt, ksc, ksc + TK, nullptr, j0,
                                                              kpos0, lo - kpos0, hi - kpos0, false,
                                                              nq, window, qp, gl, q, acc, m, l);
      else
        decode_tile<G, GL, STEPS, NQ, HD, QUANT, false, false>(kt, vt, ksc, ksc + TK, nullptr, j0,
                                                               kpos0, lo - kpos0, hi - kpos0, false,
                                                               nq, window, qp, gl, q, acc, m, l);
    }
    cp_wait<0>();
  } else {
    // --- phase B: the launch's new keys of this sequence, causal. Tiles are
    // packed densely with the keys of consecutive same-seq_id rows (a row's
    // keys never straddle two tiles: n_tokens <= W <= 8 < TK), so the W = 1
    // rows of a mixed tick's chunk cost one tile round trip per TK keys, not
    // one per row. Warp 0 scans 32 rows at a time: each lane counts its
    // row's keys that some query of this row can see (positions up to
    // qpos_hi, and past start - window with a window), a prefix sum places
    // them, and the scan stops at the first row that no longer fits.
    const T* kn = reinterpret_cast<const T*>(a.k_new);
    const T* vn = reinterpret_cast<const T*>(a.v_new);
    const int my_seq = a.seq_ids[r];
    T* kt = reinterpret_cast<T*>(dsmem);
    T* vt = kt + TK * HD;
    int* kpos_s = pg_s;            // key positions of the tile (NO_KEY: empty)
    int* ksrc_s = pg_s + TK;       // their token index r2 * W + j in k_new / v_new
    int* scan_s = pg_s + 2 * TK;   // keys in the tile, first row of the next scan
    static_assert(2 * TK + 2 <= DEC_SPLIT + 2, "phase B's tile index fits pg_s");
    constexpr int CPR = HD * (int)sizeof(T) / 16;
    const int klo = window > 0 ? start - window + 1 : 0;  // first key any query sees
    int row0 = 0;
    for (;;) {
      __syncthreads();  // the previous tile (and its index) is consumed
      if (warp == 0) {
        int fill = 0, rr = row0;
        while (rr < a.R && fill < TK) {
          const int r2 = rr + lane;
          int cnt = 0, jlo = 0, st2 = 0;
          if (r2 < a.R) {
            const int n2 = a.n_tokens[r2];
            if (n2 > 0 && a.seq_ids[r2] == my_seq) {
              st2 = a.row_starts[r2];
              jlo = max(0, klo - st2);
              cnt = max(0, min(n2, qpos_hi - st2 + 1) - jlo);
            }
          }
          int incl = cnt;
#pragma unroll
          for (int o = 1; o < 32; o <<= 1) {
            const int y = __shfl_up_sync(FULL, incl, o);
            if (lane >= o) incl += y;
          }
          const bool fits = fill + incl <= TK;  // true on a prefix of the lanes
          if (fits)
            for (int j = 0; j < cnt; ++j) {
              kpos_s[fill + incl - cnt + j] = st2 + jlo + j;
              ksrc_s[fill + incl - cnt + j] = r2 * W + jlo + j;
            }
          const int nfit = __popc(__ballot_sync(FULL, fits));
          fill += nfit > 0 ? __shfl_sync(FULL, incl, nfit - 1) : 0;
          rr += nfit;
          if (nfit < 32) break;  // a row did not fit: the tile is full
        }
        for (int j = fill + lane; j < TK; j += 32) kpos_s[j] = NO_KEY;
        if (lane == 0) {
          scan_s[0] = fill;
          scan_s[1] = rr;
        }
      }
      __syncthreads();
      const int fill = scan_s[0];
      if (fill == 0) break;  // no key left to attend
      row0 = scan_s[1];
      for (int c = tid; c < 2 * TK * CPR; c += NT) {
        const int kv = c / (TK * CPR), rem = c % (TK * CPR);
        const int j = rem / CPR, piece = rem % CPR;
        const bool ok = j < fill;
        const long long src = ok ? ((long long)ksrc_s[j] * Kh + kvh) * HD : 0;
        cp16((kv ? vt : kt) + j * HD + piece * (16 / (int)sizeof(T)),
             (kv ? vn : kn) + src + piece * (16 / (int)sizeof(T)), ok);
      }
      cp_commit();
      cp_wait<0>();
      __syncthreads();
      if (all_rows)
        decode_tile<G, GL, STEPS, NQ, HD, false, true, true>(kt, vt, nullptr, nullptr, kpos_s, j0,
                                                             0, 0, 0, true, nq, window, qp, gl, q,
                                                             acc, m, l);
      else
        decode_tile<G, GL, STEPS, NQ, HD, false, false, true>(kt, vt, nullptr, nullptr, kpos_s, j0,
                                                              0, 0, 0, true, nq, window, qp, gl, q,
                                                              acc, m, l);
      if (row0 >= a.R) break;  // every row was scanned
    }
  }

  // --- merge the key groups of each warp, then the four warps, into one
  // partial (m, l, acc) of this split
#pragma unroll
  for (int o = G; o < 32; o <<= 1) {
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      if (i < nq) {
        const float mo = __shfl_xor_sync(FULL, m[i], o);
        const float lo_ = __shfl_xor_sync(FULL, l[i], o);
        const float mx = fmaxf(m[i], mo);
        const float a1 = exp2f(m[i] - mx), a2 = exp2f(mo - mx);
        l[i] = l[i] * a1 + lo_ * a2;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float ao = __shfl_xor_sync(FULL, acc[i][e], o);
          acc[i][e] = acc[i][e] * a1 + ao * a2;
        }
        m[i] = mx;
      }
    }
  }
  __syncthreads();  // the ring (aliased by the merge buffer) is consumed
  float* mb = reinterpret_cast<float*>(dsmem);  // [4][DEC_NQ][HD + 2]
  if (grp == 0 && gl < GL) {
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      if (i < nq) {
        float* row = mb + (warp * DEC_NQ + i) * (HD + 2);
#pragma unroll
        for (int e = 0; e < VEC; ++e) row[gl * VEC + e] = acc[i][e];
        if (gl == 0) {
          row[HD] = m[i];
          row[HD + 1] = l[i];
        }
      }
    }
  }
  __syncthreads();
  float* part = a.part + (((long long)r * Kh + kvh) * (nsplit + 1) + sp) * decode_part_floats(HD);
  for (int e = tid; e < nq * HD; e += NT) {
    const int i = e / HD, d = e % HD;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < 4; ++w) mx = fmaxf(mx, mb[(w * DEC_NQ + i) * (HD + 2) + HD]);
    float lsum = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float* row = mb + (w * DEC_NQ + i) * (HD + 2);
      const float sc = exp2f(row[HD] - mx);
      lsum += row[HD + 1] * sc;
      o += row[d] * sc;
    }
    part[2 * DEC_NQ + i * HD + d] = o;
    if (d == 0) {
      part[i] = mx;
      part[DEC_NQ + i] = lsum;
    }
  }
}

// Merge the partials of every split that held keys, and phase B's, then
// finalize: out = acc / max(l, 1e-30). grid (R, Kh). Mirrors the split
// choice of decode_split_kernel; ops/paged_attention.py has its plain
// version (merge_partials_ref, there with m in natural-log units).
template <typename T>
__global__ void __launch_bounds__(NT) decode_combine_kernel(Args a, int hd) {
  const int r = blockIdx.x, kvh = blockIdx.y;
  const int nsplit = decode_nsplit(a.ps, a.maxp);
  const int rep = a.H / a.Kh, W = a.W;
  const int ntok = a.n_tokens[r];
  const int nq = ntok > 0 ? min(W, ntok) * rep : 0;
  T* out = reinterpret_cast<T*>(a.out);
  int s_lo = 0, s_hi = 0;  // splits of phase A that held keys
  if (nq > 0) {
    const int start = a.row_starts[r];
    const int ctx_eff = min(a.ctx_lens[r], a.maxp * a.ps);
    const int k_lo = a.window > 0 ? max(0, start - a.window + 1) : 0;
    if (k_lo < ctx_eff) {
      s_lo = k_lo / DEC_SPLIT;
      s_hi = (ctx_eff + DEC_SPLIT - 1) / DEC_SPLIT;
    }
  }
  const int pf = decode_part_floats(hd);
  const float* part = a.part + ((long long)r * a.Kh + kvh) * (nsplit + 1) * pf;
  const float* pb = part + (long long)nsplit * pf;  // phase B
  for (int e = threadIdx.x; e < W * rep * hd; e += blockDim.x) {
    const int i = e / hd, d = e % hd;
    const int w = i / rep, h = kvh * rep + i % rep;
    float res = 0.f;  // padding rows and tokens
    if (i < nq) {
      float mx = pb[i];
      for (int s = s_lo; s < s_hi; ++s) mx = fmaxf(mx, part[(long long)s * pf + i]);
      float sc = exp2f(pb[i] - mx);
      float lsum = pb[DEC_NQ + i] * sc, o = pb[2 * DEC_NQ + i * hd + d] * sc;
      for (int s = s_lo; s < s_hi; ++s) {
        const float* p = part + (long long)s * pf;
        sc = exp2f(p[i] - mx);
        lsum += p[DEC_NQ + i] * sc;
        o += p[2 * DEC_NQ + i * hd + d] * sc;
      }
      res = o / fmaxf(lsum, 1e-30f);
    }
    out[(((long long)r * W + w) * a.H + h) * hd + d] = from_f32<T>(res);
  }
}

// ---------------------------------------------------------------------------
// Path 1: 64 packed query rows on bf16 tensor cores.

constexpr int TC_QT = 64;  // packed query rows per CTA, 16 per warp
constexpr int TC_KT = 64;  // keys per tile
constexpr int TC_STAGES = 2;

__device__ __forceinline__ void ldsm_x4(unsigned& r0, unsigned& r1, unsigned& r2, unsigned& r3,
                                        const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned& r0, unsigned& r1, unsigned& r2,
                                          unsigned& r3, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_u32(p)));
}
// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const unsigned*>(&v);
}

// Output dims a path-1 CTA accumulates: all of hd up to 128; hd 256 splits
// over two CTAs (grid z = query tiles x halves).
template <int HD>
struct TcGeom {
  static constexpr int DV = HD > 128 ? 128 : HD;
  static constexpr int NH = HD / DV;
};

template <typename PT, int HD>
struct TcSmem {
  static constexpr bool QUANT = !std::is_same<PT, bf16>::value;
  static constexpr int PITCH = HD + 8;  // bf16 per row: +16 bytes, ldmatrix conflict-free
  static constexpr int RAW_PITCH = HD + 16;  // bytes per raw int8/fp8 row
  static constexpr int tile = TC_KT * PITCH * 2;  // bytes of one bf16 K or V tile
  static constexpr int stage = 2 * tile + 2 * TC_KT * 4;  // K, V, k/v scales
  // Q passes through the last ring stage on its way to registers, before
  // the ring first fills it; quantized pools add a bf16 copy of a raw tile
  static_assert(TC_QT * PITCH * 2 <= stage, "Q tile must fit a ring stage");
  static constexpr int conv_bytes = QUANT ? 2 * tile : 0;
  static constexpr size_t bytes = (size_t)TC_STAGES * stage + conv_bytes;
};

// One key tile: phase A (cached keys at positions pos + j) or phase B (row
// r2's new keys jb + j at positions pos + j). Keys j outside [jlo, jhi) are
// no keys (zero-filled, masked).
struct TcTile {
  int kind;  // 0 = A, 1 = B, -1 = none
  int pos, r2, jb, jlo, jhi;
};

// The tile sequence of a CTA: phase A over [k_lo, ctx_eff) in TC_KT steps,
// then every same-seq row's new keys up to the tile's last query, skipping
// tiles wholly before the window. Every thread walks it identically.
struct TcIter {
  int phase, kb, r2, jb;
  __device__ bool next(const Args& a, int my_seq, int k_lo, int ctx_eff, int qpos_lo,
                       int qpos_hi, TcTile& d) {
    if (phase == 0) {
      if (kb < ctx_eff) {
        d = {0, kb, 0, 0, max(0, k_lo - kb), min(TC_KT, ctx_eff - kb)};
        kb += TC_KT;
        return true;
      }
      phase = 1;
      r2 = 0;
      jb = 0;
    }
    while (phase == 1 && r2 < a.R) {
      const int n2 = a.n_tokens[r2];
      if (n2 > 0 && a.seq_ids[r2] == my_seq) {
        const int st2 = a.row_starts[r2];
        while (jb < n2 && st2 + jb <= qpos_hi) {
          const int j0 = jb;
          jb += TC_KT;
          if (a.window > 0 && st2 + j0 + TC_KT - 1 <= qpos_lo - a.window) continue;
          d = {1, st2 + j0, r2, j0, 0, min(TC_KT, n2 - j0)};
          return true;
        }
      }
      ++r2;
      jb = 0;
    }
    phase = 2;
    return false;
  }
};

template <typename PT, int HD>
__global__ void __launch_bounds__(NT) tc_tile_kernel(Args a) {
  using L = TcSmem<PT, HD>;
  constexpr bool QUANT = L::QUANT;
  constexpr int PITCH = L::PITCH;
  constexpr int KS = HD / 16;  // k-steps of S = Q K^T
  constexpr int DV = TcGeom<HD>::DV, NH = TcGeom<HD>::NH;
  constexpr int DT = DV / 8;   // 8-wide dim tiles of this CTA's O
  extern __shared__ __align__(16) unsigned char tsmem[];
  __shared__ TcTile desc[TC_STAGES];

  const int r = blockIdx.x, kvh = blockIdx.y, i0 = (blockIdx.z / NH) * TC_QT;
  const int d0 = (blockIdx.z % NH) * DV;  // this CTA's output dims [d0, d0 + DV)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int W = a.W, H = a.H, Kh = a.Kh, ps = a.ps;
  const int rep = H / Kh;
  const int nq = W * rep;
  const int rows = min(TC_QT, nq - i0);
  const int start = a.row_starts[r], ntok = a.n_tokens[r];
  const int my_seq = a.seq_ids[r], window = a.window;
  const bf16* qg = reinterpret_cast<const bf16*>(a.q);
  bf16* out = reinterpret_cast<bf16*>(a.out);
  auto qoff = [&](int i) -> long long {  // packed row i of the tile
    const int gi = i0 + i, w = gi / rep, h = kvh * rep + gi % rep;
    return (((long long)r * W + w) * H + h) * HD;
  };
  const int w_lo = i0 / rep;
  const int w_hi = min((i0 + rows - 1) / rep, ntok - 1);
  if (w_lo > w_hi) {  // padding row / all-padding tile: zeros, nothing to read
    for (int e = tid; e < rows * DV; e += NT)
      out[qoff(e / DV) + d0 + e % DV] = __float2bfloat16(0.f);
    return;
  }
  const int qpos_lo = start + w_lo, qpos_hi = start + w_hi;
  const int ctx_eff = min(a.ctx_lens[r], a.maxp * ps);
  const int k_lo = window > 0 ? max(0, qpos_lo - window + 1) : 0;
  const float qscale = a.sm_scale * LOG2E;

  unsigned char* conv = tsmem + TC_STAGES * L::stage;  // quantized pools' bf16 tile
  unsigned char* q_stage = tsmem + (TC_STAGES - 1) * L::stage;
  // --- Q tile into registers (A fragments), rows past the tile zero
  {
    bf16* qs = reinterpret_cast<bf16*>(q_stage);
    for (int c = tid; c < TC_QT * (HD / 8); c += NT) {
      const int i = c / (HD / 8), piece = c % (HD / 8);
      const bool ok = i < rows;
      cp16(qs + i * PITCH + piece * 8, qg + (ok ? qoff(i) : 0) + piece * 8, ok);
    }
    cp_commit();
  }
  cp_wait<0>();
  __syncthreads();
  unsigned qa[KS][4];
  {
    const bf16* qs = reinterpret_cast<const bf16*>(q_stage);
    const int row = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      ldsm_x4(qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3],
              qs + row * PITCH + kk * 16 + (lane >> 4) * 8);
  }
  __syncthreads();  // Q is in registers: its stage is free for the ring

  // this thread's two rows of the warp's 16: g and g + 8
  const int g = lane >> 2, tq = lane & 3;
  int qp[2];
  bool live[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gi = i0 + warp * 16 + g + 8 * h;
    qp[h] = start + gi / rep;
    live[h] = gi < nq && gi / rep < ntok;
  }
  float o[DT][4], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;

  const PT* kpool = reinterpret_cast<const PT*>(a.k_pages);
  const PT* vpool = reinterpret_cast<const PT*>(a.v_pages);
  const bf16* kn = reinterpret_cast<const bf16*>(a.k_new);
  const bf16* vn = reinterpret_cast<const bf16*>(a.v_new);

  auto load_tile = [&](const TcTile& d, int stage) {
    unsigned char* st = tsmem + stage * L::stage;
    if (tid == 0) desc[stage] = d;
    if (d.kind < 0) return;
    if (d.kind == 0) {
      constexpr int CPR = HD * (int)sizeof(PT) / 16;
      constexpr int CHUNKS = TC_KT * CPR;
      constexpr int RP = QUANT ? L::RAW_PITCH : PITCH * 2;  // bytes per smem row
#pragma unroll
      for (int k = 0; k < (CHUNKS + NT - 1) / NT; ++k) {
        const int c = tid + k * NT;
        if (CHUNKS % NT == 0 || c < CHUNKS) {
          const int j = c / CPR, piece = c % CPR;
          const int kp = d.pos + j;
          const bool ok = j >= d.jlo && j < d.jhi;
          const long long src =
              ok ? pool_row(a, a.page_tables[(long long)r * a.maxp + page_index(a, kp)], kvh, kp) *
                       HD
                 : 0;
          const int off = piece * (16 / (int)sizeof(PT));
          cp16(st + j * RP + piece * 16, kpool + src + off, ok);
          cp16(st + L::tile + j * RP + piece * 16, vpool + src + off, ok);
        }
      }
      if constexpr (QUANT) {
        if (tid < TC_KT) {
          const int kp = d.pos + tid;
          const bool ok = tid >= d.jlo && tid < d.jhi;
          const long long row =
              ok ? pool_row(a, a.page_tables[(long long)r * a.maxp + page_index(a, kp)], kvh, kp)
                 : 0;
          float* sc = reinterpret_cast<float*>(st + 2 * L::tile) + tid;
          cp4(sc, a.k_scales + row, ok);
          cp4(sc + TC_KT, a.v_scales + row, ok);
        }
      }
    } else {
      constexpr int CHUNKS = TC_KT * (HD / 8);
#pragma unroll
      for (int k = 0; k < (CHUNKS + NT - 1) / NT; ++k) {
        const int c = tid + k * NT;
        if (CHUNKS % NT == 0 || c < CHUNKS) {
          const int j = c / (HD / 8), piece = c % (HD / 8);
          const bool ok = j < d.jhi;
          const long long src = ok ? (((long long)d.r2 * W + d.jb + j) * Kh + kvh) * HD : 0;
          const int dst = (j * PITCH + piece * 8) * 2;
          cp16(st + dst, kn + src + piece * 8, ok);
          cp16(st + L::tile + dst, vn + src + piece * 8, ok);
        }
      }
    }
  };

  TcIter it{0, (k_lo / TC_KT) * TC_KT, 0, 0};
  if (k_lo >= ctx_eff) it.phase = 1;  // nothing cached in reach
#pragma unroll
  for (int s = 0; s < TC_STAGES - 1; ++s) {
    TcTile d{-1, 0, 0, 0, 0, 0};
    it.next(a, my_seq, k_lo, ctx_eff, qpos_lo, qpos_hi, d);
    load_tile(d, s);
    cp_commit();
  }
  for (int t = 0;; ++t) {
    const int stage = t % TC_STAGES;
    cp_wait<TC_STAGES - 2>();
    __syncthreads();  // tile t landed everywhere; tile t - 1 fully consumed
    const TcTile d = desc[stage];
    if (d.kind < 0) break;
    {
      TcTile nx{-1, 0, 0, 0, 0, 0};
      it.next(a, my_seq, k_lo, ctx_eff, qpos_lo, qpos_hi, nx);
      load_tile(nx, (t + TC_STAGES - 1) % TC_STAGES);
      cp_commit();
    }
    unsigned char* st = tsmem + stage * L::stage;
    const bf16* kt = reinterpret_cast<const bf16*>(st);
    const bf16* vt = reinterpret_cast<const bf16*>(st + L::tile);
    const float* ksc = reinterpret_cast<const float*>(st + 2 * L::tile);
    const bool scaled = QUANT && d.kind == 0;
    if constexpr (QUANT) {
      if (d.kind == 0) {  // raw int8/fp8 -> bf16, exact
        bf16* ck = reinterpret_cast<bf16*>(conv);
        for (int c = tid; c < 2 * TC_KT * (HD / 8); c += NT) {
          const int kv = c / (TC_KT * (HD / 8)), rem = c % (TC_KT * (HD / 8));
          const int j = rem / (HD / 8), piece = rem % (HD / 8);
          float f[8];
          load8(reinterpret_cast<const PT*>(st + kv * L::tile + j * L::RAW_PITCH) + piece * 8, f);
          uint4 u;
          u.x = pack_bf16(f[0], f[1]);
          u.y = pack_bf16(f[2], f[3]);
          u.z = pack_bf16(f[4], f[5]);
          u.w = pack_bf16(f[6], f[7]);
          *reinterpret_cast<uint4*>(ck + kv * TC_KT * PITCH + j * PITCH + piece * 8) = u;
        }
        __syncthreads();
        kt = ck;
        vt = ck + TC_KT * PITCH;
      }
    }

    // S = Q K^T: 16 rows x 64 keys per warp, 8 n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        unsigned b0, b1, b2, b3;
        const int key = np * 16 + (lane & 7) + ((lane >> 4) << 3);
        ldsm_x4(b0, b1, b2, b3, kt + key * PITCH + kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qa[kk], b0, b1);
        mma_bf16(s[2 * np + 1], qa[kk], b2, b3);
      }
    }
    // scale, mask, online softmax in registers
    const bool need_mask = d.jlo > 0 || d.jhi < TC_KT ||
                           (d.kind == 1 && d.pos + TC_KT - 1 > qpos_lo) ||
                           (window > 0 && d.pos <= qpos_hi - window);
    float mx[2] = {NEG_INF, NEG_INF};  // scores in log2 units: exp2f below
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, j = nt * 8 + 2 * tq + (e & 1);
        float x = s[nt][e] * qscale;
        if (scaled) x *= ksc[j];
        if (need_mask) {
          const int kp = d.pos + j;
          const bool keep = j >= d.jlo && j < d.jhi && (d.kind == 0 || kp <= qp[h]) &&
                            (window == 0 || kp > qp[h] - window);
          if (!keep) x = NEG_INF;
        }
        s[nt][e] = x;
        mx[h] = fmaxf(mx[h], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(FULL, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(FULL, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      alpha[h] = exp2f(m[h] - m_new);
      m[h] = m_new;
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const float p = (s[nt][e] <= NEG_INF / 2) ? 0.f : exp2f(s[nt][e] - m[h]);
        l[h] += p;  // this lane's columns; the quad sums at the end
        s[nt][e] = scaled ? p * ksc[TC_KT + nt * 8 + 2 * tq + (e & 1)] : p;
      }
    }
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      o[dt][0] *= alpha[0];
      o[dt][1] *= alpha[0];
      o[dt][2] *= alpha[1];
      o[dt][3] *= alpha[1];
    }
    // O += P V, P split into bf16 hi + lo parts
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      unsigned ph[4], pl[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        // x: 0 = (row g, tile 2kk), 1 = (row g+8, tile 2kk), 2/3 = tile 2kk+1
        const float* c = &s[2 * kk + (x >> 1)][(x & 1) * 2];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(c[0], c[1]);
        const float2 hf = __bfloat1622float2(hi);
        ph[x] = *reinterpret_cast<const unsigned*>(&hi);
        pl[x] = pack_bf16(c[0] - hf.x, c[1] - hf.y);
      }
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        unsigned b0, b1, b2, b3;
        const int key = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldsm_x4_t(b0, b1, b2, b3, vt + key * PITCH + d0 + dp * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * dp], ph, b0, b1);
        mma_bf16(o[2 * dp], pl, b0, b1);
        mma_bf16(o[2 * dp + 1], ph, b2, b3);
        mma_bf16(o[2 * dp + 1], pl, b2, b3);
      }
    }
  }
  cp_wait<0>();

  // --- finalize: rows that never accumulated (or padding tokens) give 0
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(FULL, l[h], 1);
    l[h] += __shfl_xor_sync(FULL, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = warp * 16 + g + 8 * h;
    if (i >= rows) continue;
    const float lf = fmaxf(l[h], 1e-30f);
    bf16* dst = out + qoff(i) + d0 + 2 * tq;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const float v0 = live[h] ? o[dt][2 * h] / lf : 0.f;
      const float v1 = live[h] ? o[dt][2 * h + 1] / lf : 0.f;
      *reinterpret_cast<__nv_bfloat162*>(dst + dt * 8) = __floats2bfloat162_rn(v0, v1);
    }
  }
}

// ---------------------------------------------------------------------------
// Path 3: the f32 CUDA-core tile (64 query rows; keys widened to f32 in
// shared memory 32 at a time, running max/sum in shared memory).

template <int HD, int QT>
struct Smem {
  static constexpr int HDP = HD + 1;  // odd row stride: column reads hit 32 banks
  static constexpr int q_off = 0;                      // f32 [QT][HDP]
  static constexpr int k_off = q_off + QT * HDP;       // f32 [KB][HDP]
  static constexpr int v_off = k_off + KB * HDP;       // f32 [KB][HD]
  static constexpr int s_off = v_off + KB * HD;        // f32 [QT][KB+1]
  static constexpr int m_off = s_off + QT * (KB + 1);  // f32 [QT] running max
  static constexpr int l_off = m_off + QT;             // f32 [QT] running sum
  static constexpr int a_off = l_off + QT;             // f32 [QT] block rescale
  static constexpr int pos_off = a_off + QT;           // i32 [KB] key positions
  static constexpr int src_off = ((pos_off + KB + 1) / 2) * 2;  // i64 [KB] row offsets
  static constexpr size_t bytes = (size_t)src_off * 4 + (size_t)KB * 8;
};

// Copy KB key rows (K and V, HD values each) into shared memory as f32.
// src_s[j] is the element offset of key j's row, or -1 for "no key" (zero
// fill: p is 0 there, but 0 * garbage could still be NaN). SCALED rows are
// quantized pool rows: each value times its row's scale (row = off / HD).
template <typename S, int HD, bool SCALED>
__device__ __forceinline__ void load_keys(const S* __restrict__ ksrc, const S* __restrict__ vsrc,
                                          const float* __restrict__ ksc,
                                          const float* __restrict__ vsc,
                                          const long long* src_s, float* k_s, float* v_s) {
  constexpr int VEC = 16 / sizeof(S);  // elements per 16-byte load
  constexpr int CPR = HD / VEC;        // chunks per key row
  constexpr int HDP = HD + 1;
  static_assert(HD % VEC == 0, "head_dim must split into 16-byte chunks");
  for (int c = threadIdx.x; c < KB * CPR; c += NT) {
    const int j = c / CPR, d0 = (c % CPR) * VEC;
    const long long off = src_s[j];
    float kf[VEC], vf[VEC];
    if (off >= 0) {
      const uint4 kraw = *reinterpret_cast<const uint4*>(ksrc + off + d0);
      const uint4 vraw = *reinterpret_cast<const uint4*>(vsrc + off + d0);
      const S* kt = reinterpret_cast<const S*>(&kraw);
      const S* vt = reinterpret_cast<const S*>(&vraw);
      float ks = 1.f, vs = 1.f;
      if constexpr (SCALED) {
        ks = ksc[off / HD];
        vs = vsc[off / HD];
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        kf[e] = to_f32(kt[e]);
        vf[e] = to_f32(vt[e]);
        if constexpr (SCALED) {
          kf[e] *= ks;
          vf[e] *= vs;
        }
      }
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) kf[e] = vf[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      k_s[j * HDP + d0 + e] = kf[e];
      v_s[j * HD + d0 + e] = vf[e];
    }
  }
}

template <typename T, typename PT, int HD, int QT>
__global__ void __launch_bounds__(NT) ragged_attention_kernel(Args a) {
  constexpr bool QUANT = !std::is_same<T, PT>::value;  // int8 / fp8 pool
  using S = Smem<HD, QT>;
  constexpr int HDP = S::HDP;
  constexpr int ACC = QT * HD / NT;  // accumulator elements per thread
  static_assert((QT * HD) % NT == 0, "tile must split evenly over the CTA");
  extern __shared__ float smem[];
  float* q_s = smem + S::q_off;
  float* k_s = smem + S::k_off;
  float* v_s = smem + S::v_off;
  float* s_s = smem + S::s_off;
  float* m_s = smem + S::m_off;
  float* l_s = smem + S::l_off;
  float* a_s = smem + S::a_off;
  int* pos_s = reinterpret_cast<int*>(smem + S::pos_off);
  long long* src_s = reinterpret_cast<long long*>(smem + S::src_off);

  const int r = blockIdx.x, kvh = blockIdx.y, i0 = blockIdx.z * QT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int W = a.W, H = a.H, Kh = a.Kh, ps = a.ps;
  const int rep = H / Kh;
  const int nq = W * rep;
  const int rows = min(QT, nq - i0);  // query rows of this tile
  const int start = a.row_starts[r], ntok = a.n_tokens[r];
  const int ctx = a.ctx_lens[r], my_seq = a.seq_ids[r];
  const T* q = reinterpret_cast<const T*>(a.q);
  T* out = reinterpret_cast<T*>(a.out);

  // query row i of the tile: token w = (i0 + i) / rep, head kvh*rep + (i0+i)%rep
  auto qoff = [&](int i) -> long long {
    const int gi = i0 + i, w = gi / rep, h = kvh * rep + gi % rep;
    return (((long long)r * W + w) * H + h) * HD;
  };
  const int w_lo = i0 / rep;                     // first token of the tile
  const int w_hi = min((i0 + rows - 1) / rep, ntok - 1);  // last VALID token
  if (w_lo > w_hi) {  // padding row / all-padding tile: zeros, nothing to read
    for (int e = tid; e < rows * HD; e += NT)
      out[qoff(e / HD) + e % HD] = from_f32<T>(0.f);
    return;
  }
  const int qpos_lo = start + w_lo, qpos_hi = start + w_hi;
  const int window = a.window;

  for (int e = tid; e < QT * HD; e += NT) {
    const int i = e / HD, d = e % HD;
    q_s[i * HDP + d] = (i < rows) ? to_f32(q[qoff(i) + d]) * a.sm_scale : 0.f;
  }
  if (tid < QT) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[ACC];
#pragma unroll
  for (int k = 0; k < ACC; ++k) acc[k] = 0.f;

  // One key block (k_s/v_s/pos_s loaded): scores, online softmax, P @ V.
  auto process = [&]() {
    for (int e = tid; e < QT * KB; e += NT) {
      const int i = e / KB, j = e % KB;  // a warp shares i: q_s broadcasts
      const int w = (i0 + i) / rep;
      const int kp = pos_s[j];
      const int qp = start + w;
      float s = NEG_INF;
      if (i < rows && w < ntok && kp != NO_KEY && kp <= qp &&
          (window == 0 || kp > qp - window)) {
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < HD; ++d) dot += q_s[i * HDP + d] * k_s[j * HDP + d];
        s = dot;
      }
      s_s[i * (KB + 1) + j] = s;
    }
    __syncthreads();
    for (int i = warp; i < QT; i += NT / 32) {
      const float s = s_s[i * (KB + 1) + lane];
      float mx = s;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[i];
      const float m_new = fmaxf(m_old, mx);
      const float p = (s <= NEG_INF / 2) ? 0.f : expf(s - m_new);
      float sum = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      s_s[i * (KB + 1) + lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[i] = alpha;
        l_s[i] = l_s[i] * alpha + sum;
        m_s[i] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < ACC; ++k) {
      const int e = tid + k * NT;
      const int i = e / HD, d = e % HD;
      float v = acc[k] * a_s[i];
#pragma unroll 8
      for (int j = 0; j < KB; ++j) v += s_s[i * (KB + 1) + j] * v_s[j * HD + d];
      acc[k] = v;
    }
  };

  // --- phase A: cached pool pages, positions [k_lo, ctx). With a window,
  // keys at or before the tile's first query minus the window never count.
  if (ctx > 0) {
    const PT* kp_base = reinterpret_cast<const PT*>(a.k_pages);
    const PT* vp_base = reinterpret_cast<const PT*>(a.v_pages);
    int k_lo = 0;
    if (window > 0) k_lo = max(0, qpos_lo - window + 1);
    for (int kb0 = (k_lo / KB) * KB; kb0 < ctx; kb0 += KB) {
      __syncthreads();  // previous block's readers are done with pos_s/src_s
      if (tid < KB) {
        const int kp = kb0 + tid;
        const int pi = kp / ps;
        if (kp < ctx && pi < a.maxp) {
          const long long page = a.page_tables[(long long)r * a.maxp + pi];
          pos_s[tid] = kp;
          src_s[tid] = ((page * Kh + kvh) * ps + kp % ps) * HD;
        } else {
          pos_s[tid] = NO_KEY;
          src_s[tid] = -1;
        }
      }
      __syncthreads();  // pos_s/src_s visible; previous block fully consumed
      load_keys<PT, HD, QUANT>(kp_base, vp_base, a.k_scales, a.v_scales, src_s, k_s, v_s);
      __syncthreads();
      process();
    }
  }

  // --- phase B: the launch's new keys of this sequence, causal.
  {
    const T* kn = reinterpret_cast<const T*>(a.k_new);
    const T* vn = reinterpret_cast<const T*>(a.v_new);
    for (int r2 = 0; r2 < a.R; ++r2) {
      const int n2 = a.n_tokens[r2];
      if (n2 <= 0 || a.seq_ids[r2] != my_seq) continue;
      const int st2 = a.row_starts[r2];
      for (int jb = 0; jb < n2; jb += KB) {
        if (st2 + jb > qpos_hi) break;  // every key past the tile's last query
        if (window > 0 && st2 + jb + KB - 1 <= qpos_lo - window) continue;
        __syncthreads();
        if (tid < KB) {
          const int j = jb + tid;
          if (j < n2) {
            pos_s[tid] = st2 + j;
            src_s[tid] = (((long long)r2 * W + j) * Kh + kvh) * HD;
          } else {
            pos_s[tid] = NO_KEY;
            src_s[tid] = -1;
          }
        }
        __syncthreads();
        load_keys<T, HD, false>(kn, vn, nullptr, nullptr, src_s, k_s, v_s);
        __syncthreads();
        process();
      }
    }
  }

  // --- finalize: rows that never accumulated divide 0 by the floor
  __syncthreads();
#pragma unroll
  for (int k = 0; k < ACC; ++k) {
    const int e = tid + k * NT;
    const int i = e / HD, d = e % HD;
    if (i < rows) out[qoff(i) + d] = from_f32<T>(acc[k] / fmaxf(l_s[i], 1e-30f));
  }
}

// Phase C: token (r, w) writes its K/V row for every KV head into its slot.
template <typename T>
__global__ void kv_write_kernel(Args a, int hd) {
  const int t = blockIdx.x;
  const int r = t / a.W, w = t % a.W;
  if (w >= a.n_tokens[r]) return;  // padding token: no write
  const int pos = a.row_starts[r] + w;
  const int pi = pos / a.ps;
  if (pi >= a.maxp) return;  // past the page table: no write
  const long long page = a.page_tables[(long long)r * a.maxp + pi];
  const int slot = pos % a.ps;
  const T* kn = reinterpret_cast<const T*>(a.k_new);
  const T* vn = reinterpret_cast<const T*>(a.v_new);
  T* kp = reinterpret_cast<T*>(a.k_pages);
  T* vp = reinterpret_cast<T*>(a.v_pages);
  for (int e = threadIdx.x; e < a.Kh * hd; e += blockDim.x) {
    const int kh = e / hd, d = e % hd;
    const long long dst = ((page * a.Kh + kh) * a.ps + slot) * hd + d;
    const long long src = (((long long)r * a.W + w) * a.Kh + kh) * hd + d;
    kp[dst] = kn[src];
    vp[dst] = vn[src];
  }
}

// Phase C, quantized pools: one warp per (token, KV head) row. Quantizes
// `src` (hd values of T) into `dst` (hd values of PT) and its scale.
template <typename T, typename PT>
__device__ __forceinline__ void quantize_row(const T* __restrict__ src, PT* __restrict__ dst,
                                             float* __restrict__ scale_dst, int hd, int lane) {
  float mx = 0.f;
  for (int d = lane; d < hd; d += 32) mx = fmaxf(mx, fabsf(to_f32(src[d])));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  const float scale = fmaxf(mx * Quant<PT>::inv_qmax, SCALE_FLOOR);
  for (int d = lane; d < hd; d += 32) dst[d] = Quant<PT>::cast(__fdiv_rn(to_f32(src[d]), scale));
  if (lane == 0) *scale_dst = scale;
}

template <typename T, typename PT>
__global__ void kv_write_quant_kernel(Args a, int hd) {
  const int t = blockIdx.x;
  const int r = t / a.W, w = t % a.W;
  if (w >= a.n_tokens[r]) return;  // padding token: no write
  const int pos = a.row_starts[r] + w;
  const int pi = pos / a.ps;
  if (pi >= a.maxp) return;  // past the page table: no write
  const long long page = a.page_tables[(long long)r * a.maxp + pi];
  const int slot = pos % a.ps;
  const T* kn = reinterpret_cast<const T*>(a.k_new);
  const T* vn = reinterpret_cast<const T*>(a.v_new);
  PT* kp = reinterpret_cast<PT*>(a.k_pages);
  PT* vp = reinterpret_cast<PT*>(a.v_pages);
  const int lane = threadIdx.x & 31;
  for (int kh = threadIdx.x >> 5; kh < a.Kh; kh += blockDim.x >> 5) {
    const long long src = (((long long)r * a.W + w) * a.Kh + kh) * hd;
    const long long row = (page * a.Kh + kh) * a.ps + slot;  // scale index
    quantize_row<T, PT>(kn + src, kp + row * hd, a.k_scales + row, hd, lane);
    quantize_row<T, PT>(vn + src, vp + row * hd, a.v_scales + row, hd, lane);
  }
}

// Path 1 (bf16, nq > 8), 2 (nq <= 8) or 3 (f32, nq > 8) for these widths.
constexpr int attention_path(int W, int H, int Kh, int dtype) {
  return W * (H / Kh) <= DEC_NQ ? 2 : (dtype == 1 ? 1 : 3);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, typename PT, int HD>
cudaError_t launch_attention(const Args& a, int path, cudaStream_t stream) {
  cudaError_t err;
  if (path == 2) {
    if (a.part == nullptr) return cudaErrorInvalidValue;
    const size_t smem = DecodeSmem<T, PT, HD>::bytes;
    const dim3 grid(a.R, a.Kh, decode_nsplit(a.ps, a.maxp) + 1);
    if (a.W * (a.H / a.Kh) <= 4) {
      if ((err = allow_smem(decode_split_kernel<T, PT, HD, 4>, smem)) != cudaSuccess) return err;
      decode_split_kernel<T, PT, HD, 4><<<grid, NT, smem, stream>>>(a);
    } else {
      if ((err = allow_smem(decode_split_kernel<T, PT, HD, DEC_NQ>, smem)) != cudaSuccess)
        return err;
      decode_split_kernel<T, PT, HD, DEC_NQ><<<grid, NT, smem, stream>>>(a);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    decode_combine_kernel<T><<<dim3(a.R, a.Kh), NT, 0, stream>>>(a, HD);
    return cudaGetLastError();
  }
  const int nq = a.W * (a.H / a.Kh);
  if constexpr (std::is_same<T, bf16>::value) {
    const size_t smem = TcSmem<PT, HD>::bytes;
    const int tiles = (nq + TC_QT - 1) / TC_QT * TcGeom<HD>::NH;
    if ((err = allow_smem(tc_tile_kernel<PT, HD>, smem)) != cudaSuccess) return err;
    tc_tile_kernel<PT, HD><<<dim3(a.R, a.Kh, tiles), NT, smem, stream>>>(a);
  } else {
    constexpr int QT = HD > 128 ? 32 : 64;  // f32 accumulators: QT * HD / NT a thread
    const size_t smem = Smem<HD, QT>::bytes;
    if ((err = allow_smem(ragged_attention_kernel<T, PT, HD, QT>, smem)) != cudaSuccess) return err;
    ragged_attention_kernel<T, PT, HD, QT><<<dim3(a.R, a.Kh, (nq + QT - 1) / QT), NT, smem,
                                             stream>>>(a);
  }
  return cudaGetLastError();
}

#ifndef AFP_HEAD_DIM
#error "build with -DAFP_HEAD_DIM=<head dim> (ops/cuda/build.py does)"
#endif

// Attention for head_dim hd (this build's AFP_HEAD_DIM), then (write_kv)
// phase C on the same stream.
template <typename T, typename PT>
cudaError_t run(const Args& a, int hd, int path, int write_kv, cudaStream_t stream) {
  if (hd != AFP_HEAD_DIM) return cudaErrorInvalidValue;
  const cudaError_t err = launch_attention<T, PT, AFP_HEAD_DIM>(a, path, stream);
  if (err != cudaSuccess || !write_kv) return err;
  if constexpr (std::is_same<T, PT>::value)
    kv_write_kernel<T><<<a.R * a.W, NT, 0, stream>>>(a, hd);
  else
    kv_write_quant_kernel<T, PT><<<a.R * a.W, NT, 0, stream>>>(a, hd);
  return cudaGetLastError();
}

// pool_dtype: the compute dtype's own code (plain pool, no scales), or 2 =
// int8 / 3 = float8_e4m3fn with both scale pointers set.
template <typename T>
cudaError_t run_pool(const Args& a, int hd, int path, int own_code, int pool_dtype,
                     int write_kv, cudaStream_t stream) {
  const bool scaled = a.k_scales != nullptr && a.v_scales != nullptr;
  const bool unscaled = a.k_scales == nullptr && a.v_scales == nullptr;
  if (pool_dtype == own_code && unscaled) return run<T, T>(a, hd, path, write_kv, stream);
  if (pool_dtype == 2 && scaled) return run<T, int8_t>(a, hd, path, write_kv, stream);
  if (pool_dtype == 3 && scaled) return run<T, __nv_fp8_e4m3>(a, hd, path, write_kv, stream);
  return cudaErrorInvalidValue;
}

long long part_floats_needed(int R, int W, int H, int Kh, int ps, int maxp, int hd) {
  if (W * (H / Kh) > DEC_NQ) return 0;
  return (long long)R * Kh * (decode_nsplit(ps, maxp) + 1) * decode_part_floats(hd);
}

}  // namespace

// The head dim this library was built for.
extern "C" int afp_head_dim() { return AFP_HEAD_DIM; }

extern "C" const char* afp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The path a launch of these widths takes: 1 = bf16 tensor-core tile, 2 =
// split-context decode (then a combine launch), 3 = f32 CUDA-core tile.
extern "C" int afp_attention_path(int W, int H, int Kh, int dtype) {
  return attention_path(W, H, Kh, dtype);
}

// f32 scratch the decode path needs for its partials (0 on paths 1 and 3).
extern "C" long long afp_decode_part_floats(int R, int W, int H, int Kh, int ps, int maxp,
                                            int hd) {
  return part_floats_needed(R, W, H, Kh, ps, maxp, hd);
}

// dtype (q, new K/V, out): 0 = float32, 1 = bfloat16. pool_dtype: the same
// code for a plain pool (k_scales = v_scales = null), or 2 = int8, 3 =
// float8_e4m3fn with per-slot f32 scales [P, Kh, ps]; any other combination
// returns cudaErrorInvalidValue. part: f32 scratch of part_floats values,
// at least afp_decode_part_floats(...) (may be null when that is 0).
// write_kv: 0 skips phase C (the dense packing attends a throwaway pool).
// Returns cudaGetLastError() after the launches (0 = success); a fault
// during the run surfaces at the next sync.
extern "C" int afp_ragged_paged_attention(
    const void* q, const void* k_new, const void* v_new, void* k_pages, void* v_pages,
    void* k_scales, void* v_scales, void* out, const void* page_tables, const void* row_starts,
    const void* n_tokens, const void* ctx_lens, const void* seq_ids, void* part,
    long long part_floats, int R, int W, int H, int Kh, int ps, int maxp, int hd, int dtype,
    int pool_dtype, float sm_scale, int window, int write_kv, void* stream_ptr) {
  if (R <= 0 || W <= 0) return (int)cudaSuccess;
  if (Kh <= 0 || H % Kh || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  if (part_floats < part_floats_needed(R, W, H, Kh, ps, maxp, hd))
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  Args a;
  a.q = q; a.k_new = k_new; a.v_new = v_new; a.k_pages = k_pages; a.v_pages = v_pages;
  a.k_scales = static_cast<float*>(k_scales); a.v_scales = static_cast<float*>(v_scales);
  a.out = out;
  a.page_tables = static_cast<const int*>(page_tables);
  a.row_starts = static_cast<const int*>(row_starts);
  a.n_tokens = static_cast<const int*>(n_tokens);
  a.ctx_lens = static_cast<const int*>(ctx_lens);
  a.seq_ids = static_cast<const int*>(seq_ids);
  a.part = static_cast<float*>(part);
  a.R = R; a.W = W; a.H = H; a.Kh = Kh; a.ps = ps; a.maxp = maxp;
  a.sm_scale = sm_scale; a.window = window;
  a.ps_shift = (ps > 0 && (ps & (ps - 1)) == 0) ? __builtin_ctz((unsigned)ps) : -1;
  const int path = attention_path(W, H, Kh, dtype);
  if (dtype == 0) return (int)run_pool<float>(a, hd, path, 0, pool_dtype, write_kv, stream);
  return (int)run_pool<bf16>(a, hd, path, 1, pool_dtype, write_kv, stream);
}
