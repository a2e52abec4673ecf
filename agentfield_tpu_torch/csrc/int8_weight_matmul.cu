// Weight-only int8 matrix product, hand-written for Hopper (sm_90a). Plain C
// interface, loaded with ctypes by agentfield_tpu_torch/ops/cuda/quant_matmul.py.
//
//   y[M, N] = (x[M, K] @ q[K, N]) * scale[N]
//
// x and y are bf16 or f32 (the same type), q is int8 (row-major, N
// contiguous), scale is f32, and the sum is taken in f32. This is the
// port's implementation of agentfield_tpu/models/quant.py's
// QuantW.__rmatmul__, per-output-channel symmetric int8 weights. It has no
// Pallas twin: on the TPU, XLA folds the int8 -> bf16 convert into the
// dot's operand read. In PyTorch, x @ q.to(bf16) would write a widened
// copy of every weight and read it back (5 bytes a weight against the bf16
// model's 2). Here q is read once, as int8, and widened in registers; no
// widened copy of q is ever written to device memory.
//
// The card (H100 SXM): 3.35 TB/s HBM, 989 TFLOP/s bf16 on the tensor cores,
// 132 SMs of 227 KB shared memory. At decode widths (M <= 64) a product is
// bound by the bytes of q: K * N int8 against M * K * N * 2 FLOPs, about
// M FLOPs a byte where the card needs ~295 to be bound by operations. A
// prefill chunk (M in the hundreds or thousands) is bound by the FLOPs.
//
// Design. One kernel body, two paths (the wrapper plans which):
//   stream (M <= 64, decode widths 4-32 and the speculative verify): a CTA
//     of 16 warps owns a 256-column slice of N (8 warps across, 32 columns
//     each) and all M rows (rounded up to 16, 32 or 64); when the N slices
//     alone would leave some of the 132 SMs idle,
//     the K range is split across CTAs (grid z), each writing an f32
//     partial; the last CTA of a tile to finish (an atomic count) sums the
//     partials in split order and applies the scale, so a product is one
//     launch. Inside a CTA, two groups of 8 warps take alternate 16-row
//     steps of each stage and meet in shared memory at the end. A 4-stage
//     cp.async ring keeps 64-row tiles of q (16 KB) and the matching x tile
//     in flight, all with 16-byte loads. (Measured on the card: 256 columns
//     and two groups stream faster than 128 columns or one group; more
//     stages do not help.)
//   tiled (M > 64, prefill, the embed's chunks, the mixed tick): a CTA of 8
//     warps computes a 128 x 128 tile of y over a 3-stage cp.async ring;
//     the same split-K when the tiles are too few for the card.
// Each warp computes a 16*MT x 32 block with mma.sync.m16n8k16 bf16 -> f32.
// Its B fragments come straight from the int8 tile in shared memory: lane
// (g = lane / 4, t = lane % 4) reads one 32-bit word (4 columns) from each
// of the four rows 2t, 2t+1, 2t+8, 2t+9 of a 16-row step. Those are the
// rows the B fragment wants, and the 4 columns become the lane's column of
// 4 separate n8 blocks: logical column p of block j is physical column
// 4p + j of the warp's 32. The C fragment then puts 8 consecutive physical
// columns (8t .. 8t+7) in each lane, so the epilogue stores 16 bytes a row.
// int8 -> bf16 is exact (every int8 is a bf16): bias the byte to unsigned,
// place it in the mantissa of 2^23, subtract 2^23 + 128 in f32, and keep
// the upper half (exact, the value has <= 8 significant bits). Rows of q
// in shared memory are padded by 16 bytes (a pitch of 4 banks mod 32), so
// the four rows a lane reads fall in distinct banks: the warp's 32 reads
// hit 32 banks.
// f32 x: each value is split into three bf16 parts, hi + mid + lo == x
// exactly, and the product runs as three MMAs: every product of a bf16 part
// and an int8 weight is exact in f32. The tensor core's f32 accumulation is
// not round-to-nearest, so each 16-row step is summed there from zero and
// added to the running sum by an IEEE f32 add (measured on the card: summed
// over all of K in the tensor core, the full-width f32 logits missed 1e-4
// of their max against the plain version). bf16 outputs round to 8 bits, so
// the bf16 path accumulates in the tensor core throughout.
// Edges: rows of x past M and rows of q past K are zero-filled by cp.async;
// columns past N are skipped (N a multiple of 32, K of 16: the wrapper
// refuses anything else).
// wgmma and TMA are left for a later change: the first version is mma.sync
// with widening in registers, the simple shape that is right.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BK = 64;             // K rows of a ring stage
constexpr int X_PITCH = BK + 8;    // x elements a row takes in shared memory
// a CTA has WN warps across N, 32 columns each: BN = 32 WN columns, whose
// q rows take BN + 16 bytes in shared memory
__host__ __device__ constexpr int q_pitch(int wn) { return 32 * wn + 16; }
// the stream path's CTA (measured on the card, PR 12: 8 warps across N and
// two K groups beat 4 across and one group; 6 or 8 ring stages gain nothing)
constexpr int STREAM_WN = 8;       // warps across N: 256 columns
constexpr int STREAM_KW = 2;       // warp groups splitting each stage's 16-row steps
constexpr int STREAM_STAGES = 4;   // cp.async ring stages

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// cp.async with zero fill: src_size 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte J of two biased int8 words (u = v + 128) as a bf16 pair: wa's in
// the low half, wb's in the high half.
template <int J>
__device__ __forceinline__ uint32_t widen_pair(uint32_t wa, uint32_t wb) {
  const float fa = __uint_as_float(__byte_perm(wa, 0x4B000000u, J | 0x7540)) - 8388736.0f;
  const float fb = __uint_as_float(__byte_perm(wb, 0x4B000000u, J | 0x7540)) - 8388736.0f;
  return __byte_perm(__float_as_uint(fa), __float_as_uint(fb), 0x7632);
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

// x element types: how an A fragment register pair is read from the x tile
// (row-major, X_PITCH elements a row) and how many bf16 parts it takes.
template <typename T> struct XOps;
template <> struct XOps<bf16> {
  static constexpr int PARTS = 1;
  static constexpr int CHUNK = 8;  // elements of a 16-byte cp.async
  // parts[0][i] = the A register i: rows r0 + g (+8), cols c0 + 2t (+8)
  __device__ static void frag(const bf16* xs, int r, int c, uint32_t (&parts)[1][4]) {
    const bf16* p = xs + r * X_PITCH + c;
    parts[0][0] = *reinterpret_cast<const uint32_t*>(p);
    parts[0][1] = *reinterpret_cast<const uint32_t*>(p + 8 * X_PITCH);
    parts[0][2] = *reinterpret_cast<const uint32_t*>(p + 8);
    parts[0][3] = *reinterpret_cast<const uint32_t*>(p + 8 * X_PITCH + 8);
  }
};
template <> struct XOps<float> {
  static constexpr int PARTS = 3;
  static constexpr int CHUNK = 4;
  __device__ static void split(float2 v, uint32_t& hi, uint32_t& mid, uint32_t& lo) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
    const float2 hf = __bfloat1622float2(h);
    const float2 r1 = make_float2(v.x - hf.x, v.y - hf.y);
    const __nv_bfloat162 m = __floats2bfloat162_rn(r1.x, r1.y);
    const float2 mf = __bfloat1622float2(m);
    const __nv_bfloat162 l = __floats2bfloat162_rn(r1.x - mf.x, r1.y - mf.y);
    hi = bf16x2_bits(h);
    mid = bf16x2_bits(m);
    lo = bf16x2_bits(l);
  }
  __device__ static void frag(const float* xs, int r, int c, uint32_t (&parts)[3][4]) {
    const float* p = xs + r * X_PITCH + c;
    const float2 v[4] = {*reinterpret_cast<const float2*>(p),
                         *reinterpret_cast<const float2*>(p + 8 * X_PITCH),
                         *reinterpret_cast<const float2*>(p + 8),
                         *reinterpret_cast<const float2*>(p + 8 * X_PITCH + 8)};
#pragma unroll
    for (int i = 0; i < 4; ++i) split(v[i], parts[0][i], parts[1][i], parts[2][i]);
  }
};

__device__ __forceinline__ void store8(bf16* y, const float* v) {
  uint4 u;
  u.x = bf16x2_bits(__floats2bfloat162_rn(v[0], v[1]));
  u.y = bf16x2_bits(__floats2bfloat162_rn(v[2], v[3]));
  u.z = bf16x2_bits(__floats2bfloat162_rn(v[4], v[5]));
  u.w = bf16x2_bits(__floats2bfloat162_rn(v[6], v[7]));
  *reinterpret_cast<uint4*>(y) = u;
}
__device__ __forceinline__ void store8(float* y, const float* v) {
  *reinterpret_cast<float4*>(y) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(y + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

template <typename T, int BM, int WN>
__host__ __device__ constexpr int smem_stage_bytes() {
  return BK * q_pitch(WN) + BM * X_PITCH * (int)sizeof(T);
}

// One CTA: a BM x BN tile of y (blockIdx.y, blockIdx.x) over the K tiles of
// split blockIdx.z. With part != null it writes its unscaled f32 sums to
// part[z][M][N]; otherwise y = sums * scale.
template <typename T, int BM, int WM, int WN, int KW, int STAGES>
__global__ void __launch_bounds__(32 * WM * WN * KW)
w8_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
                 const float* __restrict__ scale, T* __restrict__ y, float* __restrict__ part,
                 int* __restrict__ counters, int M, int K, int N, int kt_per_split) {
  constexpr int THREADS = 32 * WM * WN * KW;
  constexpr int MT = BM / WM / 16;  // m16 tiles a warp
  constexpr int PARTS = XOps<T>::PARTS;
  constexpr int CHUNK = XOps<T>::CHUNK;
  constexpr int STAGE = smem_stage_bytes<T, BM, WN>();
  constexpr int BN = 32 * WN, Q_PITCH = q_pitch(WN);
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  // KW warp groups split each stage's 16-row steps; group kw > 0 hands its
  // sums to group 0 at the end
  const int kw = warp / (WM * WN), wrest = warp % (WM * WN);
  const int wm = wrest / WN, wn = wrest % WN;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int nkt = (K + BK - 1) / BK;
  const int kt0 = blockIdx.z * kt_per_split;
  const int kt1 = min(kt0 + kt_per_split, nkt);
  const int ntiles = max(kt1 - kt0, 0);

  auto load_stage = [&](int stage, int kt) {
    unsigned char* base = smem + stage * STAGE;
    int8_t* qs = reinterpret_cast<int8_t*>(base);
    T* xs = reinterpret_cast<T*>(base + BK * Q_PITCH);
    const int k0 = kt * BK;
    // q: BK rows x BN / 16 chunks of 16 bytes
    for (int c = tid; c < BK * (BN / 16); c += THREADS) {
      const int r = c / (BN / 16), ch = c % (BN / 16);
      const int gk = k0 + r, gn = n0 + ch * 16;
      const bool ok = gk < K && gn < N;
      cp16(qs + r * Q_PITCH + ch * 16, ok ? q + (long long)gk * N + gn : q, ok);
    }
    // x: BM rows x BK / CHUNK chunks of 16 bytes
    for (int c = tid; c < BM * (BK / CHUNK); c += THREADS) {
      const int r = c / (BK / CHUNK), ch = c % (BK / CHUNK);
      const int gm = m0 + r, gk = k0 + ch * CHUNK;
      const bool ok = gm < M && gk < K;
      cp16(xs + r * X_PITCH + ch * CHUNK, ok ? x + (long long)gm * K + gk : x, ok);
    }
  };

  float acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const bool warp_live = n0 + wn * 32 < N;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ntiles) load_stage(s, kt0 + s);
    cp_commit();
  }
  for (int i = 0; i < ntiles; ++i) {
    cp_wait<STAGES - 2>();
    __syncthreads();
    const int nxt = i + STAGES - 1;
    if (nxt < ntiles) load_stage(nxt % STAGES, kt0 + nxt);
    cp_commit();
    if (!warp_live) continue;
    const unsigned char* base = smem + (i % STAGES) * STAGE;
    const int8_t* qs = reinterpret_cast<const int8_t*>(base) + wn * 32 + 4 * g;
    const T* xs = reinterpret_cast<const T*>(base + BK * Q_PITCH);
#pragma unroll
    for (int step = 0; step < BK / (16 * KW); ++step) {
      const int kk = (step * KW + kw) * 16;
      const int8_t* qr = qs + (kk + 2 * t) * Q_PITCH;
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(qr) ^ 0x80808080u;
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(qr + Q_PITCH) ^ 0x80808080u;
      const uint32_t w8 = *reinterpret_cast<const uint32_t*>(qr + 8 * Q_PITCH) ^ 0x80808080u;
      const uint32_t w9 = *reinterpret_cast<const uint32_t*>(qr + 9 * Q_PITCH) ^ 0x80808080u;
      uint32_t b0[4], b1[4];
      b0[0] = widen_pair<0>(w0, w1); b1[0] = widen_pair<0>(w8, w9);
      b0[1] = widen_pair<1>(w0, w1); b1[1] = widen_pair<1>(w8, w9);
      b0[2] = widen_pair<2>(w0, w1); b1[2] = widen_pair<2>(w8, w9);
      b0[3] = widen_pair<3>(w0, w1); b1[3] = widen_pair<3>(w8, w9);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a[PARTS][4];
        XOps<T>::frag(xs, (wm * MT + mt) * 16 + g, kk + 2 * t, a);
        if constexpr (PARTS == 1) {
#pragma unroll
          for (int j = 0; j < 4; ++j) mma16816(acc[mt][j], a[0], b0[j], b1[j]);
        } else {
          // f32: the tensor core sums this step's 3 x 16 products from
          // zero, and the step's sum joins the running sum in an IEEE f32
          // add (the tensor core's own accumulation is not round-to-
          // nearest: summed there over all of K, it errs far more)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float step[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int p = 0; p < PARTS; ++p) mma16816(step, a[p], b0[j], b1[j]);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][j][e] += step[e];
          }
        }
      }
    }
  }
  cp_wait<0>();
  if (KW > 1) {  // the groups' sums meet in shared memory (the ring is done)
    __syncthreads();
    float* red = reinterpret_cast<float*>(smem);
    if (kw > 0 && warp_live) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            red[((((kw - 1) * WM * WN + wrest) * MT + i) * 16 + j * 4 + e) * 32 + lane] =
                acc[i][j][e];
    }
    __syncthreads();
    if (kw == 0) {
      for (int h = 1; h < KW; ++h)
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[i][j][e] += red[((((h - 1) * WM * WN + wrest) * MT + i) * 16 + j * 4 + e) * 32 +
                                  lane];
    }
  }

  // lane's columns: n0 + wn*32 + 8t + c, c < 4 from C fragment element 0
  // (or 2) of block c, c >= 4 from element 1 (or 3) of block c - 4
  if (warp_live && kw == 0) {
    const int col = n0 + wn * 32 + 8 * t;
    float sc[8];
    if (part == nullptr) {
      const float4 s0 = *reinterpret_cast<const float4*>(scale + col);
      const float4 s1 = *reinterpret_cast<const float4*>(scale + col + 4);
      sc[0] = s0.x; sc[1] = s0.y; sc[2] = s0.z; sc[3] = s0.w;
      sc[4] = s1.x; sc[5] = s1.y; sc[6] = s1.z; sc[7] = s1.w;
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + (wm * MT + mt) * 16 + g + 8 * h;
        if (row >= M) continue;
        float v[8];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          v[c] = acc[mt][c][2 * h];
          v[c + 4] = acc[mt][c][2 * h + 1];
        }
        if (part != nullptr) {
          store8(part + ((long long)blockIdx.z * M + row) * N + col, v);
        } else {
#pragma unroll
          for (int c = 0; c < 8; ++c) v[c] *= sc[c];
          store8(y + (long long)row * N + col, v);
        }
      }
    }
  }
  if (part == nullptr) return;

  // Split-K: the last CTA of this (m, n) tile to finish sums every split's
  // partial in split order (the same sum on every run), scales and writes
  // y, and resets the tile's counter for the next launch (the threadfence
  // reduction pattern: partials are fenced before the count, read after).
  __shared__ int is_last;
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* ctr = counters + blockIdx.y * gridDim.x + blockIdx.x;
    is_last = atomicAdd(ctr, 1) == (int)gridDim.z - 1;
    if (is_last) *ctr = 0;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const long long total = (long long)M * N;
  for (int e = tid * 8; e < BM * BN; e += THREADS * 8) {
    const int row = m0 + e / BN, col = n0 + e % BN;
    if (row >= M || col >= N) continue;
    const float* p = part + (long long)row * N + col;
    float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int sp = 0; sp < (int)gridDim.z; ++sp) {
      const float4 a = __ldcg(reinterpret_cast<const float4*>(p + sp * total));
      const float4 b = __ldcg(reinterpret_cast<const float4*>(p + sp * total + 4));
      v[0] += a.x; v[1] += a.y; v[2] += a.z; v[3] += a.w;
      v[4] += b.x; v[5] += b.y; v[6] += b.z; v[7] += b.w;
    }
    const float4 s0 = *reinterpret_cast<const float4*>(scale + col);
    const float4 s1 = *reinterpret_cast<const float4*>(scale + col + 4);
    v[0] *= s0.x; v[1] *= s0.y; v[2] *= s0.z; v[3] *= s0.w;
    v[4] *= s1.x; v[5] *= s1.y; v[6] *= s1.z; v[7] *= s1.w;
    store8(y + (long long)row * N + col, v);
  }
}

template <typename T, int BM, int WM, int WN, int KW, int STAGES>
cudaError_t launch_tile(const void* x, const void* q, const void* scale, void* y, float* part,
                        int* counters, int M, int K, int N, int splits, int kt_per_split,
                        cudaStream_t stream) {
  auto kernel = w8_matmul_kernel<T, BM, WM, WN, KW, STAGES>;
  constexpr int BN = 32 * WN;
  constexpr int ring = STAGES * smem_stage_bytes<T, BM, WN>();
  constexpr int reduce = (KW - 1) * WM * WN * (BM / WM / 16) * 16 * 32 * 4;
  const int smem = ring > reduce ? ring : reduce;
  static bool smem_allowed = false;  // once per instance (a benign race: same value)
  cudaError_t err;
  if (!smem_allowed) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_allowed = true;
  }
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  kernel<<<grid, 32 * WM * WN * KW, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(q), static_cast<const float*>(scale),
      static_cast<T*>(y), splits > 1 ? part : nullptr, counters, M, K, N, kt_per_split);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dtype(int path, int bm, const void* x, const void* q, const void* scale,
                         void* y, float* part, int* counters, int M, int K, int N, int splits,
                         int kt_per_split, cudaStream_t stream) {
#define W8_ARGS x, q, scale, y, part, counters, M, K, N, splits, kt_per_split, stream
  if (path == 1) {  // stream: all BM rows in each warp
    constexpr int WN = STREAM_WN, KW = STREAM_KW, ST = STREAM_STAGES;
    if (bm == 16) return launch_tile<T, 16, 1, WN, KW, ST>(W8_ARGS);
    if (bm == 32) return launch_tile<T, 32, 1, WN, KW, ST>(W8_ARGS);
    if (bm == 64) return launch_tile<T, 64, 1, WN, KW, ST>(W8_ARGS);
  } else if (path == 2 && bm == 128) {  // tiled: 2 x 4 warps of 64 x 32
    return launch_tile<T, 128, 2, 4, 1, 3>(W8_ARGS);
  }
#undef W8_ARGS
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" const char* w8_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x [M, K] and y [M, N]: dtype 0 = float32, 1 = bfloat16; q [K, N] int8;
// scale [N] f32; all contiguous and 16-byte aligned. path 1 = stream (bm 16,
// 32 or 64), 2 = tiled (bm 128). splits > 1: the K tiles of 64 rows are cut
// into splits ranges of kt_per_split tiles each; part holds at least splits
// * M * N floats and counters one int per (m, n) tile, zero before the
// launch and zero again after it (null both when splits == 1); launches that
// share counters must not overlap. Returns cudaGetLastError() after the
// launch (0 = success); a fault during the run surfaces at the next sync.
// Anything it does not take returns cudaErrorInvalidValue.
extern "C" int w8_matmul(const void* x, const void* q, const void* scale, void* y, void* part,
                         long long part_floats, void* counters, int counter_ints, int M, int K,
                         int N, int dtype, int path, int bm, int splits, int kt_per_split,
                         void* stream_ptr) {
  if (M <= 0) return (int)cudaSuccess;
  const int nkt = (K + BK - 1) / BK;
  if (K <= 0 || K % 16 || N <= 0 || N % 32 || splits < 1 || kt_per_split < 1 ||
      (long long)splits * kt_per_split < nkt || (long long)(splits - 1) * kt_per_split >= nkt)
    return (int)cudaErrorInvalidValue;
  if (bm <= 0) return (int)cudaErrorInvalidValue;
  const int BN = 32 * (path == 1 ? STREAM_WN : 4);
  const long long tiles = (long long)((N + BN - 1) / BN) * ((M + bm - 1) / bm);
  if (splits > 1 && (part == nullptr || part_floats < (long long)splits * M * N ||
                     counters == nullptr || counter_ints < tiles))
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  float* p = static_cast<float*>(part);
  int* c = static_cast<int*>(counters);
  cudaError_t err;
  if (dtype == 1)
    err = launch_dtype<bf16>(path, bm, x, q, scale, y, p, c, M, K, N, splits, kt_per_split, stream);
  else if (dtype == 0)
    err = launch_dtype<float>(path, bm, x, q, scale, y, p, c, M, K, N, splits, kt_per_split, stream);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
