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
// cached key row on load, value * its slot's scale in f32, as the TPU kernel
// does; phase B reads k_new/v_new unquantized (same-launch keys never
// round-trip the pool). Phase C quantizes each written (token, KV head) row
// with kv_quantize's formula, one warp per row: max |x| over hd by shuffles
// (order-independent, so exact), scale = max(max * f32(1/QMAX), 1e-20), an
// IEEE division x / scale (__fdiv_rn: the build never sets fast math), then
// round half to even and clamp to +-127 (int8) or a round-to-nearest-even
// cast to e4m3 (fp8). Every step is the plain version's, so the pool bytes
// and scales equal kv_quantize's bit for bit.
//
// Design. One CTA of 128 threads per (row r, KV head, query tile). The TPU
// program holds all W*rep query rows of a (row, KV head) in VMEM; at W=256,
// rep=4, hd=128 that is 512 KB of f32, more than a block's 227 KB of shared
// memory, so query rows are tiled (QT = 64, or 8 for decode-shaped rows).
// Keys stream through shared memory 32 at a time (one key per lane in the
// softmax pass); the running max/sum live in shared memory and the output
// accumulator in registers (QT*HD/128 floats per thread). All arithmetic is
// f32 on the CUDA cores; bf16 inputs are widened on load. Phase C is a second
// launch on the same stream after the attention launch: attention reads only
// cached positions < ctx <= row_starts, which no token of the launch writes,
// so the final pool bytes equal the TPU kernel's copy-then-patch.
//
// Bound on the H100 (3.35 TB/s HBM, 989 TFLOP/s bf16 tensor cores): decode
// is bound by the bytes of cached pages read (each row streams ctx*Kh*hd
// values of K and of V once: 2 bytes each in bf16, 1 plus 4 bytes of scale
// per slot when quantized); long prefill chunks are bound by the 4*q*k*hd
// FLOPs. This
// simple design reads each page once per (row, KV head, query tile) — once
// for decode — with 16-byte vector loads, but does not overlap loads with
// compute (no cp.async/TMA pipeline) and does the FLOPs on CUDA cores, not
// wgmma; both are work for a later change. PERF.md has its measured times.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NT = 128;  // threads per CTA
constexpr int KB = 32;   // keys per shared-memory block (one per lane)
constexpr float NEG_INF = -1e30f;
constexpr int NO_KEY = 0x7fffffff;  // key-position marker: slot holds no key

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
  int R, W, H, Kh, ps, maxp;
  float sm_scale;
  int window;  // 0 = no sliding window
};

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

template <typename T, typename PT, int HD, int QT>
cudaError_t launch_attention(const Args& a, int n_tiles, cudaStream_t stream) {
  const size_t smem = Smem<HD, QT>::bytes;
  cudaError_t err = cudaFuncSetAttribute(ragged_attention_kernel<T, PT, HD, QT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.R, a.Kh, n_tiles);
  ragged_attention_kernel<T, PT, HD, QT><<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, typename PT, int HD>
cudaError_t dispatch_tile(const Args& a, cudaStream_t stream) {
  const int nq = a.W * (a.H / a.Kh);
  if (nq <= 8) return launch_attention<T, PT, HD, 8>(a, 1, stream);
  return launch_attention<T, PT, HD, 64>(a, (nq + 63) / 64, stream);
}

// Attention for head_dim hd, then (write_kv) phase C on the same stream.
template <typename T, typename PT>
cudaError_t run(const Args& a, int hd, int write_kv, cudaStream_t stream) {
  cudaError_t err;
  switch (hd) {
    case 32: err = dispatch_tile<T, PT, 32>(a, stream); break;
    case 64: err = dispatch_tile<T, PT, 64>(a, stream); break;
    case 128: err = dispatch_tile<T, PT, 128>(a, stream); break;
    default: return cudaErrorInvalidValue;
  }
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
cudaError_t run_pool(const Args& a, int hd, int own_code, int pool_dtype, int write_kv,
                     cudaStream_t stream) {
  const bool scaled = a.k_scales != nullptr && a.v_scales != nullptr;
  const bool unscaled = a.k_scales == nullptr && a.v_scales == nullptr;
  if (pool_dtype == own_code && unscaled) return run<T, T>(a, hd, write_kv, stream);
  if (pool_dtype == 2 && scaled) return run<T, int8_t>(a, hd, write_kv, stream);
  if (pool_dtype == 3 && scaled) return run<T, __nv_fp8_e4m3>(a, hd, write_kv, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" const char* afp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype (q, new K/V, out): 0 = float32, 1 = bfloat16. pool_dtype: the same
// code for a plain pool (k_scales = v_scales = null), or 2 = int8, 3 =
// float8_e4m3fn with per-slot f32 scales [P, Kh, ps]; any other combination
// returns cudaErrorInvalidValue. write_kv: 0 skips phase C (the dense
// packing attends a throwaway pool). Returns cudaGetLastError() after the
// launches (0 = success); a fault during the run surfaces at the next sync.
extern "C" int afp_ragged_paged_attention(
    const void* q, const void* k_new, const void* v_new, void* k_pages, void* v_pages,
    void* k_scales, void* v_scales, void* out, const void* page_tables, const void* row_starts,
    const void* n_tokens, const void* ctx_lens, const void* seq_ids, int R, int W, int H,
    int Kh, int ps, int maxp, int hd, int dtype, int pool_dtype, float sm_scale, int window,
    int write_kv, void* stream_ptr) {
  if (R <= 0 || W <= 0) return (int)cudaSuccess;
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
  a.R = R; a.W = W; a.H = H; a.Kh = Kh; a.ps = ps; a.maxp = maxp;
  a.sm_scale = sm_scale; a.window = window;
  if (dtype == 0) return (int)run_pool<float>(a, hd, 0, pool_dtype, write_kv, stream);
  if (dtype == 1) return (int)run_pool<__nv_bfloat16>(a, hd, 1, pool_dtype, write_kv, stream);
  return (int)cudaErrorInvalidValue;
}
