// Ragged paged attention with the KV-cache write, hand-written for Hopper
// (sm_90a). Plain C interface, loaded with ctypes by
// agentfield_tpu_torch/ops/cuda/ragged_paged_attention.py.
//
// Replaces: agentfield_tpu/ops/pallas/ragged_paged_attention_kernel.py,
// function _ragged_kernel (launched by ragged_paged_attention_pallas, whose
// dense packing dense_causal_attention also lands here).
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
// is bound by the bytes of cached pages read (each row streams ctx*Kh*hd*2
// values once); long prefill chunks are bound by the 4*q*k*hd FLOPs. This
// simple design reads each page once per (row, KV head, query tile) — once
// for decode — with 16-byte vector loads, but does not overlap loads with
// compute (no cp.async/TMA pipeline) and does the FLOPs on CUDA cores, not
// wgmma; both are work for a later change. PERF.md has its measured times.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;  // threads per CTA
constexpr int KB = 32;   // keys per shared-memory block (one per lane)
constexpr float NEG_INF = -1e30f;
constexpr int NO_KEY = 0x7fffffff;  // key-position marker: slot holds no key

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round-to-nearest-even, like a torch/jax cast
}

struct Args {
  const void* q;       // [R, W, H, HD]
  const void* k_new;   // [R, W, Kh, HD]
  const void* v_new;
  void* k_pages;       // [P, Kh, ps, HD]
  void* v_pages;
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
// fill: p is 0 there, but 0 * garbage could still be NaN).
template <typename T, int HD>
__device__ __forceinline__ void load_keys(const T* __restrict__ ksrc, const T* __restrict__ vsrc,
                                          const long long* src_s, float* k_s, float* v_s) {
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int CPR = HD / VEC;        // chunks per key row
  constexpr int HDP = HD + 1;
  for (int c = threadIdx.x; c < KB * CPR; c += NT) {
    const int j = c / CPR, d0 = (c % CPR) * VEC;
    const long long off = src_s[j];
    float kf[VEC], vf[VEC];
    if (off >= 0) {
      const uint4 kraw = *reinterpret_cast<const uint4*>(ksrc + off + d0);
      const uint4 vraw = *reinterpret_cast<const uint4*>(vsrc + off + d0);
      const T* kt = reinterpret_cast<const T*>(&kraw);
      const T* vt = reinterpret_cast<const T*>(&vraw);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        kf[e] = to_f32(kt[e]);
        vf[e] = to_f32(vt[e]);
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

template <typename T, int HD, int QT>
__global__ void __launch_bounds__(NT) ragged_attention_kernel(Args a) {
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

  // One key block (pos_s/src_s already set): scores, online softmax, P @ V.
  auto process = [&](const T* ksrc, const T* vsrc) {
    __syncthreads();  // pos_s/src_s visible; previous block fully consumed
    load_keys<T, HD>(ksrc, vsrc, src_s, k_s, v_s);
    __syncthreads();
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
    const T* kp_base = reinterpret_cast<const T*>(a.k_pages);
    const T* vp_base = reinterpret_cast<const T*>(a.v_pages);
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
      process(kp_base, vp_base);
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
        process(kn, vn);
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

template <typename T, int HD, int QT>
cudaError_t launch_attention(const Args& a, int n_tiles, cudaStream_t stream) {
  const size_t smem = Smem<HD, QT>::bytes;
  cudaError_t err = cudaFuncSetAttribute(ragged_attention_kernel<T, HD, QT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.R, a.Kh, n_tiles);
  ragged_attention_kernel<T, HD, QT><<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t dispatch_tile(const Args& a, cudaStream_t stream) {
  const int nq = a.W * (a.H / a.Kh);
  if (nq <= 8) return launch_attention<T, HD, 8>(a, 1, stream);
  return launch_attention<T, HD, 64>(a, (nq + 63) / 64, stream);
}

template <typename T>
cudaError_t dispatch_hd(const Args& a, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return dispatch_tile<T, 32>(a, stream);
    case 64: return dispatch_tile<T, 64>(a, stream);
    case 128: return dispatch_tile<T, 128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" const char* afp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16. write_kv: 0 skips phase C (the dense
// packing attends a throwaway pool). Returns cudaGetLastError() after the
// launches (0 = success); a fault during the run surfaces at the next sync.
extern "C" int afp_ragged_paged_attention(
    const void* q, const void* k_new, const void* v_new, void* k_pages, void* v_pages,
    void* out, const void* page_tables, const void* row_starts, const void* n_tokens,
    const void* ctx_lens, const void* seq_ids, int R, int W, int H, int Kh, int ps, int maxp,
    int hd, int dtype, float sm_scale, int window, int write_kv, void* stream_ptr) {
  if (R <= 0 || W <= 0) return (int)cudaSuccess;
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  Args a;
  a.q = q; a.k_new = k_new; a.v_new = v_new; a.k_pages = k_pages; a.v_pages = v_pages;
  a.out = out;
  a.page_tables = static_cast<const int*>(page_tables);
  a.row_starts = static_cast<const int*>(row_starts);
  a.n_tokens = static_cast<const int*>(n_tokens);
  a.ctx_lens = static_cast<const int*>(ctx_lens);
  a.seq_ids = static_cast<const int*>(seq_ids);
  a.R = R; a.W = W; a.H = H; a.Kh = Kh; a.ps = ps; a.maxp = maxp;
  a.sm_scale = sm_scale; a.window = window;
  cudaError_t err;
  if (dtype == 0) err = dispatch_hd<float>(a, hd, stream);
  else if (dtype == 1) err = dispatch_hd<__nv_bfloat16>(a, hd, stream);
  else return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess || !write_kv) return (int)err;
  if (dtype == 0) kv_write_kernel<float><<<R * W, NT, 0, stream>>>(a, hd);
  else kv_write_kernel<__nv_bfloat16><<<R * W, NT, 0, stream>>>(a, hd);
  return (int)cudaGetLastError();
}
