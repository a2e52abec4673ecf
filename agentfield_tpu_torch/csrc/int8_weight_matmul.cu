// Weight-only int8 matrix product, hand-written for Hopper (sm_90a). Plain C
// interface, loaded with ctypes by agentfield_tpu_torch/ops/cuda/quant_matmul.py.
//
//   y[M, N] = (x[M, K] @ q[K, N]) * scale[N]
//
// x and y are bf16 or f32 (the same type), q is int8, scale is f32, and the
// sum is taken in f32. This is the port's implementation of
// agentfield_tpu/models/quant.py's QuantW.__rmatmul__, per-output-channel
// symmetric int8 weights. It has no Pallas twin: on the TPU, XLA folds the
// int8 -> bf16 convert into the dot's operand read. q is read once, as int8,
// and widened in registers; no widened copy of q is ever written to device
// memory.
//
// What bounds it on the card (H100 SXM: 3.35 TB/s HBM, 989 TFLOP/s bf16 on
// the tensor cores, 132 SMs of 227 KB shared memory). At decode widths (M <=
// 64) a product reads K * N bytes of q for M * K * N * 2 FLOPs, about M FLOPs
// a byte where the card needs ~295 to be bound by operations: the bytes of q
// bound it, and the design's job is to keep every SM's share of them in
// flight. A prefill chunk (M in the hundreds or thousands) is bound by the
// tensor cores, and the job there is to feed wgmma at a shape where it runs
// near its peak while each q byte is widened once per CTA.
//
// The packed layout (ops/cuda/quant_matmul.py's pack_int8_weight makes it
// once, when the weight is quantized or carried to the card). q[K, N] is cut
// into panels of 64 output columns; panel p holds its K rows in chunks of 32,
// each chunk 2048 bytes: 128 threads x 16 bytes. Thread T of a consumer
// warpgroup (warp w = T / 32, lane g = (T % 32) / 4, t = T % 4) finds at
// byte 8 s + 2 r + e of its 16 (k16 step s in {0, 1}, register r in 0..3,
// half e in {0, 1}) the weight
//   q[k = 32 kc + 16 s + 2 t + e + 8 (r / 2), n = 64 p + 16 w + g + 8 (r % 2)]
// which is the wgmma A fragment of a 64 x 16 bf16 tile (rows = the panel's
// output columns, cols = k) for register r, half e. So a thread reads two
// k16 steps with one conflict-free 16-byte shared-memory load (a warp's 512
// contiguous bytes), and a ring stage of a panel (64 K rows, 4096 bytes) is
// one contiguous run of global memory that one cp.async.bulk brings in. K is
// padded to 64 and N to 64 with zero weights where a width needs it (no
// preset's Llama-3-8B width does).
//
// The product as y^T = q^T . x^T on wgmma (bf16 x). A = the panel's q^T tile
// from registers: each consumer thread widens its own 8 bytes a k16 step
// (int8 -> bf16 is exact: bias the byte to unsigned, place it in the mantissa
// of 2^23, subtract 2^23 + 128 in f32, keep the upper half). B = x's tile in
// shared memory, K-major with the 128-byte swizzle, brought by a TMA tensor
// map (rows past M and columns past K arrive as zeros). wgmma's N is x's row
// count rounded up to 8 (NX = 8 ... 64 at decode widths, so x pads at most 7
// rows; 128 or 256 in prefill). The accumulators stay f32 in registers.
// Roles: CW consumer warpgroups, one 64-column panel each, and one producer
// warp whose lane 0 issues, per ring stage, one bulk copy per panel and one
// TMA load of x per 64-row K tile, on a full mbarrier whose expect_tx is
// exactly those bytes; each consumer warpgroup arrives on the stage's empty
// mbarrier once the wgmma group that read it has retired.
//   decode widths (NX <= 64): a stage holds two K tiles (8 KB of a panel),
//     its 8 k16 steps one commit group; the consumer widens stage i + 1 into
//     the other of two register sets while stage i's group runs (wgmma.fence
//     before each group; a set is rewritten only after wgmma.wait_group 1
//     retired the group that read it). A ring of 100 KB leaves room for two
//     CTAs an SM. A split's odd last tile reads x out of bounds (zeros), so
//     every stage runs the same wgmma sequence.
//   prefill (NX 128, 256): a stage holds one K tile; each k16 step is its own
//     commit group, the next step widened into the other of two 4-register
//     sets while it runs (two whole stages of registers do not fit beside
//     128 accumulators); a ring of 200 KB, one CTA an SM.
// The kernel is launched as a programmatic dependent of the kernel before
// it: the producer issues the first ring pass of weights, which no earlier
// kernel writes, then waits (griddepcontrol.wait) before it loads x; every
// CTA lets the next kernel launch as soon as it has started.
//
// The split. A CTA owns CW panels, NX rows of x and one of `splits` K ranges.
// The splits of a tile form one thread-block cluster (grid x = the split, at
// most 8): each CTA leaves its partial tile in its own shared memory, and
// after a cluster barrier every CTA sums a 1/splits slice of the tile's rows
// over all the cluster's partials through distributed shared memory, in rank
// order (the same sum on every run), scales it and writes y with 16-byte
// stores. So a product is always one launch and needs no workspace and no
// counters. ops/cuda/quant_matmul.py's plan picks NX, CW and the split per
// (M bucket, K, N).
//
// f32 x (no served path; the JAX package's f32 forward): a CTA of 4 warps
// takes one panel and 32 rows of x, reads its q fragments straight from the
// packed layout in global memory (the same map: one 16-byte load a thread
// per 32 K rows) and runs mma.sync.m16n8k16 with x split into three bf16
// parts, hi + mid + lo == x exactly, so every product of a part and an int8
// weight is exact in f32. The tensor core's f32 accumulation is not
// round-to-nearest, so each 16-row step is summed there from zero and added
// to the running sum by an IEEE f32 add (measured on the card:
// summed over all of K in the tensor core, the full-width f32 logits missed
// 1e-4 of their max against the plain version).

#include <cuda.h>  // CUtensorMap and its enums (types only: the encoder comes from the runtime)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BK = 64;            // K rows of a ring stage (one 128-byte row of bf16 x)
constexpr int PANEL = 64;         // output columns of a panel: wgmma's M
constexpr int KC_BYTES = 2048;    // 32 K rows of a panel: 128 threads x 16 bytes
constexpr int PANEL_STAGE = 4096; // a panel's 64 K rows, contiguous in the packed layout
constexpr int MAX_SPLITS = 8;     // a portable cluster

// ---------------------------------------------------------------------------
// PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// spin until the phase of parity `parity` has completed; a wait that never
// ends (a broken pipeline) traps, a launch error, instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}
// bytes of global memory into shared memory, counted on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// a 2-D box of a tensor map into shared memory, counted on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}
// 8 floats of CTA `rank`'s shared memory at the local address `addr`
__device__ __forceinline__ void ld_cluster8(uint32_t addr, int rank, float* v) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(rank));
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3])
               : "r"(remote)
               : "memory");
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v[4]), "=f"(v[5]), "=f"(v[6]), "=f"(v[7])
               : "r"(remote + 16)
               : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving accesses of a register across a wgmma
__device__ __forceinline__ void reg_fence(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void reg_fence(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }

// wgmma's shared-memory descriptor of a K-major tile with the 128-byte
// swizzle: 8-row groups 1024 bytes apart (the stride byte offset), the
// leading byte offset unused; `saddr` advances 32 bytes a k16 step.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// D (64 x N f32) += A (64 x 16 bf16, registers) * B (16 x N bf16, shared-memory
// descriptor, K-major). d[4 j + 2 h + e] is D[16 w + g + 8 h][8 j + 2 t + e].
template <int N> struct WG;
template <> struct WG<8> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3"
        "}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};
template <> struct WG<16> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};
template <> struct WG<24> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11"
        "}, {%12, %13, %14, %15}, %16, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};
template <> struct WG<32> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};
template <> struct WG<40> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19"
        "}, {%20, %21, %22, %23}, %24, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};
template <> struct WG<48> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23"
        "}, {%24, %25, %26, %27}, %28, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};
template <> struct WG<56> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %33, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n56k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27"
        "}, {%28, %29, %30, %31}, %32, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};
template <> struct WG<64> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};
template <> struct WG<128> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};
template <> struct WG<256> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

// Four biased int8 weights of a word as two bf16 pairs: bytes 0, 1 -> lo
// (byte 0 in the low half), bytes 2, 3 -> hi. Exact.
__device__ __forceinline__ void widen4(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;  // v + 128
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.0f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.0f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.0f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.0f;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}
// a thread's 16 bytes of a 32-row chunk: the A registers of two k16 steps
__device__ __forceinline__ void widen16(uint4 v, uint32_t (&s0)[4], uint32_t (&s1)[4]) {
  widen4(v.x, s0[0], s0[1]);
  widen4(v.y, s0[2], s0[3]);
  widen4(v.z, s1[0], s1[1]);
  widen4(v.w, s1[2], s1[3]);
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

// ---------------------------------------------------------------------------
// bf16 x: wgmma

template <int NX, int CW> struct Cfg {
  static constexpr int THREADS = 128 * CW + 32;  // consumer warpgroups, then the producer warp
  // 64-row K tiles a ring stage: two at decode widths (half the barrier and
  // fence work a byte), one in prefill (registers)
  static constexpr int KT = NX > 64 ? 1 : 2;
  static constexpr int Q_STAGE = CW * KT * PANEL_STAGE;  // a panel's KT tiles, contiguous
  static constexpr int X_TILE = NX * 128;  // NX rows of 64 bf16, 128-byte swizzled
  static constexpr int X_STAGE = KT * X_TILE;
  static constexpr int STAGE = Q_STAGE + X_STAGE;
  // decode widths: two CTAs an SM; prefill tiles: one
  static constexpr int BUDGET = NX > 64 ? 200 * 1024 : 100 * 1024;
  static constexpr int STAGES = BUDGET / STAGE > 16 ? 16 : BUDGET / STAGE;
  static constexpr int RED_PITCH = PANEL * CW + 4;  // floats a row of the partial tile
  static constexpr int RED = NX * RED_PITCH * 4;
  static constexpr int DATA = STAGES * STAGE > RED ? STAGES * STAGE : RED;
  static constexpr int SMEM = DATA + 2 * STAGES * 8 + 1024;  // + mbarriers + 1024-byte alignment
  static_assert(STAGES >= 2, "ring too small");
  static_assert(SMEM <= 232448, "shared memory");
};

// One CTA: panels blockIdx.y * CW .. + CW - 1, rows blockIdx.z * NX .. + NX - 1
// of x, K tiles of split blockIdx.x (a cluster of gridDim.x CTAs).
template <int NX, int CW>
__global__ void __launch_bounds__(Cfg<NX, CW>::THREADS, 1)
w8_wgmma_kernel(const __grid_constant__ CUtensorMap xmap, const int8_t* __restrict__ qp,
                const float* __restrict__ scale, bf16* __restrict__ y, int M, int N, int Kp,
                int kt_per_split) {
  using C = Cfg<NX, CW>;
  constexpr int STAGES = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* xs = smem;                      // STAGES x X_STAGE, 1024-aligned
  unsigned char* qs = smem + STAGES * C::X_STAGE;  // STAGES x Q_STAGE
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::DATA);
  uint64_t* empty = full + STAGES;

  const int split = blockIdx.x, splits = gridDim.x;
  const int group = blockIdx.y;
  const int m0 = blockIdx.z * NX;
  const int panels = (N + PANEL - 1) / PANEL;
  const int live = min(CW, panels - group * CW);  // this CTA's panels that exist
  const int nkt = Kp / BK;
  const int kt0 = split * kt_per_split;
  const int ntiles = max(min(kt0 + kt_per_split, nkt) - kt0, 0);
  const int nstages = (ntiles + C::KT - 1) / C::KT;  // stage i: K tiles kt0 + KT i ...
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], live);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // a kernel launched after this one may start its prologue (its weights)
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  }
  __syncthreads();

  float acc[NX / 2];
#pragma unroll
  for (int i = 0; i < NX / 2; ++i) acc[i] = 0.f;
  const int c = warp >> 2;  // consumer warpgroup (CW = the producer warp)

  if (c == CW) {
    if (lane == 0) {
      auto tiles = [&](int i) { return min(C::KT, ntiles - C::KT * i); };
      auto load_q = [&](int i) {  // the stage's expected bytes, then its weights
        const int s = i % STAGES, nk = tiles(i);
        mbar_expect_tx(&full[s], nk * live * PANEL_STAGE + C::X_STAGE);
        for (int p = 0; p < live; ++p)
          bulk_copy(qs + s * C::Q_STAGE + p * C::KT * PANEL_STAGE,
                    qp + ((long long)(group * CW + p) * nkt + kt0 + C::KT * i) * PANEL_STAGE,
                    nk * PANEL_STAGE, &full[s]);
      };
      // x's tiles of a stage; a tile past the split's last (the final stage
      // of an odd count) is read wholly out of bounds, so it arrives as zeros
      // and the consumers multiply whatever q the slot holds by 0: every
      // stage runs the same wgmma sequence (no divergent path)
      auto load_x = [&](int i) {
        const int s = i % STAGES, nk = tiles(i);
        for (int j = 0; j < C::KT; ++j)
          tma_load_2d(xs + s * C::X_STAGE + j * C::X_TILE, &xmap,
                      j < nk ? (kt0 + C::KT * i + j) * BK : Kp, m0, &full[s]);
      };
      // The weights depend on no earlier kernel: the first ring pass of them
      // is in flight before the wait for the kernel that wrote x (a no-op
      // unless this launch is a programmatic dependent of it).
      const int pre = min(STAGES, nstages);
      for (int i = 0; i < pre; ++i) load_q(i);
      asm volatile("griddepcontrol.wait;\n" ::: "memory");
      for (int i = 0; i < pre; ++i) load_x(i);
      for (int i = pre; i < nstages; ++i) {
        mbar_wait(&empty[i % STAGES], ((i / STAGES) & 1) ^ 1);
        load_q(i);
        load_x(i);
      }
    }
  } else if (c < live && C::KT > 1) {
    // decode widths: a stage's 4 KT k16 steps are one commit group; the next
    // stage is widened into the other register set while it runs
    constexpr int STEPS = 4 * C::KT;  // k16 steps a stage
    const unsigned char* qbase = qs + c * C::KT * PANEL_STAGE + (tid & 127) * 16;
    uint32_t a0[STEPS][4], a1[STEPS][4];  // two register sets: [k16 step][register]
    auto issue = [&](uint32_t(&a)[STEPS][4], int i) {
      const int s = i % STAGES;
#pragma unroll
      for (int j = 0; j < C::KT; ++j) {
        const unsigned char* qt = qbase + s * C::Q_STAGE + j * PANEL_STAGE;
        widen16(*reinterpret_cast<const uint4*>(qt), a[4 * j], a[4 * j + 1]);
        widen16(*reinterpret_cast<const uint4*>(qt + KC_BYTES), a[4 * j + 2], a[4 * j + 3]);
      }
#pragma unroll
      for (int k = 0; k < STEPS; ++k)
#pragma unroll
        for (int r = 0; r < 4; ++r) reg_fence(a[k][r]);
#pragma unroll
      for (int k = 0; k < NX / 2; ++k) reg_fence(acc[k]);
      wgmma_fence();
      const uint32_t xb = smem_u32(xs + s * C::X_STAGE);
#pragma unroll
      for (int j = 0; j < C::KT; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          WG<NX>::mma(acc, a[4 * j + k], desc_sw128(xb + j * C::X_TILE + 32 * k));
      wgmma_commit();
#pragma unroll
      for (int k = 0; k < NX / 2; ++k) reg_fence(acc[k]);
    };
    auto retire_previous = [&](int i) {  // stage i - 1's group has retired: free its slot
      wgmma_wait<1>();
      if (i > 0 && (tid & 127) == 0) mbar_arrive(&empty[(i - 1) % STAGES]);
    };
    int i = 0;
    for (; i + 1 < nstages; i += 2) {
      mbar_wait(&full[i % STAGES], (i / STAGES) & 1);
      issue(a0, i);
      retire_previous(i);
      mbar_wait(&full[(i + 1) % STAGES], ((i + 1) / STAGES) & 1);
      issue(a1, i + 1);
      retire_previous(i + 1);
    }
    if (i < nstages) {
      mbar_wait(&full[i % STAGES], (i / STAGES) & 1);
      issue(a0, i);
      retire_previous(i);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int k = 0; k < NX / 2; ++k) reg_fence(acc[k]);
  } else if (c < live) {
    // prefill tiles: each k16 step is a commit group of one wgmma (N = 128
    // or 256), the next step widened into the other of two small register
    // sets while it runs (the registers of two whole stages would not fit
    // beside the accumulators)
    const unsigned char* qbase = qs + c * PANEL_STAGE + (tid & 127) * 16;
    uint32_t s0[4], s1[4];
    for (int i = 0; i < nstages; ++i) {
      const int s = i % STAGES;
      mbar_wait(&full[s], (i / STAGES) & 1);
      const uint4 v0 = *reinterpret_cast<const uint4*>(qbase + s * C::Q_STAGE);
      const uint4 v1 = *reinterpret_cast<const uint4*>(qbase + s * C::Q_STAGE + KC_BYTES);
      const uint32_t xb = smem_u32(xs + s * C::X_STAGE);
      auto step = [&](uint32_t(&a)[4], uint32_t lo, uint32_t hi, int k) {
        widen4(lo, a[0], a[1]);
        widen4(hi, a[2], a[3]);
#pragma unroll
        for (int r = 0; r < 4; ++r) reg_fence(a[r]);
#pragma unroll
        for (int j = 0; j < NX / 2; ++j) reg_fence(acc[j]);
        wgmma_fence();
        WG<NX>::mma(acc, a, desc_sw128(xb + 32 * k));
        wgmma_commit();
#pragma unroll
        for (int j = 0; j < NX / 2; ++j) reg_fence(acc[j]);
        wgmma_wait<1>();  // the step before this one has retired: its set is free
      };
      step(s0, v0.x, v0.y, 0);
      if (i > 0 && (tid & 127) == 0) mbar_arrive(&empty[(i - 1) % STAGES]);  // its last step retired
      step(s1, v0.z, v0.w, 1);
      step(s0, v1.x, v1.y, 2);
      step(s1, v1.z, v1.w, 3);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int k = 0; k < NX / 2; ++k) reg_fence(acc[k]);
  }

  // Epilogue. The ring is done (every consumer retired its groups, every
  // load was consumed): the partial tile takes its place, [NX rows of x][CW
  // panels' columns] in f32.
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
  if (c < live) {
    const int w = warp & 3, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < NX / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          red[(8 * j + 2 * t + e) * C::RED_PITCH + c * PANEL + 16 * w + g + 8 * h] =
              acc[4 * j + 2 * h + e];
  }
  if (splits > 1)
    cluster_sync();
  else
    __syncthreads();
  // this CTA sums rows [r0, r1) of the tile over the cluster's partials, in
  // rank order, 8 columns a thread
  constexpr int CHUNKS = CW * PANEL / 8;
  const int r0 = split * NX / splits, r1 = (split + 1) * NX / splits;
  const int n_base = group * CW * PANEL;
  for (int e = tid; e < (r1 - r0) * CHUNKS; e += C::THREADS) {
    const int row = r0 + e / CHUNKS, col = (e % CHUNKS) * 8;
    const int m = m0 + row, n = n_base + col;
    if (m >= M || n >= N) continue;
    float v[8];
    const float* own = red + row * C::RED_PITCH + col;
    if (splits == 1) {
      const float4 lo = *reinterpret_cast<const float4*>(own);
      const float4 hi = *reinterpret_cast<const float4*>(own + 4);
      v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
      v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
    } else {
      ld_cluster8(smem_u32(own), 0, v);
      for (int rk = 1; rk < splits; ++rk) {
        float u[8];
        ld_cluster8(smem_u32(own), rk, u);
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] += u[k];
      }
    }
    const float4 s0 = *reinterpret_cast<const float4*>(scale + n);
    const float4 s1 = *reinterpret_cast<const float4*>(scale + n + 4);
    uint4 o;
    o.x = bf16x2_bits(__floats2bfloat162_rn(v[0] * s0.x, v[1] * s0.y));
    o.y = bf16x2_bits(__floats2bfloat162_rn(v[2] * s0.z, v[3] * s0.w));
    o.z = bf16x2_bits(__floats2bfloat162_rn(v[4] * s1.x, v[5] * s1.y));
    o.w = bf16x2_bits(__floats2bfloat162_rn(v[6] * s1.z, v[7] * s1.w));
    *reinterpret_cast<uint4*>(y + (long long)m * N + n) = o;
  }
  if (splits > 1) cluster_sync();  // no CTA leaves while another reads its partial
}

// ---------------------------------------------------------------------------
// f32 x: mma.sync on three bf16 parts of x

constexpr int F32_ROWS = 32;  // rows of x a CTA

__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// x = hi + mid + lo exactly, each a bf16 pair
__device__ __forceinline__ void split3(float2 v, uint32_t (&p)[3]) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
  const float2 hf = __bfloat1622float2(h);
  const float2 r1 = make_float2(v.x - hf.x, v.y - hf.y);
  const __nv_bfloat162 m = __floats2bfloat162_rn(r1.x, r1.y);
  const float2 mf = __bfloat1622float2(m);
  const __nv_bfloat162 l = __floats2bfloat162_rn(r1.x - mf.x, r1.y - mf.y);
  p[0] = bf16x2_bits(h);
  p[1] = bf16x2_bits(m);
  p[2] = bf16x2_bits(l);
}

// One CTA of 4 warps: panel blockIdx.x (warp w its rows 16 w .. 16 w + 15),
// rows blockIdx.y * F32_ROWS .. of x, over all of K.
__global__ void __launch_bounds__(128)
w8_f32_kernel(const float* __restrict__ x, const int8_t* __restrict__ qp,
              const float* __restrict__ scale, float* __restrict__ y, int M, int K, int N, int Kp) {
  __shared__ __align__(16) float xs[F32_ROWS][32 + 4];
  const int panel = blockIdx.x, m0 = blockIdx.y * F32_ROWS;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int nkc = Kp / 32;
  const int8_t* qsrc = qp + (long long)panel * nkc * KC_BYTES + tid * 16;
  float acc[F32_ROWS / 8][4];
#pragma unroll
  for (int j = 0; j < F32_ROWS / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  uint4 next = __ldg(reinterpret_cast<const uint4*>(qsrc));
  for (int kc = 0; kc < nkc; ++kc) {
    __syncthreads();  // the previous chunk's x is read
    for (int e = tid; e < F32_ROWS * 8; e += 128) {
      const int row = e >> 3, c4 = (e & 7) * 4;
      const int gm = m0 + row, gk = kc * 32 + c4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gm < M && gk < K) v = *reinterpret_cast<const float4*>(x + (long long)gm * K + gk);
      *reinterpret_cast<float4*>(&xs[row][c4]) = v;
    }
    __syncthreads();
    const uint4 cur = next;
    if (kc + 1 < nkc) next = __ldg(reinterpret_cast<const uint4*>(qsrc + (kc + 1) * KC_BYTES));
    uint32_t a[2][4];
    widen16(cur, a[0], a[1]);
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int j = 0; j < F32_ROWS / 8; ++j) {
        uint32_t b0[3], b1[3];
        split3(*reinterpret_cast<const float2*>(&xs[8 * j + g][16 * s + 2 * t]), b0);
        split3(*reinterpret_cast<const float2*>(&xs[8 * j + g][16 * s + 2 * t + 8]), b1);
        float step[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int p = 0; p < 3; ++p) mma16816(step, a[s], b0[p], b1[p]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] += step[e];
      }
  }
  // acc[j][2 h + e] = D[n = 16 w + g + 8 h][m = 8 j + 2 t + e]
#pragma unroll
  for (int j = 0; j < F32_ROWS / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = m0 + 8 * j + 2 * t + e, n = panel * PANEL + 16 * w + g + 8 * h;
        if (m < M && n < N) y[(long long)m * N + n] = acc[j][2 * h + e] * scale[n];
      }
}

// ---------------------------------------------------------------------------
// host side

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
EncodeTiled encode_tiled = nullptr;

template <int NX, int CW> cudaError_t allow_smem() {
  return cudaFuncSetAttribute(w8_wgmma_kernel<NX, CW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              Cfg<NX, CW>::SMEM);
}

template <int NX, int CW>
cudaError_t launch_wgmma(const CUtensorMap& map, const void* qp, const void* scale, void* y, int M,
                         int N, int Kp, int splits, int kt_per_split, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, ((N + PANEL - 1) / PANEL + CW - 1) / CW, (M + NX - 1) / NX);
  cfg.blockDim = dim3(Cfg<NX, CW>::THREADS);
  cfg.dynamicSmemBytes = Cfg<NX, CW>::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  // a programmatic dependent of the kernel before it: the weights stream in
  // while that kernel drains (x is read after griddepcontrol.wait)
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  return cudaLaunchKernelEx(&cfg, w8_wgmma_kernel<NX, CW>, map,
                            static_cast<const int8_t*>(qp), static_cast<const float*>(scale),
                            static_cast<bf16*>(y), M, N, Kp, kt_per_split);
}

// every (NX, CW) instance: X(NX, CW)
#define W8_INSTANCES(X)                                                                        \
  X(8, 1) X(16, 1) X(24, 1) X(32, 1) X(40, 1) X(48, 1) X(56, 1) X(64, 1)                       \
  X(128, 1) X(128, 2) X(256, 1) X(256, 2)

}  // namespace

extern "C" const char* w8_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Once per device, before its first launch and outside any CUDA graph
// capture: raise every instance's shared-memory limit and resolve the
// tensor-map encoder (cuTensorMapEncodeTiled). Returns a cudaError_t (0 = success).
extern "C" int w8_setup() {
  cudaError_t err;
#define W8_ALLOW(NX, CW) \
  if ((err = allow_smem<NX, CW>()) != cudaSuccess) return (int)err;
  W8_INSTANCES(W8_ALLOW)
#undef W8_ALLOW
  if (encode_tiled == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault,
                                           &found);
#else
    err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return (int)cudaErrorNotSupported;
    encode_tiled = reinterpret_cast<EncodeTiled>(fn);
  }
  return (int)cudaSuccess;
}

// x [M, K] and y [M, N]: dtype 0 = float32, 1 = bfloat16; qp the packed
// weight of q [K, N] (Kp = K rounded up to 64, N padded to 64 columns; see
// the note at the top); scale [N] f32; all contiguous and 16-byte aligned,
// K a multiple of 16 and N of 8. bf16: the wgmma kernel instance (nx, cw)
// over `splits` K ranges of kt_per_split 64-row tiles each (a cluster of
// splits CTAs, at most 8); f32 ignores nx, cw and the split. Returns
// cudaGetLastError() after the launch (0 = success); a fault during the run
// surfaces at the next sync. Anything it does not take returns
// cudaErrorInvalidValue, and a launch before w8_setup cudaErrorInitializationError.
extern "C" int w8_matmul(const void* x, const void* qp, const void* scale, void* y, int M, int K,
                         int N, int Kp, int dtype, int nx, int cw, int splits, int kt_per_split,
                         void* stream_ptr) {
  if (M <= 0) return (int)cudaSuccess;
  const int nkt = Kp / BK;
  if (K <= 0 || K % 16 || N <= 0 || N % 8 || Kp != (K + BK - 1) / BK * BK ||
      ((uintptr_t)x | (uintptr_t)qp | (uintptr_t)scale | (uintptr_t)y) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  if (dtype == 0) {
    const dim3 grid((N + PANEL - 1) / PANEL, (M + F32_ROWS - 1) / F32_ROWS);
    w8_f32_kernel<<<grid, 128, 0, stream>>>(static_cast<const float*>(x),
                                            static_cast<const int8_t*>(qp),
                                            static_cast<const float*>(scale),
                                            static_cast<float*>(y), M, K, N, Kp);
    return (int)cudaGetLastError();
  }
  if (dtype != 1 || splits < 1 || splits > MAX_SPLITS || kt_per_split < 1 ||
      (long long)splits * kt_per_split < nkt || (long long)(splits - 1) * kt_per_split >= nkt)
    return (int)cudaErrorInvalidValue;
  if (encode_tiled == nullptr) return (int)cudaErrorInitializationError;
  // x as a [M, K] bf16 tensor map: boxes of 64 columns (128 bytes) x nx
  // rows, 128-byte swizzle; rows past M and columns past K read as zeros
  CUtensorMap map;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t strides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)nx};
  const cuuint32_t elem[2] = {1, 1};
  if (nx < 8 || nx > 256 ||
      encode_tiled(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x), dims, strides,
                   box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaErrorInvalidValue;
#define W8_LAUNCH(NX, CW)                                                                     \
  if (nx == NX && cw == CW)                                                                   \
    err = launch_wgmma<NX, CW>(map, qp, scale, y, M, N, Kp, splits, kt_per_split, stream);
  W8_INSTANCES(W8_LAUNCH)
#undef W8_LAUNCH
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
