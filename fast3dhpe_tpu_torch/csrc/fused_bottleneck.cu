// Fused eval-mode ResNet Bottleneck for Hopper (sm_90a), bf16 in and out.
//
// Replaces fast3dhpe_tpu/ops/pallas_bottleneck.py `_bottleneck_kernel`
// (pallas_call at :191, in `fused_bottleneck`): one stride-1 block
//   1x1 conv + BN + relu -> 3x3 conv (pad 1) + BN + relu -> 1x1 conv + BN
//   -> + residual (identity, or 1x1 downsample + BN) -> relu
// with BN folded to per-channel (scale, bias) and the weights packed once
// per weight version by the caller (ops/bottleneck.py pack_weights). It
// rounds where the TPU kernel rounds: h1, h2, h3 and the downsampled
// residual are bf16, every product sums in fp32, and the residual add
// happens in bf16. Off the image h1 is 0 (the TPU kernel zero-pads h1, not
// x).
//
// What bounds it on the H100 (989 TFLOP/s bf16, 3.35 TB/s): at 64 images
// layer1.0 (Cin 64, P 64, Cout 256, downsample, 64x64) moves 168 MB, 0.050
// ms, and does 38.7 GFLOP, 0.039 ms; layer2.x (Cin 512, P 128, Cout 512,
// 32x32) moves 134 MB, 0.040 ms, and does 36.5 GFLOP, 0.037 ms. Both sit
// near the ridge, so half the bound needs most of the tensor cores' rate,
// and the weights, which every tile reads again, must not flood the L2.
// Device memory sees x once (plus the halo) and the output once; h1, h2
// and the residual stay on chip. What the design does about it:
//   - products: four implicit GEMMs a tile, all on wgmma.mma_async
//     m64nNk16 (bf16 -> fp32), issued by two consumer warpgroups with both
//     operands read from shared memory through descriptors. conv1 runs
//     over the tile's halo (M = the halo's pixels), conv2 as 9 taps x P
//     (M = the tile's pixels), then per pass of kN3 output channels the
//     downsample (K = Cin) and conv3 (K = P);
//   - loads: TMA with mbarriers. One producer warp walks the CTA's whole
//     schedule of 64-deep K chunks and keeps them in flight: a ring of
//     kXStages x chunks (conv1's halo box, the downsample's 8x8 boxes, the
//     identity residual's boxes) and a ring of kWStages weight chunks, each
//     arriving in wgmma's 128-byte swizzled layout. The halo is one 4-D box
//     over NHWC starting at (y0 - 1, x0 - 1): TMA fills what lies off the
//     image with zeros, so negative, ragged and overhanging tiles need no
//     masking on the load; h1 is set to 0 off the image in conv1's
//     epilogue. A stage is freed by an mbarrier arrival once the wgmma that
//     read it completed, so no K chunk waits for a block-wide barrier;
//   - persistent CTAs: at most one cluster for every two SMs (all of them
//     resident), each walking pairs of tiles, so the producer loads the
//     next tile's first halo chunks while the current tile finishes;
//   - conv2's shifted windows: h1 is stored in wgmma's unswizzled core-
//     matrix layout ([8-channel group][halo pixel][8 channels]), where the
//     window of tap (ky, kx) over an 8x8 block of output pixels is a plain
//     descriptor offset of ky * (kTW + 2) + kx pixels (8-row groups one
//     halo row apart), so no im2col copy is made. Each warpgroup owns one
//     8x8 block (M = 64) of the 8x16 tile;
//   - the weights' L2 traffic: the two CTAs of a thread-block cluster (two
//     neighbouring tiles) share one weight stream, each loading half of
//     every weight chunk by TMA multicast into both. That halves the
//     weight bytes a launch asks of the L2, as counted from the launch
//     plan (work items x the block's weights; not a measured count): at 64
//     images layer1.0 302 -> 151 MB, layer2.x 285 -> 143 MB. A larger
//     tile would cut them further but does not fit: h1, h2 and the rings
//     of an 8x16 tile of P = 128 take 215 KB of the 227 KB;
//   - small batches (ops/bottleneck.py launch_plan): a launch whose 8x16
//     tiles would fill at most half the SMs takes an 8x8 tile instead, twice
//     the CTAs; its two warpgroups split N where the 8x16 tile splits M;
//   - epilogues: BN, relu and the rounding run on the fp32 accumulators in
//     registers (the residual add and relu as bf16x2); h2 and the output
//     tile are written in the 128-byte swizzle (no bank conflicts), and
//     the output leaves by TMA stores, which drop what lies off the image.
//     A pass's store reads its boxes while the next pass's products run;
//   - synchronisation: the consumers free a stage by an mbarrier arrival
//     in each CTA of the cluster, with release at CTA scope (a cluster-
//     scope release costs a memory barrier a chunk); the warpgroups meet
//     at named barriers only
//     where h1 or h2 changes hands;
//   - one CTA an SM: 288 threads, so every thread may hold 224 registers
//     and the accumulators (at most 96 floats) need no setmaxnreg.
// No atomics and a fixed order of every sum: results repeat bit for bit.
// Still open (ROADMAP B6): every SM streams its tile's halo at the same
// time, so conv1 waits on device memory while the rest of the tile reads
// none; the two warpgroups reach their
// epilogues together, so the tensor cores idle through them (a ping-pong
// of the warpgroups); conv1 recomputes the halo (180 rows for 128 pixels).

#include <cuda.h>   // CUtensorMap and the driver's types; nothing is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kTH = 8;                     // output tile rows, both tiles
constexpr int kTWBig = 16;                 // output tile columns: 8x16 tile
constexpr int kTWSmall = 8;                // ... and the small batches' 8x8
constexpr int kKC = 64;                    // K chunk (one swizzled row)
constexpr int kRowBytes = kKC * 2;         // 128
constexpr int kBox = 8 * 8 * kRowBytes;    // an (8x8 pixels, 64 ch) box
constexpr int kN3 = 128;                   // output channels a pass
constexpr int kConsumers = 2;              // consumer warpgroups
constexpr int kThreads = 128 * kConsumers + 32;   // + the producer warp
constexpr int kCluster = 2;                // CTAs sharing a weight stream
constexpr int kXStages = 3;                // ring of x chunks
constexpr int kWStages = 4;                // ring of weight chunks
constexpr int kHaloBig = (kTH + 2) * (kTWBig + 2);   // 180
constexpr int kTilePixBig = kTH * kTWBig;            // 128
constexpr int kXStage = (kHaloBig + 63) / 64 * 64 * kRowBytes;  // 192 rows
constexpr int kOutTile = kTilePixBig * kN3 * 2;      // one pass's outputs
constexpr int kAlign = 1024;               // the 128-byte swizzle's period
constexpr int kSMs = 132;                  // H100 SXM
constexpr int kSmallCtas = kSMs / 2;       // 8x16 launches this small: 8x8
constexpr int kClusters = kSMs / 2;        // resident clusters, one CTA an SM
constexpr int kSmemLimit = 232448;

constexpr long long kHangCycles = 1ll << 33;   // ~5 s: a broken schedule

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

__host__ __device__ constexpr int max_of(int a, int b) { return a > b ? a : b; }

// Shared memory, in bytes from a 1024-byte aligned base, the same for both
// tiles (the 8x16 tile's, the larger):
//   1. h1 [P / 8][halo pixels][8]; once h1 is dead, the output tile;
//   2. h2 [P / 64][tile pixels][64], swizzled;
//   3. the ring of x chunks, kXStages x 192 rows of 128 bytes;
//   4. the ring of weight chunks, kWStages x max(P, kN3) rows of 128 bytes;
//   5. the mbarriers.
__host__ __device__ constexpr int region1(int P) {
  return round_up(max_of(kHaloBig * P * 2, kOutTile), kAlign);
}

__host__ __device__ constexpr int w_stage(int P) {
  return max_of(P, kN3) * kRowBytes;
}

// Dynamic shared memory of a launch, in bytes: the regions, one kAlign for
// the mbarriers and one for aligning the base. ops/bottleneck.py smem_bytes
// is the same formula over the same constants, which
// tests/test_torch_bottleneck.py reads from this file; a change here
// changes it there.
__host__ __device__ constexpr int smem_bytes(int P) {
  return kAlign + region1(P) + kTilePixBig * P * 2 + kXStages * kXStage +
         kWStages * w_stage(P) + kAlign;
}

// ------------------------------------------------------------- device side

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n"
               "barrier.cluster.wait.acquire;" ::: "memory");
}

__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

// one arrival that also adds `bytes` to the transactions to wait for
__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// one arrival on the barrier at this offset in every CTA of the cluster
__device__ __forceinline__ void bar_arrive_cluster(uint32_t bar) {
#pragma unroll
  for (int r = 0; r < kCluster; ++r)
    asm volatile(
        "{\n.reg .b32 ra;\n"
        "mapa.shared::cluster.u32 ra, %0, %1;\n"
        "mbarrier.arrive.shared::cluster.b64 _, [ra];\n}" ::"r"(
            bar), "r"(r) : "memory");
}

// Wait for the phase of the given parity to complete. A wait that outlasts
// kHangCycles can only be a broken schedule: it traps, so the launch fails
// instead of holding the card. The clock is read once every 1024 polls.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  long long start = 0;
  for (uint32_t polls = 1;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}" : "=r"(done) : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls % 1024 == 0) {
      if (start == 0)
        start = clock64();
      else if (clock64() - start > kHangCycles)
        __trap();
    }
  }
}

// TMA: a box of a 4-D map into this CTA's shared memory
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3) : "memory");
}

// TMA: a box of a 2-D map into the same offset of every CTA in `mask`,
// each CTA's barrier at `bar` counting the bytes
__device__ __forceinline__ void tma_load_2d_multicast(uint32_t dst,
                                                      const CUtensorMap* map,
                                                      uint32_t bar, int c0,
                                                      int c1, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes.multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "h"(mask) : "memory");
}

// TMA: a shared-memory box to a 4-D map; what lies off the tensor is dropped
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3) : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// the committed stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// ordinary shared-memory stores before this become visible to the async
// proxy (wgmma, TMA) after the next barrier
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// Shared-memory stores and loads as asm: they keep their order among the
// barriers and fences (also asm), while ordinary loads (the BN vectors)
// may be scheduled around them.
__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr), "r"(v));
}

__device__ __forceinline__ uint32_t ld_shared(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];" : "=r"(v) : "r"(addr));
  return v;
}


__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// wgmma operand descriptors. K-major, 128-byte swizzle: rows of 64 bf16,
// 8-row groups 1024 bytes apart; a k16 step is +32 bytes.
__device__ __forceinline__ uint64_t desc_swizzled(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// K-major, no swizzle: 8x8 core matrices of 16-byte rows, `k_stride`
// bytes between the two core matrices of a k16 step, `m_stride` bytes
// between 8-row groups
__device__ __forceinline__ uint64_t desc_plain(uint32_t addr,
                                               uint32_t k_stride,
                                               uint32_t m_stride) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)(k_stride >> 4) << 16) | ((uint64_t)(m_stride >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// d (64 x N fp32; this thread's N / 2) += A (64 x 16) B (16 x N), both from
// shared memory; accumulate == 0 overwrites d. Thread t of the warpgroup
// holds rows 16 (t / 32) + (t % 32) / 4 (+ 8) and columns 8 j + 2 (t % 4)
// (+ 1): d[4 j + 2 h + e] is (row + 8 h, 8 j + 2 (t % 4) + e).
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t a,
                                          uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t a,
                                          uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t a,
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t a,
                                      uint64_t b, int accumulate) {
  static_assert(N == 32 || N == 64 || N == 128, "a wgmma width");
  if constexpr (N == 32) wgmma_n32(d, a, b, accumulate);
  if constexpr (N == 64) wgmma_n64(d, a, b, accumulate);
  if constexpr (N == 128) wgmma_n128(d, a, b, accumulate);
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// Persistent CTAs in clusters of kCluster: a cluster walks work items,
// each a pair of neighbouring tiles of kTH x kTW output pixels of one
// image, one tile a CTA. Warps 0-7 are the two consumer warpgroups, warp 8
// the producer.
template <int kTW, int kP>
__global__ void __launch_bounds__(kThreads, 1)
bottleneck_kernel(const __grid_constant__ CUtensorMap xh_map,   // x, halo boxes
                  const __grid_constant__ CUtensorMap xb_map,   // x, 8x8 boxes
                  const __grid_constant__ CUtensorMap w1_map,   // w1^T (P, Cin)
                  const __grid_constant__ CUtensorMap w2_map,   // w2^T (P, 9 P)
                  const __grid_constant__ CUtensorMap w3_map,   // w3^T (Cout, P)
                  const __grid_constant__ CUtensorMap wd_map,   // wd^T (Cout, Cin)
                  const __grid_constant__ CUtensorMap out_map,  // out, 8x8 boxes
                  const float* __restrict__ sb, int B, int H, int W,
                  int Cin, int Cout, int has_down) {
  constexpr bool kBig = kTW == kTWBig;
  constexpr int kHW = kTW + 2;                 // halo row
  constexpr int kHalo = (kTH + 2) * kHW;       // halo pixels
  constexpr int kTilePix = kTH * kTW;
  constexpr int kLdK1 = kHalo * 16;            // h1: bytes an 8-channel group
  // a consumer warpgroup's share of each product, in M blocks of 64 rows x
  // N columns: the 8x16 tile gives each warpgroup one 8x8 block of output
  // pixels and splits conv1's halo by N; the 8x8 tile splits conv1's halo
  // by M and the rest by N
  constexpr int kM1 = kBig ? 3 : 1;
  constexpr int kN1 = kBig ? kP / 2 : kP;
  constexpr int kN2 = kBig ? kP : kP / 2;
  constexpr int kNW = kBig ? kN3 : kN3 / 2;    // conv3 and the downsample
  constexpr int kWGBoxes = kNW / 64;           // output boxes a warpgroup owns
  static_assert((kHalo + 63) / 64 == (kBig ? 3 : 2), "conv1's M blocks");
  static_assert(kP % kKC == 0 && kP <= 128, "P");

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + kAlign - 1) & ~uint32_t(kAlign - 1);
  const uint32_t h1 = base;                    // region 1: h1, then outputs
  const uint32_t outt = base;
  const uint32_t h2 = base + region1(kP);
  const uint32_t xring = h2 + kTilePixBig * kP * 2;
  const uint32_t wring = xring + kXStages * kXStage;
  const uint32_t xfull = wring + kWStages * w_stage(kP);
  const uint32_t xempty = xfull + 8 * kXStages;
  const uint32_t wfull = xempty + 8 * kXStages;
  const uint32_t wempty = wfull + 8 * kWStages;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // The work: tiles numbered row-major over each image's plane, padded to
  // whole clusters (the padding tiles lie past the image), taken a cluster
  // at a time: cluster c takes items c, c + clusters, ..., each a pair of
  // neighbouring tiles, one a CTA.
  const int tiles_x = (W + kTW - 1) / kTW;
  const int tiles_img = round_up((H + kTH - 1) / kTH * tiles_x, kCluster);
  const int items = tiles_img / kCluster * B;
  const int rank = blockIdx.x % kCluster;      // = %cluster_ctarank
  const int first = blockIdx.x / kCluster;
  const int step = gridDim.x / kCluster;
  struct Tile {
    int y0, x0, img;
  };
  auto tile_of = [&](int item) {
    const int t = item * kCluster + rank;
    const int i = t % tiles_img;
    return Tile{i / tiles_x * kTH, i % tiles_x * kTW, t / tiles_img};
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kXStages; ++s) {
      bar_init(xfull + 8 * s, 1);
      bar_init(xempty + 8 * s, kConsumers);
    }
    for (int s = 0; s < kWStages; ++s) {
      bar_init(wfull + 8 * s, 1);
      bar_init(wempty + 8 * s, kConsumers * kCluster);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_sync();

  if (warp == 4 * kConsumers) {
    // ---- producer: one lane walks the schedule the consumers walk, and
    // runs ahead into the next tile as far as the rings let it
    if (lane == 0) {
      const uint16_t all = (1u << kCluster) - 1;
      int xi = 0, wi = 0;
      auto x_stage = [&](uint32_t bytes) {
        const int s = xi % kXStages;
        bar_wait(xempty + 8 * s, ((xi / kXStages) & 1) ^ 1);
        bar_expect(xfull + 8 * s, bytes);
        ++xi;
        return s;
      };
      // every CTA of the cluster has freed the stage before this CTA's half
      // of the chunk lands in all of them
      auto w_stage_next = [&](uint32_t bytes) {
        const int s = wi % kWStages;
        bar_wait(wempty + 8 * s, ((wi / kWStages) & 1) ^ 1);
        bar_expect(wfull + 8 * s, bytes);
        ++wi;
        return s;
      };
      auto w_half = [&](const CUtensorMap* map, int s, int k, int n0,
                        int rows) {
        const int half = rows / kCluster;
        tma_load_2d_multicast(wring + s * w_stage(kP) + rank * half * kRowBytes,
                              map, wfull + 8 * s, k, n0 + rank * half, all);
      };
      for (int item = first; item < items; item += step) {
        const Tile t = tile_of(item);
        for (int c = 0; c < Cin / kKC; ++c) {           // conv1
          int s = x_stage(kHalo * kRowBytes);
          tma_load_4d(xring + s * kXStage, &xh_map, xfull + 8 * s, c * kKC,
                      t.x0 - 1, t.y0 - 1, t.img);
          s = w_stage_next(kP * kRowBytes);
          w_half(&w1_map, s, c * kKC, 0, kP);
        }
        for (int c = 0; c < 9 * kP / kKC; ++c) {        // conv2
          const int s = w_stage_next(kP * kRowBytes);
          w_half(&w2_map, s, c * kKC, 0, kP);
        }
        for (int n0 = 0; n0 < Cout; n0 += kN3) {        // the passes
          if (has_down)
            for (int c = 0; c < Cin / kKC; ++c) {
              int s = x_stage(kTilePix * kRowBytes);
              for (int b = 0; b < kTilePix / 64; ++b)
                tma_load_4d(xring + s * kXStage + b * kBox, &xb_map,
                            xfull + 8 * s, c * kKC, t.x0 + 8 * b, t.y0, t.img);
              s = w_stage_next(kN3 * kRowBytes);
              w_half(&wd_map, s, c * kKC, n0, kN3);
            }
          for (int c = 0; c < kP / kKC; ++c) {
            const int s = w_stage_next(kN3 * kRowBytes);
            w_half(&w3_map, s, c * kKC, n0, kN3);
          }
          // the identity residual, after the pass's weights (a wait for x
          // space must not hold them back): chunk c holds each
          // warpgroup's box of 64 of its channels
          if (!has_down)
            for (int c = 0; c < kTilePix / 64; ++c) {
              const int s = x_stage(kConsumers * kBox);
              for (int w = 0; w < kConsumers; ++w)
                tma_load_4d(xring + s * kXStage + w * kBox, &xb_map,
                            xfull + 8 * s, n0 + 64 * (kBig ? c : w),
                            t.x0 + (kBig ? 8 * w : 0), t.y0, t.img);
            }
        }
      }
    }
    __syncwarp();
  } else {
    // ---- consumers
    const int wg = warp / 4;
    const bool leader = threadIdx.x % 128 == 0;
    const int row = 16 * (warp % 4) + lane / 4;   // accumulator rows row, +8
    const int col = 2 * (lane % 4);               // columns col, +1 (+ 8 j)
    const float* s1 = sb;
    const float* b1 = s1 + kP;
    const float* s2 = b1 + kP;
    const float* b2 = s2 + kP;
    const float* s3 = b2 + kP;
    const float* b3 = s3 + Cout;
    const float* sd = b3 + Cout;
    const float* bd = sd + Cout;
    int xi = 0, wi = 0;

    // One product over `chunks` K chunks: wait for each chunk, issue the
    // warpgroup's wgmmas on it, and free the chunk before once they finish.
    auto product = [&](int chunks, bool with_x, auto&& issue) {
      for (int c = 0; c < chunks; ++c) {
        const int ws = wi % kWStages;
        bar_wait(wfull + 8 * ws, (wi / kWStages) & 1);
        int xs = 0;
        if (with_x) {
          xs = xi % kXStages;
          bar_wait(xfull + 8 * xs, (xi / kXStages) & 1);
        }
        wgmma_fence();
        issue(c, xring + xs * kXStage, wring + ws * w_stage(kP));
        wgmma_commit();
        wgmma_wait<1>();
        if (c > 0 && leader) {
          bar_arrive_cluster(wempty + 8 * ((wi - 1) % kWStages));
          if (with_x) bar_arrive(xempty + 8 * ((xi - 1) % kXStages));
        }
        ++wi;
        if (with_x) ++xi;
      }
      wgmma_wait<0>();
      if (leader) {
        bar_arrive_cluster(wempty + 8 * ((wi - 1) % kWStages));
        if (with_x) bar_arrive(xempty + 8 * ((xi - 1) % kXStages));
      }
    };

    const int n_lo3 = kBig ? 0 : wg * kNW;       // first column in a pass
    const uint32_t mine = outt + wg * kWGBoxes * kBox;
    // byte offset of element (row + 8 h, 8 j + col) of the warpgroup's
    // part of a pass in its output boxes
    auto box_off = [&](int j, int h) -> uint32_t {
      const int p = row + 8 * h;
      const int n = 8 * j + col;
      return (n / 64) * kBox + p * kRowBytes +
             ((((n % 64) / 8) ^ (p % 8)) << 4) + (n % 8) * 2;
    };
    auto boxes_free = [&](int id, int threads) {   // the stores have read them
      if (leader) bulk_wait_read();
      named_sync(id, threads);
    };
    for (int item = first; item < items; item += step) {
      const Tile t = tile_of(item);
      // 1. h1 = bf16(relu(x @ w1 * s1 + b1)) over the halo, 0 off the image
      {
        float acc[kM1][kN1 / 2];
#pragma unroll
        for (int m = 0; m < kM1; ++m) zero(acc[m]);
        const int n_lo = kBig ? wg * kN1 : 0;
        product(Cin / kKC, true, [&](int c, uint32_t xs, uint32_t ws) {
#pragma unroll
          for (int k = 0; k < kKC / 16; ++k)
#pragma unroll
            for (int m = 0; m < kM1; ++m)
              wgmma<kN1>(acc[m],
                         desc_swizzled(xs + (kBig ? m : wg) * 64 * kRowBytes +
                                       32 * k),
                         desc_swizzled(ws + n_lo * kRowBytes + 32 * k),
                         c + k > 0);
        });
        // h1 overlays the last tile's output boxes
        if (item != first) boxes_free(1, 128 * kConsumers);
#pragma unroll
        for (int m = 0; m < kM1; ++m)
#pragma unroll
          for (int j = 0; j < kN1 / 8; ++j) {
            const int n = n_lo + 8 * j + col;
            const float2 s = *reinterpret_cast<const float2*>(s1 + n);
            const float2 b = *reinterpret_cast<const float2*>(b1 + n);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int p = 64 * (kBig ? m : wg) + row + 8 * h;  // halo pixel
              if (p < kHalo) {
                const int gy = t.y0 - 1 + p / kHW;
                const int gx = t.x0 - 1 + p % kHW;
                const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
                const float* a = acc[m] + 4 * j + 2 * h;
                st_shared(h1 + (n / 8) * kLdK1 + p * 16 + (n % 8) * 2,
                          inside ? pack_bf16(fmaxf(a[0] * s.x + b.x, 0.f),
                                             fmaxf(a[1] * s.y + b.y, 0.f))
                                 : 0u);
              }
            }
          }
      }
      fence_proxy_async();
      named_sync(1, 128 * kConsumers);

      // 2. h2 = bf16(relu(conv3x3(h1) * s2 + b2)) on the tile. Row m of the
      // warpgroup's M block is output pixel (m / 8, m % 8) of its 8x8 block;
      // at tap (ky, kx) it reads halo pixel (m / 8 + ky) * kHW + m % 8 + kx
      // (+ 8 for the 8x16 tile's second block).
      {
        float acc[kN2 / 2];
        zero(acc);
        const int px = kBig ? 8 * wg : 0;
        const int n_lo = kBig ? 0 : wg * kN2;
        product(9 * kP / kKC, false, [&](int c, uint32_t, uint32_t ws) {
          const int tap = c / (kP / kKC);
          const int k0 = (c % (kP / kKC)) * kKC;
          const uint32_t a0 =
              h1 + (k0 / 8) * kLdK1 + ((tap / 3) * kHW + tap % 3 + px) * 16;
#pragma unroll
          for (int k = 0; k < kKC / 16; ++k)
            wgmma<kN2>(acc, desc_plain(a0 + 2 * k * kLdK1, kLdK1, kHW * 16),
                       desc_swizzled(ws + n_lo * kRowBytes + 32 * k),
                       c + k > 0);
        });
#pragma unroll
        for (int j = 0; j < kN2 / 8; ++j) {
          const int n = n_lo + 8 * j + col;
          const float2 s = *reinterpret_cast<const float2*>(s2 + n);
          const float2 b = *reinterpret_cast<const float2*>(b2 + n);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int p = (kBig ? 64 * wg : 0) + row + 8 * h;   // h2 row
            const float* a = acc + 4 * j + 2 * h;
            st_shared(h2 + (n / 64) * kTilePix * kRowBytes + p * kRowBytes +
                          ((((n % 64) / 8) ^ (p % 8)) << 4) + (n % 8) * 2,
                      pack_bf16(fmaxf(a[0] * s.x + b.x, 0.f),
                                fmaxf(a[1] * s.y + b.y, 0.f)));
          }
        }
      }
      fence_proxy_async();
      named_sync(1, 128 * kConsumers);   // h2 complete, h1 dead

      // 3. per kN3 output channels: the residual r in registers (the
      // downsample's, or the identity's from x-ring chunks that the
      // producer loads with the pass's weights), then out = relu(bf16(
      // bf16(h2 @ w3 * s3 + b3) + r)) into the warpgroup's output boxes,
      // then TMA stores. A pass's store reads its boxes while the next
      // pass's products run; the leader waits for that only before the
      // boxes are written again.
      const int bx = t.x0 + (kBig ? 8 * wg : 0);   // the boxes' first column
      for (int n0 = 0, pass = 0; n0 < Cout; n0 += kN3, ++pass) {
        float acc[kNW / 2];
        zero(acc);
        uint32_t r[kNW / 8][2];                    // the residual, bf16x2
        if (has_down) {
          product(Cin / kKC, true, [&](int c, uint32_t xs, uint32_t ws) {
#pragma unroll
            for (int k = 0; k < kKC / 16; ++k)
              wgmma<kNW>(acc,
                         desc_swizzled(xs + (kBig ? wg : 0) * kBox + 32 * k),
                         desc_swizzled(ws + n_lo3 * kRowBytes + 32 * k),
                         c + k > 0);
          });
#pragma unroll
          for (int j = 0; j < kNW / 8; ++j) {
            const int n = n0 + n_lo3 + 8 * j + col;
            const float2 s = *reinterpret_cast<const float2*>(sd + n);
            const float2 b = *reinterpret_cast<const float2*>(bd + n);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float* a = acc + 4 * j + 2 * h;
              r[j][h] = pack_bf16(a[0] * s.x + b.x, a[1] * s.y + b.y);
            }
          }
        }
        product(kP / kKC, false, [&](int c, uint32_t, uint32_t ws) {
#pragma unroll
          for (int k = 0; k < kKC / 16; ++k)
            wgmma<kNW>(acc,
                       desc_swizzled(h2 + c * kTilePix * kRowBytes +
                                     (kBig ? 64 * wg : 0) * kRowBytes + 32 * k),
                       desc_swizzled(ws + n_lo3 * kRowBytes + 32 * k),
                       c + k > 0);
        });
        if (!has_down) {
          // chunk c holds this warpgroup's box of its columns 64 c (8x16)
          // or of all its 64 columns (8x8)
#pragma unroll
          for (int c = 0; c < kTilePix / 64; ++c) {
            const int xs = (xi + c) % kXStages;
            bar_wait(xfull + 8 * xs, ((xi + c) / kXStages) & 1);
            const uint32_t rb = xring + xs * kXStage + wg * kBox;
#pragma unroll
            for (int j = 8 * c; j < (kBig ? 8 * c + 8 : kNW / 8); ++j)
#pragma unroll
              for (int h = 0; h < 2; ++h)
                r[j][h] = ld_shared(rb + box_off(j - 8 * c, h));
          }
        }
        if (pass > 0) boxes_free(2 + wg, 128);
        // h3 = bf16(acc * s3 + b3); the add and relu in bf16x2 (an add of
        // two bf16 values rounds once, as the fp32 add then the rounding do)
        const __nv_bfloat162 zero2 = __floats2bfloat162_rn(0.f, 0.f);
#pragma unroll
        for (int j = 0; j < kNW / 8; ++j) {
          const int n = n0 + n_lo3 + 8 * j + col;
          const float2 s = *reinterpret_cast<const float2*>(s3 + n);
          const float2 b = *reinterpret_cast<const float2*>(b3 + n);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float* a = acc + 4 * j + 2 * h;
            const __nv_bfloat162 h3 =
                __floats2bfloat162_rn(a[0] * s.x + b.x, a[1] * s.y + b.y);
            const __nv_bfloat162 o = __hmax2(
                __hadd2(h3,
                        *reinterpret_cast<const __nv_bfloat162*>(&r[j][h])),
                zero2);
            st_shared(mine + box_off(j, h),
                      *reinterpret_cast<const uint32_t*>(&o));
          }
        }
        fence_proxy_async();
        named_sync(2 + wg, 128);
        if (leader) {
          if (!has_down)                           // the residual is read
            for (int c = 0; c < kTilePix / 64; ++c)
              bar_arrive(xempty + 8 * ((xi + c) % kXStages));
          for (int g = 0; g < kWGBoxes; ++g)
            tma_store_4d(&out_map, mine + g * kBox, n0 + n_lo3 + 64 * g, bx,
                         t.y0, t.img);
          bulk_commit();
        }
        if (!has_down) xi += kTilePix / 64;
      }
    }
    if (leader) bulk_wait_read();   // the stores have read the last tile
  }
  cluster_sync();   // no CTA leaves while its peer may still signal it
}

// ---------------------------------------------------------------- host side

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, through the runtime's driver entry point, so the
// library links no libcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// An NHWC bf16 tensor (B, H, W, C) as a 4-D map of (64, bw, bh, 1) boxes
bool map_nhwc(CUtensorMap* m, const void* p, int B, int H, int W, int C,
              int bw, int bh) {
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2,
                                 (cuuint64_t)H * W * C * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kKC, (cuuint32_t)bw, (cuuint32_t)bh,
                             1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encode_tiled()(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(p), dims, strides, box, step,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A K-major (N, K) bf16 weight as a 2-D map of (64, rows) boxes
bool map_weight(CUtensorMap* m, const void* p, int N, int K, int rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)N};
  const cuuint64_t strides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kKC, (cuuint32_t)rows};
  const cuuint32_t step[2] = {1, 1};
  return encode_tiled()(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(p), dims, strides, box, step,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

// The maps of one packed weight buffer (w1, w2, w3 and wd). A map is a
// function of the buffer's address and the block's sizes alone, so each
// host thread encodes them once for each (address, sizes) and keeps the
// last kKeptMaps; only x's and the output's maps are encoded a call.
struct WeightMaps {
  const bf16* w;
  int p, cin, cout, has_down;
  CUtensorMap m1, m2, m3, md;
};
constexpr int kKeptMaps = 16;

template <int kP>
const WeightMaps* weight_maps(const bf16* w, int Cin, int Cout,
                              int has_down) {
  thread_local WeightMaps kept[kKeptMaps];
  thread_local int n_kept = 0, next = 0;
  for (int i = 0; i < n_kept; ++i) {
    const WeightMaps& k = kept[i];
    if (k.w == w && k.p == kP && k.cin == Cin && k.cout == Cout &&
        k.has_down == has_down)
      return &k;
  }
  // the packed weights (ops/bottleneck.py weight_layout), each K-major
  const bf16* w1 = w;                          // (P, Cin)
  const bf16* w2 = w1 + (size_t)kP * Cin;      // (P, 9 P), K = (ky, kx, cin)
  const bf16* w3 = w2 + (size_t)9 * kP * kP;   // (Cout, P)
  const bf16* wd = w3 + (size_t)kP * Cout;     // (Cout, Cin)
  WeightMaps& e = kept[next];
  e.p = 0;   // matches nothing until every map is encoded
  // without a downsample wd is never read; any valid map will do
  if (!(map_weight(&e.m1, w1, kP, Cin, kP / kCluster) &&
        map_weight(&e.m2, w2, kP, 9 * kP, kP / kCluster) &&
        map_weight(&e.m3, w3, Cout, kP, kN3 / kCluster) &&
        map_weight(&e.md, has_down ? wd : w3, Cout, has_down ? Cin : kP,
                   kN3 / kCluster)))
    return nullptr;
  e.w = w;
  e.p = kP;
  e.cin = Cin;
  e.cout = Cout;
  e.has_down = has_down;
  next = (next + 1) % kKeptMaps;
  if (n_kept < kKeptMaps) ++n_kept;
  return &e;
}

// The launch: the tile's columns, the work items (pairs of tiles, one a
// CTA of a cluster; each image's tiles padded to whole clusters) and the
// CTAs, at most one cluster for every two SMs, each walking items.
// ops/bottleneck.py launch_plan is the same rule.
struct Plan {
  int tw, items, ctas;
};

Plan plan_of(int B, int H, int W) {
  auto tiles = [&](int tw) {
    return round_up(cdiv(H, kTH) * cdiv(W, tw), kCluster);
  };
  const int tw = (long long)tiles(kTWBig) * B <= kSmallCtas ? kTWSmall : kTWBig;
  const int items = tiles(tw) / kCluster * B;
  return {tw, items, kCluster * (items < kClusters ? items : kClusters)};
}

template <int kTW, int kP>
int launch(const bf16* x, const bf16* w, const float* sb, bf16* out, int B,
           int H, int W, int Cin, int Cout, int has_down, const Plan& plan,
           cudaStream_t stream) {
  static unsigned configured = 0;       // a bit a device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const int smem = smem_bytes(kP);
  if (dev >= 32 || !(configured >> dev & 1u)) {
    err = cudaFuncSetAttribute(bottleneck_kernel<kTW, kP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 32) configured |= 1u << dev;
  }
  if (encode_tiled() == nullptr) return (int)cudaErrorNotSupported;
  const WeightMaps* wm = weight_maps<kP>(w, Cin, Cout, has_down);
  CUtensorMap xh, xb, mo;
  if (wm == nullptr || !map_nhwc(&xh, x, B, H, W, Cin, kTW + 2, kTH + 2) ||
      !map_nhwc(&xb, x, B, H, W, Cin, 8, 8) ||
      !map_nhwc(&mo, out, B, H, W, Cout, 8, 8))
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(plan.ctas);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, bottleneck_kernel<kTW, kP>, xh, xb, wm->m1,
                           wm->m2, wm->m3, wm->md, mo, sb, B, H, W, Cin, Cout,
                           has_down);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// Dynamic shared memory of a launch with P planes, in bytes (the same with
// and without a downsample, and for both tiles).
extern "C" int fused_bottleneck_smem_bytes(int P, int has_down) {
  (void)has_down;
  return smem_bytes(P);
}

// The launch fused_bottleneck_bf16 makes: plan[0..4] = CTAs, CTAs a
// cluster, work items (pairs of tiles), tile rows, tile columns. Returns 0.
extern "C" int fused_bottleneck_plan(int B, int H, int W, int* plan) {
  const Plan p = plan_of(B, H, W);
  plan[0] = p.ctas;
  plan[1] = kCluster;
  plan[2] = p.items;
  plan[3] = kTH;
  plan[4] = p.tw;
  return 0;
}

// x: (B, H, W, Cin) bf16 (NHWC, i.e. NCHW in channels_last).
// w: bf16 [w1^T (P, Cin) | w2^T (P, 9 P), columns (ky, kx, cin) | w3^T
//    (Cout, P) | wd^T (Cout, Cin) if has_down], each K-major; sb: fp32
//    [s1 b1 s2 b2 (P each) | s3 b3 (Cout each) | sd bd (Cout each) if
//    has_down], the folded BNs.
// out: (B, H, W, Cout) bf16. Needs Cin % 64 == 0, P == 64 or 128, Cout %
// 128 == 0, Cin == Cout without a downsample, 1 <= B <= 65535 and 16-byte
// aligned pointers (ops/bottleneck.py check_launch; these rules also give
// TMA its 16-byte strides and boxes of at most 256 rows).
// Returns a cudaError_t: 0 once the launch is enqueued on `stream`.
extern "C" int fused_bottleneck_bf16(const void* x, const void* w,
                                     const void* sb, void* out, int B, int H,
                                     int W, int Cin, int P, int Cout,
                                     int has_down, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || Cin % kKC != 0 ||
      Cout % kN3 != 0 || !(P == 64 || P == 128) ||
      (!has_down && Cin != Cout) || smem_bytes(P) > kSmemLimit ||
      !aligned16(x) || !aligned16(w) || !aligned16(sb) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  const float* sbf = static_cast<const float*>(sb);
  bf16* ob = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Plan plan = plan_of(B, H, W);
  if (plan.tw == kTWBig) {
    if (P == 64)
      return launch<kTWBig, 64>(xb, wb, sbf, ob, B, H, W, Cin, Cout,
                                has_down, plan, st);
    return launch<kTWBig, 128>(xb, wb, sbf, ob, B, H, W, Cin, Cout, has_down,
                               plan, st);
  }
  if (P == 64)
    return launch<kTWSmall, 64>(xb, wb, sbf, ob, B, H, W, Cin, Cout, has_down,
                                plan, st);
  return launch<kTWSmall, 128>(xb, wb, sbf, ob, B, H, W, Cin, Cout, has_down,
                               plan, st);
}
