// Fused eval-mode ResNet Bottleneck for Hopper (sm_90a), bf16 in and out.
//
// Replaces fast3dhpe_tpu/ops/pallas_bottleneck.py `_bottleneck_kernel`
// (pallas_call at :191): one stride-1 block
//   1x1 conv + BN + relu -> 3x3 conv (pad 1) + BN + relu -> 1x1 conv + BN
//   -> + residual (identity, or 1x1 downsample + BN) -> relu
// with BN folded to per-channel (scale, bias) and the weights packed once
// per weight version by the caller (ops/bottleneck.py pack_weights). It
// rounds where the TPU kernel rounds: h1, h2, h3 and the downsampled
// residual are bf16, every product sums in fp32, and the residual add
// happens in bf16.
//
// What bounds it on the H100: at the encoder's stage-1/2 shapes a block
// moves ~2.6 MB and does ~0.6 GFLOP per image, so at 989 TFLOP/s (bf16
// tensor cores) and 3.35 TB/s the roofline is memory, ~40-50 us for 64
// images. Device memory sees x once (plus the halo) and the output once;
// everything else stays on chip. The work is four implicit GEMMs per CTA,
// on the tensor cores:
//   - one CTA of 8 warps per (image, 8x16 output tile). Warps split each
//     product 2 (rows) x 4 (columns); every product is
//     mma.sync.m16n8k16 bf16 -> fp32 with both operands read from shared
//     memory by ldmatrix, and the BN/relu epilogue runs on the fp32
//     accumulators in registers;
//   - conv1: M = the 10x18 halo (180 pixels, two passes of 96 rows) x N =
//     P x K = Cin. Off the image h1 is 0 (the TPU kernel zero-pads h1, not
//     x), and h1 stays in shared memory as bf16;
//   - conv2: M = 128 tile pixels x N = P x K = 9 P; the A rows of tap
//     (ky, kx) are the h1 rows shifted by (ky, kx), which ldmatrix gathers
//     by address, so no im2col copy is made. h2 stays in shared memory;
//   - per 128 output channels: the downsample (M = 128 x K = Cin) or the
//     identity residual is written to an output tile in shared memory as
//     bf16, conv3 (K = P) adds to it in its epilogue, and the tile leaves
//     as 16-byte coalesced stores;
//   - K streams in chunks of 32 through a 3-stage cp.async ring: the
//     weights (<= 0.6 MB a block, shared by every CTA, so they stay in L2)
//     for every product, x for conv1 and the downsample. Each chunk loads
//     while the tensor cores work on the one before. Shared-memory rows are
//     padded by 8 bf16 so that every ldmatrix is free of bank conflicts;
//   - two CTAs per SM (__launch_bounds__ 256 x 2: 128 registers, a spill
//     of ~24 bytes), so that one CTA's barriers, epilogues and ring fills
//     overlap the other's products. For that the shared memory of a block
//     of P <= 128 stays under 114 KB: conv1's x ring shares its region with
//     h2, the downsample's x ring and the output tile share h1's (see
//     region1/region2). On the H100 this beat every one-CTA-per-SM variant
//     tried (deeper rings, K chunks of 64) at every main-path shape
//     (PERF.md, design search).
// Still open (ROADMAP B): wgmma and TMA, and the weights' L2 traffic
// (every CTA streams all of them: ~0.7 MB a CTA at layer2.x).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kTH = 8;                    // output tile rows
constexpr int kTW = 16;                   // output tile columns (one m16 tile)
constexpr int kHW = kTW + 2;              // halo row length
constexpr int kHaloPix = (kTH + 2) * kHW; // 180
constexpr int kTilePix = kTH * kTW;       // 128
constexpr int kWarpsM = 2;
constexpr int kWarpsN = 4;
constexpr int kThreads = 32 * kWarpsM * kWarpsN;
constexpr int kMinCtas = 2;               // CTAs an SM is built for
constexpr int kKC = 32;                   // K chunk
constexpr int kStages = 3;                // cp.async ring depth
constexpr int kPad = 8;                   // bf16 of padding a smem row
constexpr int kMT1 = 3;                   // conv1: m16 tiles a warp
constexpr int kRows1 = 16 * kWarpsM * kMT1;      // 96 halo rows a pass
constexpr int kMT = kTilePix / (16 * kWarpsM);   // 4: m16 tiles a warp
constexpr int kNT3 = 4;                   // conv3, downsample: n8 tiles a warp
constexpr int kN3 = 8 * kWarpsN * kNT3;   // 128 output channels a pass
constexpr int kLdA = kKC + kPad;          // staged A row
constexpr int kLdB = kN3 + kPad;          // staged B row, output tile row
constexpr int kAStage = kTilePix * kLdA;  // elements
constexpr int kAV = kKC / 8;              // 16-byte copies an A row
constexpr int kACopies = kTilePix * kAV / kThreads;  // a thread's, 128 rows
constexpr int kBStage = kKC * kLdB;
constexpr int kSmemLimit = 232448;

static_assert(kTH == kWarpsM * kMT, "each warp row-block is kMT tile rows");
static_assert(2 * kRows1 >= kHaloPix, "two conv1 passes cover the halo");

// Shared memory, in bf16 elements, is three regions:
//   1. h1 [180][P + 8]; once h1 is dead (step 3), the output tile
//      [128][kLdB] and, with a downsample, its ring of x chunks;
//   2. the ring of conv1's x chunks (96 rows); from step 2 on, h2
//      [128][P + 8];
//   3. the ring of weight chunks.
// so that a block of P = 128 (or 64) fits twice on an SM.
__host__ __device__ __forceinline__ int region1(int P, int has_down) {
  const int h1 = kHaloPix * (P + kPad);
  const int tile = kTilePix * kLdB + (has_down ? kStages * kAStage : 0);
  return h1 > tile ? h1 : tile;
}

__host__ __device__ __forceinline__ int region2(int P) {
  const int h2 = kTilePix * (P + kPad);
  const int ring = kStages * kRows1 * kLdA;
  return h2 > ring ? h2 : ring;
}

// Dynamic shared memory of a launch, in bytes. ops/bottleneck.py smem_bytes
// is the same formula over the same constants, which
// tests/test_torch_bottleneck.py reads from this file; a change here
// changes it there.
size_t smem_bytes(int P, int has_down) {
  return sizeof(bf16) * ((size_t)region1(P, has_down) + region2(P) +
                         (size_t)kStages * kBStage);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros when !valid (the source
// address is then not read, but must still be a mapped one)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, fp32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
}

// One CTA-wide product over `chunks` K-chunks through the cp.async ring.
// load(stage, c) starts this thread's copies of chunk c into a stage;
// step(stage, c) runs the warp's products on it. Copies committed before
// the call (the identity residual) are complete when it returns, and every
// thread has left the last step.
template <class Load, class Step>
__device__ __forceinline__ void pipeline(int chunks, Load load, Step step) {
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < chunks) load(s, s);
    cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<kStages - 2>();   // chunk c has landed
    __syncthreads();                // ... for every thread; stage c-1 is free
    const int next = c + kStages - 1;
    if (next < chunks) load(next % kStages, next);
    cp_async_commit();
    step(c % kStages, c);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// acc[i][j] += A (the warp's rows) x B (one staged kKC x kLdB chunk).
// a_row(i): this lane's ldmatrix address in m16 tile i at the chunk's
// first K (row lane % 16, K offset 8 * (lane / 16)). bcol: the warp's first
// column in the B chunk.
template <int MT, int NT, class ARow>
__device__ __forceinline__ void mma_chunk(float (&acc)[MT][NT][4], ARow a_row,
                                          const bf16* bs, int bcol, int lane) {
  static_assert(NT % 2 == 0, "B fragments come in pairs of n8 tiles");
#pragma unroll
  for (int kk = 0; kk < kKC; kk += 16) {
    uint32_t a[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i) ldsm_x4(a[i], a_row(i) + kk);
    const bf16* brow = bs + (kk + (lane & 15)) * kLdB + bcol + (lane >> 4) * 8;
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t b[4];
      ldsm_x4_t(b, brow + j * 8);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        mma_bf16(acc[i][j], a[i], b[0], b[1]);
        mma_bf16(acc[i][j + 1], a[i], b[2], b[3]);
      }
    }
  }
}

// Chunk k0 of a K x ld bf16 matrix in global memory, columns [n0, n0 + N),
// into a staged B chunk.
template <int N>
__device__ __forceinline__ void load_b(bf16* bs, const bf16* __restrict__ b,
                                       int ld, int k0, int n0, int tid) {
  constexpr int kRowVecs = N / 8;
  constexpr int kVecs = kKC * kRowVecs;
  static_assert(kVecs % kThreads == 0, "whole 16-byte copies a thread");
#pragma unroll
  for (int u = 0; u < kVecs / kThreads; ++u) {
    const int v = tid + u * kThreads;
    const int k = v / kRowVecs;
    const int q = v - k * kRowVecs;
    cp_async16(bs + k * kLdB + q * 8, b + (size_t)(k0 + k) * ld + n0 + q * 8,
               true);
  }
}

// This thread's share of a staged A chunk: up to kACopies 16-byte copies
// of x rows (kAV a row), fixed for the whole product.
struct ARows {
  const bf16* src[kACopies];   // x at the row's pixel, channel 8 q
  int dst[kACopies];           // offset in the stage
  bool valid[kACopies];        // the pixel lies on the image (else zeros)
  bool used[kACopies];         // the copy exists (the pass has this row)

  __device__ __forceinline__ void load(bf16* as, int c) const {
#pragma unroll
    for (int u = 0; u < kACopies; ++u)
      if (used[u])
        cp_async16(as + dst[u], valid[u] ? src[u] + c * kKC : src[u],
                   valid[u]);
  }
};

// P-pass width 8 * kWarpsN * NT: conv1 and conv2 run in passes of that
// many output channels (64 for P = 64, 128 otherwise).
template <int NT>
__global__ void __launch_bounds__(kThreads, kMinCtas)
bottleneck_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wts,
                  const float* __restrict__ sb, bf16* __restrict__ out, int H,
                  int W, int Cin, int P, int Cout, int has_down) {
  constexpr int kNP = 8 * kWarpsN * NT;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldp = P + kPad;
  bf16* h1s = reinterpret_cast<bf16*>(smem);   // [180][ldp]
  bf16* outs = h1s;                            // [128][kLdB], once h1 is dead
  bf16* sad = outs + kTilePix * kLdB;          // kStages x [128][kLdA]
  bf16* h2s = h1s + region1(P, has_down);      // [128][ldp]
  bf16* sa1 = h2s;                             // kStages x [96][kLdA]
  bf16* sbs = h2s + region2(P);                // kStages x [kKC][kLdB]

  // the packed weights and folded BN (ops/bottleneck.py weight_layout)
  const bf16* w1 = wts;                        // (Cin, P)
  const bf16* w2 = w1 + (size_t)Cin * P;       // (9 P, P), rows (ky, kx, cin)
  const bf16* w3 = w2 + (size_t)9 * P * P;     // (P, Cout)
  const bf16* wd = w3 + (size_t)P * Cout;      // (Cin, Cout)
  const float* s1 = sb;
  const float* b1 = s1 + P;
  const float* s2 = b1 + P;
  const float* b2 = s2 + P;
  const float* s3 = b2 + P;
  const float* b3 = s3 + Cout;
  const float* sd = b3 + Cout;
  const float* bd = sd + Cout;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp / kWarpsN;
  const int wn = warp % kWarpsN;
  const int tiles_x = (W + kTW - 1) / kTW;
  const int img = blockIdx.y;
  const int y0 = (blockIdx.x / tiles_x) * kTH;
  const int x0 = (blockIdx.x % tiles_x) * kTW;
  const bf16* ximg = x + (size_t)img * H * W * Cin;

  // 1. h1 = bf16(relu(x @ w1 * s1 + b1)) over the halo, 0 off the image
  for (int pass = 0; pass < 2; ++pass) {
    const int h0 = pass * kRows1;
    ARows ar;
#pragma unroll
    for (int u = 0; u < kACopies; ++u) {
      const int v = tid + u * kThreads;
      const int m = v / kAV;
      const int q = v % kAV;
      const int h = h0 + m;
      const int gy = y0 - 1 + h / kHW;
      const int gx = x0 - 1 + h % kHW;
      ar.used[u] = m < kRows1;
      ar.valid[u] = h < kHaloPix && gy >= 0 && gy < H && gx >= 0 && gx < W;
      ar.src[u] = ximg + (ar.valid[u] ? ((size_t)gy * W + gx) * Cin : 0) +
                  q * 8;
      ar.dst[u] = m * kLdA + q * 8;
    }
    for (int n0 = 0; n0 < P; n0 += kNP) {
      float acc[kMT1][NT][4];
      zero(acc);
      pipeline(
          Cin / kKC,
          [&](int s, int c) {
            ar.load(sa1 + s * kRows1 * kLdA, c);
            load_b<kNP>(sbs + s * kBStage, w1, P, c * kKC, n0, tid);
          },
          [&](int s, int c) {
            const bf16* as = sa1 + s * kRows1 * kLdA + (lane & 15) * kLdA +
                             (lane >> 4) * 8;
            mma_chunk<kMT1, NT>(
                acc,
                [&](int i) { return as + (wm * kMT1 + i) * 16 * kLdA; },
                sbs + s * kBStage, wn * 8 * NT, lane);
          });
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = n0 + wn * 8 * NT + j * 8 + (lane & 3) * 2;
        const float2 s = *reinterpret_cast<const float2*>(s1 + n);
        const float2 b = *reinterpret_cast<const float2*>(b1 + n);
#pragma unroll
        for (int i = 0; i < kMT1; ++i)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int h = h0 + (wm * kMT1 + i) * 16 + (lane >> 2) + half * 8;
            const int gy = y0 - 1 + h / kHW;
            const int gx = x0 - 1 + h % kHW;
            if (h < kHaloPix) {
              const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
              const float* a = acc[i][j] + 2 * half;
              *reinterpret_cast<__nv_bfloat162*>(h1s + h * ldp + n) =
                  inside ? __floats2bfloat162_rn(fmaxf(a[0] * s.x + b.x, 0.f),
                                                 fmaxf(a[1] * s.y + b.y, 0.f))
                         : __floats2bfloat162_rn(0.f, 0.f);
            }
          }
      }
    }
  }

  // 2. h2 = bf16(relu(conv3x3(h1) * s2 + b2)) on the tile. Output pixel
  // (r, c) at tap (ky, kx) reads halo row (r + ky) * kHW + c + kx; the
  // warp's m16 tile i is tile row r = wm * kMT + i, lane % 16 its column.
  const int cpt = P / kKC;   // chunks a tap
  for (int n0 = 0; n0 < P; n0 += kNP) {
    float acc[kMT][NT][4];
    zero(acc);
    pipeline(
        9 * cpt,
        [&](int s, int c) {
          load_b<kNP>(sbs + s * kBStage, w2, P, c * kKC, n0, tid);
        },
        [&](int s, int c) {
          const int tap = c / cpt;
          const int ky = tap / 3;
          const int k0 = (c - tap * cpt) * kKC;
          const int kx = tap - 3 * ky;
          const bf16* base = h1s + (ky * kHW + kx + (lane & 15)) * ldp + k0 +
                             (lane >> 4) * 8;
          mma_chunk<kMT, NT>(
              acc,
              [&](int i) { return base + (wm * kMT + i) * kHW * ldp; },
              sbs + s * kBStage, wn * 8 * NT, lane);
        });
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = n0 + wn * 8 * NT + j * 8 + (lane & 3) * 2;
      const float2 s = *reinterpret_cast<const float2*>(s2 + n);
      const float2 b = *reinterpret_cast<const float2*>(b2 + n);
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int m = (wm * kMT + i) * 16 + (lane >> 2) + half * 8;
          const float* a = acc[i][j] + 2 * half;
          *reinterpret_cast<__nv_bfloat162*>(h2s + m * ldp + n) =
              __floats2bfloat162_rn(fmaxf(a[0] * s.x + b.x, 0.f),
                                    fmaxf(a[1] * s.y + b.y, 0.f));
        }
    }
  }

  // 3. per kN3 output channels: the residual r into the output tile, then
  // out = relu(bf16(bf16(h2 @ w3 * s3 + b3) + r)) in place, then stores.
  // x at the tile's pixels: 4 copies a row for the downsample's A chunks.
  ARows xr;
#pragma unroll
  for (int u = 0; u < kACopies; ++u) {
    const int v = tid + u * kThreads;
    const int m = v / kAV;
    const int q = v % kAV;
    const int gy = y0 + m / kTW;
    const int gx = x0 + m % kTW;
    xr.used[u] = true;
    xr.valid[u] = gy < H && gx < W;
    xr.src[u] = ximg + (xr.valid[u] ? ((size_t)gy * W + gx) * Cin : 0) +
                q * 8;
    xr.dst[u] = m * kLdA + q * 8;
  }
  for (int n0 = 0; n0 < Cout; n0 += kN3) {
    float acc[kMT][kNT3][4];
    if (has_down) {
      zero(acc);
      pipeline(
          Cin / kKC,
          [&](int s, int c) {
            xr.load(sad + s * kAStage, c);
            load_b<kN3>(sbs + s * kBStage, wd, Cout, c * kKC, n0, tid);
          },
          [&](int s, int c) {
            const bf16* as = sad + s * kAStage + (lane & 15) * kLdA +
                             (lane >> 4) * 8;
            mma_chunk<kMT, kNT3>(
                acc, [&](int i) { return as + (wm * kMT + i) * 16 * kLdA; },
                sbs + s * kBStage, wn * 8 * kNT3, lane);
          });
#pragma unroll
      for (int j = 0; j < kNT3; ++j) {
        const int n = wn * 8 * kNT3 + j * 8 + (lane & 3) * 2;
        const float2 s = *reinterpret_cast<const float2*>(sd + n0 + n);
        const float2 b = *reinterpret_cast<const float2*>(bd + n0 + n);
#pragma unroll
        for (int i = 0; i < kMT; ++i)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int m = (wm * kMT + i) * 16 + (lane >> 2) + half * 8;
            const float* a = acc[i][j] + 2 * half;
            *reinterpret_cast<__nv_bfloat162*>(outs + m * kLdB + n) =
                __floats2bfloat162_rn(a[0] * s.x + b.x, a[1] * s.y + b.y);
          }
      }
    } else {
      // identity: x's channels [n0, n0 + kN3) at the tile's pixels; the
      // conv3 pipeline below waits for these copies
      for (int v = tid; v < kTilePix * (kN3 / 8); v += kThreads) {
        const int m = v / (kN3 / 8);
        const int q = v % (kN3 / 8);
        const int gy = y0 + m / kTW;
        const int gx = x0 + m % kTW;
        const bool ok = gy < H && gx < W;
        cp_async16(outs + m * kLdB + q * 8,
                   ok ? ximg + ((size_t)gy * W + gx) * Cin + n0 + q * 8 : ximg,
                   ok);
      }
      cp_async_commit();
    }

    zero(acc);
    pipeline(
        P / kKC,
        [&](int s, int c) {
          load_b<kN3>(sbs + s * kBStage, w3, Cout, c * kKC, n0, tid);
        },
        [&](int s, int c) {
          const bf16* base =
              h2s + (lane & 15) * ldp + c * kKC + (lane >> 4) * 8;
          mma_chunk<kMT, kNT3>(
              acc, [&](int i) { return base + (wm * kMT + i) * 16 * ldp; },
              sbs + s * kBStage, wn * 8 * kNT3, lane);
        });
#pragma unroll
    for (int j = 0; j < kNT3; ++j) {
      const int n = wn * 8 * kNT3 + j * 8 + (lane & 3) * 2;
      const float2 s = *reinterpret_cast<const float2*>(s3 + n0 + n);
      const float2 b = *reinterpret_cast<const float2*>(b3 + n0 + n);
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int m = (wm * kMT + i) * 16 + (lane >> 2) + half * 8;
          const float* a = acc[i][j] + 2 * half;
          __nv_bfloat162* o =
              reinterpret_cast<__nv_bfloat162*>(outs + m * kLdB + n);
          const float2 r = __bfloat1622float2(*o);
          const float h0 = round_bf16(a[0] * s.x + b.x);
          const float h1 = round_bf16(a[1] * s.y + b.y);
          *o = __floats2bfloat162_rn(fmaxf(round_bf16(h0 + r.x), 0.f),
                                     fmaxf(round_bf16(h1 + r.y), 0.f));
        }
    }
    __syncthreads();
    for (int v = tid; v < kTilePix * (kN3 / 8); v += kThreads) {
      const int m = v / (kN3 / 8);
      const int q = v % (kN3 / 8);
      const int gy = y0 + m / kTW;
      const int gx = x0 + m % kTW;
      if (gy < H && gx < W)
        *reinterpret_cast<uint4*>(
            out + (((size_t)img * H + gy) * W + gx) * Cout + n0 + q * 8) =
            *reinterpret_cast<const uint4*>(outs + m * kLdB + q * 8);
    }
    __syncthreads();
  }
}

template <int NT>
int launch(const bf16* x, const bf16* w, const float* sb, bf16* out, int B,
           int H, int W, int Cin, int P, int Cout, int has_down,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(P, has_down);
  cudaError_t err = cudaFuncSetAttribute(
      bottleneck_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(bottleneck_kernel<NT>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(((H + kTH - 1) / kTH) * ((W + kTW - 1) / kTW), B);
  bottleneck_kernel<NT><<<grid, kThreads, smem, stream>>>(
      x, w, sb, out, H, W, Cin, P, Cout, has_down);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// Dynamic shared memory of a launch with P planes, in bytes.
extern "C" int fused_bottleneck_smem_bytes(int P, int has_down) {
  return (int)smem_bytes(P, has_down);
}

// x: (B, H, W, Cin) bf16 (NHWC, i.e. NCHW in channels_last).
// w: bf16 [w1 (Cin, P) | w2 (9 P, P), rows (ky, kx, cin) | w3 (P, Cout) |
//    wd (Cin, Cout) if has_down]; sb: fp32 [s1 b1 s2 b2 (P each) | s3 b3
//    (Cout each) | sd bd (Cout each) if has_down], the folded BNs.
// out: (B, H, W, Cout) bf16. Needs Cin % 32 == 0, P == 64 or P % 128 == 0,
// Cout % 128 == 0, Cin == Cout without a downsample, 16-byte aligned
// pointers and smem_bytes(P, has_down) <= 232448 (ops/bottleneck.py check_launch).
// Returns a cudaError_t: 0 once the launch is enqueued on `stream`.
extern "C" int fused_bottleneck_bf16(const void* x, const void* w,
                                     const void* sb, void* out, int B, int H,
                                     int W, int Cin, int P, int Cout,
                                     int has_down, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || Cin % kKC != 0 ||
      Cout % kN3 != 0 || !(P == 64 || (P > 0 && P % 128 == 0)) ||
      (!has_down && Cin != Cout) ||
      smem_bytes(P, has_down) > (size_t)kSmemLimit ||
      !aligned16(x) || !aligned16(w) || !aligned16(sb) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  const float* sbf = static_cast<const float*>(sb);
  bf16* ob = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (P == 64)
    return launch<2>(xb, wb, sbf, ob, B, H, W, Cin, P, Cout, has_down, st);
  return launch<4>(xb, wb, sbf, ob, B, H, W, Cin, P, Cout, has_down, st);
}
