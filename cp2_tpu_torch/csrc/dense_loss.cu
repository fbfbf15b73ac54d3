// CP2 dense pair loss for Hopper (sm_90a): forward and backward on the
// tensor cores.
//
// Replaces the Pallas TPU kernels of cp2_tpu/ops/pallas/dense_loss.py:
//   _fwd_kernel (:77, pallas_call :177) -> fwd_kernel below (one launch)
//   _bwd_kernel (:107, pallas_call :222) -> bwd_kernel<DK=true> (dk) and
//                                          bwd_kernel<DK=false> (dq)
//
// Per sample n, with q, k (S, C), masks a, b (S), T the temperature,
// A = sum(a), B = sum(b), logit[x][y] = q_x . k_y / T:
//   lse_y  = logsumexp_x logit[x][y]          (softmax over QUERIES)
//   s_y    = sum_x a_x logit[x][y]
//   loss   = mean_n sum_y b_y (A lse_y - s_y) / max(A B, 1e-12)
//   d sim[x][y] = g b_y (A exp(logit[x][y] - lse_y) - a_x) / (T N max(A B, 1e-12))
//   dq_x = sum_y d sim[x][y] k_y,   dk_y = sum_x d sim[x][y] q_x
//
// What bounds it on an H100.  The step feeds float32 operands, and the
// products run as 3xTF32 on the tensor cores (below): 3 x 2 N S^4 C
// operations at 495 TFLOP/s.  At the CP2 step's shape (N=32, S=196,
// C=128) the forward moves 6.5 MB (1.9 us at 3.35 TB/s) and does
// 3 x 0.315 GFLOP (1.9 us), so neither bound dominates and 128 blocks on
// 132 SMs leave it bound by latency; at S=1024 or 4096 the products bound
// it.  bfloat16 operands take one bf16 product at 989 TFLOP/s.
//
// Why 3xTF32.  The tensor cores read a float32 operand as TF32: they drop
// its low 13 mantissa bits.  One TF32 pass puts the gradients 9e-4..1.2e-3
// (of their largest element) from float64 at N=32, S=196, C=128 and at
// N=8, S=1024, C=128, ten times the 1e-4 the JAX package's tests hold, and
// the loss at T=0.2 2.5e-5 away (rtol 2e-5).  So each float32 operand x is
// split as big = x with its low 13 bits cleared and small = x - big (exact),
// and acc += big.big + big.small + small.big is three wgmma; the error is
// then 5e-7 on the gradients and 2e-11 on the loss, that of float32.  A
// tile as TMA lands it serves as big (the tensor cores drop the low bits
// themselves; were they to round instead, the card's checks against the
// float32 version would miss their tolerance by ten), and threads write
// only small beside it.  Tiles that threads write anyway (the transposed
// chunk and d sim of the backward) store big explicitly.
//
// Design: the column softmax over queries is flash attention with the
// roles swapped.  A block owns (tile of 64 stationary rows, sample): key
// rows in the forward and in the dk pass, query rows in the dq pass.  One
// consumer warpgroup (128 threads) runs wgmma.mma_async with the
// stationary tile as A (M = 64) and STREAMED chunks of the other side as
// B; one producer warp brings every tile in by TMA (cp.async.bulk.tensor,
// 128-byte swizzle, rows past S zero-filled by the hardware) through a
// ring of STAGES slabs with a full and an empty mbarrier per slab.
//
//   Slabs.  Both operands are cut along the channel axis into slabs of
//   128 bytes a row (32 float32 or 64 bfloat16: C = 128 float32 is 4
//   slabs), the width of the 128-byte swizzle, and the ring streams
//   (chunk, slab) pairs, so shared memory holds the stationary tile plus
//   STAGES slabs of one chunk, whatever C and S are.  Each slab adds its
//   W/K k-steps of wgmma into the chunk's accumulator.  The small parts of
//   streamed slabs have two buffers, so the threads split slab r + 1
//   while slab r's products run (the float32 forward at C = 256 has room
//   for one, and splits between them).
//
//   Forward.  Chunks of NQ = 200 queries (one chunk covers S = 196 with 2 %
//   padding).  The accumulator holds logits transposed, keys x queries, so
//   the softmax over queries is a row reduction: thread-local, then two
//   shuffles inside the quad.  An online max, sum-exp (base 2, ex2.approx)
//   and s_y per key row run across chunks, so S has no upper bound; the
//   chunk's query mask is staged in shared memory.  Each block writes its
//   partial, already divided by max(A B, 1e-12); the last block to take a
//   ticket (atomicInc behind __threadfence, which wraps the counter back
//   to 0 for the next call) sums all N x tiles partials in a fixed order
//   and writes the mean: one launch, deterministic, no float atomics.
//   The ticket is the caller's, one per stream and one per forward
//   captured in a CUDA graph (ops/dense_loss.py), so forwards that may run
//   at the same time do not share it.
//
//   Backward.  Two passes as before, each block owning its output rows
//   (no atomics): dq over query tiles streaming key chunks, dk over key
//   tiles streaming query chunks, from the saved lse.  Chunks of NB = 64
//   rows (32 for float32 at C = 256, for shared memory).  The first
//   product forms the chunk's logits; d sim is computed in registers and
//   written to shared memory as the A operand of the second product,
//   out += d sim . chunk, one wgmma of N = C per k-step.  wgmma reads a
//   float32 B operand only K-major, so the threads that split each
//   streamed slab also write its transpose (channels x chunk rows) for
//   that second product.
//
// Shared memory at C = 128, float32: forward 64 KB stationary (big and
// small) + 50 KB ring + 50 KB small parts; backward 64 KB stationary +
// 16 + 16 KB ring and small parts + 64 KB transposed chunk + 32 KB d sim.
// C is a template parameter (32, 64, 128 or 256; the wrapper zero-pads C
// up to one of these).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;                   // stationary rows of a block (wgmma M)
constexpr int NQ = 200;                    // queries per streamed chunk, forward
constexpr int STAGES = 2;                  // slabs in flight
constexpr int CONSUMERS = 128;             // one warpgroup
constexpr int THREADS = CONSUMERS + 32;    // and one producer warp
constexpr int ROW = 128;                   // bytes per swizzled row
constexpr int MAX_SMEM = 232448;           // dynamic shared memory a block may have

template <typename T>
struct Op;
template <>
struct Op<float> {
  static constexpr int W = 32;             // elements per 128-byte row
  static constexpr int K = 8;              // depth of one wgmma
  static constexpr bool SPLIT = true;      // 3xTF32
  static constexpr CUtensorMapDataType TMA = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};
template <>
struct Op<__nv_bfloat16> {
  static constexpr int W = 64;
  static constexpr int K = 16;
  static constexpr bool SPLIT = false;
  static constexpr CUtensorMapDataType TMA = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};

// ---------------------------------------------------------------------------
// shared memory, barriers, TMA, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of element e of row r in a tile of 128-byte rows with the
// 128-byte swizzle (16-byte chunk c of row r sits at chunk c ^ (r % 8));
// tiles start 1024-byte aligned
template <typename T>
__device__ __forceinline__ uint32_t swz(int r, int e) {
  const int b = e * (int)sizeof(T);
  return r * ROW + ((((b >> 4) ^ r) & 7) << 4) + (b & 15);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// rows [c1, c1 + box rows) x channels [c0, c0 + W) of sample c2 into dst
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// generic-proxy writes to shared memory made visible to wgmma
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 128;" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keep the compiler from moving accumulator accesses across a wgmma and its wait
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma descriptor of a K-major tile of 128-byte swizzled rows: start
// address, leading offset 1 (unused when swizzled), stride 1024 bytes
// between 8-row groups, 128-byte swizzle.  k-step kk of a row adds 2 * kk.
__device__ __forceinline__ uint64_t desc(const void* tile) {
  return (uint64_t)((smem_u32(tile) & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

// D (64 x N, float32, the wgmma fragment) += A (64 x K) . B (N x K)^T, both
// K-major in shared memory.  Fragment: d[4 j + 2 i + e] is row
// 16 warp + lane / 4 + 8 i, column 8 j + 2 (lane % 4) + e.
template <typename T, int N>
struct Mma;

// The R = N / 2 accumulator registers are operands 3 .. R + 2 of the asm,
// after the descriptors a, b and the scale-d flag (operands 0, 1, 2).
#define CP2_REGS16 "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18"
#define CP2_REGS32 CP2_REGS16 ", %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34"
#define CP2_REGS64 CP2_REGS32 ", %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66"
#define CP2_REGS100 CP2_REGS64 ", %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102"
#define CP2_REGS128 CP2_REGS100 ", %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127, %128, %129, %130"
#define CP2_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define CP2_D8(i) CP2_D4(i), CP2_D4(i + 4)
#define CP2_D16 CP2_D8(0), CP2_D8(8)
#define CP2_D32 CP2_D16, CP2_D8(16), CP2_D8(24)
#define CP2_D64 CP2_D32, CP2_D8(32), CP2_D8(40), CP2_D8(48), CP2_D8(56)
#define CP2_D100 CP2_D64, CP2_D8(64), CP2_D8(72), CP2_D8(80), CP2_D8(88), CP2_D4(96)
#define CP2_D128 CP2_D100, CP2_D4(100), CP2_D8(104), CP2_D8(112), CP2_D8(120)

// wgmma.mma_async m64nN with both operands in shared memory; TAIL: the
// bf16 form's transpose flags of A and B (0, 0: both K-major)
#define CP2_MMA(T, N, R, KTYPE, TAIL)                                                    \
  template <>                                                                           \
  struct Mma<T, N> {                                                                    \
    __device__ __forceinline__ static void run(float (&d)[R], uint64_t a, uint64_t b) { \
      uint32_t scale_d = 1;                                                             \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n"                         \
                   "wgmma.mma_async.sync.aligned.m64n" #N KTYPE " {" CP2_REGS##R "}, "  \
                   "%0, %1, p, 1, 1" TAIL ";\n}\n"                                      \
                   : "+l"(a), "+l"(b), "+r"(scale_d), CP2_D##R);                        \
    }                                                                                   \
  };

CP2_MMA(float, 32, 16, "k8.f32.tf32.tf32", "")
CP2_MMA(float, 64, 32, "k8.f32.tf32.tf32", "")
CP2_MMA(float, 128, 64, "k8.f32.tf32.tf32", "")
CP2_MMA(float, 200, 100, "k8.f32.tf32.tf32", "")
CP2_MMA(float, 256, 128, "k8.f32.tf32.tf32", "")
CP2_MMA(__nv_bfloat16, 64, 32, "k16.f32.bf16.bf16", ", 0, 0")
CP2_MMA(__nv_bfloat16, 128, 64, "k16.f32.bf16.bf16", ", 0, 0")
CP2_MMA(__nv_bfloat16, 200, 100, "k16.f32.bf16.bf16", ", 0, 0")
CP2_MMA(__nv_bfloat16, 256, 128, "k16.f32.bf16.bf16", ", 0, 0")

#undef CP2_MMA
#undef CP2_D128
#undef CP2_D100
#undef CP2_D64
#undef CP2_D32
#undef CP2_D16
#undef CP2_D8
#undef CP2_D4
#undef CP2_REGS128
#undef CP2_REGS100
#undef CP2_REGS64
#undef CP2_REGS32
#undef CP2_REGS16

// x = big + small, big with the low 13 mantissa bits cleared (TF32)
__device__ __forceinline__ float tf32_big(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xFFFFE000u);
}

// 2^x, flushing results below 2^-126 to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the small parts of the ROWS x 128-byte tile at src, to dst; src stays as
// it is and serves as big, since the tensor cores read it as TF32.  All
// loads first.
template <int ROWS>
__device__ __forceinline__ void split_tile(const uint8_t* src, uint8_t* dst) {
  constexpr int CHUNKS = ROWS * 8, PER = (CHUNKS + CONSUMERS - 1) / CONSUMERS;
  float4 v[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = threadIdx.x + k * CONSUMERS;
    if (CHUNKS % CONSUMERS == 0 || i < CHUNKS)
      v[k] = *reinterpret_cast<const float4*>(src + 16 * i);
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = threadIdx.x + k * CONSUMERS;
    if (CHUNKS % CONSUMERS == 0 || i < CHUNKS)
      *reinterpret_cast<float4*>(dst + 16 * i) =
          make_float4(v[k].x - tf32_big(v[k].x), v[k].y - tf32_big(v[k].y),
                      v[k].z - tf32_big(v[k].z), v[k].w - tf32_big(v[k].w));
  }
}

// one streamed slab of the backward (NB rows x 128 bytes, channels
// s W .. s W + W): its small parts to small (float32), and its transpose,
// channels x rows, into the KB tiles of N2 rows at kt (and the small
// parts at kt + KT).  Lane takes chunk row g * 32 + lane, 16-byte chunk j
// of it; all loads first.
template <typename T, int NB, int N2, int KT>
__device__ __forceinline__ void split_transpose(const uint8_t* slab, uint8_t* small, uint8_t* kt,
                                                int s) {
  constexpr int W = Op<T>::W, V = 16 / (int)sizeof(T), IT = (NB / 32) * 8 / 4;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  uint4 raw[IT];
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    const int gj = warp + 4 * it, r = (gj / 8) * 32 + lane, j = gj % 8;
    raw[it] = *reinterpret_cast<const uint4*>(slab + r * ROW + (((j ^ r) & 7) << 4));
  }
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    const int gj = warp + 4 * it, r = (gj / 8) * 32 + lane, j = gj % 8;
    uint8_t* kt_r = kt + (r / W) * N2 * ROW;
    if constexpr (Op<T>::SPLIT) {
      const float x[4] = {__uint_as_float(raw[it].x), __uint_as_float(raw[it].y),
                          __uint_as_float(raw[it].z), __uint_as_float(raw[it].w)};
      *reinterpret_cast<float4*>(small + r * ROW + (((j ^ r) & 7) << 4)) =
          make_float4(x[0] - tf32_big(x[0]), x[1] - tf32_big(x[1]), x[2] - tf32_big(x[2]),
                      x[3] - tf32_big(x[3]));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t o = swz<float>(s * W + j * 4 + e, r % W);
        const float big = tf32_big(x[e]);
        *reinterpret_cast<float*>(kt_r + o) = big;
        *reinterpret_cast<float*>(kt_r + KT + o) = x[e] - big;
      }
    } else {
      const uint32_t x[4] = {raw[it].x, raw[it].y, raw[it].z, raw[it].w};
#pragma unroll
      for (int e = 0; e < V; ++e)
        *reinterpret_cast<uint16_t*>(kt_r + swz<T>(s * W + j * V + e, r % W)) =
            (uint16_t)(x[e / 2] >> (16 * (e % 2)));
    }
  }
}

// sum over the 128 consumer threads, the same in every thread; red: 4 floats
__device__ __forceinline__ float consumers_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  consumers_sync();
  const float total = (red[0] + red[1]) + (red[2] + red[3]);
  consumers_sync();
  return total;
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// the producer warp's lane 0: the stationary tile (all slabs, one
// barrier), then every (chunk, slab) of the streamed side through the ring
template <int NS, int ROWS, int SLAB_BYTES, int W>
__device__ __forceinline__ void produce(const CUtensorMap* stat_map, const CUtensorMap* strm_map,
                                        uint8_t* stat, uint8_t* ring, uint64_t* stat_full,
                                        uint64_t* full, uint64_t* empty, int r0, int n,
                                        int chunks) {
  mbar_expect_tx(stat_full, NS * TILE * ROW);
  for (int s = 0; s < NS; ++s) tma_load(stat + s * TILE * ROW, stat_map, stat_full, s * W, r0, n);
  int stage = 0;
  uint32_t phase = 0;
  for (int c = 0; c < chunks; ++c)
    for (int s = 0; s < NS; ++s) {
      mbar_wait(&empty[stage], phase ^ 1);
      mbar_expect_tx(&full[stage], SLAB_BYTES);
      tma_load(ring + stage * SLAB_BYTES, strm_map, &full[stage], s * W, c * ROWS, n);
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// byte offsets from the 1024-aligned base
template <typename T, int C>
struct FwdSmem {
  static constexpr int NS = (C + Op<T>::W - 1) / Op<T>::W;
  static constexpr int STAT = NS * TILE * ROW;
  static constexpr int SLAB = NQ * ROW;
  static constexpr int P = Op<T>::SPLIT ? 2 : 1;
  // small parts of streamed slabs: two (the next slab is split while the
  // current one's products run) where shared memory allows, else one
  static constexpr int REST =
      P * STAT + STAGES * SLAB + 2 * NQ * 4 + (1 + 2 * STAGES) * 8 + 32 + 1024;
  static constexpr int SMALLS = Op<T>::SPLIT && REST + 2 * SLAB > MAX_SMEM ? 1 : 2;
  static constexpr int stat = 0;
  static constexpr int stat_small = stat + STAT;
  static constexpr int ring = P * STAT;
  static constexpr int ring_small = ring + STAGES * SLAB;
  static constexpr int amask = ring_small + (Op<T>::SPLIT ? SMALLS * SLAB : 0);  // 2 x NQ floats
  static constexpr int bars = amask + 2 * NQ * 4;
  static constexpr int red = bars + (1 + 2 * STAGES) * 8;
  static constexpr int bytes = red + 8 * 4 + 1024;  // + alignment slack
  static_assert(bytes <= MAX_SMEM, "forward shared memory");
};

// one chunk's online update of the running (max, sum-exp) in base 2 and
// the linear sum of the key rows i (16 warp + lane / 4 + 8 i) over the
// chunk's queries x0 + 8 j + 2 (lane % 4) + e; FULL: every query < S
template <bool FULL>
__device__ __forceinline__ void online_update(const float (&acc)[NQ / 2], const float* amask,
                                              int x0, int S, float inv_t2, float (&m)[2],
                                              float (&l)[2], float (&lin)[2]) {
  const int c0 = 2 * (threadIdx.x & 3);
  float mn[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mt = -INFINITY;
#pragma unroll
    for (int j = 0; j < NQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (FULL || x0 + c0 + 8 * j + e < S) mt = fmaxf(mt, acc[4 * j + 2 * i + e]);
    mn[i] = fmaxf(m[i], mt * inv_t2);
    if (mn[i] != -INFINITY) l[i] *= ex2(m[i] - mn[i]);
  }
#pragma unroll
  for (int j = 0; j < NQ / 8; ++j) {
    const float2 ax = *reinterpret_cast<const float2*>(amask + c0 + 8 * j);
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (FULL || x0 + c0 + 8 * j + e < S)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          l[i] += ex2(fmaf(acc[4 * j + 2 * i + e], inv_t2, -mn[i]));
          lin[i] = fmaf(e ? ax.y : ax.x, acc[4 * j + 2 * i + e], lin[i]);
        }
  }
  m[0] = mn[0];
  m[1] = mn[1];
}

// grid (ceil(S / TILE), N): per key row lse_y; per block
// sum_y b_y (A lse_y - s_y) / max(A B, 1e-12) into partial[n * tiles + tile];
// the last block to take a ticket writes the loss and leaves *ticket at 0
template <typename T, int C>
__global__ void __launch_bounds__(THREADS, 1)
fwd_kernel(const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap qmap,
           const float* __restrict__ ma, const float* __restrict__ mb, int N, int S,
           float inv_t, float* __restrict__ lse_out, float* __restrict__ partial,
           float* __restrict__ loss, unsigned int* __restrict__ ticket) {
  using L = FwdSmem<T, C>;
  constexpr int W = Op<T>::W, K = Op<T>::K, NS = L::NS;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* stat_full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* full = stat_full + 1;
  uint64_t* empty = full + STAGES;
  float* red = reinterpret_cast<float*>(smem + L::red);

  const int n = blockIdx.y, y0 = blockIdx.x * TILE;
  const int chunks = (S + NQ - 1) / NQ;
  if (threadIdx.x == 0) {
    mbar_init(stat_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    fence_async_smem();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    if (threadIdx.x == CONSUMERS)
      produce<NS, NQ, L::SLAB, W>(&kmap, &qmap, smem + L::stat, smem + L::ring, stat_full, full,
                                  empty, y0, n, chunks);
    return;
  }

  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const float* an = ma + (size_t)n * S;
  const float* bn = mb + (size_t)n * S;
  float sa = 0.f, sb = 0.f;
  for (int i = t; i < S; i += CONSUMERS) {
    sa += an[i];
    sb += bn[i];
  }
  const float A = consumers_sum(sa, red);
  const float B = consumers_sum(sb, red);

  mbar_wait(stat_full, 0);
  if constexpr (Op<T>::SPLIT) split_tile<NS * TILE>(smem + L::stat, smem + L::stat_small);

  // per key row i (16 warp + lane / 4 + 8 i): running max and sum-exp of
  // the logits in base 2 (logit log2 e), and sum_x a_x q_x.k_y
  const float inv_t2 = inv_t * 1.4426950408889634f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, lin[2] = {0.f, 0.f};

  // round r is slab r % NS of chunk r / NS.  Preparing it: the chunk's
  // query mask (0 past S) at its first slab, the wait for the slab, and
  // its small parts.  With two small buffers round r + 1 is prepared while
  // round r's products run.
  constexpr int SMALLS = L::SMALLS;
  constexpr bool OVERLAP = SMALLS == 2;
  float* amask = reinterpret_cast<float*>(smem + L::amask);
  auto prepare = [&](int r, int st, uint32_t ph) {
    const int c = r / NS;
    if (r % NS == 0)
      for (int i = t; i < NQ; i += CONSUMERS)
        amask[(c & 1) * NQ + i] = c * NQ + i < S ? an[c * NQ + i] : 0.f;
    mbar_wait(&full[st], ph);
    if constexpr (Op<T>::SPLIT)
      split_tile<NQ>(smem + L::ring + st * L::SLAB,
                     smem + L::ring_small + (r % SMALLS) * L::SLAB);
  };

  const int rounds = chunks * NS;
  float acc[NQ / 2];
  int stage = 0;
  uint32_t phase = 0;
  prepare(0, 0, 0);
  fence_async_smem();
  consumers_sync();
  for (int r = 0; r < rounds; ++r) {
    const int s = r % NS, c = r / NS;
    if (s == 0)
#pragma unroll
      for (int i = 0; i < NQ / 2; ++i) acc[i] = 0.f;
    const uint64_t a = desc(smem + L::stat + s * TILE * ROW);
    const uint64_t b = desc(smem + L::ring + stage * L::SLAB);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < W / K; ++kk) {
      if constexpr (Op<T>::SPLIT) {
        const uint64_t as = desc(smem + L::stat_small + s * TILE * ROW);
        const uint64_t bs = desc(smem + L::ring_small + (r % SMALLS) * L::SLAB);
        Mma<T, NQ>::run(acc, a + 2 * kk, bs + 2 * kk);
        Mma<T, NQ>::run(acc, as + 2 * kk, b + 2 * kk);
      }
      Mma<T, NQ>::run(acc, a + 2 * kk, b + 2 * kk);
    }
    wgmma_commit();
    const int next = stage + 1 == STAGES ? 0 : stage + 1;
    const uint32_t next_phase = next == 0 ? phase ^ 1 : phase;
    const bool more = r + 1 < rounds;
    if (OVERLAP && more) prepare(r + 1, next, next_phase);
    wgmma_wait();
    fence_regs(acc);
    mbar_arrive(&empty[stage]);
    if (!OVERLAP && more) {
      consumers_sync();  // every warp's products are done with the one small buffer
      prepare(r + 1, next, next_phase);
    }
    stage = next;
    phase = next_phase;
    if (s == NS - 1) {
      if ((c + 1) * NQ <= S)
        online_update<true>(acc, amask + (c & 1) * NQ, c * NQ, S, inv_t2, m, l, lin);
      else
        online_update<false>(acc, amask + (c & 1) * NQ, c * NQ, S, inv_t2, m, l, lin);
    }
    if (more) {
      fence_async_smem();
      consumers_sync();
    }
  }

  // merge the quad's statistics of each key row
  float contrib = 0.f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    float sum = m[i] == -INFINITY ? 0.f : l[i] * ex2(m[i] - mx);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    float s = lin[i] + __shfl_xor_sync(0xffffffffu, lin[i], 1);
    s = (s + __shfl_xor_sync(0xffffffffu, s, 2)) * inv_t;
    const int y = y0 + 16 * warp + (lane >> 2) + 8 * i;
    if ((lane & 3) == 0 && y < S) {
      const float lse = (mx + log2f(sum)) * 0.6931471805599453f;
      lse_out[(size_t)n * S + y] = lse;
      contrib += bn[y] * (A * lse - s);
    }
  }
  const float total = consumers_sum(contrib, red);

  // the last block to finish sums every block's partial, in order
  const unsigned int blocks = gridDim.x * gridDim.y;
  unsigned int* last = reinterpret_cast<unsigned int*>(red + 4);
  if (t == 0) {
    partial[(size_t)n * gridDim.x + blockIdx.x] = total / fmaxf(A * B, 1e-12f);
    __threadfence();
    *last = atomicInc(ticket, blocks - 1) == blocks - 1;
  }
  consumers_sync();
  if (!*last) return;
  __threadfence();
  float sum = 0.f;
  for (unsigned int i = t; i < blocks; i += CONSUMERS) sum += __ldcg(partial + i);
  sum = consumers_sum(sum, red);
  if (t == 0) *loss = sum / N;
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

template <typename T, int C>
struct BwdSmem {
  static constexpr int W = Op<T>::W;
  static constexpr int NS = (C + W - 1) / W;
  static constexpr int NB = (sizeof(T) == 4 && C > 128) ? 32 : 64;  // rows per chunk
  static constexpr int KB = NB / W;  // 128-byte row blocks of a chunk along its rows
  static constexpr int STAT = NS * TILE * ROW;
  static constexpr int SLAB = NB * ROW;
  static constexpr int N2 = NS * W;  // channels, C rounded up to a slab
  static constexpr int KT = KB * N2 * ROW;  // the chunk transposed: KB tiles of N2 rows
  static constexpr int DS = KB * TILE * ROW;    // d sim: KB tiles of 64 rows
  static constexpr int P = Op<T>::SPLIT ? 2 : 1;
  static constexpr int stat = 0;
  static constexpr int ring = stat + P * STAT;  // stationary big [, small]
  static constexpr int ring_small = ring + STAGES * SLAB;  // two: see the forward
  static constexpr int kt = ring_small + (P - 1) * 2 * SLAB;
  static constexpr int ds = kt + P * KT;
  static constexpr int colv = ds + P * DS;  // 2 buffers x 2 values x NB floats
  static constexpr int bars = colv + 4 * NB * 4;
  static constexpr int red = bars + (1 + 2 * STAGES) * 8;
  static constexpr int bytes = red + 8 * 4 + 1024;
  static_assert(bytes <= MAX_SMEM, "backward shared memory");
};

// grid (ceil(S / TILE), N).  DK: the block's stationary rows are keys y and
// it streams queries x, writing dk; otherwise stationary queries x
// streaming keys y, writing dq.  out[r] = sum_s dsim[r][s] * streamed[s].
template <typename T, int C, bool DK>
__global__ void __launch_bounds__(THREADS, 1)
bwd_kernel(const __grid_constant__ CUtensorMap stat_map,
           const __grid_constant__ CUtensorMap strm_map, const float* __restrict__ ma,
           const float* __restrict__ mb, const float* __restrict__ lse,
           const float* __restrict__ gout, int N, int S, float inv_t,
           float* __restrict__ grad) {
  using L = BwdSmem<T, C>;
  constexpr int W = L::W, K = Op<T>::K, NS = L::NS, NB = L::NB, KB = L::KB, N2 = L::N2;
  constexpr bool SPLIT = Op<T>::SPLIT;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* stat_full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* full = stat_full + 1;
  uint64_t* empty = full + STAGES;
  float* red = reinterpret_cast<float*>(smem + L::red);

  const int n = blockIdx.y, r0 = blockIdx.x * TILE;
  const int chunks = (S + NB - 1) / NB;
  if (threadIdx.x == 0) {
    mbar_init(stat_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    fence_async_smem();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    if (threadIdx.x == CONSUMERS)
      produce<NS, NB, L::SLAB, W>(&stat_map, &strm_map, smem + L::stat, smem + L::ring,
                                  stat_full, full, empty, r0, n, chunks);
    return;
  }

  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const float* an = ma + (size_t)n * S;
  const float* bn = mb + (size_t)n * S;
  const float* ln = lse + (size_t)n * S;
  float sa = 0.f, sb = 0.f;
  for (int i = t; i < S; i += CONSUMERS) {
    sa += an[i];
    sb += bn[i];
  }
  const float A = consumers_sum(sa, red);
  const float B = consumers_sum(sb, red);
  const float scale = gout[0] * inv_t / ((float)N * fmaxf(A * B, 1e-12f));
  constexpr float LOG2E = 1.4426950408889634f;
  const float inv_t2 = inv_t * LOG2E;  // p = 2^(q.k inv_t2 - lse log2 e)

  // the stationary rows' own values: b and lse (keys) or a (queries)
  float row_a[2], row_b[2], row_lse[2];
  bool row_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 16 * warp + (lane >> 2) + 8 * i;
    row_ok[i] = r < S;
    row_a[i] = row_ok[i] && !DK ? an[r] : 0.f;
    row_b[i] = row_ok[i] && DK ? bn[r] : 0.f;
    row_lse[i] = row_ok[i] && DK ? ln[r] * LOG2E : 0.f;
  }

  mbar_wait(stat_full, 0);
  if constexpr (SPLIT) split_tile<NS * TILE>(smem + L::stat, smem + L::stat + L::STAT);

  float out[N2 / 2];
#pragma unroll
  for (int i = 0; i < N2 / 2; ++i) out[i] = 0.f;

  int stage = 0;
  uint32_t phase = 0;
  for (int c = 0; c < chunks; ++c) {
    // the chunk's own values, read after the first slab's barrier: b and
    // lse log2 e (keys) or a (queries), 0 past S
    float* colv = reinterpret_cast<float*>(smem + L::colv) + (c & 1) * 2 * NB;
    if (t < NB) {
      const int x = c * NB + t;
      colv[t] = x < S ? (DK ? an[x] : bn[x]) : 0.f;
      colv[NB + t] = !DK && x < S ? ln[x] * LOG2E : 0.f;
    }
    float acc[NB / 2];
#pragma unroll
    for (int i = 0; i < NB / 2; ++i) acc[i] = 0.f;
    // the chunk's first product, slab by slab; slab s + 1 is split while
    // slab s's products run (small parts in two buffers)
    mbar_wait(&full[stage], phase);
    split_transpose<T, NB, N2, L::KT>(smem + L::ring + stage * L::SLAB, smem + L::ring_small,
                                      smem + L::kt, 0);
    fence_async_smem();
    consumers_sync();
    for (int s = 0; s < NS; ++s) {
      const uint64_t a = desc(smem + L::stat + s * TILE * ROW);
      const uint64_t b = desc(smem + L::ring + stage * L::SLAB);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < W / K; ++kk) {
        if constexpr (SPLIT) {
          const uint64_t as = desc(smem + L::stat + L::STAT + s * TILE * ROW);
          const uint64_t bs = desc(smem + L::ring_small + (s & 1) * L::SLAB);
          Mma<T, NB>::run(acc, a + 2 * kk, bs + 2 * kk);
          Mma<T, NB>::run(acc, as + 2 * kk, b + 2 * kk);
        }
        Mma<T, NB>::run(acc, a + 2 * kk, b + 2 * kk);
      }
      wgmma_commit();
      const int next = stage + 1 == STAGES ? 0 : stage + 1;
      const uint32_t next_phase = next == 0 ? phase ^ 1 : phase;
      if (s + 1 < NS) {
        mbar_wait(&full[next], next_phase);
        split_transpose<T, NB, N2, L::KT>(smem + L::ring + next * L::SLAB,
                                          smem + L::ring_small + ((s + 1) & 1) * L::SLAB,
                                          smem + L::kt, s + 1);
      }
      wgmma_wait();
      fence_regs(acc);
      mbar_arrive(&empty[stage]);
      stage = next;
      phase = next_phase;
      if (s + 1 < NS) {
        fence_async_smem();
        consumers_sync();
      }
    }

    // d sim of the chunk, written as the A operand of the second product
#pragma unroll
    for (int j = 0; j < NB / 8; ++j) {
      const int col = 8 * j + 2 * (lane & 3);
      const float2 v0 = *reinterpret_cast<const float2*>(colv + col);
      const float2 v1 = *reinterpret_cast<const float2*>(colv + NB + col);
      float d[2][2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = c * NB + col + e < S;
        const float cv0 = e ? v0.y : v0.x, cv1 = e ? v1.y : v1.x;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float b_y = DK ? row_b[i] : cv0;
          const float lse_y = DK ? row_lse[i] : cv1;
          const float a_x = DK ? cv0 : row_a[i];
          const float p = ex2(fmaf(acc[4 * j + 2 * i + e], inv_t2, -lse_y));
          d[i][e] = ok && row_ok[i] ? scale * b_y * (A * p - a_x) : 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = 16 * warp + (lane >> 2) + 8 * i;
        uint8_t* ds = smem + L::ds + (col / W) * TILE * ROW + swz<T>(row, col % W);
        if constexpr (SPLIT) {
          const float b0 = tf32_big(d[i][0]), b1 = tf32_big(d[i][1]);
          *reinterpret_cast<float2*>(ds) = make_float2(b0, b1);
          *reinterpret_cast<float2*>(ds + L::DS) = make_float2(d[i][0] - b0, d[i][1] - b1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(ds) = __floats2bfloat162_rn(d[i][0], d[i][1]);
        }
      }
    }
    fence_async_smem();
    consumers_sync();

    // out (64 x C) += d sim (64 x NB) . chunk (NB x C), all channels at once
    fence_regs(out);
    wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < KB; ++kb) {
      const uint64_t a = desc(smem + L::ds + kb * TILE * ROW);
      const uint64_t b = desc(smem + L::kt + kb * N2 * ROW);
#pragma unroll
      for (int kk = 0; kk < W / K; ++kk) {
        if constexpr (SPLIT) {
          Mma<T, N2>::run(out, a + 2 * kk, b + (L::KT >> 4) + 2 * kk);
          Mma<T, N2>::run(out, a + (L::DS >> 4) + 2 * kk, b + 2 * kk);
        }
        Mma<T, N2>::run(out, a + 2 * kk, b + 2 * kk);
      }
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(out);
    // a warp's wait covers its own part of the product only: every warp is
    // done with kt and d sim before the next chunk writes them
    if (c + 1 < chunks) consumers_sync();
  }

  float* gn = grad + (size_t)n * S * C;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 16 * warp + (lane >> 2) + 8 * i;
    if (!row_ok[i]) continue;
#pragma unroll
    for (int j = 0; j < N2 / 8; ++j) {
      const int col = 8 * j + 2 * (lane & 3);
      if (col < C)
        *reinterpret_cast<float2*>(gn + (size_t)r * C + col) =
            make_float2(out[4 * j + 2 * i], out[4 * j + 2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// host side: tensor maps and launches
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, found through the runtime so that
// the library needs no link against libcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (N, S, C) row-major as a 3-D tensor map; boxes of W channels x rows x 1
// sample, 128-byte swizzle, zeros past S (and past C)
template <typename T>
cudaError_t make_map(CUtensorMap* map, const void* base, int N, int S, int C, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  // a libcuda call: the device's context has to be current on this thread,
  // which autograd's backward thread need not have made it yet
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)S, (cuuint64_t)N};
  const cuuint64_t strides[2] = {(cuuint64_t)C * sizeof(T), (cuuint64_t)S * C * sizeof(T)};
  const cuuint32_t box[3] = {(cuuint32_t)Op<T>::W, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r =
      encode(map, Op<T>::TMA, 3, const_cast<void*>(base), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// dynamic shared memory above 48 KB has to be allowed per kernel
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem_bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem_bytes);
}

template <typename T, int C>
cudaError_t fwd(const void* q, const void* k, const float* a, const float* b, int N, int S,
                float inv_t, float* lse, float* partial, float* loss, unsigned int* ticket,
                cudaStream_t stream) {
  CUtensorMap kmap, qmap;
  cudaError_t err = make_map<T>(&kmap, k, N, S, C, TILE);
  if (err == cudaSuccess) err = make_map<T>(&qmap, q, N, S, C, NQ);
  constexpr size_t smem = FwdSmem<T, C>::bytes;
  if (err == cudaSuccess) err = allow_smem(fwd_kernel<T, C>, smem);
  if (err != cudaSuccess) return err;
  fwd_kernel<T, C><<<dim3((S + TILE - 1) / TILE, N), THREADS, smem, stream>>>(
      kmap, qmap, a, b, N, S, inv_t, lse, partial, loss, ticket);
  return cudaGetLastError();
}

template <typename T, int C, bool DK>
cudaError_t bwd_one(const void* q, const void* k, const float* a, const float* b,
                    const float* lse, const float* g, int N, int S, float inv_t, float* grad,
                    cudaStream_t stream) {
  CUtensorMap stat_map, strm_map;
  cudaError_t err = make_map<T>(&stat_map, DK ? k : q, N, S, C, TILE);
  if (err == cudaSuccess) err = make_map<T>(&strm_map, DK ? q : k, N, S, C, BwdSmem<T, C>::NB);
  constexpr size_t smem = BwdSmem<T, C>::bytes;
  if (err == cudaSuccess) err = allow_smem(bwd_kernel<T, C, DK>, smem);
  if (err != cudaSuccess) return err;
  bwd_kernel<T, C, DK><<<dim3((S + TILE - 1) / TILE, N), THREADS, smem, stream>>>(
      stat_map, strm_map, a, b, lse, g, N, S, inv_t, grad);
  return cudaGetLastError();
}

template <typename T, int C>
cudaError_t bwd(const void* q, const void* k, const float* a, const float* b, const float* lse,
                const float* g, int N, int S, float inv_t, float* dq, float* dk,
                cudaStream_t stream) {
  cudaError_t err = cudaSuccess;
  if (dk != nullptr) err = bwd_one<T, C, true>(q, k, a, b, lse, g, N, S, inv_t, dk, stream);
  if (err != cudaSuccess || dq == nullptr) return err;
  return bwd_one<T, C, false>(q, k, a, b, lse, g, N, S, inv_t, dq, stream);
}

template <typename T>
cudaError_t fwd_dispatch(int C, const void* q, const void* k, const float* a, const float* b,
                         int N, int S, float inv_t, float* lse, float* partial, float* loss,
                         unsigned int* ticket, cudaStream_t stream) {
  switch (C) {
    case 32: return fwd<T, 32>(q, k, a, b, N, S, inv_t, lse, partial, loss, ticket, stream);
    case 64: return fwd<T, 64>(q, k, a, b, N, S, inv_t, lse, partial, loss, ticket, stream);
    case 128: return fwd<T, 128>(q, k, a, b, N, S, inv_t, lse, partial, loss, ticket, stream);
    case 256: return fwd<T, 256>(q, k, a, b, N, S, inv_t, lse, partial, loss, ticket, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t bwd_dispatch(int C, const void* q, const void* k, const float* a, const float* b,
                         const float* lse, const float* g, int N, int S, float inv_t, float* dq,
                         float* dk, cudaStream_t stream) {
  switch (C) {
    case 32: return bwd<T, 32>(q, k, a, b, lse, g, N, S, inv_t, dq, dk, stream);
    case 64: return bwd<T, 64>(q, k, a, b, lse, g, N, S, inv_t, dq, dk, stream);
    case 128: return bwd<T, 128>(q, k, a, b, lse, g, N, S, inv_t, dq, dk, stream);
    case 256: return bwd<T, 256>(q, k, a, b, lse, g, N, S, inv_t, dq, dk, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int cp2_dense_loss_tile(void) { return TILE; }

const char* cp2_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, k: (N, S, C) float32 (bf16 == 0) or bfloat16 (bf16 == 1), C in
// {32, 64, 128, 256}, 16-byte aligned; a, b: (N, S) float32.  Writes lse
// (N, S), partial (N, ceil(S / 64)) and the scalar loss, in one launch.
// ticket: one unsigned int on the device, 0 before the call and 0 after
// it; calls that may run at the same time need tickets of their own.
int cp2_dense_loss_fwd(const void* q, const void* k, const void* a, const void* b, int N, int S,
                       int C, int bf16, float inv_t, void* lse, void* partial, void* loss,
                       void* ticket, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  float* lf = static_cast<float*>(lse);
  float* pf = static_cast<float*>(partial);
  float* out = static_cast<float*>(loss);
  unsigned int* tk = static_cast<unsigned int*>(ticket);
  return bf16 ? fwd_dispatch<__nv_bfloat16>(C, q, k, af, bf, N, S, inv_t, lf, pf, out, tk, s)
              : fwd_dispatch<float>(C, q, k, af, bf, N, S, inv_t, lf, pf, out, tk, s);
}

// g: the upstream gradient (one float32 on the device).  dq, dk: (N, S, C)
// float32 outputs; either may be null to skip it.
int cp2_dense_loss_bwd(const void* q, const void* k, const void* a, const void* b,
                       const void* lse, const void* g, int N, int S, int C, int bf16,
                       float inv_t, void* dq, void* dk, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  const float* lf = static_cast<const float*>(lse);
  const float* gf = static_cast<const float*>(g);
  float* dqf = static_cast<float*>(dq);
  float* dkf = static_cast<float*>(dk);
  return bf16 ? bwd_dispatch<__nv_bfloat16>(C, q, k, af, bf, lf, gf, N, S, inv_t, dqf, dkf, s)
              : bwd_dispatch<float>(C, q, k, af, bf, lf, gf, N, S, inv_t, dqf, dkf, s);
}

}  // extern "C"
