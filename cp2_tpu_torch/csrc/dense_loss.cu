// CP2 dense pair loss for Hopper (sm_90a): forward and backward.
//
// Replaces the Pallas TPU kernels of cp2_tpu/ops/pallas/dense_loss.py:
//   _fwd_kernel (:77, pallas_call :177) -> fwd_tiles + fwd_reduce below
//   _bwd_kernel (:107, pallas_call :222) -> bwd_tiles<DK=true> (dk) and
//                                          bwd_tiles<DK=false> (dq)
//
// Per sample n, with q, k (S, C), masks a, b (S), T the temperature,
// A = sum(a), B = sum(b), logit[x][y] = q_x . k_y / T:
//   lse_y  = logsumexp_x logit[x][y]          (softmax over QUERIES)
//   s_y    = sum_x a_x logit[x][y]
//   loss   = mean_n sum_y b_y (A lse_y - s_y) / max(A B, 1e-12)
//   d sim[x][y] = g b_y (A exp(logit[x][y] - lse_y) - a_x) / (T N max(A B, 1e-12))
//   dq_x = sum_y d sim[x][y] k_y,   dk_y = sum_x d sim[x][y] q_x
//
// What bounds it on an H100: at the flagship shape (N=32, S=196, C=128)
// the forward is 2*32*196^2*128 = 0.31 GFLOP over 6.4 MB of float32 q/k —
// about 49 FLOP per byte, so the arithmetic bounds it (float32 FMA on the
// CUDA cores, 67 TFLOP/s, since the step's operands are float32); at the
// 512^2 shape (S=1024, N=8) it is 2.1 GFLOP over 8.4 MB.
//
// Design: the column softmax over queries is flash attention with the
// roles swapped.  A block owns (key tile of 64, sample) and STREAMS query
// tiles of 64 through shared memory, keeping an online max / sum-exp and
// the linear sum s_y per key column, so no (S, S) tensor exists anywhere
// and S has no upper bound (the TPU kernel kept the whole query axis in
// VMEM, S <= 2048).  Blocks run in parallel in no order, so the forward
// writes one partial per block and a one-block second pass reduces them;
// the forward also saves lse (N, S), so the backward forms
// p = exp(logit - lse) without a second softmax.  The backward is two
// deterministic passes without atomics: dk from blocks over key tiles
// streaming query tiles, dq from blocks over query tiles streaming key
// tiles.  Operands are float32 or bfloat16 (converted to float32 in shared
// memory); all arithmetic is float32 FMA on the CUDA cores — tensor cores
// (wgmma) and TMA are left for a later version.
//
// Each block: 256 threads as 16 x 16; a thread computes a 4 x 4 micro-tile
// of similarities, stationary rows tr + 16 i against streamed rows
// ts + 16 j, reading float4 along C from rows padded by 4 floats (no bank
// conflicts).  C is a template parameter (32, 64, 128 or 256; the wrapper
// zero-pads C up to one of these).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;
constexpr int THREADS = 256;
constexpr int PAD = 4;
constexpr int DS_STRIDE = TILE + PAD;

template <typename T>
__device__ __forceinline__ float4 load4(const T* p);

template <>
__device__ __forceinline__ float4 load4<float>(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <>
__device__ __forceinline__ float4 load4<__nv_bfloat16>(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// rows [row0, row0 + TILE) of a (S, C) matrix into shared memory (row
// stride C + PAD), rows past S as zeros
template <typename T, int C>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0, int S) {
  constexpr int C4 = C / 4;
  for (int i = threadIdx.x; i < TILE * C4; i += THREADS) {
    const int r = i / C4;
    const int c = (i % C4) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < S) v = load4<T>(src + (size_t)(row0 + r) * C + c);
    *reinterpret_cast<float4*>(dst + r * (C + PAD) + c) = v;
  }
}

// acc[i][j] = stat[tr + 16 i] . strm[ts + 16 j]
template <int C>
__device__ __forceinline__ void sim_tile(const float* stat, const float* strm,
                                         int tr, int ts, float acc[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < C; c += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(stat + (tr + 16 * i) * (C + PAD) + c);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(strm + (ts + 16 * j) * (C + PAD) + c);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = acc[i][j];
        s = fmaf(a[i].x, b[j].x, s);
        s = fmaf(a[i].y, b[j].y, s);
        s = fmaf(a[i].z, b[j].z, s);
        s = fmaf(a[i].w, b[j].w, s);
        acc[i][j] = s;
      }
  }
}

// sum over the block; every thread gets the total.  scratch: 32 floats.
__device__ float block_sum(float v, float* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = lane < (int)(blockDim.x / 32) ? scratch[lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ float row_sum(const float* v, int S, float* scratch) {
  float acc = 0.f;
  for (int i = threadIdx.x; i < S; i += blockDim.x) acc += v[i];
  return block_sum(acc, scratch);
}

constexpr size_t fwd_smem_floats(int C) {
  return 2 * TILE * (C + PAD) + TILE + 3 * 16 * TILE + 32;
}

constexpr size_t bwd_smem_floats(int C) {
  return 2 * TILE * (C + PAD) + TILE * DS_STRIDE + 4 * TILE + 32;
}

// grid (ceil(S / TILE), N): per key column lse_y, and per block
// sum_y b_y (A lse_y - s_y) into partial[n * tiles + tile]
template <typename T, int C>
__global__ void __launch_bounds__(THREADS)
fwd_tiles(const T* __restrict__ q, const T* __restrict__ k,
          const float* __restrict__ ma, const float* __restrict__ mb,
          int S, float inv_t, float* __restrict__ lse_out,
          float* __restrict__ partial) {
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                       // stationary key tile
  float* qs = ks + TILE * (C + PAD);      // streamed query tile
  float* as = qs + TILE * (C + PAD);      // query mask of the tile
  float* red = as + TILE;                 // 3 x 16 x TILE per-thread stats
  float* scratch = red + 3 * 16 * TILE;   // 32 floats

  const int n = blockIdx.y, y0 = blockIdx.x * TILE;
  const int t = threadIdx.x, tr = t % 16, ts = t / 16;
  const T* qn = q + (size_t)n * S * C;
  const T* kn = k + (size_t)n * S * C;
  const float* an = ma + (size_t)n * S;
  const float* bn = mb + (size_t)n * S;

  load_tile<T, C>(ks, kn, y0, S);
  const float A = row_sum(an, S, scratch);

  float m[4], l[4], s[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) { m[i] = -INFINITY; l[i] = 0.f; s[i] = 0.f; }

  for (int x0 = 0; x0 < S; x0 += TILE) {
    __syncthreads();  // the previous query tile is consumed
    load_tile<T, C>(qs, qn, x0, S);
    if (t < TILE) as[t] = x0 + t < S ? an[x0 + t] : 0.f;
    __syncthreads();
    float acc[4][4];
    sim_tile<C>(ks, qs, tr, ts, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v[4], mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = x0 + ts + 16 * j < S ? acc[i][j] * inv_t : -INFINITY;
        mt = fmaxf(mt, v[j]);
      }
      if (mt == -INFINITY) continue;  // none of this thread's queries is real
      const float mn = fmaxf(m[i], mt);
      float sum = l[i] * expf(m[i] - mn);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sum += expf(v[j] - mn);
        s[i] = fmaf(as[ts + 16 * j], acc[i][j] * inv_t, s[i]);
      }
      l[i] = sum;
      m[i] = mn;
    }
  }

  // merge the 16 partial (max, sum-exp, linear sum) of each key column
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr + 16 * i;
    red[ts * TILE + r] = m[i];
    red[16 * TILE + ts * TILE + r] = l[i];
    red[32 * TILE + ts * TILE + r] = s[i];
  }
  __syncthreads();
  float contrib = 0.f;
  if (t < TILE && y0 + t < S) {
    float mx = -INFINITY;
    for (int w = 0; w < 16; ++w) mx = fmaxf(mx, red[w * TILE + t]);
    float sum = 0.f, lin = 0.f;
    for (int w = 0; w < 16; ++w) {
      const float mw = red[w * TILE + t];
      if (mw != -INFINITY) sum += red[16 * TILE + w * TILE + t] * expf(mw - mx);
      lin += red[32 * TILE + w * TILE + t];
    }
    const float lse = mx + logf(sum);
    lse_out[(size_t)n * S + y0 + t] = lse;
    contrib = bn[y0 + t] * (A * lse - lin);
  }
  const float total = block_sum(contrib, scratch);
  if (t == 0) partial[(size_t)n * gridDim.x + blockIdx.x] = total;
}

// one block: loss = mean_n (sum of the sample's partials) / max(A B, 1e-12)
__global__ void __launch_bounds__(THREADS)
fwd_reduce(const float* __restrict__ ma, const float* __restrict__ mb,
           const float* __restrict__ partial, int N, int S, int tiles,
           float* __restrict__ loss) {
  __shared__ float scratch[32];
  float total = 0.f;
  for (int n = 0; n < N; ++n) {
    const float A = row_sum(ma + (size_t)n * S, S, scratch);
    const float B = row_sum(mb + (size_t)n * S, S, scratch);
    const float P = row_sum(partial + (size_t)n * tiles, tiles, scratch);
    total += P / fmaxf(A * B, 1e-12f);
  }
  if (threadIdx.x == 0) *loss = total / N;
}

// grid (ceil(S / TILE), N).  DK: the block's stationary rows are keys y and
// it streams queries x, writing dk; otherwise stationary queries x
// streaming keys y, writing dq.  out[r] = sum_s dsim[r][s] * streamed[s].
template <typename T, int C, bool DK>
__global__ void __launch_bounds__(THREADS)
bwd_tiles(const T* __restrict__ q, const T* __restrict__ k,
          const float* __restrict__ ma, const float* __restrict__ mb,
          const float* __restrict__ lse, const float* __restrict__ gout,
          int N, int S, float inv_t, float* __restrict__ grad) {
  extern __shared__ __align__(16) float smem[];
  float* st = smem;                       // stationary tile
  float* sm = st + TILE * (C + PAD);      // streamed tile
  float* dsT = sm + TILE * (C + PAD);     // dsim transposed: [s][r]
  float* st_mask = dsT + TILE * DS_STRIDE;
  float* st_lse = st_mask + TILE;
  float* sm_mask = st_lse + TILE;
  float* sm_lse = sm_mask + TILE;
  float* scratch = sm_lse + TILE;

  const int n = blockIdx.y, r0 = blockIdx.x * TILE;
  const int t = threadIdx.x, tr = t % 16, ts = t / 16;
  const T* stat_src = (DK ? k : q) + (size_t)n * S * C;
  const T* strm_src = (DK ? q : k) + (size_t)n * S * C;
  const float* an = ma + (size_t)n * S;
  const float* bn = mb + (size_t)n * S;
  const float* ln = lse + (size_t)n * S;
  // stationary rows carry b and lse (keys) or a (queries); streamed rows
  // the other side
  const float* st_mask_src = DK ? bn : an;
  const float* sm_mask_src = DK ? an : bn;

  const float A = row_sum(an, S, scratch);
  const float B = row_sum(bn, S, scratch);
  const float scale = gout[0] * inv_t / ((float)N * fmaxf(A * B, 1e-12f));

  load_tile<T, C>(st, stat_src, r0, S);
  if (t < TILE) {
    const bool ok = r0 + t < S;
    st_mask[t] = ok ? st_mask_src[r0 + t] : 0.f;
    st_lse[t] = ok && DK ? ln[r0 + t] : 0.f;
  }

  // output rows rg * 4 + i, columns ch * 32 + cl * 2 + e
  constexpr int CH = C / 32;
  const int rg = t / 16, cl = t % 16;
  float out[CH][8];
#pragma unroll
  for (int ch = 0; ch < CH; ++ch)
#pragma unroll
    for (int e = 0; e < 8; ++e) out[ch][e] = 0.f;

  for (int s0 = 0; s0 < S; s0 += TILE) {
    __syncthreads();  // the previous streamed tile and dsT are consumed
    load_tile<T, C>(sm, strm_src, s0, S);
    if (t < TILE) {
      const bool ok = s0 + t < S;
      sm_mask[t] = ok ? sm_mask_src[s0 + t] : 0.f;
      sm_lse[t] = ok && !DK ? ln[s0 + t] : 0.f;
    }
    __syncthreads();
    float acc[4][4];
    sim_tile<C>(st, sm, tr, ts, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tr + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int sj = ts + 16 * j;
        float d = 0.f;
        if (s0 + sj < S) {
          // key side: b and lse; query side: a
          const float b_y = DK ? st_mask[r] : sm_mask[sj];
          const float lse_y = DK ? st_lse[r] : sm_lse[sj];
          const float a_x = DK ? sm_mask[sj] : st_mask[r];
          const float p = expf(acc[i][j] * inv_t - lse_y);
          d = scale * b_y * (A * p - a_x);
        }
        dsT[sj * DS_STRIDE + r] = d;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int sj = 0; sj < TILE; ++sj) {
      const float4 dv = *reinterpret_cast<const float4*>(dsT + sj * DS_STRIDE + rg * 4);
#pragma unroll
      for (int ch = 0; ch < CH; ++ch) {
        const float2 sv =
            *reinterpret_cast<const float2*>(sm + sj * (C + PAD) + ch * 32 + cl * 2);
        out[ch][0] = fmaf(dv.x, sv.x, out[ch][0]);
        out[ch][1] = fmaf(dv.x, sv.y, out[ch][1]);
        out[ch][2] = fmaf(dv.y, sv.x, out[ch][2]);
        out[ch][3] = fmaf(dv.y, sv.y, out[ch][3]);
        out[ch][4] = fmaf(dv.z, sv.x, out[ch][4]);
        out[ch][5] = fmaf(dv.z, sv.y, out[ch][5]);
        out[ch][6] = fmaf(dv.w, sv.x, out[ch][6]);
        out[ch][7] = fmaf(dv.w, sv.y, out[ch][7]);
      }
    }
  }

  float* gn = grad + (size_t)n * S * C;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + rg * 4 + i;
    if (r >= S) continue;
#pragma unroll
    for (int ch = 0; ch < CH; ++ch)
      *reinterpret_cast<float2*>(gn + (size_t)r * C + ch * 32 + cl * 2) =
          make_float2(out[ch][2 * i], out[ch][2 * i + 1]);
  }
}

// dynamic shared memory above 48 KB has to be allowed per kernel
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem_bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem_bytes);
}

template <typename T, int C>
cudaError_t fwd(const void* q, const void* k, const float* a, const float* b,
                int N, int S, float inv_t, float* lse, float* partial,
                float* loss, cudaStream_t stream) {
  const int tiles = (S + TILE - 1) / TILE;
  const dim3 grid(tiles, N);
  const size_t smem = fwd_smem_floats(C) * sizeof(float);
  cudaError_t err = allow_smem(fwd_tiles<T, C>, smem);
  if (err != cudaSuccess) return err;
  fwd_tiles<T, C><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), a, b, S, inv_t, lse,
      partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fwd_reduce<<<1, THREADS, 0, stream>>>(a, b, partial, N, S, tiles, loss);
  return cudaGetLastError();
}

template <typename T, int C, bool DK>
cudaError_t bwd_one(const void* q, const void* k, const float* a, const float* b,
                    const float* lse, const float* g, int N, int S, float inv_t,
                    float* grad, cudaStream_t stream) {
  const dim3 grid((S + TILE - 1) / TILE, N);
  const size_t smem = bwd_smem_floats(C) * sizeof(float);
  cudaError_t err = allow_smem(bwd_tiles<T, C, DK>, smem);
  if (err != cudaSuccess) return err;
  bwd_tiles<T, C, DK><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), a, b, lse, g, N, S,
      inv_t, grad);
  return cudaGetLastError();
}

template <typename T, int C>
cudaError_t bwd(const void* q, const void* k, const float* a, const float* b,
                const float* lse, const float* g, int N, int S, float inv_t,
                float* dq, float* dk, cudaStream_t stream) {
  cudaError_t err = cudaSuccess;
  if (dk != nullptr) err = bwd_one<T, C, true>(q, k, a, b, lse, g, N, S, inv_t, dk, stream);
  if (err != cudaSuccess || dq == nullptr) return err;
  return bwd_one<T, C, false>(q, k, a, b, lse, g, N, S, inv_t, dq, stream);
}

template <typename T>
cudaError_t fwd_dispatch(int C, const void* q, const void* k, const float* a,
                         const float* b, int N, int S, float inv_t, float* lse,
                         float* partial, float* loss, cudaStream_t stream) {
  switch (C) {
    case 32: return fwd<T, 32>(q, k, a, b, N, S, inv_t, lse, partial, loss, stream);
    case 64: return fwd<T, 64>(q, k, a, b, N, S, inv_t, lse, partial, loss, stream);
    case 128: return fwd<T, 128>(q, k, a, b, N, S, inv_t, lse, partial, loss, stream);
    case 256: return fwd<T, 256>(q, k, a, b, N, S, inv_t, lse, partial, loss, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t bwd_dispatch(int C, const void* q, const void* k, const float* a,
                         const float* b, const float* lse, const float* g, int N,
                         int S, float inv_t, float* dq, float* dk,
                         cudaStream_t stream) {
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
// {32, 64, 128, 256}; a, b: (N, S) float32.  Writes lse (N, S),
// partial (N, ceil(S / 64)) and the scalar loss.
int cp2_dense_loss_fwd(const void* q, const void* k, const void* a, const void* b,
                       int N, int S, int C, int bf16, float inv_t, void* lse,
                       void* partial, void* loss, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  float* lf = static_cast<float*>(lse);
  float* pf = static_cast<float*>(partial);
  float* out = static_cast<float*>(loss);
  return bf16 ? fwd_dispatch<__nv_bfloat16>(C, q, k, af, bf, N, S, inv_t, lf, pf, out, s)
              : fwd_dispatch<float>(C, q, k, af, bf, N, S, inv_t, lf, pf, out, s);
}

// g: the upstream gradient (one float32 on the device).  dq, dk: (N, S, C)
// float32 outputs; either may be null to skip it.
int cp2_dense_loss_bwd(const void* q, const void* k, const void* a, const void* b,
                       const void* lse, const void* g, int N, int S, int C,
                       int bf16, float inv_t, void* dq, void* dk, void* stream) {
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
