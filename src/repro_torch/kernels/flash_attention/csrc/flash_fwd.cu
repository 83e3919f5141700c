// flash_fwd for Hopper (sm_90a): one (q-chunk, kv-chunk) pair of FPDT's
// online-softmax attention, continuing a carry (acc, m, l).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py::flash_fwd (_fwd_kernel).
// It computes what that kernel computes, not a block-by-block copy:
//   * one thread block per (q-tile, q-head, batch row); the Pallas grid's
//     sequential fourth axis (k blocks) is the loop inside the block;
//   * the carry is read once at the start and (acc, m, l) written once at
//     the end, all fp32, unnormalized;
//   * q_offset / k_offset are plain runtime arguments (the FPDT loop moves
//     them on every call), causal + sliding-window masks act on global
//     positions, and the window applies only under causal (as the plain
//     version, ref.py, does);
//   * tiles are fixed at 64 x 64 and ragged tails are masked here, where
//     Pallas shrinks its tiles to a divisor (_fit_block): the result is the
//     same function;
//   * a tile that no (q, k) pair of it can see is skipped (kernel.py:93-96);
//   * a masked logit gets p = 0 explicitly, never by exp underflow, and
//     NEG_INF is the finite -1e30, so alpha = exp(m_prev - m_new) stays
//     finite for a row that has seen no live key yet.
//
// What bounds it on this card: at the serve shapes (d = 64, bf16 in, fp32
// state) a pair does 4*d multiply-adds per live (q, k) pair against 2*d
// input bytes per key row, so at large chunks the operations bound it (the
// tensor cores' 989 TFLOP/s) and at the 64-token serve prompt the bytes and
// the launch do.  This first version runs the products as fp32 FMAs on the
// CUDA cores out of shared-memory tiles (each thread a 4 x 4 micro-tile of
// S and a 4 x d/16 micro-tile of acc), which keeps it exact against the
// fp32 plain version for both input types; tensor cores (mma/wgmma) and
// TMA pipelining are later work.  At d = 256 (recurrentgemma's heads)
// a block takes 214,016 of the 232,448 bytes of shared memory a block may
// have, so one block runs per SM, and each thread a 4 x 16 acc micro-tile.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;   // q rows per block
constexpr int BK = 64;   // keys per inner tile
constexpr int NT = 256;  // threads: 16 x 16 for the products, 4 per row for the softmax

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <int D>
constexpr size_t smem_bytes() {
  // sQ [BQ][D+1], sK [BK][D+1], sV [BK][D], sS [BQ][BK+1], sAlpha [BQ]
  return sizeof(float) * (size_t(BQ) * (D + 1) + size_t(BK) * (D + 1) + size_t(BK) * D +
                          size_t(BQ) * (BK + 1) + BQ);
}

template <int D, typename T>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ acc_in, const float* __restrict__ m_in,
                 const float* __restrict__ l_in, float* __restrict__ acc_out,
                 float* __restrict__ m_out, float* __restrict__ l_out, int hq, int hkv, int sq,
                 int sk, int causal, int window, int q_offset, int k_offset, float scale) {
  constexpr int DP = D + 1;   // padded stride: column walks hit distinct banks
  constexpr int SP = BK + 1;
  constexpr int DC = D / 16;  // acc columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * DP;
  float* sV = sK + BK * DP;
  float* sS = sV + BK * D;
  float* sAlpha = sS + BQ * SP;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;   // product mapping
  const int srow = tid / 4, sl = tid % 4;   // softmax mapping: 4 lanes per row
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int hk = h / (hq / hkv);            // GQA: kv head = q head // group
  const int nq = min(BQ, sq - q0);          // live rows of this tile

  const size_t row0 = ((size_t)blockIdx.z * hq + h) * sq + q0;  // first (b, h, q) row
  const T* qp = q + row0 * D;
  const size_t kv0 = ((size_t)blockIdx.z * hkv + hk) * sk;
  const T* kp = k + kv0 * D;
  const T* vp = v + kv0 * D;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D;
    sQ[r * DP + c] = r < nq ? to_f32(qp[(size_t)r * D + c]) : 0.f;
  }

  // carry-in (identity when absent): m/l per softmax row, acc per micro-tile
  const bool srow_live = srow < nq;
  float m_run = (m_in != nullptr && srow_live) ? m_in[row0 + srow] : NEG_INF;
  float l_run = (l_in != nullptr && srow_live) ? l_in[row0 + srow] : 0.f;
  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < DC; ++j)
      acc[i][j] = (acc_in != nullptr && r < nq) ? acc_in[(row0 + r) * D + tx + 16 * j] : 0.f;
  }

  const int q_first = q_offset + q0;
  const int q_last = q_first + nq - 1;
  const int n_tiles = (sk + BK - 1) / BK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    const int nk = min(BK, sk - k0);
    const int k_first = k_offset + k0;
    const int k_last = k_first + nk - 1;
    // dead tile: wholly above the diagonal or wholly left of the window band
    // (block-uniform, so every thread skips the barriers below together)
    if (causal && (q_last < k_first || (window > 0 && k_last < q_first - window + 1)))
      continue;

    __syncthreads();  // the previous tile's readers are done with sK/sV/sS
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, c = i % D;
      const bool ok = r < nk;
      const size_t gi = (size_t)(k0 + r) * D + c;
      sK[r * DP + c] = ok ? to_f32(kp[gi]) : 0.f;
      sV[r * D + c] = ok ? to_f32(vp[gi]) : 0.f;
    }
    __syncthreads();

    // S = (Q K^T) * scale, masked on global positions and the ragged tail
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sQ[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sK[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        bool live = c < nk;
        if (causal) {
          const int qpos = q_first + r, kpos = k_first + c;
          live = live && qpos >= kpos && (window <= 0 || qpos - kpos < window);
        }
        sS[r * SP + c] = live ? s[i][j] * scale : NEG_INF;
      }
    }
    __syncthreads();

    // online softmax, one row per 4 lanes: P overwrites S in place
    {
      float* row = sS + srow * SP;
      float mx = NEG_INF;
      for (int c = sl; c < BK; c += 4) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run, mx);
      float sum = 0.f;
      for (int c = sl; c < BK; c += 4) {
        const float x = row[c];
        const float p = x <= 0.5f * NEG_INF ? 0.f : expf(x - m_new);
        row[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float alpha = expf(m_run - m_new);
      l_run = l_run * alpha + sum;
      m_run = m_new;
      if (sl == 0) sAlpha[srow] = alpha;
    }
    __syncthreads();

    // acc = acc * alpha + P V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float al = sAlpha[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= al;
    }
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sS[(ty + 16 * i) * SP + c];
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        const float vv = sV[c * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r < nq) {
#pragma unroll
      for (int j = 0; j < DC; ++j) acc_out[(row0 + r) * D + tx + 16 * j] = acc[i][j];
    }
  }
  if (sl == 0 && srow_live) {
    m_out[row0 + srow] = m_run;
    l_out[row0 + srow] = l_run;
  }
}

template <int D, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const float* acc_in,
                   const float* m_in, const float* l_in, float* acc_out, float* m_out,
                   float* l_out, int b, int hq, int hkv, int sq, int sk, int causal, int window,
                   int q_offset, int k_offset, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kern = flash_fwd_kernel<D, T>;
  // the shared-memory opt-in is set once per instantiation and device, not
  // per launch (a repeat from a racing thread is harmless)
  constexpr int kMaxDevices = 64;
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || !configured[dev]) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) configured[dev] = true;
  }
  const dim3 grid((sq + BQ - 1) / BQ, hq, b);
  kern<<<grid, NT, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                   static_cast<const T*>(v), acc_in, m_in, l_in, acc_out, m_out,
                                   l_out, hq, hkv, sq, sk, causal, window, q_offset, k_offset,
                                   scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int d, const void* q, const void* k, const void* v, const float* acc_in,
                       const float* m_in, const float* l_in, float* acc_out, float* m_out,
                       float* l_out, int b, int hq, int hkv, int sq, int sk, int causal,
                       int window, int q_offset, int k_offset, float scale,
                       cudaStream_t stream) {
#define FLASH_FWD_CASE(DIM)                                                                  \
  case DIM:                                                                                  \
    return launch<DIM, T>(q, k, v, acc_in, m_in, l_in, acc_out, m_out, l_out, b, hq, hkv, sq, \
                          sk, causal, window, q_offset, k_offset, scale, stream);
  switch (d) {
    FLASH_FWD_CASE(16)
    FLASH_FWD_CASE(32)
    FLASH_FWD_CASE(64)
    FLASH_FWD_CASE(128)
    FLASH_FWD_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef FLASH_FWD_CASE
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  acc_in/m_in/l_in may all be null (no
// carry).  Returns the launch's cudaError_t (0 = launched).
extern "C" int flash_fwd_launch(int dtype, int d, const void* q, const void* k, const void* v,
                                const float* acc_in, const float* m_in, const float* l_in,
                                float* acc_out, float* m_out, float* l_out, int b, int hq,
                                int hkv, int sq, int sk, int causal, int window, int q_offset,
                                int k_offset, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(d, q, k, v, acc_in, m_in, l_in, acc_out, m_out, l_out, b, hq, hkv,
                             sq, sk, causal, window, q_offset, k_offset, scale, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(d, q, k, v, acc_in, m_in, l_in, acc_out, m_out, l_out, b,
                                     hq, hkv, sq, sk, causal, window, q_offset, k_offset, scale,
                                     st);
  return cudaErrorInvalidValue;
}

extern "C" const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
