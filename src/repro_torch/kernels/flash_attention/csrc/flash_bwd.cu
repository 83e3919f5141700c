// flash_bwd_dq and flash_bwd_dkv for Hopper (sm_90a): the two halves of the
// backward of one (q-chunk, kv-chunk) pair of FPDT's attention, given the
// final row log-sum-exp L and delta = sum(do * o) of every query row.
//
// Replace the Pallas TPU kernels
//   src/repro/kernels/flash_attention/kernel.py::flash_bwd_dq  (_dq_kernel)
//   src/repro/kernels/flash_attention/kernel.py::flash_bwd_dkv (_dkv_kernel)
// computing what they compute, not a block-by-block copy:
//   p  = exp(s * scale - L), with p = 0 set explicitly where the mask cuts
//   ds = p * (do . v - delta) * scale
//   dq = sum_k ds * k                       (flash_bwd_dq)
//   dv = sum_q p * do, dk = sum_q ds * q    (flash_bwd_dkv, summed over the
//                                            g q-heads of each kv group)
// Design (the rules of flash_fwd.cu):
//   * flash_bwd_dq: one block per (q-tile, q-head, batch row); q, do, L and
//     delta of the tile are loaded once, the loop runs over 64-key tiles,
//     and dq stays in registers and is written once.
//   * flash_bwd_dkv: one block per (k-tile, kv-head, batch row), mirroring
//     the Pallas grid (b, hkv, nk, g * nq): k and v are loaded once and the
//     loop runs over the group's g q-heads times the q tiles (q-head
//     hk * g + t / nq).  dk and dv accumulate inside the block with no
//     atomics and are written once, so the GQA sum is exact in the sense of
//     being deterministic: the same order on every run.
//   * tiles are 64 x 64 with ragged tails masked, except at head_dim 256,
//     where flash_bwd_dq takes 32-row q tiles and flash_bwd_dkv 32-row key
//     tiles (tile_rows below) so that the fp32 tiles fit the 227 KB of
//     shared memory a block may have (205,952 and 214,528 bytes) and the
//     per-thread accumulators stay at 32 (dq) and 64 (dk + dv) floats;
//     the d <= 128 instantiations are the 64 x 64 ones, unchanged; q_offset
//     and k_offset are runtime arguments; a tile wholly above the diagonal or
//     left of the window band is skipped (kernel.py:240-242, :331-333);
//     the window applies only under causal, as in ref.py.
//   * a masked (q, k) pair gets p = 0 without any exp, so a row that saw no
//     key (its L is the forward's NEG_INF, -1e30) contributes nothing.
//   * all products are fp32 FMAs out of shared memory (bf16 inputs are
//     widened on load), so the kernels match the fp32 plain versions
//     (ref.chunk_bwd_dq / chunk_bwd_dkv) for both input types.
//
// What bounds them on this card: per live (q, k) pair dq does 6 * d and dkv
// 8 * d flops against O(d) bytes per row, so at FPDT's chunk sizes the
// operations bound both (989 TFLOP/s on the tensor cores).  This first
// version runs on the CUDA cores in fp32 (each thread a (rows / 16) x 4
// micro-tile of s and a (rows / 16) x d/16 micro-tile of its accumulators),
// so it is far from that bound; mma/wgmma tensor-core products and TMA
// pipelining are later work.  Under MQA (one kv head) flash_bwd_dkv has only
// sk / 32 blocks at d = 256 (64 for a 2048-key chunk, on 132 SMs), each
// looping over every q head: right, and slow.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;   // q rows per tile (flash_bwd_dq: TQ, below)
constexpr int BK = 64;   // keys per tile (flash_bwd_dkv: TK, below)
constexpr int NT = 256;  // threads: 16 x 16, each a (rows / 16) x 4 micro-tile

// rows of the tile a block keeps for its whole life (dq: q rows; dkv: key
// rows): 64, or 32 at head_dim 256 so the fp32 tiles fit shared memory
template <int D>
__host__ __device__ constexpr int tile_rows() { return D > 128 ? 32 : 64; }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// a tile that no (q, k) pair of it can see (block-uniform)
__device__ __forceinline__ bool dead_tile(int causal, int window, int q_first, int q_last,
                                          int k_first, int k_last) {
  return causal && (q_last < k_first || (window > 0 && k_last < q_first - window + 1));
}

__device__ __forceinline__ bool live_pair(int causal, int window, int qpos, int kpos) {
  return !causal || (qpos >= kpos && (window <= 0 || qpos - kpos < window));
}

// rows [0, n) of a [ROWS, D] tile from global memory into a padded shared tile
template <int D, int ROWS, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int n, int tid) {
  constexpr int DP = D + 1;
  for (int i = tid; i < ROWS * D; i += NT) {
    const int r = i / D, c = i % D;
    dst[r * DP + c] = r < n ? to_f32(src[(size_t)r * D + c]) : 0.f;
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  // sQ, sDO [TQ][D+1]; sK, sV [BK][D+1]; sDS [TQ][BK+1]; sL, sDelta [TQ]
  constexpr size_t TQ = tile_rows<D>();
  return sizeof(float) * (2 * TQ * (D + 1) + 2 * size_t(BK) * (D + 1) + TQ * (BK + 1) + 2 * TQ);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  // sK, sV [TK][D+1]; sQ, sDO [BQ][D+1]; sP, sDS [TK][BQ+1]; sL, sDelta [BQ]
  constexpr size_t TK = tile_rows<D>();
  return sizeof(float) * (2 * TK * (D + 1) + 2 * size_t(BQ) * (D + 1) + 2 * TK * (BQ + 1) +
                          2 * BQ);
}

template <int D, typename T>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const float* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq, int hq, int hkv,
                    int sq, int sk, int causal, int window, int q_offset, int k_offset,
                    float scale) {
  constexpr int TQ = tile_rows<D>();
  constexpr int MI = TQ / 16;  // q rows per thread
  constexpr int DP = D + 1;
  constexpr int SP = BK + 1;
  constexpr int DC = D / 16;  // dq columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sDO = sQ + TQ * DP;
  float* sK = sDO + TQ * DP;
  float* sV = sK + BK * DP;
  float* sDS = sV + BK * DP;
  float* sL = sDS + TQ * SP;
  float* sDelta = sL + TQ;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * TQ;
  const int h = blockIdx.y;
  const int hk = h / (hq / hkv);
  const int nq = min(TQ, sq - q0);

  const size_t row0 = ((size_t)blockIdx.z * hq + h) * sq + q0;
  const size_t kv0 = ((size_t)blockIdx.z * hkv + hk) * sk;
  load_tile<D, TQ>(sQ, q + row0 * D, nq, tid);
  load_tile<D, TQ>(sDO, dout + row0 * D, nq, tid);
  for (int i = tid; i < TQ; i += NT) {
    sL[i] = i < nq ? lse[row0 + i] : 0.f;
    sDelta[i] = i < nq ? delta[row0 + i] : 0.f;
  }

  float acc[MI][DC];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;

  const int q_first = q_offset + q0;
  const int q_last = q_first + nq - 1;
  const int n_tiles = (sk + BK - 1) / BK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    const int nk = min(BK, sk - k0);
    const int k_first = k_offset + k0;
    if (dead_tile(causal, window, q_first, q_last, k_first, k_first + nk - 1)) continue;

    __syncthreads();  // the previous tile's readers are done with sK/sV/sDS
    load_tile<D, BK>(sK, k + (kv0 + k0) * D, nk, tid);
    load_tile<D, BK>(sV, v + (kv0 + k0) * D, nk, tid);
    __syncthreads();

    // s = q k^T and dp = do v^T on the same micro-tile
    float s[MI][4], dp[MI][4];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[MI], o[MI], b[4], w[4];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        a[i] = sQ[(ty + 16 * i) * DP + d];
        o[i] = sDO[(ty + 16 * i) * DP + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j] = sK[(tx + 16 * j) * DP + d];
        w[j] = sV[(tx + 16 * j) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], b[j], s[i][j]);
          dp[i][j] = fmaf(o[i], w[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        float ds = 0.f;
        if (r < nq && c < nk && live_pair(causal, window, q_first + r, k_first + c)) {
          const float p = expf(s[i][j] * scale - sL[r]);
          ds = p * (dp[i][j] - sDelta[r]) * scale;
        }
        sDS[r * SP + c] = ds;
      }
    }
    __syncthreads();

    // dq += ds k
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float g[MI];
#pragma unroll
      for (int i = 0; i < MI; ++i) g[i] = sDS[(ty + 16 * i) * SP + c];
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        const float kk = sK[c * DP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < MI; ++i) acc[i][j] = fmaf(g[i], kk, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int r = ty + 16 * i;
    if (r < nq) {
#pragma unroll
      for (int j = 0; j < DC; ++j) dq[(row0 + r) * D + tx + 16 * j] = acc[i][j];
    }
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const float* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int hq, int hkv, int sq, int sk, int causal,
                     int window, int q_offset, int k_offset, float scale) {
  constexpr int TK = tile_rows<D>();
  constexpr int MI = TK / 16;  // key rows per thread
  constexpr int DP = D + 1;
  constexpr int PP = BQ + 1;
  constexpr int DC = D / 16;  // dk / dv columns per thread
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + TK * DP;
  float* sQ = sV + TK * DP;
  float* sDO = sQ + BQ * DP;
  float* sP = sDO + BQ * DP;   // [key][query]
  float* sDS = sP + TK * PP;   // [key][query]
  float* sL = sDS + TK * PP;
  float* sDelta = sL + BQ;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;  // rows: keys ty + 16 i; columns: queries tx + 16 j
  const int k0 = blockIdx.x * TK;
  const int hk = blockIdx.y;
  const int g = hq / hkv;
  const int nk = min(TK, sk - k0);
  const int nqt = (sq + BQ - 1) / BQ;

  const size_t kv0 = ((size_t)blockIdx.z * hkv + hk) * sk + k0;
  load_tile<D, TK>(sK, k + kv0 * D, nk, tid);
  load_tile<D, TK>(sV, v + kv0 * D, nk, tid);

  float dk_acc[MI][DC], dv_acc[MI][DC];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  const int k_first = k_offset + k0;
  const int k_last = k_first + nk - 1;
  for (int t = 0; t < g * nqt; ++t) {
    const int h = hk * g + t / nqt;
    const int q0 = (t % nqt) * BQ;
    const int nq = min(BQ, sq - q0);
    const int q_first = q_offset + q0;
    if (dead_tile(causal, window, q_first, q_first + nq - 1, k_first, k_last)) continue;

    __syncthreads();  // the previous tile's readers are done with sQ/sDO/sP/sDS
    const size_t row0 = ((size_t)blockIdx.z * hq + h) * sq + q0;
    load_tile<D, BQ>(sQ, q + row0 * D, nq, tid);
    load_tile<D, BQ>(sDO, dout + row0 * D, nq, tid);
    for (int i = tid; i < BQ; i += NT) {
      sL[i] = i < nq ? lse[row0 + i] : 0.f;
      sDelta[i] = i < nq ? delta[row0 + i] : 0.f;
    }
    __syncthreads();

    // s^T = k q^T and dp^T = v do^T on the same micro-tile
    float s[MI][4], dp[MI][4];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[MI], w[MI], b[4], o[4];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        a[i] = sK[(ty + 16 * i) * DP + d];
        w[i] = sV[(ty + 16 * i) * DP + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j] = sQ[(tx + 16 * j) * DP + d];
        o[j] = sDO[(tx + 16 * j) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(b[j], a[i], s[i][j]);
          dp[i][j] = fmaf(o[j], w[i], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int r = ty + 16 * i;  // key
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;  // query
        float p = 0.f, ds = 0.f;
        if (r < nk && c < nq && live_pair(causal, window, q_first + c, k_first + r)) {
          p = expf(s[i][j] * scale - sL[c]);
          ds = p * (dp[i][j] - sDelta[c]) * scale;
        }
        sP[r * PP + c] = p;
        sDS[r * PP + c] = ds;
      }
    }
    __syncthreads();

    // dv += p^T do, dk += ds^T q
#pragma unroll 4
    for (int c = 0; c < BQ; ++c) {
      float pp[MI], gg[MI];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        pp[i] = sP[(ty + 16 * i) * PP + c];
        gg[i] = sDS[(ty + 16 * i) * PP + c];
      }
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        const float o = sDO[c * DP + tx + 16 * j];
        const float qq = sQ[c * DP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          dv_acc[i][j] = fmaf(pp[i], o, dv_acc[i][j]);
          dk_acc[i][j] = fmaf(gg[i], qq, dk_acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int r = ty + 16 * i;
    if (r < nk) {
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        dk[(kv0 + r) * D + tx + 16 * j] = dk_acc[i][j];
        dv[(kv0 + r) * D + tx + 16 * j] = dv_acc[i][j];
      }
    }
  }
}

// The shared-memory opt-in is set once per instantiation and device, not per
// launch (a repeat from a racing thread is harmless).
template <typename K>
cudaError_t configure_once(K kern, size_t smem, bool* configured) {
  constexpr int kMaxDevices = 64;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || !configured[dev]) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) configured[dev] = true;
  }
  return cudaSuccess;
}

struct Args {
  const void *q, *k, *v;
  const float *dout, *lse, *delta;
  float *dq, *dk, *dv;
  int b, hq, hkv, sq, sk, causal, window, q_offset, k_offset;
  float scale;
  cudaStream_t stream;
};

template <int D, typename T>
cudaError_t launch_dq(const Args& a) {
  constexpr size_t smem = dq_smem_bytes<D>();
  static bool configured[64] = {};
  auto kern = flash_bwd_dq_kernel<D, T>;
  cudaError_t err = configure_once(kern, smem, configured);
  if (err != cudaSuccess) return err;
  constexpr int TQ = tile_rows<D>();
  const dim3 grid((a.sq + TQ - 1) / TQ, a.hq, a.b);
  kern<<<grid, NT, smem, a.stream>>>(static_cast<const T*>(a.q), static_cast<const T*>(a.k),
                                     static_cast<const T*>(a.v), a.dout, a.lse, a.delta, a.dq,
                                     a.hq, a.hkv, a.sq, a.sk, a.causal, a.window, a.q_offset,
                                     a.k_offset, a.scale);
  return cudaGetLastError();
}

template <int D, typename T>
cudaError_t launch_dkv(const Args& a) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  static bool configured[64] = {};
  auto kern = flash_bwd_dkv_kernel<D, T>;
  cudaError_t err = configure_once(kern, smem, configured);
  if (err != cudaSuccess) return err;
  constexpr int TK = tile_rows<D>();
  const dim3 grid((a.sk + TK - 1) / TK, a.hkv, a.b);
  kern<<<grid, NT, smem, a.stream>>>(static_cast<const T*>(a.q), static_cast<const T*>(a.k),
                                     static_cast<const T*>(a.v), a.dout, a.lse, a.delta, a.dk,
                                     a.dv, a.hq, a.hkv, a.sq, a.sk, a.causal, a.window,
                                     a.q_offset, a.k_offset, a.scale);
  return cudaGetLastError();
}

template <bool DQ, typename T>
cudaError_t dispatch_d(int d, const Args& a) {
  switch (d) {
    case 16: return DQ ? launch_dq<16, T>(a) : launch_dkv<16, T>(a);
    case 32: return DQ ? launch_dq<32, T>(a) : launch_dkv<32, T>(a);
    case 64: return DQ ? launch_dq<64, T>(a) : launch_dkv<64, T>(a);
    case 128: return DQ ? launch_dq<128, T>(a) : launch_dkv<128, T>(a);
    case 256: return DQ ? launch_dq<256, T>(a) : launch_dkv<256, T>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <bool DQ>
int dispatch(int dtype, int d, const Args& a) {
  if (dtype == 0) return dispatch_d<DQ, float>(d, a);
  if (dtype == 1) return dispatch_d<DQ, __nv_bfloat16>(d, a);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v); dout, lse, delta and the
// outputs are float32.  Each returns the launch's cudaError_t (0 = launched).
extern "C" int flash_bwd_dq_launch(int dtype, int d, const void* q, const void* k,
                                   const void* v, const float* dout, const float* lse,
                                   const float* delta, float* dq, int b, int hq, int hkv, int sq,
                                   int sk, int causal, int window, int q_offset, int k_offset,
                                   float scale, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, nullptr, b, hq, hkv, sq, sk,
               causal, window, q_offset, k_offset, scale, static_cast<cudaStream_t>(stream)};
  return dispatch<true>(dtype, d, a);
}

extern "C" int flash_bwd_dkv_launch(int dtype, int d, const void* q, const void* k,
                                    const void* v, const float* dout, const float* lse,
                                    const float* delta, float* dk, float* dv, int b, int hq,
                                    int hkv, int sq, int sk, int causal, int window,
                                    int q_offset, int k_offset, float scale, void* stream) {
  const Args a{q, k, v, dout, lse, delta, nullptr, dk, dv, b, hq, hkv, sq, sk,
               causal, window, q_offset, k_offset, scale, static_cast<cudaStream_t>(stream)};
  return dispatch<false>(dtype, d, a);
}

extern "C" const char* flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
