// flash_fwd for Hopper (sm_90a): one (q-chunk, kv-chunk) pair of FPDT's
// online-softmax attention, continuing a carry (acc, m, l).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py::flash_fwd (_fwd_kernel).
// It computes what that kernel computes, not a block-by-block copy:
//   * one thread block per (q-tile, q-head, batch row); the Pallas grid's
//     sequential fourth axis (k blocks) is the loop inside the block;
//   * the carry is read once at the start and (acc, m, l) written once at
//     the end, all fp32, unnormalized, with m in the natural-log domain of
//     ref.attend_chunk;
//   * q_offset / k_offset are plain runtime arguments (the FPDT loop moves
//     them on every call), causal + sliding-window masks act on global
//     positions, and the window applies only under causal (as the plain
//     version, ref.py, does);
//   * tiles are fixed (64 q rows; 64 keys, 32 at head_dim 256 in bf16) and
//     ragged tails are masked here, where Pallas shrinks its tiles to a
//     divisor (_fit_block): the result is the same function.  Key tiles
//     start at multiples of the tile from the chunk's first key, so at
//     chunk sizes that are multiples of 64 a row meets the same tiles in
//     the same order whether its keys come in one launch or several, and
//     the fp32 carry passes through memory unchanged between launches;
//   * a tile that no (q, k) pair of it can see is skipped (kernel.py:93-96);
//   * a masked logit gets p = 0 explicitly, never by exp underflow, and
//     NEG_INF is the finite -1e30, so alpha = exp(m_prev - m_new) stays
//     finite for a row that has seen no live key yet.
//
// Two kernels, chosen by the input dtype alone (neither is ever the other's
// fallback; a build or launch failure raises in the wrapper):
//   * bf16 (the training and serving path: param_dtype is bfloat16) runs on
//     the tensor cores: mma.sync m16n8k16, bf16 operands, fp32
//     accumulation.  128 threads, 4 warps of 16 q rows.  Q is copied to
//     shared memory once; K and V tiles stream through two cp.async stages,
//     the next tile's copy in flight while this one is computed.  Each warp
//     computes S = Q K^T from ldmatrix fragments into registers, masks it,
//     runs the online softmax in registers (row max and sum over the quad
//     of lanes that share a row, by shuffles), rounds P to bf16 in
//     registers and uses it as the A operand of P V (V read with
//     ldmatrix.trans); acc stays in fp32 registers.  l sums the fp32 p
//     before rounding, so the one rounding beyond fp32 accumulation order
//     is P to bf16 before P V (tests/test_torch_flash_tc_numerics.py
//     emulates it).  exp(x) is taken as 2^(x log2 e), one MUFU.EX2, with m
//     kept in the natural-log domain (the scaling is applied to x - m, never
//     stored).  Head dims 16, 32, 64, 80 (gpt-2.7b), 128 and 256 are
//     instantiated.  At head_dim 256 acc is 128 registers a thread, so Q
//     fragments are re-read from shared memory for every key tile and key
//     tiles are 32 wide (101 KB of shared memory a block).
//   * fp32 runs the first version on the CUDA cores: fp32 FMAs out of
//     shared-memory tiles (each thread a 4 x 4 micro-tile of S and a
//     4 x d/16 micro-tile of acc), exact against the fp32 plain version;
//     chip_smoke.py's fp32 checks (1e-5, u=4 vs u=1 training, decode vs
//     prefill) run it.
//
// What bounds it on this card: a pair does 4*d flops per live (q, k) pair
// against 2*d input bytes per key row, so at FPDT's chunk sizes the
// operations bound it (989 TFLOP/s dense bf16) and at the 64-token serve
// prompt the bytes and the launch do.  The bf16 kernel's products run on
// the tensor cores through mma.sync, which reaches a fraction of that peak;
// wgmma with TMA-fed, warp-specialised pipelines is what remains, and the
// softmax's exp and the fragment loads from shared memory are the next
// limits after the products.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "flash_tc.cuh"

namespace {

using flash::bf16;
using flash::NEG_INF;

// ---------------------------------------------------------------------------
// fp32: CUDA-core FMAs
// ---------------------------------------------------------------------------

constexpr int BQ = 64;   // q rows per block
constexpr int BK = 64;   // keys per inner tile
constexpr int NT = 256;  // threads: 16 x 16 for the products, 4 per row for the softmax

__device__ __forceinline__ float to_f32(float x) { return x; }

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
  static_assert(D % 16 == 0, "16 threads share a row's d columns");
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


// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

template <int D>
struct TcFwd {
  static constexpr int BQ = 64;                 // q rows a block: 16 a warp
  static constexpr int BK = D > 128 ? 32 : 64;  // keys a tile
  static constexpr int NT = 128;                // 4 warps
  static constexpr int P = D + flash::PAD;     // a tile row's pitch
  // sQ [BQ][P]; two stages of sK [BK][P] and of sV [BK][P]; all bf16
  static constexpr size_t smem = sizeof(bf16) * (size_t(BQ) + 4 * size_t(BK)) * P;
  static_assert(D % 16 == 0, "S = Q K^T steps over d 16 at a time, P V covers d in 16s");
};

template <int D>
__global__ void __launch_bounds__(TcFwd<D>::NT, 1)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const float* __restrict__ acc_in,
                    const float* __restrict__ m_in, const float* __restrict__ l_in,
                    float* __restrict__ acc_out, float* __restrict__ m_out,
                    float* __restrict__ l_out, int hq, int hkv, int sq, int sk, int causal,
                    int window, int q_offset, int k_offset, float scale) {
  using namespace flash;
  constexpr int TQ = TcFwd<D>::BQ, TK = TcFwd<D>::BK, NTH = TcFwd<D>::NT, P = TcFwd<D>::P;
  constexpr int NS = TK / 8;  // 8-key column blocks of S a warp holds
  constexpr int NA = D / 8;   // 8-column blocks of acc
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + TQ * P;      // stage s at sK + s * TK * P
  bf16* sV = sK + 2 * TK * P;  // stage s at sV + s * TK * P

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = lane & 3;
  const int q0 = blockIdx.x * TQ;
  const int h = blockIdx.y;
  const int hk = h / (hq / hkv);  // GQA: kv head = q head // group
  const int nq = min(TQ, sq - q0);
  const size_t row0 = ((size_t)blockIdx.z * hq + h) * sq + q0;
  const size_t kv0 = ((size_t)blockIdx.z * hkv + hk) * sk;
  const bf16* kp = k + kv0 * D;
  const bf16* vp = v + kv0 * D;

  // the live key tiles are one contiguous run: dead ones lie above the
  // diagonal (at the end) or left of the window band (at the start)
  const int q_first = q_offset + q0, q_last = q_first + nq - 1;
  const int n_tiles = (sk + TK - 1) / TK;
  int kt_lo = n_tiles, kt_hi = -1;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k_first = k_offset + kt * TK;
    if (!dead_tile(causal, window, q_first, q_last, k_first,
                   k_first + min(TK, sk - kt * TK) - 1)) {
      kt_lo = min(kt_lo, kt);
      kt_hi = kt;
    }
  }

  // Q, then the first live K/V tile: one cp.async group
  load_rows_async<TQ, D, NTH>(sQ, q + row0 * D, nq, tid);
  if (kt_lo <= kt_hi) {
    const int k0 = kt_lo * TK, nk = min(TK, sk - k0);
    load_rows_async<TK, D, NTH>(sK, kp + (size_t)k0 * D, nk, tid);
    load_rows_async<TK, D, NTH>(sV, vp + (size_t)k0 * D, nk, tid);
  }
  cp_async_commit();

  // this lane's two rows of the warp's 16, and the carry-in of both
  int rows[2];
  rows[0] = warp * 16 + (lane >> 2);
  rows[1] = rows[0] + 8;
  float m_run[2], l_run[2];
  float acc[NA][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool live = rows[i] < nq;
    m_run[i] = (m_in != nullptr && live) ? m_in[row0 + rows[i]] : NEG_INF;
    l_run[i] = (l_in != nullptr && live) ? l_in[row0 + rows[i]] : 0.f;
#pragma unroll
    for (int j = 0; j < NA; ++j) {
      float2 a = make_float2(0.f, 0.f);
      if (acc_in != nullptr && live)
        a = *reinterpret_cast<const float2*>(acc_in + (row0 + rows[i]) * D + 8 * j + 2 * t);
      acc[j][2 * i] = a.x;
      acc[j][2 * i + 1] = a.y;
    }
  }

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int st = (kt - kt_lo) & 1;
    if (kt < kt_hi) {  // the next tile's copy flies while this one is computed
      const int k0n = (kt + 1) * TK, nkn = min(TK, sk - k0n);
      load_rows_async<TK, D, NTH>(sK + (st ^ 1) * TK * P, kp + (size_t)k0n * D, nkn, tid);
      load_rows_async<TK, D, NTH>(sV + (st ^ 1) * TK * P, vp + (size_t)k0n * D, nkn, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* tK = sK + st * TK * P;
    const bf16* tV = sV + st * TK * P;

    // S = Q K^T for the warp's 16 rows x TK keys, fp32 in registers
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t a[4];
      ldsm_x4(a, sQ + toff<D>(warp * 16 + a_row(lane), ks * 16 + a_col(lane)));
#pragma unroll
      for (int nb = 0; nb < TK / 16; ++nb) {
        uint32_t b[4];
        ldsm_x4(b, tK + toff<D>(nb * 16 + b_row(lane), ks * 16 + b_col(lane)));
        mma(s[2 * nb], a, b[0], b[1]);
        mma(s[2 * nb + 1], a, b[2], b[3]);
      }
    }

    // scale, and mask on global positions and the ragged tail
    const int k0 = kt * TK, nk = min(TK, sk - k0), k_first = k_offset + k0;
    const bool full = nk == TK && full_tile(causal, window, q_first, q_last, k_first,
                                            k_first + TK - 1);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1);
        const bool live = full || (c < nk && live_pair(causal, window,
                                                       q_first + rows[e >> 1], k_first + c));
        s[j][e] = live ? s[j][e] * scale : NEG_INF;
      }

    // online softmax in registers: the 4 lanes of a quad share a row
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float m_new[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      m_new[i] = fmaxf(m_run[i], mx[i]);
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[j][e];
        const float p = x <= 0.5f * NEG_INF ? 0.f : exp2f((x - m_new[e >> 1]) * LOG2E);
        s[j][e] = p;
        sum[e >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      const float alpha = exp2f((m_run[i] - m_new[i]) * LOG2E);
      l_run[i] = l_run[i] * alpha + sum[i];
      m_run[i] = m_new[i];
#pragma unroll
      for (int j = 0; j < NA; ++j) {
        acc[j][2 * i] *= alpha;
        acc[j][2 * i + 1] *= alpha;
      }
    }

    // acc += P V: P rounded to bf16 in registers is the A operand
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int db = 0; db < D / 16; ++db) {
        uint32_t b[4];
        ldsm_x4_t(b, tV + toff<D>(kk * 16 + a_row(lane), db * 16 + a_col(lane)));
        mma(acc[2 * db], a, b[0], b[1]);
        mma(acc[2 * db + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  cp_async_wait<0>();  // no copy outlives the block (no live tile: Q's group)

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= nq) continue;
#pragma unroll
    for (int j = 0; j < NA; ++j)
      *reinterpret_cast<float2*>(acc_out + (row0 + rows[i]) * D + 8 * j + 2 * t) =
          make_float2(acc[j][2 * i], acc[j][2 * i + 1]);
    if (t == 0) {
      m_out[row0 + rows[i]] = m_run[i];
      l_out[row0 + rows[i]] = l_run[i];
    }
  }
}

struct Args {
  const void *q, *k, *v;
  const float *acc_in, *m_in, *l_in;
  float *acc_out, *m_out, *l_out;
  int b, hq, hkv, sq, sk, causal, window, q_offset, k_offset;
  float scale;
  cudaStream_t stream;
};

template <int D>
cudaError_t launch_simt(const Args& a) {
  constexpr size_t smem = smem_bytes<D>();
  static bool configured[64] = {};
  auto kern = flash_fwd_kernel<D, float>;
  cudaError_t err = flash::configure_once(kern, smem, configured);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.sq + BQ - 1) / BQ, a.hq, a.b);
  kern<<<grid, NT, smem, a.stream>>>(static_cast<const float*>(a.q),
                                     static_cast<const float*>(a.k),
                                     static_cast<const float*>(a.v), a.acc_in, a.m_in, a.l_in,
                                     a.acc_out, a.m_out, a.l_out, a.hq, a.hkv, a.sq, a.sk,
                                     a.causal, a.window, a.q_offset, a.k_offset, a.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_tc(const Args& a) {
  using C = TcFwd<D>;
  static bool configured[64] = {};
  auto kern = flash_fwd_tc_kernel<D>;
  cudaError_t err = flash::configure_once(kern, C::smem, configured);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.sq + C::BQ - 1) / C::BQ, a.hq, a.b);
  kern<<<grid, C::NT, C::smem, a.stream>>>(static_cast<const bf16*>(a.q),
                                           static_cast<const bf16*>(a.k),
                                           static_cast<const bf16*>(a.v), a.acc_in, a.m_in,
                                           a.l_in, a.acc_out, a.m_out, a.l_out, a.hq, a.hkv,
                                           a.sq, a.sk, a.causal, a.window, a.q_offset,
                                           a.k_offset, a.scale);
  return cudaGetLastError();
}

template <bool TC>
cudaError_t dispatch_d(int d, const Args& a) {
  switch (d) {
    case 16: return TC ? launch_tc<16>(a) : launch_simt<16>(a);
    case 32: return TC ? launch_tc<32>(a) : launch_simt<32>(a);
    case 64: return TC ? launch_tc<64>(a) : launch_simt<64>(a);
    case 80: return TC ? launch_tc<80>(a) : launch_simt<80>(a);
    case 128: return TC ? launch_tc<128>(a) : launch_simt<128>(a);
    case 256: return TC ? launch_tc<256>(a) : launch_simt<256>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32 (CUDA-core kernel), 1 = bfloat16 (tensor-core kernel).
// acc_in/m_in/l_in may all be null (no carry).  Returns the launch's
// cudaError_t (0 = launched).
extern "C" int flash_fwd_launch(int dtype, int d, const void* q, const void* k, const void* v,
                                const float* acc_in, const float* m_in, const float* l_in,
                                float* acc_out, float* m_out, float* l_out, int b, int hq,
                                int hkv, int sq, int sk, int causal, int window, int q_offset,
                                int k_offset, float scale, void* stream) {
  const Args a{q, k, v, acc_in, m_in, l_in, acc_out, m_out, l_out, b, hq, hkv, sq, sk,
               causal, window, q_offset, k_offset, scale, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch_d<false>(d, a);
  if (dtype == 1) return dispatch_d<true>(d, a);
  return cudaErrorInvalidValue;
}

extern "C" const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
