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
// Shared rules (those of flash_fwd.cu): q_offset and k_offset are runtime
// arguments; ragged tails are masked; a tile wholly above the diagonal or
// left of the window band is skipped (kernel.py:240-242, :331-333); the
// window applies only under causal, as in ref.py; a masked (q, k) pair gets
// p = 0 without any exp, so a row that saw no key (its L is the forward's
// NEG_INF, -1e30) contributes nothing; no atomics anywhere, so every result
// is the same bits on every run and every card (training's offload on ==
// off check relies on it).
//
// The input dtype alone picks the kernel, never as a fallback: fp32 runs
// the CUDA-core kernels, bf16 (the training path's dtype) the tensor-core
// kernels.
//
// fp32 (CUDA cores): fp32 FMAs out of shared memory, so they match the fp32
// plain versions (ref.chunk_bwd_dq / chunk_bwd_dkv).
//   * flash_bwd_dq_kernel: one block per (q-tile, q-head, batch row); q,
//     do, L and delta of the tile are loaded once, the loop runs over
//     64-key tiles, and dq stays in registers and is written once.
//   * flash_bwd_dkv_kernel: one block per (k-tile, kv-head, batch row),
//     mirroring the Pallas grid (b, hkv, nk, g * nq): k and v are loaded
//     once and the loop runs over the group's g q-heads times the q tiles.
//   * tiles are 64 x 64, except at head_dim 256, where dq takes 32-row q
//     tiles and dkv 32-row key tiles (tile_rows below) so that the fp32
//     tiles fit the 227 KB of shared memory a block may have.
//
// bf16 (tensor cores): mma.sync m16n8k16, bf16 operands, fp32 accumulation.
//   * flash_bwd_dq_tc_kernel: one block per (64-row q tile, q head, batch
//     row), 256 threads, 8 warps of 16 q rows x half the columns (at head_dim
//     80 and 16: 128 threads, 4 warps of all the columns, warp_cols); the grid
//     fills the card unsplit (1024 blocks at llama3.2-1b's pair, 512 at
//     recurrentgemma-9b's), so dq needs no cross-block sum.  Q (bf16) and
//     dO (fp32, rounded to bf16 on load, nearest even, as
//     flash_bwd_round_do_kernel rounds it for dkv) stay in shared memory for
//     the block's life, L and delta of a lane's two rows in registers, dQ
//     in fp32 registers, written once.  The block walks the run of key
//     tiles live for its rows; each 64-key tile's K and V come by cp.async
//     into one of two buffers while the previous tile is computed, then
//       1. S = Q K^T and dP = dO V^T, each warp 16 q rows x 32 keys;
//          P = exp(S scale - L) (as 2^(S scale log2 e - L log2 e), one
//          MUFU.EX2) and dS = P (dP - delta) scale in fp32, masked, dS
//          rounded to bf16 into shared memory;
//       2. dQ += dS K, each warp 16 q rows x d/2 columns, K read with
//          ldmatrix.trans (64 accumulator floats a thread at head_dim 256).
//     Two barriers a key tile: the next tile's copy is issued after the
//     first, when every warp is done with the buffer it overwrites.  The
//     rounding points beyond fp32 accumulation order are dO and dS to bf16
//     (ref.chunk_bwd_dq_tc emulates them).  The q tiles run heaviest first:
//     on a causal diagonal pair the last q tiles see the most keys, so the
//     block order is reversed there, and kept where the first q tile sees
//     more (a window's off-diagonal pair).  212 KB of shared memory a block
//     at head_dim 256; 65 KB at 64, where two blocks share an SM (128
//     registers a thread).
//   * flash_bwd_dkv_tc_kernel: a first small kernel rounds dO (fp32, the
//     op's input) to bf16 once, so that the blocks that all read it copy
//     half the bytes and convert nothing (flash_bwd_round_do_kernel; the
//     wrapper allocates the bf16 copy).  One block per (64-key tile, kv
//     head x q-head split, batch row), 256 threads, 8 warps of 16 keys x
//     half the columns (4 warps of all of them at head_dim 80 and 16).  K
//     and V of the tile stay in shared memory for the
//     block's life; dK and dV accumulate in fp32 registers.  The block walks
//     (its q heads) x (the q tiles live for its keys); each 64-row q tile's
//     Q, dO, L and delta come by cp.async into one of two buffers while the
//     previous tile is computed, then
//       1. S^T = K Q^T and dP^T = V dO^T on the tensor cores, each warp 16
//          keys x 32 queries (16 at a time up to head_dim 64, which keeps a
//          thread within 128 registers so that two blocks share an SM);
//          P^T = exp(S^T scale - L) and dS^T = P^T (dP^T - delta) scale,
//          masked, both rounded to bf16 into shared memory;
//       2. dV += P^T dO and dK += dS^T Q, each warp 16 keys x d/2 columns,
//          so that at head_dim 256 a thread holds 128 accumulator floats.
//     The rounding points beyond fp32 accumulation order are dO, P^T and
//     dS^T to bf16 (ref.chunk_bwd_dkv_tc emulates them).  214 KB of shared
//     memory a block at head_dim 256, 66 KB at 64.
//   * The g q-heads of a group are split across n_split blocks (the grid's
//     y axis is hkv * n_split): under a window every head sees the same
//     band of live q tiles, so head splits carry equal work where q-tile
//     splits would give some blocks only dead tiles.  n_split is a function
//     of the shapes alone (kernel.py dkv_splits, reckoned against a fixed
//     132 SMs, never the card's count), so the bits are the same on every
//     card: 1 where the unsplit grid already fills an H100 (llama3.2-1b's
//     pairs, 256 blocks), 8 for recurrentgemma-9b's single kv head (32
//     blocks -> 256).  With n_split > 1 each split writes its partial dK and
//     dV into a workspace [n_split, b, hkv, sk, d] and
//     flash_bwd_dkv_split_sum_kernel adds the splits in index order.
//
// What bounds them on this card: per live (q, k) pair dq does 6 * d and dkv
// 8 * d flops against O(d) bytes per row, so at FPDT's chunk sizes the
// operations bound both (989 TFLOP/s dense bf16 on the tensor cores).  The
// CUDA-core kernels sit far above that bound.  The tensor-core kernels are
// set by latency more than by their products: each tile's exp, copies and
// two phases of products run between barriers, so at head_dim 64 a thread
// is held to 128 registers and two blocks share an SM, one computing while
// the other waits.  wgmma with warp-specialised TMA loads, and a fused
// dq + dkv pass, are what remains.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "flash_tc.cuh"

namespace {

using flash::bf16;
using flash::dead_tile;
using flash::live_pair;

// ---------------------------------------------------------------------------
// fp32: CUDA-core FMAs
// ---------------------------------------------------------------------------

constexpr int BQ = 64;   // q rows per tile (flash_bwd_dq: TQ, below)
constexpr int BK = 64;   // keys per tile (flash_bwd_dkv: TK, below)
constexpr int NT = 256;  // threads: 16 x 16, each a (rows / 16) x 4 micro-tile

// rows of the tile a block keeps for its whole life (dq: q rows; dkv: key
// rows): 64, or 32 at head_dim 256 so the fp32 tiles fit shared memory
template <int D>
__host__ __device__ constexpr int tile_rows() { return D > 128 ? 32 : 64; }

// rows [0, n) of a [ROWS, D] tile from global memory into a padded shared tile
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int n, int tid) {
  constexpr int DP = D + 1;
  for (int i = tid; i < ROWS * D; i += NT) {
    const int r = i / D, c = i % D;
    dst[r * DP + c] = r < n ? src[(size_t)r * D + c] : 0.f;
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

template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, int hq, int hkv,
                    int sq, int sk, int causal, int window, int q_offset, int k_offset,
                    float scale) {
  constexpr int TQ = tile_rows<D>();
  constexpr int MI = TQ / 16;  // q rows per thread
  constexpr int DP = D + 1;
  constexpr int SP = BK + 1;
  constexpr int DC = D / 16;  // dq columns per thread
  static_assert(D % 16 == 0, "16 threads share a row's d columns");
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

template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dk,
                     float* __restrict__ dv, int hq, int hkv, int sq, int sk, int causal,
                     int window, int q_offset, int k_offset, float scale) {
  constexpr int TK = tile_rows<D>();
  constexpr int MI = TK / 16;  // key rows per thread
  constexpr int DP = D + 1;
  constexpr int PP = BQ + 1;
  constexpr int DC = D / 16;  // dk / dv columns per thread
  static_assert(D % 16 == 0, "16 threads share a row's d columns");
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

// ---------------------------------------------------------------------------
// flash_bwd_dq in bf16: tensor cores
// ---------------------------------------------------------------------------

// Warp columns of the bf16 backward kernels: two where each half of d is
// whole 16-column blocks (d 32, 64, 128, 256), else one (d 16, and d 80,
// whose halves of 40 would leave 8 columns a warp outside its dn loop)
template <int D>
constexpr int warp_cols() { return D >= 32 && (D / 2) % 16 == 0 ? 2 : 1; }

template <int D>
struct TcDq {
  static constexpr int TQ = 64;               // q rows a block keeps for its life
  static constexpr int TK = 64;               // keys a tile
  static constexpr int WR = TQ / 16;          // warp rows: 16 q rows each
  static constexpr int WC = warp_cols<D>();   // warp columns
  static constexpr int NT = 32 * WR * WC;
  static constexpr int KW = TK / WC;          // keys of S, dP a warp computes
  static constexpr int DW = D / WC;           // dQ columns a warp accumulates
  static_assert(D % 16 == 0 && DW % 16 == 0 && KW % 16 == 0,
                "phase 1 steps d by 16; phase 2 covers a warp's DW columns in 16s");
  // up to head_dim 64 two blocks share an SM (128 registers a thread)
  static constexpr int MIN_BLOCKS = D <= 64 ? 2 : 1;
  static constexpr int P = D + flash::PAD;    // pitch of a [.][D] tile row
  static constexpr int PK = TK + flash::PAD;  // pitch of a [.][TK] tile row
  // bf16 sQ, sDO [TQ][P], two buffers of sK, sV [TK][P], sDS [TQ][PK]
  static constexpr size_t smem =
      sizeof(bf16) * ((2 * size_t(TQ) + 4 * size_t(TK)) * P + size_t(TQ) * PK);
};

// The key tiles (of `tk` keys from the chunk's first) that rows at global
// positions [q_first, q_last] see: one contiguous run, x .. y (y < x: none).
__device__ __forceinline__ int2 live_key_tiles(int causal, int window, int q_first, int q_last,
                                               int k_offset, int sk, int tk) {
  int lo = (sk + tk - 1) / tk, hi = -1;
  for (int kt = 0; kt * tk < sk; ++kt) {
    const int k_first = k_offset + kt * tk;
    if (!flash::dead_tile(causal, window, q_first, q_last, k_first,
                          k_first + min(tk, sk - kt * tk) - 1)) {
      lo = min(lo, kt);
      hi = kt;
    }
  }
  return make_int2(lo, hi);
}

template <int D>
__global__ void __launch_bounds__(TcDq<D>::NT, TcDq<D>::MIN_BLOCKS)
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const float* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       float* __restrict__ dq, int hq, int hkv, int sq, int sk, int causal,
                       int window, int q_offset, int k_offset, float scale) {
  using namespace flash;
  using C = TcDq<D>;
  constexpr int TQ = C::TQ, TK = C::TK, NTH = C::NT, KW = C::KW, DW = C::DW, P = C::P;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sDO = sQ + TQ * P;
  bf16* sKb = sDO + TQ * P;      // buffer u at sKb + u * TK * P
  bf16* sVb = sKb + 2 * TK * P;  // buffer u at sVb + u * TK * P
  bf16* sDS = sVb + 2 * TK * P;  // dS [q][key]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = lane & 3;
  const int wr = warp % C::WR, wc = warp / C::WR;

  // heaviest q tiles first: reverse the block order where the last q tile
  // sees more key tiles than the first (a causal diagonal pair)
  const int nqt = gridDim.x;
  const int2 first = live_key_tiles(causal, window, q_offset, q_offset + min(TQ, sq) - 1,
                                    k_offset, sk, TK);
  const int2 last = live_key_tiles(causal, window, q_offset + (nqt - 1) * TQ,
                                   q_offset + sq - 1, k_offset, sk, TK);
  const bool reverse = last.y - last.x > first.y - first.x;
  const int q0 = (reverse ? nqt - 1 - (int)blockIdx.x : (int)blockIdx.x) * TQ;
  const int nq = min(TQ, sq - q0);
  const int h = blockIdx.y, hk = h / (hq / hkv);
  const size_t row0 = ((size_t)blockIdx.z * hq + h) * sq + q0;
  const size_t kv0 = ((size_t)blockIdx.z * hkv + hk) * sk;
  const int q_first = q_offset + q0, q_last = q_first + nq - 1;

  // Q by cp.async (its group completes with the first key tile's); dO fp32
  // rounded to bf16 on the way in, rows past nq zero
  load_rows_async<TQ, D, NTH>(sQ, q + row0 * D, nq, tid);
  cp_async_commit();
  {
    constexpr int V4 = D / 4;  // float4s a row
    const float4* src = reinterpret_cast<const float4*>(dout + row0 * D);
    for (int i = tid; i < TQ * V4; i += NTH) {
      const int r = i / V4, c = (i % V4) * 4;
      const float4 x = r < nq ? src[i] : make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<uint2*>(sDO + toff<D>(r, c)) =
          make_uint2(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w));
    }
  }
  // L log2 e and delta of this lane's two q rows (C fragment rows g, g + 8)
  float l2[2], dl[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = wr * 16 + (lane >> 2) + 8 * hh;
    l2[hh] = r < nq ? lse[row0 + r] * LOG2E : 0.f;
    dl[hh] = r < nq ? delta[row0 + r] : 0.f;
  }

  float acc[DW / 8][4];
#pragma unroll
  for (int j = 0; j < DW / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  const int2 run = live_key_tiles(causal, window, q_first, q_last, k_offset, sk, TK);
  const int n_iter = max(0, run.y - run.x + 1);
  // key tile `it` of the run's K and V into buffer u, as one cp.async group
  auto stage = [&](int it, int u) {
    const int k0 = (run.x + it) * TK;
    const int nk = min(TK, sk - k0);
    load_rows_async<TK, D, NTH>(sKb + u * TK * P, k + (kv0 + k0) * D, nk, tid);
    load_rows_async<TK, D, NTH>(sVb + u * TK * P, v + (kv0 + k0) * D, nk, tid);
    cp_async_commit();
  };
  if (n_iter > 0) stage(0, 0);

  const float scale_log2 = scale * LOG2E;
  for (int it = 0; it < n_iter; ++it) {
    const int u = it & 1;
    const bf16* sK = sKb + u * TK * P;
    const bf16* sV = sVb + u * TK * P;
    cp_async_wait<0>();  // this tile's K and V (the first time, Q too) have landed
    __syncthreads();     // for every thread; and every warp is done with the last tile
    if (it + 1 < n_iter) stage(it + 1, u ^ 1);  // flies while this tile is computed
    const int k0 = (run.x + it) * TK, nk = min(TK, sk - k0);
    const int k_first = k_offset + k0, k_last = k_first + nk - 1;

    // phase 1: S = Q K^T and dP = dO V^T for the warp's 16 q rows and KW
    // keys, then P = exp(S scale - L) (as 2^(S scale log2 e - L log2 e)) and
    // dS = P (dP - delta) scale, masked, rounded to bf16 into shared memory
    float s[KW / 8][4], dp[KW / 8][4];
#pragma unroll
    for (int j = 0; j < KW / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t aq[4], ao[4];
      ldsm_x4(aq, sQ + toff<D>(wr * 16 + a_row(lane), ks * 16 + a_col(lane)));
      ldsm_x4(ao, sDO + toff<D>(wr * 16 + a_row(lane), ks * 16 + a_col(lane)));
#pragma unroll
      for (int kn = 0; kn < KW / 16; ++kn) {
        uint32_t bk[4], bv[4];
        const int r = wc * KW + kn * 16 + b_row(lane), c = ks * 16 + b_col(lane);
        ldsm_x4(bk, sK + toff<D>(r, c));
        ldsm_x4(bv, sV + toff<D>(r, c));
        mma(s[2 * kn], aq, bk[0], bk[1]);
        mma(s[2 * kn + 1], aq, bk[2], bk[3]);
        mma(dp[2 * kn], ao, bv[0], bv[1]);
        mma(dp[2 * kn + 1], ao, bv[2], bv[3]);
      }
    }
    const bool full = nk == TK && nq == TQ &&
                      full_tile(causal, window, q_first, q_last, k_first, k_last);
#pragma unroll
    for (int j = 0; j < KW / 8; ++j) {
      const int key = wc * KW + 8 * j + 2 * t;  // key of e = 0; key + 1 that of e = 1
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = wr * 16 + (lane >> 2) + 8 * hh;  // this lane's q rows
        float ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool live = full || (r < nq && key + e < nk &&
                                     live_pair(causal, window, q_first + r, k_first + key + e));
          const float p = live ? exp2f(s[j][2 * hh + e] * scale_log2 - l2[hh]) : 0.f;
          ds[e] = live ? p * (dp[j][2 * hh + e] - dl[hh]) * scale : 0.f;
        }
        *reinterpret_cast<uint32_t*>(sDS + toff<TK>(r, key)) = pack_bf16(ds[0], ds[1]);
      }
    }
    __syncthreads();

    // phase 2: dQ += dS K, 16 q rows x DW columns a warp
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      uint32_t ads[4];
      ldsm_x4(ads, sDS + toff<TK>(wr * 16 + a_row(lane), kk * 16 + a_col(lane)));
#pragma unroll
      for (int dn = 0; dn < DW / 16; ++dn) {
        uint32_t bk[4];
        ldsm_x4_t(bk, sK + toff<D>(kk * 16 + a_row(lane), wc * DW + dn * 16 + a_col(lane)));
        mma(acc[2 * dn], ads, bk[0], bk[1]);
        mma(acc[2 * dn + 1], ads, bk[2], bk[3]);
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block (no live tile: Q's group)

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = wr * 16 + (lane >> 2) + 8 * hh;
    if (r >= nq) continue;
    float* out = dq + (row0 + r) * D + wc * DW + 2 * t;
#pragma unroll
    for (int j = 0; j < DW / 8; ++j)
      *reinterpret_cast<float2*>(out + 8 * j) = make_float2(acc[j][2 * hh], acc[j][2 * hh + 1]);
  }
}

// ---------------------------------------------------------------------------
// flash_bwd_dkv in bf16: tensor cores, q heads split across blocks
// ---------------------------------------------------------------------------

template <int D>
struct TcDkv {
  static constexpr int TK = 64;               // keys a block keeps for its life
  static constexpr int TQ = 64;               // q rows a tile
  static constexpr int WR = TK / 16;          // warp rows: 16 keys each
  static constexpr int WC = warp_cols<D>();   // warp columns
  static constexpr int NT = 32 * WR * WC;
  static constexpr int QW = TQ / WC;          // queries of S^T, dP^T a warp computes
  static constexpr int DW = D / WC;           // dK, dV columns a warp accumulates
  // phase 1 takes a warp's queries QB at a time: 16 up to head_dim 64, which
  // halves the registers S^T and dP^T hold, at the price of reloading the K
  // and V fragments; at most 32 above, where those reloads cost more (all QW
  // at d 128 and 256; half of them at d 80, whose one warp column holds 80
  // accumulator floats of dK and dV a thread)
  static constexpr int QB = D <= 64 ? 16 : (QW < 32 ? QW : 32);
  static_assert(D % 16 == 0 && DW % 16 == 0 && QB % 16 == 0 && QW % QB == 0,
                "phase 1 steps d by 16 over QB queries; phase 2 covers DW in 16s");
  // up to head_dim 64 two blocks share an SM (128 registers a thread), so
  // one block's products run while the other waits at a barrier
  static constexpr int MIN_BLOCKS = D <= 64 ? 2 : 1;
  static constexpr int P = D + flash::PAD;    // pitch of a [.][D] tile row
  static constexpr int PQ = TQ + flash::PAD;  // pitch of a [.][TQ] tile row
  // bf16 sK, sV [TK][P], two buffers of sQ, sDO [TQ][P], sP, sDS [TK][PQ];
  // fp32 two buffers of sL, sDelta [TQ]
  static constexpr size_t smem =
      sizeof(bf16) * ((2 * size_t(TK) + 4 * size_t(TQ)) * P + 2 * size_t(TK) * PQ) +
      sizeof(float) * 4 * TQ;
};

// The q tile `it` of a dkv block's walk over (q head of its split) x (live
// q tile): its first row in [b, hq, sq] and its live rows.
struct QTile {
  size_t row0;
  int q0, nq;
};

__device__ __forceinline__ QTile q_tile(int it, int n_q, int qt_lo, int h_begin, int hq, int sq,
                                        int rows) {
  const int h = h_begin + it / n_q;
  const int q0 = (qt_lo + it % n_q) * rows;
  return {((size_t)blockIdx.z * hq + h) * sq + q0, q0, min(rows, sq - q0)};
}

template <int D>
__global__ void __launch_bounds__(TcDkv<D>::NT, TcDkv<D>::MIN_BLOCKS)
flash_bwd_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ dk, float* __restrict__ dv, int hq, int hkv, int sq,
                        int sk, int causal, int window, int q_offset, int k_offset, float scale,
                        int n_split) {
  using namespace flash;
  using C = TcDkv<D>;
  constexpr int TK = C::TK, TQ = C::TQ, NTH = C::NT, QW = C::QW, DW = C::DW, P = C::P;
  constexpr int QB = C::QB;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + TK * P;
  bf16* sQb = sV + TK * P;        // buffer u at sQb + u * TQ * P
  bf16* sDOb = sQb + 2 * TQ * P;  // buffer u at sDOb + u * TQ * P
  bf16* sP = sDOb + 2 * TQ * P;   // P^T [key][query]
  bf16* sDS = sP + TK * C::PQ;    // dS^T [key][query]
  float* sLb = reinterpret_cast<float*>(sDS + TK * C::PQ);  // buffer u at sLb + u * TQ
  float* sDeltab = sLb + 2 * TQ;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = lane & 3;
  const int wr = warp % C::WR, wc = warp / C::WR;
  const int k0 = blockIdx.x * TK;
  const int nk = min(TK, sk - k0);
  const int hk = blockIdx.y / n_split, split = blockIdx.y % n_split;
  const int g = hq / hkv, per_split = g / n_split;
  const int h_begin = hk * g + split * per_split;  // heads h_begin .. + per_split
  const size_t kv0 = ((size_t)blockIdx.z * hkv + hk) * sk + k0;
  load_rows_async<TK, D, NTH>(sK, k + kv0 * D, nk, tid);
  load_rows_async<TK, D, NTH>(sV, v + kv0 * D, nk, tid);
  cp_async_commit();

  float dk_acc[DW / 8][4], dv_acc[DW / 8][4];
#pragma unroll
  for (int j = 0; j < DW / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  // the live q tiles of this key tile are one contiguous run; the block
  // walks (its q heads) x (that run)
  const int k_first = k_offset + k0, k_last = k_first + nk - 1;
  const int nqt = (sq + TQ - 1) / TQ;
  int qt_lo = nqt, qt_hi = -1;
  for (int qt = 0; qt < nqt; ++qt) {
    const int q_first = q_offset + qt * TQ;
    if (!dead_tile(causal, window, q_first, q_first + min(TQ, sq - qt * TQ) - 1, k_first,
                   k_last)) {
      qt_lo = min(qt_lo, qt);
      qt_hi = qt;
    }
  }
  const int n_q = qt_hi - qt_lo + 1;
  const int n_iter = n_q > 0 ? per_split * n_q : 0;

  // a q tile's Q, dO (bf16, 16-byte copies), L and delta (fp32, 4-byte
  // copies: a row of them need not start 16-byte aligned) into buffer u,
  // as one cp.async group
  auto stage = [&](int it, int u) {
    const QTile tl = q_tile(it, n_q, qt_lo, h_begin, hq, sq, TQ);
    load_rows_async<TQ, D, NTH>(sQb + u * TQ * P, q + tl.row0 * D, tl.nq, tid);
    load_rows_async<TQ, D, NTH>(sDOb + u * TQ * P, dout + tl.row0 * D, tl.nq, tid);
    if (tid < TQ) {
      const bool ok = tid < tl.nq;
      cp_async4(sLb + u * TQ + tid, ok ? lse + tl.row0 + tid : lse, ok);
      cp_async4(sDeltab + u * TQ + tid, ok ? delta + tl.row0 + tid : delta, ok);
    }
    cp_async_commit();
  };
  if (n_iter > 0) stage(0, 0);

  const float scale_log2 = scale * LOG2E;
  for (int it = 0; it < n_iter; ++it) {
    const int u = it & 1;
    const bf16* sQ = sQb + u * TQ * P;
    const bf16* sDO = sDOb + u * TQ * P;
    const float* sL = sLb + u * TQ;
    const float* sDelta = sDeltab + u * TQ;
    const QTile tq = q_tile(it, n_q, qt_lo, h_begin, hq, sq, TQ);
    if (it + 1 < n_iter) {  // the next tile's copies fly while this one is computed
      stage(it + 1, u ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int q_first = q_offset + tq.q0, q_last = q_first + tq.nq - 1, nq = tq.nq;

    // phase 1, QB queries at a time: S^T = K Q^T and dP^T = V dO^T for the
    // warp's 16 keys, then P^T = exp(S^T scale - L) (as 2^(S^T scale log2 e
    // - L log2 e)) and dS^T = P^T (dP^T - delta) scale, masked, rounded to
    // bf16 into shared memory
    const bool full = nk == TK && nq == TQ &&
                      full_tile(causal, window, q_first, q_last, k_first, k_last);
#pragma unroll
    for (int qb = 0; qb < QW / QB; ++qb) {
      float s[QB / 8][4], dp[QB / 8][4];
#pragma unroll
      for (int j = 0; j < QB / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        uint32_t ak[4], av[4];
        ldsm_x4(ak, sK + toff<D>(wr * 16 + a_row(lane), ks * 16 + a_col(lane)));
        ldsm_x4(av, sV + toff<D>(wr * 16 + a_row(lane), ks * 16 + a_col(lane)));
#pragma unroll
        for (int qn = 0; qn < QB / 16; ++qn) {
          uint32_t bq[4], bo[4];
          const int r = wc * QW + qb * QB + qn * 16 + b_row(lane), c = ks * 16 + b_col(lane);
          ldsm_x4(bq, sQ + toff<D>(r, c));
          ldsm_x4(bo, sDO + toff<D>(r, c));
          mma(s[2 * qn], ak, bq[0], bq[1]);
          mma(s[2 * qn + 1], ak, bq[2], bq[3]);
          mma(dp[2 * qn], av, bo[0], bo[1]);
          mma(dp[2 * qn + 1], av, bo[2], bo[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < QB / 8; ++j) {
        // query of e = 0 and 2; c + 1 that of e = 1 and 3
        const int c = wc * QW + qb * QB + 8 * j + 2 * t;
        const float l2[2] = {sL[c] * LOG2E, sL[c + 1] * LOG2E};
        const float dl[2] = {sDelta[c], sDelta[c + 1]};
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int key = wr * 16 + (lane >> 2) + 8 * hh;  // this lane's key rows
          float p[2], ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int qc = c + e;
            const bool live = full || (key < nk && qc < nq &&
                                       live_pair(causal, window, q_first + qc, k_first + key));
            p[e] = live ? exp2f(s[j][2 * hh + e] * scale_log2 - l2[e]) : 0.f;
            ds[e] = live ? p[e] * (dp[j][2 * hh + e] - dl[e]) * scale : 0.f;
          }
          *reinterpret_cast<uint32_t*>(sP + toff<TQ>(key, c)) = pack_bf16(p[0], p[1]);
          *reinterpret_cast<uint32_t*>(sDS + toff<TQ>(key, c)) = pack_bf16(ds[0], ds[1]);
        }
      }
    }
    __syncthreads();

    // phase 2: dV += P^T dO and dK += dS^T Q, 16 keys x DW columns a warp
#pragma unroll
    for (int kq = 0; kq < TQ / 16; ++kq) {
      uint32_t ap[4], ads[4];
      ldsm_x4(ap, sP + toff<TQ>(wr * 16 + a_row(lane), kq * 16 + a_col(lane)));
      ldsm_x4(ads, sDS + toff<TQ>(wr * 16 + a_row(lane), kq * 16 + a_col(lane)));
#pragma unroll
      for (int dn = 0; dn < DW / 16; ++dn) {
        uint32_t bo[4], bq[4];
        const int r = kq * 16 + a_row(lane), c = wc * DW + dn * 16 + a_col(lane);
        ldsm_x4_t(bo, sDO + toff<D>(r, c));
        ldsm_x4_t(bq, sQ + toff<D>(r, c));
        mma(dv_acc[2 * dn], ap, bo[0], bo[1]);
        mma(dv_acc[2 * dn + 1], ap, bo[2], bo[3]);
        mma(dk_acc[2 * dn], ads, bq[0], bq[1]);
        mma(dk_acc[2 * dn + 1], ads, bq[2], bq[3]);
      }
    }
    __syncthreads();  // every warp is done with this tile's buffers and sP, sDS
  }
  cp_async_wait<0>();  // no copy outlives the block (no live tile: K/V's group)

  // this split's dK and dV: the outputs (n_split 1) or its workspace slice
  const size_t split_off = (size_t)split * gridDim.z * hkv * sk * D;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = wr * 16 + (lane >> 2) + 8 * hh;
    if (key >= nk) continue;
    const size_t base = split_off + (kv0 + key) * D + wc * DW + 2 * t;
#pragma unroll
    for (int j = 0; j < DW / 8; ++j) {
      *reinterpret_cast<float2*>(dk + base + 8 * j) =
          make_float2(dk_acc[j][2 * hh], dk_acc[j][2 * hh + 1]);
      *reinterpret_cast<float2*>(dv + base + 8 * j) =
          make_float2(dv_acc[j][2 * hh], dv_acc[j][2 * hh + 1]);
    }
  }
}

// dO, fp32, rounded to bf16 once for all the blocks that read it (n4
// float4s)
__global__ void __launch_bounds__(256)
flash_bwd_round_do_kernel(const float4* __restrict__ x, uint2* __restrict__ y, size_t n4) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    const float4 a = x[i];
    y[i] = make_uint2(flash::pack_bf16(a.x, a.y), flash::pack_bf16(a.z, a.w));
  }
}

// out = sum over s = 0 .. n_split - 1 of part[s], in that order (blockIdx.y:
// 0 for dk, 1 for dv); n4 float4s a split
__global__ void __launch_bounds__(256)
flash_bwd_dkv_split_sum_kernel(const float4* __restrict__ part_dk,
                               const float4* __restrict__ part_dv, float4* __restrict__ dk,
                               float4* __restrict__ dv, int n_split, size_t n4) {
  const float4* part = blockIdx.y == 0 ? part_dk : part_dv;
  float4* out = blockIdx.y == 0 ? dk : dv;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    float4 acc = part[i];
    for (int s = 1; s < n_split; ++s) {
      const float4 x = part[s * n4 + i];
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    out[i] = acc;
  }
}

struct Args {
  const void *q, *k, *v;
  const float *dout, *lse, *delta;
  float *dq, *dk, *dv;
  void* dout16;  // bf16 dkv: dO rounded to bf16, b x hq x sq x d
  float* ws;     // bf16 dkv with n_split > 1: partial dk, then dv, n_split x b x hkv x sk x d each
  int n_split;   // bf16 dkv: q-head splits of a group (1 for fp32)
  int b, hq, hkv, sq, sk, causal, window, q_offset, k_offset;
  float scale;
  cudaStream_t stream;
};

template <int D>
cudaError_t launch_dq(const Args& a) {
  constexpr size_t smem = dq_smem_bytes<D>();
  static bool configured[64] = {};
  auto kern = flash_bwd_dq_kernel<D>;
  cudaError_t err = flash::configure_once(kern, smem, configured);
  if (err != cudaSuccess) return err;
  constexpr int TQ = tile_rows<D>();
  const dim3 grid((a.sq + TQ - 1) / TQ, a.hq, a.b);
  kern<<<grid, NT, smem, a.stream>>>(static_cast<const float*>(a.q),
                                     static_cast<const float*>(a.k),
                                     static_cast<const float*>(a.v), a.dout, a.lse, a.delta,
                                     a.dq, a.hq, a.hkv, a.sq, a.sk, a.causal, a.window,
                                     a.q_offset, a.k_offset, a.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const Args& a) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  static bool configured[64] = {};
  auto kern = flash_bwd_dkv_kernel<D>;
  cudaError_t err = flash::configure_once(kern, smem, configured);
  if (err != cudaSuccess) return err;
  constexpr int TK = tile_rows<D>();
  const dim3 grid((a.sk + TK - 1) / TK, a.hkv, a.b);
  kern<<<grid, NT, smem, a.stream>>>(static_cast<const float*>(a.q),
                                     static_cast<const float*>(a.k),
                                     static_cast<const float*>(a.v), a.dout, a.lse, a.delta,
                                     a.dk, a.dv, a.hq, a.hkv, a.sq, a.sk, a.causal, a.window,
                                     a.q_offset, a.k_offset, a.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq_tc(const Args& a) {
  using C = TcDq<D>;
  static bool configured[64] = {};
  auto kern = flash_bwd_dq_tc_kernel<D>;
  cudaError_t err = flash::configure_once(kern, C::smem, configured);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.sq + C::TQ - 1) / C::TQ, a.hq, a.b);
  kern<<<grid, C::NT, C::smem, a.stream>>>(static_cast<const bf16*>(a.q),
                                           static_cast<const bf16*>(a.k),
                                           static_cast<const bf16*>(a.v), a.dout, a.lse,
                                           a.delta, a.dq, a.hq, a.hkv, a.sq, a.sk, a.causal,
                                           a.window, a.q_offset, a.k_offset, a.scale);
  return cudaGetLastError();
}

// blocks of 256 threads for a grid-stride loop over n items
unsigned grid_stride_blocks(size_t n) {
  const size_t blocks = (n + 255) / 256;
  return (unsigned)(blocks < 4096 ? (blocks > 0 ? blocks : 1) : 4096);
}

template <int D>
cudaError_t launch_dkv_tc(const Args& a) {
  using C = TcDkv<D>;
  static bool configured[64] = {};
  auto kern = flash_bwd_dkv_tc_kernel<D>;
  cudaError_t err = flash::configure_once(kern, C::smem, configured);
  if (err != cudaSuccess) return err;
  if (a.n_split < 1 || (a.hq / a.hkv) % a.n_split != 0 || (a.n_split > 1 && a.ws == nullptr))
    return cudaErrorInvalidValue;
  if (a.dout16 == nullptr) return cudaErrorInvalidValue;
  const size_t n_do4 = (size_t)a.b * a.hq * a.sq * D / 4;  // float4s of dO
  flash_bwd_round_do_kernel<<<grid_stride_blocks(n_do4), 256, 0, a.stream>>>(
      reinterpret_cast<const float4*>(a.dout), reinterpret_cast<uint2*>(a.dout16), n_do4);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t n = (size_t)a.b * a.hkv * a.sk * D;  // elements of dk (and of dv)
  float* dk = a.n_split > 1 ? a.ws : a.dk;
  float* dv = a.n_split > 1 ? a.ws + a.n_split * n : a.dv;
  const dim3 grid((a.sk + C::TK - 1) / C::TK, a.hkv * a.n_split, a.b);
  kern<<<grid, C::NT, C::smem, a.stream>>>(static_cast<const bf16*>(a.q),
                                           static_cast<const bf16*>(a.k),
                                           static_cast<const bf16*>(a.v),
                                           static_cast<const bf16*>(a.dout16), a.lse, a.delta,
                                           dk, dv, a.hq, a.hkv, a.sq, a.sk, a.causal, a.window,
                                           a.q_offset, a.k_offset, a.scale, a.n_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.n_split == 1) return err;
  const size_t n4 = n / 4;  // d is a multiple of 16
  const dim3 sum_grid(grid_stride_blocks(n4), 2);
  flash_bwd_dkv_split_sum_kernel<<<sum_grid, 256, 0, a.stream>>>(
      reinterpret_cast<const float4*>(dk), reinterpret_cast<const float4*>(dv),
      reinterpret_cast<float4*>(a.dk), reinterpret_cast<float4*>(a.dv), a.n_split, n4);
  return cudaGetLastError();
}

// the CUDA-core kernels for fp32, the tensor-core kernels for bf16
template <int D>
cudaError_t launch(bool dq, bool bf, const Args& a) {
  if (dq) return bf ? launch_dq_tc<D>(a) : launch_dq<D>(a);
  return bf ? launch_dkv_tc<D>(a) : launch_dkv<D>(a);
}

int dispatch(bool dq, int dtype, int d, const Args& a) {
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  if (!dq && dtype == 0 && a.n_split != 1) return cudaErrorInvalidValue;
  const bool bf = dtype == 1;
  switch (d) {
    case 16: return launch<16>(dq, bf, a);
    case 32: return launch<32>(dq, bf, a);
    case 64: return launch<64>(dq, bf, a);
    case 80: return launch<80>(dq, bf, a);
    case 128: return launch<128>(dq, bf, a);
    case 256: return launch<256>(dq, bf, a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v); dout, lse, delta and the
// outputs are float32.  Each returns the launch's cudaError_t (0 = launched).
extern "C" int flash_bwd_dq_launch(int dtype, int d, const void* q, const void* k,
                                   const void* v, const float* dout, const float* lse,
                                   const float* delta, float* dq, int b, int hq, int hkv, int sq,
                                   int sk, int causal, int window, int q_offset, int k_offset,
                                   float scale, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, nullptr, nullptr, nullptr, 1,
               b, hq, hkv, sq, sk, causal, window, q_offset, k_offset, scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch(true, dtype, d, a);
}

// bf16 only (null / 1 for fp32): dout16, b * hq * sq * d bf16 of workspace
// for dO rounded to bf16; n_split, the q-head splits of each kv group; with
// n_split > 1, ws, 2 * n_split * b * hkv * sk * d floats of workspace.
extern "C" int flash_bwd_dkv_launch(int dtype, int d, const void* q, const void* k,
                                    const void* v, const float* dout, const float* lse,
                                    const float* delta, float* dk, float* dv, void* dout16,
                                    float* ws, int n_split, int b, int hq, int hkv, int sq,
                                    int sk, int causal, int window, int q_offset, int k_offset,
                                    float scale, void* stream) {
  const Args a{q, k, v, dout, lse, delta, nullptr, dk, dv, dout16, ws, n_split,
               b, hq, hkv, sq, sk, causal, window, q_offset, k_offset, scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch(false, dtype, d, a);
}

extern "C" const char* flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
