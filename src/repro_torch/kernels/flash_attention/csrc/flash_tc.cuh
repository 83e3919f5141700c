// Tile helpers of the flash-attention kernels (sm_90a), shared by flash_fwd.cu
// and flash_bwd.cu: the mask predicates every kernel applies, the
// shared-memory opt-in, and the pieces of the bf16 tensor-core kernels:
//   * bf16 tiles in shared memory, [rows][COLS + PAD] row-major (toff): the
//     pad keeps the eight row addresses of one ldmatrix phase in distinct
//     banks;
//   * cp.async global -> shared copies (16 bytes; 4 for rows of fp32 that
//     need not be 16-byte aligned), zero-filled past a ragged tail (a
//     masked p = 0 times a garbage NaN would still give NaN);
//   * ldmatrix x4 (plain and .trans) fragment loads and mma.sync m16n8k16
//     with bf16 operands and fp32 accumulation.
// Fragment layouts of m16n8k16 (lane = 4 g + t, g = lane / 4, t = lane % 4):
//   A 16 x 16: a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..), a3 (g+8, 2t+8..)
//   B 16 x 8:  b0 (k 2t..2t+1, n g), b1 (k 2t+8..2t+9, n g)
//   C 16 x 8:  c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1)
// so the C fragments of two neighbouring 8-column blocks are, rounded to
// bf16 and packed in pairs, the A fragment of the next product over those
// 16 columns: a P tile never leaves registers.
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace flash {

using bf16 = __nv_bfloat16;

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;  // exp(x) = 2^(x log2 e): one MUFU.EX2

// a tile that no (q, k) pair of it can see: wholly above the diagonal or
// wholly left of the window band (block-uniform)
__device__ __forceinline__ bool dead_tile(int causal, int window, int q_first, int q_last,
                                          int k_first, int k_last) {
  return causal && (q_last < k_first || (window > 0 && k_last < q_first - window + 1));
}

// every (q, k) pair of the tile is live
__device__ __forceinline__ bool full_tile(int causal, int window, int q_first, int q_last,
                                          int k_first, int k_last) {
  return !causal || (q_first >= k_last && (window <= 0 || q_last - k_first < window));
}

__device__ __forceinline__ bool live_pair(int causal, int window, int qpos, int kpos) {
  return !causal || (qpos >= kpos && (window <= 0 || qpos - kpos < window));
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

// bf16 tiles in shared memory are [rows][COLS + PAD], row-major: a row's
// pitch is (COLS + 8) * 2 bytes = 16 * (COLS / 8 + 1), an odd number of
// 16-byte units whenever COLS % 16 == 0 (11 at COLS 80, 9 at 64, 17 at 128),
// so the eight 16-byte rows of one ldmatrix phase fall in eight distinct
// 16-byte slots of the 128-byte bank line, and a fragment's address is one
// per-lane offset plus a compile-time constant.
constexpr int PAD = 8;

template <int COLS>
__device__ __forceinline__ int toff(int row, int col) {
  static_assert(COLS % 16 == 0, "tile width: a multiple of 16 (one k step of m16n8k16)");
  return row * (COLS + PAD) + col;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes when !pred (src not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

// 4 bytes global -> shared, or 4 zero bytes when !pred (src not read)
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [0, n) of a contiguous [ROWS, COLS] bf16 block into a padded tile,
// rows [n, ROWS) zero-filled; NT threads share the copies
template <int ROWS, int COLS, int NT>
__device__ __forceinline__ void load_rows_async(bf16* dst, const bf16* src, int n, int tid) {
  constexpr int CPR = COLS / 8;  // 16-byte chunks a row
#pragma unroll 4
  for (int i = tid; i < ROWS * CPR; i += NT) {
    const int r = i / CPR, c = (i % CPR) * 8;
    const bool ok = r < n;
    cp_async16(dst + toff<COLS>(r, c), ok ? src + (size_t)r * COLS + c : src, ok);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// Per-lane ldmatrix addresses, as (row, col) of the tile:
//  * a_row/a_col: the A fragment of the 16 x 16 block at (r0, c0) of a
//    row-major [M][K] tile; with ldsm_x4_t, the same addresses give the B
//    fragments of two 8-column blocks (n0 = c0, c0 + 8) of a row-major
//    [K][N] tile at k0 = r0: regs 0-1 for the first, 2-3 for the second.
//  * b_row/b_col: with ldsm_x4, the B fragments of two 8-row blocks
//    (n0, n0 + 8) of a row-major [N][K] tile (B transposed) at k0.
__device__ __forceinline__ int a_row(int lane) { return lane & 15; }
__device__ __forceinline__ int a_col(int lane) { return (lane >> 4) << 3; }
__device__ __forceinline__ int b_row(int lane) { return (lane & 7) + ((lane >> 4) << 3); }
__device__ __forceinline__ int b_col(int lane) { return ((lane >> 3) & 1) << 3; }

// d += a * b on the tensor cores: bf16 operands, fp32 accumulation
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace flash
