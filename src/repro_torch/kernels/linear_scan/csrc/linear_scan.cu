// linear_scan for Hopper (sm_90a): every inclusive state of
//   h_t = a_t * h_{t-1} + b_t   (elementwise over channels), h_{-1} = h0,
// over a, b [batch, seq, chan] in fp32 or bf16 (upcast on load), fp32 out.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/linear_scan/kernel.py::linear_scan (_scan_kernel).
// It computes what that kernel computes, not a block-by-block copy.  The
// Pallas kernel walks seq blocks in order on one core, carrying h in VMEM,
// and scans inside a block with a vectorised associative scan.  On the
// card the channels are what is parallel: one thread owns one (batch row,
// channel, sequence segment), neighbouring threads take neighbouring
// channels, so every step's loads and stores are coalesced, and the
// recurrence is a plain loop along the segment.  The segments compose the
// way the Pallas kernel composes its blocks, h = B_cum + A_cum * h_carry:
//   1. linear_scan_summary: each segment folds its steps into (A, B), the
//      product of its a and its state from a zero start;
//   2. linear_scan_carry: one thread per (batch row, channel) walks the
//      segments' summaries from h0 and writes the state entering each;
//   3. linear_scan_apply: each segment replays h = a h + b from its
//      incoming state and writes every h.
// With one segment, passes 1 and 2 are skipped and h0 enters directly.
// Any seq and chan are taken (ragged tails are masked); the wrapper picks
// the segment length so that about two thousand threads per SM are in
// flight.  reverse = 1 runs the recurrence from the last step to the first
// (h_t = a_t h_{t+1} + b_t, h_seq = h0), which the backward's adjoint scan
// uses without flipped copies of its inputs and output.
//
// What bounds it on this card: bytes.  A step is one multiply-add per
// element against 2 or 4 bytes of a and of b read and 4 bytes of h
// written (12 bytes an element in fp32, the bound); this version reads a
// and b twice (passes 1 and 3), 20 bytes an element, for a grid that
// fills the 132 SMs at batch 1.  The summaries and carries are
// [batch, segments, chan] fp32 scratch the wrapper allocates.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;  // threads per block: 128 consecutive channels

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

struct Geom {
  int seq, chan, seg_len, nseg, reverse;
};

// element offset of step k (in scan order) of batch row bi, channel c
__device__ __forceinline__ size_t at(const Geom& g, int bi, int k, int c) {
  const int t = g.reverse ? g.seq - 1 - k : k;
  return ((size_t)bi * g.seq + t) * g.chan + c;
}

__device__ __forceinline__ size_t seg_at(const Geom& g, int bi, int seg, int c) {
  return ((size_t)bi * g.nseg + seg) * g.chan + c;
}

template <typename TA, typename TB>
__global__ void __launch_bounds__(NT)
linear_scan_summary(const TA* __restrict__ a, const TB* __restrict__ b, float* __restrict__ sum_a,
                    float* __restrict__ sum_b, Geom g) {
  const int c = blockIdx.x * NT + threadIdx.x;
  const int seg = blockIdx.y, bi = blockIdx.z;
  if (c >= g.chan) return;
  const int k0 = seg * g.seg_len, k1 = min(g.seq, k0 + g.seg_len);
  float A = 1.f, B = 0.f;
  for (int k = k0; k < k1; ++k) {
    const size_t i = at(g, bi, k, c);
    const float av = to_f32(a[i]);
    B = fmaf(av, B, to_f32(b[i]));
    A *= av;
  }
  sum_a[seg_at(g, bi, seg, c)] = A;
  sum_b[seg_at(g, bi, seg, c)] = B;
}

__global__ void __launch_bounds__(NT)
linear_scan_carry(const float* __restrict__ sum_a, const float* __restrict__ sum_b,
                  const float* __restrict__ h0, float* __restrict__ carry, Geom g) {
  const int c = blockIdx.x * NT + threadIdx.x;
  const int bi = blockIdx.y;
  if (c >= g.chan) return;
  float h = h0 != nullptr ? h0[(size_t)bi * g.chan + c] : 0.f;
  for (int seg = 0; seg < g.nseg; ++seg) {
    const size_t o = seg_at(g, bi, seg, c);
    carry[o] = h;
    h = fmaf(sum_a[o], h, sum_b[o]);
  }
}

// carry: the state entering each segment, [batch, nseg, chan]; with one
// segment that is h0 itself ([batch, chan]) or null (zeros)
template <typename TA, typename TB>
__global__ void __launch_bounds__(NT)
linear_scan_apply(const TA* __restrict__ a, const TB* __restrict__ b,
                  const float* __restrict__ carry, float* __restrict__ out, Geom g) {
  const int c = blockIdx.x * NT + threadIdx.x;
  const int seg = blockIdx.y, bi = blockIdx.z;
  if (c >= g.chan) return;
  const int k0 = seg * g.seg_len, k1 = min(g.seq, k0 + g.seg_len);
  float h = carry != nullptr ? carry[seg_at(g, bi, seg, c)] : 0.f;
  for (int k = k0; k < k1; ++k) {
    const size_t i = at(g, bi, k, c);
    h = fmaf(to_f32(a[i]), h, to_f32(b[i]));
    out[i] = h;
  }
}

template <typename TA, typename TB>
cudaError_t launch(const void* a_, const void* b_, const float* h0, float* out, float* sum_a,
                   float* sum_b, float* carry, int batch, const Geom& g, cudaStream_t stream) {
  const TA* a = static_cast<const TA*>(a_);
  const TB* b = static_cast<const TB*>(b_);
  const int cblocks = (g.chan + NT - 1) / NT;
  const dim3 grid(cblocks, g.nseg, batch);
  const float* enter = h0;
  if (g.nseg > 1) {
    linear_scan_summary<TA, TB><<<grid, NT, 0, stream>>>(a, b, sum_a, sum_b, g);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    linear_scan_carry<<<dim3(cblocks, batch), NT, 0, stream>>>(sum_a, sum_b, h0, carry, g);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    enter = carry;
  }
  linear_scan_apply<TA, TB><<<grid, NT, 0, stream>>>(a, b, enter, out, g);
  return cudaGetLastError();
}

template <typename TA>
cudaError_t dispatch_b(int b_dtype, const void* a, const void* b, const float* h0, float* out,
                       float* sum_a, float* sum_b, float* carry, int batch, const Geom& g,
                       cudaStream_t stream) {
  if (b_dtype == 0)
    return launch<TA, float>(a, b, h0, out, sum_a, sum_b, carry, batch, g, stream);
  if (b_dtype == 1)
    return launch<TA, __nv_bfloat16>(a, b, h0, out, sum_a, sum_b, carry, batch, g, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// a_dtype, b_dtype: 0 = float32, 1 = bfloat16.  h0 [batch, chan] fp32 or
// null (zeros); out [batch, seq, chan] fp32.  With nseg > 1, sum_a, sum_b
// and carry are [batch, nseg, chan] fp32 scratch; with nseg == 1 they may
// be null.  Segment s covers scan steps [s * seg_len, min(seq, (s + 1) *
// seg_len)).  Returns the first launch's cudaError_t (0 = all launched).
extern "C" int linear_scan_launch(int a_dtype, int b_dtype, const void* a, const void* b,
                                  const float* h0, float* out, float* sum_a, float* sum_b,
                                  float* carry, int batch, int seq, int chan, int seg_len,
                                  int nseg, int reverse, void* stream) {
  if (batch <= 0 || seq <= 0 || chan <= 0 || seg_len <= 0 || nseg <= 0 ||
      (long long)seg_len * nseg < seq || (long long)seg_len * (nseg - 1) >= seq)
    return cudaErrorInvalidValue;
  if (nseg > 1 && (sum_a == nullptr || sum_b == nullptr || carry == nullptr))
    return cudaErrorInvalidValue;
  const Geom g{seq, chan, seg_len, nseg, reverse ? 1 : 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a_dtype == 0)
    return dispatch_b<float>(b_dtype, a, b, h0, out, sum_a, sum_b, carry, batch, g, st);
  if (a_dtype == 1)
    return dispatch_b<__nv_bfloat16>(b_dtype, a, b, h0, out, sum_a, sum_b, carry, batch, g, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* linear_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
