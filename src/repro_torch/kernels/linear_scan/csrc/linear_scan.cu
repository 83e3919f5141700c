// linear_scan for Hopper (sm_90a): every inclusive state of
//   h_t = a_t * h_{t-1} + b_t   (elementwise over channels), h_{-1} = h0,
// over a, b [batch, seq, chan] in fp32 or bf16 (upcast on load), fp32 out;
// and its fused backward, linear_scan_bwd.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/linear_scan/kernel.py::linear_scan (_scan_kernel),
// and, for the backward, that kernel as the JAX custom_vjp reruns it on
// flipped, shifted inputs (src/repro/kernels/linear_scan/ops.py).  It
// computes what that kernel computes, not a block-by-block copy.  The
// Pallas kernel walks seq blocks in order on one core, carrying h in VMEM.
// On the card the channels are what is parallel: one thread owns one (batch
// row, channel, segment of SEG scan steps), neighbouring threads take
// neighbouring channels, so every step's loads and stores are coalesced,
// and the recurrence is a plain loop along the segment.
//
// What bounds it on this card: bytes.  A step is one multiply-add per
// element against 2 or 4 bytes of a and of b read and 4 bytes of h written
// (12 bytes an element in fp32).  So a and b are read once: a thread stages
// its segment's SEG steps into its column of a shared-memory tile (fp32 by
// 4-byte cp.async, so the bytes in flight hold no registers: six forward
// blocks, four backward ones, fit an SM), folds them into the segment's
// summary (A, B) (the product of its a, and its state from a zero start),
// learns the state entering the segment from its predecessors, and
// replays h = a h + b from the tile, writing every h.  One launch, one
// pass.
//
// Segments meet through a look-back that only ever applies summaries to a
// state, never composes two summaries, so every segment's entering state
// is bitwise the serial fold  h = fmaf(A_j, h, B_j)  over the segments
// before it from h0, whoever computed it and in whatever order the blocks
// ran.  A block takes its segment from an atomic ticket (segment-major
// over the batch rows and channel blocks), so it only ever waits on blocks
// that have already started.  It publishes its summary (flag SUMMARY)
// before it waits on anything; then warp 0 reads the flags of the 32
// segments before it at once, waits until each has published something,
// and takes the nearest that has published its inclusive state (flag
// STATE; h0 before segment 0), else moves 32 further back.  The block
// folds the summaries between that state and itself in order, publishes
// its own state fmaf(A, enter, B) (flag STATE), and replays.  Flags and the
// ticket are zeroed on the stream by each call (cudaMemsetAsync), so a
// CUDA graph's replays start clean; every spin is capped and traps past
// the cap, so a deadlock becomes a launch error, not a hung card.
//
// The plan (SEG steps a segment) is fixed, a function of the shapes alone:
// the bits do not depend on the card's SM count.
//
// The backward is the adjoint scan run from the last step to the first,
//   g_t = dout_t + a_{t+1} g_{t+1}  (a_seq = 1),
//   db_t = g_t,  da_t = g_t h_{t-1}  (h_{-1} = h0, or 0),  dh0 = a_0 g_0,
// on the same plan and the same arithmetic as the forward in reverse mode
// over (a shifted by one step, dout), reading a[t + 1] and h[t - 1] by
// index: no shifted copy is made.  Its g, da and dh0 are so bit for bit
// those of the forward kernel run on a copy of a shifted, followed by one
// IEEE multiply and a round-to-nearest-even cast.  It reads a, dout and h
// and writes da and db: 20 bytes an element in fp32, its bound.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int NT = 128;   // threads per block: 128 consecutive channels
constexpr int SEG = 32;   // scan steps per segment (kernel.py SEGMENT)
constexpr int TILE = SEG * NT;  // floats of one shared tile
constexpr int FOLD = 8;   // summaries a thread loads at once when it folds
constexpr unsigned SPIN_CAP = 1u << 24;  // polls of one flag window before __trap()
constexpr unsigned FULL = 0xffffffffu;

enum : int { NONE = 0, SUMMARY = 1, STATE = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// one element global -> this thread's column of a shared tile, as fp32:
// fp32 by a 4-byte cp.async (no register holds it in flight), bf16 through
// a register and the exact upcast
__device__ __forceinline__ void stage(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void stage(float* dst, const __nv_bfloat16* src) {
  *dst = __bfloat162float(*src);
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

struct Plan {
  int batch, seq, chan, cblocks, nseg;
};

// flags [batch * cblocks, nseg] and the ticket are zeroed by each call;
// sum_a, sum_b, state are [batch, nseg, chan] fp32
struct Scratch {
  int* flags;
  int* ticket;
  float* sum_a;
  float* sum_b;
  float* state;
};

// Warp 0: the nearest segment before ``seg`` whose state is published (-1:
// h0), once every segment between has published at least its summary.
__device__ int look_back(const int* flags, int seg, int lane) {
  unsigned spins = 0;
  for (int hi = seg - 1;; hi -= 32) {
    const int j = hi - lane;
    int f = j >= 0 ? ld_acquire(flags + j) : STATE;
    while (__any_sync(FULL, f == NONE)) {
      if (++spins > SPIN_CAP) __trap();
      __nanosleep(32);
      if (f == NONE) f = ld_acquire(flags + j);
    }
    const unsigned st = __ballot_sync(FULL, f == STATE);
    if (st) return hi - (__ffs(st) - 1);
  }
}

// One block: NT channels of one batch row over one segment.  ``Io`` stages
// scan step k's a, b (and, for its epilogue, Io::TILES - 2 more values)
// into this thread's column of the shared tiles, and emits each replayed
// state.  A thread reads back only its own column.
template <class Io>
__device__ __forceinline__ void scan_segment(const Io& io, const Plan& p, const Scratch& s,
                                             const float* __restrict__ h0) {
  extern __shared__ float tiles[];  // [Io::TILES][SEG][NT]
  __shared__ int s_ticket, s_from;
  if (threadIdx.x == 0) s_ticket = atomicAdd(s.ticket, 1);
  __syncthreads();
  const int ticket = s_ticket, rows = p.batch * p.cblocks;
  const int seg = ticket / rows, bi = ticket % rows / p.cblocks, cb = ticket % p.cblocks;
  const int c = cb * NT + threadIdx.x;
  const bool live = c < p.chan;
  const int k0 = seg * SEG, n = min(SEG, p.seq - k0);
  float* col = tiles + threadIdx.x;  // step i of tile j at col[j * TILE + i * NT]

#pragma unroll
  for (int i = 0; i < SEG; ++i)
    if (live && i < n) io.stage(bi, k0 + i, c, col + i * NT);
  asm volatile("cp.async.wait_all;\n" ::: "memory");

  float A = 1.f, B = 0.f;
#pragma unroll
  for (int i = 0; i < SEG; ++i)
    if (live && i < n) {
      const float av = col[i * NT];
      B = fmaf(av, B, col[TILE + i * NT]);
      A *= av;
    }

  const size_t o = ((size_t)bi * p.nseg + seg) * p.chan + c;
  int* flags = s.flags + (size_t)(bi * p.cblocks + cb) * p.nseg;
  const bool successor = seg + 1 < p.nseg;
  float enter = h0 != nullptr && live ? h0[(size_t)bi * p.chan + c] : 0.f;
  if (seg > 0) {
    if (successor) {  // publish the summary before waiting on anything
      if (live) {
        __stcg(s.sum_a + o, A);
        __stcg(s.sum_b + o, B);
      }
      __syncthreads();  // with the release below, orders every thread's stores first
      if (threadIdx.x == 0) st_release(flags + seg, SUMMARY);
    }
    if (threadIdx.x < 32) {
      const int from = look_back(flags, seg, threadIdx.x);
      if (threadIdx.x == 0) s_from = from;
    }
    __syncthreads();  // with warp 0's acquire, orders the reads below after it
    const int from = s_from;
    if (live) {
      const size_t col = (size_t)bi * p.nseg * p.chan + c;
      if (from >= 0) enter = __ldcg(s.state + col + (size_t)from * p.chan);
      for (int j0 = from + 1; j0 < seg; j0 += FOLD) {  // FOLD summaries' loads at once
        float fa[FOLD], fb[FOLD];
#pragma unroll
        for (int u = 0; u < FOLD; ++u)
          if (j0 + u < seg) {
            const size_t q = col + (size_t)(j0 + u) * p.chan;
            fa[u] = __ldcg(s.sum_a + q);
            fb[u] = __ldcg(s.sum_b + q);
          }
#pragma unroll
        for (int u = 0; u < FOLD; ++u)
          if (j0 + u < seg) enter = fmaf(fa[u], enter, fb[u]);
      }
    }
  }
  if (successor) {  // publish the state the next segment enters with
    if (live) __stcg(s.state + o, fmaf(A, enter, B));
    __syncthreads();
    if (threadIdx.x == 0) st_release(flags + seg, STATE);
  }

  float h = enter;
#pragma unroll
  for (int i = 0; i < SEG; ++i)
    if (live && i < n) {
      h = fmaf(col[i * NT], h, col[TILE + i * NT]);
      io.emit(bi, k0 + i, c, h, col + i * NT);
    }
}

// scan step k of the forward: time k, or seq - 1 - k in reverse
template <typename TA, typename TB>
struct Forward {
  const TA* __restrict__ a;
  const TB* __restrict__ b;
  float* __restrict__ out;
  int seq, chan, reverse;

  __device__ __forceinline__ size_t at(int bi, int k, int c) const {
    const int t = reverse ? seq - 1 - k : k;
    return ((size_t)bi * seq + t) * chan + c;
  }
  static constexpr int TILES = 2;  // a, b

  __device__ __forceinline__ void stage(int bi, int k, int c, float* col) const {
    const size_t i = at(bi, k, c);
    ::stage(col, a + i);
    ::stage(col + TILE, b + i);
  }
  __device__ __forceinline__ void emit(int bi, int k, int c, float h, const float*) const {
    out[at(bi, k, c)] = h;
  }
};

// scan step k of the backward is time t = seq - 1 - k: its a is a[t + 1]
// (1 past the last step), its input dout[t], and its third tile holds the
// epilogue's h_prev = h[t - 1] (h0 or 0 at t = 0)
template <typename TA, typename TB>
struct Backward {
  const TA* __restrict__ a;
  const float* __restrict__ h;
  const float* __restrict__ h0;
  const float* __restrict__ dout;
  TA* __restrict__ da;
  TB* __restrict__ db;
  float* __restrict__ dh0;
  int seq, chan;

  static constexpr int TILES = 3;  // a shifted, dout, h_prev

  __device__ __forceinline__ void stage(int bi, int k, int c, float* col) const {
    const int t = seq - 1 - k;
    const size_t i = ((size_t)bi * seq + t) * chan + c;
    if (t + 1 < seq)
      ::stage(col, a + i + chan);
    else
      *col = 1.f;
    ::stage(col + TILE, dout + i);
    if (t > 0)
      ::stage(col + 2 * TILE, h + i - chan);
    else
      col[2 * TILE] = h0 != nullptr ? h0[(size_t)bi * chan + c] : 0.f;
  }
  __device__ __forceinline__ void emit(int bi, int k, int c, float g, const float* col) const {
    const int t = seq - 1 - k;
    const size_t i = ((size_t)bi * seq + t) * chan + c;
    put(db + i, g);
    put(da + i, __fmul_rn(g, col[2 * TILE]));
    if (t == 0 && dh0 != nullptr) dh0[(size_t)bi * chan + c] = __fmul_rn(to_f32(a[i]), g);
  }
};

template <typename TA, typename TB>
__global__ void __launch_bounds__(NT)
linear_scan_kernel(Forward<TA, TB> io, Plan p, Scratch s, const float* __restrict__ h0) {
  scan_segment(io, p, s, h0);
}

template <typename TA, typename TB>
__global__ void __launch_bounds__(NT)
linear_scan_bwd_kernel(Backward<TA, TB> io, Plan p, Scratch s) {
  scan_segment(io, p, s, nullptr);  // the adjoint starts from zero
}

// The scratch of a [batch, seq, chan] call, in 32-bit words: the flags
// [batch * cblocks, nseg] and the ticket (rounded up to 4 words, so the fp32
// arrays start 16-byte aligned), then sum_a, sum_b, state [batch, nseg,
// chan] fp32.  The only place that knows this layout.
struct Layout {
  long long blocks, flag_words, cols;
  long long words() const { return flag_words + 3 * cols; }
};

Layout layout(int batch, int seq, int chan) {
  const long long nseg = (seq + SEG - 1) / SEG;
  const long long blocks = (long long)batch * ((chan + NT - 1) / NT) * nseg;
  return Layout{blocks, (blocks + 1 + 3) / 4 * 4, (long long)batch * nseg * chan};
}

// Checks the plan against the shapes and carves the scratch; 0 or an error.
cudaError_t prepare(int batch, int seq, int chan, int seg_len, int nseg, void* scratch,
                    long long scratch_words, Plan& p, Scratch& s, long long& blocks,
                    cudaStream_t stream) {
  if (batch <= 0 || seq <= 0 || chan <= 0 || seg_len != SEG || nseg != (seq + SEG - 1) / SEG ||
      scratch == nullptr)
    return cudaErrorInvalidValue;
  const Layout l = layout(batch, seq, chan);
  if (l.blocks > 0x7fffffffLL || scratch_words < l.words()) return cudaErrorInvalidValue;
  p = Plan{batch, seq, chan, (chan + NT - 1) / NT, nseg};
  blocks = l.blocks;
  int* words = static_cast<int*>(scratch);
  float* f = reinterpret_cast<float*>(words + l.flag_words);
  s = Scratch{words, words + blocks, f, f + l.cols, f + 2 * l.cols};
  return cudaMemsetAsync(words, 0, (size_t)l.flag_words * sizeof(int), stream);
}

// Lets ``kern`` take ``smem`` bytes of dynamic shared memory (the
// backward's 48 KB of tiles and its two static words pass the 48 KB a block
// gets without asking) and prefer shared memory over L1 (six forward or four
// backward blocks fit an SM only with the largest carveout), once per device.
template <typename Kern>
cudaError_t configure_once(Kern kern, int smem, bool* configured) {
  constexpr int kMaxDevices = 64;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kMaxDevices && configured[dev])) return err;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && dev < kMaxDevices) configured[dev] = true;
  return err;
}

template <typename TA, typename TB>
cudaError_t launch_fwd(const void* a, const void* b, const float* h0, float* out, int reverse,
                       const Plan& p, const Scratch& s, long long blocks, cudaStream_t stream) {
  const Forward<TA, TB> io{static_cast<const TA*>(a), static_cast<const TB*>(b), out, p.seq,
                           p.chan, reverse ? 1 : 0};
  constexpr int smem = Forward<TA, TB>::TILES * TILE * sizeof(float);
  static bool configured[64];
  const cudaError_t err = configure_once(linear_scan_kernel<TA, TB>, smem, configured);
  if (err != cudaSuccess) return err;
  linear_scan_kernel<TA, TB><<<(unsigned)blocks, NT, smem, stream>>>(io, p, s, h0);
  return cudaGetLastError();
}

template <typename TA, typename TB>
cudaError_t launch_bwd(const void* a, const float* h, const float* h0, const float* dout,
                       void* da, void* db, float* dh0, const Plan& p, const Scratch& s,
                       long long blocks, cudaStream_t stream) {
  const Backward<TA, TB> io{static_cast<const TA*>(a), h, h0, dout, static_cast<TA*>(da),
                            static_cast<TB*>(db), dh0, p.seq, p.chan};
  constexpr int smem = Backward<TA, TB>::TILES * TILE * sizeof(float);
  static bool configured[64];
  const cudaError_t err = configure_once(linear_scan_bwd_kernel<TA, TB>, smem, configured);
  if (err != cudaSuccess) return err;
  linear_scan_bwd_kernel<TA, TB><<<(unsigned)blocks, NT, smem, stream>>>(io, p, s);
  return cudaGetLastError();
}

}  // namespace

// 32-bit words of scratch that a [batch, seq, chan] call of either kernel
// takes; -1 for shapes it does not take.
extern "C" long long linear_scan_scratch_words(int batch, int seq, int chan) {
  if (batch <= 0 || seq <= 0 || chan <= 0) return -1;
  return layout(batch, seq, chan).words();
}

// a_dtype, b_dtype: 0 = float32, 1 = bfloat16.  h0 [batch, chan] fp32 or
// null (zeros); out [batch, seq, chan] fp32.  seg_len must be SEG and nseg
// ceil(seq / SEG) (kernel.py's plan); scratch holds scratch_words 32-bit
// words, at least linear_scan_scratch_words(batch, seq, chan).  reverse = 1
// runs the recurrence from the last step to the first (h_t = a_t h_{t+1} +
// b_t, h_seq = h0).  Returns the first failing call's cudaError_t (0 = all
// launched).
extern "C" int linear_scan_launch(int a_dtype, int b_dtype, const void* a, const void* b,
                                  const float* h0, float* out, void* scratch,
                                  long long scratch_words, int batch, int seq, int chan,
                                  int seg_len, int nseg, int reverse, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Plan p;
  Scratch s;
  long long blocks;
  cudaError_t err = prepare(batch, seq, chan, seg_len, nseg, scratch, scratch_words, p, s,
                            blocks, st);
  if (err != cudaSuccess) return err;
  if (a_dtype == 0 && b_dtype == 0)
    return launch_fwd<float, float>(a, b, h0, out, reverse, p, s, blocks, st);
  if (a_dtype == 0 && b_dtype == 1)
    return launch_fwd<float, __nv_bfloat16>(a, b, h0, out, reverse, p, s, blocks, st);
  if (a_dtype == 1 && b_dtype == 0)
    return launch_fwd<__nv_bfloat16, float>(a, b, h0, out, reverse, p, s, blocks, st);
  if (a_dtype == 1 && b_dtype == 1)
    return launch_fwd<__nv_bfloat16, __nv_bfloat16>(a, b, h0, out, reverse, p, s, blocks, st);
  return cudaErrorInvalidValue;
}

// The fused backward of the forward scan (not reverse) that gave h.  a
// [batch, seq, chan] in a_dtype; h, dout [batch, seq, chan] fp32; h0
// [batch, chan] fp32 or null.  Writes da (a_dtype), db (b_dtype) [batch,
// seq, chan] and, where dh0 is not null, dh0 [batch, chan] fp32.  Plan and
// scratch as for linear_scan_launch.
extern "C" int linear_scan_bwd_launch(int a_dtype, int b_dtype, const void* a, const float* h,
                                      const float* h0, const float* dout, void* da, void* db,
                                      float* dh0, void* scratch, long long scratch_words,
                                      int batch, int seq, int chan, int seg_len, int nseg,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Plan p;
  Scratch s;
  long long blocks;
  cudaError_t err = prepare(batch, seq, chan, seg_len, nseg, scratch, scratch_words, p, s,
                            blocks, st);
  if (err != cudaSuccess) return err;
  if (a_dtype == 0 && b_dtype == 0)
    return launch_bwd<float, float>(a, h, h0, dout, da, db, dh0, p, s, blocks, st);
  if (a_dtype == 0 && b_dtype == 1)
    return launch_bwd<float, __nv_bfloat16>(a, h, h0, dout, da, db, dh0, p, s, blocks, st);
  if (a_dtype == 1 && b_dtype == 0)
    return launch_bwd<__nv_bfloat16, float>(a, h, h0, dout, da, db, dh0, p, s, blocks, st);
  if (a_dtype == 1 && b_dtype == 1)
    return launch_bwd<__nv_bfloat16, __nv_bfloat16>(a, h, h0, dout, da, db, dh0, p, s, blocks,
                                                    st);
  return cudaErrorInvalidValue;
}

extern "C" const char* linear_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
