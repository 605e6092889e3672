// Polyphase analysis channelizer, fused, for sm_90a: one pass over the
// wideband window forms the float32 polyphase legs, the float64 DFT across
// legs on the FP64 tensor cores, and stores the (K, M) complex64 channels
// already transposed.
//
// Replaces: no Pallas kernel.  opv_tpu/rx/channelizer.py::channelize runs
// as XLA elementwise ops and one matmul; the port ran it as ~30 PyTorch
// passes (rx/channelizer.py: polyphase_legs' 12 shifted multiply-adds, the
// widening, the float64 GEMM, the narrowing and the transpose), which stay
// as the twin.  Same contract, with X[j, r] = x[jK + r] and g[p, r] the
// (taps, K) tap matrix:
//     u[m, r] = sum_p g[p, r] X[m + p, r]   in float32, p = 0 .. taps-1 in
//               order, each product and each sum rounded (the twin's order:
//               __fmul_rn and __fadd_rn, nothing contracts), so the legs
//               are the twin's bit for bit;
//     y[c, m] = sum_r W[c, r] u[m, r]       as the twin's real product of
//               the re/im-interleaved legs with dft_kernel(K) rounded to
//               float32: every product exact in float64, summed there,
//               rounded to complex64 once.  Only the order of the float64
//               sum differs from cuBLAS' or the host BLAS'.
// The kernel values come from the host as the (K, K) complex pairs
// (wr, wi) = dft_kernel(K)[2r, c] in float32; the im leg's row is (-wi, wr),
// an exact negation.  (A K-entry table indexed by c (K-1-r) mod K is not
// the same bits: the twin's angles are not reduced mod 2 pi, so e.g.
// sin(2 pi n) rounds to a tiny non-zero float32 that differs with n.)
//
// What bounds it on the card: the dense float64 product, 2 x M x (2K)^2
// operations: 22.7 GFLOP for one 8-frame quantum at K = 64, 0.34 ms at the
// FP64 tensor cores' 67 TFLOP/s; the window read once and the channels
// written once are 710 MB, 0.21 ms at 3.35 TB/s.  The twin moved ~3 GB
// for the same work.
//
// Design: persistent blocks (two a SM: 256 threads, <= 128 registers,
// ~108 KB of shared memory each) walk items of 64 output rows x 128 real
// DFT columns (64 channels).  An item runs in stages: a chunk of 128 real
// legs (64 branches) x a chunk of <= 12 taps.  A stage's slab, the stream
// rows [m0 + p0, m0 + p0 + 64 + P - 1) of its leg columns (contiguous in
// the stream at K <= 64, ~38 KB), and its taps arrive by cp.async, 16-byte
// pieces where the window's alignment allows.  Each thread then filters
// one leg column over 16 rows at a time, the rows' window of samples held in
// registers, into the legs tile U (float32, rows padded to 132 floats: the
// A-fragment reads are conflict-free); the next stage's copy is issued
// before the product, so it overlaps it.  At a chunk's last tap the 8 warps
// (2 x 4, 32 x 32 each) run mma.sync m16n8k4 f64 over U and the chunk's
// (wr, wi) block (float32 in shared memory, rows padded to 136 floats:
// conflict-free B reads; a thread's B element is wr, wi or -wi by its lane
// parity), widening each operand exactly, and keep the sums in registers
// across leg chunks.  At the item's last chunk each thread holds whole
// complex outputs (columns 2c, 2c+1 of a row) and stores them into the
// (K, M) channels: each warp store covers 4 channels x 8 rows, 64-byte
// runs.  The other block on the SM fills its slab and legs while this one
// multiplies.  Any K and taps run: K <= 64 is one leg and column chunk
// (the DFT block is loaded once a block), larger K loops chunks (the legs
// are re-formed for each column chunk), taps > 12 accumulate U over tap
// chunks in order.  Padded legs and kernel rows are zero; rows past M
// are computed from whatever the slab holds and never stored.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;              // 8 warps: 2 (rows) x 4 (columns)
constexpr int kRows = 64;                  // output rows a tile
constexpr int kCols = 128;                 // real DFT columns a chunk (64 channels)
constexpr int kLegs = 128;                 // real legs a chunk (64 branches)
constexpr int kMaxTaps = 12;               // taps a slab
constexpr int kJ = 16;                     // leg rows a thread filters at once
constexpr int kUStride = kLegs + 4;        // floats: gid * 132 + tig hits 32 banks
constexpr int kWStride = kCols + 8;        // floats: rows r, r+1 land 8 banks apart
constexpr int kMaxDevices = 64;

constexpr int kWFloats = (kLegs / 2) * kWStride;
constexpr int kUFloats = kRows * kUStride;
constexpr int kGFloats = kMaxTaps * (kLegs / 2);

constexpr int smem_bytes(int taps_in_slab) {
  return (kWFloats + kUFloats + kGFloats + (kRows + taps_in_slab - 1) * kLegs) * 4;
}

struct Params {
  const float* x;   // the window, re/im interleaved: stream row j at x + 2Kj
  const float* g;   // (taps, K) tap matrix
  const float2* w;  // (K, K) pairs (wr, wi) of dft_kernel(K)'s re-leg rows
  float2* out;      // (K, M) channels
  long long m;      // output rows
  int k, taps;
  int n_nc, n_kc, n_pc;  // column, leg and tap chunks
  int wide;              // the slab copies in 16-byte pieces
};

template <int W>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (W == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src), "n"(W)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// d += a b for a 16 x 4 A fragment (rows gid, gid + 8; column tig), a 4 x 8
// B fragment (row tig, column gid) and the 16 x 8 sums (rows gid, gid + 8;
// columns 2 tig, 2 tig + 1), all float64.
__device__ __forceinline__ void mma_f64(double (&d)[4], double a0, double a1, double b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(b));
}

// A stage: leg chunk kc and tap chunk pc of one item.
struct Stage {
  long long m0;       // first output row
  int nc, kc, pc;
  int l0, nl, nl4;    // first real leg, legs in the chunk, rounded up to 4
  int p0, np;         // first tap, taps in the chunk
};

__device__ __forceinline__ Stage stage_of(const Params& p, long long item, int sidx) {
  Stage s;
  s.m0 = (item / p.n_nc) * kRows;
  s.nc = (int)(item % p.n_nc);
  s.kc = sidx / p.n_pc;
  s.pc = sidx - s.kc * p.n_pc;
  s.l0 = s.kc * kLegs;
  s.nl = min(kLegs, 2 * p.k - s.l0);
  s.nl4 = (s.nl + 3) & ~3;
  s.p0 = s.pc * kMaxTaps;
  s.np = min(kMaxTaps, p.taps - s.p0);
  return s;
}

// cp.async the n-row x per-piece block at src (row stride ld floats) into
// dst (row stride kLegs floats) in W-byte pieces, one piece a thread in turn.
template <int W>
__device__ __forceinline__ void copy_rows(float* dst, const float* src, long long ld, int nrows,
                                          int per, int tid) {
  constexpr int kF = W / 4;  // floats a piece
  const int dr = kThreads / per, dq = kThreads - dr * per;
  int r = tid / per, q = tid - r * per;
  while (r < nrows) {
    cp_async<W>(dst + r * kLegs + kF * q, src + r * ld + kF * q);
    r += dr;
    q += dq;
    if (q >= per) {
      q -= per;
      ++r;
    }
  }
}

// Start the copies of a stage's slab (stream rows m0 + p0 .., its legs'
// columns) and taps.  Rows past the last one any output uses are left out.
__device__ __forceinline__ void issue(const Params& p, float* slab, float* gs, const Stage& s,
                                      int tid) {
  const long long ld = 2LL * p.k;
  const long long row0 = s.m0 + s.p0;
  const int nrows = (int)min((long long)(kRows + s.np - 1), p.m + p.taps - 1 - row0);
  const float* src = p.x + row0 * ld + s.l0;
  if (p.wide)
    copy_rows<16>(slab, src, ld, nrows, s.nl / 4, tid);
  else
    copy_rows<8>(slab, src, ld, nrows, s.nl / 2, tid);
  const int nb = s.nl / 2, total = s.np * nb;
  for (int i = tid; i < total; i += kThreads) {
    const int t = i / nb, rr = i - t * nb;
    cp_async<4>(gs + t * (kLegs / 2) + rr, p.g + (long long)(s.p0 + t) * p.k + s.l0 / 2 + rr);
  }
}

// The (wr, wi) block of leg chunk kc and column chunk nc, zero outside K x K.
__device__ __forceinline__ void load_w(const Params& p, float* w, int kc, int nc, int tid) {
  const int r0 = kc * (kLegs / 2), c0 = nc * (kCols / 2);
  for (int i = tid; i < (kLegs / 2) * (kCols / 2); i += kThreads) {
    const int rr = i / (kCols / 2), cc = i % (kCols / 2);
    const int r = r0 + rr, c = c0 + cc;
    float2 v = make_float2(0.f, 0.f);
    if (r < p.k && c < p.k) v = p.w[(long long)r * p.k + c];
    *reinterpret_cast<float2*>(w + rr * kWStride + 2 * cc) = v;
  }
}

// acc[i] += the taps' products with rows i .. i + np - 1 of a slab column
// (xs, row stride kLegs), tap by tap in the twin's order; w[] holds the
// samples of the kJ rows for the current tap.  NP > 0: np is NP, and the
// unrolled walk turns the window's shifts into register renames.
template <int NP>
__device__ __forceinline__ void filter(const float* xs, const float* gk, float (&acc)[kJ],
                                       int np) {
  float w[kJ];
#pragma unroll
  for (int i = 0; i < kJ; ++i) w[i] = xs[i * kLegs];
  auto step = [&](int t, bool last) {
    const float gt = gk[t * (kLegs / 2)];
#pragma unroll
    for (int i = 0; i < kJ; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(w[i], gt));
    if (!last) {
#pragma unroll
      for (int i = 0; i + 1 < kJ; ++i) w[i] = w[i + 1];
      w[kJ - 1] = xs[(kJ + t) * kLegs];
    }
  };
  if constexpr (NP > 0) {
#pragma unroll
    for (int t = 0; t < NP; ++t) step(t, t + 1 == NP);
  } else {
#pragma unroll 1
    for (int t = 0; t < np; ++t) step(t, t + 1 == np);
  }
}

// The stage's taps into U: a thread filters leg column kk over kJ rows;
// partial sums of earlier tap chunks come back from U.  Columns of the
// chunk past its legs (K odd) are zero.
__device__ __forceinline__ void legs(const float* slab, const float* gs, float* u, const Stage& s,
                                     int tid) {
  const int items = s.nl4 * (kRows / kJ);
  for (int e = tid; e < items; e += kThreads) {
    const int kk = e % s.nl4, j0 = (e / s.nl4) * kJ;
    float* ut = u + j0 * kUStride + kk;
    float acc[kJ];
#pragma unroll
    for (int i = 0; i < kJ; ++i) acc[i] = s.pc == 0 || kk >= s.nl ? 0.f : ut[i * kUStride];
    if (kk < s.nl) {
      const float* xs = slab + j0 * kLegs + kk;
      const float* gk = gs + (kk >> 1);
      if (s.np == kMaxTaps)
        filter<kMaxTaps>(xs, gk, acc, kMaxTaps);
      else
        filter<0>(xs, gk, acc, s.np);
    }
#pragma unroll
    for (int i = 0; i < kJ; ++i) ut[i * kUStride] = acc[i];
  }
}

// acc += U (the warp's 32 rows, nl4 legs) x the chunk's real kernel (the
// warp's 32 columns, of which ncv - 32 wn are valid).  The B element of
// lane (gid, tig) at leg row 2r + (tig & 1), column 2c + (gid & 1) is wr
// on the diagonal parities, wi for (re leg, im column), -wi for (im leg, re
// column): component (tig ^ gid) & 1, sign by the parities.
__device__ __forceinline__ void product(const float* u, const float* w, double (&acc)[2][4][4],
                                        int nl4, int ncv, int warp, int lane) {
  const int gid = lane >> 2, tig = lane & 3, wm = warp & 1, wn = warp >> 1;
  const int nj = min(4, (ncv - wn * 32 + 7) / 8);
  if (nj <= 0) return;
  const float* ua = u + (wm * 32 + gid) * kUStride + tig;
  const float* wb = w + (tig >> 1) * kWStride + wn * 32 + 2 * (gid >> 1) + ((tig ^ gid) & 1);
  const unsigned sign = ((tig & 1) && !(gid & 1)) ? 0x80000000u : 0u;
#pragma unroll 4
  for (int ks = 0; ks < nl4 / 4; ++ks) {
    double a[2][2], b[4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      a[i][0] = (double)ua[(16 * i) * kUStride + 4 * ks];
      a[i][1] = (double)ua[(16 * i + 8) * kUStride + 4 * ks];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = (double)__uint_as_float(__float_as_uint(wb[2 * ks * kWStride + 8 * j]) ^ sign);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < nj) {
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_f64(acc[i][j], a[i][0], a[i][1], b[j]);
      }
  }
}

// Round the item's sums to complex64 and store them into the (K, M)
// channels; lane (gid, tig) of column block j holds channel
// 64 nc + 16 wn + 4 j + tig at rows gid and gid + 8 of each 16-row block.
__device__ __forceinline__ void store(const Params& p, const double (&acc)[2][4][4],
                                      const Stage& s, int warp, int lane) {
  const int gid = lane >> 2, tig = lane & 3, wm = warp & 1, wn = warp >> 1;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = s.nc * (kCols / 2) + wn * 16 + 4 * j + tig;
    if (c >= p.k) continue;
    float2* o = p.out + (long long)c * p.m;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const long long row = s.m0 + wm * 32 + 16 * i + gid;
      if (row < p.m)
        o[row] = make_float2(__double2float_rn(acc[i][j][0]), __double2float_rn(acc[i][j][1]));
      if (row + 8 < p.m)
        o[row + 8] = make_float2(__double2float_rn(acc[i][j][2]), __double2float_rn(acc[i][j][3]));
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2) channelize_kernel(Params p, long long items) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* const w = reinterpret_cast<float*>(smem);
  float* const u = w + kWFloats;
  float* const gs = u + kUFloats;
  float* const slab = gs + kGFloats;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int per_item = p.n_kc * p.n_pc;
  const bool one_block = p.n_kc == 1 && p.n_nc == 1;  // the DFT block never changes
  long long item = blockIdx.x;
  int sidx = 0;
  if (item >= items) return;
  if (one_block) load_w(p, w, 0, 0, tid);
  Stage s = stage_of(p, item, 0);
  issue(p, slab, gs, s, tid);
  cp_async_commit();
  double acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.0;
  while (true) {
    cp_async_wait_all();  // this thread's copies of the stage have landed
    __syncthreads();      // ... and every thread's; the last product is done with U and W
    if (!one_block && s.pc == 0) load_w(p, w, s.kc, s.nc, tid);
    legs(slab, gs, u, s, tid);
    __syncthreads();      // U is whole; the slab and taps may be refilled
    long long next = item;
    int nsidx = sidx + 1;
    if (nsidx == per_item) {
      nsidx = 0;
      next += gridDim.x;
    }
    Stage ns{};
    if (next < items) {
      ns = stage_of(p, next, nsidx);
      issue(p, slab, gs, ns, tid);
    }
    cp_async_commit();
    if (s.pc == p.n_pc - 1) {
      product(u, w, acc, s.nl4, min(kCols, 2 * p.k - s.nc * kCols), warp, lane);
      if (s.kc == p.n_kc - 1) {
        store(p, acc, s, warp, lane);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.0;
      }
    }
    if (next >= items) break;
    item = next;
    sidx = nsidx;
    s = ns;
  }
}

// SMs x resident blocks per SM on the current device, set up once per
// device (the dynamic shared-memory limit above 48 KB included).
cudaError_t persistent_grid(int* grid) {
  static int cache[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && cache[dev] > 0) {
    *grid = cache[dev];
    return cudaSuccess;
  }
  const int bytes = smem_bytes(kMaxTaps);
  err = cudaFuncSetAttribute(channelize_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, channelize_kernel, kThreads, bytes);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *grid = sms * per_sm;
  if (dev < kMaxDevices) cache[dev] = *grid;
  return cudaSuccess;
}

}  // namespace

// x: the (N,) complex64 window, 8-byte aligned, N >= (m + taps - 1) k;
// g: (taps, k) float32; w: (k, k, 2) float32 (wr, wi) pairs; out: (k, m)
// complex64.  Returns the first CUDA error of the set-up or the launch.
extern "C" int opv_channelize(const void* x, int k, int taps, long long m, const void* g,
                              const void* w, void* out, void* stream) {
  if (m <= 0) return 0;
  if (k < 1 || taps < 1) return (int)cudaErrorInvalidValue;
  int grid = 0;
  const cudaError_t err = persistent_grid(&grid);
  if (err != cudaSuccess) return (int)err;
  Params p;
  p.x = static_cast<const float*>(x);
  p.g = static_cast<const float*>(g);
  p.w = static_cast<const float2*>(w);
  p.out = static_cast<float2*>(out);
  p.m = m;
  p.k = k;
  p.taps = taps;
  p.n_nc = (2 * k + kCols - 1) / kCols;
  p.n_kc = (2 * k + kLegs - 1) / kLegs;
  p.n_pc = (taps + kMaxTaps - 1) / kMaxTaps;
  p.wide = (reinterpret_cast<uintptr_t>(x) & 15u) == 0 && k % 2 == 0;
  const long long items = ((m + kRows - 1) / kRows) * p.n_nc;
  if (items < grid) grid = (int)items;
  const int bytes = smem_bytes(taps < kMaxTaps ? taps : kMaxTaps);
  channelize_kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(p, items);
  return (int)cudaGetLastError();
}
