// Locked-grid soft stage, fused: window-row correlation + A(s)+phi*B(s+1)
// combine + |f2|^2 - |f1|^2, for sm_90a.
//
// Replaces: opv_tpu/ops/pallas/correlate.py, symbol_corr_pallas ->
// _corr_kernel (ab[c,s,o] = sum_t sym[c,s,t] * kern[c,t,o], t < 80, o < 8),
// and goes further: it also fuses _symbol_soft_batch's epilogue
// (opv_tpu/rx/locked.py:247-265), so the (C, M, 8) correlation never reaches
// device memory and the kernel emits the (C, nsym) soft stream directly.
//
// Inputs: (C, M) window rows of 80 values (40 interleaved I/Q samples; rows
// of a channel contiguous, any channel stride), float32 or int8; per-channel
// (C, 80, 8) kernel columns (float32, or int8 round(k*127) for int8 rows);
// (C,) float32 rescale (1 for float32 rows, INT8_SCALE/127 or scale/127 for
// int8); (C, 2, 2) float32 phi = e^{-j inc_k 40} as [tone][re, im].
// Column order of the correlation: [ReA0 ReA1 ReB0 ReB1 ImA0 ImA1 ImB0 ImB1]
// (A = window tail at t >= r, B = head at t < r; tone 0 = F1, 1 = F2).
//
// What bounds it on the card: bytes.  Each window row is read once
// (320 B float32, 80 B int8) for 8 dot products of 80 taps: 2 flop/B in
// float32, far under the H100's ~20 flop/B float32 balance point.  At 64
// channels x 44,228 rows a call moves 917 MB (float32 rows) or 238 MB (int8
// rows), soft output included: 0.274 / 0.071 ms at 3.35 TB/s.  Reaching
// that rate takes ~25 KB of loads in flight per SM (Little's law at ~0.8 us
// of HBM latency); a block that loads a tile, waits and then computes keeps
// far less in flight.
//
// Design: persistent blocks (SMs x blocks per SM, from the occupancy API)
// each walk a contiguous range of the flattened (channel, tile) space in
// order.  A tile is T = threads x rows-per-thread symbols; its rows are one
// contiguous span of memory, copied by 16-byte cp.async into a ring of
// kStages tile buffers in dynamic shared memory, so tile i+1 (and later)
// is in flight while tile i is computed.  Rows sit at a padded stride (84
// floats: a quarter warp's float4 reads hit banks 20*tid mod 32, all
// distinct; int8 rows at 20 words are already conflict-free), and every
// thread reads the same tap at once, so the column reads are broadcasts.
// A channel's columns are loaded once when the block enters the channel.
// The B half of row s+1 reaches symbol s's thread through shared memory;
// the last symbol of a tile takes it from the next tile's first row, which
// the ring already holds: that row is read once.  Only a block's last tile
// (and a channel's last tile) loads its closing row itself.  A channel
// whose base is not 16-byte aligned (odd-N complex input, a slice of a
// longer buffer) is copied in 8- or 4-byte pieces instead.  int8 rows use
// __dp4a (exact s8 x s8 -> s32 accumulate, as the TPU's int8 matmul) and
// rescale in float32 before the combine.  A `raw` mode writes the (C,
// nsym+1, 8) correlation instead of the soft stream (float32, or the exact
// int32 dot for int8 rows) so tests can hold the dot itself against a plain
// contraction.
//
// float64 rows (F64Rows, the JAX package's complex128 path,
// opv_tpu/rx/locked.py:212-265): the same design with float64 through
// the rows, columns, accumulators, rescale, phi, the combine and the soft
// stream.  A row is 640 B, so a tile is 128 rows of one thread each at a
// padded stride of 82 doubles (656 B: a quarter warp's 16-byte reads hit
// banks 4 t mod 32, all distinct), 2 stages (178.5 KB with the columns
// and B halves, one block per SM).  At 64 channels x 44,228 rows a call
// moves 1.83 GB: 0.55 ms at 3.35 TB/s; its 2 x 80 x 8 float64 operations
// a row (0.9 GFLOP) take 0.027 ms at the card's 34 TFLOP/s, so bytes
// bound it, as for float32 (it runs at ~87% of that bound; PERF.md §6).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRow = 80;         // values per window row
constexpr int kCols = 8;         // correlation columns
constexpr int kRowW = kRow / 4;  // int8 row in 32-bit words
constexpr int kMaxDevices = 64;

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
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename V>
__device__ __forceinline__ auto lane(const V& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// Four reals of a correlation half: float4, or for float64 rows four
// doubles (16-byte aligned, as float4's slots in shared memory).
struct __align__(16) dquad {
  double x, y, z, w;
};

// a = {ReA0, ReA1, ImA0, ImA1} of row s, b = {ReB0, ReB1, ImB0, ImB1} of
// row s+1, ph = {re0, im0, re1, im1}; in the rows' real type F.
template <typename F, typename Q>
__device__ __forceinline__ F combine(Q a4, Q b4, const F* ph) {
  const F a[4] = {a4.x, a4.y, a4.z, a4.w}, b[4] = {b4.x, b4.y, b4.z, b4.w};
  F p[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const F pre = ph[2 * k], pim = ph[2 * k + 1];
    const F cre = a[k] + pre * b[k] - pim * b[2 + k];
    const F cim = a[2 + k] + pre * b[2 + k] + pim * b[k];
    p[k] = cre * cre + cim * cim;
  }
  return p[1] - p[0];
}

// Split a row's correlation into its A half (kept by the row's thread) and
// its B half (handed to the previous symbol), rescaled to the real type F.
template <typename F, typename Acc, typename Q>
__device__ __forceinline__ void split(const Acc* acc, F scale, Q& a, Q& b) {
  a.x = (F)acc[0] * scale; a.y = (F)acc[1] * scale;
  a.z = (F)acc[4] * scale; a.w = (F)acc[5] * scale;
  b.x = (F)acc[2] * scale; b.y = (F)acc[3] * scale;
  b.z = (F)acc[6] * scale; b.w = (F)acc[7] * scale;
}

template <int NT, int RPT, int S>
struct Config {
  static constexpr int kThreads = NT;        // threads per block
  static constexpr int kRowsPerThread = RPT;
  static constexpr int kTile = NT * RPT;     // symbols per tile
  static constexpr int kStages = S;          // tile buffers in the ring
};

// Row-type traits: how a row sits in device and shared memory, how the
// kernel columns are laid out in shared memory (Cols), and the 8-column dot
// of N rows at once (one column read serves all N) with its accumulator.
//
// The Config<threads, rows per thread, stages> of each row type was chosen
// by a timing sweep on the card (scripts/soft_sweep.py times copies of this
// file with other values).  float32: 128 x 2 rows, 2 stages of 257 rows
// (179 KB, one block per SM, 96 registers, no spills); int8: 256 x 2 rows,
// 3 stages of 513 rows (132 KB, one block per SM, 80 registers).  The
// other settings timed were up to 28% (float32) or 13% (int8) slower.
struct F32Rows : Config<128, 2, 2> {
  using Elem = float;
  using Acc = float;
  using Real = float;   // rescale, phi, combine and the soft stream
  using Quad = float4;
  static constexpr int kRowBytes = kRow * 4;
  static constexpr int kSmemRowBytes = (kRow + 4) * 4;  // 84 floats
  struct Cols { float4 k[kRow * 2]; };  // tap t: k[2t] = cols 0-3, k[2t+1] = 4-7

  static __device__ __forceinline__ void load_cols(Cols& ks, const float* kc, int tid) {
    for (int i = tid; i < kRow * kCols; i += kThreads) reinterpret_cast<float*>(ks.k)[i] = kc[i];
  }
  template <int N>
  static __device__ __forceinline__ void dot(const unsigned char* x, int step, const Cols& ks,
                                             float (&acc)[N][kCols]) {
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int o = 0; o < kCols; ++o) acc[i][o] = 0.f;
#pragma unroll 2
    for (int q = 0; q < kRow / 4; ++q) {
      float4 v[N];
#pragma unroll
      for (int i = 0; i < N; ++i) v[i] = reinterpret_cast<const float4*>(x + i * step)[q];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 k0 = ks.k[8 * q + 2 * j], k1 = ks.k[8 * q + 2 * j + 1];
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const float u = lane(v[i], j);
          acc[i][0] = fmaf(u, k0.x, acc[i][0]); acc[i][1] = fmaf(u, k0.y, acc[i][1]);
          acc[i][2] = fmaf(u, k0.z, acc[i][2]); acc[i][3] = fmaf(u, k0.w, acc[i][3]);
          acc[i][4] = fmaf(u, k1.x, acc[i][4]); acc[i][5] = fmaf(u, k1.y, acc[i][5]);
          acc[i][6] = fmaf(u, k1.z, acc[i][6]); acc[i][7] = fmaf(u, k1.w, acc[i][7]);
        }
      }
    }
  }
};

struct I8Rows : Config<256, 2, 3> {
  using Elem = int8_t;
  using Acc = int;
  using Real = float;
  using Quad = float4;
  static constexpr int kRowBytes = kRow;
  static constexpr int kSmemRowBytes = kRow;  // 20 words: conflict-free int4 reads
  struct Cols { int4 k[kRowW][2]; };  // word w: k[w][0] = cols 0-3, k[w][1] = 4-7

  // pack column o's taps 4w..4w+3 into one word, tap 4w in the low byte,
  // matching the little-endian byte order of a row word
  static __device__ __forceinline__ void load_cols(Cols& ks, const int8_t* kc, int tid) {
    for (int i = tid; i < kCols * kRowW; i += kThreads) {
      const int o = i / kRowW, w = i - o * kRowW;
      uint32_t v = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) v |= (uint32_t)(uint8_t)kc[(4 * w + j) * kCols + o] << (8 * j);
      reinterpret_cast<int*>(ks.k)[w * kCols + o] = (int)v;
    }
  }
  template <int N>
  static __device__ __forceinline__ void dot(const unsigned char* x, int step, const Cols& ks,
                                             int (&acc)[N][kCols]) {
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int o = 0; o < kCols; ++o) acc[i][o] = 0;
#pragma unroll
    for (int q = 0; q < kRowW / 4; ++q) {
      int4 v[N];
#pragma unroll
      for (int i = 0; i < N; ++i) v[i] = reinterpret_cast<const int4*>(x + i * step)[q];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int4 k0 = ks.k[4 * q + j][0], k1 = ks.k[4 * q + j][1];
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const int u = lane(v[i], j);
          acc[i][0] = __dp4a(u, k0.x, acc[i][0]); acc[i][1] = __dp4a(u, k0.y, acc[i][1]);
          acc[i][2] = __dp4a(u, k0.z, acc[i][2]); acc[i][3] = __dp4a(u, k0.w, acc[i][3]);
          acc[i][4] = __dp4a(u, k1.x, acc[i][4]); acc[i][5] = __dp4a(u, k1.y, acc[i][5]);
          acc[i][6] = __dp4a(u, k1.z, acc[i][6]); acc[i][7] = __dp4a(u, k1.w, acc[i][7]);
        }
      }
    }
  }
};

// float64 rows: 128 x 1 rows, 2 stages of 129 rows (see the header).
struct F64Rows : Config<128, 1, 2> {
  using Elem = double;
  using Acc = double;
  using Real = double;
  using Quad = dquad;
  static constexpr int kRowBytes = kRow * 8;
  static constexpr int kSmemRowBytes = (kRow + 2) * 8;  // 82 doubles
  // tap t: k[4t .. 4t+3] = cols (0,1), (2,3), (4,5), (6,7)
  struct Cols { double2 k[kRow * 4]; };

  static __device__ __forceinline__ void load_cols(Cols& ks, const double* kc, int tid) {
    for (int i = tid; i < kRow * kCols; i += kThreads) reinterpret_cast<double*>(ks.k)[i] = kc[i];
  }
  template <int N>
  static __device__ __forceinline__ void dot(const unsigned char* x, int step, const Cols& ks,
                                             double (&acc)[N][kCols]) {
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int o = 0; o < kCols; ++o) acc[i][o] = 0.0;
#pragma unroll 2
    for (int q = 0; q < kRow / 2; ++q) {
      double2 v[N];
#pragma unroll
      for (int i = 0; i < N; ++i) v[i] = reinterpret_cast<const double2*>(x + i * step)[q];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const double2* kt = ks.k + 4 * (2 * q + j);
        const double2 k0 = kt[0], k1 = kt[1], k2 = kt[2], k3 = kt[3];
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const double u = j == 0 ? v[i].x : v[i].y;
          acc[i][0] = fma(u, k0.x, acc[i][0]); acc[i][1] = fma(u, k0.y, acc[i][1]);
          acc[i][2] = fma(u, k1.x, acc[i][2]); acc[i][3] = fma(u, k1.y, acc[i][3]);
          acc[i][4] = fma(u, k2.x, acc[i][4]); acc[i][5] = fma(u, k2.y, acc[i][5]);
          acc[i][6] = fma(u, k3.x, acc[i][6]); acc[i][7] = fma(u, k3.y, acc[i][7]);
        }
      }
    }
  }
};

// Dynamic shared memory: the columns, the B halves of a tile (T+1 rows),
// the carried A half, then the ring of kStages tiles of T+1 rows.  Every
// part is a multiple of 16 bytes.
template <typename R>
struct Layout {
  static constexpr int kStageBytes = (R::kTile + 1) * R::kSmemRowBytes;
  static constexpr int kRing =
      (int)sizeof(typename R::Cols) + (R::kTile + 2) * (int)sizeof(typename R::Quad);
  static constexpr int kBytes = kRing + R::kStages * kStageBytes;
};

// One item of the flattened (channel, tile) space: tile j of channel c
// outputs symbols s0 .. s0+nt-1 from rows s0 .. s0+nrows-1.  A tile loads
// its closing row s0+nt only when no later tile of this block will: at the
// end of the channel (the row is row nsym) or of the block's range.
struct Tile {
  int c, j, s0, nt, nrows;
  bool last_ch;
};

__device__ __forceinline__ Tile tile_of(long long k, long long end, int ntiles, int nsym, int T) {
  Tile t;
  t.c = (int)(k / ntiles);
  t.j = (int)(k - (long long)t.c * ntiles);
  t.s0 = t.j * T;
  t.nt = min(T, nsym - t.s0);
  t.last_ch = t.j == ntiles - 1;
  t.nrows = t.nt + ((t.last_ch || k == end - 1) ? 1 : 0);
  return t;
}

template <typename R, int W>
__device__ __forceinline__ void copy_rows(unsigned char* dst, const unsigned char* src, int nrows,
                                          int tid) {
  constexpr int kPer = R::kRowBytes / W;
  const int total = nrows * kPer;
#pragma unroll 4
  for (int i = tid; i < total; i += R::kThreads) {
    const int r = i / kPer;
    cp_async<W>(dst + r * R::kSmemRowBytes + (i - r * kPer) * W, src + (size_t)i * W);
  }
}

// Start the asynchronous copy of a tile's rows into one ring stage, in the
// widest pieces the channel base's alignment allows (rows are multiples of
// 16 bytes, so the base decides for the whole channel).
template <typename R>
__device__ __forceinline__ void issue(unsigned char* dst, const typename R::Elem* rows,
                                      long long cstride, const Tile& t, int tid) {
  const typename R::Elem* ch = rows + (long long)t.c * cstride;
  const auto* src = reinterpret_cast<const unsigned char*>(ch + (long long)t.s0 * kRow);
  const unsigned mis = (unsigned)reinterpret_cast<uintptr_t>(ch) & 15u;
  if (mis == 0)
    copy_rows<R, 16>(dst, src, t.nrows, tid);
  else if ((mis & 7u) == 0)
    copy_rows<R, 8>(dst, src, t.nrows, tid);
  else
    copy_rows<R, 4>(dst, src, t.nrows, tid);
}

template <typename Acc>
__device__ __forceinline__ void store_raw(Acc* out, const Acc* acc, int c, int nsym, int s) {
  Acc* dst = out + ((size_t)c * (nsym + 1) + s) * kCols;
#pragma unroll
  for (int o = 0; o < kCols; ++o) dst[o] = acc[o];
}

template <typename R>
__global__ void __launch_bounds__(R::kThreads)
symbol_soft(const typename R::Elem* __restrict__ rows, long long cstride,
            const typename R::Elem* __restrict__ kern, const typename R::Real* __restrict__ resc,
            const typename R::Real* __restrict__ phi, void* __restrict__ out, int nsym,
            int ntiles, long long items, int raw) {
  using Acc = typename R::Acc;
  using F = typename R::Real;
  using Q = typename R::Quad;
  using L = Layout<R>;
  constexpr int NT = R::kThreads, RPT = R::kRowsPerThread, T = R::kTile, S = R::kStages;
  constexpr int kRowB = R::kSmemRowBytes;
  extern __shared__ __align__(16) unsigned char smem[];
  auto& ks = *reinterpret_cast<typename R::Cols*>(smem);
  Q* const bsh = reinterpret_cast<Q*>(smem + sizeof(typename R::Cols));
  Q* const carry = bsh + T + 1;  // A half of the last symbol of the previous tile
  unsigned char* const ring = smem + L::kRing;
  const int tid = threadIdx.x;
  const long long start = items * blockIdx.x / gridDim.x;
  const long long end = items * (blockIdx.x + 1) / gridDim.x;
  Acc* const raw_out = static_cast<Acc*>(out);
  F* const soft_out = static_cast<F*>(out);

#pragma unroll
  for (int p = 0; p < S - 1; ++p) {
    if (start + p < end)
      issue<R>(ring + p * L::kStageBytes, rows, cstride, tile_of(start + p, end, ntiles, nsym, T),
               tid);
    cp_async_commit();
  }
  int cur_c = -1;
  F scale = 0, ph[4];
  for (long long k = start; k < end; ++k) {
    const int it = (int)(k - start);
    if (k + S - 1 < end)  // refill the stage computed in the previous iteration
      issue<R>(ring + ((it + S - 1) % S) * L::kStageBytes, rows, cstride,
               tile_of(k + S - 1, end, ntiles, nsym, T), tid);
    cp_async_commit();
    const Tile t = tile_of(k, end, ntiles, nsym, T);
    if (t.c != cur_c) {  // entering a channel: its columns, rescale and phi
      cur_c = t.c;
      R::load_cols(ks, kern + (size_t)cur_c * kRow * kCols, tid);
      scale = resc[cur_c];
#pragma unroll
      for (int i = 0; i < 4; ++i) ph[i] = phi[4 * cur_c + i];
    }
    cp_async_wait<S - 1>();  // this thread's copies of tile k have landed
    __syncthreads();         // ... and every thread's, and the columns
    const unsigned char* st = ring + (it % S) * L::kStageBytes;
    Acc acc[RPT][kCols];
    R::template dot<RPT>(st + tid * kRowB, NT * kRowB, ks, acc);
    Q a[RPT], b0{};
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = tid + i * NT;
      if (r < t.nrows) {
        if (raw && (r < t.nt || t.last_ch)) store_raw(raw_out, acc[i], t.c, nsym, t.s0 + r);
        Q b;
        split(acc[i], scale, a[i], b);
        bsh[r] = b;
        if (i == 0) b0 = b;
      }
    }
    if (tid == 0 && t.nrows == T + 1) {  // the closing row of a full tile
      Acc e[1][kCols];
      R::template dot<1>(st + T * kRowB, 0, ks, e);
      if (raw && t.last_ch) store_raw(raw_out, e[0], t.c, nsym, nsym);
      Q unused;
      split(e[0], scale, unused, bsh[T]);
    }
    // the previous tile's last symbol, waiting for this tile's first row
    if (!raw && tid == 0 && k > start && t.j > 0)
      soft_out[(size_t)t.c * nsym + t.s0 - 1] = combine(*carry, b0, ph);
    __syncthreads();
    if (!raw) {
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = tid + i * NT;
        if (r < t.nt) {
          if (r + 1 < t.nrows)
            soft_out[(size_t)t.c * nsym + t.s0 + r] = combine(a[i], bsh[r + 1], ph);
          else
            *carry = a[i];
        }
      }
    }
    __syncthreads();  // the stage, bsh and the columns may now be refilled
  }
}

// SMs x resident blocks per SM for kernel R on the current device, set up
// once per device (the dynamic shared-memory limit above 48 KB included).
template <typename R>
cudaError_t persistent_grid(int* grid) {
  static int cache[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && cache[dev] > 0) {
    *grid = cache[dev];
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(symbol_soft<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Layout<R>::kBytes);
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, symbol_soft<R>, R::kThreads,
                                                      Layout<R>::kBytes);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *grid = sms * per_sm;
  if (dev < kMaxDevices) cache[dev] = *grid;
  return cudaSuccess;
}

template <typename R>
int launch(const void* rows, long long cstride, const void* kern, const void* resc,
           const void* phi, void* out, int channels, int nsym, int raw, cudaStream_t st) {
  int grid = 0;
  const cudaError_t err = persistent_grid<R>(&grid);
  if (err != cudaSuccess) return (int)err;
  const int ntiles = (nsym + R::kTile - 1) / R::kTile;
  const long long items = (long long)channels * ntiles;
  if (items < grid) grid = (int)items;
  using E = typename R::Elem;
  using F = typename R::Real;
  symbol_soft<R><<<grid, R::kThreads, Layout<R>::kBytes, st>>>(
      static_cast<const E*>(rows), cstride, static_cast<const E*>(kern),
      static_cast<const F*>(resc), static_cast<const F*>(phi), out, nsym, ntiles, items, raw);
  return (int)cudaGetLastError();
}

template <typename R>
int config(int* cfg) {
  int grid = 0;
  const cudaError_t err = persistent_grid<R>(&grid);
  cfg[0] = R::kThreads;
  cfg[1] = R::kRowsPerThread;
  cfg[2] = R::kStages;
  cfg[3] = Layout<R>::kBytes;
  cfg[4] = grid;
  return (int)err;
}

}  // namespace

// rows: element pointer of row 0 of channel 0; cstride: channel stride in
// elements (int8 rows: a 4-byte-aligned base and a multiple of 4).
// row_type: 0 float32 rows (float32 kern, resc, phi and out), 1 int8 rows
// (int8 kern, float32 resc, phi and out), 2 float64 rows (float64 kern,
// resc, phi and out).  out: (C, nsym) soft values, or with raw != 0 the
// (C, nsym+1, 8) correlation (the accumulator type: float32, int32 or
// float64).  Returns the first CUDA error of the set-up or the launch
// (cudaGetLastError()).
extern "C" int opv_symbol_soft(const void* rows, long long cstride, int row_type,
                               const void* kern, const void* resc, const void* phi,
                               void* out, int channels, int nsym, int raw, void* stream) {
  if (channels <= 0 || nsym <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (row_type) {
    case 0: return launch<F32Rows>(rows, cstride, kern, resc, phi, out, channels, nsym, raw, st);
    case 1: return launch<I8Rows>(rows, cstride, kern, resc, phi, out, channels, nsym, raw, st);
    case 2: return launch<F64Rows>(rows, cstride, kern, resc, phi, out, channels, nsym, raw, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The launch configuration for a row type (as opv_symbol_soft's) on the
// current device: cfg[0..4] = threads per block, rows per thread, ring
// stages, dynamic shared-memory bytes per block, persistent grid (SMs x
// blocks per SM).
extern "C" int opv_symbol_soft_config(int row_type, int* cfg) {
  switch (row_type) {
    case 0: return config<F32Rows>(cfg);
    case 1: return config<I8Rows>(cfg);
    case 2: return config<F64Rows>(cfg);
    default: return (int)cudaErrorInvalidValue;
  }
}
