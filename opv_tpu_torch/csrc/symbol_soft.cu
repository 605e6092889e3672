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
// channels x ~43.5k rows a block reads ~890 MB (float32) or ~222 MB (int8).
//
// Design: one block of 128 threads per (channel, tile of 128 symbols).  The
// tile's 129 rows (the next tile's first row supplies B(s+1) of the last
// symbol) are one contiguous span of memory, loaded once with coalesced
// loads into shared memory, padded to an odd row stride (81 floats / 21
// words) so one-row-per-thread reads are bank-conflict free.  Each thread
// computes its row's 8 dot products; the B halves go through shared memory
// to the neighbouring thread for the combine.  int8 rows use __dp4a (exact
// s8 x s8 -> s32 accumulate, as the TPU's int8 matmul) and rescale in float32
// before the combine.  A `raw` mode writes the (C, nsym+1, 8) correlation
// instead of the soft stream (float32, or the exact int32 dot for int8
// rows) so tests can hold the dot itself against a plain contraction.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;     // symbols per block = threads per block
constexpr int kRow = 80;       // values per window row
constexpr int kCols = 8;       // correlation columns
constexpr int kRowW = kRow / 4;  // int8 row in 32-bit words

// a = {ReA0, ReA1, ImA0, ImA1} of row s, b = {ReB0, ReB1, ImB0, ImB1} of
// row s+1, ph = {re0, im0, re1, im1}.
__device__ __forceinline__ float combine(const float* a, const float* b, const float* ph) {
  float p[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float pre = ph[2 * k], pim = ph[2 * k + 1];
    const float cre = a[k] + pre * b[k] - pim * b[2 + k];
    const float cim = a[2 + k] + pre * b[2 + k] + pim * b[k];
    p[k] = cre * cre + cim * cim;
  }
  return p[1] - p[0];
}

// The tile-level epilogue shared by both row types: keep row tid's A half
// in registers, hand its B half to thread tid-1 through shared memory.
template <typename Acc>
__device__ __forceinline__ void split(const Acc* acc, float scale, float* a, float* b) {
  a[0] = (float)acc[0] * scale; a[1] = (float)acc[1] * scale;
  a[2] = (float)acc[4] * scale; a[3] = (float)acc[5] * scale;
  b[0] = (float)acc[2] * scale; b[1] = (float)acc[3] * scale;
  b[2] = (float)acc[6] * scale; b[3] = (float)acc[7] * scale;
}

// Row-type traits: how a row is staged in shared memory (Word, kWords per
// row), how the kernel columns are laid out there (Cols), and the 8-column
// dot with its accumulator type (Acc).
struct F32Rows {
  using Elem = float;
  using Word = float;
  using Acc = float;
  static constexpr int kWords = kRow;
  struct Cols { float4 k[kRow * 2]; };  // tap t: k[2t] = cols 0-3, k[2t+1] = 4-7

  static __device__ __forceinline__ void load_cols(Cols& ks, const float* kc, int tid) {
    for (int i = tid; i < kRow * kCols; i += kTile) reinterpret_cast<float*>(ks.k)[i] = kc[i];
  }
  static __device__ __forceinline__ void dot(const float* x, const Cols& ks, float* acc) {
#pragma unroll
    for (int o = 0; o < kCols; ++o) acc[o] = 0.f;
#pragma unroll 8
    for (int t = 0; t < kRow; ++t) {
      const float v = x[t];
      const float4 k0 = ks.k[2 * t], k1 = ks.k[2 * t + 1];
      acc[0] = fmaf(v, k0.x, acc[0]); acc[1] = fmaf(v, k0.y, acc[1]);
      acc[2] = fmaf(v, k0.z, acc[2]); acc[3] = fmaf(v, k0.w, acc[3]);
      acc[4] = fmaf(v, k1.x, acc[4]); acc[5] = fmaf(v, k1.y, acc[5]);
      acc[6] = fmaf(v, k1.z, acc[6]); acc[7] = fmaf(v, k1.w, acc[7]);
    }
  }
};

struct I8Rows {
  using Elem = int8_t;
  using Word = int;  // four taps, tap 4w in the low byte
  using Acc = int;
  static constexpr int kWords = kRowW;
  struct Cols { int k[kCols][kRowW]; };

  // pack column o's taps 4w..4w+3 into one word, tap 4w in the low byte,
  // matching the little-endian byte order of a row word
  static __device__ __forceinline__ void load_cols(Cols& ks, const int8_t* kc, int tid) {
    for (int i = tid; i < kCols * kRowW; i += kTile) {
      const int o = i / kRowW, w = i - o * kRowW;
      uint32_t v = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) v |= (uint32_t)(uint8_t)kc[(4 * w + j) * kCols + o] << (8 * j);
      ks.k[o][w] = (int)v;
    }
  }
  static __device__ __forceinline__ void dot(const int* x, const Cols& ks, int* acc) {
#pragma unroll
    for (int o = 0; o < kCols; ++o) acc[o] = 0;
#pragma unroll 4
    for (int w = 0; w < kRowW; ++w) {
      const int v = x[w];
#pragma unroll
      for (int o = 0; o < kCols; ++o) acc[o] = __dp4a(v, ks.k[o][w], acc[o]);
    }
  }
};

template <typename Acc>
__device__ __forceinline__ void store_raw(Acc* out, const Acc* acc, int c, int nsym, int s) {
  Acc* dst = out + ((size_t)c * (nsym + 1) + s) * kCols;
#pragma unroll
  for (int o = 0; o < kCols; ++o) dst[o] = acc[o];
}

template <typename R>
__global__ void __launch_bounds__(kTile)
symbol_soft(const typename R::Elem* __restrict__ rows, long long cstride,
            const typename R::Elem* __restrict__ kern, const float* __restrict__ resc,
            const float* __restrict__ phi, void* __restrict__ out, int nsym, int raw) {
  using Word = typename R::Word;
  using Acc = typename R::Acc;
  constexpr int kStride = R::kWords + 1;  // odd row stride: conflict-free reads
  __shared__ Word xs[(kTile + 1) * kStride];
  __shared__ typename R::Cols ks;
  __shared__ float bsh[kTile + 1][4];
  const int c = blockIdx.y, s0 = blockIdx.x * kTile, tid = threadIdx.x;
  const int nrows = min(kTile + 1, nsym + 1 - s0);
  const Word* src = reinterpret_cast<const Word*>(rows + (long long)c * cstride +
                                                  (long long)s0 * kRow);
  R::load_cols(ks, kern + (size_t)c * kRow * kCols, tid);
#pragma unroll 4
  for (int i = tid; i < nrows * R::kWords; i += kTile) {
    const int r = i / R::kWords;
    xs[r * kStride + (i - r * R::kWords)] = src[i];
  }
  __syncthreads();
  const float scale = resc[c];
  Acc* const raw_out = static_cast<Acc*>(out);
  float a[4];
  Acc acc[kCols];
  if (tid < nrows) {
    R::dot(xs + tid * kStride, ks, acc);
    if (raw) store_raw(raw_out, acc, c, nsym, s0 + tid);
    split(acc, scale, a, bsh[tid]);
  }
  if (tid == 0 && nrows == kTile + 1) {  // first row of the next tile
    float b_unused[4];
    R::dot(xs + kTile * kStride, ks, acc);
    if (raw && s0 + kTile == nsym) store_raw(raw_out, acc, c, nsym, nsym);
    split(acc, scale, b_unused, bsh[kTile]);
  }
  __syncthreads();
  const int s = s0 + tid;
  if (!raw && s < nsym)
    static_cast<float*>(out)[(size_t)c * nsym + s] = combine(a, bsh[tid + 1], phi + 4 * c);
}

}  // namespace

// rows: element pointer of row 0 of channel 0; cstride: channel stride in
// elements (int8 rows: a multiple of 4, 4-byte-aligned base).  out: (C, nsym)
// float32 soft values, or with raw != 0 the (C, nsym+1, 8) correlation
// (float32, or int32 for int8 rows).  Returns cudaGetLastError().
extern "C" int opv_symbol_soft(const void* rows, long long cstride, int is_int8,
                               const void* kern, const void* resc, const void* phi,
                               void* out, int channels, int nsym, int raw, void* stream) {
  if (channels <= 0 || nsym <= 0) return 0;
  const dim3 grid((nsym + kTile - 1) / kTile, channels), block(kTile);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(resc);
  const float* ph = static_cast<const float*>(phi);
  if (is_int8)
    symbol_soft<I8Rows><<<grid, block, 0, st>>>(static_cast<const int8_t*>(rows), cstride,
                                                static_cast<const int8_t*>(kern), r, ph, out,
                                                nsym, raw);
  else
    symbol_soft<F32Rows><<<grid, block, 0, st>>>(static_cast<const float*>(rows), cstride,
                                                 static_cast<const float*>(kern), r, ph, out,
                                                 nsym, raw);
  return (int)cudaGetLastError();
}
