// The AFC/TED symbol-tracking loop of the non-coherent MSK demodulator,
// for sm_90a, in float64 (the reference's precision) and float32 (the JAX
// package's dtype="float32" mode): one template over the real type R.
//
// Replaces: the lax.scan of opv_tpu/rx/demod.py::demodulate_block (`:195`,
// its step `:117-193`), not a Pallas kernel.  Same contract as the plain
// twin in ops/track_symbols.py: per channel, symbol k interpolates the
// on-time, early (-10) and late (+10) samples at 40 taps from a 64-sample
// window, correlates them with both tones' LOs, emits soft = |c2|^2 - |c1|^2,
// and updates the early-late TED, the 2nd-order timing loop, the AFC (not
// on a call's first symbol) and the split advance pos_int/mu.  A step is
// active while pos_int < n_valid - 50; the steps after the last active one
// are no-ops (zeros, sym_valid 0).
//
// What bounds it on the card: the serial chain, not bytes or operations.
// Each symbol's window position, LO phase and frequency depend on the
// last symbol's TED and AFC update, so a channel's symbols cannot be split
// across threads.  Per symbol the work is ~6,000 float64 operations over
// 16 bytes per input sample: a 64-channel chunk of 2,168 symbols is ~0.8
// GFLOP and ~93 MB, under 0.03 ms at the card's float64 and HBM rates.
// What is left is latency.  Around the AFC loop, from one symbol's sums
// to the next's, the twin's arithmetic has 7 multiplies, 12 adds, 2
// divides, a sincos and an atan2 in series; at the card's measured
// latencies (8.2, 8.2, 111, 189 and 342 cycles) that is ~909 cycles a
// symbol, a floor for any design (the timing loop's is ~320).
//
// Measured with scripts/track_sweep.py (an H100 SXM at 700 W; cycles a
// symbol from clock64(): stage stamps in a copy of the kernel, which
// serialise the stages, and one span over the loop in another): the
// earlier one-warp-per-channel design (commit b8aea75) spends ~1,450 on
// its window loads at 1 channel and ~2,300 at 64 (one L2/HBM miss a
// symbol), ~870 on sincos (lanes 0-7 run two taps), ~790 on the
// reduction and ~1,450 on the scalar tail: a span of 4,110-4,990.  This
// design's span is ~2,240 at any width: sincos ~490, reduction
// (products, shuffles, the cross-warp sum) ~680, then the AFC (~1,030)
// beside the timing update and window (~940), ~2.5x the floor; the rest
// is the shuffles, barriers and shared-memory trips that spread a symbol
// over three warps.  In float32 the same chain is ~491 cycles at the
// card's float32 latencies (sincosf ~106, atan2f ~182, a divide ~58) and
// the span ~1,530: the shuffles, barriers and shared-memory trips stay.
//
// The design, one block of three warps per channel:
// - The channel's samples stream through a ring of kRing tiles of kTile
//   complex128 in shared memory, each filled by one 1-D TMA bulk copy
//   (cp.async.bulk) that completes on the tile's mbarrier.  pos advances
//   38-42 samples a symbol and a window spans 64, so a window touches at
//   most two tiles and the next window at most the tile after; warp 2's
//   first thread refills a slot as soon as the windows have left its
//   tile, kRing - 1 tiles ahead of the chain, and no sample load waits on
//   device memory.
// - Thread t < 40 (warps 0-1) runs tap t: two sincos and six complex
//   multiply-adds, one tap per thread.  Each of the two warps reduces its
//   twelve sums by a reduce-scatter butterfly (16 slots, 8+4+2+1+1 64-bit
//   shuffles), lanes write their slot to shared memory, and after a named
//   barrier every thread adds the two warps' partials in warp order, so
//   all hold the same bits.
// - The tails run side by side: warp 0 the AFC (its LO phases and
//   increments go to warp 1 through shared memory); warps 1 and 2 the
//   timing update (the same bits in both) and then the next symbol's
//   window, warp 1 taps 0-31 and warp 2 taps 32-39, into shared memory
//   for the tap threads.  A second named barrier closes the symbol.
// Tried and dropped (cycles a symbol): the window staged by the tap
// threads themselves between the timing update and the AFC tail (3,335:
// the slow-path branches of the divides and atan2 keep the compiler from
// interleaving the two); the AFC tail first (3,112); two warps, the
// timing update and the whole window on warp 1 (2,333: six
// interpolations a lane outlast the AFC); in the first of these, the
// reduce-scatter as a loop (3,829 against 3,335: its slots went to local
// memory); a window written to shared memory as it is interpolated (a
// store ahead of the next ring load holds that load back, so the
// interpolations run one after another); floor() and its int cast as one
// add rounded down (-6 of ~2,230); atan2 as CUDA's own polynomial
// evaluated by Estrin's scheme (-62, with the add -86: it takes fused
// multiply-adds into the loop, which the rounding rule below keeps out,
// and a host emulation put it within 1.8 ulp, CUDA's atan2 within 1.65).
//
// The sums: each warp adds its lanes in a fixed butterfly order and the
// warps are added in a fixed order, with no atomics, so a run's bits do not
// vary; they differ from the twin's matmul order by ~1e-15 relative.
//
// Rounding: nvcc would contract a*b + c into a fused multiply-add, which
// rounds once where the host rounds twice and moves the loop's trajectory
// away from the twin's.  The interpolation, the products and the scalar
// update are written with __dmul_rn / __dadd_rn / __dsub_rn / __ddiv_rn
// (float: __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn), which never
// contract; CUDA's sincos and atan2 (sincosf, atan2f: the accurate ones,
// not __sinf; no fast math) differ from the host's libm by an ulp or two.
//
// float32 follows the JAX package's float32 order of operations
// (opv_tpu/rx/demod.py:117-193): every constant a Python float there is
// rounded to float32 before it meets a float32 value (2 pi, pi, 40, 10,
// 1e-10, the timing gains and clamps), the LO increment is
// (2 pi (+-fd + foff)) / fs, ferr (pd sr) / 2 pi, and the position advances
// split as pos (int) and mu.  A float2 sample is 8 bytes, so a row of odd
// length or an odd tail would break the bulk copy's 16-byte rules: rows
// lie at a pitch `ld` whose bytes are a multiple of 16 (the wrapper pads an
// odd row by one sample) and a tile's copy is rounded up to 16 bytes,
// which stays inside the row's pitch; the extra sample is never read.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSps = 40;          // taps per symbol
constexpr int kWin = 64;          // interpolation window
constexpr int kEl = 10;           // early/late spacing, samples
constexpr int kGate = kSps + kEl; // active while pos < n_valid - 50
constexpr int kStateWidth = 9;
constexpr double kPi = 3.14159265358979323846;  // Python's math.pi
constexpr double kTwoPi = 2.0 * kPi;            // 2.0 * math.pi, exact
constexpr unsigned kFull = 0xffffffffu;

// warp 0: taps 0-31 and the AFC; warp 1: taps 32-39, the timing loop and
// the window of taps 0-31; warp 2: the timing loop, the window of taps
// 32-39 and the ring's bulk copies
constexpr int kWarps = 3;
constexpr int kTapWarps = 2;            // the warps that run taps
constexpr int kThreads = 32 * kWarps;   // thread t < kSps runs tap t
constexpr int kSums = 12;               // on/early/late x tone 1/2, re/im
constexpr int kSlots = 16;              // kSums padded for the butterfly
constexpr int kTile = 512;              // samples per ring tile (8 KB)
constexpr int kRing = 4;                // tiles in the ring (32 KB)
constexpr unsigned kRingMask = kTile * kRing - 1;
// a window spans 64 samples and moves <= 42 a symbol, so the next
// window's last tile is at most one past this window's first
static_assert(kTile >= kWin + 42 && kRing >= 2, "ring too small");
static_assert((kTile * kRing & (kTile * kRing - 1)) == 0, "ring not 2^n");
static_assert(kSps > 32 && kSps <= 32 * kTapWarps, "one tap per thread");

// ---- the real type: rounded arithmetic that never contracts -------------

__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double quot(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ void sin_cos(double x, double* s, double* c) { sincos(x, s, c); }
__device__ __forceinline__ double arg(double y, double x) { return atan2(y, x); }
__device__ __forceinline__ double rfloor(double x) { return floor(x); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float quot(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ void sin_cos(float x, float* s, float* c) { sincosf(x, s, c); }
__device__ __forceinline__ float arg(float y, float x) { return atan2f(y, x); }
__device__ __forceinline__ float rfloor(float x) { return floorf(x); }

// R's complex sample: double2 or float2
template <class R> struct Cplx;
template <> struct Cplx<double> { using T = double2; };
template <> struct Cplx<float> { using T = float2; };
template <class R> using C2 = typename Cplx<R>::T;

template <class R>
__device__ __forceinline__ C2<R> make_c2(R x, R y) {
  C2<R> v;
  v.x = x;
  v.y = y;
  return v;
}

// the constants in R, each rounded once from its double (as a Python
// float meets a float32 array in JAX)
template <class R>
struct Params {
  R fd, fs, sr, alpha_t, beta_t, tf_clamp, adj_clamp, afc_clamp, afc_alpha;
  R pi, two_pi, eps;
};

template <class R>
Params<R> make_params(const double* p) {
  return Params<R>{R(p[0]), R(p[1]), R(p[2]), R(p[3]), R(p[4]), R(p[5]),
                   R(p[6]), R(p[7]), R(p[8]), R(kPi), R(kTwoPi), R(1e-10)};
}

template <class R>
__device__ __forceinline__ R clip(R x, R lo, R hi) {
  x = x < lo ? lo : x;  // jnp.clip's order: maximum, then minimum
  return x > hi ? hi : x;
}

template <class R>
__device__ __forceinline__ R wrap(R p, const Params<R>& c) {
  if (p > c.pi) p = sub(p, c.two_pi);
  if (p < -c.pi) p = add(p, c.two_pi);
  return p;
}

template <class R>
__device__ __forceinline__ R cnorm(R re, R im) {
  return add(mul(re, re), mul(im, im));
}

template <class R>
__device__ __forceinline__ R lo_inc(R fd, R foff, const Params<R>& c) {
  return quot(mul(c.two_pi, add(fd, foff)), c.fs);
}

// acc += s * conj(lo): (sr co + si sn, si co - sr sn), as the reference's
// complex product with conj(lo) = (co, -sn).
template <class R>
__device__ __forceinline__ void cmac(C2<R> s, R co, R sn, R& re, R& im) {
  re = add(re, sub(mul(s.x, co), mul(s.y, -sn)));
  im = add(im, add(mul(s.x, -sn), mul(s.y, co)));
}

// ---- the ring: mbarriers and 1-D bulk copies ------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar))
               : "memory");
}

// Tile j (samples [j kTile, j kTile + n)) into its slot, completing on
// the slot's mbarrier.  The copy is n samples rounded up to 16 bytes (a
// bulk copy's unit): for complex128 exactly n, for complex64 one sample
// more when n is odd, which the row's pitch holds (see the launcher); the
// source is 16-byte aligned (a row at a pitch of whole 16 bytes).
template <class T>
__device__ __forceinline__ void issue_tile(T* ring, uint64_t* full,
                                           const T* s, long long cap,
                                           long long j) {
  const int slot = static_cast<int>(j % kRing);
  const long long left = cap - j * kTile;
  const uint32_t bytes = static_cast<uint32_t>(
      ((left < kTile ? left : kTile) * sizeof(T) + 15) & ~15ull);
  const uint32_t bar = smem_addr(full + slot);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      ::"r"(smem_addr(ring + slot * kTile)), "l"(s + j * kTile), "r"(bytes),
        "r"(bar)
      : "memory");
}

// Wait until tile j has landed: use j / kRing of its slot's mbarrier.
__device__ __forceinline__ void wait_tile(uint64_t* full, long long j) {
  const uint32_t bar = smem_addr(full + j % kRing);
  const uint32_t parity = static_cast<uint32_t>((j / kRing) & 1);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{ .reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// ---- the window -------------------------------------------------------------

// Linear interpolation of the window at base (a sample index, the ring
// holding it) at rel: clip to [0, 63], index pinned at 62, v0 (1 - f) +
// v1 f with each product rounded.
template <class R>
__device__ __forceinline__ C2<R> interp(const C2<R>* ring, unsigned base,
                                        R rel) {
  const R relc = clip(rel, R(0), R(kWin - 1));
  R i0d = rfloor(relc);
  int i0 = static_cast<int>(i0d);
  i0d = i0d > R(kWin - 2) ? R(kWin - 2) : i0d;
  i0 = i0 > kWin - 2 ? kWin - 2 : i0;
  const R f = sub(relc, i0d);
  const R g = sub(R(1), f);
  const unsigned j = base + static_cast<unsigned>(i0);
  const C2<R> v0 = ring[j & kRingMask];
  const C2<R> v1 = ring[(j + 1) & kRingMask];
  return make_c2<R>(add(mul(v0.x, g), mul(v1.x, f)),
                    add(mul(v0.y, g), mul(v1.y, f)));
}

// Tap i's on-time, early and late samples of the symbol at pos/mu into
// win[i] (rows kSps-63 take the taps past the last, a store and no
// branch).  First waits for the tiles of the window that this thread has
// not seen land yet (`seen` counts them).
template <class R>
__device__ __forceinline__ void stage(const C2<R>* ring, uint64_t* full,
                                      long long& seen, long long last_base,
                                      int pos, R mu, int i, C2<R> first,
                                      C2<R> (*win)[3]) {
  long long base = pos - 11;
  base = base < 0 ? 0 : (base > last_base ? last_base : base);
  for (const long long top = (base + kWin - 1) / kTile; seen <= top; ++seen)
    wait_tile(full, seen);
  const unsigned b = static_cast<unsigned>(base);
  const R offs = add(static_cast<R>(pos - static_cast<int>(base)), mu);
  const R rel = add(offs, static_cast<R>(i));
  // all three in registers before any store: a store to win ahead of a
  // ring load would hold the load back (both are shared memory)
  const C2<R> s_on = interp<R>(ring, b, rel);
  C2<R> s_e = interp<R>(ring, b, sub(rel, R(kEl)));
  const C2<R> s_l = interp<R>(ring, b, add(rel, R(kEl)));
  if (pos + i < kEl) s_e = first;
  win[i][0] = s_on;
  win[i][1] = s_e;
  win[i][2] = s_l;
}

// One level of the reduce-scatter: the lane keeps half of its first 2 H
// slots, sends the other half to its partner (lane ^ 2 H) and adds what
// it receives.  A template per level, so v stays in registers.
template <int H, class R>
__device__ __forceinline__ void scatter_level(R (&v)[kSlots], int lane) {
  const bool upper = lane & (2 * H);
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const R keep = upper ? v[H + j] : v[j];
    const R send = upper ? v[j] : v[H + j];
    v[j] = add(keep, __shfl_xor_sync(kFull, send, 2 * H));
  }
}

// The warp's sum of v[s] over its 32 lanes for the slot s = (lane >> 1) &
// 15 this lane ends with: each sum is formed in one fixed order, and the
// last level's two lanes add the same pair.
template <class R>
__device__ __forceinline__ R reduce_scatter(R (&v)[kSlots], int lane) {
  static_assert(kSlots == 16, "four halving levels");
  scatter_level<8>(v, lane);
  scatter_level<4>(v, lane);
  scatter_level<2>(v, lane);
  scatter_level<1>(v, lane);
  return add(v[0], __shfl_xor_sync(kFull, v[0], 1));
}

__device__ __forceinline__ void named_barrier(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(kThreads) : "memory");
}

// samples: rows of cap samples at a pitch of ld (ld * sizeof(C2<R>) a
// multiple of 16, ld >= cap rounded up to 16 bytes)
template <class R>
__global__ void __launch_bounds__(kThreads, 1)
track_symbols_kernel(const C2<R>* __restrict__ samples, long long cap,
                     long long ld, const int* __restrict__ n_valid,
                     const R* __restrict__ state_in, int maxs, Params<R> p,
                     R* __restrict__ soft, uint8_t* __restrict__ valid,
                     R* __restrict__ state_out, int* __restrict__ used) {
  __shared__ __align__(128) C2<R> ring[kTile * kRing];
  // the symbol's samples by tap (rows kSps-63: warp 2's idle lanes)
  __shared__ __align__(16) C2<R> win[2 * 32][3];
  __shared__ __align__(16) R part[kTapWarps][kSlots];
  __shared__ __align__(16) R lo[4];  // the symbol's ph1, ph2, inc1, inc2
  __shared__ int go;                 // the symbol is active
  __shared__ __align__(8) uint64_t full[kRing];

  const int ch = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const bool tap = tid < kSps;
  const R di = static_cast<R>(tid);
  const C2<R>* s = samples + static_cast<long long>(ch) * ld;
  R* soft_row = soft + static_cast<long long>(ch) * maxs;
  uint8_t* valid_row = valid + static_cast<long long>(ch) * maxs;
  const R* st = state_in + ch * kStateWidth;
  const long long tiles = (cap + kTile - 1) / kTile;
  const long long last_base = cap - kWin;
  // the first thread of the window warps (1, 2) and of warp 2, which
  // issues the bulk copies
  constexpr int kTimer = 32, kProducer = 64;
  const int stage_tap = tid - 32;  // warps 1-2: the tap whose window it stages
  const R sps = static_cast<R>(kSps);

  long long issued = 0;  // tiles issued (the producer)
  if (tid == kProducer) {
    for (int r = 0; r < kRing; ++r) bar_init(full + r);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (; issued < tiles && issued < kRing; ++issued)
      issue_tile(ring, full, s, cap, issued);
  }
  R mu = st[0], ph1 = st[1], ph2 = st[2], foff = st[3], tfreq = st[4];
  R pc1r = st[5], pc1i = st[6], pc2r = st[7], pc2i = st[8];
  const C2<R> first = s[0];
  const int lim = n_valid[ch] - kGate;
  R inc1 = lo_inc(-p.fd, foff, p);
  R inc2 = lo_inc(p.fd, foff, p);
  long long seen = 0;  // tiles this thread has waited for
  int pos = 0;
  int k = 0;
  bool run = maxs > 0 && pos < lim;
  __syncthreads();  // the barriers and the first tiles before any wait
  if (run && warp >= 1)
    stage<R>(ring, full, seen, last_base, pos, mu, stage_tap, first, win);
  __syncthreads();
  while (run) {
    if (warp < kTapWarps) {
      // six complex correlators: on, early, late x tone 1, tone 2
      R v[kSlots];
#pragma unroll
      for (int j = 0; j < kSlots; ++j) v[j] = R(0);
      if (tap) {
        const C2<R> s_on = win[tid][0], s_e = win[tid][1], s_l = win[tid][2];
        R sn1, co1, sn2, co2;
        sin_cos(add(ph1, mul(di, inc1)), &sn1, &co1);
        sin_cos(add(ph2, mul(di, inc2)), &sn2, &co2);
        cmac<R>(s_on, co1, sn1, v[0], v[1]);
        cmac<R>(s_on, co2, sn2, v[2], v[3]);
        cmac<R>(s_e, co1, sn1, v[4], v[5]);
        cmac<R>(s_e, co2, sn2, v[6], v[7]);
        cmac<R>(s_l, co1, sn1, v[8], v[9]);
        cmac<R>(s_l, co2, sn2, v[10], v[11]);
      }
      const R mine = reduce_scatter(v, lane);
      if (!(lane & 1)) part[warp][(lane >> 1) & (kSlots - 1)] = mine;
    }
    named_barrier(1);
    R a[kSums];
#pragma unroll
    for (int j = 0; j < kSums; j += 2) {
      const C2<R> w0 = *reinterpret_cast<const C2<R>*>(&part[0][j]);
      const C2<R> w1 = *reinterpret_cast<const C2<R>*>(&part[1][j]);
      a[j] = add(w0.x, w1.x);
      a[j + 1] = add(w0.y, w1.y);
    }
    const R e1 = cnorm(a[0], a[1]);
    const R e2 = cnorm(a[2], a[3]);
    const bool f1_dom = e1 > e2;

    if (warp == 0) {
      // the AFC: dom * conj(prev), its phase, the next LO increments
      const R dr = f1_dom ? a[0] : a[2], di_ = f1_dom ? a[1] : a[3];
      const R pr = f1_dom ? pc1r : pc2r, pi_ = f1_dom ? pc1i : pc2i;
      const R zr = sub(mul(dr, pr), mul(di_, -pi_));
      const R zi = add(mul(dr, -pi_), mul(di_, pr));
      const R ferr = quot(mul(arg(zi, zr), p.sr), p.two_pi);
      if (k >= 1)
        foff = clip(add(foff, mul(p.afc_alpha, ferr)), -p.afc_clamp,
                    p.afc_clamp);
      ph1 = wrap(add(ph1, mul(sps, inc1)), p);
      ph2 = wrap(add(ph2, mul(sps, inc2)), p);
      inc1 = lo_inc(-p.fd, foff, p);
      inc2 = lo_inc(p.fd, foff, p);
      pc1r = a[0]; pc1i = a[1]; pc2r = a[2]; pc2i = a[3];
      if (lane == 0) {
        lo[0] = ph1; lo[1] = ph2; lo[2] = inc1; lo[3] = inc2;
        soft_row[k] = sub(e2, e1);
        valid_row[k] = 1;
      }
    } else {
      // the timing update (warps 1 and 2 alike), then the next symbol's
      // window, beside the AFC
      const R ee = f1_dom ? cnorm(a[4], a[5]) : cnorm(a[6], a[7]);
      const R el = f1_dom ? cnorm(a[8], a[9]) : cnorm(a[10], a[11]);
      const R ted = quot(sub(el, ee), add(add(el, ee), p.eps));
      tfreq = clip(add(tfreq, mul(p.beta_t, ted)), -p.tf_clamp, p.tf_clamp);
      const R adj = clip(add(mul(p.alpha_t, ted), tfreq), -p.adj_clamp,
                         p.adj_clamp);
      const R t = add(mu, add(sps, adj));
      const R t_int = rfloor(t);
      const int step = static_cast<int>(t_int);
      pos += step;
      mu = sub(t, t_int);
      if (tid == kProducer) {
        // the windows have left the tiles below the next one's base:
        // refill their slots (warps 1-2 read this symbol's window before
        // the last barrier)
        long long base = pos - 11;
        base = base < 0 ? 0 : (base > last_base ? last_base : base);
        for (const long long top = base / kTile + kRing;
             issued < tiles && issued < top; ++issued)
          issue_tile(ring, full, s, cap, issued);
      }
      const bool next = k + 1 < maxs && pos < lim;
      if (next)
        stage<R>(ring, full, seen, last_base, pos, mu, stage_tap, first, win);
      if (tid == kTimer) go = next;
    }
    named_barrier(2);
    run = go;
    if (warp == 1) {
      ph1 = lo[0]; ph2 = lo[1]; inc1 = lo[2]; inc2 = lo[3];
    }
    ++k;
  }
  for (int j = k + tid; j < maxs; j += kThreads) {
    soft_row[j] = R(0);
    valid_row[j] = 0;
  }
  R* so = state_out + ch * kStateWidth;
  if (tid == 0) {
    so[1] = ph1; so[2] = ph2; so[3] = foff;
    so[5] = pc1r; so[6] = pc1i; so[7] = pc2r; so[8] = pc2i;
  }
  if (tid == kTimer) {
    so[0] = mu; so[4] = tfreq;
    used[ch] = pos;
  }
  if (tid == kProducer) {
    // no copy may still be writing the ring when the block ends
    for (; seen < issued; ++seen) wait_tile(full, seen);
  }
}

template <class R>
int launch(const void* samples, long long cap, long long ld,
           const void* n_valid, const void* state_in, int channels, int maxs,
           const double* params, void* soft, void* valid, void* state_out,
           void* used, void* stream) {
  constexpr long long kAlign = 16 / sizeof(C2<R>);  // samples in 16 bytes
  if (channels <= 0 || maxs < 0 || cap < kWin || ld % kAlign != 0 ||
      ld < (cap + kAlign - 1) / kAlign * kAlign ||
      reinterpret_cast<uintptr_t>(samples) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  track_symbols_kernel<R><<<channels, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const C2<R>*>(samples), cap, ld,
      static_cast<const int*>(n_valid), static_cast<const R*>(state_in), maxs,
      make_params<R>(params), static_cast<R*>(soft),
      static_cast<uint8_t*>(valid), static_cast<R*>(state_out),
      static_cast<int*>(used));
  return (int)cudaGetLastError();
}

}  // namespace

// samples: (channels, cap) complex128, 16-byte aligned; n_valid:
// (channels,) int32; state_in/state_out: (channels, 9) float64 (the
// LoopState row, see ops/track_symbols.py); soft: (channels, maxs)
// float64; valid: (channels, maxs) bool; used: (channels,) int32; params:
// 9 host doubles (fd, fs, sr, alpha_t, beta_t, tf_clamp, adj_clamp,
// afc_clamp, afc_alpha).  Launches on `stream`; returns cudaGetLastError().
extern "C" int opv_track_symbols(const void* samples, long long cap,
                                 const void* n_valid, const void* state_in,
                                 int channels, int maxs, const double* params,
                                 void* soft, void* valid, void* state_out,
                                 void* used, void* stream) {
  return launch<double>(samples, cap, cap, n_valid, state_in, channels, maxs,
                        params, soft, valid, state_out, used, stream);
}

// The float32 loop: samples (channels, cap) complex64 at a row pitch of ld
// samples (even, >= cap; the storage 16-byte aligned), state_in/state_out
// (channels, 9) float32, soft (channels, maxs) float32; the rest as
// opv_track_symbols', params the same 9 doubles, each rounded to float32
// here.
extern "C" int opv_track_symbols_f32(const void* samples, long long cap,
                                     long long ld, const void* n_valid,
                                     const void* state_in, int channels,
                                     int maxs, const double* params,
                                     void* soft, void* valid,
                                     void* state_out, void* used,
                                     void* stream) {
  return launch<float>(samples, cap, ld, n_valid, state_in, channels, maxs,
                       params, soft, valid, state_out, used, stream);
}
