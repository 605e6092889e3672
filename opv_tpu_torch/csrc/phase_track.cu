// Float64 NCO phase recurrence of the reference-exact modulator, for
// sm_90a: a walk over binade segments on one thread a tone, then a fill
// of the segments' samples by the grid.
//
// Replaces: opv_tpu/tx/modulator.py::_phase_track (a lax.scan, not a Pallas
// kernel), which modulate_bits_exact runs once per tone.  Same contract,
// bit for bit: for tone t with start phase ph0[t] and increment inc[t],
//     phases[t, 0] = ph0[t],  phases[t, i + 1] = wrap(phases[t, i] + inc[t]),
//     final[t] = wrap(phases[t, n - 1] + inc[t]),
// where wrap(p) subtracts 2*pi if p > pi and then adds 2*pi if p < -pi, the
// per-sample order of opv-mod.cpp:274-279.
//
// What bounds it on the card: the chain of dependent float64 operations,
// not bytes or operations.  A serial walk costs one add and the wrap's
// compares and selects a sample (~44 cycles).  But the recurrence is
// arithmetic between binade edges and wraps: while x and x + inc lie in
// one binade [2^e, 2^(e+1)), x = m u with u = 2^(e-52) and the add is
// integer arithmetic on m, which moves by d = inc / u rounded to nearest,
// ties to even.  Where inc / u ends in exactly 1/2 the first step depends
// on m's parity and leaves m even; every step after it is d.  So the walk
// takes, at a segment's start x (a chain of ~105 cycles on an H100,
// scripts/phase_sweep.py):
//   1. the real add p = x + inc (it settles a tie by parity), and the
//      table entry of x's sign and binade (shared memory, built from inc's
//      bits with integer arithmetic in the prologue): the boundary b, the
//      step d, 1 / |d| rounded up and the wrap the edge's step takes;
//   2. the count of further steps of d that keep the phase at least one
//      unit above 2^e (below it the float grid is twice as fine, so an
//      exact sum just under the edge does not round to the edge), at most
//      at 2^(e+1) - u (pi in [2, 4): no wrap), on x's side of zero:
//      floor(room / |d|), exact from one fma rounded toward zero (the
//      reciprocal's excess stays under 1 / |d| for room < 2^52 units), and
//      the segment's last phase p + count d, exact in the binade;
//   3. one real step across the edge: the add, then the table's wrap (a
//      step out of [2, 4) passes pi, and no other step of a walked binade
//      wraps); from a p outside the binade, the twin's wrap of p itself.
// A segment is recorded (start, x, p, d); zero, subnormal and tiny phases
// where inc spans whole binades take segments of one sample.  Phases with
// |x| > pi (a start beyond the wraps) and |inc| >= pi or not finite take
// the twin's serial step.  One 40 ms frame is ~8,130 segments a tone
// against 86,720 serial steps.  The fill writes x and then p + j d, exact
// (j |d| < 2^52 units, every value inside the binade): one warp a segment
// (the walk storing its own samples instead is ~3.3x slower: its stores
// sit on the one thread's in-order issue).  Every add, multiply and fma
// is written as its intrinsic, so nothing contracts.  The sin/cos, the
// tone mix and the int16 cast that follow are elementwise and run as
// torch ops on the same stream.

#include <cuda_runtime.h>

namespace {

constexpr double kPi = 3.14159265358979323846;  // Python's math.pi
constexpr double kTwoPi = 2.0 * kPi;            // 2.0 * math.pi, exact
constexpr int kEMin = -970;         // lowest binade walked (ops/phase_track.py E_MIN)
constexpr int kEntries = 3073;      // (sign, biased exponent) of |x| <= pi
constexpr int kTableThreads = 256;
constexpr int kFillThreads = 256;
constexpr long long kLo = 1LL << 52;
constexpr double kTwo52 = 4503599627370496.0;          // 2^52
constexpr int kTwo52Hi = 0x43300000;                   // its high word

// One binade on one side of zero: the boundary b where the walk stops
// (with x's sign), 1 / |d| rounded up (+inf where d = 0), the step d, all
// in x's units, and the -+2pi that the step across the edge takes
// ([2, 4) outward: past pi; 0 elsewhere).
struct alignas(16) Entry {
  double b, rc, d, wrap;
};
// One segment: x0 at start, then x1 + j d; its end is the next start.
struct alignas(16) Seg {
  long long start;
  double x0, x1, d;
};
constexpr int kTableBytes = kEntries * static_cast<int>(sizeof(Entry));

__device__ __forceinline__ double twin_step(double x, double inc) {
  double p = __dadd_rn(x, inc);
  if (p > kPi) p = __dsub_rn(p, kTwoPi);
  if (p < -kPi) p = __dadd_rn(p, kTwoPi);
  return p;
}

// The twin's step for |x| <= pi, |inc| < pi: p - 2pi then lies in
// [-pi, 0], so the second compare is needed only where the first failed.
__device__ __forceinline__ double wrap(double p) {
  const double lo = __dsub_rn(p, kTwoPi), hi = __dadd_rn(p, kTwoPi);
  return p > kPi ? lo : (p < -kPi ? hi : p);
}

// Table entry idx = (x's sign bit << 11) | x's biased exponent, for the
// increment with bits `ib` (ops/phase_track.py::binade_steps gives d).
__device__ Entry make_entry(int idx, unsigned long long ib) {
  const bool neg_x = idx >> 11, neg_inc = ib >> 63;
  const int eb = idx & 0x7FF, e = eb - 1023;
  const int ieb = static_cast<int>((ib >> 52) & 0x7FF);
  const long long mag = static_cast<long long>(ib & (kLo - 1)) | (ieb ? kLo : 0);
  const long long big = neg_inc ? -mag : mag;
  const int shift = (ieb ? ieb : 1) - 1023 - e;  // inc = big 2^(e - 52 + shift)
  const double inf = __longlong_as_double(0x7FF0000000000000LL);
  Entry out{neg_inc ? inf : -inf, 0.0, 0.0, 0.0};  // room -inf: no step
  if (eb < 1023 + kEMin || eb > 1024 || shift >= 0) return out;
  long long d = 0;
  if (-shift < 55) {  // else |inc / u| < 1/4: d = 0
    const int sh = -shift;
    const long long q = big >> sh, r = big - (q << sh), half = 1LL << (sh - 1);
    d = q + ((r > half || (r == half && (q & 1))) ? 1 : 0);
  }
  if (d >= kLo || d <= -kLo) return out;
  const double u = ldexp(1.0, e - 52);
  const bool grow = neg_x == neg_inc;
  const double bound = grow ? (e == 1 ? kPi : __dmul_rn(9007199254740991.0, u))
                            : __dmul_rn(4503599627370497.0, u);  // 2^e + u
  out.b = neg_x ? -bound : bound;
  out.d = __dmul_rn(static_cast<double>(d), u);
  out.rc = d == 0 ? inf : __drcp_ru(fabs(out.d));
  // outward from [2, 4) the step past the last phase <= pi lands past pi
  // (|d u| < 2 + u/2 there); elsewhere a walked binade's step cannot wrap
  out.wrap = (grow && e == 1) ? (neg_inc ? kTwoPi : -kTwoPi) : 0.0;
  return out;
}

// One tone's walk over n samples from x (thread 0 of the tone's block):
// the prefix with |x| > pi written directly, then segments into seg (with
// a sentinel start n after the last), their count and the final phase.
// kUp: inc's sign bit is clear.  n < 2^30 (a chunk).
template <bool kUp>
__device__ void walk(const Entry* tab, double x, const double inc, const int n,
                     double* out, Seg* seg, long long* count, double* final_ph) {
  int i = 0;
  if (!(fabs(inc) < kPi)) {  // no segments: the twin's serial step
    for (; i < n; ++i) {
      out[i] = x;
      x = twin_step(x, inc);
    }
  }
  for (; i < n && !(fabs(x) <= kPi); ++i) {
    out[i] = x;
    x = twin_step(x, inc);
  }
  Seg* sp = seg;
  int rest = n - 1 - i;  // samples after x
  double fin = x;
  if (rest >= 0) {
    for (;;) {
      const double p = __dadd_rn(x, inc);
      const Entry t = tab[static_cast<unsigned>(__double2hiint(x)) >> 20];
      *sp = Seg{i, x, p, t.d};
      ++sp;
      const double wp = wrap(p);  // the next phase if no step of d is taken
      // room: units of d u left between p and the boundary, in the walk's
      // direction (< 0: p is outside, or the binade takes no step)
      const double room = kUp ? __dsub_rn(t.b, p) : __dsub_rn(p, t.b);
      // 2^52 + floor(room / |d|), exactly: rc is 1 / |d| rounded up, and
      // the fma rounds toward zero once onto [2^52, 2^53)'s grid of 1
      const double est_m = __fma_rz(room, t.rc, kTwo52);
      const double est = __dsub_rn(est_m, kTwo52);
      const double x_end = __fma_rn(est, t.d, p);  // the segment's last phase
      const bool valid = __double2hiint(room) >= 0;  // room is never -0
      // the steps after x: est + 1; rest + 1 where the count passes 2^30 or
      // d = 0 (x + inc = x; rc is +inf there, so est_m is +inf or NaN)
      const unsigned est_lo = static_cast<unsigned>(__double2loint(est_m));
      const int k_big = valid ? rest + 1 : 0;
      const int k = valid && __double2hiint(est_m) == kTwo52Hi && est_lo < (1u << 30)
                    ? static_cast<int>(est_lo) + 1 : k_big;
      // the real step across the edge: the add, then the wrap it must take
      const double x_next = valid ? __dadd_rn(__dadd_rn(x_end, inc), t.wrap) : wp;
      if (k >= rest) {
        fin = k > rest ? __fma_rn(static_cast<double>(rest), t.d, p) : x_next;
        break;
      }
      x = x_next;
      i += k + 1;
      rest -= k + 1;
    }
  }
  const long long ns = sp - seg;
  sp->start = n;
  *count = ns;
  *final_ph = fin;
}

__global__ void __launch_bounds__(kTableThreads)
walk_kernel(const double* ph0, double inc0, double inc1, long long n,
            long long stride, double* __restrict__ phases, Seg* __restrict__ segs,
            long long cap, long long* __restrict__ counts, double* final_ph) {
  extern __shared__ Entry tab[];
  const int t = blockIdx.x;
  const double inc = t == 0 ? inc0 : inc1;
  const unsigned long long ib = static_cast<unsigned long long>(__double_as_longlong(inc));
  for (int idx = threadIdx.x; idx < kEntries; idx += kTableThreads)
    tab[idx] = make_entry(idx, ib);
  __syncthreads();
  if (threadIdx.x != 0) return;
  const double x = ph0[t];
  double* out = phases + t * stride;
  if (ib >> 63)
    walk<false>(tab, x, inc, n, out, segs + t * cap, counts + t, final_ph + t);
  else
    walk<true>(tab, x, inc, n, out, segs + t * cap, counts + t, final_ph + t);
}

// One warp a segment, its lanes over the segment's samples.
__global__ void __launch_bounds__(kFillThreads)
fill_kernel(const Seg* __restrict__ segs, long long cap,
            const long long* __restrict__ counts, long long stride,
            double* __restrict__ phases) {
  const int t = blockIdx.y;
  const Seg* s = segs + t * cap;
  double* out = phases + t * stride;
  const long long ns = counts[t];
  const int lane = threadIdx.x & 31;
  const long long warps = static_cast<long long>(gridDim.x) * (kFillThreads / 32);
  for (long long w = (static_cast<long long>(blockIdx.x) * kFillThreads + threadIdx.x) / 32;
       w < ns; w += warps) {
    const Seg g = s[w];
    const long long end = s[w + 1].start;
    for (long long j = g.start + lane; j < end; j += 32)
      out[j] = j == g.start ? g.x0
                            : __fma_rn(static_cast<double>(j - g.start - 1), g.d, g.x1);
  }
}

}  // namespace

// ph0: (tones,) float64 start phases on the device; inc0/inc1: the tones'
// increments (inc1 unused for one tone); phases: (tones, n) float64 out;
// final_ph: (tones,) float64 out; segs: (tones, chunk + 1) records of 32
// bytes and counts: (tones,) int64, scratch (after the call: the last
// chunk's segment tables).  tones is 1 or 2.  Runs chunks of at most
// `chunk` samples, each a walk launch and a fill launch from the last
// chunk's final phase, on `stream`; returns the first launch error.
extern "C" int opv_phase_track(const void* ph0, double inc0, double inc1, int tones,
                               long long n, void* phases, void* final_ph, void* segs,
                               void* counts, long long chunk, void* stream) {
  if (tones < 1 || tones > 2 || n < 0 || chunk < 1 || chunk >= (1LL << 30))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTableBytes);
  if (err != cudaSuccess) return (int)err;
  const long long fill_blocks_max = 264;  // 2 a SM of 132
  const long long wanted = (chunk + kFillThreads / 32 - 1) / (kFillThreads / 32);
  const dim3 fill_grid(static_cast<unsigned>(wanted < fill_blocks_max ? wanted : fill_blocks_max),
                       tones);
  const double* in = static_cast<const double*>(ph0);
  double* out = static_cast<double*>(phases);
  double* fin = static_cast<double*>(final_ph);
  Seg* seg = static_cast<Seg*>(segs);
  long long* cnt = static_cast<long long*>(counts);
  long long off = 0;
  do {
    const long long len = n - off < chunk ? n - off : chunk;
    walk_kernel<<<tones, kTableThreads, kTableBytes, st>>>(in, inc0, inc1, len, n, out + off,
                                                           seg, chunk + 1, cnt, fin);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    fill_kernel<<<fill_grid, kFillThreads, 0, st>>>(seg, chunk + 1, cnt, n, out + off);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    in = fin;
    off += len;
  } while (off < n);
  return (int)cudaSuccess;
}
