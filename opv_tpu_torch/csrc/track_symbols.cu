// The float64 AFC/TED symbol-tracking loop of the non-coherent MSK
// demodulator, for sm_90a.
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
// across threads.  Per symbol the work is ~6,000 float64 operations (80
// sincos, 120 interpolations, 240 complex multiply-adds, one atan2) over
// 16 bytes per input sample: a 64-channel chunk of 2,168 symbols is ~0.8
// GFLOP and ~93 MB, under 0.03 ms at the card's float64 and HBM rates,
// while one thread walking the chain would take ~20 us per symbol.
// The design: one warp per channel.  Lane l takes taps l and l + 32 (lanes
// 0-7 two taps, the rest one), so the 80 sincos and the interpolations run
// side by side, and a butterfly __shfl_xor_sync reduction leaves the six
// complex sums in every lane.  An xor butterfly adds each pair in both
// lanes, and IEEE addition commutes, so every lane holds the same bits;
// every lane then does the scalar update itself (TED, timing loop, atan2,
// AFC, advance) and the warp stays uniform with no broadcast.  The window
// (1 KB a symbol) stays in L1.  The chain per symbol is one sincos, a
// 5-level reduction, an atan2 and two divides: ~1-2 us, so a 40 ms chunk of
// 2,168 symbols takes a few ms for any channel count up to one warp per
// SM (one warp per block, one block per channel).
//
// Rounding: nvcc would contract a*b + c into a fused multiply-add, which
// rounds once where the host rounds twice and moves the loop's trajectory
// away from the twin's.  The interpolation, the products and the scalar
// update are written with __dmul_rn / __dadd_rn / __dsub_rn, which never
// contract; sincos and atan2 differ from the host's libm by an ulp or so.

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

struct Params {
  double fd, fs, sr, alpha_t, beta_t, tf_clamp, adj_clamp, afc_clamp, afc_alpha;
};

__device__ __forceinline__ double clip(double x, double lo, double hi) {
  x = x < lo ? lo : x;  // jnp.clip's order: maximum, then minimum
  return x > hi ? hi : x;
}

__device__ __forceinline__ double wrap(double p) {
  if (p > kPi) p = __dsub_rn(p, kTwoPi);
  if (p < -kPi) p = __dadd_rn(p, kTwoPi);
  return p;
}

__device__ __forceinline__ double cnorm(double re, double im) {
  return __dadd_rn(__dmul_rn(re, re), __dmul_rn(im, im));
}

// Linear interpolation of the window w at rel: clip to [0, 63], index
// pinned at 62, v0 (1 - f) + v1 f with each product rounded.
__device__ __forceinline__ double2 interp(const double2* __restrict__ w,
                                          double rel) {
  double relc = clip(rel, 0.0, kWin - 1.0);
  int i0 = static_cast<int>(floor(relc));
  i0 = i0 > kWin - 2 ? kWin - 2 : i0;
  const double f = __dsub_rn(relc, static_cast<double>(i0));
  const double g = __dsub_rn(1.0, f);
  const double2 v0 = w[i0];
  const double2 v1 = w[i0 + 1];
  return make_double2(__dadd_rn(__dmul_rn(v0.x, g), __dmul_rn(v1.x, f)),
                      __dadd_rn(__dmul_rn(v0.y, g), __dmul_rn(v1.y, f)));
}

// acc += s * conj(lo): (sr co + si sn, si co - sr sn), as the reference's
// complex product with conj(lo) = (co, -sn).
__device__ __forceinline__ void cmac(double2 s, double co, double sn,
                                     double& re, double& im) {
  re = __dadd_rn(re, __dsub_rn(__dmul_rn(s.x, co), __dmul_rn(s.y, -sn)));
  im = __dadd_rn(im, __dadd_rn(__dmul_rn(s.x, -sn), __dmul_rn(s.y, co)));
}

__global__ void __launch_bounds__(32)
track_symbols_kernel(const double2* __restrict__ samples, long long cap,
                     const int* __restrict__ n_valid,
                     const double* __restrict__ state_in, int maxs, Params p,
                     double* __restrict__ soft, uint8_t* __restrict__ valid,
                     double* __restrict__ state_out, int* __restrict__ used) {
  const int ch = blockIdx.x;
  const int lane = threadIdx.x;
  const double2* s = samples + static_cast<long long>(ch) * cap;
  double* soft_row = soft + static_cast<long long>(ch) * maxs;
  uint8_t* valid_row = valid + static_cast<long long>(ch) * maxs;
  const double* st = state_in + ch * kStateWidth;

  double mu = st[0], ph1 = st[1], ph2 = st[2], foff = st[3], tfreq = st[4];
  double pc1r = st[5], pc1i = st[6], pc2r = st[7], pc2i = st[8];
  const double2 first = s[0];
  const int lim = n_valid[ch] - kGate;
  const long long last_base = cap - kWin;
  int pos = 0;
  int k = 0;
  for (; k < maxs && pos < lim; ++k) {
    const double inc1 = __ddiv_rn(__dmul_rn(kTwoPi, __dadd_rn(-p.fd, foff)), p.fs);
    const double inc2 = __ddiv_rn(__dmul_rn(kTwoPi, __dadd_rn(p.fd, foff)), p.fs);
    long long base = pos - 11;
    base = base < 0 ? 0 : (base > last_base ? last_base : base);
    const double2* w = s + base;
    const double offs = __dadd_rn(static_cast<double>(pos - base), mu);

    // six complex correlators: on, early, late x tone 1, tone 2
    double a[12] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
#pragma unroll
    for (int rep = 0; rep < 2; ++rep) {
      const int i = lane + 32 * rep;
      if (i < kSps) {
        const double di = static_cast<double>(i);
        const double rel = __dadd_rn(offs, di);
        const double2 s_on = interp(w, rel);
        const double2 s_e = pos + i < kEl ? first : interp(w, __dsub_rn(rel, 10.0));
        const double2 s_l = interp(w, __dadd_rn(rel, 10.0));
        double sn1, co1, sn2, co2;
        sincos(__dadd_rn(ph1, __dmul_rn(di, inc1)), &sn1, &co1);
        sincos(__dadd_rn(ph2, __dmul_rn(di, inc2)), &sn2, &co2);
        cmac(s_on, co1, sn1, a[0], a[1]);
        cmac(s_on, co2, sn2, a[2], a[3]);
        cmac(s_e, co1, sn1, a[4], a[5]);
        cmac(s_e, co2, sn2, a[6], a[7]);
        cmac(s_l, co1, sn1, a[8], a[9]);
        cmac(s_l, co2, sn2, a[10], a[11]);
      }
    }
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1) {
#pragma unroll
      for (int j = 0; j < 12; ++j)
        a[j] = __dadd_rn(a[j], __shfl_xor_sync(kFull, a[j], o));
    }

    // the scalar update, identical in every lane
    const double e1 = cnorm(a[0], a[1]);
    const double e2 = cnorm(a[2], a[3]);
    const bool f1_dom = e1 > e2;
    const double ee = f1_dom ? cnorm(a[4], a[5]) : cnorm(a[6], a[7]);
    const double el = f1_dom ? cnorm(a[8], a[9]) : cnorm(a[10], a[11]);
    const double ted = __ddiv_rn(__dsub_rn(el, ee),
                                 __dadd_rn(__dadd_rn(el, ee), 1e-10));
    const double tf_n = clip(__dadd_rn(tfreq, __dmul_rn(p.beta_t, ted)),
                             -p.tf_clamp, p.tf_clamp);
    const double adj = clip(__dadd_rn(__dmul_rn(p.alpha_t, ted), tf_n),
                            -p.adj_clamp, p.adj_clamp);
    // dom * conj(prev)
    const double dr = f1_dom ? a[0] : a[2], di_ = f1_dom ? a[1] : a[3];
    const double pr = f1_dom ? pc1r : pc2r, pi_ = f1_dom ? pc1i : pc2i;
    const double zr = __dsub_rn(__dmul_rn(dr, pr), __dmul_rn(di_, -pi_));
    const double zi = __dadd_rn(__dmul_rn(dr, -pi_), __dmul_rn(di_, pr));
    const double ferr = __ddiv_rn(__dmul_rn(atan2(zi, zr), p.sr), kTwoPi);
    if (k >= 1)
      foff = clip(__dadd_rn(foff, __dmul_rn(p.afc_alpha, ferr)),
                  -p.afc_clamp, p.afc_clamp);
    ph1 = wrap(__dadd_rn(ph1, __dmul_rn(static_cast<double>(kSps), inc1)));
    ph2 = wrap(__dadd_rn(ph2, __dmul_rn(static_cast<double>(kSps), inc2)));
    const double t = __dadd_rn(mu, __dadd_rn(static_cast<double>(kSps), adj));
    const double t_int = floor(t);
    pos += static_cast<int>(t_int);
    mu = __dsub_rn(t, t_int);
    tfreq = tf_n;
    pc1r = a[0]; pc1i = a[1]; pc2r = a[2]; pc2i = a[3];
    if (lane == 0) {
      soft_row[k] = __dsub_rn(e2, e1);
      valid_row[k] = 1;
    }
  }
  for (int j = k + lane; j < maxs; j += 32) {
    soft_row[j] = 0.0;
    valid_row[j] = 0;
  }
  if (lane == 0) {
    double* so = state_out + ch * kStateWidth;
    so[0] = mu; so[1] = ph1; so[2] = ph2; so[3] = foff; so[4] = tfreq;
    so[5] = pc1r; so[6] = pc1i; so[7] = pc2r; so[8] = pc2i;
    used[ch] = pos;
  }
}

}  // namespace

// samples: (channels, cap) complex128; n_valid: (channels,) int32;
// state_in/state_out: (channels, 9) float64 (the LoopState row, see
// ops/track_symbols.py); soft: (channels, maxs) float64; valid:
// (channels, maxs) bool; used: (channels,) int32; params: 9 host doubles
// (fd, fs, sr, alpha_t, beta_t, tf_clamp, adj_clamp, afc_clamp, afc_alpha).
// Launches on `stream`; returns cudaGetLastError().
extern "C" int opv_track_symbols(const void* samples, long long cap,
                                 const void* n_valid, const void* state_in,
                                 int channels, int maxs, const double* params,
                                 void* soft, void* valid, void* state_out,
                                 void* used, void* stream) {
  if (channels <= 0 || maxs < 0 || cap < kWin) return (int)cudaErrorInvalidValue;
  Params p{params[0], params[1], params[2], params[3], params[4],
           params[5], params[6], params[7], params[8]};
  track_symbols_kernel<<<channels, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double2*>(samples), cap,
      static_cast<const int*>(n_valid), static_cast<const double*>(state_in),
      maxs, p, static_cast<double*>(soft), static_cast<uint8_t*>(valid),
      static_cast<double*>(state_out), static_cast<int*>(used));
  return (int)cudaGetLastError();
}
