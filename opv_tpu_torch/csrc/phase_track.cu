// Serial float64 NCO phase recurrence of the reference-exact modulator, for
// sm_90a.
//
// Replaces: opv_tpu/tx/modulator.py::_phase_track (a lax.scan, not a Pallas
// kernel), which modulate_bits_exact runs once per tone.  Same contract,
// bit for bit: for tone t with start phase ph0[t] and increment inc[t],
//     phases[t, 0] = ph0[t],  phases[t, i + 1] = wrap(phases[t, i] + inc[t]),
//     final[t] = wrap(phases[t, n - 1] + inc[t]),
// where wrap(p) subtracts 2*pi if p > pi and then adds 2*pi if p < -pi, the
// per-sample order of opv-mod.cpp:274-279.  Every step is one IEEE double
// add and the wrap's compares and adds (no multiply, so nothing contracts
// into a fused multiply-add), so the phases equal the host recurrence's.
//
// What bounds it on the card: the chain, not bytes or operations.  Each
// sample's phase waits on the last (add -> compare -> select -> add), and
// the phase sequence is not periodic in the sample index (the rounding of
// each add carries on), so it cannot be split across threads and stay
// exact.  One thread per tone walks its n samples; the stores sit off the
// chain.  The sin/cos, the tone mix and the int16 cast that follow are
// elementwise and run as torch ops on the same stream.

#include <cuda_runtime.h>

namespace {

constexpr double kPi = 3.14159265358979323846;  // Python's math.pi
constexpr double kTwoPi = 2.0 * kPi;            // 2.0 * math.pi, exact

__global__ void phase_track_kernel(const double* __restrict__ ph0, double inc0,
                                   double inc1, long long n,
                                   double* __restrict__ phases,
                                   double* __restrict__ final_ph) {
  const int t = blockIdx.x;
  const double inc = t == 0 ? inc0 : inc1;
  double* out = phases + static_cast<long long>(t) * n;
  double ph = ph0[t];
  for (long long i = 0; i < n; ++i) {
    out[i] = ph;
    double p = ph + inc;
    if (p > kPi) p -= kTwoPi;
    if (p < -kPi) p += kTwoPi;
    ph = p;
  }
  final_ph[t] = ph;
}

}  // namespace

// ph0: (tones,) float64 start phases on the device; inc0/inc1: the tones'
// increments (inc1 unused for one tone); phases: (tones, n) float64 out;
// final_ph: (tones,) float64 out.  tones is 1 or 2.  Launches on `stream`;
// returns cudaGetLastError().
extern "C" int opv_phase_track(const void* ph0, double inc0, double inc1,
                               int tones, long long n, void* phases,
                               void* final_ph, void* stream) {
  if (tones < 1 || tones > 2 || n < 0) return (int)cudaErrorInvalidValue;
  phase_track_kernel<<<tones, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(ph0), inc0, inc1, n,
      static_cast<double*>(phases), static_cast<double*>(final_ph));
  return (int)cudaGetLastError();
}
