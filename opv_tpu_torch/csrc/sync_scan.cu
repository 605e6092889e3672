// The sync acquisition/tracking state machine (HUNTING / VERIFYING /
// LOCKED with the miss flywheel) of the reference-parity receiver, for
// sm_90a.
//
// Replaces: the lax.scan of opv_tpu/rx/sync.py::sync_scan (`:166`, its
// step `:111-160`), not a Pallas kernel.  Same contract as the plain twin
// in ops/sync_scan.py, bit for bit: per channel and symbol, from the raw
// and energy-normalized sync correlation and the valid mask, the next
// state, symbols since sync, misses, sync quality, collecting flag,
// saturating symbol total and frame count, and the per-symbol outputs
// (frame ready, quality at emit, the EV_* transition code, misses and
// frames after the step).  An invalid step changes nothing and emits
// EV_NONE.  The work is integer adds, compares and selects, and float64
// compares (no float arithmetic), so any order of evaluation gives the
// same bits; the branch order below is the reference's.
//
// What bounds it: the chain.  Each symbol's state depends on the last, so
// one thread walks one channel's symbols; per symbol that is ~30 integer
// operations and 24 bytes in (raw, norm, valid) and 21 out, ~0.1 us of
// dependent instructions.  A 64-channel chunk (2,284 symbols) moves ~6.6 MB,
// ~0.002 ms at the HBM rate; the walk takes tens of us.  The loads do not
// depend on the state, so the loop is unrolled to start them ahead of the
// chain.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHunt = 0, kVerify = 1, kLocked = 2;
constexpr int kEvNone = 0, kEvHuntVerify = 1, kEvVerifyLock = 2,
              kEvSyncOk = 3, kEvSyncMiss = 4, kEvLoseLock = 5;
constexpr int kIntWidth = 6;  // state, sss, misses, collecting, total, frames

struct Params {
  double hunt_norm, locked_norm, hunt_raw;
  int sync_bits, encoded_bits, frame_symbols, miss_limit;
};

// int32 wrap-around add (the JAX int32 carry wraps)
__device__ __forceinline__ int add_wrap(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

__global__ void sync_scan_kernel(const double* __restrict__ raw,
                                 const double* __restrict__ norm,
                                 const uint8_t* __restrict__ valid,
                                 int channels, int steps, Params p,
                                 const int* __restrict__ ist_in,
                                 const double* __restrict__ q_in,
                                 int* __restrict__ ist_out,
                                 double* __restrict__ q_out,
                                 uint8_t* __restrict__ ready,
                                 double* __restrict__ q,
                                 int* __restrict__ events,
                                 int* __restrict__ ev_misses,
                                 int* __restrict__ ev_frames) {
  const int ch = blockIdx.x * blockDim.x + threadIdx.x;
  if (ch >= channels) return;
  const int* si = ist_in + ch * kIntWidth;
  int state = si[0], sss = si[1], misses = si[2], total = si[4], frames = si[5];
  bool collecting = si[3] != 0;
  double sq = q_in[ch];
  const long long row = static_cast<long long>(ch) * steps;
#pragma unroll 8
  for (int t = 0; t < steps; ++t) {
    const long long at = row + t;
    const double r = raw[at], nrm = norm[at];
    const bool v = valid[at] != 0;
    if (v) {
      int total_n = add_wrap(total, 1);
      total_n = total_n < (1 << 30) ? total_n : (1 << 30);
      const int sss_n = add_wrap(sss, 1);
      const bool is_hunt = state == kHunt, is_ver = state == kVerify,
                 is_lock = state == kLocked;
      const bool hunt_hit = is_hunt && total_n >= p.sync_bits &&
                            r >= p.hunt_raw && nrm >= p.hunt_norm;
      const bool ver_done = is_ver && sss_n >= p.encoded_bits;
      const bool lock_chk = is_lock && sss_n == p.frame_symbols;
      const bool lock_ok = lock_chk && nrm >= p.locked_norm;
      const bool lock_miss = lock_chk && !lock_ok;
      int m = lock_ok ? 0 : (lock_miss ? add_wrap(misses, 1) : misses);
      const bool lose_lock = lock_miss && m >= p.miss_limit;
      const bool flywheel = lock_miss && !lose_lock;
      const bool lock_emit = is_lock && collecting && sss_n == p.encoded_bits;
      const bool sync_event = hunt_hit || lock_ok || flywheel;
      const int state_n = hunt_hit ? kVerify
                        : ver_done ? kLocked
                        : lose_lock ? kHunt : state;
      collecting = sync_event ? true
                 : (ver_done || lose_lock || lock_emit) ? false : collecting;
      sss = (hunt_hit || lock_chk) ? 0 : sss_n;
      sq = sync_event ? nrm : sq;
      misses = ver_done ? 0 : m;
      const bool rdy = ver_done || lock_emit;
      frames = add_wrap(frames, rdy ? 1 : 0);
      total = total_n;
      state = state_n;
      ready[at] = rdy;
      events[at] = hunt_hit ? kEvHuntVerify
                 : ver_done ? kEvVerifyLock
                 : lock_ok ? kEvSyncOk
                 : lose_lock ? kEvLoseLock
                 : flywheel ? kEvSyncMiss : kEvNone;
    } else {
      ready[at] = 0;
      events[at] = kEvNone;
    }
    q[at] = sq;
    ev_misses[at] = misses;
    ev_frames[at] = frames;
  }
  int* so = ist_out + ch * kIntWidth;
  so[0] = state; so[1] = sss; so[2] = misses; so[3] = collecting ? 1 : 0;
  so[4] = total; so[5] = frames;
  q_out[ch] = sq;
}

}  // namespace

// raw, norm: (channels, steps) float64; valid: (channels, steps) bool;
// ist_in/ist_out: (channels, 6) int32 [state, sss, misses, collecting,
// total, frames]; q_in/q_out: (channels,) float64 sync quality; ready:
// (channels, steps) bool; q: (channels, steps) float64; events, ev_misses,
// ev_frames: (channels, steps) int32; params: 3 thresholds (hunt norm,
// locked norm, hunt raw) and 4 ints (sync bits, encoded bits, frame
// symbols, miss limit), host memory.  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int opv_sync_scan(const void* raw, const void* norm,
                             const void* valid, int channels, int steps,
                             const double* thresholds, const int* counts,
                             const void* ist_in, const void* q_in,
                             void* ist_out, void* q_out, void* ready, void* q,
                             void* events, void* ev_misses, void* ev_frames,
                             void* stream) {
  if (channels <= 0 || steps < 0) return (int)cudaErrorInvalidValue;
  Params p{thresholds[0], thresholds[1], thresholds[2],
           counts[0], counts[1], counts[2], counts[3]};
  const int threads = 32;
  sync_scan_kernel<<<(channels + threads - 1) / threads, threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(raw), static_cast<const double*>(norm),
      static_cast<const uint8_t*>(valid), channels, steps, p,
      static_cast<const int*>(ist_in), static_cast<const double*>(q_in),
      static_cast<int*>(ist_out), static_cast<double*>(q_out),
      static_cast<uint8_t*>(ready), static_cast<double*>(q),
      static_cast<int*>(events), static_cast<int*>(ev_misses),
      static_cast<int*>(ev_frames));
  return (int)cudaGetLastError();
}
