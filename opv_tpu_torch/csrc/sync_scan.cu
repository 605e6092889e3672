// The sync acquisition/tracking state machine (HUNTING / VERIFYING /
// LOCKED with the miss flywheel) of the reference-parity receiver, for
// sm_90a, with the 24-tap sync correlation as an optional input stage.
//
// Replaces: the lax.scan of opv_tpu/rx/sync.py::sync_scan (`:166`, its
// step `:111-160`), not a Pallas kernel, and (SoftSync) the 24 shifted
// adds of sync_correlate (`:71-89`) with normalized_sync's gate.  Same
// contract as the plain twins in ops/sync_scan.py, bit for bit: per
// channel and symbol, from the raw and energy-normalized sync correlation
// and the valid mask, the next state, symbols since sync, misses, sync
// quality, collecting flag, saturating symbol total and frame count, and
// the per-symbol outputs (frame ready, quality at emit, the EV_*
// transition code, misses and frames after the step).  An invalid step
// changes nothing and emits EV_NONE.  The machine is integer adds,
// compares and selects and float compares; the correlation is the twin's
// adds in the twin's order (__dadd_rn/__dsub_rn, no contraction) and one
// __ddiv_rn, so every output equals the twin's bits.
//
// One template over the real type R as well: float64 (the reference's
// precision) and float32 (the JAX package's dtype="float32" mode).  In
// float32 every compare is a float32 compare against a threshold rounded
// to float32 once (a Python float meeting a float32 array in JAX: 0.7
// rounds below itself, so a float32 norm may pass that a double compare
// would refuse), and the correlation's adds and division are
// __fadd_rn/__fsub_rn/__fdiv_rn in the same order, so T2[float32] too is
// bit-identical to its twin and to JAX's sync_correlate + sync_scan.
//
// What bounds it: the chain, and how much of it a symbol costs.  Each
// symbol's state depends on the last, but almost no symbol changes more
// than the symbol counters: in HUNTING only a hunt hit does, in VERIFYING
// and LOCKED only the symbol at a known count of valid steps.  So one warp
// walks one channel, a tile of 32 symbols at a time, a symbol per lane:
// the per-symbol tests that do not depend on the state run on every lane
// at once, a ballot and the lanes' rank among the tile's valid symbols
// give the counters at every lane in closed form, a second ballot finds
// the next lane where the step does more, and only there the warp runs
// the reference's step (a tile holds zero or one such lane as a rule).
// Each lane keeps its own symbol's outputs and the warp stores them
// coalesced.  The loads do not depend on the state: each lane loads a
// group of kGroup tiles one group ahead of the walk into registers.  A
// 64-channel chunk (2,284 symbols) moves ~5.6 MB (GivenSync) or ~6.7 MB
// (SoftSync), ~0.002 ms at the HBM rate; the walk is 72 tiles of ~500
// clock64 cycles (GivenSync; ~860 with SoftSync's correlation), 0.018 /
// 0.030 ms on an H100 SXM at C = 1 and at C = 64 alike: the per-tile
// latency bounds it, not bytes.
//
// SoftSync computes raw and norm itself from the soft stream soft_ext
// (C, 23 + S), each row at a stride of its own (the view
// soft_cat[:, eb - 23:] of rx/pipeline.py, 8 bytes off 16, read with
// plain coalesced 8-byte loads): the group and its 23-symbol halo go
// through a per-warp buffer in shared memory, each lane sums its own
// symbol's 24 taps in the twin's order, and raw and norm are stored too.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHunt = 0, kVerify = 1, kLocked = 2;
constexpr int kEvNone = 0, kEvHuntVerify = 1, kEvVerifyLock = 2,
              kEvSyncOk = 3, kEvSyncMiss = 4, kEvLoseLock = 5;
constexpr int kIntWidth = 6;  // state, sss, misses, collecting, total, frames
constexpr int kTotalCap = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kTile = 32;   // symbols a tile, one a lane
constexpr int kGroup = 4;   // tiles a lane loads at once, a group ahead
constexpr int kGroupSyms = kGroup * kTile;
constexpr int kTaps = 24;   // the sync word: SoftSync's taps
// The protocol's sync word, MSB first: a set bit is a -1 tap (the F1
// tone).  A constant, so each tap's add or subtract is fixed at compile
// time; the launcher refuses another word.
constexpr unsigned kSyncWord = 0x02B8DB;

// rounded arithmetic that never contracts, in either real type
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double quot(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float quot(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double mag(double a) { return fabs(a); }
__device__ __forceinline__ float mag(float a) { return fabsf(a); }

// thresholds in R (each rounded once from its double)
template <class R>
struct Params {
  R hunt_norm, locked_norm, hunt_raw;
  int sync_bits, encoded_bits, frame_symbols, miss_limit;
};

template <class R>
Params<R> make_params(const double* thresholds, const int* counts) {
  return Params<R>{R(thresholds[0]), R(thresholds[1]), R(thresholds[2]),
                   counts[0], counts[1], counts[2], counts[3]};
}

// int32 wrap-around add (the JAX int32 carry wraps)
__device__ __forceinline__ int add_wrap(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

// The carry of one channel, uniform across its warp.
template <class R>
struct Carry {
  int state, sss, misses, total, frames;
  bool collecting;
  R sq;
};

// One lane's outputs for its symbol of the tile.
template <class R>
struct Out {
  bool rdy;
  int ev, misses, frames;
  R q;
};

// The reference's step on a valid symbol whose counters after the step
// are sss_n and total_n; updates c, returns the outputs.
template <class R>
__device__ __forceinline__ Out<R> step(Carry<R>& c, int sss_n, int total_n,
                                       R r, R nrm, const Params<R>& p) {
  const bool is_hunt = c.state == kHunt, is_ver = c.state == kVerify,
             is_lock = c.state == kLocked;
  const bool hunt_hit = is_hunt && total_n >= p.sync_bits &&
                        r >= p.hunt_raw && nrm >= p.hunt_norm;
  const bool ver_done = is_ver && sss_n >= p.encoded_bits;
  const bool lock_chk = is_lock && sss_n == p.frame_symbols;
  const bool lock_ok = lock_chk && nrm >= p.locked_norm;
  const bool lock_miss = lock_chk && !lock_ok;
  const int m = lock_ok ? 0 : (lock_miss ? add_wrap(c.misses, 1) : c.misses);
  const bool lose_lock = lock_miss && m >= p.miss_limit;
  const bool flywheel = lock_miss && !lose_lock;
  const bool lock_emit = is_lock && c.collecting && sss_n == p.encoded_bits;
  const bool sync_event = hunt_hit || lock_ok || flywheel;
  c.state = hunt_hit ? kVerify : ver_done ? kLocked : lose_lock ? kHunt
                                                                : c.state;
  c.collecting = sync_event ? true
               : (ver_done || lose_lock || lock_emit) ? false : c.collecting;
  c.sss = (hunt_hit || lock_chk) ? 0 : sss_n;
  c.sq = sync_event ? nrm : c.sq;
  c.misses = ver_done ? 0 : m;
  const bool rdy = ver_done || lock_emit;
  c.frames = add_wrap(c.frames, rdy ? 1 : 0);
  c.total = total_n;
  Out<R> o;
  o.rdy = rdy;
  o.ev = hunt_hit ? kEvHuntVerify : ver_done ? kEvVerifyLock
       : lock_ok ? kEvSyncOk : lose_lock ? kEvLoseLock
       : flywheel ? kEvSyncMiss : kEvNone;
  o.q = c.sq;
  o.misses = c.misses;
  o.frames = c.frames;
  return o;
}

// total after k >= 1 valid steps from t, each min(wrap(t + 1), 2^30): the
// first step may wrap (t = INT_MAX) or saturate; from there on t <= 2^30
// and the steps add without wrapping until they saturate.
__device__ __forceinline__ int total_after(int t1, int k) {
  return min(add_wrap(t1, k - 1), kTotalCap);
}

// Walk one tile: lane `lane` holds symbol (v, r, nrm) and gets its outputs
// in o.  Between two events only sss and total move, so the walk jumps
// from event to event.
template <class R>
__device__ __forceinline__ void walk_tile(Carry<R>& c, bool v, R r, R nrm,
                                          const Params<R>& p, int lane,
                                          Out<R>& o) {
  const unsigned vmask = __ballot_sync(kFull, v);
  const unsigned upto = (2u << lane) - 1u;  // lanes 0..lane
  const bool hunt_ok = r >= p.hunt_raw && nrm >= p.hunt_norm;
  int from = 0;
  for (;;) {
    const unsigned live = vmask & (kFull << from);  // valid lanes >= from
    const int t1 = min(add_wrap(c.total, 1), kTotalCap);
    // the counters after this lane's step, had no event come before it
    const int k = __popc(live & upto);
    const int sss_k = add_wrap(c.sss, k);
    bool hit;
    if (c.state == kHunt)
      hit = total_after(t1, k) >= p.sync_bits && hunt_ok;
    else if (c.state == kVerify)
      hit = sss_k >= p.encoded_bits;
    else if (c.state == kLocked)
      hit = sss_k == p.frame_symbols ||
            (c.collecting && sss_k == p.encoded_bits);
    else
      hit = false;
    const unsigned events = __ballot_sync(kFull, hit && v && lane >= from);
    const int e = events ? __ffs(events) - 1 : kTile;
    if (lane >= from && lane < e) {
      o.rdy = false;
      o.ev = kEvNone;
      o.q = c.sq;
      o.misses = c.misses;
      o.frames = c.frames;
    }
    if (!events) {
      const int n = __popc(live);
      c.sss = add_wrap(c.sss, n);
      if (n) c.total = total_after(t1, n);
      return;
    }
    const int ke = __popc(live & ((2u << e) - 1u));
    const R re = __shfl_sync(kFull, r, e);
    const R ne = __shfl_sync(kFull, nrm, e);
    const Out<R> oe = step(c, add_wrap(c.sss, ke), total_after(t1, ke), re,
                           ne, p);
    if (lane == e) o = oe;
    from = e + 1;
    if (from == kTile) return;
  }
}

// The kernel's input: raw, norm and valid given, (C, S) contiguous.
template <class R>
struct GivenSync {
  using Real = R;
  static constexpr int kSmem = 1;  // reals of shared memory a warp
  const R* raw;
  const R* norm;
  const uint8_t* valid;
  struct Group {
    R r[kGroup], n[kGroup];
    bool v[kGroup];
  };
  __device__ __forceinline__ void load(Group& g, int, long long row, int t0,
                                       int steps, int lane) const {
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const int t = t0 + j * kTile + lane;
      const bool in = t < steps;
      g.r[j] = in ? raw[row + t] : R(0);
      g.n[j] = in ? norm[row + t] : R(0);
      g.v[j] = in && valid[row + t] != 0;
    }
  }
  // raw/norm of each tile of the group (nothing to compute)
  __device__ __forceinline__ void prepare(const Group& g, R* r, R* n, R*,
                                          long long, int, int, int) const {
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      r[j] = g.r[j];
      n[j] = g.n[j];
    }
  }
};

// The kernel's input: the soft stream soft_ext (C, 23 + S) at row stride
// ld and valid (C, S); raw and norm computed here and stored to raw_out,
// norm_out (C, S).
template <class R>
struct SoftSync {
  using Real = R;
  static constexpr int kSmem = kGroupSyms + kTile;  // a group and its halo
  const R* soft;
  long long ld;
  const uint8_t* valid;
  R* raw_out;
  R* norm_out;
  R min_energy;
  struct Group {
    R x[kGroup + 1];  // soft_ext[t0 + j * 32 + lane], j = 0..kGroup
    bool v[kGroup];
  };
  __device__ __forceinline__ void load(Group& g, int ch, long long row,
                                       int t0, int steps, int lane) const {
    const R* srow = soft + ch * ld;
#pragma unroll
    for (int j = 0; j <= kGroup; ++j) {
      const int i = t0 + j * kTile + lane;
      g.x[j] = i < steps + kTaps - 1 ? srow[i] : R(0);
    }
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const int t = t0 + j * kTile + lane;
      g.v[j] = t < steps && valid[row + t] != 0;
    }
  }
  // Each lane's symbol of each tile: raw and energy as the twin sums them
  // (tap 0 first, from +0.0), then normalized_sync's gate and division;
  // raw and norm stored for the symbols of the row.
  __device__ __forceinline__ void prepare(const Group& g, R* r, R* n,
                                          R* buf, long long row, int t0,
                                          int steps, int lane) const {
    __syncwarp();
#pragma unroll
    for (int j = 0; j <= kGroup; ++j) buf[j * kTile + lane] = g.x[j];
    __syncwarp();
    R e[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) r[j] = e[j] = R(0);
#pragma unroll
    for (int i = 0; i < kTaps; ++i) {
      const bool neg = (kSyncWord >> (kTaps - 1 - i)) & 1u;
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const R w = buf[j * kTile + lane + i];
        r[j] = neg ? sub(r[j], w) : add(r[j], w);
        e[j] = add(e[j], mag(w));
      }
    }
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      n[j] = e[j] < min_energy ? R(0)
           : quot(r[j], e[j] > R(0) ? e[j] : R(1));
      const int t = t0 + j * kTile + lane;
      if (t < steps) {
        raw_out[row + t] = r[j];
        norm_out[row + t] = n[j];
      }
    }
  }
};

template <class In, class R = typename In::Real>
__global__ void __launch_bounds__(kTile)
sync_scan_kernel(In in, int channels, int steps, Params<R> p,
                 const int* __restrict__ ist_in,
                 const R* __restrict__ q_in, int* __restrict__ ist_out,
                 R* __restrict__ q_out, uint8_t* __restrict__ ready,
                 R* __restrict__ q, int* __restrict__ events,
                 int* __restrict__ ev_misses, int* __restrict__ ev_frames) {
  __shared__ R buf[In::kSmem];
  const int ch = blockIdx.x;
  const int lane = threadIdx.x;
  if (ch >= channels) return;
  const int* si = ist_in + ch * kIntWidth;
  Carry<R> c;
  c.state = si[0];
  c.sss = si[1];
  c.misses = si[2];
  c.collecting = si[3] != 0;
  c.total = si[4];
  c.frames = si[5];
  c.sq = q_in[ch];
  const long long row = static_cast<long long>(ch) * steps;
  typename In::Group nxt;
  in.load(nxt, ch, row, 0, steps, lane);
  for (int t0 = 0; t0 < steps; t0 += kGroupSyms) {
    const typename In::Group cur = nxt;
    if (t0 + kGroupSyms < steps)
      in.load(nxt, ch, row, t0 + kGroupSyms, steps, lane);
    R r[kGroup], n[kGroup];
    in.prepare(cur, r, n, buf, row, t0, steps, lane);
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const int base = t0 + j * kTile;
      if (base >= steps) break;
      Out<R> o;
      walk_tile(c, cur.v[j], r[j], n[j], p, lane, o);
      const long long at = row + base + lane;
      if (base + lane < steps) {
        ready[at] = o.rdy;
        q[at] = o.q;
        events[at] = o.ev;
        ev_misses[at] = o.misses;
        ev_frames[at] = o.frames;
      }
    }
  }
  if (lane == 0) {
    int* so = ist_out + ch * kIntWidth;
    so[0] = c.state;
    so[1] = c.sss;
    so[2] = c.misses;
    so[3] = c.collecting ? 1 : 0;
    so[4] = c.total;
    so[5] = c.frames;
    q_out[ch] = c.sq;
  }
}

template <class In, class R = typename In::Real>
int launch(const In& in, int channels, int steps, const Params<R>& p,
           const void* ist_in, const void* q_in, void* ist_out, void* q_out,
           void* ready, void* q, void* events, void* ev_misses,
           void* ev_frames, void* stream) {
  sync_scan_kernel<In><<<channels, kTile, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      in, channels, steps, p, static_cast<const int*>(ist_in),
      static_cast<const R*>(q_in), static_cast<int*>(ist_out),
      static_cast<R*>(q_out), static_cast<uint8_t*>(ready),
      static_cast<R*>(q), static_cast<int*>(events),
      static_cast<int*>(ev_misses), static_cast<int*>(ev_frames));
  return (int)cudaGetLastError();
}

template <class R>
int given(const void* raw, const void* norm, const void* valid, int channels,
          int steps, const double* thresholds, const int* counts,
          const void* ist_in, const void* q_in, void* ist_out, void* q_out,
          void* ready, void* q, void* events, void* ev_misses,
          void* ev_frames, void* stream) {
  if (channels <= 0 || steps < 0) return (int)cudaErrorInvalidValue;
  const GivenSync<R> in{static_cast<const R*>(raw),
                        static_cast<const R*>(norm),
                        static_cast<const uint8_t*>(valid)};
  return launch(in, channels, steps, make_params<R>(thresholds, counts),
                ist_in, q_in, ist_out, q_out, ready, q, events, ev_misses,
                ev_frames, stream);
}

template <class R>
int correlated(const void* soft_ext, long long ld, const void* valid,
               int channels, int steps, const double* thresholds,
               const int* counts, unsigned sync_word, const void* ist_in,
               const void* q_in, void* ist_out, void* q_out, void* ready,
               void* q, void* events, void* ev_misses, void* ev_frames,
               void* raw_out, void* norm_out, void* stream) {
  if (channels <= 0 || steps < 0 || counts[0] != kTaps ||
      sync_word != kSyncWord || ld < steps + kTaps - 1)
    return (int)cudaErrorInvalidValue;
  const SoftSync<R> in{static_cast<const R*>(soft_ext), ld,
                       static_cast<const uint8_t*>(valid),
                       static_cast<R*>(raw_out), static_cast<R*>(norm_out),
                       R(thresholds[3])};
  return launch(in, channels, steps, make_params<R>(thresholds, counts),
                ist_in, q_in, ist_out, q_out, ready, q, events, ev_misses,
                ev_frames, stream);
}

}  // namespace

// raw, norm: (channels, steps) float64; valid: (channels, steps) bool;
// ist_in/ist_out: (channels, 6) int32 [state, sss, misses, collecting,
// total, frames]; q_in/q_out: (channels,) float64 sync quality; ready:
// (channels, steps) bool; q: (channels, steps) float64; events, ev_misses,
// ev_frames: (channels, steps) int32; params: 3 thresholds (hunt norm,
// locked norm, hunt raw) and 4 ints (sync bits, encoded bits, frame
// symbols, miss limit), host memory.  A warp per channel.  Launches on
// `stream`; returns cudaGetLastError().
extern "C" int opv_sync_scan(const void* raw, const void* norm,
                             const void* valid, int channels, int steps,
                             const double* thresholds, const int* counts,
                             const void* ist_in, const void* q_in,
                             void* ist_out, void* q_out, void* ready, void* q,
                             void* events, void* ev_misses, void* ev_frames,
                             void* stream) {
  return given<double>(raw, norm, valid, channels, steps, thresholds, counts,
                       ist_in, q_in, ist_out, q_out, ready, q, events,
                       ev_misses, ev_frames, stream);
}

// SoftSync: soft_ext (channels, 23 + steps) float64 rows at a stride of
// ld elements (ld >= 23 + steps), valid (channels, steps) bool; the other
// state and outputs as opv_sync_scan's, plus raw_out and norm_out
// (channels, steps) float64.  thresholds: the 3 above and the min energy;
// counts as above (sync bits must be 24); sync_word: the protocol's
// (must be kSyncWord).
extern "C" int opv_sync_correlate_scan(
    const void* soft_ext, long long ld, const void* valid, int channels,
    int steps, const double* thresholds, const int* counts, unsigned sync_word,
    const void* ist_in, const void* q_in, void* ist_out, void* q_out,
    void* ready, void* q, void* events, void* ev_misses, void* ev_frames,
    void* raw_out, void* norm_out, void* stream) {
  return correlated<double>(soft_ext, ld, valid, channels, steps, thresholds,
                            counts, sync_word, ist_in, q_in, ist_out, q_out,
                            ready, q, events, ev_misses, ev_frames, raw_out,
                            norm_out, stream);
}

// The float32 instantiations: every float64 array above float32 (raw,
// norm, soft_ext, q_in, q_out, q, raw_out, norm_out), the same arguments
// otherwise; the thresholds stay host doubles and are rounded to float32
// here, once, as JAX rounds a Python float against a float32 array.
extern "C" int opv_sync_scan_f32(const void* raw, const void* norm,
                                 const void* valid, int channels, int steps,
                                 const double* thresholds, const int* counts,
                                 const void* ist_in, const void* q_in,
                                 void* ist_out, void* q_out, void* ready,
                                 void* q, void* events, void* ev_misses,
                                 void* ev_frames, void* stream) {
  return given<float>(raw, norm, valid, channels, steps, thresholds, counts,
                      ist_in, q_in, ist_out, q_out, ready, q, events,
                      ev_misses, ev_frames, stream);
}

extern "C" int opv_sync_correlate_scan_f32(
    const void* soft_ext, long long ld, const void* valid, int channels,
    int steps, const double* thresholds, const int* counts, unsigned sync_word,
    const void* ist_in, const void* q_in, void* ist_out, void* q_out,
    void* ready, void* q, void* events, void* ev_misses, void* ev_frames,
    void* raw_out, void* norm_out, void* stream) {
  return correlated<float>(soft_ext, ld, valid, channels, steps, thresholds,
                           counts, sync_word, ist_in, q_in, ist_out, q_out,
                           ready, q, events, ev_misses, ev_frames, raw_out,
                           norm_out, stream);
}
