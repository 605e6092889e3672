// Batched 64-state K=7 rate-1/2 soft-decision Viterbi for sm_90a.
//
// Replaces: opv_tpu/ops/pallas/viterbi.py, viterbi_pallas -> the Pallas
// kernels _viterbi_kernel_r4 (RADIX=4, the default) and _viterbi_kernel
// (RADIX=2).  Same contract, bit for bit: (B, 2144) int32 soft symbols in
// 0..7 (deinterleaved, (g1, g2) per trellis step) -> (B, 1072) uint8 bits
// and (B,) int32 best path metrics.  Values are staged as int16, so every
// value in 0..2^15-1 decodes as in the Pallas kernel, and the end state and
// its metric are exact for every int32 path metric (no composite key).
//
// What bounds it on the card: the serial add-compare-select chain, not
// bytes (a frame reads 8.6 KB and writes 1 KB).  Each of the 1072 trellis
// steps (536 fused double steps at radix 4) waits on the last: shuffle the
// parents' metrics -> add -> compare-select -> the next shuffle.  There are
// only as many chains as frames: 1280 on the main path, ~10 warps per SM.
// On an H100 a lone warp per SM runs a radix-2 step in ~60 cycles (the
// chain's latency), and ~10 warps per SM take ~100 each with issue slots
// to spare: they share the SM's shuffle and shared-memory pipe (4 SHFL and
// one tape store per step).
//
// Design: one warp per frame, so the recurrence stays in registers and warp
// intrinsics, with no block-wide barrier.  Lane l holds the path metrics of
// states l and l+32.
//   * radix 2: the parents of state s are s>>1 and (s>>1)+32; for s = l
//     they are the two halves of lane l>>1, for s = l+32 the two halves of
//     lane 16+(l>>1): four __shfl_sync per step.
//   * radix 4: the grandparents (s>>2) + {0, 16, 32, 48} sit in lanes
//     s>>2 and 16+(s>>2): eight __shfl_sync per fused double step.  The
//     priority-ordered min tree (bg within bp, then bp, ties to the lower
//     index) reproduces the sequential tie rules.
//   * survivor words come from __ballot_sync: word 0 = states 0..31,
//     word 1 = states 32..63 (bit s%32), the Pallas tape layout exactly;
//     radix 4 writes [bp_w0, bp_w1, bg_w0, bg_w1] per double step.
//   * the chain carries nothing else.  The first 8 trellis steps, the only
//     ones with the INT_MAX reachability guard (every state is reachable
//     after 6; the guard selects before it adds, so nothing overflows), run
//     as their own group; the other 1064 run as 133 unrolled groups of 8
//     steps with no test inside.  A group's soft values come in two 16-byte
//     broadcast shared loads issued one group ahead.  States l and l+32
//     expect the same (g1, g2) from their parents, so a lane forms one pair
//     of branch metrics per step.  Compare-select is Hopper's DPX
//     __vibmin_s32 (min and the "a <= b" predicate); ptxas emits the same
//     VIMNMX + ISETP for it as for a plain compare and select.
//   * the end state: the warp's minimum metric (__reduce_min_sync), then
//     the lowest state holding it (__ffs of a ballot), exact for any int32.
//   * one lane walks the tape back.  Each step's words come in one 8- or
//     16-byte shared load that does not depend on the state, 16 steps
//     ahead, so the chain per step is ALU only; each 16 decoded bits leave
//     as one 16-byte global store.
//   * staging: 16-byte global loads packed to int16 (17 per lane); a soft
//     base that is not 16-byte aligned (a view's offset) takes 4-byte loads,
//     decided once per launch.
//   * one frame per block (kWarps, chosen by scripts/viterbi_sweep.py):
//     its tape (8.6 KB) and staged soft values (4.3 KB) sit in dynamic
//     shared memory, and a one-warp block lets ptxas give each thread more
//     registers than the larger blocks do.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kFrameBits = 1072;
constexpr int kEncBits = 2 * kFrameBits;
constexpr int kSoftMax = 7;
constexpr int kGroup = 8;                 // trellis steps per unrolled group
constexpr int kGuardSteps = kGroup;       // guarded steps: the first group
constexpr int32_t kInf = 0x7FFFFFFF;
constexpr int32_t kGuard = 0x7FFFFFF0;
constexpr unsigned kG1 = 0x4F;
constexpr unsigned kG2 = 0x6D;
constexpr int kWarps = 1;                 // frames per block
constexpr unsigned kFull = 0xffffffffu;
// shared memory of one frame: the tape (two words per trellis step at
// either radix), then the int16 soft values and one group of prefetch pad
constexpr int kTapeBytes = kFrameBits * 8;
constexpr int kSoftBytes = kEncBits * 2 + kGroup * 4;
constexpr int kWarpBytes = kTapeBytes + kSoftBytes;
constexpr int kBlockBytes = kWarps * kWarpBytes;
static_assert((kFrameBits - kGuardSteps) % kGroup == 0, "no ragged group");
static_assert(kFrameBits % 16 == 0 && kWarpBytes % 16 == 0, "16-byte pieces");

// expected g bit (mask g) of the transition into state s from parent s>>1
__device__ __forceinline__ int exp_bit(int s, unsigned g) {
  return __popc(((((unsigned)s & 1u) << 6) | ((unsigned)s >> 1)) & g) & 1;
}

__device__ __forceinline__ int lo16(uint32_t p) { return (int16_t)(p & 0xffffu); }
__device__ __forceinline__ int hi16(uint32_t p) { return (int16_t)(p >> 16); }

// The two branch metrics into state s: bm = sum of (e ? 7 - sg : sg) over
// (g1, g2), written k*sg + o with k = +-1.  From parent p1 = p0 + 32 the
// expected g1 bit is unchanged and the g2 bit flips (g1 has trellis bit 5
// clear, g2 has it set).  States s and s+32 (s < 32) share both (neither
// mask has trellis bit 4).
struct Branch {
  int k1, k2, o0, o1;
  __device__ explicit Branch(int s) {
    const int e1 = exp_bit(s, kG1), e2 = exp_bit(s, kG2);
    k1 = 1 - 2 * e1;
    k2 = 1 - 2 * e2;
    o0 = kSoftMax * (e1 + e2);
    o1 = kSoftMax * (e1 + 1 - e2);
  }
  // (from p0, from p1) for the soft pair p = (g1 | g2 << 16)
  __device__ __forceinline__ void operator()(uint32_t p, int& bm0, int& bm1) const {
    const int a = k1 * lo16(p), b = k2 * hi16(p);
    bm0 = a + b + o0;
    bm1 = a - b + o1;
  }
};

template <bool kGuarded>
__device__ __forceinline__ int32_t add_metric(int32_t m, int32_t bm) {
  if (kGuarded) return m < kGuard ? m + bm : kInf;
  return m + bm;
}

// min(a, b) and whether b was taken; a tie keeps a
__device__ __forceinline__ int32_t min_sel(int32_t a, int32_t b, bool& took_b) {
  bool keep_a;
  const int32_t m = __vibmin_s32(a, b, &keep_a);
  took_b = !keep_a;
  return m;
}

// Per-lane constants of a step
template <int kRadix>
struct Lane;

template <>
struct Lane<2> {
  Branch br;       // into l and l+32 alike
  int srcA, srcB;  // lanes of the parents of l and of l+32
  __device__ explicit Lane(int l) : br(l), srcA(l >> 1), srcB(16 + (l >> 1)) {}
};

template <>
struct Lane<4> {
  Branch b;        // second step, into s (l and l+32 alike)
  Branch a_lo;     // first step, into l>>1
  Branch a_hi;     // first step, into 16+(l>>1)
  int qa, qc;      // lanes of the grandparents of l and of l+32
  __device__ explicit Lane(int l)
      : b(l), a_lo(l >> 1), a_hi(16 + (l >> 1)), qa(l >> 2), qc(8 + (l >> 2)) {}
};

// One radix-2 step for both of this lane's states -> survivor words
template <bool kGuarded>
__device__ __forceinline__ uint2 step2(int32_t& m_lo, int32_t& m_hi, uint32_t p,
                                       const Lane<2>& k) {
  int bm0, bm1;
  k.br(p, bm0, bm1);
  const int32_t a_lo = __shfl_sync(kFull, m_lo, k.srcA);   // state l>>1
  const int32_t a_hi = __shfl_sync(kFull, m_hi, k.srcA);   // state (l>>1)+32
  const int32_t b_lo = __shfl_sync(kFull, m_lo, k.srcB);   // state 16+(l>>1)
  const int32_t b_hi = __shfl_sync(kFull, m_hi, k.srcB);   // state 48+(l>>1)
  bool d_lo, d_hi;                                       // ties -> p0
  m_lo = min_sel(add_metric<kGuarded>(a_lo, bm0), add_metric<kGuarded>(a_hi, bm1), d_lo);
  m_hi = min_sel(add_metric<kGuarded>(b_lo, bm0), add_metric<kGuarded>(b_hi, bm1), d_hi);
  return make_uint2(__ballot_sync(kFull, d_lo), __ballot_sync(kFull, d_hi));
}

// One state of a fused double step: candidate (bp, bg) costs
// m[(s>>2) + 16 bp + 32 bg] + bmB[bp] + (bg ? y : x), where bmB are the
// second step's branch metrics and (x, y) the first step's into s>>1
// (the same for (s>>1)+32).
template <bool kGuarded>
__device__ __forceinline__ int32_t acs4(int32_t m00, int32_t m01, int32_t m10, int32_t m11,
                                        int bmB0, int bmB1, int x, int y, bool& bp, bool& bg) {
  bool dga, dgb;
  const int32_t va = min_sel(add_metric<kGuarded>(m00, bmB0 + x),
                             add_metric<kGuarded>(m01, bmB0 + y), dga);   // bg in bp = 0
  const int32_t vb = min_sel(add_metric<kGuarded>(m10, bmB1 + x),
                             add_metric<kGuarded>(m11, bmB1 + y), dgb);   // bg in bp = 1
  const int32_t v = min_sel(va, vb, bp);                                  // ties -> bp = 0
  bg = bp ? dgb : dga;
  return v;
}

// One radix-4 double step (soft pairs pa, pb of its two trellis steps) for
// both of this lane's states -> [bp_w0, bp_w1, bg_w0, bg_w1]
template <bool kGuarded>
__device__ __forceinline__ uint4 step4(int32_t& m_lo, int32_t& m_hi, uint32_t pa, uint32_t pb,
                                       const Lane<4>& k) {
  int bmB0, bmB1, xl, yl, xh, yh;
  k.b(pb, bmB0, bmB1);
  k.a_lo(pa, xl, yl);
  k.a_hi(pa, xh, yh);
  // grandparent g = q + 16*bp + 32*bg: bp picks lane q or q+16, bg the lo
  // (g < 32) or hi half of that lane
  const int32_t A_lo = __shfl_sync(kFull, m_lo, k.qa), A_hi = __shfl_sync(kFull, m_hi, k.qa);
  const int32_t B_lo = __shfl_sync(kFull, m_lo, k.qa + 16);
  const int32_t B_hi = __shfl_sync(kFull, m_hi, k.qa + 16);
  const int32_t C_lo = __shfl_sync(kFull, m_lo, k.qc), C_hi = __shfl_sync(kFull, m_hi, k.qc);
  const int32_t D_lo = __shfl_sync(kFull, m_lo, k.qc + 16);
  const int32_t D_hi = __shfl_sync(kFull, m_hi, k.qc + 16);
  bool bp_lo, bg_lo, bp_hi, bg_hi;
  m_lo = acs4<kGuarded>(A_lo, A_hi, B_lo, B_hi, bmB0, bmB1, xl, yl, bp_lo, bg_lo);
  m_hi = acs4<kGuarded>(C_lo, C_hi, D_lo, D_hi, bmB0, bmB1, xh, yh, bp_hi, bg_hi);
  return make_uint4(__ballot_sync(kFull, bp_lo), __ballot_sync(kFull, bp_hi),
                    __ballot_sync(kFull, bg_lo), __ballot_sync(kFull, bg_hi));
}

__device__ __forceinline__ uint32_t word_of(const uint4 (&q)[2], int j) {
  const uint4& v = q[j >> 2];
  return (j & 3) == 0 ? v.x : (j & 3) == 1 ? v.y : (j & 3) == 2 ? v.z : v.w;
}

// One group of kGroup trellis steps from its 32 bytes of soft pairs q;
// lane 0 writes the survivor words of trellis step t0 onward
template <int kRadix, bool kGuarded>
__device__ __forceinline__ void group(int32_t& m_lo, int32_t& m_hi, const uint4 (&q)[2],
                                      const Lane<kRadix>& k, uint32_t* tape, int t0, int lane) {
  if constexpr (kRadix == 2) {
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const uint2 w = step2<kGuarded>(m_lo, m_hi, word_of(q, j), k);
      if (lane == 0) reinterpret_cast<uint2*>(tape)[t0 + j] = w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kGroup / 2; ++j) {
      const uint4 w = step4<kGuarded>(m_lo, m_hi, word_of(q, 2 * j), word_of(q, 2 * j + 1), k);
      if (lane == 0) reinterpret_cast<uint4*>(tape)[t0 / 2 + j] = w;
    }
  }
}

// the state before s, from the survivor word of s's half (bit s%32 set:
// parent (s>>1)+32)
__device__ __forceinline__ int prev_state(int s, uint32_t word) {
  return (s >> 1) | (int)((__funnelshift_r(word, word, s) & 1u) << 5);
}

__device__ __forceinline__ void put_bit(uint32_t (&o)[4], int i, int s) {
  o[i >> 2] |= (uint32_t)(s & 1) << (8 * (i & 3));
}

// Walk the tape back from end state s; out: the frame's 1072 bytes.
template <int kRadix>
__device__ __forceinline__ void traceback(const uint32_t* tape, int s, uint8_t* out) {
  uint4* dst = reinterpret_cast<uint4*>(out);
#pragma unroll 1
  for (int g = kFrameBits / 16 - 1; g >= 0; --g) {       // 16 bits per pass
    uint32_t o[4] = {0u, 0u, 0u, 0u};
    if constexpr (kRadix == 2) {
      uint2 w[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) w[j] = reinterpret_cast<const uint2*>(tape)[16 * g + j];
#pragma unroll
      for (int j = 15; j >= 0; --j) {
        put_bit(o, j, s);
        s = prev_state(s, (s & 32) ? w[j].y : w[j].x);
      }
    } else {
      uint4 w[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) w[j] = reinterpret_cast<const uint4*>(tape)[8 * g + j];
#pragma unroll
      for (int j = 7; j >= 0; --j) {
        const bool hi = s & 32;
        const uint32_t wg = hi ? w[j].w : w[j].z;
        const int p = prev_state(s, hi ? w[j].y : w[j].x);
        put_bit(o, 2 * j + 1, s);
        put_bit(o, 2 * j, p);
        s = (p >> 1) | (int)((__funnelshift_r(wg, wg, s) & 1u) << 5);
      }
    }
    dst[g] = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

// The frame's soft values -> int16 in shared memory
__device__ __forceinline__ void stage(const int32_t* src, int16_t* sv, int lane, bool aligned) {
  if (aligned) {
    constexpr int kVec = kEncBits / 4;                  // 536 16-byte pieces
    constexpr int kPer = (kVec + 31) / 32;              // 17 per lane
    const int4* s4 = reinterpret_cast<const int4*>(src);
    uint2* d = reinterpret_cast<uint2*>(sv);
    int4 v[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      if (lane + 32 * k < kVec) v[k] = __ldg(s4 + lane + 32 * k);
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      if (lane + 32 * k < kVec)
        d[lane + 32 * k] = make_uint2(__byte_perm(v[k].x, v[k].y, 0x5410),
                                      __byte_perm(v[k].z, v[k].w, 0x5410));
  } else {
    for (int i = lane; i < kEncBits; i += 32) sv[i] = (int16_t)src[i];
  }
}

template <int kRadix>
__global__ void __launch_bounds__(32 * kWarps)
viterbi_kernel(const int32_t* __restrict__ soft, uint8_t* __restrict__ bits,
               int32_t* __restrict__ metrics, int batch, bool aligned) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int frame = blockIdx.x * kWarps + warp;
  if (frame >= batch) return;                         // whole warps only
  unsigned char* mine = smem + warp * kWarpBytes;
  uint32_t* tape = reinterpret_cast<uint32_t*>(mine);
  int16_t* sv = reinterpret_cast<int16_t*>(mine + kTapeBytes);
  stage(soft + (size_t)frame * kEncBits, sv, lane, aligned);
  __syncwarp();

  // 16 bytes of soft values = 4 trellis steps
  const uint4* sq = reinterpret_cast<const uint4*>(sv);
  const Lane<kRadix> k(lane);
  int32_t m_lo = lane == 0 ? 0 : kInf, m_hi = kInf;
  {
    const uint4 q[2] = {sq[0], sq[1]};
    group<kRadix, true>(m_lo, m_hi, q, k, tape, 0, lane);
  }
  uint4 next[2] = {sq[kGuardSteps / 4], sq[kGuardSteps / 4 + 1]};
#pragma unroll 1
  for (int t = kGuardSteps; t < kFrameBits; t += kGroup) {
    const uint4 q[2] = {next[0], next[1]};
    next[0] = sq[t / 4 + 2];                          // the last group reads the pad
    next[1] = sq[t / 4 + 3];
    group<kRadix, false>(m_lo, m_hi, q, k, tape, t, lane);
  }

  // end state: the minimum metric, then the lowest state holding it
  const int32_t best = __reduce_min_sync(kFull, min(m_lo, m_hi));
  const unsigned lo = __ballot_sync(kFull, m_lo == best);
  const unsigned hi = __ballot_sync(kFull, m_hi == best);
  const int s = lo ? __ffs(lo) - 1 : 31 + __ffs(hi);
  if (lane == 0) {                                    // lane 0 wrote the tape
    metrics[frame] = best;
    traceback<kRadix>(tape, s, bits + (size_t)frame * kFrameBits);
  }
}

template <int kRadix>
int launch(const int32_t* soft, uint8_t* bits, int32_t* metrics, int batch, cudaStream_t st) {
  if constexpr (kBlockBytes > 48 * 1024) {   // dynamic shared memory above 48 KB
    const cudaError_t err = cudaFuncSetAttribute(
        viterbi_kernel<kRadix>, cudaFuncAttributeMaxDynamicSharedMemorySize, kBlockBytes);
    if (err != cudaSuccess) return (int)err;
  }
  const bool aligned = (reinterpret_cast<uintptr_t>(soft) & 15u) == 0;
  const dim3 grid((batch + kWarps - 1) / kWarps), block(32 * kWarps);
  viterbi_kernel<kRadix><<<grid, block, kBlockBytes, st>>>(soft, bits, metrics, batch, aligned);
  return (int)cudaGetLastError();
}

}  // namespace

// soft (batch, 2144) int32 (any 4-byte aligned base), bits (batch, 1072)
// uint8 (16-byte aligned base), metrics (batch,) int32, all contiguous on
// the device of `stream`.  Returns cudaGetLastError().
extern "C" int opv_viterbi(const void* soft, void* bits, void* metrics, int batch,
                           int radix, void* stream) {
  if (batch <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* s = static_cast<const int32_t*>(soft);
  uint8_t* b = static_cast<uint8_t*>(bits);
  int32_t* m = static_cast<int32_t*>(metrics);
  if (radix == 4) return launch<4>(s, b, m, batch, st);
  if (radix == 2) return launch<2>(s, b, m, batch, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* opv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
