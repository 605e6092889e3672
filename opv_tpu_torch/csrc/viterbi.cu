// Batched 64-state K=7 rate-1/2 soft-decision Viterbi for sm_90a.
//
// Replaces: opv_tpu/ops/pallas/viterbi.py, viterbi_pallas -> the Pallas
// kernels _viterbi_kernel_r4 (RADIX=4, the default) and _viterbi_kernel
// (RADIX=2).  Same contract, bit for bit: (B, 2144) int32 soft symbols in
// 0..7 (deinterleaved, (g1, g2) per trellis step; values are staged as
// int16, so anything below 2^15 is exact, as in the Pallas kernel) ->
// (B, 1072) uint8 bits and (B,) int32 best path metrics.
//
// What bounds it on the card: the serial add-compare-select chain (1072
// trellis steps, or 536 fused double steps at radix 4), not bytes: a frame
// reads 8.6 KB and writes 1 KB.  The per-step latency of that chain and
// how many chains run at once decide the time.
//
// Design: one warp per frame, so the whole recurrence stays in registers
// and warp intrinsics, with no block-wide barrier.  Lane l holds the path
// metrics of states l and l+32.
//   * radix 2: the parents of state s are s>>1 and (s>>1)+32; for s = l
//     they are the two halves of lane l>>1, for s = l+32 the two halves of
//     lane 16+(l>>1): four __shfl_sync per step.
//   * radix 4: the grandparents (s>>2) + {0, 16, 32, 48} sit in lanes
//     s>>2 and 16+(s>>2): eight __shfl_sync per fused double step.  The
//     priority-ordered min tree (bg within bp, then bp, strict "<" so ties
//     keep the lower index) reproduces the sequential tie rules.
//   * survivor words come from __ballot_sync: word 0 = states 0..31,
//     word 1 = states 32..63 (bit s%32), the Pallas tape layout exactly;
//     radix 4 writes [bp_w0, bp_w1, bg_w0, bg_w1] per double step.
//   * the tape (8.6 KB) and the staged soft symbols (4.3 KB) live in
//     shared memory; two warps per block keep it under the 48 KB static
//     limit with ~17 frames resident per SM, so 1280 frames are one wave
//     over 132 SMs.
//   * the INT_MAX reachability guard runs for the first 8 trellis steps
//     only (every state is reachable after 6).  It selects before it adds,
//     so no signed overflow can occur (undefined behaviour in C++).
//   * the end state is a warp min over metric*64 + state (lowest index
//     wins ties); one lane walks the tape back and the warp stores the
//     bits with coalesced 4-byte writes.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kStates = 64;
constexpr int kFrameBits = 1072;
constexpr int kEncBits = 2 * kFrameBits;
constexpr int kSoftMax = 7;
constexpr int kGuardSteps = 8;
constexpr int32_t kInf = 0x7FFFFFFF;
constexpr int32_t kGuard = 0x7FFFFFF0;
constexpr unsigned kG1 = 0x4F;
constexpr unsigned kG2 = 0x6D;
constexpr int kWarps = 2;                 // frames per block
constexpr unsigned kFull = 0xffffffffu;

// expected (g1, g2) bit of the transition into state s from parent s>>1
__device__ __forceinline__ int exp_g1(int s) {
  return __popc(((((unsigned)s & 1u) << 6) | ((unsigned)s >> 1)) & kG1) & 1;
}
__device__ __forceinline__ int exp_g2(int s) {
  return __popc(((((unsigned)s & 1u) << 6) | ((unsigned)s >> 1)) & kG2) & 1;
}
__device__ __forceinline__ int bmv(int e, int sg) { return e ? kSoftMax - sg : sg; }

template <bool kGuarded>
__device__ __forceinline__ int32_t add_metric(int32_t m, int32_t bm) {
  if (kGuarded) return m < kGuard ? m + bm : kInf;
  return m + bm;
}

// One radix-2 step for both of this lane's states.
template <bool kGuarded>
__device__ __forceinline__ void acs2(int32_t& m_lo, int32_t& m_hi, int sg1, int sg2,
                                     int srcA, int srcB, int eA1, int eA2, int eB1,
                                     int eB2, unsigned& w0, unsigned& w1) {
  const int32_t a_lo = __shfl_sync(kFull, m_lo, srcA);   // state l>>1
  const int32_t a_hi = __shfl_sync(kFull, m_hi, srcA);   // state (l>>1)+32
  const int32_t b_lo = __shfl_sync(kFull, m_lo, srcB);   // state 16+(l>>1)
  const int32_t b_hi = __shfl_sync(kFull, m_hi, srcB);   // state 48+(l>>1)
  // g1 has trellis bit 5 clear and g2 has it set, so for parent p0+32 the
  // expected g1 bit is unchanged and the g2 bit flips: bm1 = a - b + 7
  int a = bmv(eA1, sg1), b = bmv(eA2, sg2);
  int32_t m0 = add_metric<kGuarded>(a_lo, a + b);
  int32_t m1 = add_metric<kGuarded>(a_hi, a - b + kSoftMax);
  const bool d_lo = m1 < m0;                             // ties -> p0
  const int32_t n_lo = d_lo ? m1 : m0;
  a = bmv(eB1, sg1);
  b = bmv(eB2, sg2);
  m0 = add_metric<kGuarded>(b_lo, a + b);
  m1 = add_metric<kGuarded>(b_hi, a - b + kSoftMax);
  const bool d_hi = m1 < m0;
  m_hi = d_hi ? m1 : m0;
  m_lo = n_lo;
  w0 = __ballot_sync(kFull, d_lo);
  w1 = __ballot_sync(kFull, d_hi);
}

// Per-state constants of a radix-4 fused double step into final state s.
struct R4State {
  int e1b, e2b;     // second step, via parent s>>1
  int e1a0, e2a0;   // first step into p = s>>1        (bp = 0)
  int e1a1, e2a1;   // first step into p = (s>>1) + 32 (bp = 1)
  __device__ explicit R4State(int s)
      : e1b(exp_g1(s)), e2b(exp_g2(s)), e1a0(exp_g1(s >> 1)), e2a0(exp_g2(s >> 1)),
        e1a1(exp_g1((s >> 1) + 32)), e2a1(exp_g2((s >> 1) + 32)) {}
};

// m00, m01, m10, m11: metrics of grandparents (s>>2) + 16*bp + 32*bg.
template <bool kGuarded>
__device__ __forceinline__ int32_t acs4(const R4State& k, int32_t m00, int32_t m01,
                                        int32_t m10, int32_t m11, int sg1a, int sg2a,
                                        int sg1b, int sg2b, bool& bp, bool& bg) {
  const int a2 = bmv(k.e1b, sg1b), b2 = bmv(k.e2b, sg2b);
  const int bmB0 = a2 + b2, bmB1 = a2 - b2 + kSoftMax;
  const int a10 = bmv(k.e1a0, sg1a), b10 = bmv(k.e2a0, sg2a);
  const int a11 = bmv(k.e1a1, sg1a), b11 = bmv(k.e2a1, sg2a);
  const int32_t c00 = add_metric<kGuarded>(m00, bmB0 + a10 + b10);
  const int32_t c01 = add_metric<kGuarded>(m01, bmB0 + a10 - b10 + kSoftMax);
  const int32_t c10 = add_metric<kGuarded>(m10, bmB1 + a11 + b11);
  const int32_t c11 = add_metric<kGuarded>(m11, bmB1 + a11 - b11 + kSoftMax);
  const bool dga = c01 < c00;               // bg within bp = 0
  const int32_t va = dga ? c01 : c00;
  const bool dgb = c11 < c10;               // bg within bp = 1
  const int32_t vb = dgb ? c11 : c10;
  bp = vb < va;                             // ties -> bp = 0
  bg = bp ? dgb : dga;
  return bp ? vb : va;
}

template <int kRadix>
__global__ void __launch_bounds__(32 * kWarps)
viterbi_kernel(const int32_t* __restrict__ soft, uint8_t* __restrict__ bits,
               int32_t* __restrict__ metrics, int batch) {
  constexpr int kSteps = kFrameBits / (kRadix / 2);   // serial iterations
  constexpr int kWords = kRadix;                      // survivor words per iteration
  __shared__ uint32_t tape_s[kWarps][kSteps * kWords];
  __shared__ __align__(16) int16_t soft_s[kWarps][kEncBits];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int frame = blockIdx.x * kWarps + warp;
  if (frame >= batch) return;                         // whole warps only
  uint32_t* tape = tape_s[warp];
  int16_t* sv = soft_s[warp];
  const int32_t* src = soft + (size_t)frame * kEncBits;
  for (int i = lane; i < kEncBits; i += 32) sv[i] = (int16_t)src[i];
  __syncwarp();

  int32_t m_lo = lane == 0 ? 0 : kInf, m_hi = kInf;
  if constexpr (kRadix == 2) {
    const int srcA = lane >> 1, srcB = 16 + (lane >> 1);
    const int eA1 = exp_g1(lane), eA2 = exp_g2(lane);
    const int eB1 = exp_g1(lane + 32), eB2 = exp_g2(lane + 32);
    const uint32_t* sw = reinterpret_cast<const uint32_t*>(sv);
    for (int t = 0; t < kFrameBits; ++t) {
      const uint32_t p = sw[t];                       // (g1, g2) of step t
      const int sg1 = (int16_t)(p & 0xffffu), sg2 = (int16_t)(p >> 16);
      unsigned w0, w1;
      if (t < kGuardSteps)
        acs2<true>(m_lo, m_hi, sg1, sg2, srcA, srcB, eA1, eA2, eB1, eB2, w0, w1);
      else
        acs2<false>(m_lo, m_hi, sg1, sg2, srcA, srcB, eA1, eA2, eB1, eB2, w0, w1);
      if (lane < 2) tape[2 * t + lane] = lane ? w1 : w0;
    }
  } else {
    const R4State klo(lane), khi(lane + 32);
    const int qa = lane >> 2, qc = 8 + (lane >> 2);
    const uint2* sw = reinterpret_cast<const uint2*>(sv);
    for (int d = 0; d < kSteps; ++d) {
      const uint2 p = sw[d];                          // (g1a, g2a, g1b, g2b)
      const int sg1a = (int16_t)(p.x & 0xffffu), sg2a = (int16_t)(p.x >> 16);
      const int sg1b = (int16_t)(p.y & 0xffffu), sg2b = (int16_t)(p.y >> 16);
      // grandparent g = q + 16*bp + 32*bg: bp picks lane q or q+16, bg the
      // lo (g < 32) or hi half of that lane
      const int32_t A_lo = __shfl_sync(kFull, m_lo, qa), A_hi = __shfl_sync(kFull, m_hi, qa);
      const int32_t B_lo = __shfl_sync(kFull, m_lo, qa + 16);
      const int32_t B_hi = __shfl_sync(kFull, m_hi, qa + 16);
      const int32_t C_lo = __shfl_sync(kFull, m_lo, qc), C_hi = __shfl_sync(kFull, m_hi, qc);
      const int32_t D_lo = __shfl_sync(kFull, m_lo, qc + 16);
      const int32_t D_hi = __shfl_sync(kFull, m_hi, qc + 16);
      bool bp_lo, bg_lo, bp_hi, bg_hi;
      int32_t n_lo, n_hi;
      if (d < kGuardSteps / 2) {
        n_lo = acs4<true>(klo, A_lo, A_hi, B_lo, B_hi, sg1a, sg2a, sg1b, sg2b, bp_lo, bg_lo);
        n_hi = acs4<true>(khi, C_lo, C_hi, D_lo, D_hi, sg1a, sg2a, sg1b, sg2b, bp_hi, bg_hi);
      } else {
        n_lo = acs4<false>(klo, A_lo, A_hi, B_lo, B_hi, sg1a, sg2a, sg1b, sg2b, bp_lo, bg_lo);
        n_hi = acs4<false>(khi, C_lo, C_hi, D_lo, D_hi, sg1a, sg2a, sg1b, sg2b, bp_hi, bg_hi);
      }
      m_lo = n_lo;
      m_hi = n_hi;
      const unsigned wp0 = __ballot_sync(kFull, bp_lo), wp1 = __ballot_sync(kFull, bp_hi);
      const unsigned wg0 = __ballot_sync(kFull, bg_lo), wg1 = __ballot_sync(kFull, bg_hi);
      if (lane < 4) tape[4 * d + lane] = lane == 0 ? wp0 : lane == 1 ? wp1 : lane == 2 ? wg0 : wg1;
    }
  }

  // end state: lowest-index state of minimum metric
  const int32_t key = min(m_lo * kStates + lane, m_hi * kStates + lane + 32);
  const int32_t best = __reduce_min_sync(kFull, key);
  __syncwarp();                                       // tape and soft reads done
  uint8_t* bs = reinterpret_cast<uint8_t*>(sv);       // reuse the soft staging
  if (lane == 0) {
    metrics[frame] = best >> 6;
    int s = best & 63;
    if constexpr (kRadix == 2) {
      for (int t = kFrameBits - 1; t >= 0; --t) {
        bs[t] = (uint8_t)(s & 1);
        const uint32_t w = tape[2 * t + (s >> 5)];
        s = (s >> 1) + (int)((w >> (s & 31)) & 1u) * 32;
      }
    } else {
      for (int d = kSteps - 1; d >= 0; --d) {
        bs[2 * d + 1] = (uint8_t)(s & 1);
        const uint32_t wp = tape[4 * d + (s >> 5)];
        const uint32_t wg = tape[4 * d + 2 + (s >> 5)];
        const int p = (s >> 1) + (int)((wp >> (s & 31)) & 1u) * 32;
        bs[2 * d] = (uint8_t)(p & 1);
        s = (p >> 1) + (int)((wg >> (s & 31)) & 1u) * 32;
      }
    }
  }
  __syncwarp();
  const uint32_t* bw = reinterpret_cast<const uint32_t*>(bs);
  uint32_t* dst = reinterpret_cast<uint32_t*>(bits + (size_t)frame * kFrameBits);
  for (int i = lane; i < kFrameBits / 4; i += 32) dst[i] = bw[i];
}

}  // namespace

// soft (batch, 2144) int32, bits (batch, 1072) uint8, metrics (batch,) int32,
// all contiguous on the device of `stream`.  Returns cudaGetLastError().
extern "C" int opv_viterbi(const void* soft, void* bits, void* metrics, int batch,
                           int radix, void* stream) {
  if (batch <= 0) return 0;
  const dim3 grid((batch + kWarps - 1) / kWarps), block(32 * kWarps);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* s = static_cast<const int32_t*>(soft);
  uint8_t* b = static_cast<uint8_t*>(bits);
  int32_t* m = static_cast<int32_t*>(metrics);
  if (radix == 4)
    viterbi_kernel<4><<<grid, block, 0, st>>>(s, b, m, batch);
  else if (radix == 2)
    viterbi_kernel<2><<<grid, block, 0, st>>>(s, b, m, batch);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" const char* opv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
