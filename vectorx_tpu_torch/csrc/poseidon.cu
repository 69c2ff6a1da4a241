// Poseidon permutation over Goldilocks (width 12, x^7) for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` of vectorx_tpu/ops/poseidon_pallas.py
// (launched by permute_tiles / permute). Same arithmetic: 4 full rounds,
// 22 partial rounds in the Appendix-B sparse form (one lane-0 S-box, a
// 12-term row dot into lane 0, an 11-term column scatter), one dense 12x12
// D matvec closing the chain, 4 full rounds. The full-round MDS is the
// power-of-two circulant, applied by shifts.
//
// Design: one thread per permutation. The state is twelve uint64 registers,
// read and written row-major from a (B, 12) uint64 array (no transpose).
// Round constants, the sparse row/column tables, D and the MDS shift
// amounts sit in __constant__ memory; every thread of a warp reads the same
// entry, so the constant cache broadcasts it. 64x64 -> 128-bit products use
// __umul64hi followed by the epsilon-fold reduction.
//
// Bound: the ALU. A permutation does ~1,100 64-bit modular products against
// 192 bytes of device-memory traffic.
//
// Reduction is lazy: every intermediate is a 64-bit value congruent mod p
// (it may lie in [p, 2^64)); one canonicalize at the end. Adding two such
// values can carry twice (the hazard of the TPU kernel's _add_lazy2), and
// add_lazy folds both carries.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint64_t kP = 0xFFFFFFFF00000001ull;
constexpr uint64_t kEps = 0xFFFFFFFFull;  // 2^64 mod p
constexpr int kWidth = 12;
constexpr int kHalfFull = 4;
constexpr int kPartial = 22;
constexpr int kRounds = 30;

__constant__ uint64_t c_rc[kRounds][kWidth];     // L folded into row 26
__constant__ uint64_t c_prow[kPartial][kWidth];  // sparse row dot
__constant__ uint64_t c_pcol[kPartial][kWidth];  // a_i | column scatter
__constant__ uint64_t c_d[kWidth][kWidth];       // dense closing matrix
__constant__ uint32_t c_shift[kWidth][kWidth];   // log2 of the MDS entries

// (lo + hi * 2^64) mod p, as a 64-bit value (lazy: may be >= p).
__device__ __forceinline__ uint64_t reduce128(uint64_t lo, uint64_t hi) {
  const uint64_t n2 = hi & kEps;
  const uint64_t n3 = hi >> 32;
  uint64_t t0 = lo - n3;            // 2^96 = -1
  if (lo < n3) t0 -= kEps;          // borrow: +p = -eps (mod 2^64)
  const uint64_t t1 = n2 * kEps;    // 2^64 = eps; < 2^64
  uint64_t r = t0 + t1;
  if (r < t1) r += kEps;            // carry: cannot carry again
  return r;
}

__device__ __forceinline__ uint64_t mul_lazy(uint64_t a, uint64_t b) {
  return reduce128(a * b, __umul64hi(a, b));
}

// Exact for any two 64-bit operands: a carry-out is worth eps; adding eps
// can carry once more, and that second fold cannot carry.
__device__ __forceinline__ uint64_t add_lazy(uint64_t a, uint64_t b) {
  uint64_t s = a + b;
  if (s < a) {
    s += kEps;
    if (s < kEps) s += kEps;
  }
  return s;
}

__device__ __forceinline__ uint64_t canonical(uint64_t x) {
  return x >= kP ? x - kP : x;
}

__device__ __forceinline__ uint64_t sbox(uint64_t x) {
  const uint64_t x2 = mul_lazy(x, x);
  const uint64_t x3 = mul_lazy(x2, x);
  const uint64_t x6 = mul_lazy(x3, x3);
  return mul_lazy(x6, x);
}

// out_i = sum_j 2^shift[i][j] * s_j: each term is at most 80 bits, split
// into a low word and the bits shifted past 2^64; the twelve-term sum keeps
// a 128-bit accumulator and reduces once.
__device__ __forceinline__ void mds(uint64_t s[kWidth]) {
  uint64_t out[kWidth];
#pragma unroll
  for (int i = 0; i < kWidth; ++i) {
    uint64_t lo = 0, hi = 0;
#pragma unroll
    for (int j = 0; j < kWidth; ++j) {
      const uint32_t k = c_shift[i][j];
      const uint64_t tl = s[j] << k;
      const uint64_t th = k ? (s[j] >> (64 - k)) : 0;
      lo += tl;
      hi += th + (lo < tl ? 1 : 0);
    }
    out[i] = reduce128(lo, hi);
  }
#pragma unroll
  for (int i = 0; i < kWidth; ++i) s[i] = out[i];
}

__device__ __forceinline__ void full_round(uint64_t s[kWidth], int r) {
#pragma unroll
  for (int i = 0; i < kWidth; ++i) s[i] = sbox(add_lazy(s[i], c_rc[r][i]));
  mds(s);
}

// Sum of twelve lazy 64-bit values with a 128-bit accumulator, reduced once.
#define DOT12(TABLE, ROW, S, OUT)                               \
  do {                                                          \
    uint64_t lo_ = 0, hi_ = 0;                                  \
    _Pragma("unroll") for (int j_ = 0; j_ < kWidth; ++j_) {     \
      const uint64_t t_ = mul_lazy(TABLE[ROW][j_], S[j_]);      \
      lo_ += t_;                                                \
      hi_ += (lo_ < t_ ? 1 : 0);                                \
    }                                                           \
    OUT = reduce128(lo_, hi_);                                  \
  } while (0)

__global__ void poseidon_permute_kernel(const uint64_t* __restrict__ in,
                                        uint64_t* __restrict__ out,
                                        int64_t n) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n) return;
  uint64_t s[kWidth];
  const uint64_t* src = in + t * kWidth;
#pragma unroll
  for (int i = 0; i < kWidth; ++i) s[i] = src[i];

#pragma unroll 1
  for (int r = 0; r < kHalfFull; ++r) full_round(s, r);

#pragma unroll 1
  for (int i = 0; i < kPartial; ++i) {
    const uint64_t s0 = sbox(add_lazy(s[0], c_pcol[i][0]));
    uint64_t row_in[kWidth];
    row_in[0] = s0;
#pragma unroll
    for (int j = 1; j < kWidth; ++j) row_in[j] = s[j];
    uint64_t out0;
    DOT12(c_prow, i, row_in, out0);
#pragma unroll
    for (int j = 1; j < kWidth; ++j)
      s[j] = add_lazy(s[j], mul_lazy(s0, c_pcol[i][j]));
    s[0] = out0;
  }

  {
    uint64_t d[kWidth];
#pragma unroll
    for (int i = 0; i < kWidth; ++i) DOT12(c_d, i, s, d[i]);
#pragma unroll
    for (int i = 0; i < kWidth; ++i) s[i] = d[i];
  }

#pragma unroll 1
  for (int r = kRounds - kHalfFull; r < kRounds; ++r) full_round(s, r);

  uint64_t* dst = out + t * kWidth;
#pragma unroll
  for (int i = 0; i < kWidth; ++i) dst[i] = canonical(s[i]);
}

}  // namespace

extern "C" {

// Host pointers to the tables of vectorx_tpu_torch/hashes/poseidon.py,
// uploaded to the current device's constant memory.
int vx_poseidon_set_constants(const uint64_t* rc, const uint64_t* prow,
                              const uint64_t* pcol, const uint64_t* d,
                              const uint32_t* shift) {
  cudaError_t e;
  if ((e = cudaMemcpyToSymbol(c_rc, rc, sizeof(c_rc))) != cudaSuccess) return e;
  if ((e = cudaMemcpyToSymbol(c_prow, prow, sizeof(c_prow))) != cudaSuccess) return e;
  if ((e = cudaMemcpyToSymbol(c_pcol, pcol, sizeof(c_pcol))) != cudaSuccess) return e;
  if ((e = cudaMemcpyToSymbol(c_d, d, sizeof(c_d))) != cudaSuccess) return e;
  return cudaMemcpyToSymbol(c_shift, shift, sizeof(c_shift));
}

// in/out: device arrays of n * 12 uint64; launches on `stream`.
int vx_poseidon_permute(const uint64_t* in, uint64_t* out, int64_t n,
                        void* stream) {
  constexpr int kThreads = 128;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  poseidon_permute_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(in, out, n);
  return cudaGetLastError();
}

}  // extern "C"
