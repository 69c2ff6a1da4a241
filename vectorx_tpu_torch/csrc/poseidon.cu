// Poseidon over Goldilocks (width 12, x^7) for Hopper (sm_90a): three
// entries over one arithmetic core.
//
// Replaces the TPU kernel `_kernel` of vectorx_tpu/ops/poseidon_pallas.py
// (launched by permute_tiles / permute). Same arithmetic: 4 full rounds,
// 22 partial rounds in the Appendix-B sparse form (one lane-0 S-box, a
// 12-term row dot into lane 0, an 11-term column scatter), one dense 12x12
// D matvec closing the chain, 4 full rounds. The full-round MDS is the
// power-of-two circulant; its exponents are baked into this source
// (VX_MDS_ROW) and the wrapper checks them against the Python table.
//
// What bounds it on this card, and what each entry does about it:
//
//   permute (thread per state) -- the INT32 instruction rate. A
//     permutation is 1,122 64x64 -> 128-bit modular products plus 1,152 MDS
//     terms against 192 bytes of device memory. The state is twelve uint64 registers; the
//     tables sit in __constant__ memory (a warp reads one entry, the cache
//     broadcasts it). What it saves is instructions: the MDS is one wide
//     multiply-add per 32-bit half of a state word, into two 64-bit
//     accumulators that cannot carry (< 2^52), with one fold per output
//     word; the twelve-term dots sum their unreduced products and reduce
//     once; the column scatter is one product, one add, one reduction.
//
//   duplex / the cooperative kernels (a 16-lane group per state) -- the
//     time of one dependent chain. A transcript absorbs one 8-element
//     chunk per permutation and each permutation needs the last one's
//     state, so one thread would run ~1,100 products in series. Here a
//     state word lives in each of 12 lanes: the twelve S-boxes of a full
//     round run side by side, the MDS and the dense D gather words with
//     __shfl_sync, the partial rounds' S-box is computed by every lane
//     (no broadcast), their row dot is one product per lane and a
//     butterfly sum that leaves the next word 0 on every lane. The whole
//     chain of absorbs and squeezes runs inside one launch with the state
//     in registers. Tables are staged into shared memory, where lanes read
//     neighbouring words without conflict. What is left is the lone warp's
//     own instruction stream (~7,000 instructions a permutation).
//
//   sponge_rows (thread per row) -- the INT32 rate, as permute. All chunks
//     of a row are absorbed in one launch with the state in registers; the
//     matrix is read through its strides, so a column-major (w, n) LDE is
//     read with neighbouring threads on neighbouring addresses and nothing
//     is transposed, concatenated or written but the (n, 4) digests.
//
// Reduction is lazy: every intermediate is a 64-bit value congruent mod p
// (it may lie in [p, 2^64)); one canonicalize where a value leaves the
// registers. Adding two such values can carry twice (the hazard of the
// TPU kernel's _add_lazy2), and add_lazy folds both carries; sums of more
// terms keep a (low word, carry count) pair and reduce once.

#include <cstdint>
#include <cuda_runtime.h>

// Resident 128-thread blocks per SM that each thread-per-state kernel asks
// the compiler to make room for (registers per thread <= 65536 / (128 * k)).
// The defaults are the fastest of k = 1..4 on an H100, as measured by
// ops/poseidon_variants.py.
#ifndef VX_PERMUTE_MIN_BLOCKS
#define VX_PERMUTE_MIN_BLOCKS 3
#endif
#ifndef VX_SPONGE_MIN_BLOCKS
#define VX_SPONGE_MIN_BLOCKS 2
#endif

namespace {

constexpr uint64_t kP = 0xFFFFFFFF00000001ull;
constexpr uint64_t kEps = 0xFFFFFFFFull;  // 2^64 mod p
constexpr int kWidth = 12;
constexpr int kRate = 8;
constexpr int kDigest = 4;
constexpr int kHalfFull = 4;
constexpr int kPartial = 22;
constexpr int kRounds = 30;
constexpr int kThreads = 128;
constexpr int kGroup = 16;               // lanes per cooperative state
constexpr unsigned kFullMask = 0xFFFFFFFFu;

// X(d, k): the MDS entry M[i][(i + d) mod 12] is 2^k.
#define VX_MDS_ROW(X)                                                     \
  X(0, 0) X(1, 0) X(2, 1) X(3, 0) X(4, 3) X(5, 5) X(6, 1) X(7, 8)         \
  X(8, 12) X(9, 3) X(10, 16) X(11, 10)

__constant__ uint64_t c_rc[kRounds][kWidth];     // L folded into row 26
__constant__ uint64_t c_prow[kPartial][kWidth];  // sparse row dot
__constant__ uint64_t c_pcol[kPartial][kWidth];  // a_i | column scatter
__constant__ uint64_t c_d[kWidth][kWidth];       // dense closing matrix

// The same tables for the cooperative kernels, which index them per lane:
// rc | prow | pcol | D transposed, staged into shared memory by each block.
constexpr int kOffRc = 0;
constexpr int kOffProw = kOffRc + kRounds * kWidth;
constexpr int kOffPcol = kOffProw + kPartial * kWidth;
constexpr int kOffDt = kOffPcol + kPartial * kWidth;
constexpr int kTableWords = kOffDt + kWidth * kWidth;
__device__ uint64_t g_tables[kTableWords];

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

// a * b + c (mod p), lazy, for any 64-bit operands: the product's high
// word is at most 2^64 - 2, so the carry of the low word fits.
__device__ __forceinline__ uint64_t mul_add_lazy(uint64_t a, uint64_t b,
                                                 uint64_t c) {
  uint64_t lo = a * b, hi = __umul64hi(a, b);
  asm("add.cc.u64 %0, %0, %2;\n\taddc.u64 %1, %1, 0;"
      : "+l"(lo), "+l"(hi) : "l"(c));
  return reduce128(lo, hi);
}

// acc += v, its carry-out counted in `carries` (the carry flag, no compare).
__device__ __forceinline__ void add_carry(uint64_t& acc, uint32_t& carries,
                                          uint64_t v) {
  asm("add.cc.u64 %0, %0, %2;\n\taddc.u32 %1, %1, 0;"
      : "+l"(acc), "+r"(carries) : "l"(v));
}

// A sum of up to 2^32 products a * b, kept unreduced: the low and the high
// words are summed apart, each with its carry count; one reduction at the
// end instead of one per product.
struct DotAcc {
  uint64_t lo = 0, hi = 0;
  uint32_t clo = 0, chi = 0;
};

__device__ __forceinline__ void dot_add(DotAcc& acc, uint64_t a, uint64_t b) {
  add_carry(acc.lo, acc.clo, a * b);
  add_carry(acc.hi, acc.chi, __umul64hi(a, b));
}

// lo + clo 2^64 + (hi + chi 2^64) 2^64 (mod p), lazy.
__device__ __forceinline__ uint64_t dot_reduce(const DotAcc& acc) {
  const uint64_t h = reduce128(acc.hi, acc.chi);
  return add_lazy(reduce128(acc.lo, h), static_cast<uint64_t>(acc.clo) * kEps);
}

// acc += a * b, 32 x 32 -> 64 bits: one wide multiply-add.
__device__ __forceinline__ void mad_wide(uint64_t& acc, uint32_t a, uint32_t b) {
  asm("mad.wide.u32 %0, %1, %2, %0;" : "+l"(acc) : "r"(a), "r"(b));
}

__device__ __forceinline__ uint64_t canonical(uint64_t x) {
  return x >= kP ? x - kP : x;
}

// x^7 in four products. (x^4 * x^3, five products and three deep, was
// tried in the cooperative kernels and was slower: a lone warp is bound by
// its instruction count as much as by depth.)
__device__ __forceinline__ uint64_t sbox(uint64_t x) {
  const uint64_t x2 = mul_lazy(x, x);
  const uint64_t x3 = mul_lazy(x2, x);
  const uint64_t x6 = mul_lazy(x3, x3);
  return mul_lazy(x6, x);
}

// alo + ahi * 2^32 (mod p) for the MDS accumulators: alo sums the low
// halves times 2^k, ahi the high halves; twelve terms below 2^48 each, so
// neither can carry.
__device__ __forceinline__ uint64_t mds_fold(uint64_t alo, uint64_t ahi) {
  const uint64_t lo = alo + (ahi << 32);
  const uint64_t hi = (ahi >> 32) + (lo < alo ? 1 : 0);
  return reduce128(lo, hi);
}

#define VX_MDS_ACC(V, K)                                          \
  do {                                                            \
    mad_wide(alo, static_cast<uint32_t>(V), 1u << (K));           \
    mad_wide(ahi, static_cast<uint32_t>((V) >> 32), 1u << (K));   \
  } while (0);

// ---------------------------------------------------------------------------
// Thread-per-state core
// ---------------------------------------------------------------------------

// out_i = sum_d 2^k(d) * s_{(i + d) mod 12}, the powers as immediates.
__device__ __forceinline__ void mds(uint64_t s[kWidth]) {
  uint64_t out[kWidth];
#pragma unroll
  for (int i = 0; i < kWidth; ++i) {
    uint64_t alo = 0, ahi = 0;
#define VX_TERM(D, K) VX_MDS_ACC(s[(i + (D)) % kWidth], K)
    VX_MDS_ROW(VX_TERM)
#undef VX_TERM
    out[i] = mds_fold(alo, ahi);
  }
#pragma unroll
  for (int i = 0; i < kWidth; ++i) s[i] = out[i];
}

__device__ __forceinline__ void full_round(uint64_t s[kWidth], int r) {
#pragma unroll
  for (int i = 0; i < kWidth; ++i) s[i] = sbox(add_lazy(s[i], c_rc[r][i]));
  mds(s);
}

// Twelve-term dot of a table row with the state, reduced once.
#define DOT12(TABLE, ROW, S, OUT)                               \
  do {                                                          \
    DotAcc acc_;                                                \
    _Pragma("unroll") for (int j_ = 0; j_ < kWidth; ++j_)       \
      dot_add(acc_, TABLE[ROW][j_], S[j_]);                     \
    OUT = dot_reduce(acc_);                                     \
  } while (0)

// One permutation of the twelve registers; the result is lazy.
__device__ __forceinline__ void permute_thread(uint64_t s[kWidth]) {
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
      s[j] = mul_add_lazy(s0, c_pcol[i][j], s[j]);
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
}

// Entry `permute`, large batches: (n, 12) -> (n, 12), rows read in place.
__global__ void __launch_bounds__(kThreads, VX_PERMUTE_MIN_BLOCKS)
permute_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
               int64_t n) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n) return;
  uint64_t s[kWidth];
  const uint64_t* src = in + t * kWidth;
#pragma unroll
  for (int i = 0; i < kWidth; ++i) s[i] = src[i];
  permute_thread(s);
  uint64_t* dst = out + t * kWidth;
#pragma unroll
  for (int i = 0; i < kWidth; ++i) dst[i] = canonical(s[i]);
}

// Entry `sponge_rows`, many rows: element (t, c) of the (n, w) matrix is
// src[t * stride_n + c * stride_w]; row t is absorbed in overwrite mode,
// eight elements per permutation, the last chunk padded with zeros; the
// first four state words are its digest.
__global__ void __launch_bounds__(kThreads, VX_SPONGE_MIN_BLOCKS)
sponge_rows_kernel(const uint64_t* __restrict__ src, int64_t n, int64_t w,
                   int64_t stride_n, int64_t stride_w,
                   uint64_t* __restrict__ out) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const uint64_t* row = src + t * stride_n;
  uint64_t s[kWidth];
#pragma unroll
  for (int i = 0; i < kWidth; ++i) s[i] = 0;
#pragma unroll 1
  for (int64_t c0 = 0; c0 < w; c0 += kRate) {
#pragma unroll
    for (int j = 0; j < kRate; ++j)
      s[j] = (c0 + j < w) ? row[(c0 + j) * stride_w] : 0;
    permute_thread(s);
  }
#pragma unroll
  for (int i = 0; i < kDigest; ++i) out[t * kDigest + i] = canonical(s[i]);
}

// ---------------------------------------------------------------------------
// Cooperative core: a state word per lane, 12 live lanes of a 16-lane group
// ---------------------------------------------------------------------------

// Every thread of the block copies its share of the tables; ends in a
// block-wide barrier.
__device__ __forceinline__ void stage_tables(uint64_t* T) {
  for (int i = threadIdx.x; i < kTableWords; i += blockDim.x)
    T[i] = g_tables[i];
  __syncthreads();
}

// Sum of the group's values (idle lanes pass 0) on every lane, reduced: a
// butterfly over (low word, carry count). (The hardware reduction
// __reduce_add_sync over 22-bit limbs was tried and was slower.)
__device__ __forceinline__ uint64_t group_sum(uint64_t t) {
  uint64_t lo = t;
  uint32_t carries = 0;
#pragma unroll
  for (int off = kGroup / 2; off >= 1; off >>= 1) {
    const uint64_t lo2 = __shfl_xor_sync(kFullMask, lo, off, kGroup);
    const uint32_t c2 = __shfl_xor_sync(kFullMask, carries, off, kGroup);
    lo += lo2;
    carries += c2 + (lo < lo2 ? 1u : 0u);
  }
  return reduce128(lo, carries);
}

// Lane `li` holds word li of the state in x (li = 11 on the idle lanes
// 12..15, whose values nothing reads).
__device__ __forceinline__ uint64_t coop_full_round(uint64_t x, int li,
                                                    const uint64_t* rc) {
  x = sbox(add_lazy(x, rc[li]));
  uint64_t alo = 0, ahi = 0;
#define VX_TERM(D, K)                                                       \
  {                                                                         \
    const int src_ = li + (D) < kWidth ? li + (D) : li + (D) - kWidth;      \
    const uint64_t v_ = __shfl_sync(kFullMask, x, src_, kGroup);            \
    VX_MDS_ACC(v_, K)                                                       \
  }
  VX_MDS_ROW(VX_TERM)
#undef VX_TERM
  return mds_fold(alo, ahi);
}

// One permutation of the group's state; the result is lazy. Every lane of
// the warp must call it.
__device__ __forceinline__ uint64_t permute_coop(uint64_t x, int li, bool live,
                                                 const uint64_t* T) {
#pragma unroll 1
  for (int r = 0; r < kHalfFull; ++r)
    x = coop_full_round(x, li, T + kOffRc + r * kWidth);

  // partial rounds: every lane carries word 0 beside its own word, so the
  // S-box needs no broadcast and the butterfly sum leaves the next word 0
  // on every lane
  uint64_t s0 = __shfl_sync(kFullMask, x, 0, kGroup);
#pragma unroll 1
  for (int i = 0; i < kPartial; ++i) {
    const uint64_t* prow = T + kOffProw + i * kWidth;
    const uint64_t* pcol = T + kOffPcol + i * kWidth;
    s0 = sbox(add_lazy(s0, pcol[0]));
    const uint64_t term = mul_lazy(prow[li], li == 0 ? s0 : x);
    const uint64_t out0 = group_sum(live ? term : 0);
    x = mul_add_lazy(s0, pcol[li], x);         // word 0's slot is dead here
    s0 = out0;
  }
  if (li == 0) x = s0;

  {
    DotAcc acc;
    const uint64_t* dt = T + kOffDt;
#pragma unroll
    for (int j = 0; j < kWidth; ++j)
      dot_add(acc, dt[j * kWidth + li], __shfl_sync(kFullMask, x, j, kGroup));
    x = dot_reduce(acc);
  }

#pragma unroll 1
  for (int r = kRounds - kHalfFull; r < kRounds; ++r)
    x = coop_full_round(x, li, T + kOffRc + r * kWidth);
  return x;
}

// Entry `duplex`: one transcript state through a chain of permutations in
// one launch. First n_absorb overwrite-mode absorbs of data[0:m] (chunk c
// overwrites words [0, min(8, m - 8c)), the rest keep their value, then
// permute); then ceil(n_squeeze / 8) squeezes (emit up to 8 words, then
// permute). One warp works; both of its groups run the same state.
__global__ void __launch_bounds__(kThreads)
duplex_kernel(const uint64_t* __restrict__ state_in,
              const uint64_t* __restrict__ data, int64_t m, int64_t n_absorb,
              uint64_t* __restrict__ state_out,
              uint64_t* __restrict__ squeezed, int64_t n_squeeze) {
  __shared__ uint64_t T[kTableWords];
  stage_tables(T);
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x & (kGroup - 1);
  const bool live = lane < kWidth;
  const int li = live ? lane : kWidth - 1;
  const bool rate_lane = lane < kRate;

  uint64_t x = state_in[li];
  uint64_t next = (rate_lane && lane < m) ? data[lane] : 0;
#pragma unroll 1
  for (int64_t c = 0; c < n_absorb; ++c) {
    if (rate_lane && c * kRate + lane < m) x = next;
    const int64_t ahead = (c + 1) * kRate + lane;
    next = (rate_lane && ahead < m) ? data[ahead] : 0;
    x = canonical(permute_coop(x, li, live, T));
  }
#pragma unroll 1
  for (int64_t q = 0; q * kRate < n_squeeze; ++q) {
    const int64_t idx = q * kRate + lane;
    if (threadIdx.x < kRate && idx < n_squeeze) squeezed[idx] = x;
    x = canonical(permute_coop(x, li, live, T));
  }
  if (threadIdx.x < kWidth) state_out[threadIdx.x] = x;
}

// Entry `permute`, small batches: group g permutes state g.
__global__ void __launch_bounds__(kThreads)
permute_coop_kernel(const uint64_t* __restrict__ in,
                    uint64_t* __restrict__ out, int64_t n) {
  __shared__ uint64_t T[kTableWords];
  stage_tables(T);
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if ((t & ~int64_t(31)) / kGroup >= n) return;       // a whole idle warp
  const int64_t g = t / kGroup;
  const int lane = threadIdx.x & (kGroup - 1);
  const bool live = lane < kWidth;
  const int li = live ? lane : kWidth - 1;
  const int64_t row = g < n ? g : n - 1;              // an idle group shadows
  uint64_t x = in[row * kWidth + li];
  x = canonical(permute_coop(x, li, live, T));
  if (g < n && live) out[g * kWidth + li] = x;
}

// Entry `sponge_rows`, few rows: group g absorbs row g (see
// sponge_rows_kernel for the layout and the padding).
__global__ void __launch_bounds__(kThreads)
sponge_rows_coop_kernel(const uint64_t* __restrict__ src, int64_t n, int64_t w,
                        int64_t stride_n, int64_t stride_w,
                        uint64_t* __restrict__ out) {
  __shared__ uint64_t T[kTableWords];
  stage_tables(T);
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if ((t & ~int64_t(31)) / kGroup >= n) return;
  const int64_t g = t / kGroup;
  const int lane = threadIdx.x & (kGroup - 1);
  const bool live = lane < kWidth;
  const int li = live ? lane : kWidth - 1;
  const bool rate_lane = lane < kRate;
  const uint64_t* row = src + (g < n ? g : n - 1) * stride_n;

  uint64_t x = 0;
  uint64_t next = (rate_lane && lane < w) ? row[lane * stride_w] : 0;
#pragma unroll 1
  for (int64_t c0 = 0; c0 < w; c0 += kRate) {
    if (rate_lane) x = next;                 // zero past the row's end
    const int64_t ahead = c0 + kRate + lane;
    next = (rate_lane && ahead < w) ? row[ahead * stride_w] : 0;
    x = canonical(permute_coop(x, li, live, T));
  }
  if (g < n && lane < kDigest) out[g * kDigest + lane] = x;
}

inline unsigned blocks_for(int64_t threads) {
  return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// Host pointers to the tables of vectorx_tpu_torch/hashes/poseidon.py
// (d_t is d transposed), uploaded to the current device.
int vx_poseidon_set_constants(const uint64_t* rc, const uint64_t* prow,
                              const uint64_t* pcol, const uint64_t* d,
                              const uint64_t* d_t) {
  cudaError_t e;
  if ((e = cudaMemcpyToSymbol(c_rc, rc, sizeof(c_rc))) != cudaSuccess) return e;
  if ((e = cudaMemcpyToSymbol(c_prow, prow, sizeof(c_prow))) != cudaSuccess) return e;
  if ((e = cudaMemcpyToSymbol(c_pcol, pcol, sizeof(c_pcol))) != cudaSuccess) return e;
  if ((e = cudaMemcpyToSymbol(c_d, d, sizeof(c_d))) != cudaSuccess) return e;
  constexpr size_t W = sizeof(uint64_t);
  if ((e = cudaMemcpyToSymbol(g_tables, rc, sizeof(c_rc), kOffRc * W)) != cudaSuccess) return e;
  if ((e = cudaMemcpyToSymbol(g_tables, prow, sizeof(c_prow), kOffProw * W)) != cudaSuccess) return e;
  if ((e = cudaMemcpyToSymbol(g_tables, pcol, sizeof(c_pcol), kOffPcol * W)) != cudaSuccess) return e;
  return cudaMemcpyToSymbol(g_tables, d_t, sizeof(c_d), kOffDt * W);
}

// The baked MDS exponents: out[d] = log2 M[i][(i + d) mod 12].
void vx_poseidon_mds_shifts(int32_t* out) {
#define VX_PUT(D, K) out[D] = K;
  VX_MDS_ROW(VX_PUT)
#undef VX_PUT
}

// The launch bounds this library was built with: 100 * permute's + sponge's.
int vx_poseidon_min_blocks() {
  return 100 * VX_PERMUTE_MIN_BLOCKS + VX_SPONGE_MIN_BLOCKS;
}

// Every launcher below takes device pointers, launches on `stream` and
// returns cudaGetLastError().

// in/out: n * 12 uint64, a thread per state.
int vx_poseidon_permute(const uint64_t* in, uint64_t* out, int64_t n,
                        void* stream) {
  permute_kernel<<<blocks_for(n), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(in, out, n);
  return cudaGetLastError();
}

// in/out: n * 12 uint64, a 16-lane group per state.
int vx_poseidon_permute_coop(const uint64_t* in, uint64_t* out, int64_t n,
                             void* stream) {
  permute_coop_kernel<<<blocks_for(n * kGroup), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(in, out, n);
  return cudaGetLastError();
}

// state_in/state_out: 12 uint64; data: m uint64; squeezed: n_squeeze uint64.
int vx_poseidon_duplex(const uint64_t* state_in, const uint64_t* data,
                       int64_t m, int64_t n_absorb, uint64_t* state_out,
                       uint64_t* squeezed, int64_t n_squeeze, void* stream) {
  duplex_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      state_in, data, m, n_absorb, state_out, squeezed, n_squeeze);
  return cudaGetLastError();
}

// src: an (n, w) matrix through its element strides; out: n * 4 uint64.
int vx_poseidon_sponge_rows(const uint64_t* src, int64_t n, int64_t w,
                            int64_t stride_n, int64_t stride_w, uint64_t* out,
                            void* stream) {
  sponge_rows_kernel<<<blocks_for(n), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      src, n, w, stride_n, stride_w, out);
  return cudaGetLastError();
}

int vx_poseidon_sponge_rows_coop(const uint64_t* src, int64_t n, int64_t w,
                                 int64_t stride_n, int64_t stride_w,
                                 uint64_t* out, void* stream) {
  sponge_rows_coop_kernel<<<blocks_for(n * kGroup), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      src, n, w, stride_n, stride_w, out);
  return cudaGetLastError();
}

}  // extern "C"
