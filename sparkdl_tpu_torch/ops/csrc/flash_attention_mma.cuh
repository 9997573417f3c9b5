// Tensor-core building blocks shared by the flash-attention kernels
// (flash_attention_fwd.cu, flash_attention_bwd.cu) for Hopper (sm_90a):
// cp.async staging of padded row tiles, TF32 splits of f32 operands,
// mma.sync m16n8k8 TF32 fragments and accumulators, and paired stores.
// Each source that includes it is built into a library of its own.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// f32 operands are split in two TF32 values; bf16 ones are exact in TF32.
// A shared row is padded by 16 bytes.
template <typename T>
struct Elem;
template <>
struct Elem<float> {
  static constexpr bool kSplit = true;
  static constexpr int kPad = 4;
};
template <>
struct Elem<__nv_bfloat16> {
  static constexpr bool kSplit = false;
  static constexpr int kPad = 8;
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// ---------------------------------------------------------------- copies

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage rows row0 .. row0+ROWS-1 of one (seq, D) slice into a padded tile;
// rows at or past seq are zero-filled.
template <typename T, int D, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          int64_t row_stride, int row0,
                                          int seq) {
  constexpr int LD = D + Elem<T>::kPad;
  constexpr int PER = 16 / sizeof(T);  // elements per 16-byte piece
  constexpr int PIECES = ROWS * D / PER;
#pragma unroll
  for (int i = threadIdx.x; i < PIECES; i += THREADS) {
    const int r = i / (D / PER);
    const int c = (i % (D / PER)) * PER;
    const bool valid = row0 + r < seq;
    const T* from = valid ? src + (int64_t)(row0 + r) * row_stride + c : src;
    cp_async16(dst + r * LD + c, from, valid);
  }
}

// Stage ROWS floats of a (seq,) row; zero past seq.
template <int ROWS, int THREADS>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int row0, int seq) {
  for (int r = threadIdx.x; r < ROWS; r += THREADS) {
    const bool valid = row0 + r < seq;
    cp_async4(dst + r, valid ? src + row0 + r : src, valid);
  }
}

// ------------------------------------------------------------ fragments

// An m16k8 A operand and a k8n8 B operand, as TF32 values: hi, and lo where
// the operand is split (lo = 0 otherwise, and unused).
struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

// x = hi + lo as TF32 values, each rounded to nearest with ties away from
// zero, as cvt.rna.tf32.f32 rounds: add half of the 13 dropped mantissa bits
// to the magnitude, then drop them. hi is masked, since lo = x - hi needs its
// value; lo is not, since the mma ignores the 13 low bits of a TF32 operand.
// (cvt.rna.tf32.f32 itself compiles to a longer sequence that also handles
// NaN and infinity; the split is on the hot path of every product.)
template <bool SPLIT>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if (SPLIT) {
    hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
  } else {
    hi = __float_as_uint(x);  // a widened bf16 is a TF32 value
    lo = 0;
  }
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// N m16n8 accumulators. The small terms of split products, lo*hi' and
// hi*lo', go first and, with APART, into accumulators of their own; hi*hi'
// goes into c. The tensor cores round each mma's sum toward zero: the small
// sums stay about 2^-11 of c, so their roundings are negligible, and c takes
// one rounding per k-step where a shared accumulator takes three, which
// brings the kernels' error against float64 nearer the plain f32 version's.
// fold() adds them once, when the sum is complete. Without APART (where
// registers are short) the small terms go into c itself.
template <int N, bool APART>
struct Accum {
  static constexpr bool kApart = APART;
  float c[N][4];
  float lo[APART ? N : 1][4];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        c[i][e] = 0.f;
        if (APART) lo[i][e] = 0.f;
      }
  }

  // c[i] += a b
  template <bool SPLIT_A, bool SPLIT_B>
  __device__ __forceinline__ void mma(int i, const FragA& a, const FragB& b) {
    float(&small)[4] = APART ? lo[APART ? i : 0] : c[i];
    if (SPLIT_A) mma_tf32(small, a.lo, b.hi);
    if (SPLIT_B) mma_tf32(small, a.hi, b.lo);
    mma_tf32(c[i], a.hi, b.hi);
  }

  __device__ __forceinline__ void fold() {
    if (!APART) return;
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[i][e] += lo[i][e];
  }
};

// The output accumulators (O in the forward; dQ, dK and dV in the backward)
// keep their small terms apart up to head_dim 64. At 128, dK and dV alone
// take 128 registers a thread.
template <int D>
using OutAccum = Accum<D / 8, D <= 64>;

// A = X[row0 .. row0+15][col0 .. col0+7] of a row-major tile. Thread
// (g, t) = (lane / 4, lane % 4) holds rows g, g+8 and columns t, t+4.
template <typename T, bool SPLIT, int LD>
__device__ __forceinline__ FragA load_a(const T* x, int row0, int col0, int g,
                                        int t) {
  FragA f;
  const T* p = x + (row0 + g) * LD + col0 + t;
  split<SPLIT>(widen(p[0]), f.hi[0], f.lo[0]);
  split<SPLIT>(widen(p[8 * LD]), f.hi[1], f.lo[1]);
  split<SPLIT>(widen(p[4]), f.hi[2], f.lo[2]);
  split<SPLIT>(widen(p[8 * LD + 4]), f.hi[3], f.lo[3]);
  return f;
}

// B = X^T for rows n0 .. n0+7 and columns k0 .. k0+7 of a row-major X:
// B[k][n] = X[n0 + n][k0 + k]; thread (g, t) holds n = g, k = t and t+4.
template <typename T, bool SPLIT, int LD>
__device__ __forceinline__ FragB load_b_t(const T* x, int n0, int k0, int g,
                                          int t) {
  FragB f;
  const T* p = x + (n0 + g) * LD + k0 + t;
  split<SPLIT>(widen(p[0]), f.hi[0], f.lo[0]);
  split<SPLIT>(widen(p[4]), f.hi[1], f.lo[1]);
  return f;
}

// B = X[k0 .. k0+7][n0 .. n0+7] with its k rows permuted as acc_as_a permutes
// the A operand's columns: thread (g, t) holds n = g and rows 2t, 2t+1.
template <typename T, bool SPLIT, int LD>
__device__ __forceinline__ FragB load_b_perm(const T* x, int k0, int n0,
                                             int g, int t) {
  FragB f;
  const T* p = x + (k0 + 2 * t) * LD + n0 + g;
  split<SPLIT>(widen(p[0]), f.hi[0], f.lo[0]);
  split<SPLIT>(widen(p[LD]), f.hi[1], f.lo[1]);
  return f;
}

// An m16n8 accumulator (rows g, g+8; columns 2t, 2t+1) as an m16k8 A operand
// (columns t, t+4), split: column 2t plays k = t and 2t+1 plays k = t+4.
__device__ __forceinline__ FragA acc_as_a(const float (&c)[4]) {
  FragA f;
  split<true>(c[0], f.hi[0], f.lo[0]);
  split<true>(c[2], f.hi[1], f.lo[1]);
  split<true>(c[1], f.hi[2], f.lo[2]);
  split<true>(c[3], f.hi[3], f.lo[3]);
  return f;
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// cp.async copies rows in 16-byte pieces: the base and every stride of a
// dimension longer than 1 must keep them 16-byte aligned.
bool rows_aligned(const void* ptr, const int64_t* strides, int batch, int seq,
                  int heads, int itemsize) {
  if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return false;
  const int sizes[3] = {batch, seq, heads};
  for (int i = 0; i < 3; ++i)
    if (sizes[i] > 1 && (strides[i] * itemsize) % 16 != 0) return false;
  return true;
}

}  // namespace
