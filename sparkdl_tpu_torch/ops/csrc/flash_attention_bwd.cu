// Flash-attention backward for Hopper (sm_90a): tensor-core CUDA C++.
//
// Replaces the Pallas kernels `_dq_kernel` (flash_attention.py:115, called at
// :317; here flash_attention_bwd_dq) and `_dkv_kernel` (:161, called at :340;
// here flash_attention_bwd_dkv) of sparkdl_tpu/ops/flash_attention.py, the two
// halves of the custom VJP's `bwd`. With S = scale * Q K^T and the lse that
// the forward saved:
//
//   P  = exp(S - lse)   where kept, else 0
//   dS = P * (dO V^T - delta),   delta = rowsum(dO * O)   (computed outside)
//   dQ = scale * dS K,   dK = scale * dS^T Q,   dV = P^T dO
//
// A score is kept where its key is < kv_len and, when causal, not after its
// query. Inputs are (batch, seq, heads, head_dim) with any batch / seq / head
// strides that keep rows 16-byte aligned and a contiguous head_dim, so the
// q/k/v views of a fused qkv projection are read in place; lse and delta are
// contiguous (batch, heads, seq) float32; dQ, dK and dV are contiguous
// (batch, seq, heads, head_dim) tensors in the input type.
//
// Bound. At the ViT-B/16 shape (b=32, s=197, h=12, d=64), f32, dQ does
// 6*b*h*s^2*d = 5.7 GFLOP on 97 MB and dK/dV 8*b*h*s^2*d = 7.6 GFLOP on
// 117 MB: both are bound by operations. On the CUDA cores (67 TFLOP/s f32)
// that is 0.085 and 0.114 ms; done as split TF32 on the tensor cores, three
// TF32 products per f32 product at 495 TFLOP/s, it is 0.035 and 0.046 ms.
//
// Design.
// - Ownership as in the TPU design: a CTA owns a tile of gradient rows (a Q
//   tile in dQ, a K/V tile in dK/dV), walks the other operand's tiles in a
//   loop and writes its rows once. No atomics: every run gives the same bytes.
// - Products on the tensor cores with mma.sync m16n8k8 TF32, f32 accumulators
//   in registers; each warp owns 16 rows of its CTA's tile.
// - f32 accuracy from TF32 units: an f32 operand x is split into
//   hi = tf32(x) and lo = tf32(x - hi), and each product is computed as
//   lo*hi' + hi*lo' + hi*hi' (small terms first, into accumulators of their
//   own; see Accum), which leaves an error near f32's. bf16 inputs are exact
//   in TF32, so for them only P and dS (f32 in registers) are split; the
//   choice is made at compile time on the type.
// - P and dS never leave the registers. The m16n8 accumulator gives a thread
//   columns 2t and 2t+1 of its rows; the m16k8 A operand wants columns t and
//   t+4. A sum over keys (queries in dK/dV) does not care about their order,
//   so the accumulator is reused as the A operand under the permutation
//   k <-> {2t, 2t+1}, and the B operand's rows (K in dQ; dO and Q in dK/dV)
//   are read from shared memory under the same permutation. dK/dV computes
//   S^T = K Q^T directly, so P^T and dS^T come out as A operands as they are.
// - Streamed tiles (K/V in dQ; Q, dO and their lse / delta rows in dK/dV)
//   are staged by cp.async in 16-byte pieces, two stages deep, so the next
//   tile's copy overlaps this tile's products. Tiles keep the input type in
//   shared memory, rows padded by 16 bytes so that fragment reads hit 32
//   distinct banks and rows stay 16-byte aligned.
// - Padding is skipped at the mma's grain: a warp whose 16 rows all lie past
//   the sequence (or, in dK/dV, past kv_len) does no products, and an 8-wide
//   fragment of keys (queries) that is wholly masked is skipped. At s = 197
//   that is about 208 x 200 of work per head instead of 256 x 256. Rows past
//   the sequence are zero in shared memory; query rows past it add nothing to
//   dK/dV; keys past kv_len get zero gradients. Tiles with every score kept
//   run an instance of the tile body with no per-fragment tests.
// - wgmma is not used yet: for TF32 it takes both operands K-major, so
//   dV = P^T dO and dK = dS^T Q would need transposed copies of dO and Q.

#include "flash_attention_mma.cuh"

namespace {

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // (batch, heads, seq)
  const float* delta;  // (batch, heads, seq)
  void* dq;
  void* dk;
  void* dv;
  int64_t q_sb, q_ss, q_sh;  // element strides of batch, seq and head
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;  // of dout
  int seq;
  int heads;
  int kv_len;  // 1 <= kv_len <= seq
  int causal;
  float scale;
};

// Tile sizes per head_dim, from the sweep in PERF.md
// (python -m sparkdl_tpu_torch.ops.tile_sweep): rows per CTA and rows of each
// streamed tile, for dQ (Q rows, K/V tile) and for dK/dV (K/V rows, Q tile).
#ifdef FLASH_BWD_DQ_ROWS  // a sweep's build: the same tiles at every head_dim
template <int D>
struct Tiles {
  static constexpr int kDqRows = FLASH_BWD_DQ_ROWS, kDqKv = FLASH_BWD_DQ_KV;
  static constexpr int kDkvRows = FLASH_BWD_DKV_ROWS, kDkvQ = FLASH_BWD_DKV_Q;
};
#else
template <int D>
struct Tiles;
template <>
struct Tiles<32> {
  static constexpr int kDqRows = 32, kDqKv = 32, kDkvRows = 64, kDkvQ = 16;
};
template <>
struct Tiles<64> {
  static constexpr int kDqRows = 32, kDqKv = 16, kDkvRows = 64, kDkvQ = 16;
};
template <>
struct Tiles<128> {
  static constexpr int kDqRows = 64, kDqKv = 16, kDkvRows = 64, kDkvQ = 16;
};
#endif

// Write a warp's (16 x D) accumulators, rows row and row+8 of thread (g, t)
// at `row`, into a contiguous (batch, seq, heads, D) output, times mul; rows
// at or past seq are skipped.
template <typename T, int D>
__device__ __forceinline__ void store_rows(void* out, const Params& p, int b,
                                           int h, int row, int t,
                                           const float (&acc)[D / 8][4],
                                           float mul) {
  T* o = static_cast<T*>(out);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int pos = row + 8 * half;
    if (pos >= p.seq) continue;
    T* dst = o + (((int64_t)b * p.seq + pos) * p.heads + h) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      store2(dst + 8 * n, acc[n][2 * half] * mul, acc[n][2 * half + 1] * mul);
  }
}

// ---------------------------------------------------------------- kernels

// One K/V tile for a warp's 16 rows of dQ: S = Q K^T and dP = dO V^T over
// the key fragments [0, nf), dS = P (dP - delta) in place of S, dQ += dS K.
// FULL: a tile with every score of the warp kept, so nf = NF and nothing is
// tested per fragment or per score; edge tiles take the other instance.
template <typename T, int D, int BK, bool FULL>
__device__ __forceinline__ void dq_tile(OutAccum<D>& acc, const T* sQ,
                                        const T* sO, const float* sL,
                                        const float* sD, const T* cK,
                                        const T* cV, int wr, int qw,
                                        int k_start, int nf, const Params& p,
                                        int g, int t) {
  constexpr int LD = D + Elem<T>::kPad;
  constexpr bool S = Elem<T>::kSplit;
  constexpr int NF = BK / 8;  // key fragments per K/V tile
  constexpr int DF = D / 8;   // head_dim fragments
  Accum<NF, S> sa, dpa;
  sa.clear();
  dpa.clear();
#pragma unroll
  for (int kk = 0; kk < DF; ++kk) {
    const FragA qa = load_a<T, S, LD>(sQ, wr, 8 * kk, g, t);
    const FragA oa = load_a<T, S, LD>(sO, wr, 8 * kk, g, t);
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      if (FULL || j < nf) {
        const FragB kb = load_b_t<T, S, LD>(cK, 8 * j, 8 * kk, g, t);
        const FragB vb = load_b_t<T, S, LD>(cV, 8 * j, 8 * kk, g, t);
        sa.template mma<S, S>(j, qa, kb);
        dpa.template mma<S, S>(j, oa, vb);
      }
    }
  }
  sa.fold();
  dpa.fold();
  float(&s)[NF][4] = sa.c;
  const float(&dp)[NF][4] = dpa.c;

  // thread rows wr+g and wr+g+8
  const float lse[2] = {sL[wr + g], sL[wr + g + 8]};
  const float delta[2] = {sD[wr + g], sD[wr + g + 8]};
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    if (FULL || j < nf) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qpos = qw + g + 8 * (e >> 1);
        const int kpos = k_start + 8 * j + 2 * t + (e & 1);
        const bool keep =
            FULL || (kpos < p.kv_len && (!p.causal || qpos >= kpos));
        const float pv = keep ? expf(s[j][e] * p.scale - lse[e >> 1]) : 0.f;
        s[j][e] = pv * (dp[j][e] - delta[e >> 1]);
      }
    }
  }

  // dQ += dS K, dS straight from its registers
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    if (FULL || j < nf) {
      const FragA da = acc_as_a(s[j]);
#pragma unroll
      for (int n = 0; n < DF; ++n) {
        const FragB kb = load_b_perm<T, S, LD>(cK, 8 * j, 8 * n, g, t);
        acc.template mma<true, S>(n, da, kb);
      }
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(Tiles<D>::kDqRows / 16 * 32)
    flash_bwd_dq_kernel(Params p) {
  constexpr int BQ = Tiles<D>::kDqRows;
  constexpr int BK = Tiles<D>::kDqKv;
  constexpr int THREADS = BQ / 16 * 32;
  constexpr int LD = D + Elem<T>::kPad;
  constexpr int NF = BK / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);  // Q, resident
  T* sO = sQ + BQ * LD;                // dO, resident
  T* sK = sO + BQ * LD;                // K, two stages
  T* sV = sK + 2 * BK * LD;            // V, two stages
  float* sL = reinterpret_cast<float*>(sV + 2 * BK * LD);  // lse of the Q rows
  float* sD = sL + BQ;                                     // delta

  const int q_start = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wr = 16 * (threadIdx.x >> 5);  // the warp's first row in the tile
  const int qw = q_start + wr;             // ... in the sequence

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.o_sb + h * p.o_sh;
  const int64_t row_base = ((int64_t)b * p.heads + h) * p.seq;

  // K/V tiles wholly past kv_len, or wholly after this Q tile's last row
  // when causal, have P = 0 and add nothing
  int n_tiles = (p.kv_len + BK - 1) / BK;
  if (p.causal) n_tiles = min(n_tiles, (q_start + BQ - 1) / BK + 1);

  load_tile<T, D, BQ, THREADS>(sQ, q, p.q_ss, q_start, p.seq);
  load_tile<T, D, BQ, THREADS>(sO, dout, p.o_ss, q_start, p.seq);
  load_rows<BQ, THREADS>(sL, p.lse + row_base, q_start, p.seq);
  load_rows<BQ, THREADS>(sD, p.delta + row_base, q_start, p.seq);
  load_tile<T, D, BK, THREADS>(sK, k, p.k_ss, 0, p.seq);
  load_tile<T, D, BK, THREADS>(sV, v, p.v_ss, 0, p.seq);
  cp_async_commit();

  // keys at or past `limit` are masked for all 16 rows of this warp
  int limit = p.kv_len;
  if (p.causal) limit = min(limit, qw + 16);
  const bool active = qw < p.seq;

  OutAccum<D> acc;
  acc.clear();

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_tiles) {
      const int next = (it + 1) * BK;
      load_tile<T, D, BK, THREADS>(sK + (stage ^ 1) * BK * LD, k, p.k_ss, next, p.seq);
      load_tile<T, D, BK, THREADS>(sV + (stage ^ 1) * BK * LD, v, p.v_ss, next, p.seq);
    }
    cp_async_commit();
    cp_async_wait<1>();  // all but the copy just issued are done
    __syncthreads();

    const int k_start = it * BK;
    const T* cK = sK + stage * BK * LD;
    const T* cV = sV + stage * BK * LD;
    const int nf = limit > k_start ? min(NF, (limit - k_start + 7) / 8) : 0;
    // every key of the tile is kept for every row of the warp
    const bool full = k_start + BK <= p.kv_len &&
                      (!p.causal || k_start + BK - 1 <= qw);
    if (active && full)
      dq_tile<T, D, BK, true>(acc, sQ, sO, sL, sD, cK, cV, wr, qw, k_start, nf, p, g, t);
    else if (active && nf > 0)
      dq_tile<T, D, BK, false>(acc, sQ, sO, sL, sD, cK, cV, wr, qw, k_start, nf, p, g, t);
    __syncthreads();  // this stage is read; the next copy may overwrite it
  }
  cp_async_wait<0>();

  acc.fold();
  store_rows<T, D>(p.dq, p, b, h, qw + g, t, acc.c, p.scale);
}

// One Q tile for a warp's 16 keys of dK/dV: S^T = K Q^T and dP^T = V dO^T
// over the query fragments [jlo, jhi), P^T in place of S^T and dS^T in place
// of dP^T, dV += P^T dO and dK += dS^T Q. FULL: a tile with every score of
// the warp kept (jlo = 0, jhi = NF), with nothing tested per fragment or
// per score.
template <typename T, int D, int BQ, bool FULL>
__device__ __forceinline__ void dkv_tile(OutAccum<D>& dk, OutAccum<D>& dv,
                                         const T* sK,
                                         const T* sV, const T* cQ, const T* cO,
                                         const float* cL, const float* cD,
                                         int wr, int kw, int q_start, int jlo,
                                         int jhi, const Params& p, int g,
                                         int t) {
  constexpr int LD = D + Elem<T>::kPad;
  constexpr bool S = Elem<T>::kSplit;
  constexpr int NF = BQ / 8;  // query fragments per Q tile
  constexpr int DF = D / 8;
  Accum<NF, S> sa, dpa;
  sa.clear();
  dpa.clear();
#pragma unroll
  for (int kk = 0; kk < DF; ++kk) {
    const FragA ka = load_a<T, S, LD>(sK, wr, 8 * kk, g, t);
    const FragA va = load_a<T, S, LD>(sV, wr, 8 * kk, g, t);
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      if (FULL || (j >= jlo && j < jhi)) {
        const FragB qb = load_b_t<T, S, LD>(cQ, 8 * j, 8 * kk, g, t);
        const FragB ob = load_b_t<T, S, LD>(cO, 8 * j, 8 * kk, g, t);
        sa.template mma<S, S>(j, ka, qb);
        dpa.template mma<S, S>(j, va, ob);
      }
    }
  }
  sa.fold();
  dpa.fold();
  float(&s)[NF][4] = sa.c;
  float(&dp)[NF][4] = dpa.c;

  // thread keys kw+g and kw+g+8
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    if (FULL || (j >= jlo && j < jhi)) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = kw + g + 8 * (e >> 1);
        const int qi = 8 * j + 2 * t + (e & 1);
        const int qpos = q_start + qi;
        // query rows past seq are padding: they must add nothing
        const bool keep = FULL || (qpos < p.seq && kpos < p.kv_len &&
                                   (!p.causal || qpos >= kpos));
        const float pv = keep ? expf(s[j][e] * p.scale - cL[qi]) : 0.f;
        s[j][e] = pv;
        dp[j][e] = pv * (dp[j][e] - cD[qi]);
      }
    }
  }

  // dV += P^T dO and dK += dS^T Q, both A operands from registers
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    if (FULL || (j >= jlo && j < jhi)) {
      const FragA pa = acc_as_a(s[j]);
      const FragA da = acc_as_a(dp[j]);
#pragma unroll
      for (int n = 0; n < DF; ++n) {
        const FragB ob = load_b_perm<T, S, LD>(cO, 8 * j, 8 * n, g, t);
        const FragB qb = load_b_perm<T, S, LD>(cQ, 8 * j, 8 * n, g, t);
        dv.template mma<true, S>(n, pa, ob);
        dk.template mma<true, S>(n, da, qb);
      }
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(Tiles<D>::kDkvRows / 16 * 32)
    flash_bwd_dkv_kernel(Params p) {
  constexpr int BK = Tiles<D>::kDkvRows;
  constexpr int BQ = Tiles<D>::kDkvQ;
  constexpr int THREADS = BK / 16 * 32;
  constexpr int LD = D + Elem<T>::kPad;
  constexpr int NF = BQ / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);  // K, resident
  T* sV = sK + BK * LD;                // V, resident
  T* sQ = sV + BK * LD;                // Q, two stages
  T* sO = sQ + 2 * BQ * LD;            // dO, two stages
  float* sL = reinterpret_cast<float*>(sO + 2 * BQ * LD);  // lse, two stages
  float* sD = sL + 2 * BQ;                                 // delta, two stages

  const int k_start = blockIdx.x * BK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wr = 16 * (threadIdx.x >> 5);
  const int kw = k_start + wr;  // the warp's first key

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.o_sb + h * p.o_sh;
  const int64_t row_base = ((int64_t)b * p.heads + h) * p.seq;
  const float* lse = p.lse + row_base;
  const float* delta = p.delta + row_base;

  // A K/V tile wholly past kv_len has every score masked: its dK and dV are
  // 0. When causal, Q tiles that end before this tile's first key see none
  // of its keys.
  const int t_begin = p.causal ? k_start / BQ : 0;
  const int t_end = k_start < p.kv_len ? (p.seq + BQ - 1) / BQ : 0;

  auto load_q_tile = [&](int stage, int tile) {
    const int row0 = tile * BQ;
    load_tile<T, D, BQ, THREADS>(sQ + stage * BQ * LD, q, p.q_ss, row0, p.seq);
    load_tile<T, D, BQ, THREADS>(sO + stage * BQ * LD, dout, p.o_ss, row0, p.seq);
    load_rows<BQ, THREADS>(sL + stage * BQ, lse, row0, p.seq);
    load_rows<BQ, THREADS>(sD + stage * BQ, delta, row0, p.seq);
  };

  load_tile<T, D, BK, THREADS>(sK, k, p.k_ss, k_start, p.seq);
  load_tile<T, D, BK, THREADS>(sV, v, p.v_ss, k_start, p.seq);
  if (t_begin < t_end) load_q_tile(0, t_begin);
  cp_async_commit();

  // a warp whose keys are all at or past kv_len keeps zero gradients
  const bool active = kw < p.kv_len;

  OutAccum<D> dk, dv;
  dk.clear();
  dv.clear();

  for (int it = t_begin; it < t_end; ++it) {
    const int stage = (it - t_begin) & 1;
    if (it + 1 < t_end) load_q_tile(stage ^ 1, it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const int q_start = it * BQ;
    const T* cQ = sQ + stage * BQ * LD;
    const T* cO = sO + stage * BQ * LD;
    const float* cL = sL + stage * BQ;
    const float* cD = sD + stage * BQ;
    // query fragments [jlo, jhi) hold a kept score for some key of the warp:
    // those before the warp's first key are masked when causal, and those
    // past seq are padding
    const int jlo = p.causal && kw > q_start ? (kw - q_start) / 8 : 0;
    const int jhi = min(NF, (p.seq - q_start + 7) / 8);
    // every query of the tile is kept for every key of the warp
    const bool full = q_start + BQ <= p.seq && kw + 16 <= p.kv_len &&
                      (!p.causal || q_start >= kw + 15);
    if (active && full)
      dkv_tile<T, D, BQ, true>(dk, dv, sK, sV, cQ, cO, cL, cD, wr, kw, q_start,
                               jlo, jhi, p, g, t);
    else if (active && jlo < jhi)
      dkv_tile<T, D, BQ, false>(dk, dv, sK, sV, cQ, cO, cL, cD, wr, kw, q_start,
                                jlo, jhi, p, g, t);
    __syncthreads();  // this stage is read; the next copy may overwrite it
  }
  cp_async_wait<0>();

  dk.fold();
  dv.fold();
  store_rows<T, D>(p.dk, p, b, h, kw + g, t, dk.c, p.scale);
  store_rows<T, D>(p.dv, p, b, h, kw + g, t, dv.c, 1.f);
}

// ---------------------------------------------------------------- launch

template <typename T, int D>
constexpr int dq_smem_bytes() {
  constexpr int LD = D + Elem<T>::kPad;
  return (2 * Tiles<D>::kDqRows + 4 * Tiles<D>::kDqKv) * LD * (int)sizeof(T) +
         2 * Tiles<D>::kDqRows * (int)sizeof(float);
}

template <typename T, int D>
constexpr int dkv_smem_bytes() {
  constexpr int LD = D + Elem<T>::kPad;
  return (2 * Tiles<D>::kDkvRows + 4 * Tiles<D>::kDkvQ) * LD * (int)sizeof(T) +
         4 * Tiles<D>::kDkvQ * (int)sizeof(float);
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int rows, int threads, int smem,
                   const Params& p, int batch, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.seq + rows - 1) / rows, p.heads, batch);
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

// which: 0 dQ, 1 dK/dV
template <typename T, int D>
cudaError_t launch_one(int which, const Params& p, int batch,
                       cudaStream_t stream) {
  if (which == 0)
    return launch(flash_bwd_dq_kernel<T, D>, Tiles<D>::kDqRows,
                  Tiles<D>::kDqRows / 16 * 32, dq_smem_bytes<T, D>(), p, batch,
                  stream);
  return launch(flash_bwd_dkv_kernel<T, D>, Tiles<D>::kDkvRows,
                Tiles<D>::kDkvRows / 16 * 32, dkv_smem_bytes<T, D>(), p, batch,
                stream);
}

template <typename T>
cudaError_t dispatch_head_dim(int which, const Params& p, int batch,
                              int head_dim, cudaStream_t stream) {
  switch (head_dim) {
    case 32: return launch_one<T, 32>(which, p, batch, stream);
    case 64: return launch_one<T, 64>(which, p, batch, stream);
    case 128: return launch_one<T, 128>(which, p, batch, stream);
    default: return cudaErrorInvalidValue;
  }
}

int run(int which, const void* q, const void* k, const void* v,
        const void* dout, const void* lse, const void* delta, void* dq,
        void* dk, void* dv, const int64_t* strides, int batch, int seq,
        int heads, int head_dim, int dtype, int causal, float scale,
        int kv_len, void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const int itemsize = dtype == 0 ? 4 : 2;
  const void* inputs[4] = {q, k, v, dout};
  for (int i = 0; i < 4; ++i)
    if (!rows_aligned(inputs[i], strides + 3 * i, batch, seq, heads, itemsize))
      return (int)cudaErrorMisalignedAddress;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.q_sb = strides[0]; p.q_ss = strides[1]; p.q_sh = strides[2];
  p.k_sb = strides[3]; p.k_ss = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_ss = strides[7]; p.v_sh = strides[8];
  p.o_sb = strides[9]; p.o_ss = strides[10]; p.o_sh = strides[11];
  p.seq = seq;
  p.heads = heads;
  p.kv_len = kv_len;
  p.causal = causal;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_head_dim<float>(which, p, batch, head_dim, s);
  return (int)dispatch_head_dim<__nv_bfloat16>(which, p, batch, head_dim, s);
}

}  // namespace

// strides: the batch / seq / head element strides of q, k, v and dout, in
// that order (12 values); rows must be 16-byte aligned. dtype: 0 float32,
// 1 bfloat16. Each returns a cudaError_t (0 on success): the launch is
// checked with cudaGetLastError and nothing is synchronised.
extern "C" int flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, const int64_t* strides,
    int batch, int seq, int heads, int head_dim, int dtype, int causal,
    float scale, int kv_len, void* stream) {
  return run(0, q, k, v, dout, lse, delta, dq, nullptr, nullptr, strides,
             batch, seq, heads, head_dim, dtype, causal, scale, kv_len, stream);
}

extern "C" int flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv,
    const int64_t* strides, int batch, int seq, int heads, int head_dim,
    int dtype, int causal, float scale, int kv_len, void* stream) {
  return run(1, q, k, v, dout, lse, delta, nullptr, dk, dv, strides, batch,
             seq, heads, head_dim, dtype, causal, scale, kv_len, stream);
}

extern "C" const char* flash_attention_bwd_dq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" const char* flash_attention_bwd_dkv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
