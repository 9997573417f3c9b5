// Flash-attention forward for Hopper (sm_90a): tensor-core CUDA C++.
//
// Replaces the Pallas kernel `_fwd_kernel` of sparkdl_tpu/ops/flash_attention.py
// (:56), both as `fwd_only` (want_lse=False, the inference primal; pallas_call
// at :284) and as `fwd_call` (want_lse=True, the training forward that saves
// the logsumexp; pallas_call at :259).
//
//   O[b, q, h, :] = softmax_k(scale * Q[b, q, h, :] . K[b, k, h, :] + mask) V[b, k, h, :]
//   lse[b, h, q]  = m + log(l)               (optional)
//
// Masked scores are -1e30 (keys k >= kv_len; k > q when causal), as in the
// TPU kernel. Inputs are (batch, seq, heads, head_dim) with any batch / seq /
// head strides that keep rows 16-byte aligned and a contiguous head_dim, so
// the q/k/v views of a fused qkv projection are read in place. The output is
// a contiguous (batch, seq, heads, head_dim) tensor in the input type; lse is
// a contiguous (batch, heads, seq) float32 tensor, in natural log.
//
// Bound. At the ViT-B/16 shape (b=32, s=197, h=12, d=64) the forward does
// 4*b*h*s^2*d = 3.8 GFLOP on 77.5 MB of f32 q, k, v and o. Done as split TF32
// on the tensor cores (three TF32 products per f32 product at 495 TFLOP/s)
// that is 0.0231 ms, and the bytes at 3.35 TB/s take 0.0231 ms too: the f32
// kernel sits on both bounds at once. In bf16 the bytes halve (0.0116 ms;
// the work at the bf16 tensor-core rate would take 0.0039 ms), and the
// products as this kernel does them, one TF32 mma for Q K^T and two for P V,
// take 0.0116 ms at 495 TFLOP/s too. On the CUDA cores (67 TFLOP/s f32) the
// f32 work would take 0.057 ms.
//
// Design. What it does about that bound: every product runs on the tensor
// cores and no score leaves the registers, so the only traffic to device
// memory is q, k, v read and o (and lse) written; K/V re-reads by the CTAs
// of one head come from L2.
// - One CTA per (Q tile of ROWS rows, head, batch); each warp owns 16 query
//   rows, walks the K/V tiles in a loop with an online softmax and writes its
//   rows once. No atomics: every run gives the same bytes.
// - Products with mma.sync m16n8k8 TF32 and f32 accumulators in registers
//   (flash_attention_mma.cuh). f32 operands are split in hi + lo, three mma
//   per product, small terms in accumulators of their own (Accum). In bf16
//   Q and K are exact in TF32, so Q K^T takes one mma; P is f32 and stays
//   split, so P V takes two. P is never rounded to bf16, as the TPU kernel
//   keeps p in f32 and widens v.
// - Scale and exp2: scores are kept in log2 units. In f32 the scale times
//   log2(e) multiplies Q before its split (the TPU kernel scales Q too); in
//   bf16, where a scaled Q would no longer be exact in TF32, it multiplies S.
//   p = exp2(s - m); lse = m ln 2 + log(l), in natural log as the backward
//   reads it.
// - Q is staged once by cp.async, split by each warp for its own 16 rows and
//   kept in shared memory in fragment order (one 16-byte load per fragment
//   and per half, with no split left on the loop's path).
// - K/V tiles are streamed by cp.async in 16-byte pieces, two stages deep,
//   so the next tile's copy overlaps this tile's products; tiles keep the
//   input type, rows padded by 16 bytes (fragment reads hit 32 banks).
// - P never leaves the registers: the S accumulator (columns 2t, 2t+1 of
//   rows g, g+8) is the A operand of P V under the key permutation
//   k <-> {2t, 2t+1}, and V is read as the B operand under the same one.
// - Online softmax in registers: the row max reduces over the 4 lanes of a
//   quad (two xor-shuffles); each lane keeps a partial row sum, reduced over
//   the quad once at the end. A tile's P V goes into accumulators of its own
//   and joins O as O = alpha O + PV in one fma rounded to nearest, alpha =
//   exp2(m_old - m_new): the tensor cores round every mma's sum toward zero,
//   and a running O fed by the mma took that bias over every 8 keys of the
//   row (a first build of this kernel did so, and its training checks in
//   chip_smoke.py went past their limits; PERF.md).
// - O = acc / l is divided, not multiplied by a reciprocal, and stored in
//   the input type; lse is written once per row.
// - Masking and padding at the mma grain: tiles wholly past kv_len (or past
//   the causal edge of the CTA) are not loaded; a warp whose 16 rows lie
//   past seq does no products; 8-key fragments wholly masked for the warp
//   are skipped; tiles whose every score is kept run an instance of the tile
//   body with no per-fragment tests. Rows past seq are zero in shared memory
//   and never stored.
// - Tile sizes per head_dim in `Tiles`, or the same at every head_dim from
//   -DFLASH_FWD_ROWS / -DFLASH_FWD_KV for a sweep
//   (python -m sparkdl_tpu_torch.ops.tile_sweep).

#include "flash_attention_mma.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // nullptr: no lse output
  int64_t q_sb, q_ss, q_sh;  // element strides of batch, seq and head
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int seq;
  int heads;
  int kv_len;  // 1 <= kv_len <= seq
  int causal;
  float scale_log2;  // scale * log2(e)
};

// Q rows per CTA (16 per warp) and rows of a streamed K/V tile, per head_dim,
// from the sweep in PERF.md (python -m sparkdl_tpu_torch.ops.tile_sweep).
#ifdef FLASH_FWD_ROWS  // a sweep's build: the same tiles at every head_dim
template <int D>
struct Tiles {
  static constexpr int kRows = FLASH_FWD_ROWS, kKv = FLASH_FWD_KV;
};
#else
template <int D>
struct Tiles;
template <>
struct Tiles<32> {
  static constexpr int kRows = 64, kKv = 32;
};
template <>
struct Tiles<64> {
  static constexpr int kRows = 64, kKv = 32;
};
template <>
struct Tiles<128> {
  static constexpr int kRows = 128, kKv = 32;
};
#endif

// Q's fragments in shared memory: per warp, per 8-column step, the hi (and,
// split, the lo) TF32 values of 32 lanes, 16 bytes a lane.
template <typename T>
__host__ __device__ constexpr int q_parts() {
  return Elem<T>::kSplit ? 2 : 1;
}

// The raw Q tile and, in the same bytes afterwards, Q's fragments.
template <typename T, int D>
__host__ __device__ constexpr int q_bytes() {
  constexpr int raw = Tiles<D>::kRows * (D + Elem<T>::kPad) * (int)sizeof(T);
  constexpr int frags = Tiles<D>::kRows / 16 * (D / 8) * q_parts<T>() * 32 * 16;
  return raw > frags ? raw : frags;
}

template <typename T, int D>
__host__ __device__ constexpr int smem_bytes() {
  return q_bytes<T, D>() +
         4 * Tiles<D>::kKv * (D + Elem<T>::kPad) * (int)sizeof(T);
}

// The A operand Q[row0 .. row0+15][col0 .. col0+7] of the raw tile, times
// mul before the split (f32) or as it is (bf16: exact in TF32).
template <typename T, int LD>
__device__ __forceinline__ FragA load_q(const T* x, int row0, int col0, int g,
                                        int t, float mul) {
  constexpr bool S = Elem<T>::kSplit;
  const T* p = x + (row0 + g) * LD + col0 + t;
  const float v[4] = {widen(p[0]), widen(p[8 * LD]), widen(p[4]),
                      widen(p[8 * LD + 4])};
  FragA f;
#pragma unroll
  for (int e = 0; e < 4; ++e) split<S>(S ? v[e] * mul : v[e], f.hi[e], f.lo[e]);
  return f;
}

// One K/V tile for a warp's 16 rows: S = Q K^T over the key fragments
// [0, nf), masked, the online-softmax update of (m, l), O = alpha O + P V.
// qf: the warp's Q fragments. FULL: a tile with every score of the warp
// kept, so nf = NF and nothing is tested per fragment or per score; edge
// tiles take the other instance.
template <typename T, int D, int BK, bool FULL>
__device__ __forceinline__ void fwd_tile(OutAccum<D>& acc, float (&m)[2],
                                         float (&l)[2], const uint4* qf,
                                         const T* cK, const T* cV, int qw,
                                         int k_start, int nf, const Params& p,
                                         int lane, int g, int t) {
  constexpr int LD = D + Elem<T>::kPad;
  constexpr bool S = Elem<T>::kSplit;
  constexpr int NF = BK / 8;  // key fragments per K/V tile
  constexpr int DF = D / 8;   // head_dim fragments
  constexpr int QP = q_parts<T>();
  Accum<NF, S> sa;
  sa.clear();
#pragma unroll
  for (int kk = 0; kk < DF; ++kk) {
    FragA qa;
    const uint4 hi = qf[(kk * QP) * 32 + lane];
    qa.hi[0] = hi.x; qa.hi[1] = hi.y; qa.hi[2] = hi.z; qa.hi[3] = hi.w;
    if (S) {
      const uint4 lo = qf[(kk * QP + 1) * 32 + lane];
      qa.lo[0] = lo.x; qa.lo[1] = lo.y; qa.lo[2] = lo.z; qa.lo[3] = lo.w;
    }
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      if (FULL || j < nf) {
        const FragB kb = load_b_t<T, S, LD>(cK, 8 * j, 8 * kk, g, t);
        sa.template mma<S, S>(j, qa, kb);
      }
    }
  }
  sa.fold();
  float(&s)[NF][4] = sa.c;

  // scores in log2 units, masked to -1e30; the row max of rows g and g+8
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    if (FULL || j < nf) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (!S) s[j][e] *= p.scale_log2;
        if (!FULL) {
          const int qpos = qw + g + 8 * (e >> 1);
          const int kpos = k_start + 8 * j + 2 * t + (e & 1);
          if (!(kpos < p.kv_len && (!p.causal || qpos >= kpos))) s[j][e] = NEG_INF;
        }
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    }
  }
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    alpha[r] = exp2f(m[r] - m_new);  // 0 on the first tile: m = -1e30
    m[r] = m_new;
    l[r] *= alpha[r];
  }
  // P in place of S; this lane's part of the row sums
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    if (FULL || j < nf) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - m[e >> 1]);  // masked: exactly 0
        l[e >> 1] += s[j][e];
      }
    }
  }

  // O = alpha O + P V, P straight from its registers. The tensor cores round
  // each mma's sum toward zero, so a running O would shrink by about half an
  // ulp per 8 keys, over every key of the row. This tile's P V goes into
  // accumulators of its own instead (small terms into O's own, rescaled
  // first) and joins O in one fma rounded to nearest.
  constexpr bool APART = OutAccum<D>::kApart;
  float pv[DF][4];
#pragma unroll
  for (int n = 0; n < DF; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      pv[n][e] = 0.f;
      if (APART) acc.lo[n][e] *= alpha[e >> 1];
    }
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    if (FULL || j < nf) {
      const FragA pa = acc_as_a(s[j]);
#pragma unroll
      for (int n = 0; n < DF; ++n) {
        const FragB vb = load_b_perm<T, S, LD>(cV, 8 * j, 8 * n, g, t);
        float(&small)[4] = APART ? acc.lo[APART ? n : 0] : pv[n];
        mma_tf32(small, pa.lo, vb.hi);
        if (S) mma_tf32(small, pa.hi, vb.lo);
        mma_tf32(pv[n], pa.hi, vb.hi);
      }
    }
  }
#pragma unroll
  for (int n = 0; n < DF; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc.c[n][e] = fmaf(acc.c[n][e], alpha[e >> 1], pv[n][e]);
}

template <typename T, int D>
__global__ void __launch_bounds__(Tiles<D>::kRows / 16 * 32)
    flash_fwd_kernel(Params p) {
  constexpr int BQ = Tiles<D>::kRows;
  constexpr int BK = Tiles<D>::kKv;
  constexpr int THREADS = BQ / 16 * 32;
  constexpr int LD = D + Elem<T>::kPad;
  constexpr int NF = BK / 8;
  constexpr int DF = D / 8;
  constexpr int QP = q_parts<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);         // Q, raw; then its fragments
  uint4* sQf = reinterpret_cast<uint4*>(smem);
  T* sK = reinterpret_cast<T*>(smem + q_bytes<T, D>());  // K, two stages
  T* sV = sK + 2 * BK * LD;                              // V, two stages

  const int q_start = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int warp = threadIdx.x >> 5;
  const int wr = 16 * warp;     // the warp's first row in the tile
  const int qw = q_start + wr;  // ... in the sequence

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;

  // Tiles wholly past kv_len (or, when causal, after this Q tile's last row)
  // hold only masked keys. Key 0 is always kept (kv_len >= 1), so those
  // tiles would add exp(-1e30 - m) = 0 to every row: skipping them is exact.
  int n_tiles = (p.kv_len + BK - 1) / BK;
  if (p.causal) n_tiles = min(n_tiles, (q_start + BQ - 1) / BK + 1);

  load_tile<T, D, BQ, THREADS>(sQ, q, p.q_ss, q_start, p.seq);
  cp_async_commit();
  load_tile<T, D, BK, THREADS>(sK, k, p.k_ss, 0, p.seq);
  load_tile<T, D, BK, THREADS>(sV, v, p.v_ss, 0, p.seq);
  cp_async_commit();

  // Q's fragments, split once: read by every warp from the raw tile, then
  // written over it, each lane's in its own 16-byte slots (it alone reads
  // them back, so no barrier follows)
  cp_async_wait<1>();
  __syncthreads();
  {
    FragA qa[DF];
#pragma unroll
    for (int kk = 0; kk < DF; ++kk)
      qa[kk] = load_q<T, LD>(sQ, wr, 8 * kk, g, t, p.scale_log2);
    __syncthreads();  // the raw tile is read
#pragma unroll
    for (int kk = 0; kk < DF; ++kk) {
      uint4* dst = sQf + ((warp * DF + kk) * QP) * 32 + lane;
      dst[0] = make_uint4(qa[kk].hi[0], qa[kk].hi[1], qa[kk].hi[2], qa[kk].hi[3]);
      if (QP == 2)
        dst[32] = make_uint4(qa[kk].lo[0], qa[kk].lo[1], qa[kk].lo[2], qa[kk].lo[3]);
    }
  }
  const uint4* qf = sQf + warp * DF * QP * 32;

  // keys at or past `limit` are masked for all 16 rows of this warp
  int limit = p.kv_len;
  if (p.causal) limit = min(limit, qw + 16);
  const bool active = qw < p.seq;

  OutAccum<D> acc;
  acc.clear();
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};

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
      fwd_tile<T, D, BK, true>(acc, m, l, qf, cK, cV, qw, k_start, nf, p, lane, g, t);
    else if (active && nf > 0)
      fwd_tile<T, D, BK, false>(acc, m, l, qf, cK, cV, qw, k_start, nf, p, lane, g, t);
    __syncthreads();  // this stage is read; the next copy may overwrite it
  }
  cp_async_wait<0>();
  if (!active) return;

  acc.fold();
  T* o = static_cast<T*>(p.o);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float sum = l[half];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int row = qw + g + 8 * half;
    if (row >= p.seq) continue;
    T* dst = o + (((int64_t)b * p.seq + row) * p.heads + h) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < DF; ++n)
      store2(dst + 8 * n, acc.c[n][2 * half] / sum, acc.c[n][2 * half + 1] / sum);
    if (p.lse != nullptr && t == 0)
      p.lse[((int64_t)b * p.heads + h) * p.seq + row] = m[half] * LN2 + logf(sum);
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  constexpr int smem = smem_bytes<T, D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  constexpr int rows = Tiles<D>::kRows;
  const dim3 grid((p.seq + rows - 1) / rows, p.heads, batch);
  flash_fwd_kernel<T, D><<<grid, rows / 16 * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_head_dim(const Params& p, int batch, int head_dim,
                              cudaStream_t stream) {
  switch (head_dim) {
    case 32: return launch<T, 32>(p, batch, stream);
    case 64: return launch<T, 64>(p, batch, stream);
    case 128: return launch<T, 128>(p, batch, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16; rows of q, k and v must be 16-byte aligned.
// Returns a cudaError_t (0 on success): the launch is checked with
// cudaGetLastError and nothing is synchronised.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int64_t q_sb, int64_t q_ss, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh,
    int batch, int seq, int heads, int head_dim, int dtype, int causal,
    float scale, int kv_len, void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const int itemsize = dtype == 0 ? 4 : 2;
  const int64_t strides[9] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  const void* inputs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i)
    if (!rows_aligned(inputs[i], strides + 3 * i, batch, seq, heads, itemsize))
      return (int)cudaErrorMisalignedAddress;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.seq = seq;
  p.heads = heads;
  p.kv_len = kv_len;
  p.causal = causal;
  p.scale_log2 = scale * LOG2E;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_head_dim<float>(p, batch, head_dim, s);
  return (int)dispatch_head_dim<__nv_bfloat16>(p, batch, head_dim, s);
}

extern "C" const char* flash_attention_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
