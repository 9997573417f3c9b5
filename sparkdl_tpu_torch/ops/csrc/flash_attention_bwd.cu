// Flash-attention backward for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the Pallas kernels `_dq_kernel` (flash_attention_bwd_dq) and
// `_dkv_kernel` (flash_attention_bwd_dkv) of sparkdl_tpu/ops/flash_attention.py,
// the two halves of the custom VJP's `bwd`. With Qs = scale * Q and the lse
// that the forward saved:
//
//   P  = exp(Qs K^T - lse)   where kept, else 0
//   dS = P * (dO V^T - delta),   delta = rowsum(dO * O)   (computed outside)
//   dQ = scale * dS K,   dK = dS^T Qs,   dV = P^T dO
//
// A score is kept where its key is < kv_len and, when causal, not after its
// query. Inputs are (batch, seq, heads, head_dim) with any batch / seq / head
// strides and a contiguous head_dim, so the q/k/v views of a fused qkv
// projection are read in place; lse and delta are contiguous
// (batch, heads, seq) float32; dQ, dK and dV are contiguous
// (batch, seq, heads, head_dim) tensors in the input type.
//
// Design. As in the TPU design, each gradient row is owned by one CTA, which
// walks the other operand's tiles in a loop and writes its rows once: no
// atomics, so the result is the same bytes on every run.
// - dQ: one CTA of 128 threads per (64-row Q tile, head, batch). Qs, dO, lse
//   and delta stay in shared memory; each 64-row K/V tile is staged in turn.
// - dK/dV: one CTA of 128 threads per (64-row K/V tile, head, batch). K and
//   V stay in shared memory; each 64-row Q tile (with dO, lse, delta) is
//   staged in turn. Thread (ty, tx) owns key rows 4*ty .. 4*ty+3 of both
//   accumulators and the transposed scores of those keys against queries
//   tx + 8*j, so the score tile is computed as S^T and never transposed.
// Tiles are fp32 in shared memory, rows padded to head_dim + 1 floats so the
// column walks touch 32 distinct banks (as the forward does). P and dS go
// through shared memory between the score products and the accumulating
// ones. The ragged edge (197 = 3*64 + 5) is masked in the kernel, and tiles
// wholly masked (past kv_len, or on the far side of the diagonal when causal)
// are skipped, which is exact because a masked P is 0.
//
// Bound. At the ViT-B/16 shape (b=32, s=197, h=12, d=64), f32: dQ does
// 6*b*h*s^2*d = 5.7 GFLOP on 97 MB and dK/dV 8*b*h*s^2*d = 7.6 GFLOP on
// 116 MB, so both are bound by operations: the fp32 FMA rate of the CUDA
// cores. Like the forward, this first version stages tiles synchronously and
// uses neither the tensor cores (wgmma) nor TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 64;          // rows of every Q and K/V tile
constexpr int THREADS = 128;       // 16 row groups x 8 lanes
constexpr int ROWS = BLOCK / 16;   // rows per thread
constexpr int COLS = BLOCK / 8;    // score columns per thread
constexpr int LDP = BLOCK + 1;     // padded row of a P / dS tile

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

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Stage rows row0 .. row0+63 of one (seq, head_dim) slice into dst as fp32,
// multiplied by mul; rows at or past `valid` are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t row_stride, int row0,
                                          int valid, float mul) {
  for (int idx = threadIdx.x; idx < BLOCK * D; idx += THREADS) {
    const int r = idx / D;
    const int c = idx % D;
    float x = 0.f;
    if (r < valid) x = to_float(src[(int64_t)(row0 + r) * row_stride + c]) * mul;
    dst[r * (D + 1) + c] = x;
  }
}

// Stage lse and delta of rows row0 .. row0+63 (zero past seq).
__device__ __forceinline__ void load_rows(float* s_lse, float* s_delta,
                                          const float* lse, const float* delta,
                                          int row0, int seq) {
  for (int r = threadIdx.x; r < BLOCK; r += THREADS) {
    const bool in = row0 + r < seq;
    s_lse[r] = in ? lse[row0 + r] : 0.f;
    s_delta[r] = in ? delta[row0 + r] : 0.f;
  }
}

// Write rows of a (ROWS x D/8) register tile into a contiguous
// (batch, seq, heads, D) output, rows at or past seq skipped.
template <typename T, int D>
__device__ __forceinline__ void store_rows(void* out, const Params& p, int b,
                                           int h, int row0, int tx,
                                           const float (&acc)[ROWS][D / 8],
                                           float mul) {
  T* o = static_cast<T*>(out);
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int pos = row0 + i;
    if (pos >= p.seq) continue;
    T* row = o + (((int64_t)b * p.seq + pos) * p.heads + h) * D;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) store(row + tx + 8 * c, acc[i][c] * mul);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(Params p) {
  constexpr int LD = D + 1;
  constexpr int OC = D / 8;  // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;               // Qs, resident
  float* sO = sQ + BLOCK * LD;    // dO, resident
  float* sK = sO + BLOCK * LD;
  float* sV = sK + BLOCK * LD;
  float* sS = sV + BLOCK * LD;    // dS tile
  float* sL = sS + BLOCK * LDP;   // lse of the Q rows
  float* sD = sL + BLOCK;         // delta of the Q rows

  const int q_start = blockIdx.x * BLOCK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int ty = threadIdx.x >> 3;
  const int tx = threadIdx.x & 7;
  const int r0 = ty * ROWS;

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.o_sb + h * p.o_sh;
  const int64_t row_base = ((int64_t)b * p.heads + h) * p.seq;

  load_tile<T, D>(sQ, q, p.q_ss, q_start, p.seq - q_start, p.scale);
  load_tile<T, D>(sO, dout, p.o_ss, q_start, p.seq - q_start, 1.f);
  load_rows(sL, sD, p.lse + row_base, p.delta + row_base, q_start, p.seq);

  float acc[ROWS][OC];
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[i][c] = 0.f;

  // as in the forward: tiles wholly past kv_len, or wholly after this Q
  // tile's last row when causal, have P = 0 and add nothing
  int n_tiles = (p.kv_len + BLOCK - 1) / BLOCK;
  if (p.causal) n_tiles = min(n_tiles, q_start / BLOCK + 1);

  for (int t = 0; t < n_tiles; ++t) {
    const int k_start = t * BLOCK;
    __syncthreads();  // the previous tile's sK / sV / sS reads are done
    load_tile<T, D>(sK, k, p.k_ss, k_start, p.seq - k_start, 1.f);
    load_tile<T, D>(sV, v, p.v_ss, k_start, p.seq - k_start, 1.f);
    __syncthreads();

    // S = Qs K^T and dP = dO V^T, the same 4 x 8 cells of each
    float s[ROWS][COLS], dp[ROWS][COLS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < COLS; ++j) s[i][j] = dp[i][j] = 0.f;

#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[ROWS], ov[ROWS], kv[COLS], vv[COLS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        qv[i] = sQ[(r0 + i) * LD + d];
        ov[i] = sO[(r0 + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        kv[j] = sK[(tx + 8 * j) * LD + d];
        vv[j] = sV[(tx + 8 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < COLS; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int qpos = q_start + r0 + i;
      const float lse = sL[r0 + i];
      const float delta = sD[r0 + i];
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const int kpos = k_start + tx + 8 * j;
        const bool keep = kpos < p.kv_len && (!p.causal || qpos >= kpos);
        const float pv = keep ? expf(s[i][j] - lse) : 0.f;
        sS[(r0 + i) * LDP + tx + 8 * j] = pv * (dp[i][j] - delta);
      }
    }
    __syncthreads();  // the whole dS tile is written

    // dQ += dS K
#pragma unroll 4
    for (int n = 0; n < BLOCK; ++n) {
      float dsv[ROWS], kv[OC];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) dsv[i] = sS[(r0 + i) * LDP + n];
#pragma unroll
      for (int c = 0; c < OC; ++c) kv[c] = sK[n * LD + tx + 8 * c];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int c = 0; c < OC; ++c) acc[i][c] = fmaf(dsv[i], kv[c], acc[i][c]);
    }
  }

  store_rows<T, D>(p.dq, p, b, h, q_start + r0, tx, acc, p.scale);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_kernel(Params p) {
  constexpr int LD = D + 1;
  constexpr int OC = D / 8;
  extern __shared__ float smem[];
  float* sK = smem;               // K, resident
  float* sV = sK + BLOCK * LD;    // V, resident
  float* sQ = sV + BLOCK * LD;    // Qs of the current Q tile
  float* sO = sQ + BLOCK * LD;    // dO of the current Q tile
  float* sP = sO + BLOCK * LD;    // P^T tile: rows keys, columns queries
  float* sS = sP + BLOCK * LDP;   // dS^T tile
  float* sL = sS + BLOCK * LDP;
  float* sD = sL + BLOCK;

  const int k_start = blockIdx.x * BLOCK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int ty = threadIdx.x >> 3;
  const int tx = threadIdx.x & 7;
  const int r0 = ty * ROWS;

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.o_sb + h * p.o_sh;
  const int64_t row_base = ((int64_t)b * p.heads + h) * p.seq;

  load_tile<T, D>(sK, k, p.k_ss, k_start, p.seq - k_start, 1.f);
  load_tile<T, D>(sV, v, p.v_ss, k_start, p.seq - k_start, 1.f);

  float dk[ROWS][OC], dv[ROWS][OC];
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int c = 0; c < OC; ++c) dk[i][c] = dv[i][c] = 0.f;

  // A K/V tile wholly past kv_len has every score masked: its dK and dV
  // are 0. When causal, Q tiles that end before this tile's first key see
  // none of its keys.
  int t_begin = p.causal ? k_start / BLOCK : 0;
  int t_end = k_start < p.kv_len ? (p.seq + BLOCK - 1) / BLOCK : 0;

  for (int t = t_begin; t < t_end; ++t) {
    const int q_start = t * BLOCK;
    __syncthreads();  // the previous tile's sQ / sO / sP / sS reads are done
    load_tile<T, D>(sQ, q, p.q_ss, q_start, p.seq - q_start, p.scale);
    load_tile<T, D>(sO, dout, p.o_ss, q_start, p.seq - q_start, 1.f);
    load_rows(sL, sD, p.lse + row_base, p.delta + row_base, q_start, p.seq);
    __syncthreads();

    // S^T = K Qs^T, then P^T into sP
    float s[ROWS][COLS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < COLS; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kr[ROWS], qc[COLS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) kr[i] = sK[(r0 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < COLS; ++j) qc[j] = sQ[(tx + 8 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < COLS; ++j) s[i][j] = fmaf(kr[i], qc[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int kpos = k_start + r0 + i;
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const int qpos = q_start + tx + 8 * j;
        // query rows past seq are padding: they must add nothing to dK/dV
        const bool keep = qpos < p.seq && kpos < p.kv_len &&
                          (!p.causal || qpos >= kpos);
        sP[(r0 + i) * LDP + tx + 8 * j] =
            keep ? expf(s[i][j] - sL[tx + 8 * j]) : 0.f;
      }
    }

    // dP^T = V dO^T in the same registers, then dS^T into sS. Each thread
    // reads back only the P^T cells it wrote, so no barrier is needed yet.
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < COLS; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float vr[ROWS], oc[COLS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) vr[i] = sV[(r0 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < COLS; ++j) oc[j] = sO[(tx + 8 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < COLS; ++j) s[i][j] = fmaf(vr[i], oc[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const int cell = (r0 + i) * LDP + tx + 8 * j;
        sS[cell] = sP[cell] * (s[i][j] - sD[tx + 8 * j]);
      }
    __syncthreads();  // the whole P^T and dS^T tiles are written

    // dV += P^T dO, dK += dS^T Qs (Qs carries the scale of dK)
#pragma unroll 2
    for (int m = 0; m < BLOCK; ++m) {
      float pv[ROWS], dsv[ROWS], ov[OC], qv[OC];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        pv[i] = sP[(r0 + i) * LDP + m];
        dsv[i] = sS[(r0 + i) * LDP + m];
      }
#pragma unroll
      for (int c = 0; c < OC; ++c) {
        ov[c] = sO[m * LD + tx + 8 * c];
        qv[c] = sQ[m * LD + tx + 8 * c];
      }
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int c = 0; c < OC; ++c) {
          dv[i][c] = fmaf(pv[i], ov[c], dv[i][c]);
          dk[i][c] = fmaf(dsv[i], qv[c], dk[i][c]);
        }
    }
  }

  store_rows<T, D>(p.dk, p, b, h, k_start + r0, tx, dk, 1.f);
  store_rows<T, D>(p.dv, p, b, h, k_start + r0, tx, dv, 1.f);
}

constexpr int dq_smem_bytes(int d) {
  return (4 * BLOCK * (d + 1) + BLOCK * LDP + 2 * BLOCK) * (int)sizeof(float);
}
constexpr int dkv_smem_bytes(int d) {
  return (4 * BLOCK * (d + 1) + 2 * BLOCK * LDP + 2 * BLOCK) * (int)sizeof(float);
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int smem, const Params& p, int batch,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.seq + BLOCK - 1) / BLOCK, p.heads, batch);
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const Params& p, int batch, cudaStream_t stream) {
  return launch(flash_bwd_dq_kernel<T, D>, dq_smem_bytes(D), p, batch, stream);
}

template <typename T, int D>
cudaError_t launch_dkv(const Params& p, int batch, cudaStream_t stream) {
  return launch(flash_bwd_dkv_kernel<T, D>, dkv_smem_bytes(D), p, batch, stream);
}

// which: 0 dQ, 1 dK/dV
template <typename T>
cudaError_t dispatch_head_dim(int which, const Params& p, int batch,
                              int head_dim, cudaStream_t stream) {
  switch (head_dim) {
    case 32: return which ? launch_dkv<T, 32>(p, batch, stream) : launch_dq<T, 32>(p, batch, stream);
    case 64: return which ? launch_dkv<T, 64>(p, batch, stream) : launch_dq<T, 64>(p, batch, stream);
    case 128: return which ? launch_dkv<T, 128>(p, batch, stream) : launch_dq<T, 128>(p, batch, stream);
    default: return cudaErrorInvalidValue;
  }
}

int run(int which, const void* q, const void* k, const void* v,
        const void* dout, const void* lse, const void* delta, void* dq,
        void* dk, void* dv, const int64_t* strides, int batch, int seq,
        int heads, int head_dim, int dtype, int causal, float scale,
        int kv_len, void* stream) {
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
  switch (dtype) {
    case 0: return (int)dispatch_head_dim<float>(which, p, batch, head_dim, s);
    case 1: return (int)dispatch_head_dim<__nv_bfloat16>(which, p, batch, head_dim, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: the batch / seq / head element strides of q, k, v and dout, in
// that order (12 values). dtype: 0 float32, 1 bfloat16. Each returns a
// cudaError_t (0 on success): the launch is checked with cudaGetLastError
// and nothing is synchronised.
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
