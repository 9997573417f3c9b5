// Flash-attention forward for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the Pallas kernels `_fwd_kernel` of sparkdl_tpu/ops/flash_attention.py,
// both as `fwd_only` (want_lse=False, the inference primal) and as `fwd_call`
// (want_lse=True, the training forward that saves the logsumexp).
//
//   O[b, q, h, :] = softmax_k(scale * Q[b, q, h, :] . K[b, k, h, :] + mask) V[b, k, h, :]
//   lse[b, h, q]  = m + log(l)               (optional)
//
// Masked scores are -1e30 (keys k >= kv_len; k > q when causal), as in the
// TPU kernel. Inputs are (batch, seq, heads, head_dim) with any batch / seq /
// head strides and a contiguous head_dim, so the q/k/v views that a fused
// qkv projection yields are read in place. The output is a contiguous
// (batch, seq, heads, head_dim) tensor in the input type; lse is a contiguous
// (batch, heads, seq) float32 tensor.
//
// Design. One CTA of 128 threads per (64-row Q tile, head, batch). The Q tile
// (pre-scaled) and each 64-row K/V tile are staged in shared memory as fp32,
// rows padded to head_dim + 1 floats so that the column walks below touch 32
// distinct banks. Thread (ty, tx) = (tid / 8, tid % 8) owns query rows
// 4*ty .. 4*ty+3, score columns tx + 8*j and output columns tx + 8*c, so the
// online-softmax state (m, l, acc) of a row lives in the registers of the 8
// consecutive lanes that share it and row reductions are three xor-shuffles.
// QK^T and PV are fp32 FMAs on the CUDA cores; P goes through shared memory.
//
// Bound. At the ViT-B/16 shape (b=32, s=197, h=12, d=64) the forward does
// 4*b*h*s^2*d = 3.8 GFLOP on 77 MB of f32 inputs and output, so it is bound
// by operations: the fp32 FMA rate of the CUDA cores for f32 inputs. This
// first kernel stages tiles synchronously and does not use the tensor cores
// (wgmma) or TMA; those are the next steps for speed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_M = 64;   // query rows per CTA
constexpr int BLOCK_N = 64;   // keys per K/V tile (equal to BLOCK_M: see n_tiles)
constexpr int THREADS = 128;  // 16 row groups x 8 lanes
constexpr int ROWS = BLOCK_M / 16;  // query rows per thread
constexpr int COLS = BLOCK_N / 8;   // score columns per thread
constexpr int LDP = BLOCK_N + 1;    // padded row of the P tile
constexpr float NEG_INF = -1e30f;

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
  for (int idx = threadIdx.x; idx < 64 * D; idx += THREADS) {
    const int r = idx / D;
    const int c = idx % D;
    float x = 0.f;
    if (r < valid) x = to_float(src[(int64_t)(row0 + r) * row_stride + c]) * mul;
    dst[r * (D + 1) + c] = x;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(Params p) {
  constexpr int LD = D + 1;
  constexpr int OC = D / 8;  // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BLOCK_M * LD;
  float* sV = sK + BLOCK_N * LD;
  float* sP = sV + BLOCK_N * LD;

  const int q_start = blockIdx.x * BLOCK_M;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int ty = threadIdx.x >> 3;
  const int tx = threadIdx.x & 7;
  const int r0 = ty * ROWS;

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;

  load_tile<T, D>(sQ, q, p.q_ss, q_start, p.seq - q_start, p.scale);

  float m[ROWS], l[ROWS], acc[ROWS][OC];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[i][c] = 0.f;
  }

  // Tiles wholly past kv_len (or, when causal, past this Q tile's last row)
  // hold only masked keys. Key 0 is always kept (kv_len >= 1), so those
  // tiles would add exp(-1e30 - m) = 0 to every row: skipping them is exact.
  int n_tiles = (p.kv_len + BLOCK_N - 1) / BLOCK_N;
  if (p.causal) n_tiles = min(n_tiles, q_start / BLOCK_N + 1);

  for (int t = 0; t < n_tiles; ++t) {
    const int k_start = t * BLOCK_N;
    __syncthreads();  // the previous tile's sK / sV / sP reads are done
    load_tile<T, D>(sK, k, p.k_ss, k_start, p.seq - k_start, 1.f);
    load_tile<T, D>(sV, v, p.v_ss, k_start, p.seq - k_start, 1.f);
    __syncthreads();

    float s[ROWS][COLS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < COLS; ++j) s[i][j] = 0.f;

#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[ROWS], kv[COLS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) qv[i] = sQ[(r0 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < COLS; ++j) kv[j] = sK[(tx + 8 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < COLS; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int qpos = q_start + r0 + i;
      float row_max = NEG_INF;
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const int kpos = k_start + tx + 8 * j;
        const bool keep = kpos < p.kv_len && (!p.causal || qpos >= kpos);
        if (!keep) s[i][j] = NEG_INF;
        row_max = fmaxf(row_max, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      const float m_new = fmaxf(m[i], row_max);
      const float alpha = expf(m[i] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const float pv = expf(s[i][j] - m_new);
        row_sum += pv;
        sP[(r0 + i) * LDP + tx + 8 * j] = pv;
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      l[i] = alpha * l[i] + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < OC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // the whole P tile is written

#pragma unroll 4
    for (int n = 0; n < BLOCK_N; ++n) {
      float pv[ROWS], vv[OC];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) pv[i] = sP[(r0 + i) * LDP + n];
#pragma unroll
      for (int c = 0; c < OC; ++c) vv[c] = sV[n * LD + tx + 8 * c];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int c = 0; c < OC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

  T* o = static_cast<T*>(p.o);
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int qpos = q_start + r0 + i;
    if (qpos >= p.seq) continue;
    const float inv = 1.f / l[i];
    T* row = o + (((int64_t)b * p.seq + qpos) * p.heads + h) * D;
#pragma unroll
    for (int c = 0; c < OC; ++c) store(row + tx + 8 * c, acc[i][c] * inv);
    if (p.lse != nullptr && tx == 0)
      p.lse[((int64_t)b * p.heads + h) * p.seq + qpos] = m[i] + logf(l[i]);
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  constexpr int LD = D + 1;
  const int smem =
      ((BLOCK_M + 2 * BLOCK_N) * LD + BLOCK_M * LDP) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.seq + BLOCK_M - 1) / BLOCK_M, p.heads, batch);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(p);
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

// dtype: 0 float32, 1 bfloat16. Returns a cudaError_t (0 on success): the
// launch is checked with cudaGetLastError and nothing is synchronised.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int64_t q_sb, int64_t q_ss, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh,
    int batch, int seq, int heads, int head_dim, int dtype, int causal,
    float scale, int kv_len, void* stream) {
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
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)dispatch_head_dim<float>(p, batch, head_dim, s);
    case 1: return (int)dispatch_head_dim<__nv_bfloat16>(p, batch, head_dim, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_attention_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
