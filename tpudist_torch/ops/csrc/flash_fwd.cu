// Flash-attention forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel tpudist/ops/pallas/flash_attention.py::_flash_kernel
// (reached through _flash_forward's pl.pallas_call). It computes what
// _flash_forward computes, not the Pallas block structure:
//   - Q is scaled as (q.float() * (1/sqrt(d))).to(q.dtype), the rounding of
//     _scaled_q;
//   - S = Q K^T accumulated in f32; keys at or beyond k_len are masked, and
//     with `causal` a key col is visible to row i iff i + (k_len - q_len) >= col;
//   - online softmax in f32; P is rounded to V's dtype before P.V, which
//     accumulates in f32; the normalizer l sums the unrounded P;
//   - O is stored in q's dtype and lse = m + log(l) in f32; a fully masked
//     row has l == 0 and emits O = 0 and lse = -1e30 (the guard l == 0 -> 1).
//
// What bounds it on this card: at the serving shapes (ViT-B/16 at 224 px:
// T = 197, H = 12, D = 64, batch 1..8, bf16) one call moves 1.2 MB (batch 1)
// to 9.8 MB (batch 8) of Q, K, V, O and lse against 0.12 to 0.95 GFLOP, so
// the bound is memory (a few microseconds) and, at batch 1, launch latency.
//
// What the design does about it:
//   - one thread block per (query tile of 64 rows, head, batch); a loop over
//     64-key tiles inside the block takes the place of the TPU's sequential
//     "arbitrary" grid axis. A 64-row tile gives B*H*ceil(197/64) = 48 blocks
//     at batch 1 (24 with 128-row tiles), so more of the 132 SMs get work;
//   - Q, K and V are read straight from their (B, T, H, D) layout through
//     strides (the last dim must be contiguous): the model's fused QKV
//     projection output is passed in as three strided views, so no transpose
//     or copy precedes the kernel, and O is written in (B, T, H, D), the
//     layout the output projection reads. Each input byte is read once per
//     query tile;
//   - tiles are staged in shared memory as f32 with an odd row stride, so
//     the score and P.V loops are free of bank conflicts;
//   - four threads own one query row: they split its 64 scores and its D
//     output columns and combine max and sum with two warp shuffles.
// The products run on the FP32 pipes, not the tensor cores: simple and right
// first. As built, those scalar products and their shared-memory reads, not
// the bytes, set its time (0.16 ms at batch 8 on an H100 SXM against a
// 2.9 us memory bound; PERF.md). Tensor-core products (mma.sync, then
// wgmma/TMA) for bf16 are later work; f32 stays on the FP32 pipes to keep
// the f32 result within 2e-5 of the plain version.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;           // query rows per block
constexpr int BK = 64;           // keys per k-tile
constexpr int TPR = 4;           // threads per query row
constexpr int THREADS = BQ * TPR;
constexpr int CPT = BK / TPR;    // score columns per thread
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T and widened back to f32.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t(BQ) * (D + 1) + size_t(BK) * (D + 1) +
                          size_t(BK) * D + size_t(BQ) * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int Tq, int Tk,
                 int64_t q_sb, int64_t q_st, int64_t q_sh,
                 int64_t k_sb, int64_t k_st, int64_t k_sh,
                 int64_t v_sb, int64_t v_st, int64_t v_sh,
                 int causal, float scale) {
  constexpr int DP = D + 1;      // row stride of the Q and K tiles
  constexpr int PP = BK + 1;     // row stride of the P tile
  constexpr int DPT = D / TPR;   // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;              // [BQ][DP]
  float* sK = sQ + BQ * DP;      // [BK][DP]
  float* sV = sK + BK * DP;      // [BK][D]
  float* sP = sV + BK * D;       // [BQ][PP]

  const int tid = threadIdx.x;
  const int r = tid / TPR;       // query row within the tile
  const int sub = tid % TPR;     // this thread's share of the row
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row = q0 + r;
  const int offset = Tk - Tq;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int rr = i / D, d = i % D;
    const int qi = q0 + rr;
    const float x = qi < Tq ? to_f(qb[qi * q_st + d]) : 0.f;
    sQ[rr * DP + d] = round_to<T>(x * scale);
  }

  float m = NEG_INF, l = 0.f;
  float acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;

  // k-tiles past the key length, or (causal) wholly above the diagonal for
  // every row of this tile, are skipped.
  int nk = (Tk + BK - 1) / BK;
  if (causal) {
    const int last = q0 + BQ - 1 + offset;
    nk = min(nk, last < 0 ? 0 : last / BK + 1);
  }

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();             // the previous tile's K/V reads are done
    for (int i = tid; i < BK * D; i += THREADS) {
      const int rr = i / D, d = i % D;
      const int key = k0 + rr;
      const bool in = key < Tk;
      sK[rr * DP + d] = in ? to_f(kb[key * k_st + d]) : 0.f;
      sV[rr * D + d] = in ? to_f(vb[key * v_st + d]) : 0.f;
    }
    __syncthreads();

    float s[CPT];
    unsigned valid = 0u;
    float m_cur = NEG_INF;
    const float* qr = sQ + r * DP;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = sub + TPR * j;
      const float* kr = sK + c * DP;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
      const int col = k0 + c;
      const bool ok = col < Tk && (!causal || row + offset >= col);
      valid |= unsigned(ok) << j;
      s[j] = ok ? dot : NEG_INF;
      m_cur = fmaxf(m_cur, s[j]);
    }
    m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, 1));
    m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, 2));
    const float m_next = fmaxf(m, m_cur);
    const float alpha = expf(m - m_next);

    float l_cur = 0.f;
    float* pr = sP + r * PP;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const float p = (valid >> j) & 1u ? expf(s[j] - m_next) : 0.f;
      l_cur += p;
      pr[sub + TPR * j] = round_to<T>(p);
    }
    l_cur += __shfl_xor_sync(0xffffffffu, l_cur, 1);
    l_cur += __shfl_xor_sync(0xffffffffu, l_cur, 2);
    l = l * alpha + l_cur;
    m = m_next;
    __syncwarp();                // a row's P comes from lanes of one warp

#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= alpha;
    for (int kk = 0; kk < BK; ++kk) {
      const float p = pr[kk];
      const float* vr = sV + kk * D;
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] = fmaf(p, vr[sub + TPR * i], acc[i]);
    }
  }

  if (row < Tq) {
    const float l_safe = l == 0.f ? 1.f : l;
    T* orow = o + ((int64_t(b) * Tq + row) * H + h) * D;
#pragma unroll
    for (int i = 0; i < DPT; ++i) orow[sub + TPR * i] = from_f<T>(acc[i] / l_safe);
    if (sub == 0) lse[(int64_t(b) * H + h) * Tq + row] = m + logf(l_safe);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int H, int Tq, int Tk,
                   const long long* st, int causal, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      H, Tq, Tk, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dim(int head_dim, const void* q, const void* k,
                         const void* v, void* o, void* lse, int B, int H,
                         int Tq, int Tk, const long long* st, int causal,
                         float scale, cudaStream_t stream) {
  switch (head_dim) {
    case 32: return launch<T, 32>(q, k, v, o, lse, B, H, Tq, Tk, st, causal, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, B, H, Tq, Tk, st, causal, scale, stream);
    case 80: return launch<T, 80>(q, k, v, o, lse, B, H, Tq, Tk, st, causal, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. st: the (batch, seq, head) element
// strides of q, k and v in that order. Returns a cudaError_t (0 = launched).
extern "C" int tpudist_flash_fwd(int dtype, int head_dim, const void* q,
                                 const void* k, const void* v, void* o,
                                 void* lse, int B, int H, int Tq, int Tk,
                                 const long long* st, int causal, float scale,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_dim<float>(head_dim, q, k, v, o, lse, B, H, Tq, Tk, st, causal, scale, s);
  else if (dtype == 1)
    err = dispatch_dim<__nv_bfloat16>(head_dim, q, k, v, o, lse, B, H, Tq, Tk, st, causal, scale, s);
  else
    err = cudaErrorInvalidValue;
  return int(err);
}
