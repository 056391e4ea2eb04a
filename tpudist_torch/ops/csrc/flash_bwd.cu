// Flash-attention backward for Hopper (sm_90a), hand-written CUDA C++: the
// dQ pass and the dKV pass.
//
// Two entry points, each the counterpart of one TPU kernel of
// tpudist/ops/pallas/flash_attention.py (both reached through
// _flash_backward's pl.pallas_call sites):
//   tpudist_flash_bwd_dq   <- _bwd_dq_kernel   dq = T(scale * sum_k T(dS) K)
//   tpudist_flash_bwd_dkv  <- _bwd_dkv_kernel  dv = T(sum_q T(P)^T dO),
//                                              dk = T(sum_q T(dS)^T Qs)
// They compute what _flash_backward computes, at its rounding points, not the
// Pallas block structure:
//   - Qs = T(q * (1/sqrt(d))), the rounding of _scaled_q; S = Qs K^T in f32;
//   - keys at or beyond k_len are masked, and with `causal` a key col is
//     visible to row i iff i + (k_len - q_len) >= col (_masked_scores);
//   - P = exp(S - lse) in f32 from the forward's lse, which the caller has
//     clamped (lse <= -1e30/2 -> 0, so a fully masked row gives P = 0, not
//     exp(+huge) * 0 = NaN); a masked pair has P = 0 exactly, whatever K holds;
//   - dP = dO V^T in f32, dS = P * (dP - delta), with delta = rowsum(dO * O)
//     computed by the caller in f32;
//   - the dQ pass rounds dS to T before dS K, accumulates in f32 and stores
//     T(acc * scale); the dKV pass rounds P to T before P^T dO and dS to T
//     before dS^T Qs, and stores dk and dv rounded from f32 with no scale
//     (Qs is already scaled).
// q, k, v and dO are read through their (B, T, H, D) strides (the last dim
// contiguous): the model passes strided views of its fused QKV output. dq, dk
// and dv are written contiguous (B, T, H, D); lse and delta are (B, H, Tq) f32.
//
// What bounds them on this card: at ViT-B/16's training shape (B, T, H, D) =
// (128, 197, 12, 64) in bf16, reckoned with each input read once and each
// output written once, the dQ pass moves ~196 MB (q, k, v, dO, lse, delta in;
// dq out) against 22.9 GFLOP of products (S, dP, dS K), and the dKV pass
// ~235 MB against 30.5 GFLOP (S, dP, P^T dO, dS^T Qs). Against 3.35 TB/s and
// the 989 TFLOP/s bf16 tensor-core peak both are bytes-bound: ~0.058 ms and
// ~0.070 ms. chip_smoke.py recomputes both bounds from the shapes it runs.
//
// What the design does about it, and what it leaves for later:
//   - one thread block per (64-row tile, head, batch): the dQ pass tiles over
//     queries and loops over 64-key tiles, the dKV pass tiles over keys and
//     loops over 64-query tiles; the loop inside the block takes the place of
//     the TPU's sequential "arbitrary" grid axis. Each block owns its output
//     tile, so there are no atomics and the result does not depend on how
//     blocks are scheduled;
//   - each block reads its own tile once and streams the other operand's
//     tiles past it, so q, k, v and dO are read once per tile of the other
//     axis (4 times at T = 197), from L2 for the most part;
//   - tiles are staged in shared memory as f32 with odd row strides, so the
//     dot loops are free of bank conflicts; four threads own one row and split
//     its 64 partner rows and its D output columns; a row's dS (and P) goes
//     through shared memory between the lanes of one warp;
//   - tiles wholly above the causal diagonal are skipped.
// The products run as scalar FMAs on the FP32 pipes, reading both operands
// from shared memory: simple and right first. So the FP32 issue rate and
// shared-memory reads, not the bytes, set their time (PERF.md has it beside
// the bound); tensor-core products (mma.sync, then wgmma/TMA) are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;           // query rows per tile
constexpr int BK = 64;           // keys per tile
constexpr int TPR = 4;           // threads per row
constexpr int THREADS = 64 * TPR;
constexpr int CPT = 64 / TPR;    // partner rows per thread in a tile

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

// Element strides (batch, seq, head) of q, k, v and dO, in that order.
struct Strides {
  int64_t q[3], k[3], v[3], o[3];
};

// rows x D of a (B, T, H, D) tensor into shared memory as f32 (row stride
// D + 1), scaled and rounded to T when `scale` is not 1; rows past `len` are 0.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int64_t st,
                                          int first, int len, float scale,
                                          bool scaled) {
  for (int i = threadIdx.x; i < 64 * D; i += THREADS) {
    const int rr = i / D, d = i % D;
    const int t = first + rr;
    const float x = t < len ? to_f(src[t * st + d]) : 0.f;
    dst[rr * (D + 1) + d] = scaled ? round_to<T>(x * scale) : x;
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (4 * size_t(64) * (D + 1) + size_t(BQ) * (BK + 1));
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (4 * size_t(64) * (D + 1) + 2 * size_t(BK) * (BQ + 1) +
                          2 * size_t(BQ));
}

// The dQ pass: one block per (query tile, head, batch); thread (r, sub) owns
// query row r of the tile, key columns sub + 4j of each key tile and output
// columns sub + 4i.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int H, int Tq, int Tk, Strides st, int causal,
                    float scale) {
  constexpr int DP = D + 1;
  constexpr int SP = BK + 1;
  constexpr int DPT = D / TPR;
  extern __shared__ float smem[];
  float* sQ = smem;              // [BQ][DP] scaled Q, rounded to T
  float* sO = sQ + BQ * DP;      // [BQ][DP] dO
  float* sK = sO + BQ * DP;      // [BK][DP]
  float* sV = sK + BK * DP;      // [BK][DP]
  float* sS = sV + BK * DP;      // [BQ][SP] dS rounded to T

  const int tid = threadIdx.x;
  const int r = tid / TPR;
  const int sub = tid % TPR;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row = q0 + r;
  const int offset = Tk - Tq;

  const T* qb = q + b * st.q[0] + h * st.q[2];
  const T* kb = k + b * st.k[0] + h * st.k[2];
  const T* vb = v + b * st.v[0] + h * st.v[2];
  const T* ob = dout + b * st.o[0] + h * st.o[2];
  load_tile<T, D>(sQ, qb, st.q[1], q0, Tq, scale, true);
  load_tile<T, D>(sO, ob, st.o[1], q0, Tq, 1.f, false);
  const int64_t stat = (int64_t(b) * H + h) * Tq + row;
  const float lse_r = row < Tq ? lse[stat] : 0.f;
  const float delta_r = row < Tq ? delta[stat] : 0.f;

  float acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;

  int nk = (Tk + BK - 1) / BK;
  if (causal) {
    const int last = q0 + BQ - 1 + offset;
    nk = min(nk, last < 0 ? 0 : last / BK + 1);
  }

  const float* qr = sQ + r * DP;
  const float* dor = sO + r * DP;
  float* dsr = sS + r * SP;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();             // the previous tile's reads are done
    load_tile<T, D>(sK, kb, st.k[1], k0, Tk, 1.f, false);
    load_tile<T, D>(sV, vb, st.v[1], k0, Tk, 1.f, false);
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < CPT; ++j) {
      const int c = sub + TPR * j;
      const float* kr = sK + c * DP;
      const float* vr = sV + c * DP;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        s = fmaf(qr[d], kr[d], s);
        dp = fmaf(dor[d], vr[d], dp);
      }
      const int col = k0 + c;
      const bool ok = col < Tk && (!causal || row + offset >= col);
      const float p = ok ? expf(s - lse_r) : 0.f;
      dsr[c] = round_to<T>(p * (dp - delta_r));
    }
    __syncwarp();                // a row's dS comes from lanes of one warp

    for (int kk = 0; kk < BK; ++kk) {
      const float ds = dsr[kk];
      const float* kr = sK + kk * DP;
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] = fmaf(ds, kr[sub + TPR * i], acc[i]);
    }
  }

  if (row < Tq) {
    T* out = dq + ((int64_t(b) * Tq + row) * H + h) * D;
#pragma unroll
    for (int i = 0; i < DPT; ++i) out[sub + TPR * i] = from_f<T>(acc[i] * scale);
  }
}

// The dKV pass: one block per (key tile, head, batch); thread (c, sub) owns
// key row c of the tile, query rows sub + 4j of each query tile and output
// columns sub + 4i of dk and dv.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int Tq, int Tk, Strides st,
                     int causal, float scale) {
  constexpr int DP = D + 1;
  constexpr int PP = BQ + 1;
  constexpr int DPT = D / TPR;
  extern __shared__ float smem[];
  float* sK = smem;              // [BK][DP]
  float* sV = sK + BK * DP;      // [BK][DP]
  float* sQ = sV + BK * DP;      // [BQ][DP] scaled Q, rounded to T
  float* sO = sQ + BQ * DP;      // [BQ][DP] dO
  float* sP = sO + BQ * DP;      // [BK][PP] P rounded to T
  float* sS = sP + BK * PP;      // [BK][PP] dS rounded to T
  float* sL = sS + BK * PP;      // [BQ] lse
  float* sD = sL + BQ;           // [BQ] delta

  const int tid = threadIdx.x;
  const int c = tid / TPR;
  const int sub = tid % TPR;
  const int k0 = blockIdx.x * BK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int key = k0 + c;
  const int offset = Tk - Tq;

  const T* qb = q + b * st.q[0] + h * st.q[2];
  const T* kb = k + b * st.k[0] + h * st.k[2];
  const T* vb = v + b * st.v[0] + h * st.v[2];
  const T* ob = dout + b * st.o[0] + h * st.o[2];
  const float* lb = lse + (int64_t(b) * H + h) * Tq;
  const float* db = delta + (int64_t(b) * H + h) * Tq;
  load_tile<T, D>(sK, kb, st.k[1], k0, Tk, 1.f, false);
  load_tile<T, D>(sV, vb, st.v[1], k0, Tk, 1.f, false);

  float dk_acc[DPT], dv_acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  // Query tiles whose every row lies above the causal diagonal of this key
  // tile's first key are skipped.
  int qt0 = 0;
  if (causal) {
    const int lo = k0 - offset - (BQ - 1);
    qt0 = lo <= 0 ? 0 : (lo + BQ - 1) / BQ;
  }
  const int nq = (Tq + BQ - 1) / BQ;

  const float* kr = sK + c * DP;
  const float* vr = sV + c * DP;
  float* pr = sP + c * PP;
  float* dsr = sS + c * PP;
  for (int qt = qt0; qt < nq; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();             // the previous tile's reads are done
    load_tile<T, D>(sQ, qb, st.q[1], q0, Tq, scale, true);
    load_tile<T, D>(sO, ob, st.o[1], q0, Tq, 1.f, false);
    if (tid < BQ) {
      const int t = q0 + tid;
      sL[tid] = t < Tq ? lb[t] : 0.f;
      sD[tid] = t < Tq ? db[t] : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < CPT; ++j) {
      const int i = sub + TPR * j;
      const float* qr = sQ + i * DP;
      const float* dor = sO + i * DP;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        s = fmaf(qr[d], kr[d], s);
        dp = fmaf(dor[d], vr[d], dp);
      }
      const int qrow = q0 + i;
      const bool ok = key < Tk && qrow < Tq &&
                      (!causal || qrow + offset >= key);
      const float p = ok ? expf(s - sL[i]) : 0.f;
      pr[i] = round_to<T>(p);
      dsr[i] = round_to<T>(p * (dp - sD[i]));
    }
    __syncwarp();                // a key's P and dS come from lanes of one warp

    for (int ii = 0; ii < BQ; ++ii) {
      const float p = pr[ii];
      const float ds = dsr[ii];
      const float* qr = sQ + ii * DP;
      const float* dor = sO + ii * DP;
#pragma unroll
      for (int t = 0; t < DPT; ++t) {
        const int col = sub + TPR * t;
        dv_acc[t] = fmaf(p, dor[col], dv_acc[t]);
        dk_acc[t] = fmaf(ds, qr[col], dk_acc[t]);
      }
    }
  }

  if (key < Tk) {
    const int64_t base = ((int64_t(b) * Tk + key) * H + h) * D;
#pragma unroll
    for (int t = 0; t < DPT; ++t) {
      dk[base + sub + TPR * t] = from_f<T>(dk_acc[t]);
      dv[base + sub + TPR * t] = from_f<T>(dv_acc[t]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *out0, *out1;             // dq; or dk and dv
  int B, H, Tq, Tk, causal;
  float scale;
  Strides st;
  cudaStream_t stream;
};

template <typename T, int D>
cudaError_t launch_dq(const Args& a) {
  constexpr size_t smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((a.Tq + BQ - 1) / BQ, a.H, a.B);
  flash_bwd_dq_kernel<T, D><<<grid, THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.out0), a.H, a.Tq, a.Tk, a.st, a.causal, a.scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((a.Tk + BK - 1) / BK, a.H, a.B);
  flash_bwd_dkv_kernel<T, D><<<grid, THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.out0), static_cast<T*>(a.out1), a.H, a.Tq, a.Tk,
      a.st, a.causal, a.scale);
  return cudaGetLastError();
}

template <bool DQ, typename T>
cudaError_t dispatch_dim(int head_dim, const Args& a) {
  switch (head_dim) {
    case 32: return DQ ? launch_dq<T, 32>(a) : launch_dkv<T, 32>(a);
    case 64: return DQ ? launch_dq<T, 64>(a) : launch_dkv<T, 64>(a);
    case 80: return DQ ? launch_dq<T, 80>(a) : launch_dkv<T, 80>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <bool DQ>
int run(int dtype, int head_dim, const void* q, const void* k, const void* v,
        const void* dout, const void* lse, const void* delta, void* out0,
        void* out1, int B, int H, int Tq, int Tk, const long long* st,
        int causal, float scale, void* stream) {
  Args a{q, k, v, dout, lse, delta, out0, out1, B, H, Tq, Tk, causal, scale,
         {}, static_cast<cudaStream_t>(stream)};
  for (int i = 0; i < 3; ++i) {
    a.st.q[i] = st[i];
    a.st.k[i] = st[3 + i];
    a.st.v[i] = st[6 + i];
    a.st.o[i] = st[9 + i];
  }
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_dim<DQ, float>(head_dim, a);
  else if (dtype == 1)
    err = dispatch_dim<DQ, __nv_bfloat16>(head_dim, a);
  else
    err = cudaErrorInvalidValue;
  return int(err);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. st: the (batch, seq, head) element
// strides of q, k, v and dO in that order. lse (clamped) and delta are
// (B, H, Tq) f32. Each returns a cudaError_t (0 = launched).
extern "C" int tpudist_flash_bwd_dq(int dtype, int head_dim, const void* q,
                                    const void* k, const void* v,
                                    const void* dout, const void* lse,
                                    const void* delta, void* dq, int B, int H,
                                    int Tq, int Tk, const long long* st,
                                    int causal, float scale, void* stream) {
  return run<true>(dtype, head_dim, q, k, v, dout, lse, delta, dq, nullptr, B,
                   H, Tq, Tk, st, causal, scale, stream);
}

extern "C" int tpudist_flash_bwd_dkv(int dtype, int head_dim, const void* q,
                                     const void* k, const void* v,
                                     const void* dout, const void* lse,
                                     const void* delta, void* dk, void* dv,
                                     int B, int H, int Tq, int Tk,
                                     const long long* st, int causal,
                                     float scale, void* stream) {
  return run<false>(dtype, head_dim, q, k, v, dout, lse, delta, dk, dv, B, H,
                    Tq, Tk, st, causal, scale, stream);
}
