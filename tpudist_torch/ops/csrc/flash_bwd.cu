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
// Both passes do their products over 64 x 64 tiles, so at T = 197 (four tiles,
// the last one 5 rows full) they compute 1.69x the FLOPs of the visible pairs;
// even so, at the tensor cores' peak the products (~0.039 and ~0.052 ms) stay
// under the bytes bound, while on the FP32 pipes (~6 TFLOP/s reached, 67 peak)
// they took 4-6 ms a pass. The dKV pass holds the most live state (four
// accumulator sets); its registers, not shared memory, cap the blocks an SM
// runs.
//
// Shared by both dtypes:
//   - one thread block per (64-row tile, head, batch): the dQ pass tiles over
//     queries and loops over 64-key tiles, the dKV pass tiles over keys and
//     loops over 64-query tiles; the loop inside the block takes the place of
//     the TPU's sequential "arbitrary" grid axis. Each block owns its output
//     tile, so there are no atomics and the result does not depend on how
//     blocks are scheduled: two launches on the same inputs are bit-identical;
//   - each block reads its own tile once and streams the other operand's
//     tiles past it, so q, k, v and dO are read once per tile of the other
//     axis (4 times at T = 197), from L2 for the most part;
//   - tiles wholly above the causal diagonal are skipped.
//
// bf16 and float16 (the training paths, --use_amp --amp-dtype bfloat16 or
// float16): tensor cores, flash_bwd_dq_mma<E, D> and flash_bwd_dkv_mma<E, D>,
// one instantiation per 16-bit element type E. Four warps a block, each
// owning 16 rows of the block's 64 (queries in the dQ pass, keys in the dKV
// pass). Every product is mma.sync.m16n8k16.row.col.f32.E.E.f32 (.bf16.bf16
// or .f16.f16): 16-bit operands, f32 accumulators (the PTX helpers, shared
// with the forward, are in mma_bf16.cuh). That is exactly _flash_backward's
// arithmetic, because every operand it feeds a product is already rounded
// to E (in float16 a P or dS below 2^-25 rounds to 0 and one past 65504 to
// inf, at the same points in the plain version):
//   S   = Qs K^T      A: Qs (dQ pass) or K (dKV: S^T = K Qs^T), B: the other
//   dP  = dO V^T      A: dO or V, B: the other
//   dQ += T(dS) K     A: T(dS) packed from S/dP's C fragments, B: K (.trans)
//   dV += T(P)^T dO   A: T(P^T) from the C fragments, B: dO (.trans)
//   dK += T(dS)^T Qs  A: T(dS^T) from the C fragments, B: Qs (.trans)
// Only the order of the f32 sums differs from the plain version, so an entry
// of P or dS lying at a bf16 rounding boundary can round the other way: the
// results are within the Pallas backward's 1e-2 bound, not bit-equal. An
// inf or NaN in dO (an overflow the dynamic loss scale must see) reaches
// dq, dk and dv through delta and the products, as in the plain version.
//   - tiles reach shared memory by cp.async (16 bytes a thread, zero-filled
//     past Tq / Tk), as 16-bit rows padded by 8 elements, so ldmatrix reads
//     8 rows at 8 distinct 16-byte bank groups for D = 32, 64 and 80;
//   - the streamed tiles are double-buffered: the copy of tile i+1 is in
//     flight while the warps multiply tile i;
//   - Qs = T(f32(q) * scale) is formed once per Q tile, in shared memory (at
//     D = 64 the scale is a power of two and the rounding is exact; at 32
//     and 80 it is not);
//   - the dQ pass keeps its warp's Qs and dO A fragments in registers for
//     the whole key loop; the dKV pass reloads K and V fragments from shared
//     memory each query tile, which keeps its four accumulator sets (S^T,
//     dP^T, dK, dV: 4 x 32 f32 a thread at D = 64) clear of spills;
//   - S and dP's C fragments turn into P and dS in registers and are packed
//     to 16-bit A fragments (two n8 C tiles make one k16 A tile) with no trip
//     through shared memory; lse and delta come per row from registers (dQ
//     pass) or per column from shared memory (dKV pass).
// A masked pair (key >= Tk, query >= Tq, or causal at the Tk - Tq offset) gets
// P = 0 by the mask, never from exp: a row that sees no key (lse clamped to 0)
// gets dq = 0 exactly.
//
// f32 keeps the scalar kernels: on tensor cores f32 would run as TF32, whose
// 10-bit mantissa breaks the 1e-5 bound the f32 backward is held to. Tiles
// are staged in shared memory as f32 with odd row strides; four threads own
// one row and split its 64 partner rows and its D output columns; a row's dS
// (and P) goes through shared memory between the lanes of one warp. The
// products are scalar FMAs on the FP32 pipes, bit-equal to the plain version.
//
// Left for later: wgmma on 64-row warpgroup tiles with TMA loads into
// swizzled shared memory, a producer warp, and a persistent grid; 128-row
// tiles, which would also cut the re-reads of the streamed operand.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

#include "mma_bf16.cuh"

namespace {

constexpr int BQ = 64;           // query rows per tile
constexpr int BK = 64;           // keys per tile
constexpr int TPR = 4;           // threads per row
constexpr int THREADS = 64 * TPR;
constexpr int CPT = 64 / TPR;    // partner rows per thread in a tile

// The scalar kernels below run f32 only (bf16 and float16 take the
// tensor-core ones).
__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

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

// ---- bf16 and float16: tensor-core kernels ----------------------------------

template <int D>
constexpr size_t dq_mma_smem_bytes() { return 6 * tile_bytes<D>(); }

template <int D>
constexpr size_t dkv_mma_smem_bytes() {
  return 6 * tile_bytes<D>() + 4 * 64 * sizeof(float);
}

// The dQ pass in bf16 or float16 (E): one block per (query tile, head,
// batch); warp w owns query rows 16w..16w+15; lane (g, tg) = (lane / 4,
// lane % 4) holds rows g and g + 8 and, of each n8 tile, columns 2tg and
// 2tg + 1.
template <typename E, int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_bwd_dq_mma(const E* __restrict__ q, const E* __restrict__ k,
                 const E* __restrict__ v, const E* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, E* __restrict__ dq, int H,
                 int Tq, int Tk, Strides st, int causal, float scale) {
  constexpr int LD = ld_of<D>();
  constexpr int TILE = 64 * LD;
  constexpr int KS = D / 16;     // k16 steps over D
  constexpr int NT = D / 8;      // n8 tiles over D
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* sQ = reinterpret_cast<E*>(smem_raw);         // Qs
  E* sO = sQ + TILE;                              // dO
  E* sK = sO + TILE;                              // 2 buffers
  E* sV = sK + 2 * TILE;                          // 2 buffers

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tg = lane % 4;
  const int q0 = blockIdx.x * 64, h = blockIdx.y, b = blockIdx.z;
  const int offset = Tk - Tq;

  const E* qb = q + b * st.q[0] + h * st.q[2];
  const E* kb = k + b * st.k[0] + h * st.k[2];
  const E* vb = v + b * st.v[0] + h * st.v[2];
  const E* ob = dout + b * st.o[0] + h * st.o[2];

  int nk = (Tk + 63) / 64;
  if (causal) {
    const int last = q0 + 63 + offset;
    nk = min(nk, last < 0 ? 0 : last / 64 + 1);
  }

  copy_tile<D, E>(sQ, qb, st.q[1], q0, Tq);
  copy_tile<D, E>(sO, ob, st.o[1], q0, Tq);
  cp_async_commit();
  if (nk > 0) {
    copy_tile<D, E>(sK, kb, st.k[1], 0, Tk);
    copy_tile<D, E>(sV, vb, st.v[1], 0, Tk);
  }
  cp_async_commit();

  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  const int64_t stat = (int64_t(b) * H + h) * Tq;
  const float lse0 = row0 < Tq ? lse[stat + row0] : 0.f;
  const float lse1 = row1 < Tq ? lse[stat + row1] : 0.f;
  const float dl0 = row0 < Tq ? delta[stat + row0] : 0.f;
  const float dl1 = row1 < Tq ? delta[stat + row1] : 0.f;

  cp_async_wait<1>();            // Q and dO have landed
  __syncthreads();
  scale_tile<D, E>(sQ, scale);
  __syncthreads();

  uint32_t aQ[KS][4], aO[KS][4];
  const int ar = warp * 16 + a_row(lane), ac = a_col(lane);
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    ldsm_x4(aQ[ks], sQ + ar * LD + ks * 16 + ac);
    ldsm_x4(aO[ks], sO + ar * LD + ks * 16 + ac);
  }

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int br = b_row(lane), bc = b_col(lane);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * 64;
    const E* cK = sK + (kt & 1) * TILE;
    const E* cV = sV + (kt & 1) * TILE;
    if (kt + 1 < nk) {
      copy_tile<D, E>(sK + ((kt + 1) & 1) * TILE, kb, st.k[1], k0 + 64, Tk);
      copy_tile<D, E>(sV + ((kt + 1) & 1) * TILE, vb, st.v[1], k0 + 64, Tk);
    }
    cp_async_commit();
    cp_async_wait<1>();          // tile kt has landed
    __syncthreads();

    // S = Qs K^T and dP = dO V^T over the warp's 16 rows x 64 keys.
    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t bk[4], bv[4];
        ldsm_x4(bk, cK + (j * 16 + br) * LD + ks * 16 + bc);
        ldsm_x4(bv, cV + (j * 16 + br) * LD + ks * 16 + bc);
        mma16<E>(s[2 * j], aQ[ks], bk[0], bk[1]);
        mma16<E>(s[2 * j + 1], aQ[ks], bk[2], bk[3]);
        mma16<E>(dp[2 * j], aO[ks], bv[0], bv[1]);
        mma16<E>(dp[2 * j + 1], aO[ks], bv[2], bv[3]);
      }
    }

    // P = exp(S - lse) where visible, else 0; dS = P (dP - delta), into s.
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? row0 : row1;
        const int col = k0 + n * 8 + 2 * tg + (e & 1);
        const bool ok = row < Tq && col < Tk && (!causal || row + offset >= col);
        const float p = ok ? expf(s[n][e] - (e < 2 ? lse0 : lse1)) : 0.f;
        s[n][e] = p * (dp[n][e] - (e < 2 ? dl0 : dl1));
      }
    }

    // dQ += T(dS) K, K read transposed.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t aS[4];
      pack_a<E>(aS, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        uint32_t bk[4];
        ldsm_x4_t(bk, cK + (kk * 16 + a_row(lane)) * LD + j * 16 + ac);
        mma16<E>(acc[2 * j], aS, bk[0], bk[1]);
        mma16<E>(acc[2 * j + 1], aS, bk[2], bk[3]);
      }
    }
    __syncthreads();             // buffer kt & 1 is free for tile kt + 2
  }
  cp_async_wait<0>();

  const int64_t r0 = ((int64_t(b) * Tq + row0) * H + h) * D;
  const int64_t r1 = ((int64_t(b) * Tq + row1) * H + h) * D;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = n * 8 + 2 * tg;
    if (row0 < Tq)
      *reinterpret_cast<uint32_t*>(dq + r0 + col) =
          pack2<E>(acc[n][0] * scale, acc[n][1] * scale);
    if (row1 < Tq)
      *reinterpret_cast<uint32_t*>(dq + r1 + col) =
          pack2<E>(acc[n][2] * scale, acc[n][3] * scale);
  }
}

// The dKV pass in bf16 or float16 (E): one block per (key tile, head,
// batch); warp w owns keys 16w..16w+15 and works in the transposed
// orientation (S^T = K Qs^T, dP^T = V dO^T), so P^T and dS^T leave the
// accumulators already laid out as A fragments for dV += T(P)^T dO and
// dK += T(dS)^T Qs.
template <typename E, int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_bwd_dkv_mma(const E* __restrict__ q, const E* __restrict__ k,
                  const E* __restrict__ v, const E* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, E* __restrict__ dk,
                  E* __restrict__ dv, int H, int Tq, int Tk, Strides st,
                  int causal, float scale) {
  constexpr int LD = ld_of<D>();
  constexpr int TILE = 64 * LD;
  constexpr int KS = D / 16;
  constexpr int NT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* sK = reinterpret_cast<E*>(smem_raw);
  E* sV = sK + TILE;
  E* sQ = sV + TILE;             // 2 buffers, Qs once formed
  E* sO = sQ + 2 * TILE;         // 2 buffers
  float* sL = reinterpret_cast<float*>(sO + 2 * TILE);   // [2][64] lse
  float* sD = sL + 2 * 64;                               // [2][64] delta

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tg = lane % 4;
  const int k0 = blockIdx.x * 64, h = blockIdx.y, b = blockIdx.z;
  const int offset = Tk - Tq;

  const E* qb = q + b * st.q[0] + h * st.q[2];
  const E* kb = k + b * st.k[0] + h * st.k[2];
  const E* vb = v + b * st.v[0] + h * st.v[2];
  const E* ob = dout + b * st.o[0] + h * st.o[2];
  const float* lb = lse + (int64_t(b) * H + h) * Tq;
  const float* db = delta + (int64_t(b) * H + h) * Tq;

  // Query tiles whose every row lies above the causal diagonal of this key
  // tile's first key are skipped.
  int qt0 = 0;
  if (causal) {
    const int lo = k0 - offset - 63;
    qt0 = lo <= 0 ? 0 : (lo + 63) / 64;
  }
  const int nq = (Tq + 63) / 64;

  // Q, dO, lse and delta of query tile qt into buffer `buf`.
  auto copy_q_tile = [&](int qt, int buf) {
    const int q0 = qt * 64;
    copy_tile<D, E>(sQ + buf * TILE, qb, st.q[1], q0, Tq);
    copy_tile<D, E>(sO + buf * TILE, ob, st.o[1], q0, Tq);
    const int i = tid & 63, t = q0 + i;
    const float* src = tid < 64 ? lb : db;
    float* dst = (tid < 64 ? sL : sD) + buf * 64 + i;
    cp_async4(dst, t < Tq ? src + t : src, t < Tq);
  };

  copy_tile<D, E>(sK, kb, st.k[1], k0, Tk);
  copy_tile<D, E>(sV, vb, st.v[1], k0, Tk);
  cp_async_commit();
  if (qt0 < nq) copy_q_tile(qt0, 0);
  cp_async_commit();

  float dk_acc[NT][4], dv_acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  const int key0 = k0 + warp * 16 + g, key1 = key0 + 8;
  const int ar = warp * 16 + a_row(lane), ac = a_col(lane);
  const int br = b_row(lane), bc = b_col(lane);
  for (int qt = qt0; qt < nq; ++qt) {
    const int q0 = qt * 64;
    const int buf = (qt - qt0) & 1;
    E* cQ = sQ + buf * TILE;
    const E* cO = sO + buf * TILE;
    const float* cL = sL + buf * 64;
    const float* cD = sD + buf * 64;
    if (qt + 1 < nq) copy_q_tile(qt + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();          // K, V and query tile qt have landed
    __syncthreads();
    scale_tile<D, E>(cQ, scale);
    __syncthreads();

    // S^T = K Qs^T and dP^T = V dO^T over the warp's 16 keys x 64 queries.
    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t aK[4], aV[4];
      ldsm_x4(aK, sK + ar * LD + ks * 16 + ac);
      ldsm_x4(aV, sV + ar * LD + ks * 16 + ac);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t bq[4], bo[4];
        ldsm_x4(bq, cQ + (j * 16 + br) * LD + ks * 16 + bc);
        ldsm_x4(bo, cO + (j * 16 + br) * LD + ks * 16 + bc);
        mma16<E>(s[2 * j], aK, bq[0], bq[1]);
        mma16<E>(s[2 * j + 1], aK, bq[2], bq[3]);
        mma16<E>(dp[2 * j], aV, bo[0], bo[1]);
        mma16<E>(dp[2 * j + 1], aV, bo[2], bo[3]);
      }
    }

    // P^T = exp(S^T - lse[col]) where visible, else 0, into s; dS^T into dp.
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = e < 2 ? key0 : key1;
        const int c = n * 8 + 2 * tg + (e & 1);
        const int qrow = q0 + c;
        const bool ok = key < Tk && qrow < Tq && (!causal || qrow + offset >= key);
        const float p = ok ? expf(s[n][e] - cL[c]) : 0.f;
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - cD[c]);
      }
    }

    // dV += T(P^T) dO and dK += T(dS^T) Qs, dO and Qs read transposed.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t aP[4], aS[4];
      pack_a<E>(aP, s[2 * kk], s[2 * kk + 1]);
      pack_a<E>(aS, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        uint32_t bo[4], bq[4];
        ldsm_x4_t(bo, cO + (kk * 16 + a_row(lane)) * LD + j * 16 + ac);
        ldsm_x4_t(bq, cQ + (kk * 16 + a_row(lane)) * LD + j * 16 + ac);
        mma16<E>(dv_acc[2 * j], aP, bo[0], bo[1]);
        mma16<E>(dv_acc[2 * j + 1], aP, bo[2], bo[3]);
        mma16<E>(dk_acc[2 * j], aS, bq[0], bq[1]);
        mma16<E>(dk_acc[2 * j + 1], aS, bq[2], bq[3]);
      }
    }
    __syncthreads();             // buffer `buf` is free for tile qt + 2
  }
  cp_async_wait<0>();

  const int64_t r0 = ((int64_t(b) * Tk + key0) * H + h) * D;
  const int64_t r1 = ((int64_t(b) * Tk + key1) * H + h) * D;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = n * 8 + 2 * tg;
    if (key0 < Tk) {
      *reinterpret_cast<uint32_t*>(dk + r0 + col) =
          pack2<E>(dk_acc[n][0], dk_acc[n][1]);
      *reinterpret_cast<uint32_t*>(dv + r0 + col) =
          pack2<E>(dv_acc[n][0], dv_acc[n][1]);
    }
    if (key1 < Tk) {
      *reinterpret_cast<uint32_t*>(dk + r1 + col) =
          pack2<E>(dk_acc[n][2], dk_acc[n][3]);
      *reinterpret_cast<uint32_t*>(dv + r1 + col) =
          pack2<E>(dv_acc[n][2], dv_acc[n][3]);
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

template <typename E, int D>
cudaError_t launch_dq_mma(const Args& a) {
  constexpr size_t smem = dq_mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_mma<E, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((a.Tq + 63) / 64, a.H, a.B);
  flash_bwd_dq_mma<E, D><<<grid, MMA_THREADS, smem, a.stream>>>(
      static_cast<const E*>(a.q), static_cast<const E*>(a.k),
      static_cast<const E*>(a.v), static_cast<const E*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<E*>(a.out0), a.H, a.Tq, a.Tk, a.st, a.causal, a.scale);
  return cudaGetLastError();
}

template <typename E, int D>
cudaError_t launch_dkv_mma(const Args& a) {
  constexpr size_t smem = dkv_mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_mma<E, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((a.Tk + 63) / 64, a.H, a.B);
  flash_bwd_dkv_mma<E, D><<<grid, MMA_THREADS, smem, a.stream>>>(
      static_cast<const E*>(a.q), static_cast<const E*>(a.k),
      static_cast<const E*>(a.v), static_cast<const E*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<E*>(a.out0), static_cast<E*>(a.out1), a.H, a.Tq, a.Tk,
      a.st, a.causal, a.scale);
  return cudaGetLastError();
}

// f32 runs the scalar kernels; bf16 and float16 the tensor-core ones.
template <bool DQ, typename T>
cudaError_t dispatch_dim(int head_dim, const Args& a) {
  if constexpr (!std::is_same_v<T, float>) {
    switch (head_dim) {
      case 32: return DQ ? launch_dq_mma<T, 32>(a) : launch_dkv_mma<T, 32>(a);
      case 64: return DQ ? launch_dq_mma<T, 64>(a) : launch_dkv_mma<T, 64>(a);
      case 80: return DQ ? launch_dq_mma<T, 80>(a) : launch_dkv_mma<T, 80>(a);
      default: return cudaErrorInvalidValue;
    }
  } else {
    switch (head_dim) {
      case 32: return DQ ? launch_dq<T, 32>(a) : launch_dkv<T, 32>(a);
      case 64: return DQ ? launch_dq<T, 64>(a) : launch_dkv<T, 64>(a);
      case 80: return DQ ? launch_dq<T, 80>(a) : launch_dkv<T, 80>(a);
      default: return cudaErrorInvalidValue;
    }
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
    err = dispatch_dim<DQ, bf16>(head_dim, a);
  else if (dtype == 2)
    err = dispatch_dim<DQ, f16>(head_dim, a);
  else
    err = cudaErrorInvalidValue;
  return int(err);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. st: the (batch, seq, head)
// element strides of q, k, v and dO in that order. lse (clamped) and delta are
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
