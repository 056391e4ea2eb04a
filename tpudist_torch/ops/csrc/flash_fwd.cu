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
// q, k and v are read through their (B, T, H, D) strides (the last dim
// contiguous): the model passes strided views of its fused QKV output, so no
// transpose or copy precedes the kernel. O is written contiguous (B, T, H, D),
// the layout the output projection reads; lse is (B, H, Tq) f32.
//
// What bounds it on this card: at ViT-B/16's training shape (B, T, H, D) =
// (128, 197, 12, 64) in bf16 one call moves 156 MB (q, k, v in; O and lse
// out) against 15.3 GFLOP of products over the visible pairs, so against
// 3.35 TB/s and the 989 TFLOP/s bf16 tensor-core peak it is bytes-bound
// (~0.047 ms); at the serving batches 1..8 the bound is a few microseconds
// and launch latency sets the floor. With 64 x 64 tiles at T = 197 (four
// tiles, the last 5 rows full) the products are 25.8 GFLOP, still under the
// bytes bound at the tensor cores' peak; on the FP32 pipes (~6 TFLOP/s
// reached) they took 2.5 ms. As built, the tensor-core kernel takes 0.22 ms
// there (~118 TFLOP/s of padded tiles) and ~0.014 ms of device time at batch
// 1, on an H100 80GB HBM3 at 700 W (chip_smoke.py; PERF.md).
//
// Shared by both dtypes: one thread block per (query tile of 64 rows, head,
// batch); a loop over 64-key tiles inside the block takes the place of the
// TPU's sequential "arbitrary" grid axis. A 64-row tile gives 48 blocks at
// batch 1 on 132 SMs (24 with 128-row tiles). Key tiles past k_len, or
// (causal) wholly above the diagonal for every row of the block, are skipped.
// Each block owns its output rows, so two launches give the same bits.
//
// bf16 and float16 (serving and the --use_amp training paths, --amp-dtype
// bfloat16 or float16): tensor cores, flash_fwd_mma<E, D>, one instantiation
// per 16-bit element type E. Four warps a block, each owning 16 query rows.
// Both products are mma.sync.m16n8k16.row.col.f32.E.E.f32 (.bf16.bf16 or
// .f16.f16; the helpers are in mma_bf16.cuh), which is exactly
// _flash_forward's arithmetic: every operand it feeds a product is already
// rounded to E. In float16, P below 2^-25 rounds to 0 where bf16 keeps it, and
// O past 65504 rounds to inf; the plain version rounds at the same points.
//   S   = Qs K^T   A: Qs, kept in registers for the whole key loop;
//                  B: K by ldmatrix (a [key][d] tile is B's [n][k] order)
//   O  += T(P) V   A: T(P) packed from two n8 C tiles of S into one k16 A
//                  tile, in registers; B: V by ldmatrix.trans
//   - Qs = T(f32(q) * scale) is formed once per tile in shared memory (at
//     D = 64 the scale is a power of two and the rounding is exact; at 32
//     and 80 it is not);
//   - K and V tiles reach shared memory by 16-byte cp.async (zero-filled past
//     Tk) as 16-bit rows padded by 8 elements, double-buffered: the copy of
//     tile i+1 is in flight while the warps multiply tile i;
//   - the online softmax runs on S's C fragments: a lane holds two rows
//     (g and g + 8), so the row max reduces over the lane quad with two
//     shuffles, and the rescale alpha of each row scales exactly that row's
//     accumulator entries (c[0..1] and c[2..3] of every n8 tile of O). Each
//     lane sums its share of l (rescaled by the same alpha) and the quad
//     adds the shares once, at the end;
//   - a masked pair gets P = 0 by the mask, never from exp: while m is still
//     -1e30, exp(s - m) of a masked column would be 1. Tiles whose every pair
//     is visible skip the mask.
// Only the order of the f32 sums differs from the plain version (and P is
// rounded from exp(S - m) at the running max m, as in the Pallas kernel, not
// at the row's final max), so O is within the 1e-2 bound, not bit-equal.
//
// f32 keeps the scalar kernel, flash_fwd_kernel: on tensor cores f32 would
// run as TF32, whose 10-bit mantissa breaks the 2e-5 bound the f32 forward is
// held to. Tiles are staged in shared memory as f32 with odd row strides;
// four threads own one query row and split its 64 scores and its D output
// columns; the products are scalar FMAs on the FP32 pipes.
//
// Left for later: wgmma on 64-row warpgroup tiles with TMA loads into
// swizzled shared memory, a producer warp, and a persistent grid; 128-row
// tiles, which would halve the re-reads of K and V.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int BQ = 64;           // query rows per block
constexpr int BK = 64;           // keys per k-tile
constexpr int TPR = 4;           // threads per query row
constexpr int THREADS = BQ * TPR;
constexpr int CPT = BK / TPR;    // score columns per thread
constexpr float NEG_INF = -1e30f;

// The batch, seq and head element strides of q, k and v.
struct Strides {
  int64_t q[3], k[3], v[3];
};

// ---- f32: the scalar kernel -------------------------------------------------

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t(BQ) * (D + 1) + size_t(BK) * (D + 1) +
                          size_t(BK) * D + size_t(BQ) * (BK + 1));
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int H, int Tq, int Tk, Strides st,
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

  const float* qb = q + b * st.q[0] + h * st.q[2];
  const float* kb = k + b * st.k[0] + h * st.k[2];
  const float* vb = v + b * st.v[0] + h * st.v[2];

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int rr = i / D, d = i % D;
    const int qi = q0 + rr;
    sQ[rr * DP + d] = qi < Tq ? qb[qi * st.q[1] + d] * scale : 0.f;
  }

  float m = NEG_INF, l = 0.f;
  float acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;

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
      sK[rr * DP + d] = in ? kb[key * st.k[1] + d] : 0.f;
      sV[rr * D + d] = in ? vb[key * st.v[1] + d] : 0.f;
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
      pr[sub + TPR * j] = p;
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
    float* orow = o + ((int64_t(b) * Tq + row) * H + h) * D;
#pragma unroll
    for (int i = 0; i < DPT; ++i) orow[sub + TPR * i] = acc[i] / l_safe;
    if (sub == 0) lse[(int64_t(b) * H + h) * Tq + row] = m + logf(l_safe);
  }
}

// ---- bf16 and float16: the tensor-core kernel --------------------------------

template <int D>
constexpr size_t mma_smem_bytes() { return 5 * tile_bytes<D>(); }

// One block per (query tile, head, batch); warp w owns query rows
// 16w..16w+15; lane (g, tg) = (lane / 4, lane % 4) holds rows g and g + 8
// and, of each n8 tile, columns 2tg and 2tg + 1.
template <typename E, int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_fwd_mma(const E* __restrict__ q, const E* __restrict__ k,
              const E* __restrict__ v, E* __restrict__ o,
              float* __restrict__ lse, int H, int Tq, int Tk, Strides st,
              int causal, float scale) {
  constexpr int LD = ld_of<D>();
  constexpr int TILE = 64 * LD;
  constexpr int KS = D / 16;     // k16 steps over D
  constexpr int NT = D / 8;      // n8 tiles over D
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* sQ = reinterpret_cast<E*>(smem_raw);         // Qs
  E* sK = sQ + TILE;                              // 2 buffers
  E* sV = sK + 2 * TILE;                          // 2 buffers

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tg = lane % 4;
  const int q0 = blockIdx.x * 64, h = blockIdx.y, b = blockIdx.z;
  const int offset = Tk - Tq;

  const E* qb = q + b * st.q[0] + h * st.q[2];
  const E* kb = k + b * st.k[0] + h * st.k[2];
  const E* vb = v + b * st.v[0] + h * st.v[2];

  int nk = (Tk + 63) / 64;
  if (causal) {
    const int last = q0 + 63 + offset;
    nk = min(nk, last < 0 ? 0 : last / 64 + 1);
  }

  copy_tile<D, E>(sQ, qb, st.q[1], q0, Tq);
  cp_async_commit();
  if (nk > 0) {
    copy_tile<D, E>(sK, kb, st.k[1], 0, Tk);
    copy_tile<D, E>(sV, vb, st.v[1], 0, Tk);
  }
  cp_async_commit();

  cp_async_wait<1>();            // Q has landed
  __syncthreads();
  scale_tile<D, E>(sQ, scale);
  __syncthreads();

  uint32_t aQ[KS][4];
  const int ar = warp * 16 + a_row(lane), ac = a_col(lane);
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) ldsm_x4(aQ[ks], sQ + ar * LD + ks * 16 + ac);

  // Per row (g, g + 8): the running max, this lane's share of l, and the
  // f32 accumulators of O.
  const int row0 = q0 + warp * 16 + g;
  float m[2] = {NEG_INF, NEG_INF}, ls[2] = {0.f, 0.f};
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

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

    // S = Qs K^T over the warp's 16 rows x 64 keys.
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t bk[4];
        ldsm_x4(bk, cK + (j * 16 + br) * LD + ks * 16 + bc);
        mma16<E>(s[2 * j], aQ[ks], bk[0], bk[1]);
        mma16<E>(s[2 * j + 1], aQ[ks], bk[2], bk[3]);
      }
    }

    // Which pairs are visible: bit 4n + e for s[n][e]. A tile whose keys all
    // lie below Tk and (causal) on or below the diagonal of the block's
    // first row needs no mask.
    uint32_t valid = 0xffffffffu;
    if (k0 + 64 > Tk || (causal && q0 + offset < k0 + 63)) {
      valid = 0u;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = row0 + (e >> 1) * 8;
          const int col = k0 + n * 8 + 2 * tg + (e & 1);
          const bool ok = col < Tk && (!causal || row + offset >= col);
          valid |= uint32_t(ok) << (4 * n + e);
        }
    }

    // Online softmax: the new row max over the quad, alpha = exp(m - m_next)
    // for the old sums, P = exp(S - m_next) where visible, else 0.
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = NEG_INF;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          if ((valid >> (4 * n + 2 * r + c)) & 1u)
            mx = fmaxf(mx, s[n][2 * r + c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_next = fmaxf(m[r], mx);
      alpha[r] = expf(m[r] - m_next);
      m[r] = m_next;
      ls[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p =
            (valid >> (4 * n + e)) & 1u ? expf(s[n][e] - m[e >> 1]) : 0.f;
        s[n][e] = p;
        ls[e >> 1] += p;
      }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += T(P) V, V read transposed.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t aP[4];
      pack_a<E>(aP, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        uint32_t bv[4];
        ldsm_x4_t(bv, cV + (kk * 16 + a_row(lane)) * LD + j * 16 + ac);
        mma16<E>(acc[2 * j], aP, bv[0], bv[1]);
        mma16<E>(acc[2 * j + 1], aP, bv[2], bv[3]);
      }
    }
    __syncthreads();             // buffer kt & 1 is free for tile kt + 2
  }
  cp_async_wait<0>();

  // The quad's shares of l added up; a row that saw no key has l == 0 -> 1.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    ls[r] += __shfl_xor_sync(0xffffffffu, ls[r], 1);
    ls[r] += __shfl_xor_sync(0xffffffffu, ls[r], 2);
    ls[r] = ls[r] == 0.f ? 1.f : ls[r];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= Tq) continue;
    const float l = ls[r];
    E* orow = o + ((int64_t(b) * Tq + row) * H + h) * D;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * tg) =
          pack2<E>(acc[n][2 * r] / l, acc[n][2 * r + 1] / l);
    if (tg == 0) lse[(int64_t(b) * H + h) * Tq + row] = m[r] + logf(l);
  }
}

// ---- launch -----------------------------------------------------------------

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       void* lse, int B, int H, int Tq, int Tk,
                       const Strides& st, int causal, float scale,
                       cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), H, Tq, Tk, st, causal, scale);
  return cudaGetLastError();
}

template <typename E, int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       void* lse, int B, int H, int Tq, int Tk,
                       const Strides& st, int causal, float scale,
                       cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma<E, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + 63) / 64, H, B);
  flash_fwd_mma<E, D><<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(k),
      static_cast<const E*>(v), static_cast<E*>(o),
      static_cast<float*>(lse), H, Tq, Tk, st, causal, scale);
  return cudaGetLastError();
}

using Launch = cudaError_t (*)(const void*, const void*, const void*, void*,
                               void*, int, int, int, int, const Strides&, int,
                               float, cudaStream_t);

}  // namespace

// dtype: 0 = float32 (the scalar kernel), 1 = bfloat16, 2 = float16 (the
// tensor-core kernel). st: the (batch, seq, head) element strides of q, k
// and v in that order. Returns a cudaError_t (0 = launched).
extern "C" int tpudist_flash_fwd(int dtype, int head_dim, const void* q,
                                 const void* k, const void* v, void* o,
                                 void* lse, int B, int H, int Tq, int Tk,
                                 const long long* st, int causal, float scale,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Strides sd;
  for (int i = 0; i < 3; ++i) {
    sd.q[i] = st[i];
    sd.k[i] = st[3 + i];
    sd.v[i] = st[6 + i];
  }
  Launch launch = nullptr;
  switch (head_dim) {
    case 32:
      launch = dtype == 0 ? launch_f32<32>
               : dtype == 1 ? launch_mma<bf16, 32> : launch_mma<f16, 32>;
      break;
    case 64:
      launch = dtype == 0 ? launch_f32<64>
               : dtype == 1 ? launch_mma<bf16, 64> : launch_mma<f16, 64>;
      break;
    case 80:
      launch = dtype == 0 ? launch_f32<80>
               : dtype == 1 ? launch_mma<bf16, 80> : launch_mma<f16, 80>;
      break;
  }
  if (launch == nullptr || dtype < 0 || dtype > 2)
    return int(cudaErrorInvalidValue);
  return int(launch(q, k, v, o, lse, B, H, Tq, Tk, sd, causal, scale, s));
}
