// Fused BatchNorm epilogues for Hopper (sm_90a), hand-written CUDA C++.
//
// Four entry points, each the counterpart of one TPU kernel of
// tpudist/ops/pallas/fused_norm.py (reached through its pl.pallas_call sites):
//   tpudist_bn_act_fwd      <- _fwd_kernel      y = relu(x*a + b)
//   tpudist_bn_act_fwd_res  <- _fwd_res_kernel  q = T(x*a + b); y = relu(T(q + r))
//   tpudist_bn_act_bwd      <- _bwd_kernel      g = dy*[x*a+b > 0]; dx = T(g*a);
//                                               per-row-block partials sum(g*x), sum(g)
//   tpudist_bn_act_bwd_res  <- _bwd_res_kernel  as above with the mask recomputed
//                                               through the forward's rounding to T,
//                                               and dr = T(g)
// x, r, y, dy, dx, dr are (M, C) row-major in the storage type T (float,
// bfloat16 or float16): an NHWC activation, i.e. a channels_last NCHW
// tensor viewed as rows of C channels. a and b are the per-channel f32
// vectors the caller folds from the batch statistics (a =
// scale*rsqrt(var+eps), b = bias - mean*a); the statistics, the fold and
// the reduction of the partials stay in PyTorch, so autograd carries da and
// db back to scale, bias, mean and var. All arithmetic is f32. x*a and the
// + b are rounded separately (__fmul_rn, __fadd_rn), as the plain PyTorch
// version computes them, so the forward agrees with it bit for bit;
// relu'(0) = 0 (the mask is pre > 0).
//
// Non-finite values pass as they pass through the Pallas kernels, so that a
// float16 overflow reaches the gradients and the dynamic loss scale sees it:
// a value past float16's 65504 rounds to inf in T (round to nearest, as
// torch's cast); the ReLU keeps NaN (a compare, not fmaxf, which would drop
// it); the backward mask is pre > 0, so a NaN pre-activation gives g = 0 and
// an inf one passes dy; g * a, T(g) and the partials keep whatever inf or NaN
// dy brings.
//
// What bounds them on this card: one multiply-add and a compare per element
// against 4 (fwd), 6 (fwd_res, bwd) or 10 (bwd_res) bytes per element in
// bf16: far below the H100's ~295 operations per byte, so HBM bandwidth
// (3.35 TB/s) is the bound, and reaching it takes enough bytes in flight
// to cover the memory's latency (Little's law: some 3 MB across the card).
// ResNet-18 at batch 256 and 224 px moves about 2.75 GB a step through the
// forward kernels and 4.3 GB through the backward ones, densenet121 about
// 16 GB and 24 GB; chip_smoke.py recomputes the bound from the shapes it
// runs.
//
// What the design does about it: every byte is read once and written once,
// in 16-byte vectors (8 elements in bf16 and float16, 4 in f32), several
// vectors a thread in flight before the first is used. Two variants of
// each kernel; the wrapper picks one before the launch and counts it:
//   - vector (C a multiple of the elements in 16 bytes, every row operand
//     16-byte aligned: every BatchNorm site of the conv families and the
//     resnets):
//     - forward: a grid-stride pass over the (M*C/VEC) vectors. The
//       thread count is a multiple of C/VEC, so each thread stays on one
//       group of VEC channels and holds their a and b in registers; each
//       takes FWD_UNROLL vectors an iteration. x is read without
//       allocating in L1 and y stored as streaming;
//     - backward: a block owns `rows` rows (one row of the partials) and
//       a slice of the channel groups: all of them, unless there are too
//       few row blocks to fill the card or too many groups for one block;
//       the slices of one row block are consecutive blocks, so they read
//       its rows together. Its threads are lanes x groups: each walks its
//       group down every lanes-th row, BWD_UNROLL rows in flight, with VEC
//       f32 accumulators for sum(g*x) and VEC for sum(g), so a warp reads
//       contiguous rows (512 bytes a warp where a slice holds all of C)
//       and no lane idles at C = 16, 72, 80 or 104. Two blocks a SM fit
//       the registers of BWD_UNROLL rows in flight without spilling; the
//       last batch of loads is predicated, not serialised. The lanes are
//       then summed in a fixed
//       order through shared memory and the block writes its own row of
//       the (ceil(M/rows), C) partials: no atomics, so the result does not
//       depend on how blocks are scheduled. PyTorch sums the partials
//       afterwards, as _bwd_call's jnp.sum does;
//   - scalar (any other C or alignment: an odd channel count, an offset
//     view): one element a thread an iteration; the forward as above, the
//     backward in (32 channels x 8 row lanes) blocks over the same row
//     blocks and partials.
// The arithmetic is the same per element in both, so both agree with the
// plain version bit for bit in y, dx and dr.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int FWD_THREADS = 256;
constexpr int BWD_CT = 32;       // channels per scalar backward block
constexpr int BWD_LANES = 8;     // row lanes per scalar backward block

// The vector variant's schedule (tools/fused_norm_tune.py measures the
// choices on the card).
constexpr int FWD_UNROLL = 4;          // vectors in flight a forward thread
constexpr int FWD_BLOCKS_PER_SM = 16;  // the forward grid's cap, a SM
constexpr bool FWD_HINTS = true;       // x no-L1-allocate, y streaming
constexpr int BWD_UNROLL = 4;          // rows in flight a backward thread
constexpr int BWD_THREADS = 256;       // most threads of a backward block
constexpr int BWD_MIN_BLOCKS = 2;      // resident blocks asked of ptxas
constexpr int BWD_BLOCKS_PER_SM = 4;   // backward blocks wanted, a SM
constexpr int BWD_MIN_SLICE = 4;       // fewest channel groups of a slice
constexpr bool BWD_HINTS = false;      // as FWD_HINTS, for x, r, dy, dx, dr

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

// x rounded to T and widened back to f32.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// The pre-activation of both directions: x*a + b in f32 for the plain
// epilogue, T(T(x*a + b) + r) for the residual one.
template <typename T, bool RES>
__device__ __forceinline__ float pre_act(float xf, float a, float b, float rf) {
  const float p = __fadd_rn(__fmul_rn(xf, a), b);
  if (!RES) return p;
  return round_to<T>(round_to<T>(p) + rf);
}

// -- the scalar variant ------------------------------------------------------

template <typename T, bool RES>
__global__ void __launch_bounds__(FWD_THREADS)
bn_act_fwd_kernel(const T* __restrict__ x, const T* __restrict__ r,
                  const float* __restrict__ a, const float* __restrict__ b,
                  T* __restrict__ y, int64_t n, int C) {
  const int64_t stride = int64_t(gridDim.x) * FWD_THREADS;   // a multiple of C
  int64_t i = int64_t(blockIdx.x) * FWD_THREADS + threadIdx.x;
  const int c = int(i % C);
  const float ac = a[c], bc = b[c];
  for (; i < n; i += stride) {
    const float p = pre_act<T, RES>(to_f(x[i]), ac, bc, RES ? to_f(r[i]) : 0.f);
    y[i] = from_f<T>(p < 0.f ? 0.f : p);     // relu; NaN passes through
  }
}

template <typename T, bool RES>
__global__ void __launch_bounds__(BWD_CT * BWD_LANES)
bn_act_bwd_kernel(const T* __restrict__ x, const T* __restrict__ r,
                  const T* __restrict__ dy, const float* __restrict__ a,
                  const float* __restrict__ b, T* __restrict__ dx,
                  T* __restrict__ dr, float* __restrict__ da_p,
                  float* __restrict__ db_p, int64_t M, int C, int rows) {
  __shared__ float s_da[BWD_LANES][BWD_CT];
  __shared__ float s_db[BWD_LANES][BWD_CT];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.y * BWD_CT + tx;
  const bool live = c < C;
  float sda = 0.f, sdb = 0.f;
  if (live) {
    const float ac = a[c], bc = b[c];
    const int64_t m0 = int64_t(blockIdx.x) * rows;
    const int64_t m1 = m0 + rows < M ? m0 + rows : M;
    for (int64_t m = m0 + ty; m < m1; m += BWD_LANES) {
      const int64_t i = m * C + c;
      const float xf = to_f(x[i]);
      const float p = pre_act<T, RES>(xf, ac, bc, RES ? to_f(r[i]) : 0.f);
      const float g = p > 0.f ? to_f(dy[i]) : 0.f;
      dx[i] = from_f<T>(__fmul_rn(g, ac));
      if (RES) dr[i] = from_f<T>(g);
      sda = fmaf(g, xf, sda);
      sdb += g;
    }
  }
  s_da[ty][tx] = sda;
  s_db[ty][tx] = sdb;
  __syncthreads();
  if (ty == 0 && live) {
    float ta = 0.f, tb = 0.f;
#pragma unroll
    for (int l = 0; l < BWD_LANES; ++l) {
      ta += s_da[l][tx];
      tb += s_db[l][tx];
    }
    da_p[int64_t(blockIdx.x) * C + c] = ta;
    db_p[int64_t(blockIdx.x) * C + c] = tb;
  }
}

// -- the vector variant ------------------------------------------------------

// Elements of T in one 16-byte vector.
template <typename T> __host__ __device__ constexpr int vec_n() {
  return 16 / int(sizeof(T));
}

// One element of a 16-bit T from / to the low 16 bits of a word.
template <typename T> __device__ __forceinline__ float from_bits(uint32_t h);
template <> __device__ __forceinline__ float from_bits<__nv_bfloat16>(uint32_t h) {
  return __uint_as_float(h << 16);
}
template <> __device__ __forceinline__ float from_bits<__half>(uint32_t h) {
  return __half2float(__ushort_as_half((unsigned short)h));
}
template <typename T> __device__ __forceinline__ uint32_t to_bits(float x);
template <> __device__ __forceinline__ uint32_t to_bits<__nv_bfloat16>(float x) {
  return __bfloat16_as_ushort(__float2bfloat16(x));
}
template <> __device__ __forceinline__ uint32_t to_bits<__half>(float x) {
  return __half_as_ushort(__float2half_rn(x));
}

// A 16-byte vector's elements widened to f32, and f32 values rounded to T
// and packed (element k at the k-th lowest address: little-endian words).
template <typename T>
__device__ __forceinline__ void unpack(uint4 v, float* f) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(T) == 4) {
      f[i] = __uint_as_float(w[i]);
    } else {
      f[2 * i] = from_bits<T>(w[i] & 0xffffu);
      f[2 * i + 1] = from_bits<T>(w[i] >> 16);
    }
  }
}

template <typename T>
__device__ __forceinline__ uint4 pack(const float* f) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(T) == 4) {
      w[i] = __float_as_uint(f[i]);
    } else {
      w[i] = to_bits<T>(f[2 * i]) | (to_bits<T>(f[2 * i + 1]) << 16);
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Loads of the inputs, which no thread writes during the launch: with
// HINTS through the non-coherent path without allocating in L1 (each byte
// is read once); stores of the outputs with HINTS marked streaming (evict
// first).
template <bool HINTS>
__device__ __forceinline__ uint4 load_in(const uint4* p) {
  if constexpr (HINTS) {
    uint4 v;
    asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
        : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
    return v;
  } else {
    return *p;
  }
}

template <bool HINTS>
__device__ __forceinline__ void store_out(uint4* p, uint4 v) {
  if constexpr (HINTS) {
    __stcs(p, v);
  } else {
    *p = v;
  }
}

// y = relu(pre) for one vector.
template <typename T, bool RES>
__device__ __forceinline__ uint4 fwd_vec(uint4 xv, uint4 rv, const float* ac,
                                         const float* bc) {
  constexpr int N = vec_n<T>();
  float f[N], rf[N];
  unpack<T>(xv, f);
  if (RES) unpack<T>(rv, rf);
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const float p = pre_act<T, RES>(f[k], ac[k], bc[k], RES ? rf[k] : 0.f);
    f[k] = p < 0.f ? 0.f : p;                // relu; NaN passes through
  }
  return pack<T>(f);
}

template <typename T, bool RES>
__global__ void __launch_bounds__(FWD_THREADS)
bn_act_fwd_vec_kernel(const uint4* __restrict__ x, const uint4* __restrict__ r,
                      const float* __restrict__ a, const float* __restrict__ b,
                      uint4* __restrict__ y, int64_t nv, int cv) {
  constexpr int N = vec_n<T>();
  const int64_t stride = int64_t(gridDim.x) * FWD_THREADS;   // a multiple of cv
  int64_t v = int64_t(blockIdx.x) * FWD_THREADS + threadIdx.x;
  const int c0 = int(v % cv) * N;
  float ac[N], bc[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    ac[k] = a[c0 + k];
    bc[k] = b[c0 + k];
  }
  // FWD_UNROLL vectors a batch, all loaded before the first is used (the
  // last batch too: its loads are predicated, not serialised).
  for (; v < nv; v += FWD_UNROLL * stride) {
    uint4 xv[FWD_UNROLL], rv[FWD_UNROLL];
#pragma unroll
    for (int u = 0; u < FWD_UNROLL; ++u) {
      if (v + u * stride < nv) {
        xv[u] = load_in<FWD_HINTS>(x + v + u * stride);
        if (RES) rv[u] = load_in<FWD_HINTS>(r + v + u * stride);
      }
    }
#pragma unroll
    for (int u = 0; u < FWD_UNROLL; ++u) {
      if (v + u * stride < nv)
        store_out<FWD_HINTS>(y + v + u * stride,
                             fwd_vec<T, RES>(xv[u], rv[u], ac, bc));
    }
  }
}

// One vector of the backward: dx (and dr) out, the f32 sums updated.
template <typename T, bool RES>
__device__ __forceinline__ void bwd_vec(uint4 xv, uint4 rv, uint4 dyv,
                                        const float* ac, const float* bc,
                                        float* sda, float* sdb, uint4& dxv,
                                        uint4& drv) {
  constexpr int N = vec_n<T>();
  float xf[N], rf[N], gf[N];
  unpack<T>(xv, xf);
  unpack<T>(dyv, gf);
  if (RES) unpack<T>(rv, rf);
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const float p = pre_act<T, RES>(xf[k], ac[k], bc[k], RES ? rf[k] : 0.f);
    const float g = p > 0.f ? gf[k] : 0.f;
    gf[k] = __fmul_rn(g, ac[k]);
    rf[k] = g;
    sda[k] = fmaf(g, xf[k], sda[k]);
    sdb[k] += g;
  }
  dxv = pack<T>(gf);
  if (RES) drv = pack<T>(rf);
}

// Block i: rows [(i / ns)*rows, +rows) and the channel groups
// [(i % ns)*cvs, +cvs), ns = cv / cvs (so the slices of one row block run
// side by side and read its rows together); blockDim.x = cvs * lanes,
// thread t on group t % cvs and lane t / cvs.
template <typename T, bool RES>
__global__ void __launch_bounds__(BWD_THREADS, BWD_MIN_BLOCKS)
bn_act_bwd_vec_kernel(const uint4* __restrict__ x, const uint4* __restrict__ r,
                      const uint4* __restrict__ dy, const float* __restrict__ a,
                      const float* __restrict__ b, uint4* __restrict__ dx,
                      uint4* __restrict__ dr, float* __restrict__ da_p,
                      float* __restrict__ db_p, int64_t M, int cv, int cvs,
                      int lanes, int rows) {
  constexpr int N = vec_n<T>();
  __shared__ __align__(16) float s_da[BWD_THREADS * N];
  __shared__ __align__(16) float s_db[BWD_THREADS * N];
  const int t = threadIdx.x;
  const int grp = t % cvs, lane = t / cvs;
  const int ns = cv / cvs;
  const int64_t bm = blockIdx.x / ns;                  // row block
  const int slice = int(blockIdx.x % ns);
  const int gv = slice * cvs + grp;                    // group in the row
  const int64_t m0 = bm * rows;
  const int64_t m1 = m0 + rows < M ? m0 + rows : M;
  const int64_t first = m0 + lane;
  const int nrow = first < m1 ? int((m1 - first + lanes - 1) / lanes) : 0;
  const int64_t step = int64_t(lanes) * cv;             // vectors a row walk
  const int64_t base = first * cv + gv;
  float ac[N], bc[N], sda[N], sdb[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    ac[k] = a[gv * N + k];
    bc[k] = b[gv * N + k];
    sda[k] = 0.f;
    sdb[k] = 0.f;
  }
  // BWD_UNROLL rows a batch, all loaded before the first is used (the
  // last batch's loads predicated); the sums run in row order.
  for (int i = 0; i < nrow; i += BWD_UNROLL) {
    uint4 xv[BWD_UNROLL], rv[BWD_UNROLL], dyv[BWD_UNROLL];
#pragma unroll
    for (int u = 0; u < BWD_UNROLL; ++u) {
      if (i + u < nrow) {
        const int64_t o = base + (i + u) * step;
        xv[u] = load_in<BWD_HINTS>(x + o);
        dyv[u] = load_in<BWD_HINTS>(dy + o);
        if (RES) rv[u] = load_in<BWD_HINTS>(r + o);
      }
    }
#pragma unroll
    for (int u = 0; u < BWD_UNROLL; ++u) {
      if (i + u < nrow) {
        const int64_t o = base + (i + u) * step;
        uint4 dxv, drv;
        bwd_vec<T, RES>(xv[u], rv[u], dyv[u], ac, bc, sda, sdb, dxv, drv);
        store_out<BWD_HINTS>(dx + o, dxv);
        if (RES) store_out<BWD_HINTS>(dr + o, drv);
      }
    }
  }
  // s[lane][grp*N + k]: the slice's channels, one row of them a lane.
  const int cs = cvs * N;
  float4* sa = reinterpret_cast<float4*>(s_da + lane * cs + grp * N);
  float4* sb = reinterpret_cast<float4*>(s_db + lane * cs + grp * N);
#pragma unroll
  for (int k = 0; k < N / 4; ++k) {
    sa[k] = make_float4(sda[4 * k], sda[4 * k + 1], sda[4 * k + 2], sda[4 * k + 3]);
    sb[k] = make_float4(sdb[4 * k], sdb[4 * k + 1], sdb[4 * k + 2], sdb[4 * k + 3]);
  }
  __syncthreads();
  const int64_t out = bm * cv * N + int64_t(slice) * cs;
  for (int c = t; c < cs; c += blockDim.x) {
    float ta = 0.f, tb = 0.f;
    for (int l = 0; l < lanes; ++l) {
      ta += s_da[l * cs + c];
      tb += s_db[l * cs + c];
    }
    da_p[out + c] = ta;
    db_p[out + c] = tb;
  }
}

// -- launches ----------------------------------------------------------------

int gcd_int(int p, int q) {
  while (q) { const int t = p % q; p = q; q = t; }
  return p;
}

// Streaming multiprocessors of the current device (132 on an H100 SXM).
int sm_count() {
  static int cache[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 132;
  if (dev >= 0 && dev < 64 && cache[dev] > 0) return cache[dev];
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || n < 1)
    n = 132;
  if (dev >= 0 && dev < 64) cache[dev] = n;
  return n;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// The grid-stride forward's blocks: about `per_thread` items a thread, at
// most `cap` blocks, rounded up so that blocks * FWD_THREADS is a multiple
// of `unit_items` (the items of one row).
int64_t fwd_blocks(int64_t items, int unit_items, int per_thread, int64_t cap) {
  const int unit = unit_items / gcd_int(unit_items, FWD_THREADS);
  int64_t want = (items + int64_t(per_thread) * FWD_THREADS - 1) /
                 (int64_t(per_thread) * FWD_THREADS);
  if (want > cap) want = cap;
  int64_t blocks = (want + unit - 1) / unit * unit;
  return blocks < unit ? unit : blocks;
}

template <typename T, bool RES>
cudaError_t launch_fwd(const void* x, const void* r, const void* a,
                       const void* b, void* y, int64_t M, int C, bool vec,
                       cudaStream_t stream) {
  const int64_t n = M * C;
  if (vec) {
    constexpr int N = vec_n<T>();
    if (C % N || !aligned16(x) || !aligned16(y) || (RES && !aligned16(r)))
      return cudaErrorInvalidValue;
    const int cv = C / N;
    const int64_t blocks = fwd_blocks(n / N, cv, FWD_UNROLL,
                                      int64_t(sm_count()) * FWD_BLOCKS_PER_SM);
    if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
    bn_act_fwd_vec_kernel<T, RES><<<unsigned(blocks), FWD_THREADS, 0, stream>>>(
        static_cast<const uint4*>(x), static_cast<const uint4*>(r),
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<uint4*>(y), n / N, cv);
    return cudaGetLastError();
  }
  // Enough blocks for ~4 elements a thread, at most 8 a SM of 132.
  const int64_t blocks = fwd_blocks(n, C, 4, 132 * 8);
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  bn_act_fwd_kernel<T, RES><<<unsigned(blocks), FWD_THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(r),
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<T*>(y), n, C);
  return cudaGetLastError();
}

// The vector backward's channel slices: the fewest that divide the cv
// groups, fit a block, and give BWD_BLOCKS_PER_SM blocks a SM over the nm
// row blocks, without cutting a slice below BWD_MIN_SLICE groups (64
// contiguous bytes of a row).
int bwd_slices(int64_t nm, int cv) {
  int ns = 0;
  const int64_t want = int64_t(sm_count()) * BWD_BLOCKS_PER_SM;
  for (int d = 1; d <= cv; ++d) {
    if (cv % d || cv / d > BWD_THREADS) continue;
    if (ns && cv / d < BWD_MIN_SLICE) break;
    ns = d;
    if (nm * d >= want) break;
  }
  return ns;
}

template <typename T, bool RES>
cudaError_t launch_bwd(const void* x, const void* r, const void* dy,
                       const void* a, const void* b, void* dx, void* dr,
                       void* da_p, void* db_p, int64_t M, int C, int rows,
                       bool vec, cudaStream_t stream) {
  const int64_t nm = (M + rows - 1) / rows;
  if (nm > 0x7fffffff) return cudaErrorInvalidConfiguration;
  if (vec) {
    constexpr int N = vec_n<T>();
    if (C % N || !aligned16(x) || !aligned16(dy) || !aligned16(dx) ||
        (RES && (!aligned16(r) || !aligned16(dr))))
      return cudaErrorInvalidValue;
    const int cv = C / N;
    const int ns = bwd_slices(nm, cv);
    const int cvs = cv / ns;
    int lanes = BWD_THREADS / cvs;
    if (lanes > rows) lanes = rows;
    if (nm * ns > 0x7fffffff) return cudaErrorInvalidConfiguration;
    bn_act_bwd_vec_kernel<T, RES><<<unsigned(nm * ns), cvs * lanes, 0, stream>>>(
        static_cast<const uint4*>(x), static_cast<const uint4*>(r),
        static_cast<const uint4*>(dy), static_cast<const float*>(a),
        static_cast<const float*>(b), static_cast<uint4*>(dx),
        static_cast<uint4*>(dr), static_cast<float*>(da_p),
        static_cast<float*>(db_p), M, cv, cvs, lanes, rows);
    return cudaGetLastError();
  }
  dim3 grid(unsigned(nm), unsigned((C + BWD_CT - 1) / BWD_CT));
  dim3 block(BWD_CT, BWD_LANES);
  bn_act_bwd_kernel<T, RES><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(r),
      static_cast<const T*>(dy), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<T*>(dx), static_cast<T*>(dr),
      static_cast<float*>(da_p), static_cast<float*>(db_p), M, C, rows);
  return cudaGetLastError();
}

bool bad_shape(long long M, int C) { return M < 1 || C < 1; }

template <bool RES>
int fwd(int dtype, int vec, const void* x, const void* r, const void* a,
        const void* b, void* y, long long M, int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_shape(M, C) || (vec != 0 && vec != 1)) return int(cudaErrorInvalidValue);
  if (dtype == 0) return int(launch_fwd<float, RES>(x, r, a, b, y, M, C, vec, s));
  if (dtype == 1) return int(launch_fwd<__nv_bfloat16, RES>(x, r, a, b, y, M, C, vec, s));
  if (dtype == 2) return int(launch_fwd<__half, RES>(x, r, a, b, y, M, C, vec, s));
  return int(cudaErrorInvalidValue);
}

template <bool RES>
int bwd(int dtype, int vec, const void* x, const void* r, const void* dy,
        const void* a, const void* b, void* dx, void* dr, void* da_p,
        void* db_p, long long M, int C, int rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_shape(M, C) || rows < 1 || (vec != 0 && vec != 1))
    return int(cudaErrorInvalidValue);
  if (dtype == 0)
    return int(launch_bwd<float, RES>(x, r, dy, a, b, dx, dr, da_p, db_p, M, C, rows, vec, s));
  if (dtype == 1)
    return int(launch_bwd<__nv_bfloat16, RES>(x, r, dy, a, b, dx, dr, da_p, db_p, M, C, rows, vec, s));
  if (dtype == 2)
    return int(launch_bwd<__half, RES>(x, r, dy, a, b, dx, dr, da_p, db_p, M, C, rows, vec, s));
  return int(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (x, r, y, dy, dx, dr all
// share it). vec: 1 = the 16-byte vector variant (refused unless C is a
// multiple of the elements in 16 bytes and every row operand is 16-byte
// aligned), 0 = the scalar one.
// a, b: (C,) f32. Partials da_p, db_p: (ceil(M/rows), C) f32.
// Each returns a cudaError_t (0 = launched).
extern "C" int tpudist_bn_act_fwd(int dtype, int vec, const void* x,
                                  const void* a, const void* b, void* y,
                                  long long M, int C, void* stream) {
  return fwd<false>(dtype, vec, x, nullptr, a, b, y, M, C, stream);
}

extern "C" int tpudist_bn_act_fwd_res(int dtype, int vec, const void* x,
                                      const void* r, const void* a,
                                      const void* b, void* y, long long M,
                                      int C, void* stream) {
  return fwd<true>(dtype, vec, x, r, a, b, y, M, C, stream);
}

extern "C" int tpudist_bn_act_bwd(int dtype, int vec, const void* x,
                                  const void* dy, const void* a,
                                  const void* b, void* dx, void* da_p,
                                  void* db_p, long long M, int C, int rows,
                                  void* stream) {
  return bwd<false>(dtype, vec, x, nullptr, dy, a, b, dx, nullptr, da_p, db_p,
                    M, C, rows, stream);
}

extern "C" int tpudist_bn_act_bwd_res(int dtype, int vec, const void* x,
                                      const void* r, const void* dy,
                                      const void* a, const void* b, void* dx,
                                      void* dr, void* da_p, void* db_p,
                                      long long M, int C, int rows,
                                      void* stream) {
  return bwd<true>(dtype, vec, x, r, dy, a, b, dx, dr, da_p, db_p, M, C, rows,
                   stream);
}
