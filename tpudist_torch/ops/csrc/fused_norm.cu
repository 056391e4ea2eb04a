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
// x, r, y, dy, dx, dr are (M, C) row-major in the storage type T (float or
// bfloat16): an NHWC activation, i.e. a channels_last NCHW tensor viewed as
// rows of C channels. a and b are the per-channel f32 vectors the caller
// folds from the batch statistics (a = scale*rsqrt(var+eps), b = bias -
// mean*a); the statistics, the fold and the reduction of the partials stay
// in PyTorch, so autograd carries da and db back to scale, bias, mean and
// var. All arithmetic is f32. x*a and the + b are rounded separately
// (__fmul_rn, __fadd_rn), as the plain PyTorch version computes them, so the
// forward agrees with it bit for bit; relu'(0) = 0 (the mask is pre > 0).
//
// What bounds them on this card: one multiply-add and a max per element
// against 4 (fwd), 6 (fwd_res, bwd) or 10 (bwd_res) bytes per element in
// bf16: far below the H100's ~295 operations per byte, so HBM bandwidth
// (3.35 TB/s) is the bound. ResNet-18 at batch 256 and 224 px moves about
// 2.75 GB a step through the forward kernels and 4.3 GB through the
// backward ones; chip_smoke.py recomputes the bound from the shapes it runs.
//
// What the design does about it: every byte is read once and written once.
//   - forward: a grid-stride elementwise pass. The grid is sized so that the
//     total thread count is a multiple of C, so each thread stays on one
//     channel for its whole walk and holds that channel's a and b in two
//     registers: no per-element index arithmetic beyond the stride, no
//     shared memory;
//   - backward: a (32 channels x 8 row lanes) block owns a block of `rows`
//     rows and a 32-channel slice. Each thread walks its channel down every
//     8th row of the block with f32 register accumulators, then the 8 lanes
//     are summed in a fixed order through shared memory and the block writes
//     its own row of the (ceil(M/rows), C) partials: no atomics, so the
//     result does not depend on how blocks are scheduled. PyTorch sums the
//     partials afterwards, as _bwd_call's jnp.sum does.
// Loads are one element per thread (a warp reads 64 contiguous bytes in
// bf16): simple and right first; 16-byte vector accesses are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int FWD_THREADS = 256;
constexpr int BWD_CT = 32;       // channels per backward block
constexpr int BWD_LANES = 8;     // row lanes per backward block

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

// The pre-activation of both directions: x*a + b in f32 for the plain
// epilogue, T(T(x*a + b) + r) for the residual one.
template <typename T, bool RES>
__device__ __forceinline__ float pre_act(float xf, float a, float b, const T* r,
                                         int64_t i) {
  const float p = __fadd_rn(__fmul_rn(xf, a), b);
  if (!RES) return p;
  return round_to<T>(round_to<T>(p) + to_f(r[i]));
}

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
    const float p = pre_act<T, RES>(to_f(x[i]), ac, bc, r, i);
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
      const float g = pre_act<T, RES>(xf, ac, bc, r, i) > 0.f ? to_f(dy[i]) : 0.f;
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

int gcd_int(int p, int q) {
  while (q) { const int t = p % q; p = q; q = t; }
  return p;
}

template <typename T, bool RES>
cudaError_t launch_fwd(const void* x, const void* r, const void* a,
                       const void* b, void* y, int64_t M, int C,
                       cudaStream_t stream) {
  const int64_t n = M * C;
  // Enough blocks for ~4 elements a thread, at most 8 a SM of 132, rounded
  // up so that blocks * FWD_THREADS is a multiple of C.
  const int unit = C / gcd_int(C, FWD_THREADS);
  int64_t want = (n + 4 * FWD_THREADS - 1) / (4 * FWD_THREADS);
  if (want > 132 * 8) want = 132 * 8;
  int64_t blocks = (want + unit - 1) / unit * unit;
  if (blocks < unit) blocks = unit;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  bn_act_fwd_kernel<T, RES><<<unsigned(blocks), FWD_THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(r),
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<T*>(y), n, C);
  return cudaGetLastError();
}

template <typename T, bool RES>
cudaError_t launch_bwd(const void* x, const void* r, const void* dy,
                       const void* a, const void* b, void* dx, void* dr,
                       void* da_p, void* db_p, int64_t M, int C, int rows,
                       cudaStream_t stream) {
  const int64_t nm = (M + rows - 1) / rows;
  if (nm > 0x7fffffff) return cudaErrorInvalidConfiguration;
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, r, y, dy, dx, dr all share it).
// a, b: (C,) f32. Partials da_p, db_p: (ceil(M/rows), C) f32.
// Each returns a cudaError_t (0 = launched).
extern "C" int tpudist_bn_act_fwd(int dtype, const void* x, const void* a,
                                  const void* b, void* y, long long M, int C,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_shape(M, C)) return int(cudaErrorInvalidValue);
  if (dtype == 0) return int(launch_fwd<float, false>(x, nullptr, a, b, y, M, C, s));
  if (dtype == 1) return int(launch_fwd<__nv_bfloat16, false>(x, nullptr, a, b, y, M, C, s));
  return int(cudaErrorInvalidValue);
}

extern "C" int tpudist_bn_act_fwd_res(int dtype, const void* x, const void* r,
                                      const void* a, const void* b, void* y,
                                      long long M, int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_shape(M, C)) return int(cudaErrorInvalidValue);
  if (dtype == 0) return int(launch_fwd<float, true>(x, r, a, b, y, M, C, s));
  if (dtype == 1) return int(launch_fwd<__nv_bfloat16, true>(x, r, a, b, y, M, C, s));
  return int(cudaErrorInvalidValue);
}

extern "C" int tpudist_bn_act_bwd(int dtype, const void* x, const void* dy,
                                  const void* a, const void* b, void* dx,
                                  void* da_p, void* db_p, long long M, int C,
                                  int rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_shape(M, C) || rows < 1) return int(cudaErrorInvalidValue);
  if (dtype == 0)
    return int(launch_bwd<float, false>(x, nullptr, dy, a, b, dx, nullptr, da_p, db_p, M, C, rows, s));
  if (dtype == 1)
    return int(launch_bwd<__nv_bfloat16, false>(x, nullptr, dy, a, b, dx, nullptr, da_p, db_p, M, C, rows, s));
  return int(cudaErrorInvalidValue);
}

extern "C" int tpudist_bn_act_bwd_res(int dtype, const void* x, const void* r,
                                      const void* dy, const void* a,
                                      const void* b, void* dx, void* dr,
                                      void* da_p, void* db_p, long long M,
                                      int C, int rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_shape(M, C) || rows < 1) return int(cudaErrorInvalidValue);
  if (dtype == 0)
    return int(launch_bwd<float, true>(x, r, dy, a, b, dx, dr, da_p, db_p, M, C, rows, s));
  if (dtype == 1)
    return int(launch_bwd<__nv_bfloat16, true>(x, r, dy, a, b, dx, dr, da_p, db_p, M, C, rows, s));
  return int(cudaErrorInvalidValue);
}
