// PTX helpers shared by the 16-bit tensor-core flash kernels (flash_fwd.cu,
// flash_bwd.cu): cp.async tile copies, ldmatrix operand loads,
// mma.sync.m16n8k16 products of bf16 or float16 operands into f32, and the
// fragment index helpers. The element type E is __nv_bfloat16 or __half:
// the tiles, the ldmatrix loads and the fragment layout are the same for
// both (16-bit elements); what differs is the mma's operand type
// (.bf16.bf16 or .f16.f16) and the conversions (__floats2bfloat162_rn or
// __floats2half2_rn, which round to nearest, and their widening inverses).
// Float16 is never reached from bf16 by a bit cast: the two split their 16
// bits between exponent and mantissa differently.
//
// The kernels run four warps a block (MMA_THREADS), each owning 16 rows of a
// 64-row tile. Tiles live in shared memory as 16-bit rows of D elements
// padded by 8 (ld_of<D>), so the eight row addresses of one ldmatrix fall in
// eight distinct 16-byte bank groups at D = 32, 64 and 80.
//
// Fragment layout of mma.sync.m16n8k16 (lane = 4 g + tg): a C tile (16 x 8,
// f32) holds rows g (c[0], c[1]) and g + 8 (c[2], c[3]) at columns 2 tg and
// 2 tg + 1; an A tile (16 x 16, 16-bit) is a[0] row g k 2tg.., a[1] row g + 8
// k 2tg.., a[2] row g k 2tg + 8.., a[3] row g + 8 k 2tg + 8..; a B tile
// (16 x 8) is two registers, k 2tg.. and k 2tg + 8.., of column g.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using f16 = __half;

constexpr int MMA_THREADS = 128;   // four warps, 16 rows each

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes when !valid (src unread).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, or zero when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// The same, each matrix transposed on the way into registers.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// c += a (16x16, row) * b (16x8, col), E in, f32 accumulate.
template <typename E>
__device__ __forceinline__ void mma16(float (&c)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1);

template <>
__device__ __forceinline__ void mma16<bf16>(float (&c)[4],
                                            const uint32_t (&a)[4],
                                            uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <>
__device__ __forceinline__ void mma16<f16>(float (&c)[4],
                                           const uint32_t (&a)[4],
                                           uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 rounded to E (to nearest), `lo` in the low half (the lower
// column), and the pair widened back.
template <typename E> struct Pair;

template <> struct Pair<bf16> {
  using T2 = __nv_bfloat162;
  static __device__ __forceinline__ T2 round(float lo, float hi) {
    return __floats2bfloat162_rn(lo, hi);
  }
  static __device__ __forceinline__ float2 widen(T2 v) {
    return __bfloat1622float2(v);
  }
};

template <> struct Pair<f16> {
  using T2 = __half2;
  static __device__ __forceinline__ T2 round(float lo, float hi) {
    return __floats2half2_rn(lo, hi);
  }
  static __device__ __forceinline__ float2 widen(T2 v) {
    return __half22float2(v);
  }
};

template <typename E>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  typename Pair<E>::T2 v = Pair<E>::round(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragments of T(X) over k16 step kk, from the f32 C fragments of the n8
// tiles 2kk and 2kk+1 (row g: c[0], c[1]; row g + 8: c[2], c[3]).
template <typename E>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack2<E>(c0[0], c0[1]);
  a[1] = pack2<E>(c0[2], c0[3]);
  a[2] = pack2<E>(c1[0], c1[1]);
  a[3] = pack2<E>(c1[2], c1[3]);
}

// Row stride of a 16-bit tile in shared memory: D plus 8 elements of padding.
template <int D>
__host__ __device__ constexpr int ld_of() { return D + 8; }

template <int D>
constexpr size_t tile_bytes() { return sizeof(uint16_t) * 64 * ld_of<D>(); }

// rows [first, first + 64) x D of a (B, T, H, D) tensor into a padded tile by
// cp.async; rows past `len` are zero-filled.
template <int D, typename E>
__device__ __forceinline__ void copy_tile(E* dst, const E* src, int64_t st,
                                          int first, int len) {
  constexpr int CH = D / 8;      // 16-byte chunks a row
  for (int i = threadIdx.x; i < 64 * CH; i += MMA_THREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    const int t = first + r;
    const bool ok = t < len;
    cp_async16(dst + r * ld_of<D>() + c, ok ? src + t * st + c : src, ok);
  }
}

// Qs = T(f32(q) * scale) in place over a whole tile.
template <int D, typename E>
__device__ __forceinline__ void scale_tile(E* tile, float scale) {
  using T2 = typename Pair<E>::T2;
  for (int i = threadIdx.x; i < 64 * D / 2; i += MMA_THREADS) {
    const int r = i / (D / 2), c = (i % (D / 2)) * 2;
    T2* p = reinterpret_cast<T2*>(tile + r * ld_of<D>() + c);
    const float2 f = Pair<E>::widen(*p);
    *p = Pair<E>::round(f.x * scale, f.y * scale);
  }
}

// Per-lane row and column offsets of ldmatrix.x4 addresses within a 16x16
// block: an A fragment (or a B fragment pair read .trans from a [k][n] tile),
// and a B fragment pair for n8 tiles 2j, 2j+1 read from an [n][k] tile.
__device__ __forceinline__ int a_row(int lane) { return lane & 15; }
__device__ __forceinline__ int a_col(int lane) { return (lane >> 4) * 8; }
__device__ __forceinline__ int b_row(int lane) {
  return (lane & 7) + ((lane >> 4) << 3);
}
__device__ __forceinline__ int b_col(int lane) { return ((lane >> 3) & 1) * 8; }

}  // namespace
