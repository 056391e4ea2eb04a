// PTX helpers shared by the bf16 tensor-core flash kernels (flash_fwd.cu,
// flash_bwd.cu): cp.async tile copies, ldmatrix operand loads,
// mma.sync.m16n8k16 bf16 -> f32 products, and the fragment index helpers.
//
// The kernels run four warps a block (MMA_THREADS), each owning 16 rows of a
// 64-row tile. Tiles live in shared memory as bf16 rows of D elements padded
// by 8 (ld_of<D>), so the eight row addresses of one ldmatrix fall in eight
// distinct 16-byte bank groups at D = 32, 64 and 80.
//
// Fragment layout of mma.sync.m16n8k16 (lane = 4 g + tg): a C tile (16 x 8,
// f32) holds rows g (c[0], c[1]) and g + 8 (c[2], c[3]) at columns 2 tg and
// 2 tg + 1; an A tile (16 x 16, bf16) is a[0] row g k 2tg.., a[1] row g + 8
// k 2tg.., a[2] row g k 2tg + 8.., a[3] row g + 8 k 2tg + 8..; a B tile
// (16 x 8) is two registers, k 2tg.. and k 2tg + 8.., of column g.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

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
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// The same, each matrix transposed on the way into registers.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 rounded to bf16, `lo` in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragments of T(X) over k16 step kk, from the f32 C fragments of the n8
// tiles 2kk and 2kk+1 (row g: c[0], c[1]; row g + 8: c[2], c[3]).
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Row stride of a bf16 tile in shared memory: D plus 8 elements of padding.
template <int D>
__host__ __device__ constexpr int ld_of() { return D + 8; }

template <int D>
constexpr size_t tile_bytes() { return sizeof(bf16) * 64 * ld_of<D>(); }

// rows [first, first + 64) x D of a (B, T, H, D) tensor into a padded tile by
// cp.async; rows past `len` are zero-filled.
template <int D>
__device__ __forceinline__ void copy_tile(bf16* dst, const bf16* src,
                                          int64_t st, int first, int len) {
  constexpr int CH = D / 8;      // 16-byte chunks a row
  for (int i = threadIdx.x; i < 64 * CH; i += MMA_THREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    const int t = first + r;
    const bool ok = t < len;
    cp_async16(dst + r * ld_of<D>() + c, ok ? src + t * st + c : src, ok);
  }
}

// Qs = T(f32(q) * scale) in place over a whole tile.
template <int D>
__device__ __forceinline__ void scale_tile(bf16* tile, float scale) {
  for (int i = threadIdx.x; i < 64 * D / 2; i += MMA_THREADS) {
    const int r = i / (D / 2), c = (i % (D / 2)) * 2;
    __nv_bfloat162* p =
        reinterpret_cast<__nv_bfloat162*>(tile + r * ld_of<D>() + c);
    const float2 f = __bfloat1622float2(*p);
    *p = __floats2bfloat162_rn(f.x * scale, f.y * scale);
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
