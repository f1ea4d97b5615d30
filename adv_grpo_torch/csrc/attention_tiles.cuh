// Tile plumbing of the mma.sync joint attention backward
// (joint_attention_bwd.cu): bf16 mma.sync / ldmatrix wrappers, and the
// 64-row head-tile load that applies the per-head qk-RMS on its way into
// shared memory.
//
// Tile geometry: a block of 4 warps works on 64-row tiles of one head of
// width D (64 or 128, a template argument); each warp owns 16 rows of the
// tile it iterates with.
// Shared tiles have a pitch of D + 8 bf16 (72 or 136: 4 words more than a
// multiple of 32), so the eight row addresses of an ldmatrix hit distinct
// banks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace attn {

using bf16 = __nv_bfloat16;

constexpr int kD = 64;     // the default head width of the helpers below
constexpr int kBQ = 64;    // q rows per tile
constexpr int kBKV = 64;   // kv rows per tile
constexpr int kWarps = 4;  // each warp owns 16 rows
constexpr int kThreads = 32 * kWarps;
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kBQ == 16 * kWarps && kBQ == kBKV, "tile geometry");

// bf16 pitch of a shared tile of D columns
template <int D>
__host__ __device__ constexpr int ld_of() {
  static_assert(D == 64 || D == 128, "head dims 64 and 128");
  return D + 8;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a (16x16, row) * b (16x8, col); bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// acc (16 x 8N) += A * B^T with both operands in shared memory: A is the 16
// rows of a D-wide tile starting at `a`, B the 8N rows starting at `b`; the
// contraction runs along their D columns. A's fragments are read per
// 16-column step (ldmatrix), so they hold no registers across calls.
template <int D, int N>
__device__ __forceinline__ void mma_abt_ss(float (&acc)[N][4], const bf16* a, const bf16* b,
                                           int lane) {
  constexpr int ld = ld_of<D>();
  const int lm_row = lane & 7, lm_mat = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    // A matrices: rows 0-7 / 8-15 x columns 16kk / 16kk+8 -> a[0..3]
    uint32_t af[4];
    ldmatrix_x4(af, a + (lm_row + 8 * (lm_mat & 1)) * ld + 16 * kk + 8 * (lm_mat >> 1));
#pragma unroll
    for (int j = 0; j < N; j += 2) {
      uint32_t bf[4];
      ldmatrix_x4(bf, b + (8 * (j + (lm_mat >> 1)) + lm_row) * ld + 16 * kk +
                          8 * (lm_mat & 1));
      mma_16816(acc[j], af, bf[0], bf[1]);
      mma_16816(acc[j + 1], af, bf[2], bf[3]);
    }
  }
}

// acc (16 x D) += a (16 x 16KS, A fragments) * tile (16KS rows x D columns),
// the contraction running down the tile's rows (P.V shape): transposed
// ldmatrix of the tile.
template <int D = kD, int KS = 4>
__device__ __forceinline__ void mma_ab(float (&acc)[D / 8][4], const uint32_t (&a)[KS][4],
                                       const bf16* tile, int lane) {
  constexpr int ld = ld_of<D>();
  const int lm_row = lane & 7, lm_mat = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
    for (int n = 0; n < D / 8; n += 2) {
      // transposed matrices: tile rows 16kk / 16kk+8, columns 8n / 8(n+1)
      uint32_t b[4];
      ldmatrix_x4_trans(b, tile + (16 * kk + 8 * (lm_mat & 1) + lm_row) * ld +
                               8 * (n + (lm_mat >> 1)));
      mma_16816(acc[n], a[kk], b[0], b[1]);
      mma_16816(acc[n + 1], a[kk], b[2], b[3]);
    }
  }
}

// A 16 x 8N accumulator (rows g, g+8; columns 8j + 2t, +1) as the bf16 A
// fragments of the next product, whose contraction runs over those columns.
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[N / 2][4], const float (&acc)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    a[j / 2][(j & 1) * 2] = pack_bf16(acc[j][0], acc[j][1]);
    a[j / 2][(j & 1) * 2 + 1] = pack_bf16(acc[j][2], acc[j][3]);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
}

// A 64-row x D-column tile of one head moves global -> registers -> shared
// memory as 16-byte vectors: thread i holds row (i / (D/8)) + (128 / (D/8)) * k,
// columns 8 * (i % (D/8)) .. +8. A row's D/8 vectors sit in neighbouring
// lanes (8 at D = 64, 16 at D = 128), so its RMS is a shuffle reduction
// among them.
template <int D>
struct TileRegsT {
  static constexpr int kVecPerRow = D / 8;
  static constexpr int kRowsPerPass = kThreads / kVecPerRow;
  static constexpr int kVecPerThread = kBKV * D / 8 / kThreads;
  uint4 v[kVecPerThread];
};

template <int D>
__device__ __forceinline__ void fetch_tile(TileRegsT<D>& regs, const bf16* src,
                                           long long row_stride, int row0, int len) {
  using R = TileRegsT<D>;
  const int col = 8 * (threadIdx.x % R::kVecPerRow);
#pragma unroll
  for (int k = 0; k < R::kVecPerThread; ++k) {
    const int r = row0 + threadIdx.x / R::kVecPerRow + R::kRowsPerPass * k;
    regs.v[k] = r < len ? *reinterpret_cast<const uint4*>(src + r * row_stride + col)
                        : make_uint4(0u, 0u, 0u, 0u);
  }
}

// RMS in fp32, then x weight (when `w` is given), then x scale_a (and x
// scale_b), then the cast to bf16 — the TPU kernel's op order — and the store
// into `dst_a` (and `dst_b`, when given: two roundings of one normalised row).
template <int D>
__device__ __forceinline__ void store_tile(bf16* dst_a, const TileRegsT<D>& regs,
                                           const float* w, float eps, float scale_a,
                                           bf16* dst_b = nullptr, float scale_b = 1.f) {
  using R = TileRegsT<D>;
  constexpr int ld = ld_of<D>();
  const int col = 8 * (threadIdx.x % R::kVecPerRow);
  float wv[8];
  if (w != nullptr) {
#pragma unroll
    for (int e = 0; e < 8; ++e) wv[e] = w[col + e];
  }
#pragma unroll
  for (int k = 0; k < R::kVecPerThread; ++k) {
    const int off = (threadIdx.x / R::kVecPerRow + R::kRowsPerPass * k) * ld + col;
    if (w == nullptr && scale_a == 1.f && dst_b == nullptr) {
      *reinterpret_cast<uint4*>(dst_a + off) = regs.v[k];
      continue;
    }
    const __nv_bfloat162* in = reinterpret_cast<const __nv_bfloat162*>(&regs.v[k]);
    float f[8];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 p = __bfloat1622float2(in[e]);
      f[2 * e] = p.x;
      f[2 * e + 1] = p.y;
    }
    if (w != nullptr) {
      float ss = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) ss += f[e] * f[e];
#pragma unroll
      for (int o = 1; o < R::kVecPerRow; o <<= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
      const float rs = rsqrtf(ss / D + eps);
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = f[e] * rs * wv[e];
    }
    uint4 out;
    __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      o2[e] = __floats2bfloat162_rn(f[2 * e] * scale_a, f[2 * e + 1] * scale_a);
    *reinterpret_cast<uint4*>(dst_a + off) = out;
    if (dst_b != nullptr) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o2[e] = __floats2bfloat162_rn(f[2 * e] * scale_b, f[2 * e + 1] * scale_b);
      *reinterpret_cast<uint4*>(dst_b + off) = out;
    }
  }
}

// Rows g and g+8 of a warp's 16 x D fp32 accumulator, divided by div0 /
// div1, as bf16 into a (B, S, H*D) tensor (row pitch `row_stride`), rows <
// len only.
template <int D = kD>
__device__ __forceinline__ void store_rows(bf16* base, long long row_stride, int r0, int len,
                                           const float (&acc)[D / 8][4], float div0,
                                           float div1, int t) {
  const int r1 = r0 + 8;
  bf16* ob = base + 2 * t;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    if (r0 < len)
      *reinterpret_cast<__nv_bfloat162*>(ob + r0 * row_stride + 8 * n) =
          __floats2bfloat162_rn(acc[n][0] / div0, acc[n][1] / div0);
    if (r1 < len)
      *reinterpret_cast<__nv_bfloat162*>(ob + r1 * row_stride + 8 * n) =
          __floats2bfloat162_rn(acc[n][2] / div1, acc[n][3] / div1);
  }
}

}  // namespace attn
