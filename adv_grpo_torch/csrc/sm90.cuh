// PTX helpers for Hopper (sm_90a) kernels: mbarriers, TMA tile loads and
// reduce-adds, wgmma shared-memory descriptors and the wgmma instructions the
// attention kernels use, the wgmma fence / commit / wait, named barriers and
// setmaxnreg; the 3xTF32 split, mma.sync m16n8k8 in TF32 and cp.async (the
// generic kernels' fp32 instances); the qk-RMS arithmetic of the joint
// attention; and, on the host, the TMA tensor maps of the attention
// operands. Hand-written inline PTX (no CuTe), so a source that includes
// this header compiles in seconds. The attention forward
// (attention_fwd_sm90.cu), backward (attention_bwd_sm90.cu) and the generic
// kernels (attention_generic.cuh) include it.
//
// Shared-memory tiles of bf16 use the 128-byte swizzle that TMA writes with
// CU_TENSOR_MAP_SWIZZLE_128B: a tile is a stack of 1024-byte atoms of 8 rows
// x 64 bf16 (128 bytes), the 16-byte chunk c of row r stored at chunk
// c ^ (r % 8). Every tile starts 1024-byte aligned.

#pragma once

#include <cuda.h>  // CUtensorMap (types only: nothing here links libcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace sm90 {

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ── the qk-RMS of the joint attention kernels ──
// Shared by the forward's q transform and k pre-pass and the backward's
// pre-pass, so that both read bit-identical q^ and k^ (their plain twins,
// ops/joint_attention.py, round them the same way).

// 1 / sqrt(mean(x^2) + eps) of a row whose sum of squares is ss: a
// correctly rounded square root and division (not rsqrtf)
template <int D>
__device__ __forceinline__ float rms_scale(float ss, float eps) {
  return 1.f / sqrtf(ss * (1.f / D) + eps);
}

// the sum of the squares of 8 bf16 columns, in column order (each square is
// exact in fp32, so a contraction into FMA rounds the same)
__device__ __forceinline__ float sum_sq(const uint4& x) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
  float ss = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    ss += f.x * f.x;
    ss += f.y * f.y;
  }
  return ss;
}

// the 8 columns of x: bf16(x * rs * w * scale) in the TPU's order, with
// w8 their 8 weights, x * scale alone where w8 is null
__device__ __forceinline__ uint4 scale_chunk(const uint4& x, float rs, const float* w8,
                                             float scale) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
  uint4 out;
  uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float2 f = __bfloat1622float2(h[e]);
    if (w8 != nullptr) {
      f.x = f.x * rs * w8[2 * e];
      f.y = f.y * rs * w8[2 * e + 1];
    }
    o[e] = pack_bf16(f.x * scale, f.y * scale);
  }
  return out;
}

// ── mbarriers ──

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the other threads and to TMA
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// one arrival, and `bytes` more expected from TMA before the phase completes
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// spins until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// ── TMA ──

// a 4-D box of `map` at coordinates (c0 innermost) into shared memory; the
// bytes complete on `bar`. Coordinates past the tensor read as zeros.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// global[box at (c0, c1, c2)] += shared (fp32), elementwise, in the async
// proxy; elements past the tensor are dropped. Completes in a bulk group.
__device__ __forceinline__ void tma_reduce_add_3d(const CUtensorMap* map, const void* src, int c0,
                                                  int c1, int c2) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.3d.global.shared::cta.add.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// until at most N bulk groups still read shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// until at most N bulk groups are still in flight at all
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// orders this thread's ordinary shared-memory writes before later reads of
// the async proxy (wgmma operands, TMA stores and reduces)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ── threads ──

__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// counts this warp's threads towards barrier `id` without waiting for it
__device__ __forceinline__ void named_bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ── wgmma ──

// Descriptor of a 128-byte-swizzled bf16 operand at shared address `addr`.
// K-major (the contraction dim contiguous): sbo = 1024, the stride of 8-row
// groups; a k16 step inside the 64-wide atom adds 32 bytes to addr. MN-major
// (rows along the contraction dim): sbo = 1024 between groups of 8 rows of
// the contraction, lbo = the stride of the 64-wide column blocks.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  uint64_t d = static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
  d |= static_cast<uint64_t>(1) << 62;  // 128-byte swizzle
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses of these registers across a
// wgmma issue or wait (the tensor cores read and write them asynchronously)
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

#define SM90_F4(i) "+f"(d[i]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3])
#define SM90_F16(i) SM90_F4(i), SM90_F4((i) + 4), SM90_F4((i) + 8), SM90_F4((i) + 12)
#define SM90_R64                                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "   \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "    \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "    \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d (64 x 64 fp32) (+)= A (64 x 16, shared) * B (16 x 64, shared); kTA / kTB:
// A / B MN-major. scale_d = 0 overwrites d.
template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_m64n64_ss(float (&d)[32], uint64_t da, uint64_t db,
                                                int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : SM90_F16(0), SM90_F16(16)
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTA), "n"(kTB));
}

// d (64 x 128 fp32) (+)= A (64 x 16, shared) * B (16 x 128, shared)
template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_m64n128_ss(float (&d)[64], uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " SM90_R64
      ", %64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : SM90_F16(0), SM90_F16(16), SM90_F16(32), SM90_F16(48)
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTA), "n"(kTB));
}

// d (64 x 64 fp32) (+)= A (64 x 16 bf16 in registers) * B (16 x 64, shared)
template <int kTB>
__device__ __forceinline__ void wgmma_m64n64_rs(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : SM90_F16(0), SM90_F16(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(kTB));
}

// d (64 x 128 fp32) (+)= A (64 x 16 bf16 in registers) * B (16 x 128, shared)
template <int kTB>
__device__ __forceinline__ void wgmma_m64n128_rs(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " SM90_R64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n"
      "}\n"
      : SM90_F16(0), SM90_F16(16), SM90_F16(32), SM90_F16(48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(kTB));
}

// d (64 x N fp32) (+)= A (registers) * B (shared), N = 64 or 128
template <int N, int kTB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  if constexpr (N == 64)
    wgmma_m64n64_rs<kTB>(d, a, db, scale_d);
  else
    wgmma_m64n128_rs<kTB>(d, a, db, scale_d);
}

// ── wgmma in TF32 (fp32 operands in a 3xTF32 split; the generic forward) ──
// TF32 operands in shared memory must be K-major (no transpose for 32-bit
// types): 128-byte-swizzled tiles, 32 tf32 to a row's 128-byte atom, a k8
// step 32 bytes into it (desc_sw128 as for bf16, lbo unused, sbo = 1024).
// A from registers takes the m16n8k8 A layout in each warp's 16 rows: lane
// (g, c) holds (g, c), (g + 8, c), (g, c + 4), (g + 8, c + 4).

// d (64 x 32 fp32) (+)= A (64 x 8, shared) * B (8 x 32, shared)
__device__ __forceinline__ void wgmma_m64n32k8_tf32_ss(float (&d)[16], uint64_t da, uint64_t db,
                                                       int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, "
      "%17, p, 1, 1;\n"
      "}\n"
      : SM90_F16(0)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 32 fp32) (+)= A (64 x 8 tf32 in registers) * B (8 x 32, shared)
__device__ __forceinline__ void wgmma_m64n32k8_tf32_rs(float (&d)[16], const uint32_t (&a)[4],
                                                       uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, "
      "%17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : SM90_F16(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (64 x 64 fp32) (+)= A (64 x 8 tf32 in registers) * B (8 x 64, shared)
__device__ __forceinline__ void wgmma_m64n64k8_tf32_rs(float (&d)[32], const uint32_t (&a)[4],
                                                       uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : SM90_F16(0), SM90_F16(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (64 x 128 fp32) (+)= A (64 x 8 tf32 in registers) * B (8 x 128, shared)
__device__ __forceinline__ void wgmma_m64n128k8_tf32_rs(float (&d)[64], const uint32_t (&a)[4],
                                                       uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
      "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : SM90_F16(0), SM90_F16(16), SM90_F16(32), SM90_F16(48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (64 x N fp32) (+)= A (registers) * B (shared), N = 32, 64 or 128
template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  if constexpr (N == 32)
    wgmma_m64n32k8_tf32_rs(d, a, db, scale_d);
  else if constexpr (N == 64)
    wgmma_m64n64k8_tf32_rs(d, a, db, scale_d);
  else
    wgmma_m64n128k8_tf32_rs(d, a, db, scale_d);
}

#undef SM90_R64
#undef SM90_F16
#undef SM90_F4

// ── fp32 on the tensor cores: the 3xTF32 split and mma.sync ──
// (the generic attention kernels' fp32 instances; their products,
// attention_generic.cuh `scores_3xtf32` / `update_3xtf32`, form a.b as
// big.small + small.big + big.big, CUTLASS's OpMultiplyAddFastF32, accurate
// to about 2^-22 of each product: small.small is dropped)

// x rounded to TF32 (10 mantissa bits) to nearest, ties away from zero, as
// cvt.rna.tf32.f32 rounds: the bit pattern plus half a TF32 unit, the 13
// low bits cleared (two integer instructions; inf and NaN stay so)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small + O(2^-22 |x|): big = tf32(x), small = tf32(x - big)
// (x - big is exact in fp32)
template <int N>
__device__ __forceinline__ void split_tf32(const float (&x)[N], uint32_t (&big)[N],
                                           uint32_t (&small)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    big[i] = tf32_rna(x[i]);
    small[i] = tf32_rna(x[i] - __uint_as_float(big[i]));
  }
}

// d (16 x 8 fp32) += a (16 x 8 tf32, row) * b (8 x 8 tf32, col); lane l
// (g = l / 4, c = l % 4) holds a = (a[g][c], a[g+8][c], a[g][c+4],
// a[g+8][c+4]), b = (b[c][g], b[c+4][g]) and d = (d[g][2c], d[g][2c+1],
// d[g+8][2c], d[g+8][2c+1])
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ── cp.async: asynchronous global -> shared copies ──

// 16 bytes, or 16 zero bytes where !valid (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes, or a zero word where !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ── host side: launch set-up ──

constexpr int kMaxDevices = 16;

// lets `kernel` use `bytes` of dynamic shared memory (above 48 KB only after
// this opt-in), once per device: `done` is the caller's per-kernel record,
// since the driver call would otherwise cost every launch
template <typename Kernel>
inline cudaError_t opt_in_smem(Kernel kernel, int bytes, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kMaxDevices && done[dev])) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

// ── host side: TMA tensor maps ──

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (a libcuda entry point) looked up through the
// runtime, so the library links without -lcuda
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

struct HeadView {  // bf16 rows of D contiguous columns per head, element strides
  const void* ptr;
  long long sb, ss, sh;
  int rows;
};

// A tensor map is a function of its encode arguments alone, and a model's
// layers hand the same (pointer, shape, strides) again and again (the
// caching allocator reuses its blocks): the last kMapMemo maps encoded on
// this thread by one call site are kept under their key and looked up first,
// newest first (one call's maps sit together), so a repeated call costs a
// short scan instead of an encode. `encode(map)` encodes on a miss.
constexpr int kMapMemo = 64;

template <typename Encode>
inline bool memo_map(CUtensorMap* map, const cuuint64_t (&key)[9], Encode encode) {
  struct Memo {
    cuuint64_t key[kMapMemo][9];
    CUtensorMap map[kMapMemo];
    int n = 0, next = 0;
  };
  thread_local Memo memo;
  for (int i = 1; i <= memo.n; ++i) {
    const int j = (memo.next - i + kMapMemo) % kMapMemo;
    if (memcmp(memo.key[j], key, sizeof key) == 0) {
      *map = memo.map[j];
      return true;
    }
  }
  if (!encode(map)) return false;
  memcpy(memo.key[memo.next], key, sizeof key);
  memo.map[memo.next] = *map;
  memo.next = (memo.next + 1) % kMapMemo;
  memo.n = memo.n < kMapMemo ? memo.n + 1 : kMapMemo;
  return true;
}

// the 4-D map (D, H, S, B) of a BSHD view (heads inner), or (D, S, H, B) of
// a BHSD one; boxes of 64 columns x `box_rows` rows of one head, 128-byte
// swizzle. Rows at or past x.rows read as zeros. Memoised (memo_map).
inline bool bf16_map(CUtensorMap* map, const HeadView& x, int d, int heads, int batch, bool bhsd,
                     int box_rows) {
  const cuuint64_t inner = bhsd ? x.rows : heads, outer = bhsd ? heads : x.rows;
  const cuuint64_t s1 = 2ull * (bhsd ? x.ss : x.sh), s2 = 2ull * (bhsd ? x.sh : x.ss);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), inner, outer,
                              static_cast<cuuint64_t>(batch)};
  // a batch of one may carry any stride: give it the dense one
  const cuuint64_t strides[3] = {s1, s2, batch > 1 ? 2ull * x.sb : s2 * outer};
  const cuuint32_t rows = static_cast<cuuint32_t>(box_rows);
  const cuuint32_t box[4] = {64, bhsd ? rows : 1u, bhsd ? 1u : rows, 1};
  const cuuint64_t key[9] = {reinterpret_cast<cuuint64_t>(x.ptr), dims[0], dims[1], dims[2],
                             dims[3], strides[0], strides[1], strides[2],
                             (static_cast<cuuint64_t>(rows) << 1) | (bhsd ? 1u : 0u)};
  return memo_map(map, key, [&](CUtensorMap* m) {
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    return encode_tiled()(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x.ptr),
                          dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
  });
}

}  // namespace sm90
