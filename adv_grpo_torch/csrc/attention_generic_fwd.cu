// The generic attention forward for Hopper (sm_90a): fp32 at any head width
// d <= 128, bf16 at the widths d <= 128 other than 64 and 128, in the four
// layouts of the wgmma + TMA forward (attention_generic.cuh: kJoint two
// streams or one, with or without the fused qk-RMS; kBshd with kv_len and
// row strides; kBhsd).
//
// Replaces, where the wgmma + TMA kernel (attention_fwd_sm90.cu) does not
// reach: adv_grpo_tpu/ops/joint_attention.py `_joint_fwd_kernel` (#2) and
// `_single_fwd_kernel` (#3), adv_grpo_tpu/ops/attention.py
// `_bshd_fwd_kernel` (#8) and `_fwd_kernel` (#10). The TPU kernels take any
// dtype (their dots run in the input's dtype) and any d with 128 % d == 0,
// packing 128 / d heads per column group, and fall back to the unfused
// composition of the same kernels elsewhere; the (B, H, S, D) kernel at the
// end of that chain takes a whole head of any width.
//
// Bound on this card: in fp32 the tensor cores at a third of their TF32
// rate (3xTF32: 495 / 3 = 165 TFLOP/s of fp32-accurate products; FFMA
// would give 67); in bf16 the tensor cores (989 TFLOP/s), which the bf16
// instance does not use. PERF.md has the times beside both bounds.
//
// fp32 design (attn_generic_fwd_tf32_kernel). Each product runs on the
// tensor cores as three TF32 wgmma: every fp32 operand x splits into big =
// tf32(x) (to nearest, ties away) and small = tf32(x - big), and a.b =
// big.small + small.big + big.big in fp32 accumulators (CUTLASS's
// OpMultiplyAddFastF32), accurate to about 2^-22 of each product. TF32
// wgmma reads shared-memory operands K-major only and TMA cannot split, so
// the kernel stages fp32 rows by cp.async and writes the planes itself: q
// and k as they are (d contiguous), v transposed (kv contiguous), each a
// 128-byte-swizzled tile, the two planes twice the fp32 tile. One CTA of
// two warpgroups per (128-row q tile, head, batch item), 64 q rows each, so
// one warpgroup's softmax runs while the other's products do; both share
// each 32-row kv tile's planes, which all 256 threads split, and the next
// tile's rows load while this one is multiplied. The walk covers the kv
// tiles of stream 0, then of stream 1, with an online base-2 softmax in
// the accumulator layout. s = q k^T reads both planes from shared memory
// (small products in one accumulator, big ones in another); o += p v takes
// p from registers: lane (g, c) holds columns 2c, 2c + 1 of each 8-column
// step, the A fragment's k positions c, c + 4, so v^T stores the kv rows of
// each step in the order 0, 2, 4, 6, 1, 3, 5, 7 (a permutation of the sum;
// p needs no shuffle). Each tile's p v lands in a fresh accumulator and is
// added into o with rounding to nearest: the tensor cores add with
// truncation, and a long run of adds into one register drifts. 225 KB of
// shared memory at d = 128 (one CTA an SM), 113 KB at 64. No atomics: a run
// repeats bitwise.
//
// bf16 design (attn_generic_fwd_kernel, the simple FFMA kernel, unchanged).
// One CTA of 256 threads per (64-row q tile, head, batch item),
// which walks the 128-row kv tiles of stream 0 and then of stream 1 (the
// twin's tile, so the running max, and with it where bf16 rounds p, is the
// twin's) with an online base-2 softmax. The q tile, each K / V tile and
// the tile of p are staged in shared memory as fp32, rows padded by one
// word against bank conflicts. Thread (ty, tx) owns the q rows 4ty..4ty+3
// and, of the scores, the kv columns tx + 16j, of the output the columns tx
// + 16c: the row statistics stay in its registers, reduced over the 16 lanes
// of a row group by shuffles. p = exp2(s - m) is rounded to dt for p.v and
// summed unrounded into l, as the twin does; o = acc / l and lse = ln2 (m +
// log2 l), fp32 (B, H, S).

#include <type_traits>

#include "attention_generic.cuh"

namespace generic_attn {
namespace {

constexpr int kBQ = 64;    // q rows of a CTA
constexpr int kBKV = 128;  // kv rows of a tile (the twin's KV_TILE)

template <int DMAX>
struct FwdSmem {
  static constexpr int kLd = DMAX + 1;  // padded row of the Q and K tiles
  static constexpr int kLdP = kBKV + 1;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kBQ * kLd;
  static constexpr int kV = kK + kBKV * kLd;
  static constexpr int kP = kV + kBKV * DMAX;
  static constexpr int kFloats = kP + kBQ * kLdP;
  static constexpr size_t kBytes = kFloats * sizeof(float);
};

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads) attn_generic_fwd_kernel(const __grid_constant__ Params p) {
  using L = FwdSmem<DMAX>;
  constexpr int C = DMAX / 16;  // output columns a thread owns
  extern __shared__ float smem[];
  float* sQ = smem + L::kQ;
  float* sK = smem + L::kK;
  float* sV = smem + L::kV;
  float* sP = smem + L::kP;
  const int h = blockIdx.y, b = blockIdx.z;
  int t = blockIdx.x;
  const Stream& S = p.st[stream_of(p, kBQ, false, t)];
  const int r0 = t * kBQ;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  load_tile<T, DMAX>(sQ, L::kLd, kBQ, S.q, b, h, r0, imin(kBQ, S.q_rows - r0), p.d);

  float m[4], l[4], acc[4][C];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;
  }
  for (int ks = 0; ks < p.nst; ++ks) {
    const Stream& K = p.st[ks];
    for (int c0 = 0; c0 < K.kv_valid; c0 += kBKV) {
      const int nk = imin(kBKV, K.kv_valid - c0);
      __syncthreads();  // the last tile's K, V and p are read
      load_tile<T, DMAX>(sK, L::kLd, kBKV, K.k, b, h, c0, nk, p.d);
      load_tile<T, DMAX>(sV, DMAX, kBKV, K.v, b, h, c0, nk, p.d);
      __syncthreads();
      float s[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
      for (int e = 0; e < DMAX; ++e) {
        float qa[4], kb[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) qa[i] = sQ[(4 * ty + i) * L::kLd + e];
#pragma unroll
        for (int j = 0; j < 8; ++j) kb[j] = sK[(tx + 16 * j) * L::kLd + e];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[i][j] = tx + 16 * j < nk ? s[i][j] * p.score_scale : -INFINITY;
          mx = fmaxf(mx, s[i][j]);
        }
#pragma unroll
        for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_new = fmaxf(m[i], mx);
        const float a = exp2f(m[i] - m_new);
        float ps = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float pj = exp2f(s[i][j] - m_new);
          ps += pj;
          sP[(4 * ty + i) * L::kLdP + tx + 16 * j] = round_to<T>(pj);
        }
#pragma unroll
        for (int o = 8; o > 0; o >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, o);
        l[i] = l[i] * a + ps;
        m[i] = m_new;
#pragma unroll
        for (int c = 0; c < C; ++c) acc[i][c] *= a;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < nk; ++kk) {
        float pa[4], vb[C];
#pragma unroll
        for (int i = 0; i < 4; ++i) pa[i] = sP[(4 * ty + i) * L::kLdP + kk];
#pragma unroll
        for (int c = 0; c < C; ++c) vb[c] = sV[kk * DMAX + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < C; ++c) acc[i][c] = fmaf(pa[i], vb[c], acc[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + 4 * ty + i;
    if (row >= S.q_rows) continue;
    const float den = l[i] == 0.f ? 1.f : l[i];
    T* o = at_mut<T>(S.out, b, row, h);
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (tx + 16 * c < p.d) o[tx + 16 * c] = from_f<T>(acc[i][c] / den);
    if (tx == 0 && S.lse != nullptr)
      S.lse[(static_cast<long long>(b) * p.heads + h) * S.q_rows + row] =
          (m[i] + log2f(fmaxf(l[i], 1e-37f))) * kLn2;
  }
}

// ── fp32: the tensor cores in a 3xTF32 split, on wgmma ──

constexpr int kTfThreads = 256;  // two warpgroups of 64 q rows, 16 a warp
constexpr int kTfBQ = 128;       // q rows of a CTA
constexpr int kTfBKV = 32;       // kv rows of a tile (one 128-byte atom of V^T)

// Shared memory, in bytes from a 1024-byte-aligned base: the TF32 planes
// (big, small) of the q tile, of the K tile (both K-major, 128-byte
// swizzle) and of the V^T tile (DMAX rows of the tile's 32 kv rows, K-major,
// the kv rows of each 8-row step in the order 0, 2, 4, 6, 1, 3, 5, 7), then
// the fp32 staging of the next tile's K and V rows (cp.async; the q tile's
// rows at the start, 64 at a time), rows padded to DMAX + 4 words. 225 KB
// at d = 128.
template <int DMAX>
struct TfFwdSmem {
  static constexpr int kLdRaw = DMAX + 4;
  static constexpr int kQPlane = kTfBQ * DMAX * 4, kKPlane = kTfBKV * DMAX * 4;
  static constexpr int kVPlane = DMAX * 128;
  static constexpr int kQb = 0, kQs = kQb + kQPlane;
  static constexpr int kKb = kQs + kQPlane, kKs = kKb + kKPlane;
  static constexpr int kVb = kKs + kKPlane, kVs = kVb + kVPlane;
  static constexpr int kRaw = kVs + kVPlane;
  static constexpr int kBytes = kRaw + 2 * kTfBKV * kLdRaw * 4;
  static_assert(kTfBQ / 2 <= 2 * kTfBKV, "q is staged where K and V are, in halves");
};

// byte offset of columns k .. k + 3 (k % 4 == 0) of row r in a K-major
// 128-byte-swizzled tile of `rows` rows: column block k / 32, 16-byte chunk
// (k % 32 / 4) ^ (r % 8) of the row's 128 bytes
__device__ __forceinline__ int sw128_off(int r, int k, int rows) {
  return (k >> 5) * rows * 128 + r * 128 + ((((k & 31) >> 2) ^ (r & 7)) << 4);
}

// the TF32 planes of `rows` staged fp32 rows, as rows row0.. of K-major
// planes of plane_rows rows: each thread a 16-byte chunk (a quarter-warp
// reads one row's 128 bytes and writes 8 distinct chunks)
template <int DMAX>
__device__ __forceinline__ void split_rows(uint8_t* big, uint8_t* small, const float* raw,
                                           int rows, int row0, int plane_rows) {
  constexpr int VPR = DMAX / 4;
  for (int idx = threadIdx.x; idx < rows * VPR; idx += blockDim.x) {
    const int r = idx / VPR, k = (idx % VPR) * 4;
    const float4 v = *reinterpret_cast<const float4*>(raw + r * (DMAX + 4) + k);
    const float x[4] = {v.x, v.y, v.z, v.w};
    uint32_t b[4], sm[4];
    sm90::split_tf32(x, b, sm);
    const int off = sw128_off(row0 + r, k, plane_rows);
    *reinterpret_cast<uint4*>(big + off) = make_uint4(b[0], b[1], b[2], b[3]);
    *reinterpret_cast<uint4*>(small + off) = make_uint4(sm[0], sm[1], sm[2], sm[3]);
  }
}

// the TF32 planes of V^T from the staged tile's 32 kv rows: lane j reads
// row j (rows padded by 4 words: a quarter-warp's 8 rows hit distinct
// banks) and writes its 4 columns to 4 rows of V^T at k position 8 (j / 8)
// + (j % 8) / 2 + 4 (j % 2), which the 32 lanes spread over distinct banks
template <int DMAX>
__device__ __forceinline__ void split_vt(uint8_t* big, uint8_t* small, const float* raw) {
  const int j = threadIdx.x & 31;
  const int kp = 8 * (j >> 3) + ((j & 7) >> 1) + 4 * (j & 1);
  for (int n = 4 * (threadIdx.x >> 5); n < DMAX; n += 4 * (kTfThreads / 32)) {
    const float4 v = *reinterpret_cast<const float4*>(raw + j * (DMAX + 4) + n);
    const float x[4] = {v.x, v.y, v.z, v.w};
    uint32_t b[4], sm[4];
    sm90::split_tf32(x, b, sm);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = n + e;
      const int off = row * 128 + ((((kp >> 2) ^ (row & 7))) << 4) + ((kp & 3) << 2);
      *reinterpret_cast<uint32_t*>(big + off) = b[e];
      *reinterpret_cast<uint32_t*>(small + off) = sm[e];
    }
  }
}

template <int DMAX>
__global__ void __launch_bounds__(kTfThreads, 1)
    attn_generic_fwd_tf32_kernel(const __grid_constant__ Params p) {
  using L = TfFwdSmem<DMAX>;
  constexpr int LDR = L::kLdRaw, NO = DMAX / 2;  // o: NO accumulator registers
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  float* raw = reinterpret_cast<float*>(smem + L::kRaw);
  const uint32_t base = sm90::smem_u32(smem);
  const int h = blockIdx.y, b = blockIdx.z;
  int t = blockIdx.x;
  const Stream& S = p.st[stream_of(p, kTfBQ, false, t)];
  const int r0 = t * kTfBQ;
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;

  // the kv tiles of stream 0, then of stream 1
  const int n0 = cdiv(p.st[0].kv_valid, kTfBKV);
  const int ntiles = n0 + (p.nst > 1 ? cdiv(p.st[1].kv_valid, kTfBKV) : 0);
  auto tile_rows = [&](int i, int& c0) {
    const int si = i < n0 ? 0 : 1;
    c0 = (i - (si ? n0 : 0)) * kTfBKV;
    return imin(kTfBKV, p.st[si].kv_valid - c0);
  };
  auto issue = [&](int i) {
    const Stream& K = p.st[i < n0 ? 0 : 1];
    int c0;
    const int nk = tile_rows(i, c0);
    load_tile_async<DMAX>(raw, LDR, kTfBKV, K.k, b, h, c0, nk, p.d);
    load_tile_async<DMAX>(raw + kTfBKV * LDR, LDR, kTfBKV, K.v, b, h, c0, nk, p.d);
  };

  // the q tile's planes, once, 64 rows at a time
  for (int half = 0; half < 2; ++half) {
    const int q0 = r0 + 64 * half;
    load_tile_async<DMAX>(raw, LDR, 64, S.q, b, h, q0, imin(64, S.q_rows - q0), p.d);
    sm90::cp_async_commit();
    sm90::cp_async_wait<0>();
    __syncthreads();
    split_rows<DMAX>(smem + L::kQb, smem + L::kQs, raw, 64, 64 * half, kTfBQ);
    __syncthreads();  // the staged q rows are read before the next rows land there
  }
  if (ntiles > 0) issue(0);
  sm90::cp_async_commit();

  // accumulators (rows 64 wg + 16 warp + g and + 8; columns 8 n + 2c, + 1
  // at [4n .. 4n + 3]): o, the scores (big products in s, small ones in x)
  // and each tile's p v (tv), added into o with rounding to nearest
  float o[NO], tv[NO], s[16], x[16], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = tv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) s[i] = x[i] = 0.f;
  for (int i = 0; i < ntiles; ++i) {
    sm90::cp_async_wait<0>();
    __syncthreads();  // tile i is staged; the last tile's wgmmas are done
    split_rows<DMAX>(smem + L::kKb, smem + L::kKs, raw, kTfBKV, 0, kTfBKV);
    split_vt<DMAX>(smem + L::kVb, smem + L::kVs, raw + kTfBKV * LDR);
    sm90::fence_proxy_async();  // the planes, before the wgmmas read them
    __syncthreads();            // and the staging is read: the next tile may land
    if (i + 1 < ntiles) issue(i + 1);
    sm90::cp_async_commit();
    int c0;
    const int nk = tile_rows(i, c0);

    // s = q k^T over the tile's 32 kv columns, each warpgroup its 64 q rows
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DMAX / 8; ++kk) {
      const uint32_t qo = (kk / 4) * kTfBQ * 128 + wg * 64 * 128 + (kk % 4) * 32;
      const uint32_t ko = (kk / 4) * kTfBKV * 128 + (kk % 4) * 32;
      const uint64_t qb = sm90::desc_sw128(base + L::kQb + qo, 16, 1024);
      const uint64_t qs = sm90::desc_sw128(base + L::kQs + qo, 16, 1024);
      const uint64_t kb = sm90::desc_sw128(base + L::kKb + ko, 16, 1024);
      const uint64_t ks = sm90::desc_sw128(base + L::kKs + ko, 16, 1024);
      sm90::wgmma_m64n32k8_tf32_ss(x, qs, kb, kk > 0);
      sm90::wgmma_m64n32k8_tf32_ss(x, qb, ks, 1);
      sm90::wgmma_m64n32k8_tf32_ss(s, qb, kb, kk > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(s);
    sm90::fence_regs(x);

    // the online base-2 softmax of rows g (e = 0, 1) and g + 8 (e = 2, 3)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i2 = 0; i2 < 16; ++i2) {
      const float v = s[i2] + x[i2];
      s[i2] = 8 * (i2 >> 2) + 2 * c + (i2 & 1) < nk ? v * p.score_scale : -INFINITY;
      mx[(i2 >> 1) & 1] = fmaxf(mx[(i2 >> 1) & 1], s[i2]);
    }
    float a[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      a[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= a[r];  // this lane's part of the row sum
    }
    // p as the A fragments of o += p v: step kk's k positions c, c + 4 are
    // kv columns 2c, 2c + 1 (V^T holds them there)
    uint32_t pb[kTfBKV / 8][4], ps[kTfBKV / 8][4];
#pragma unroll
    for (int kk = 0; kk < kTfBKV / 8; ++kk) {
      float pv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pv[e] = exp2f(s[4 * kk + e] - m[e >> 1]);
        l[e >> 1] += pv[e];
      }
      const float pa[4] = {pv[0], pv[2], pv[1], pv[3]};
      sm90::split_tf32(pa, pb[kk], ps[kk]);
    }
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTfBKV / 8; ++kk) {
      const uint64_t vb = sm90::desc_sw128(base + L::kVb + kk * 32, 16, 1024);
      const uint64_t vs = sm90::desc_sw128(base + L::kVs + kk * 32, 16, 1024);
      sm90::wgmma_tf32_rs<DMAX>(tv, ps[kk], vb, kk > 0);
      sm90::wgmma_tf32_rs<DMAX>(tv, pb[kk], vs, 1);
      sm90::wgmma_tf32_rs<DMAX>(tv, pb[kk], vb, 1);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(tv);
    sm90::fence_regs(pb);
    sm90::fence_regs(ps);
#pragma unroll
    for (int i2 = 0; i2 < NO; ++i2) o[i2] = o[i2] * a[(i2 >> 1) & 1] + tv[i2];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 64 * wg + 16 * warp + g + 8 * r;
    if (row >= S.q_rows) continue;
    const float den = l[r] == 0.f ? 1.f : l[r];
    float* out = at_mut<float>(S.out, b, row, h);
#pragma unroll
    for (int nt = 0; nt < DMAX / 8; ++nt) {
      const int col = 8 * nt + 2 * c;
      if (col < p.d)
        *reinterpret_cast<float2*>(out + col) =
            make_float2(o[4 * nt + 2 * r] / den, o[4 * nt + 2 * r + 1] / den);
    }
    if (c == 0 && S.lse != nullptr)
      S.lse[(static_cast<long long>(b) * p.heads + h) * S.q_rows + row] =
          (m[r] + log2f(fmaxf(l[r], 1e-37f))) * kLn2;
  }
}

template <int DMAX>
int launch_fwd_tf32(const Params& p, int batch, cudaStream_t stream) {
  const int bytes = TfFwdSmem<DMAX>::kBytes + 1024;  // + the 1024-byte alignment
  const auto kernel = attn_generic_fwd_tf32_kernel<DMAX>;
  static bool done[sm90::kMaxDevices] = {};
  const cudaError_t err = sm90::opt_in_smem(kernel, bytes, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(tiles_of(p, kTfBQ, false), p.heads, batch);
  kernel<<<grid, kTfThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DMAX>
int launch_fwd(const Params& p, int batch, cudaStream_t stream) {
  using L = FwdSmem<DMAX>;
  const auto kernel = attn_generic_fwd_kernel<T, DMAX>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(L::kBytes));
  const dim3 grid(tiles_of(p, kBQ, false), p.heads, batch);
  kernel<<<grid, kThreads, L::kBytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run(const long long* desc, int nst, int mode, int batch, int heads, int d, float qscale,
        float eps, cudaStream_t stream) {
  Params p{};
  int rc = setup_streams<T>(p, desc, nst, mode, batch, heads, d, qscale, 0.f, eps, false,
                            stream);
  if (rc != 0) return rc;
  p.score_scale = mode == kJoint ? 1.f : qscale;  // q^ holds the scale in kJoint
  if constexpr (std::is_same<T, float>::value) {
    if (d <= 32) return launch_fwd_tf32<32>(p, batch, stream);
    if (d <= 64) return launch_fwd_tf32<64>(p, batch, stream);
    return launch_fwd_tf32<128>(p, batch, stream);
  } else {
    if (d <= 32) return launch_fwd<T, 32>(p, batch, stream);
    if (d <= 64) return launch_fwd<T, 64>(p, batch, stream);
    return launch_fwd<T, 128>(p, batch, stream);
  }
}

}  // namespace
}  // namespace generic_attn

// desc: `nst` streams of generic_attn::kDescLen int64 each (the lengths, the
// Views of q, k, v and o, the lse and RMS weight pointers, the kJoint
// scratches; attention_generic.cuh `Desc`); dtype: 0 fp32, 1 bf16; mode:
// generic_attn::Mode; qscale = sm_scale * log2 e. Head width d <= 128 and a
// multiple of 16 bytes' worth of elements, every row 16-byte aligned (the
// wrapper checks). Returns the first cudaGetLastError() that is not 0.
extern "C" int attention_generic_fwd(const long long* desc, int nst, int dtype, int mode,
                                     int batch, int num_heads, int head_dim, float qscale,
                                     float eps, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (head_dim < 1 || head_dim > 128 || nst < 1 || nst > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return generic_attn::run<float>(desc, nst, mode, batch, num_heads, head_dim, qscale, eps,
                                    s);
  return generic_attn::run<__nv_bfloat16>(desc, nst, mode, batch, num_heads, head_dim, qscale,
                                          eps, s);
}
