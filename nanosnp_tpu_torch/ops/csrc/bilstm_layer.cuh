// Device code shared by the BiLSTM layer kernels (bilstm.cu) and the
// pileup encoder's fused kernels (bilstm_fused.cu): the mma.sync product
// with ldmatrix B fragments, cp.async, the cluster barrier, the SFU gate
// math, and `fused_layer`, one direction of a layer with its weights in
// shared memory (bilstm.cu's fused path, and each layer of
// bilstm_fused.cu's kernels). Included once by each source, so every
// function keeps internal linkage.
//
// Gate math on the SFU, no IEEE division and no tanhf: 6.5 SFU operations
// a cell in place of 10.
//   sigmoid(v) = 1 / (1 + ex2.approx(-v log2 e)), four of a cell (i, f, o
//                and 2g) sharing one rcp.approx of their denominators'
//                product, each v clamped at -20 so that product stays
//                finite (the clamp moves sigmoid by at most 2.1e-9);
//   tanh(v)    = 2 sigmoid(2v) - 1, two cells' tanh(c) sharing one rcp.
// The PTX ISA bounds ex2.approx.ftz.f32 at 2 ulp and rcp.approx.ftz.f32 at
// 1 ulp; with the products' roundings sigmoid is within 1e-6 of the exact
// value and tanh within 2e-6 (absolute) over all finite v, and large |v|
// saturates without NaN (ex2 gives +0 or a clamped finite value).
// tests/test_torch_bilstm_plan.py holds the formulas to that bound.
//
// Knock-outs. `fused_layer` and `cell_update` take a KnockOut parameter,
// none by default; the probe (bilstm_probe.cu) builds the layer with one
// part of a step removed, so that timing the variants says where a step's
// time sits. Every branch on it is an `if constexpr` (the x buffer's index a
// conditional expression on it, folded at compile time): the default
// compiles to the layer as it is, the same SASS (ops/sass_compare.py; a
// helper function returning that index changed the center kernels' code).
//   kNoGate  the gate math on the SFU (sigmoid4, tanh2) replaced by a
//            linear combine, c = 0.5 c + 0.25 (g_i + g_f),
//            h = 0.5 c + 0.125 (g_g + g_o);
//   kNoMm    no W_hh . h product: gates = W_ih x_t + b; h is still
//            rounded, written to the shared h tile and output (the x
//            product is unrolled one k-tile deep, see fused_layer);
//   kNoDma   x is staged once: the slab of the direction's first step
//            (x[0] for direction 0, x[L-1] for direction 1) serves every
//            step, so no step waits for or starts a copy of x.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kSmemMax = 232448;  // dynamic shared memory a block may use
constexpr int kRowPad = 8;        // bf16 pad per shared row (bank conflicts)
constexpr int kNT = 4;            // n-tiles of 8 rows a warp: 32 batch rows
constexpr int kPlanError = -1;    // the plan does not match the shape
constexpr int kNoCluster = -2;    // no cluster of this plan fits the card

enum class KnockOut { kNone = 0, kNoGate = 1, kNoMm = 2, kNoDma = 3 };

__device__ __forceinline__ float ex2_approx(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ float rcp_approx(float v) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// 1 + 2^(-v log2 e), the denominator of sigmoid(v); v is clamped at -20
// so that a product of four stays finite (e^80 < 3.4e38), which moves
// sigmoid by at most sigmoid(-20) = 2.1e-9
__device__ __forceinline__ float sigmoid_den(float v) {
  return 1.0f + ex2_approx(-1.4426950408889634f * fmaxf(v, -20.0f));
}

// sigmoid of four values for one reciprocal: 1/a = b c d / (a b c d)
__device__ __forceinline__ void sigmoid4(float (&v)[4]) {
  const float a = sigmoid_den(v[0]), b = sigmoid_den(v[1]);
  const float c = sigmoid_den(v[2]), d = sigmoid_den(v[3]);
  const float ab = a * b, cd = c * d;
  const float r = rcp_approx(ab * cd);
  const float r_ab = r * cd, r_cd = r * ab;  // 1/(ab), 1/(cd)
  v[0] = b * r_ab;
  v[1] = a * r_ab;
  v[2] = d * r_cd;
  v[3] = c * r_cd;
}

// tanh of two values, 2 sigmoid(2x) - 1, for one reciprocal; x is clamped
// at -20 (tanh(-20) = -1 + 8.5e-18) so that the product stays finite
__device__ __forceinline__ void tanh2(float& u, float& v) {
  const float a = 1.0f + ex2_approx(-2.8853900817779268f * fmaxf(u, -20.0f));
  const float b = 1.0f + ex2_approx(-2.8853900817779268f * fmaxf(v, -20.0f));
  const float r = rcp_approx(a * b);
  u = fmaf(2.0f, b * r, -1.0f);
  v = fmaf(2.0f, a * r, -1.0f);
}

template <typename OutT>
__device__ __forceinline__ OutT to_out(float v);
template <>
__device__ __forceinline__ float to_out<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 to_out<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint4& a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 16 or 4 bytes; an invalid source reads nothing and fills
// zeros (src-size 0), src must still be a mapped address
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// the cluster barrier in two halves: arrive publishes this thread's
// earlier writes (shared memory of any CTA of the cluster), wait returns
// once every thread of the cluster has arrived and sees their writes
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// B fragments of two n-tiles (8 batch rows each, k contiguous in shared
// memory): thread t gives the address of row t % 8 of matrix t / 8, where
// matrices 0, 1 are the first n-tile's k 0-7 and 8-15 and 2, 3 the
// second's; b[0], b[1] are then the first tile's b0, b1, b[2], b[3] the
// second's
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&b)[4],
                                            const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(smem_u32(p)));
}

// this thread's ldmatrix_x4 row: (row in the pair of n-tiles, k offset)
__device__ __forceinline__ int ldmatrix_offset(int lane, int ld) {
  return ((lane >> 4) * 8 + (lane & 7)) * ld + ((lane >> 3) & 1) * 8;
}

// One LSTM cell update on a thread's accumulator fragments. acc[g][nt][e]
// holds gate g of unit j_lo (e < 2) or j_lo + 8 (e >= 2) for batch row
// nt * 8 + 2 tig + (e & 1) of the warp's 32 rows; h[nt][e] receives h_t.
// With kRegOut it writes the output of rows below n from the registers.
// 6.5 SFU operations a cell: five ex2, one rcp for the four gates, half an
// rcp for tanh(c) (two cells share it); none under KnockOut::kNoGate.
template <bool kCenter, bool kRegOut, typename OutT,
          KnockOut kKnock = KnockOut::kNone>
__device__ __forceinline__ void cell_update(
    float (&acc)[4][kNT][4], float (&c)[kNT][4], float (&h)[kNT][4],
    OutT* __restrict__ out, int n, int n_row0, int seq_len, int t,
    int out_col_lo, int hidden, int tig) {
  const int center = seq_len / 2;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    float og[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (kKnock == KnockOut::kNoGate) {
        c[nt][e] = 0.5f * c[nt][e] + 0.25f * (acc[0][nt][e] + acc[1][nt][e]);
        h[nt][e] = 0.5f * c[nt][e] + 0.125f * (acc[2][nt][e] + acc[3][nt][e]);
      } else {
        float g4[4] = {acc[0][nt][e], acc[1][nt][e], acc[3][nt][e],
                       2.0f * acc[2][nt][e]};
        sigmoid4(g4);  // sigmoid(i), sigmoid(f), sigmoid(o), sigmoid(2g)
        c[nt][e] = g4[1] * c[nt][e] + g4[0] * fmaf(2.0f, g4[3], -1.0f);
        og[e] = g4[2];
        h[nt][e] = c[nt][e];
      }
    }
    if constexpr (kKnock != KnockOut::kNoGate) {
      tanh2(h[nt][0], h[nt][1]);
      tanh2(h[nt][2], h[nt][3]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (kKnock != KnockOut::kNoGate) h[nt][e] *= og[e];
      const int row = n_row0 + nt * 8 + 2 * tig + (e & 1);
      const int col = out_col_lo + (e < 2 ? 0 : 8);
      if (kRegOut && row < n) {
        if (!kCenter)
          out[((size_t)row * seq_len + t) * 2 * hidden + col] =
              to_out<OutT>(h[nt][e]);
        else if (t == center)
          out[(size_t)row * 2 * hidden + col] = to_out<OutT>(h[nt][e]);
      }
    }
  }
}

constexpr int kGroupRows = 64;  // rows of a group that steps on its own

// bar.sync on named barrier `id` (1..15; __syncthreads takes 0) for
// `count` threads, a multiple of 32
__device__ __forceinline__ void group_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// A direction's packed layer weights [4H/16 m-tiles (gate g, unit group
// u at g H/16 + u), Kp/16 k-tiles, 32 lanes] uint4 (ops/bilstm.py
// pack_weights) into shared memory by cp.async, each unit group's tiles
// k-tile by k-tile with its four gates side by side: tile (u, kt, g) at
// ((u Kp/16 + kt) 4 + g) 32 (the caller commits the group)
__device__ __forceinline__ void cp_async_layer_weights(
    uint4* dst, const uint4* __restrict__ src, int hidden, int d_x) {
  const int h_tiles = hidden / 16;
  const int k_tiles = ((d_x + 15) / 16 * 16 + hidden) / 16;
  const int count = 4 * h_tiles * k_tiles * 32;
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const int tile = i >> 5;
    const int g = tile & 3;
    const int rest = tile >> 2;
    const int u = rest / k_tiles;
    const int kt = rest - u * k_tiles;
    cp_async16(dst + i,
               src + (((size_t)(g * h_tiles + u) * k_tiles + kt) << 5) +
                   (i & 31),
               true);
  }
}

// acc[g][nt] += A(gate g, k-tiles [ka, ka + count)) . B(the warp's 32 rows,
// k-tiles [0, count) of the shared tile at b), the A tiles laid out by
// cp_async_layer_weights (w: the lane's piece of its unit group's first
// tile). Per k-tile the B fragments of the 32 rows come first, then each
// gate's A tile in turn, so that one gate's A fragment is live at a time.
// kUnroll k-tiles are unrolled: more loads in flight, more registers.
template <int kUnroll>
__device__ __forceinline__ void mma_gates(float (&acc)[4][kNT][4],
                                          const uint4* w, int ka,
                                          const __nv_bfloat16* b, int ld,
                                          int count) {
#pragma unroll kUnroll
  for (int kt = 0; kt < count; ++kt) {
    uint32_t bf[kNT / 2][4];
#pragma unroll
    for (int p = 0; p < kNT / 2; ++p)
      ldmatrix_x4(bf[p], b + p * 16 * ld + kt * 16);
    const uint4* wk = w + (ka + kt) * 4 * 32;
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const uint4 a = wk[g * 32];
#pragma unroll
      for (int p = 0; p < kNT / 2; ++p) {
        mma_bf16(acc[g][2 * p], a, bf[p][0], bf[p][1]);
        mma_bf16(acc[g][2 * p + 1], a, bf[p][2], bf[p][3]);
      }
    }
  }
}

// zero count 16-byte pieces of shared memory, spread over the block
__device__ __forceinline__ void zero_smem(__nv_bfloat16* p, int count) {
  for (int i = threadIdx.x; i < count; i += blockDim.x)
    reinterpret_cast<uint4*>(p)[i] = make_uint4(0, 0, 0, 0);
}

// shared memory of a fused layer block (bilstm.cu's kernels and the
// probe's): the direction's weights 4H Kp, x [2][bn][Dp + 8], h [2][bn][H +
// 8], all bf16
inline int fused_smem(int d_x, int hidden, int bn) {
  const int d_pad = (d_x + 15) / 16 * 16;
  return 4 * hidden * (d_pad + hidden) * 2 +
         2 * bn * (d_pad + kRowPad) * 2 + 2 * bn * (hidden + kRowPad) * 2;
}

// whether a fused layer plan (ops/bilstm.py plan_layer) matches the shape:
// d_x even, (H/16) (bn/32) warps, at most 16, the block's shared memory
inline bool fused_plan_ok(int n, int seq_len, int d_x, int hidden, int bn,
                          int smem, int grid_x) {
  return n > 0 && seq_len > 0 && d_x > 0 && d_x % 2 == 0 && hidden > 0 &&
         hidden % 16 == 0 && bn > 0 && bn % 32 == 0 &&
         hidden / 16 * (bn / 32) <= 16 &&
         smem == fused_smem(d_x, hidden, bn) && smem <= kSmemMax &&
         grid_x == (n + bn - 1) / bn;
}

// One direction of a fused layer on a tile of `bn` batch rows from n0.
//
// x     [n, seq_len, d_x] bf16, d_x even
// s_w   the direction's packed weights in shared memory as
//       cp_async_layer_weights lays them out (Kp = Dp + H, Dp = d_x padded
//       to 16); the caller issues that copy and commits it, the first step
//       waits for it
// bias  the direction's [4H] f32
// out   kRegOut: written from the registers, kCenter ? [n, 2H] f32 (h at
//       t = L//2) : [n, seq_len, 2H] OutT, this direction's half of 2H
// s_x   [2][bn][Dp + 8] bf16 and s_h [2][bn][H + 8] bf16, zeroed here (the
//       D padding stays zero, h_{-1} = 0)
// Warps (H/16) x (bn/32): warp w owns units (w % (H/16)) * 16 ... (all
// four gates) for batch rows (w / (H/16)) * 32 ... of the tile. The tile's
// rows step in groups of up to 64 (kGroupRows), each group on its own
// named barrier, so two groups of one block overlap as two blocks would
// while sharing one copy of the weights. x_{t+1} comes by cp.async into
// the other x buffer while step t computes, and h is double buffered, so a
// step has one barrier. A bf16 stream output is copied from the shared h
// tile in 16-byte rows during the next step. Returns the steps run; the
// last step's bf16 h is then in s_h + (steps & 1) bn (H + 8), whole once
// the block has passed a barrier. kKnock removes a part of the step (the
// knock-outs above).
template <bool kCenter, bool kRegOut, typename OutT, int kUnroll,
          KnockOut kKnock = KnockOut::kNone>
__device__ __forceinline__ int fused_layer(
    const __nv_bfloat16* __restrict__ x, const uint4* s_w,
    const float* __restrict__ bias, OutT* __restrict__ out,
    __nv_bfloat16* s_x, __nv_bfloat16* s_h, int n, int seq_len, int d_x,
    int hidden, int bn, int dir, int n0) {
  // the x product's unroll: kUnroll, but one k-tile deep under
  // KnockOut::kNoMm, where it is the step's only product and four deep
  // spills (228 B a thread, ptxas) as one deep does not
  constexpr int kXUnroll = kKnock == KnockOut::kNoMm ? 1 : kUnroll;
  const int d_pad = (d_x + 15) / 16 * 16;
  const int dp_tiles = d_pad / 16;
  const int h_tiles = hidden / 16;
  const int k_tiles = dp_tiles + h_tiles;
  const int ldx = d_pad + kRowPad;
  const int ldh = hidden + kRowPad;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int grp = lane >> 2;
  const int tig = lane & 3;
  const int ug = warp % h_tiles;  // unit group of 16
  const int wn = warp / h_tiles;  // 32-row part of the tile
  // row groups of up to 64 rows step on their own, each with its barrier
  const int g_rows = bn < kGroupRows ? bn : kGroupRows;
  const int g_threads = h_tiles * g_rows;  // (H/16) x (g_rows/32) warps
  const int g_id = wn * 32 / g_rows;
  const int g_tid = tid - g_id * g_threads;
  const int g_row0 = g_id * g_rows;

  zero_smem(s_x, 2 * bn * ldx / 8);
  zero_smem(s_h, 2 * bn * ldh / 8);

  const int center = seq_len / 2;
  const int steps =
      kCenter ? (dir == 0 ? center + 1 : seq_len - center) : seq_len;
  const bool vec16 = d_x % 8 == 0;
  const int chunk = vec16 ? 8 : 2;  // bf16 a copy
  const int per_row = d_x / chunk;

  auto fetch_x = [&](int s, int buf) {
    const int t = dir == 0 ? s : seq_len - 1 - s;
    __nv_bfloat16* dst = s_x + buf * bn * ldx;
    for (int i = g_tid; i < g_rows * per_row; i += g_threads) {
      const int r = g_row0 + i / per_row;
      const int k = (i % per_row) * chunk;
      const int row = n0 + r;
      const bool ok = row < n;
      const __nv_bfloat16* src =
          x + ((size_t)(ok ? row : 0) * seq_len + t) * d_x + k;
      if (vec16)
        cp_async16(dst + r * ldx + k, src, ok);
      else
        cp_async4(dst + r * ldx + k, src, ok);
    }
    cp_async_commit();
  };

  const int j_lo = ug * 16 + grp;
  float b_lo[4], b_hi[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    b_lo[g] = bias[g * hidden + j_lo];
    b_hi[g] = bias[g * hidden + j_lo + 8];
  }
  const uint4* w_ug = s_w + (size_t)ug * k_tiles * 4 * 32 + lane;
  const int x_row = wn * 32 * ldx + ldmatrix_offset(lane, ldx);
  const int h_row = wn * 32 * ldh + ldmatrix_offset(lane, ldh);

  float c[kNT][4];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[nt][e] = 0.0f;

  cp_async_wait<0>();  // this thread's copies of the weights
  __syncthreads();  // all the weights in; zeros before x copies land on them
  fetch_x(0, 0);

  // a bf16 stream output leaves from the shared h tile as 16-byte rows, a
  // step late (no output address is held in registers over the loop); f32
  // and center outputs from the registers
  constexpr bool kSmemOut =
      kRegOut && !kCenter && std::is_same<OutT, __nv_bfloat16>::value;
  auto store_h = [&](int s) {  // h of step s, in s_h[(s + 1) & 1], to out
    const int t = dir == 0 ? s : seq_len - 1 - s;
    const __nv_bfloat16* src = s_h + ((s + 1) & 1) * bn * ldh;
    const int per = hidden / 8;
    for (int i = g_tid; i < g_rows * per; i += g_threads) {
      const int r = g_row0 + i / per;
      const int k = (i % per) * 8;
      if (n0 + r < n)
        *reinterpret_cast<uint4*>(
            out + ((size_t)(n0 + r) * seq_len + t) * 2 * hidden +
            dir * hidden + k) =
            *reinterpret_cast<const uint4*>(src + r * ldh + k);
    }
  };

  // one step; `emit` (std::true_type or std::false_type) says whether it
  // writes the output
  auto step = [&](int s, auto emit) {
    const int t = dir == 0 ? s : seq_len - 1 - s;
    cp_async_wait<0>();  // this thread's copies of x_t
    // the group's copies visible; its h_{t-1} written; its reads of step
    // s-1 done
    group_sync(1 + g_id, g_threads);
    if constexpr (kKnock != KnockOut::kNoDma) {
      if (s + 1 < steps) fetch_x(s + 1, (s + 1) & 1);
    }
    if constexpr (kSmemOut) {
      if (s > 0) store_h(s - 1);  // its buffer is read-only in this step
    }

    float acc[4][kNT][4];
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        acc[g][nt][0] = b_lo[g];
        acc[g][nt][1] = b_lo[g];
        acc[g][nt][2] = b_hi[g];
        acc[g][nt][3] = b_hi[g];
      }
    mma_gates<kXUnroll>(acc, w_ug, 0,
                        s_x + (kKnock == KnockOut::kNoDma ? 0 : s & 1) * bn *
                                  ldx + x_row,
                        ldx, dp_tiles);
    if constexpr (kKnock != KnockOut::kNoMm)
      mma_gates<kUnroll>(acc, w_ug, dp_tiles,
                         s_h + (s & 1) * bn * ldh + h_row, ldh, h_tiles);
    float h[kNT][4];
    cell_update<kCenter, kRegOut && !kSmemOut && decltype(emit)::value,
                OutT, kKnock>(
        acc, c, h, out, n, n0 + wn * 32, seq_len, t, dir * hidden + j_lo,
        hidden, tig);
    __nv_bfloat16* h_next = s_h + ((s + 1) & 1) * bn * ldh;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        h_next[(wn * 32 + nt * 8 + 2 * tig + (e & 1)) * ldh + j_lo +
               (e < 2 ? 0 : 8)] = __float2bfloat16_rn(h[nt][e]);
  };

  if constexpr (kCenter) {
    // only the last step (t = L//2) writes: the output's addresses are
    // made there, not kept in registers over the loop
    for (int s = 0; s + 1 < steps; ++s) step(s, std::false_type());
    step(steps - 1, std::true_type());
  } else {
    for (int s = 0; s < steps; ++s) step(s, std::true_type());
  }
  if constexpr (kSmemOut) {
    __syncthreads();
    store_h(steps - 1);
  }
  return steps;
}

}  // namespace
