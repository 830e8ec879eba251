// LSTM recurrence over precomputed input projections, both directions, for
// Hopper (sm_90a): the inference forward, and training's forward and
// backward. Plain C interface, loaded with ctypes.
//
// Replaces the Pallas TPU kernels of nanosnp_tpu/ops/pallas_lstm.py behind
// the custom VJP `_recurrence` (its primal, and the differentiable
// recurrence of training):
//   nsp_lstm_infer_smem, nsp_lstm_infer_cluster, nsp_lstm_infer
//                 <- _kernel       (no gradient wanted: streams h_t only,
//                                    xp f32 or bf16)
//   nsp_lstm_infer_f32
//                 <- no Pallas kernel: the lax.scan route in f32 (f32 w_hh,
//                    nothing rounded; its design is at its kernel, below)
//   nsp_lstm_fwd_smem, nsp_lstm_fwd_cluster, nsp_lstm_fwd
//                 <- _train_kernel  (forward; streams h_t and c_t)
//   nsp_lstm_bwd_smem, nsp_lstm_bwd_cluster, nsp_lstm_bwd
//                 <- _bwd_kernel    (reverse-time sweep: gates recomputed,
//                                    dxp streamed, dh/dc carried; the smem
//                                    one sums dW too)
//   nsp_lstm_dw   <- the dW accumulation of _bwd_kernel (its VMEM sum over
//                    batch tiles, then the wrapper's sum over tiles):
//                    dW[d] = sum_{t,n} h_{t-1}[d, n, :]^T dxp[t, d, n, :],
//                    on the tensor cores (split bf16, three products) over
//                    a fixed split of the rows, the splits added in order
//
// Layouts (true time order; direction 1 walks time backwards inside the
// kernels, so no reversed copies are made):
//   xp, dxp [n, L, 2, 4H] f32   input projections x W_ih + b / their grads
//   hs, cs  [n, L, 2, H]  f32   h_t and c_t, direction d at [..., d, :]
//   g       [n, L, 2, H]  f32   gradient of the loss with respect to hs
// (the inference kernels also take xp in bf16 and widen it to f32)
//   dW      [2, H, 4H]    bf16  gradient of w_hh (x @ w layout)
// Gate order i, f, g, o. h and c start at zero.
//
// Cast sites (those of the Pallas path): w_hh bf16; xp f32; h_{t-1} rounded
// to bf16 before W.h with f32 accumulation; gate and cell math f32; hs, cs
// f32. Backward: gates recomputed from xp + W.bf16(h_{t-1}); dgates f32;
// dh_{t-1} = W^T.bf16(dgates) with f32 accumulation; dc <- dc.f;
// dW += dgates (x) h_{t-1} in f32 with f32 h_{t-1} (on the smem path as
// three bf16 products of the split operands, below, in the sweep on the
// smem path and in nsp_lstm_dw elsewhere), rounded to bf16 once, after the
// whole sum.
//
// What bounds them on this card. Each step is a [4H, H] x [H, BN] product
// (the backward adds a [H, 4H] x [4H, BN] one) that depends on the step
// before, L steps in a row. The f32 streams (xp in, hs and cs out; in the
// backward xp, hs, cs, g in and dxp out) are the least traffic, and at the
// training batch sizes they, not the operations, give the bound; so too
// for the inference kernels, which move xp in and hs out and nothing else.
// Training takes one of three designs, picked per call by the wrapper's
// plan (ops/lstm_train.plan_train), which the launchers check; inference
// the smem forward at H=64, the cluster forward at H=256 and the packed one
// elsewhere (ops/lstm_train.plan_infer):
//
// 1. smem (nsp_lstm_fwd_smem, nsp_lstm_bwd_smem), H=64, the pileup model
//    (the kernels are templates on H, built for 64): one block per
//    (direction, 32 batch rows), so N=2000 is 126 blocks, one wave;
//    2 x H/16 warps, warp w owning 16 hidden units with
//    all four gate rows (the cell runs on the mma accumulator registers,
//    and the dh product's output lands on them) for 16 of the rows.
//    - w_hh [H, 4H] bf16 is copied into shared memory once a block, as the
//      model holds it, rows padded for conflict-free ldmatrix: .trans gives
//      w_hh^T's A fragments for the gates, the plain form w_hh's for dh, so
//      the wrapper packs nothing. The forward keeps its A fragments in
//      registers.
//    - The next step's inputs arrive by cp.async while this step computes,
//      double buffered: the forward's xp, the sweep's xp, g, h_{t-1} and
//      c_{t-1} (c_t is the c_{t-1} a thread read the step before). The
//      forward's bf16 h is double buffered too: one barrier a step. The
//      sweep has two, since its dgates are exchanged within the step.
//    - Gate math on the SFU (sigmoid4, tanh2: bilstm.cu's formulas and
//      bound); the sweep forms the derivatives from those values.
//    - The sweep rounds f32 h_{t-1} to bf16 as it builds the gates' B
//      fragments from shared memory. The cell writes dgates there as bf16
//      hi (their rounding, the dh product's B by ldmatrix) and lo (what hi
//      leaves); dW reads both by transposed ldmatrix.
//    - dW: each block sums h_{t-1}^T dgates over its rows and every step on
//      the tensor cores, each f32 operand split into bf16 hi + lo, three
//      products (hi hi, hi lo, lo hi) with f32 accumulation: within about
//      2^-15 of each f32 product, against the 2^-8 of the bf16 dW returned.
//      It writes its partial once; a second small launch sums the partials
//      in tile order and rounds to bf16. Nothing is read back for dW, and
//      there are no atomics: the gradient is the same on every run.
//    - Inference (nsp_lstm_infer_smem) is the forward kernel without the
//      c_t stream: one template. A bf16 xp is staged by cp.async as bf16
//      ([2][32][4H + 8], 16-byte pieces of 8 values, half the f32 bytes)
//      and widened once, as each value is read from shared memory into the
//      accumulators. Its block takes 109,568 B of shared memory with f32
//      xp and 76,800 B with bf16 (three such blocks and their 1 KiB each
//      fill an SM's 233,472 B); registers may hold either to 2 blocks an
//      SM (the forward keeps 64 A-fragment registers a thread).
// 2. cluster (nsp_lstm_fwd_cluster, nsp_lstm_bwd_cluster, and
//    nsp_lstm_dw), H=256, the haplotype model, whose w_hh (512 KiB a
//    direction) fits no SM: a thread-block cluster of 4 CTAs per
//    (direction, 64 batch rows), as bilstm.cu's recurrence; N=512 is 16
//    clusters, one round of the 30 resident. CTA r holds the w_hh columns
//    of its 64 units, all four gates (128 KiB), in shared memory for the
//    whole call, copied from the model's layout (nothing packed); one copy
//    serves both of the sweep's products as on the smem path.
//    - Forward: xp of the thread's fragments read into registers a step
//      ahead; each CTA's slice of bf16 h_t goes to every peer through
//      distributed shared memory (two buffers by step parity, one cluster
//      barrier a step).
//    - Sweep: every CTA stages the whole bf16 h_{t-1} row from hs (no
//      exchange) and forms dgates for its own gate columns K_r; its dh
//      partial w_hh[:, K_r] . bf16(dgates_{K_r}) covers every unit, and is
//      reduce-scattered through distributed shared memory: each CTA adds
//      the four partials of its units in rank order, so dh is the same bits
//      on every run. The shared tile of h_{t-1} takes dgates once the gate
//      product has read it (the w slice and the partials' slots leave no
//      room for two).
//    - dW is nsp_lstm_dw's, as on the packed path.
//    - Inference (nsp_lstm_infer_cluster) is the forward kernel without the
//      c_t stream, xp f32 or bf16 widened on load: one template.
//    Bound: L dependent steps, each a chain of latencies (cluster barriers,
//    shared-memory products, the DSMEM exchange) plus the step's own
//    device-memory streams, which at the trainer's batch only 64 SMs pull:
//    the sweep's xp, g, c_{t-1} and h_{t-1} in and dxp out, about 224 KiB
//    a CTA a step (ops/step_stamps.py splits a step into its phases).
// 3. packed (nsp_lstm_fwd, nsp_lstm_bwd, nsp_lstm_dw), any other H: w_hh^T
//    re-read from L2 every step:
//    - one block per (direction, 32 or 16 batch rows), one warp per 16
//      hidden units with all four gate rows;
//    - mma.sync.m16n8k16 (bf16 in, f32 accumulate) with A packed by the
//      wrapper in fragment order on every call (one coalesced 512-byte load
//      per warp and tile): w_hh^T for the gates, w_hh for dh;
//    - bf16 h_{t-1} (and in the backward bf16 dgates) in shared memory as
//      the B operand; xp, g, hs, cs read straight into registers;
//    - dW is nsp_lstm_dw's, as on the cluster path.
// dW (nsp_lstm_dw, every H but the smem path's): the tensor cores, each f32
// operand split into bf16 hi + lo on its way into shared memory, three
// products; a fixed split of the N (L-1) rows, one CTA per (output tile,
// split, direction), and a second small launch that adds the splits in
// order. Bound: its bytes, both f32 operands read once (0.052 ms at the
// haplotype trainer's N=512, L=33, at an H100 SXM's published 3.35 TB/s,
// 700 W; the three products take 0.017 ms at its 989 TFLOP/s).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxWarps = 16;  // H <= 256
constexpr int kRowPad = 8;     // bf16 pad per shared row (bank conflicts)
constexpr int kFwdNT = 4;      // forward: n-tiles of 8 batch rows per block
constexpr int kBwdNT = 2;      // backward: fewer, for registers

__device__ __forceinline__ float sigmoid_f32(float v) {
  return 1.0f / (1.0f + expf(-v));
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

// Accumulator element e of n-tile nt of this thread: batch row in the
// tile, and whether it is the upper hidden unit (j_hi) of the pair.
__device__ __forceinline__ int frag_row(int nt, int tig, int e) {
  return nt * 8 + 2 * tig + (e & 1);
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// gates[g][nt][e] = xp[row, t, dir, g*H + j] (zero past n), then
// += w_hh^T . bf16(h_{t-1}) from shared memory.

template <int kNT, typename XpT>
__device__ __forceinline__ void gate_preacts(
    float (&acc)[4][kNT][4], const XpT* __restrict__ xp,
    const uint4* const (&wg)[4], const __nv_bfloat16* s_h, int ld, int n,
    int n0, int seq_len, int t, int dir, int hidden, int j_lo, int grp,
    int tig) {
  const int k_tiles = hidden / 16;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = n0 + frag_row(nt, tig, e);
      const int j = e < 2 ? j_lo : j_lo + 8;
      const XpT* p =
          xp + (((size_t)row * seq_len + t) * 2 + dir) * 4 * hidden + j;
#pragma unroll
      for (int g = 0; g < 4; ++g)
        acc[g][nt][e] = row < n ? widen(p[g * hidden]) : 0.0f;
    }
  for (int kt = 0; kt < k_tiles; ++kt) {
    uint4 a[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) a[g] = __ldg(wg[g] + kt * 32);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const __nv_bfloat16* bp = s_h + (nt * 8 + grp) * ld + kt * 16 + 2 * tig;
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(bp);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(bp + 8);
#pragma unroll
      for (int g = 0; g < 4; ++g) mma_bf16(acc[g][nt], a[g], b0, b1);
    }
  }
}

// The forward recurrence. kTrain streams c_t beside h_t (the backward
// sweep reads it); inference (kTrain false) streams h_t only and takes xp
// in f32 or bf16.
// xp [n, L, 2, 4H]; wpk [2, 4H/16, H/16, 32, 8] bf16 (w_hh^T fragments)
// hs, cs [n, L, 2, H] f32. block = H/16 warps, grid = (ceil(n/BN), 2).
template <bool kTrain, typename XpT>
__global__ void __launch_bounds__(kMaxWarps * 32)
lstm_fwd_kernel(const XpT* __restrict__ xp, const uint4* __restrict__ wpk,
                float* __restrict__ hs, float* __restrict__ cs, int n,
                int seq_len, int hidden) {
  constexpr int kNT = kFwdNT;
  constexpr int kBN = 8 * kNT;
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* s_h = reinterpret_cast<__nv_bfloat16*>(smem_u4);
  const int ld = hidden + kRowPad;
  const int k_tiles = hidden / 16;
  const int m_tiles_gate = hidden / 16;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grp = lane >> 2;
  const int tig = lane & 3;
  const int dir = blockIdx.y;
  const int n0 = blockIdx.x * kBN;

  for (int i = threadIdx.x; i < kBN * ld; i += blockDim.x)
    s_h[i] = __float2bfloat16_rn(0.0f);  // h_{-1} = 0

  const int j_lo = warp * 16 + grp;
  const uint4* wg[4];
#pragma unroll
  for (int g = 0; g < 4; ++g)
    wg[g] = wpk + ((size_t)(dir * 4 + g) * m_tiles_gate + warp) * k_tiles * 32
            + lane;

  float c[kNT][4];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[nt][e] = 0.0f;
  __syncthreads();

  for (int s = 0; s < seq_len; ++s) {
    const int t = dir == 0 ? s : seq_len - 1 - s;
    float acc[4][kNT][4];
    gate_preacts<kNT>(acc, xp, wg, s_h, ld, n, n0, seq_len, t, dir, hidden,
                      j_lo, grp, tig);
    __syncthreads();  // every read of h_{t-1} is done before it changes

#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float ig = sigmoid_f32(acc[0][nt][e]);
        const float fg = sigmoid_f32(acc[1][nt][e]);
        const float gg = tanhf(acc[2][nt][e]);
        const float og = sigmoid_f32(acc[3][nt][e]);
        c[nt][e] = fg * c[nt][e] + ig * gg;
        const float h = og * tanhf(c[nt][e]);
        const int r = frag_row(nt, tig, e);
        const int j = e < 2 ? j_lo : j_lo + 8;
        s_h[r * ld + j] = __float2bfloat16_rn(h);
        const int row = n0 + r;
        if (row < n) {
          const size_t o = (((size_t)row * seq_len + t) * 2 + dir) * hidden + j;
          hs[o] = h;
          if (kTrain) cs[o] = c[nt][e];
        }
      }
    __syncthreads();  // h_t is in shared memory before the next product
  }
}

// Reverse-time sweep. wpk_t: w_hh^T fragments as in the forward; wpk_h:
// w_hh [2, H, 4H] as fragments [2, H/16, 4H/16, 32, 8]. g [n, L, 2, H];
// dxp [n, L, 2, 4H]. block = H/16 warps, grid = (ceil(n/BN), 2).
__global__ void __launch_bounds__(kMaxWarps * 32)
lstm_bwd_kernel(const float* __restrict__ xp, const uint4* __restrict__ wpk_t,
                const uint4* __restrict__ wpk_h, const float* __restrict__ hs,
                const float* __restrict__ cs, const float* __restrict__ g,
                float* __restrict__ dxp, int n, int seq_len, int hidden) {
  constexpr int kNT = kBwdNT;
  constexpr int kBN = 8 * kNT;
  extern __shared__ uint4 smem_u4[];
  const int ld_h = hidden + kRowPad;
  const int ld_d = 4 * hidden + kRowPad;
  __nv_bfloat16* s_h = reinterpret_cast<__nv_bfloat16*>(smem_u4);
  __nv_bfloat16* s_d = s_h + kBN * ld_h;   // ld_h * 2 bytes is 16-aligned
  const int k_tiles_h = hidden / 16;
  const int k_tiles_d = 4 * hidden / 16;
  const int m_tiles_gate = hidden / 16;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grp = lane >> 2;
  const int tig = lane & 3;
  const int dir = blockIdx.y;
  const int n0 = blockIdx.x * kBN;
  const int j_lo = warp * 16 + grp;

  const uint4* wg[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    wg[q] = wpk_t + ((size_t)(dir * 4 + q) * m_tiles_gate + warp) * k_tiles_h
            * 32 + lane;
  const uint4* wd =
      wpk_h + ((size_t)dir * m_tiles_gate + warp) * k_tiles_d * 32 + lane;

  float dh[kNT][4], dc[kNT][4];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dh[nt][e] = 0.0f;
      dc[nt][e] = 0.0f;
    }

  for (int s = seq_len - 1; s >= 0; --s) {
    const int t = dir == 0 ? s : seq_len - 1 - s;
    const int tp = dir == 0 ? t - 1 : t + 1;  // the step before, if s > 0
    // stage bf16(h_{t-1}); rows past n and the first step read zero
    for (int i = threadIdx.x; i < kBN * hidden; i += blockDim.x) {
      const int r = i / hidden;
      const int j = i - r * hidden;
      const int row = n0 + r;
      const float v =
          (s > 0 && row < n)
              ? hs[(((size_t)row * seq_len + tp) * 2 + dir) * hidden + j]
              : 0.0f;
      s_h[r * ld_h + j] = __float2bfloat16_rn(v);
    }
    __syncthreads();

    float acc[4][kNT][4];
    gate_preacts<kNT>(acc, xp, wg, s_h, ld_h, n, n0, seq_len, t, dir,
                      hidden, j_lo, grp, tig);

#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = frag_row(nt, tig, e);
        const int row = n0 + r;
        const int j = e < 2 ? j_lo : j_lo + 8;
        const bool valid = row < n;
        const size_t o_t =
            (((size_t)row * seq_len + t) * 2 + dir) * hidden + j;
        const size_t o_p =
            (((size_t)row * seq_len + tp) * 2 + dir) * hidden + j;
        const float c_t = valid ? cs[o_t] : 0.0f;
        const float c_prev = (valid && s > 0) ? cs[o_p] : 0.0f;
        const float g_out = valid ? g[o_t] : 0.0f;
        const float ig = sigmoid_f32(acc[0][nt][e]);
        const float fg = sigmoid_f32(acc[1][nt][e]);
        const float gg = tanhf(acc[2][nt][e]);
        const float og = sigmoid_f32(acc[3][nt][e]);
        const float tanh_ct = tanhf(c_t);
        const float dhv = g_out + dh[nt][e];
        const float dcv = dhv * og * (1.0f - tanh_ct * tanh_ct) + dc[nt][e];
        float dgate[4];
        dgate[0] = dcv * gg * ig * (1.0f - ig);
        dgate[1] = dcv * c_prev * fg * (1.0f - fg);
        dgate[2] = dcv * ig * (1.0f - gg * gg);
        dgate[3] = dhv * tanh_ct * og * (1.0f - og);
        dc[nt][e] = dcv * fg;
        float* dst =
            dxp + (((size_t)row * seq_len + t) * 2 + dir) * 4 * hidden + j;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          s_d[r * ld_d + q * hidden + j] = __float2bfloat16_rn(dgate[q]);
          if (valid) dst[q * hidden] = dgate[q];
        }
      }
    __syncthreads();  // all of bf16(dgates) is staged

    // dh_{t-1}[j, :] = sum_k w_hh[j, k] bf16(dgates)[k, :]
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dh[nt][e] = 0.0f;
    for (int kt = 0; kt < k_tiles_d; ++kt) {
      const uint4 a = __ldg(wd + kt * 32);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const __nv_bfloat16* bp =
            s_d + (nt * 8 + grp) * ld_d + kt * 16 + 2 * tig;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(bp);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(bp + 8);
        mma_bf16(dh[nt], a, b0, b1);
      }
    }
    // No barrier here: the next step writes s_h, which nobody reads any
    // more, and writes s_d only after its first barrier.
  }
}

// dW = bf16(sum over splits, in split order)
__global__ void lstm_dw_sum_kernel(const float* __restrict__ part,
                                   __nv_bfloat16* __restrict__ dw,
                                   int size, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= size) return;
  float s = 0.0f;
  for (int p = 0; p < splits; ++p) s += part[(size_t)p * size + i];
  dw[i] = __float2bfloat16_rn(s);
}

// ---------------------------------------------------------------------------
// The smem path (H=64, the pileup model): w_hh in shared memory

constexpr int kSmemMax = 232448;  // dynamic shared memory a block may use
constexpr int kPlanError = -1;    // the plan does not match the shape
constexpr int kTrainBN = 32;      // batch rows a block: two halves of 16
constexpr int kSmemHidden = 64;   // the H the smem kernels are built for
constexpr int kWPad = 8;          // bf16 pad of a w_hh row (ldmatrix)
constexpr int kXpPad = 4;         // f32 pad of an xp row (accumulator loads)
constexpr int kXpRowPad = 16;     // bytes of pad of a shared xp row, any dtype
constexpr int kHPad = 8;          // f32 pad of an h_{t-1} row (8-byte loads)
constexpr int kCPad = 4;          // f32 pad of a c_{t-1} or g row
constexpr int kDgPad = 8;         // bf16 pad of a dgates row (ldmatrix)

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

// Gate math on the SFU, as csrc/bilstm.cu states and bounds it (sigmoid
// within 1e-6, tanh within 2e-6 of the exact value; tests/
// test_torch_bilstm_plan.py): sigmoid of four values for one reciprocal,
// each clamped at -20 so the product of denominators stays finite
__device__ __forceinline__ float sigmoid_den(float v) {
  return 1.0f + ex2_approx(-1.4426950408889634f * fmaxf(v, -20.0f));
}

__device__ __forceinline__ void sigmoid4(float (&v)[4]) {
  const float a = sigmoid_den(v[0]), b = sigmoid_den(v[1]);
  const float c = sigmoid_den(v[2]), d = sigmoid_den(v[3]);
  const float ab = a * b, cd = c * d;
  const float r = rcp_approx(ab * cd);
  const float r_ab = r * cd, r_cd = r * ab;
  v[0] = b * r_ab;
  v[1] = a * r_ab;
  v[2] = d * r_cd;
  v[3] = c * r_cd;
}

// tanh of two values, 2 sigmoid(2x) - 1, for one reciprocal
__device__ __forceinline__ void tanh2(float& u, float& v) {
  const float a = 1.0f + ex2_approx(-2.8853900817779268f * fmaxf(u, -20.0f));
  const float b = 1.0f + ex2_approx(-2.8853900817779268f * fmaxf(v, -20.0f));
  const float r = rcp_approx(a * b);
  u = fmaf(2.0f, b * r, -1.0f);
  v = fmaf(2.0f, a * r, -1.0f);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 16 bytes; an invalid source reads nothing and fills zeros
// (src-size 0), src must still be a mapped address
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// four 8x8 bf16 matrices, thread t giving the address of row t % 8 of
// matrix t / 8; .trans hands each thread the transposed element pair
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

// shared-memory writes of the generic proxy visible to wgmma's reads (the
// async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// x, y as two bf16 pairs, hi = (x, y) rounded and lo = what hi leaves,
// rounded: hi + lo is within 2^-16 of each value, relatively
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// two f32 as the bf16 pair of an mma operand register (lower k first)
__device__ __forceinline__ uint32_t pack_bf16(float2 v) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(v.x, v.y);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// A fragments of w_hh^T (gate rows m0.., hidden units k0..) from w_hh
// [H][ldw] in shared memory, read transposed: lanes 0-7 give rows k0..k0+7
// at m0, lanes 8-15 the same rows at m0 + 8, lanes 16-31 rows k0 + 8..
__device__ __forceinline__ void a_wt(uint32_t (&a)[4], const __nv_bfloat16* w,
                                     int ldw, int m0, int k0, int lane) {
  ldmatrix_x4_trans(a, w + (k0 + (lane & 7) + (lane >> 4) * 8) * ldw + m0 +
                           ((lane >> 3) & 1) * 8);
}

// A fragments of w_hh (hidden units m0.., gate columns k0..), read as is
__device__ __forceinline__ void a_w(uint32_t (&a)[4], const __nv_bfloat16* w,
                                    int ldw, int m0, int k0, int lane) {
  ldmatrix_x4(a, w + (m0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ldw + k0 +
                     (lane >> 4) * 8);
}

// w_hh[dir] [H, 4H] bf16 into shared memory rows of ldw, as 16-byte pieces
template <int kH>
__device__ __forceinline__ void copy_w(__nv_bfloat16* s_w,
                                       const __nv_bfloat16* w, int tid,
                                       int threads) {
  constexpr int kPieces = 4 * kH / 8;  // a row
  for (int i = tid; i < kH * kPieces; i += threads) {
    const int r = i / kPieces, q = i - r * kPieces;
    cp_async16(s_w + r * (4 * kH + kWPad) + q * 8, w + (size_t)r * 4 * kH +
                                                       q * 8, true);
  }
}

// rows [n0, n0 + kTrainBN) of src [n, L, 2, width] (f32, or bf16 xp) at
// (t, dir) into shared rows of ld values, 16-byte pieces; rows past n (or
// every row, valid false) zero
template <int kWidth, typename T = float>
__device__ __forceinline__ void fetch_rows(T* dst, int ld, const T* src,
                                           int n, int n0, int seq_len, int t,
                                           int dir, bool valid, int tid,
                                           int threads) {
  constexpr int kPer = 16 / (int)sizeof(T);  // values a piece
  constexpr int kPieces = kWidth / kPer;
  for (int i = tid; i < kTrainBN * kPieces; i += threads) {
    const int r = i / kPieces, q = i - r * kPieces;
    const int row = n0 + r;
    const bool ok = valid && row < n;
    cp_async16(dst + r * ld + q * kPer,
               src + (((size_t)(ok ? row : 0) * seq_len + t) * 2 + dir) *
                         kWidth + q * kPer,
               ok);
  }
}

// Forward, training's (kTrain: hs and cs out, xp f32) and inference's (hs
// only, xp f32 or bf16). xp [n, L, 2, 4H]; w_hh [2, H, 4H] bf16 (x @ w
// layout, as the model holds it); hs, cs [n, L, 2, H] f32. grid
// (ceil(n/32), 2); block 2 x H/16 warps: warp w owns hidden units
// 16 (w % (H/16)).. with all four gates, for batch rows 16 (w / (H/16))..
// of the tile. Shared: w_hh [H][4H + 8] bf16, xp [2][32][4H + 16 bytes]
// in its own dtype (f32 rows of 4H + 4, bf16 rows of 4H + 8), bf16 h
// [2][32][H + 8]. A bf16 xp is staged as it is, half the bytes of f32,
// and each value widened once, as it is read into the accumulators.
template <int kH, bool kTrain, typename XpT>
__global__ void __launch_bounds__(kH / 16 * 64)
lstm_fwd_smem_kernel(const XpT* __restrict__ xp,
                     const __nv_bfloat16* __restrict__ w_hh,
                     float* __restrict__ hs, float* __restrict__ cs, int n,
                     int seq_len) {
  constexpr int kUG = kH / 16;  // unit groups, and k-tiles of the product
  constexpr int kThreads = kUG * 64;
  constexpr int ldw = 4 * kH + kWPad;
  constexpr int ldx = 4 * kH + kXpRowPad / (int)sizeof(XpT);
  constexpr int ldh = kH + kRowPad;
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* s_w = reinterpret_cast<__nv_bfloat16*>(smem_u4);
  XpT* s_x = reinterpret_cast<XpT*>(s_w + kH * ldw);
  __nv_bfloat16* s_h =
      reinterpret_cast<__nv_bfloat16*>(s_x + 2 * kTrainBN * ldx);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int grp = lane >> 2;
  const int tig = lane & 3;
  const int ug = warp % kUG;
  const int rw = (warp / kUG) * 16;  // the warp's first row in the tile
  const int dir = blockIdx.y;
  const int n0 = blockIdx.x * kTrainBN;
  auto time_of = [&](int s) { return dir == 0 ? s : seq_len - 1 - s; };

  copy_w<kH>(s_w, w_hh + (size_t)dir * kH * 4 * kH, tid, kThreads);
  fetch_rows<4 * kH>(s_x, ldx, xp, n, n0, seq_len, time_of(0), dir, true,
                     tid, kThreads);
  cp_async_commit();
  for (int i = tid; i < 2 * kTrainBN * ldh; i += kThreads)
    s_h[i] = __float2bfloat16_rn(0.0f);  // h_{-1} = 0
  cp_async_wait_all();
  __syncthreads();

  // w_hh^T's A fragments for the warp's gate rows, once, into registers
  uint32_t a[4][kUG][4];
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int kt = 0; kt < kUG; ++kt)
      a_wt(a[g][kt], s_w, ldw, g * kH + ug * 16, kt * 16, lane);
  // this thread's ldmatrix row of h: n-tiles 0 and 1 of the warp's rows
  const int h_row = (rw + (lane >> 4) * 8 + (lane & 7)) * ldh +
                    ((lane >> 3) & 1) * 8;

  float c[2][4];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[nt][e] = 0.0f;

  for (int s = 0; s < seq_len; ++s) {
    const int t = time_of(s);
    cp_async_wait_all();  // this thread's copies of xp_t
    // every copy visible; h_{t-1} written; every read of step s-1 done
    __syncthreads();
    if (s + 1 < seq_len) {
      fetch_rows<4 * kH>(s_x + ((s + 1) & 1) * kTrainBN * ldx, ldx, xp, n,
                         n0, seq_len, time_of(s + 1), dir, true, tid,
                         kThreads);
      cp_async_commit();
    }
    const XpT* xs = s_x + (s & 1) * kTrainBN * ldx;
    float acc[4][2][4];
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[g][nt][e] = widen(xs[(rw + nt * 8 + 2 * tig + (e & 1)) * ldx +
                                   g * kH + ug * 16 + grp + (e < 2 ? 0 : 8)]);
    const __nv_bfloat16* hb = s_h + (s & 1) * kTrainBN * ldh + h_row;
#pragma unroll
    for (int kt = 0; kt < kUG; ++kt) {
      uint32_t b[4];
      ldmatrix_x4(b, hb + kt * 16);
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        mma_bf16(acc[g][0], a[g][kt], b[0], b[1]);
        mma_bf16(acc[g][1], a[g][kt], b[2], b[3]);
      }
    }
    __nv_bfloat16* h_next = s_h + ((s + 1) & 1) * kTrainBN * ldh;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      float h[4], og[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float g4[4] = {acc[0][nt][e], acc[1][nt][e], acc[3][nt][e],
                       2.0f * acc[2][nt][e]};
        sigmoid4(g4);  // sigmoid(i), sigmoid(f), sigmoid(o), sigmoid(2g)
        c[nt][e] = g4[1] * c[nt][e] + g4[0] * fmaf(2.0f, g4[3], -1.0f);
        og[e] = g4[2];
        h[e] = c[nt][e];
      }
      tanh2(h[0], h[1]);
      tanh2(h[2], h[3]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        h[e] *= og[e];
        const int r = rw + nt * 8 + 2 * tig + (e & 1);
        const int j = ug * 16 + grp + (e < 2 ? 0 : 8);
        h_next[r * ldh + j] = __float2bfloat16_rn(h[e]);
        if (n0 + r < n) {
          const size_t o =
              (((size_t)(n0 + r) * seq_len + t) * 2 + dir) * kH + j;
          hs[o] = h[e];
          if constexpr (kTrain) cs[o] = c[nt][e];
        }
      }
    }
  }
}

// Reverse-time sweep with dW. Inputs as the forward's, plus hs, cs, g
// [n, L, 2, H] f32; dxp [n, L, 2, 4H] f32; part [tiles, 2, H, 4H] f32, the
// block's dW over its rows and every step (kDw). Warps as the forward's.
// Shared: w_hh [H][4H + 8] bf16; per buffer (2): xp [32][4H + 4], h_{t-1}
// [32][H + 8], c_{t-1} [32][H + 4], g [32][H + 4], all f32; dgates hi and lo
// [2][32][4H + 8] bf16.
template <int kH, bool kDw>
__global__ void __launch_bounds__(kH / 16 * 64)
lstm_bwd_smem_kernel(const float* __restrict__ xp,
                     const __nv_bfloat16* __restrict__ w_hh,
                     const float* __restrict__ hs,
                     const float* __restrict__ cs,
                     const float* __restrict__ g, float* __restrict__ dxp,
                     float* __restrict__ part, int n, int seq_len) {
  constexpr int kUG = kH / 16;
  constexpr int kThreads = kUG * 64;
  constexpr int ldw = 4 * kH + kWPad;
  constexpr int ldx = 4 * kH + kXpPad;
  constexpr int ldh = kH + kHPad;
  constexpr int ldc = kH + kCPad;
  constexpr int ldd = 4 * kH + kDgPad;
  constexpr int kBuf = kTrainBN * (ldx + ldh + 2 * ldc);  // floats a buffer
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* s_w = reinterpret_cast<__nv_bfloat16*>(smem_u4);
  float* s_buf = reinterpret_cast<float*>(s_w + kH * ldw);
  // dgates as bf16 hi (the rounding the dh product takes) and lo (what hi
  // leaves, for dW), rows of ldd
  __nv_bfloat16* s_dh = reinterpret_cast<__nv_bfloat16*>(s_buf + 2 * kBuf);
  __nv_bfloat16* s_dl = s_dh + kTrainBN * ldd;
  // buffer b: xp at s_buf + b kBuf, then h_{t-1}, c_{t-1}, g
  auto s_xp = [&](int b) { return s_buf + b * kBuf; };
  auto s_hp = [&](int b) { return s_buf + b * kBuf + kTrainBN * ldx; };
  auto s_cp = [&](int b) { return s_hp(b) + kTrainBN * ldh; };
  auto s_g = [&](int b) { return s_cp(b) + kTrainBN * ldc; };

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int grp = lane >> 2;
  const int tig = lane & 3;
  const int ug = warp % kUG;
  const int rw = (warp / kUG) * 16;
  const int dir = blockIdx.y;
  const int n0 = blockIdx.x * kTrainBN;
  auto time_of = [&](int s) { return dir == 0 ? s : seq_len - 1 - s; };

  // iteration i runs the direction's step s = L-1-i: xp and g at its time,
  // h and c of the step before (zero at s = 0)
  auto fetch = [&](int i, int b) {
    const int s = seq_len - 1 - i;
    const int t = time_of(s);
    const int tp = s > 0 ? time_of(s - 1) : t;
    fetch_rows<4 * kH>(s_xp(b), ldx, xp, n, n0, seq_len, t, dir, true, tid,
                       kThreads);
    fetch_rows<kH>(s_g(b), ldc, g, n, n0, seq_len, t, dir, true, tid,
                   kThreads);
    fetch_rows<kH>(s_hp(b), ldh, hs, n, n0, seq_len, tp, dir, s > 0, tid,
                   kThreads);
    fetch_rows<kH>(s_cp(b), ldc, cs, n, n0, seq_len, tp, dir, s > 0, tid,
                   kThreads);
    cp_async_commit();
  };

  copy_w<kH>(s_w, w_hh + (size_t)dir * kH * 4 * kH, tid, kThreads);
  fetch(0, 0);

  // c_t of the first iteration from device memory; each later one is the
  // c_{t-1} this thread read the iteration before
  float ct[2][4], dh[2][4], dc[2][4];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = n0 + rw + nt * 8 + 2 * tig + (e & 1);
      const int j = ug * 16 + grp + (e < 2 ? 0 : 8);
      ct[nt][e] = row < n ? cs[(((size_t)row * seq_len +
                                  time_of(seq_len - 1)) * 2 + dir) * kH + j]
                          : 0.0f;
      dh[nt][e] = 0.0f;
      dc[nt][e] = 0.0f;
    }

  // dW over the block's rows on the tensor cores: warp w computes units
  // 16 (w % (H/16)).. by gate columns 2H (w / (H/16)).., H/4 n-tiles
  constexpr int kDwNT = kH / 4;
  const int kc0 = (warp / kUG) * 2 * kH;
  // this thread's ldmatrix row of dgates for the dh product: n-tiles 0
  // and 1 of the warp's rows
  const int dg_row = (rw + (lane >> 4) * 8 + (lane & 7)) * ldd +
                     ((lane >> 3) & 1) * 8;
  float dw[kDw ? kDwNT : 1][4];
  if constexpr (kDw) {
#pragma unroll
    for (int nn = 0; nn < kDwNT; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) dw[nn][e] = 0.0f;
  }

  for (int i = 0; i < seq_len; ++i) {
    const int s = seq_len - 1 - i;
    const int t = time_of(s);
    const int b = i & 1;
    cp_async_wait_all();
    // this iteration's inputs visible; every read of the last one done
    __syncthreads();
    if (i + 1 < seq_len) fetch(i + 1, b ^ 1);

    // gates again: xp_t + w_hh^T . bf16(h_{t-1})
    float acc[4][2][4];
    const float* xs = s_xp(b);
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[q][nt][e] = xs[(rw + nt * 8 + 2 * tig + (e & 1)) * ldx +
                             q * kH + ug * 16 + grp + (e < 2 ? 0 : 8)];
    const float* hp = s_hp(b);
#pragma unroll
    for (int kt = 0; kt < kUG; ++kt) {
      uint32_t bf[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const float* p = hp + (rw + nt * 8 + grp) * ldh + kt * 16 + 2 * tig;
        bf[nt][0] = pack_bf16(*reinterpret_cast<const float2*>(p));
        bf[nt][1] = pack_bf16(*reinterpret_cast<const float2*>(p + 8));
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t a[4];
        a_wt(a, s_w, ldw, q * kH + ug * 16, kt * 16, lane);
        mma_bf16(acc[q][0], a, bf[0][0], bf[0][1]);
        mma_bf16(acc[q][1], a, bf[1][0], bf[1][1]);
      }
    }

    // the cell backwards; dgates to dxp and to shared memory
    const float* cp = s_cp(b);
    const float* gp = s_g(b);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      float tc[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) tc[e] = ct[nt][e];
      tanh2(tc[0], tc[1]);
      tanh2(tc[2], tc[3]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = rw + nt * 8 + 2 * tig + (e & 1);
        const int j = ug * 16 + grp + (e < 2 ? 0 : 8);
        const float c_prev = cp[r * ldc + j];
        float g4[4] = {acc[0][nt][e], acc[1][nt][e], acc[3][nt][e],
                       2.0f * acc[2][nt][e]};
        sigmoid4(g4);
        const float ig = g4[0], fg = g4[1], og = g4[2];
        const float gg = fmaf(2.0f, g4[3], -1.0f);
        const float dhv = gp[r * ldc + j] + dh[nt][e];
        const float dcv = dhv * og * (1.0f - tc[e] * tc[e]) + dc[nt][e];
        float dq[4];
        dq[0] = dcv * gg * ig * (1.0f - ig);
        dq[1] = dcv * c_prev * fg * (1.0f - fg);
        dq[2] = dcv * ig * (1.0f - gg * gg);
        dq[3] = dhv * tc[e] * og * (1.0f - og);
        dc[nt][e] = dcv * fg;
        ct[nt][e] = c_prev;
        float* dst = dxp + (((size_t)(n0 + r) * seq_len + t) * 2 + dir) *
                               4 * kH + j;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const __nv_bfloat16 hi = __float2bfloat16_rn(dq[q]);
          s_dh[r * ldd + q * kH + j] = hi;
          if constexpr (kDw)
            s_dl[r * ldd + q * kH + j] =
                __float2bfloat16_rn(dq[q] - __bfloat162float(hi));
          if (n0 + r < n) dst[q * kH] = dq[q];
        }
      }
    }
    __syncthreads();  // all of dgates is in shared memory

    // dh_{t-1} = w_hh . bf16(dgates) for the warp's units and rows
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dh[nt][e] = 0.0f;
#pragma unroll 4
    for (int kt = 0; kt < 4 * kUG; ++kt) {
      uint32_t a[4];
      a_w(a, s_w, ldw, ug * 16, kt * 16, lane);
      uint32_t b[4];
      ldmatrix_x4(b, s_dh + dg_row + kt * 16);
      mma_bf16(dh[0], a, b[0], b[1]);
      mma_bf16(dh[1], a, b[2], b[3]);
    }

    // dW += h_{t-1}^T dgates (f32 h_{t-1} and dgates, each split into
    // bf16 hi + lo; h_{t-1} = 0 at s = 0)
    if constexpr (kDw) {
      if (s > 0) {
#pragma unroll
        for (int kt = 0; kt < kTrainBN / 16; ++kt) {
          // A: h_{t-1}^T, units ug*16.. by rows kt*16..
          const float* h0 = hp + (kt * 16 + 2 * tig) * ldh + ug * 16 + grp;
          uint32_t ah[4], al[4];
          split2(h0[0], h0[ldh], ah[0], al[0]);
          split2(h0[8], h0[ldh + 8], ah[1], al[1]);
          split2(h0[8 * ldh], h0[9 * ldh], ah[2], al[2]);
          split2(h0[8 * ldh + 8], h0[9 * ldh + 8], ah[3], al[3]);
          // B: dgates hi and lo, rows kt*16.. by the warp's gate columns,
          // two n-tiles a transposed ldmatrix
          const int d0 = (kt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ldd +
                         kc0 + (lane >> 4) * 8;
#pragma unroll
          for (int p = 0; p < kDwNT / 2; ++p) {
            uint32_t bh[4], bl[4];
            ldmatrix_x4_trans(bh, s_dh + d0 + p * 16);
            ldmatrix_x4_trans(bl, s_dl + d0 + p * 16);
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              float (&acc_w)[4] = dw[2 * p + q];
              mma_bf16(acc_w, ah, bh[2 * q], bh[2 * q + 1]);
              mma_bf16(acc_w, ah, bl[2 * q], bl[2 * q + 1]);
              mma_bf16(acc_w, al, bh[2 * q], bh[2 * q + 1]);
            }
          }
        }
      }
    }
    // No barrier here: the next iteration's first one comes before anyone
    // writes dgates or refills this iteration's buffer.
  }
  if constexpr (kDw) {
    float* out = part + ((size_t)blockIdx.x * 2 + dir) * kH * 4 * kH +
                 (size_t)(ug * 16 + grp) * 4 * kH + kc0 + 2 * tig;
#pragma unroll
    for (int nn = 0; nn < kDwNT; ++nn) {
      *reinterpret_cast<float2*>(out + nn * 8) =
          make_float2(dw[nn][0], dw[nn][1]);
      *reinterpret_cast<float2*>(out + 8 * 4 * kH + nn * 8) =
          make_float2(dw[nn][2], dw[nn][3]);
    }
  }
}

// the smem forward's block with xp of xp_bytes (4 f32, 2 bf16; training's
// is the f32 one): w_hh, two xp buffers, two bf16 h buffers
// (lstm_fwd_smem_kernel)
int infer_smem_bytes(int hidden, int xp_bytes) {
  return hidden * (4 * hidden + kWPad) * 2 +
         2 * kTrainBN * (4 * hidden * xp_bytes + kXpRowPad) +
         2 * kTrainBN * (hidden + kRowPad) * 2;
}

int bwd_smem_bytes(int hidden) {
  return hidden * (4 * hidden + kWPad) * 2 +
         2 * kTrainBN *
             ((4 * hidden + kXpPad) + (hidden + kHPad) + 2 * (hidden + kCPad)) *
             4 +
         2 * kTrainBN * (4 * hidden + kDgPad) * 2;
}

bool smem_plan_ok(int n, int seq_len, int hidden, int bn, int grid_x) {
  return n > 0 && seq_len > 0 && hidden == kSmemHidden && bn == kTrainBN &&
         grid_x == (n + kTrainBN - 1) / kTrainBN;
}

template <int kH, bool kTrain, typename XpT>
int launch_fwd_smem(const void* xp, const void* w, void* hs, void* cs, int n,
                    int seq_len, int smem, int grid_x, cudaStream_t stream) {
  if (smem != infer_smem_bytes(kH, sizeof(XpT)) || smem > kSmemMax)
    return kPlanError;
  auto kernel = lstm_fwd_smem_kernel<kH, kTrain, XpT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(grid_x, 2), kH / 16 * 64, smem, stream>>>(
      static_cast<const XpT*>(xp), static_cast<const __nv_bfloat16*>(w),
      static_cast<float*>(hs), static_cast<float*>(cs), n, seq_len);
  return (int)cudaGetLastError();
}

// blocks of the smem inference forward an SM holds at once at `smem`
// bytes (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or a negated
// cudaError
template <typename XpT>
int infer_smem_occupancy(int smem) {
  auto kernel = lstm_fwd_smem_kernel<kSmemHidden, false, XpT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, kernel, kSmemHidden / 16 * 64, smem);
  if (err != cudaSuccess) return -(int)err;
  return blocks;
}

template <int kH, bool kDw>
int launch_bwd_smem(const void* xp, const void* w, const void* hs,
                    const void* cs, const void* g, void* dxp, void* part,
                    void* dw, int n, int seq_len, int smem, int grid_x,
                    cudaStream_t stream) {
  if (smem != bwd_smem_bytes(kH) || smem > kSmemMax) return kPlanError;
  auto kernel = lstm_bwd_smem_kernel<kH, kDw>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(grid_x, 2), kH / 16 * 64, smem, stream>>>(
      static_cast<const float*>(xp), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(hs), static_cast<const float*>(cs),
      static_cast<const float*>(g), static_cast<float*>(dxp),
      static_cast<float*>(part), n, seq_len);
  err = cudaGetLastError();
  if (err != cudaSuccess || !kDw) return (int)err;
  // dW = bf16(the blocks' partials summed over tiles, in tile order)
  const int size = 2 * kH * 4 * kH;
  lstm_dw_sum_kernel<<<(size + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<__nv_bfloat16*>(dw), size,
      grid_x);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// dW on the tensor cores (nsp_lstm_dw: the cluster and packed paths).
// dW[d] = A_d^T B_d over the rows m of direction d, the (n, step) pairs with
// a predecessor: m = n_idx (L-1) + q, t = q + 1 - d, t_prev = q + d; A_d
// [M, H] is h_{t_prev} (hs), B_d [M, 4H] dxp at t, both f32, rows at a
// stride of 2H and 8H floats. One CTA computes a kDwTH (units) x kDwTK (gate
// columns) tile of one direction over one split of the rows: grid (output
// tiles, splits, 2), the tiles of one (split, direction) next to each other,
// so the CTAs that read the same rows run together and each row comes from
// device memory once.
//   - A ring of kDwStages f32 chunks (kDwRows rows of the tile's A and B
//     columns) is filled by cp.async. Each thread splits the pieces it
//     copied itself (its own wait_group makes them visible to it, so the
//     ring needs no barrier) into bf16 hi + lo tiles, double buffered: A as
//     it comes ([rows][units]), B transposed into K-major 8x8 core matrices
//     for wgmma.
//   - Two warpgroups of 64 units x kDwTK columns: per 16 rows, A^T's
//     fragments by ldmatrix.trans (a warp's 16 units, the mma.m16n8k16 A
//     layout that wgmma takes from registers) and three wgmma m64n128k16
//     (hi hi, hi lo, lo hi) into one f32 accumulator: within about 2^-15 of
//     each f32 product, against the 2^-8 of the bf16 dW returned. The
//     products of chunk c run while the same warps split chunk c + 1: one
//     barrier a chunk.
//   - Each CTA writes its partial once to part [splits, 2, H, 4H] f32;
//     lstm_dw_sum_kernel adds the partials in split order and rounds to bf16
//     once. No atomics: the same bits every run.
constexpr int kDwTH = 128;                // units (rows of dW) a tile
constexpr int kDwTK = 128;                // gate columns a tile (wgmma N)
constexpr int kDwRows = 32;               // rows m a chunk
constexpr int kDwStages = 4;              // f32 chunks in the ring
constexpr int kDwLd = kDwTH + kRowPad;    // a row of the A tiles, bf16
constexpr int kDwTileA = kDwRows * kDwLd;  // an A tile, bf16
// B tiles: core matrix (column group g, row group q) at g kDwSbo + q 128
// bytes, 8 columns x 8 rows m, a column's 8 rows in 16 bytes; the 16 bytes
// between column groups spread the split's stores over the banks
constexpr int kDwSbo = kDwRows / 8 * 128 + 16;
constexpr int kDwTileB = kDwTK / 8 * kDwSbo / 2;  // a B tile, bf16
constexpr int kDwBuf = 2 * kDwTileA + 2 * kDwTileB;  // A hi, lo, B hi, lo
constexpr int kDwThreads = 256;

int dw_smem_bytes() {
  return kDwStages * kDwRows * (kDwTH + kDwTK) * 4 + 2 * kDwBuf * 2;
}

int dw_tiles(int hidden) {
  return (hidden + kDwTH - 1) / kDwTH * ((4 * hidden + kDwTK - 1) / kDwTK);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// wgmma (as csrc/bilstm.cu's in-projection issues it): D[64 x 128] +=
// A[64 x 16] B[16 x 128], A from registers (warp w of the warpgroup holds
// rows 16 w.. in the mma.m16n8k16 A-fragment layout), B from shared memory
// through a descriptor of K-major core matrices; D per 8 columns j in the
// m16n8 accumulator layout (d[4j..4j+3]).
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// descriptor of a K-major B tile without swizzle: k-adjacent core matrices
// 128 bytes apart, n-adjacent ones kDwSbo
__device__ __forceinline__ uint64_t dw_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(128 >> 4) << 16) | ((uint64_t)(kDwSbo >> 4) << 32);
}

// empty asms that read and write the registers: the compiler keeps their
// values where they are up to here (operands of an issued wgmma, which
// reads and writes them until its wait)
template <int kN>
__device__ __forceinline__ void keep_regs(float (&v)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(v[i])::"memory");
}

template <int kN>
__device__ __forceinline__ void keep_regs(uint32_t (&v)[kN][4]) {
#pragma unroll
  for (int i = 0; i < kN; ++i)
    asm volatile("" : "+r"(v[i][0]), "+r"(v[i][1]), "+r"(v[i][2]),
                 "+r"(v[i][3])::"memory");
}

// four f32 as bf16 hi (their rounding) and lo (what hi leaves, rounded)
__device__ __forceinline__ void split4(const float4& v, uint2& hi,
                                       uint2& lo) {
  split2(v.x, v.y, hi.x, lo.x);
  split2(v.z, v.w, hi.y, lo.y);
}

// part [splits, 2, H, 4H] f32; rows: rows m a split (a multiple of kDwRows)
__global__ void __launch_bounds__(kDwThreads, 1)
lstm_dw_tc_kernel(const float* __restrict__ dxp, const float* __restrict__ hs,
                  float* __restrict__ part, int n, int seq_len, int hidden,
                  int rows) {
  extern __shared__ uint4 smem_u4[];
  constexpr int kStage = kDwRows * (kDwTH + kDwTK);  // floats a ring slot
  float* s_ring = reinterpret_cast<float*>(smem_u4);
  __nv_bfloat16* s_split =
      reinterpret_cast<__nv_bfloat16*>(s_ring + kDwStages * kStage);
  const int four_h = 4 * hidden;
  const int tiles_k = (four_h + kDwTK - 1) / kDwTK;
  const int h0 = blockIdx.x / tiles_k * kDwTH;
  const int k0 = (blockIdx.x % tiles_k) * kDwTK;
  const int d = blockIdx.z;
  const int steps = seq_len - 1;
  const int total = n * steps;  // below 2^31: dw_plan_ok
  const int m_begin = blockIdx.y * rows;
  const int m_end = m_begin + rows < total ? m_begin + rows : total;
  const int chunks =
      m_end > m_begin ? (m_end - m_begin + kDwRows - 1) / kDwRows : 0;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int grp = lane >> 2;
  const int tig = lane & 3;
  // this thread's pieces of a chunk: rows 4 r0 + i (i < 4), 4 columns from
  // c4 of the tile, in A and in B; zero past H, 4H or the split's rows
  const int r0 = warp;
  const int c4 = lane * 4;
  const bool a_cols = h0 + c4 < hidden;
  const bool b_cols = k0 + c4 < four_h;
  // warpgroup warp / 4 computes units 64 (warp / 4).. of the tile, the
  // warp the 16 from wu
  const int wu = (warp >> 2) * 64 + (warp & 3) * 16;

  auto fetch = [&](int c) {
    if (c < chunks) {
      float* st = s_ring + (c % kDwStages) * kStage;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 4 * r0 + i;
        const int m = m_begin + c * kDwRows + r;
        const bool ok = m < m_end;
        const int n_idx = ok ? m / steps : 0;
        const int q = ok ? m - n_idx * steps : 0;
        const float* a = hs + (((size_t)n_idx * seq_len + q + d) * 2 + d) *
                                  hidden + h0 + c4;
        const float* b = dxp + (((size_t)n_idx * seq_len + q + 1 - d) * 2 +
                                d) * four_h + k0 + c4;
        cp_async16(st + r * kDwTH + c4, ok && a_cols ? a : hs, ok && a_cols);
        cp_async16(st + kDwRows * kDwTH + r * kDwTK + c4,
                   ok && b_cols ? b : dxp, ok && b_cols);
      }
    }
    cp_async_commit();  // empty past the last chunk: the count stays even
  };
  // this thread's pieces of chunk c, from the ring into split buffer c & 1:
  // A rows 4 r0.. as they are; B's columns c4.. transposed, the four rows
  // one 8-byte half of each column's row of its core matrix
  auto split = [&](int c) {
    const float* st = s_ring + (c % kDwStages) * kStage;
    __nv_bfloat16* sb = s_split + (c & 1) * kDwBuf;
    float4 bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * r0 + i;
      uint2 hi, lo;
      split4(*reinterpret_cast<const float4*>(st + r * kDwTH + c4), hi, lo);
      *reinterpret_cast<uint2*>(sb + r * kDwLd + c4) = hi;
      *reinterpret_cast<uint2*>(sb + kDwTileA + r * kDwLd + c4) = lo;
      bv[i] = *reinterpret_cast<const float4*>(st + kDwRows * kDwTH +
                                               r * kDwTK + c4);
    }
    const float col[4][4] = {{bv[0].x, bv[1].x, bv[2].x, bv[3].x},
                             {bv[0].y, bv[1].y, bv[2].y, bv[3].y},
                             {bv[0].z, bv[1].z, bv[2].z, bv[3].z},
                             {bv[0].w, bv[1].w, bv[2].w, bv[3].w}};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int nc = c4 + e;  // the column in the tile
      uint2 hi, lo;
      split4(make_float4(col[e][0], col[e][1], col[e][2], col[e][3]), hi, lo);
      const int off = (nc >> 3) * (kDwSbo / 2) + (r0 >> 1) * 64 +
                      (nc & 7) * 8 + (r0 & 1) * 4;
      *reinterpret_cast<uint2*>(sb + 2 * kDwTileA + off) = hi;
      *reinterpret_cast<uint2*>(sb + 2 * kDwTileA + kDwTileB + off) = lo;
    }
  };

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  // this thread's ldmatrix row of A^T (units by rows m), read transposed
  const int a_off = ((lane & 7) + (lane >> 4) * 8) * kDwLd + wu +
                    ((lane >> 3) & 1) * 8;

#pragma unroll
  for (int c = 0; c < kDwStages - 1; ++c) fetch(c);
  if (chunks > 0) {
    cp_async_wait<kDwStages - 2>();
    fetch(kDwStages - 1);
    split(0);
  }
  fence_proxy_async();  // the split's B tiles visible to wgmma
  __syncthreads();
  for (int c = 0; c < chunks; ++c) {
    const __nv_bfloat16* sb = s_split + (c & 1) * kDwBuf;
    // every warpgroup issues its products, past H too (on zeros): wgmma
    // under a branch the compiler cannot prove uniform is serialized
    uint32_t ah[kDwRows / 16][4], al[kDwRows / 16][4];
#pragma unroll
    for (int ks = 0; ks < kDwRows / 16; ++ks) {
      ldmatrix_x4_trans(ah[ks], sb + ks * 16 * kDwLd + a_off);
      ldmatrix_x4_trans(al[ks], sb + kDwTileA + ks * 16 * kDwLd + a_off);
    }
    keep_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kDwRows / 16; ++ks) {
      const __nv_bfloat16* bh = sb + 2 * kDwTileA + ks * 128;
      wgmma_m64n128k16(acc, ah[ks], dw_desc(bh));
      wgmma_m64n128k16(acc, ah[ks], dw_desc(bh + kDwTileB));
      wgmma_m64n128k16(acc, al[ks], dw_desc(bh));
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // chunk c + 1's split beside chunk c's products, into the other buffer,
    // whose last reader (chunk c - 1's products) ended before the barrier
    if (c + 1 < chunks) {
      cp_async_wait<kDwStages - 2>();  // this thread's copies of chunk c + 1
      // into chunk c's slot, which only this thread's split read
      fetch(c + kDwStages);
      split(c + 1);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    keep_regs(acc);
    keep_regs(ah);
    keep_regs(al);
    fence_proxy_async();
    __syncthreads();  // chunk c + 1 split; chunk c's products ended
  }
  const int h = h0 + wu + grp;
  if (h >= hidden) return;  // H is a multiple of 16: the warp's 16 units
  float* out = part + ((size_t)blockIdx.y * 2 + d) * hidden * four_h;
#pragma unroll
  for (int j = 0; j < kDwTK / 8; ++j) {
    const int k = k0 + 8 * j + 2 * tig;
    if (k >= four_h) continue;
    *reinterpret_cast<float2*>(out + (size_t)h * four_h + k) =
        make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(out + (size_t)(h + 8) * four_h + k) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// the plan (ops/lstm_train.plan_dw): rows a multiple of kDwRows, every
// split non-empty, the splits covering the N (L-1) rows, a CTA per tile
bool dw_plan_ok(int n, int seq_len, int hidden, int rows, int splits,
                int grid_x) {
  if (n <= 0 || seq_len < 2 || hidden < 16 || hidden % 16 || hidden > 256 ||
      rows <= 0 || rows % kDwRows || splits <= 0 || splits > 65535)
    return false;
  const long long total = (long long)n * (seq_len - 1);
  return total < 0x7fffffff - rows && grid_x == dw_tiles(hidden) &&
         (long long)rows * (splits - 1) < total &&
         (long long)rows * splits >= total;
}

bool bad_shape(int n, int seq_len, int hidden) {
  return n <= 0 || seq_len <= 0 || hidden <= 0 || hidden % 16 ||
         hidden > 16 * kMaxWarps;
}

template <bool kTrain, typename XpT>
int launch_fwd(const void* xp, const void* wpk, void* hs, void* cs, int n,
               int seq_len, int hidden, void* stream) {
  if (bad_shape(n, seq_len, hidden)) return (int)cudaErrorInvalidValue;
  constexpr int kBN = 8 * kFwdNT;
  const size_t smem =
      (size_t)kBN * (hidden + kRowPad) * sizeof(__nv_bfloat16);
  auto kernel = lstm_fwd_kernel<kTrain, XpT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + kBN - 1) / kBN, 2);
  kernel<<<grid, hidden / 16 * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const XpT*>(xp), static_cast<const uint4*>(wpk),
      static_cast<float*>(hs), static_cast<float*>(cs), n, seq_len, hidden);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The cluster path (H=256, the haplotype model): w_hh sliced over a cluster
// of kClC CTAs, one cluster per (direction, kClBN batch rows). CTA r owns
// units [r U, (r+1) U), U = H/C, with all four gates: its gate columns K_r
// are {g H + r U + u : g < 4, u < U}, and its w_hh slice, every k row of
// those columns, is copied into shared memory once, straight from the
// model's w_hh [2, H, 4H] ([H][4U + 8] bf16). Warp w owns units (w % 4)
// 16.. of the CTA's U for batch rows (w / 4) 32.., as the smem path's
// warps do; one slice serves both of the sweep's products (ldmatrix.trans
// for the gates' w_hh^T, plain ldmatrix for dh's w_hh).
//
// Within each group of 16 units the slice's rows and columns, and the
// columns of the bf16 h tiles, are in the order perm: position p holds
// unit 2 (p % 8) + p / 8. An mma accumulator's rows grp and grp + 8 are
// then units 2 grp and 2 grp + 1, so a thread's two units of a fragment
// are neighbours in device memory and its xp, hs, cs, g and dxp accesses
// are 8-byte pairs, not single floats (scalar accesses, four rows a warp
// instruction, made the loads' issue the longest part of a step).

constexpr int kClH = 256;                 // the H the kernels are built for
constexpr int kClC = 4;                   // CTAs a cluster
constexpr int kClU = kClH / kClC;         // units a CTA
constexpr int kClBN = 64;                 // batch rows a cluster
constexpr int kClThreads = 256;           // 4 unit groups x 2 row halves
constexpr int kClLdw = 4 * kClU + kWPad;  // a row of the w slice, bf16
constexpr int kClLdh = kClH + kRowPad;    // a row of bf16 h (or dgates)
constexpr int kNoCluster = -2;            // no cluster of the plan fits

// the position of unit u in its group of 16
__device__ __forceinline__ int inv_perm16(int u) {
  return (u & ~15) | (((u & 1) << 3) + ((u & 15) >> 1));
}

// the cluster barrier in two halves: arrive publishes this thread's earlier
// writes (shared memory of any CTA of the cluster), wait returns once every
// thread of the cluster has arrived and sees their writes
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// CTA `rank`'s slice of w_hh[dir] [H, 4H] into shared memory: source row k
// to row inv_perm16(k), gate g's unit rank U + u to column g U +
// inv_perm16(u). Once a call: 16-byte loads, 2-byte stores.
__device__ __forceinline__ void copy_w_slice(__nv_bfloat16* s_w,
                                             const __nv_bfloat16* w,
                                             int rank, int tid) {
  constexpr int kPieces = 4 * kClU / 8;  // 8 units of one gate, a row
  for (int i = tid; i < kClH * kPieces; i += kClThreads) {
    const int k = i / kPieces, q = i - k * kPieces;
    const int g = q / (kClU / 8), u0 = (q - g * (kClU / 8)) * 8;
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(
        w + (size_t)k * 4 * kClH + g * kClH + rank * kClU + u0));
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
    __nv_bfloat16* row = s_w + inv_perm16(k) * kClLdw + g * kClU;
#pragma unroll
    for (int x = 0; x < 8; ++x) row[inv_perm16(u0 + x)] = e[x];
  }
}

// acc[g][nt] += w_slice^T (gate g, the warp's units) . bf16 h (the warp's
// 32 rows, every k); hb is this thread's ldmatrix row of the warp's rows in
// a bf16 [kClBN][kClLdh] tile. per_kt(kt) runs before k-tile kt's products:
// loads of device memory spread over the product so that they overlap it
// (issued all at once, they stalled the warps for as long as the product
// took).
template <typename PerKt>
__device__ __forceinline__ void cluster_gates(float (&acc)[4][4][4],
                                              const __nv_bfloat16* s_w,
                                              const __nv_bfloat16* hb, int ug,
                                              int lane, PerKt&& per_kt) {
#pragma unroll
  for (int kt = 0; kt < kClH / 16; ++kt) {
    per_kt(kt);
    uint32_t b[2][4];
    ldmatrix_x4(b[0], hb + kt * 16);
    ldmatrix_x4(b[1], hb + 16 * kClLdh + kt * 16);
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      uint32_t a[4];
      a_wt(a, s_w, kClLdw, g * kClU + ug * 16, kt * 16, lane);
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        mma_bf16(acc[g][2 * p], a, b[p][0], b[p][1]);
        mma_bf16(acc[g][2 * p + 1], a, b[p][2], b[p][3]);
      }
    }
  }
}

// Accumulator element e of n-tile nt holds batch row rw + nt 8 + 2 tig +
// (e & 1) and the CTA's unit ug 16 + 2 grp + e / 2: elements e and e + 2
// are one 8-byte pair of neighbouring units in device memory.

// Two neighbouring xp values as loaded (an f32 pair, or a bf16 pair in 32
// bits), and widened to f32. The forward keeps the loaded form in
// registers until the next step: widening at the load would consume it
// there, and each prefetch would wait for its load.
__device__ __forceinline__ float2 load_pair(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}
__device__ __forceinline__ float2 widen_pair(float2 v) { return v; }
__device__ __forceinline__ float2 widen_pair(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// Forward, training's (kTrain: hs and cs out, xp f32) and inference's (hs
// only, xp f32 or bf16 widened on load). xp [n, L, 2, 4H]; w_hh [2, H, 4H]
// bf16; hs, cs [n, L, 2, H] f32. grid (ceil(n / kClBN) kClC, 2), cluster
// (kClC, 1, 1). Shared: the w slice, then bf16 h [2][kClBN][kClLdh] by step
// parity. Each step: xp of this thread's fragments (loaded the step before)
// + w_slice^T . bf16 h_{t-1}, the cell in registers, hs (and cs) out, this
// CTA's slice of bf16 h_t into every peer's buffer through distributed
// shared memory, one cluster barrier.
template <bool kTrain, typename XpT>
__global__ void __launch_bounds__(kClThreads, 1)
lstm_fwd_cluster_kernel(const XpT* __restrict__ xp,
                        const __nv_bfloat16* __restrict__ w_hh,
                        float* __restrict__ hs, float* __restrict__ cs, int n,
                        int seq_len) {
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* s_w = reinterpret_cast<__nv_bfloat16*>(smem_u4);
  __nv_bfloat16* s_h = s_w + kClH * kClLdw;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int grp = lane >> 2;
  const int tig = lane & 3;
  const int ug = warp % 4;
  const int rw = (warp / 4) * 32;  // the warp's first row in the tile
  const int dir = blockIdx.y;
  const int n0 = (blockIdx.x / kClC) * kClBN;
  const int jc = rank * kClU + ug * 16 + grp;      // h tile column, e < 2
  const int jg = rank * kClU + ug * 16 + 2 * grp;  // unit of the pair
  auto time_of = [&](int s) { return dir == 0 ? s : seq_len - 1 - s; };

  for (int i = tid; i < 2 * kClBN * kClLdh; i += kClThreads)
    s_h[i] = __float2bfloat16_rn(0.0f);  // h_{-1} = 0
  copy_w_slice(s_w, w_hh + (size_t)dir * kClH * 4 * kClH, rank, tid);

  // pair li of xp at step s, as loaded: gate li / 8, n-tile li / 2 % 4,
  // elements li % 2 and li % 2 + 2; zero past n
  using Pair = decltype(load_pair(xp));
  auto load_xp = [&](int s, int li, Pair (&v)[32]) {
    const int nt = li / 2 % 4, par = li % 2;
    const int row = n0 + rw + nt * 8 + 2 * tig + par;
    v[li] = row < n ? load_pair(xp + (((size_t)row * seq_len + time_of(s)) *
                                          2 + dir) * 4 * kClH +
                                (li / 8) * kClH + jg)
                    : Pair{};
  };
  Pair xcur[32];
#pragma unroll
  for (int li = 0; li < 32; ++li) load_xp(0, li, xcur);
  float c[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[nt][e] = 0.0f;
  const int h_row = (rw + (lane >> 4) * 8 + (lane & 7)) * kClLdh +
                    ((lane >> 3) & 1) * 8;
  // the slice in and every CTA's h zeroed before any peer writes into it
  cluster_arrive();

  for (int s = 0; s < seq_len; ++s) {
    const int t = time_of(s);
    // h_{t-1} whole in every CTA; every read of the other buffer done
    cluster_wait();
    float acc[4][4][4];
#pragma unroll
    for (int li = 0; li < 32; ++li) {
      const float2 x = widen_pair(xcur[li]);
      acc[li / 8][li / 2 % 4][li % 2] = x.x;
      acc[li / 8][li / 2 % 4][li % 2 + 2] = x.y;
    }
    // the next step's xp, two pairs a k-tile, in flight during the step
    const bool more = s + 1 < seq_len;
    cluster_gates(acc, s_w, s_h + (s & 1) * kClBN * kClLdh + h_row, ug, lane,
                  [&](int kt) {
                    if (more) {
                      load_xp(s + 1, 2 * kt, xcur);
                      load_xp(s + 1, 2 * kt + 1, xcur);
                    }
                  });
    __nv_bfloat16* h_next = s_h + ((s + 1) & 1) * kClBN * kClLdh;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      float h[4], og[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float g4[4] = {acc[0][nt][e], acc[1][nt][e], acc[3][nt][e],
                       2.0f * acc[2][nt][e]};
        sigmoid4(g4);  // sigmoid(i), sigmoid(f), sigmoid(o), sigmoid(2g)
        c[nt][e] = g4[1] * c[nt][e] + g4[0] * fmaf(2.0f, g4[3], -1.0f);
        og[e] = g4[2];
        h[e] = c[nt][e];
      }
      tanh2(h[0], h[1]);
      tanh2(h[2], h[3]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        h[e] *= og[e];
        h_next[(rw + nt * 8 + 2 * tig + (e & 1)) * kClLdh + jc +
               (e < 2 ? 0 : 8)] = __float2bfloat16_rn(h[e]);
      }
#pragma unroll
      for (int par = 0; par < 2; ++par) {
        const int row = n0 + rw + nt * 8 + 2 * tig + par;
        if (row < n) {
          const size_t o =
              (((size_t)row * seq_len + t) * 2 + dir) * kClH + jg;
          *reinterpret_cast<float2*>(hs + o) = make_float2(h[par],
                                                           h[par + 2]);
          if constexpr (kTrain)
            *reinterpret_cast<float2*>(cs + o) =
                make_float2(c[nt][par], c[nt][par + 2]);
        }
      }
    }
    __syncthreads();  // this CTA's slice of h_t is whole ...
    // ... and goes to every peer's buffer of the same parity: kClBN rows of
    // U / 8 pieces of 16 bytes, two a thread
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int i = tid + q * kClThreads;
      const int row = i / (kClU / 8);
      __nv_bfloat16* src =
          h_next + row * kClLdh + rank * kClU + (i - row * (kClU / 8)) * 8;
      const uint4 v = *reinterpret_cast<const uint4*>(src);
#pragma unroll
      for (int p = 1; p < kClC; ++p)
        *reinterpret_cast<uint4*>(
            cluster.map_shared_rank(src, (rank + p) % kClC)) = v;
    }
    cluster_arrive();
  }
  cluster_wait();  // no peer still writes into this CTA's shared memory
}

// Reverse-time sweep, dW left to lstm_dw_reduce. Inputs as the forward's,
// plus hs, cs, g [n, L, 2, H] f32; dxp [n, L, 2, 4H] f32. Grid and cluster
// as the forward's. Shared: the w slice; one bf16 [kClBN][kClLdh] tile that
// holds h_{t-1} for the gate product and then dgates (the slice's column
// order) for the dh product; the peers' partial dh, [kClC - 1][8 warps][4
// n-tiles][32 lanes] float4 (the receiving thread's accumulator fragments).
// Each step:
//   1. gates = xp + w_slice^T . bf16(h_{t-1}) (bf16 h_{t-1} staged from hs
//      the step before: every CTA reads the whole row, no exchange);
//   2. the cell backwards for this CTA's units: dgates to dxp (f32) and,
//      bf16, to the shared tile; dc <- dc f;
//   3. P_r = w_hh[:, K_r] . bf16(dgates_{K_r}), a partial of dh_{t-1} for
//      every unit, f32 on the tensor cores: warp (ug, rows) computes units
//      q U + ug 16.. for each CTA q, the very fragments that CTA q's warp
//      (ug, rows) owns;
//   4. reduce-scatter: P_r's part for CTA q into q's slot of rank r through
//      distributed shared memory; CTA q adds the four partials in rank order
//      0..3, its own from registers at its place, so dh is the same bits on
//      every run. A split cluster barrier guards the slots: the writes wait
//      for the peers' arrive after their sum, the sum for the writes.
__global__ void __launch_bounds__(kClThreads, 1)
lstm_bwd_cluster_kernel(const float* __restrict__ xp,
                        const __nv_bfloat16* __restrict__ w_hh,
                        const float* __restrict__ hs,
                        const float* __restrict__ cs,
                        const float* __restrict__ g, float* __restrict__ dxp,
                        int n, int seq_len) {
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* s_w = reinterpret_cast<__nv_bfloat16*>(smem_u4);
  __nv_bfloat16* s_x = s_w + kClH * kClLdw;
  float4* s_slot = reinterpret_cast<float4*>(s_x + kClBN * kClLdh);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int grp = lane >> 2;
  const int tig = lane & 3;
  const int ug = warp % 4;
  const int rw = (warp / 4) * 32;
  const int dir = blockIdx.y;
  const int n0 = (blockIdx.x / kClC) * kClBN;
  const int jl = ug * 16 + grp;  // the slice's column of e < 2; e >= 2: +8
  const int jg = rank * kClU + ug * 16 + 2 * grp;  // unit of the pair
  auto time_of = [&](int s) { return dir == 0 ? s : seq_len - 1 - s; };
  // the slot of sender `from` in a receiver `to`'s shared memory
  auto slot = [&](float4* base, int from, int to) {
    return base + (((from < to ? from : from - 1) * 8 + warp) * 4) * 32 + lane;
  };
  // the pair of f32 values of (row, unit jg, jg + 1) at time t of src
  // [n, L, 2, width]; zero past n
  auto pair_at = [&](const float* src, int width, int row, int t,
                     bool valid) {
    return valid && row < n
               ? __ldg(reinterpret_cast<const float2*>(
                     src + (((size_t)row * seq_len + t) * 2 + dir) * width +
                     jg))
               : make_float2(0.0f, 0.0f);
  };

  // iteration i runs step s = L-1-i. h_{t-1} of iteration i as 16 float4
  // a thread (piece k: row tid / 64 + 4 k), zero past n and at s = 0
  auto load_h = [&](int i, int k, float4 (&v)[16]) {
    const int s = seq_len - 1 - i;
    const int tp = s > 0 ? time_of(s - 1) : 0;
    const int idx = tid + k * kClThreads;
    const int row = n0 + (idx >> 6);
    v[k] = (s > 0 && row < n)
               ? __ldg(reinterpret_cast<const float4*>(
                           hs + (((size_t)row * seq_len + tp) * 2 + dir) *
                                    kClH) +
                       (idx & 63))
               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  };
  // into the tile as bf16, each unit at its column of the perm order
  auto store_h = [&](const float4 (&v)[16]) {
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int idx = tid + k * kClThreads;
      __nv_bfloat16* row = s_x + (idx >> 6) * kClLdh;
      const int u = (idx & 63) * 4;
      row[inv_perm16(u)] = __float2bfloat16_rn(v[k].x);
      row[inv_perm16(u + 1)] = __float2bfloat16_rn(v[k].y);
      row[inv_perm16(u + 2)] = __float2bfloat16_rn(v[k].z);
      row[inv_perm16(u + 3)] = __float2bfloat16_rn(v[k].w);
    }
  };
  // the cell's inputs of iteration i at this thread's fragments, loaded
  // during the iteration's gate product (held from the iteration before,
  // they would spill): pair li of xp at t (gate li / 8, n-tile li / 2 % 4,
  // elements li % 2 and li % 2 + 2), pair li of g at t and of c_{t-1} (zero
  // at s = 0)
  auto load_xp = [&](int i, int li, float (&x)[4][4][4]) {
    const int q = li / 8, nt = li / 2 % 4, par = li % 2;
    const float2 v = pair_at(xp + q * kClH, 4 * kClH,
                             n0 + rw + nt * 8 + 2 * tig + par,
                             time_of(seq_len - 1 - i), true);
    x[q][nt][par] = v.x;
    x[q][nt][par + 2] = v.y;
  };
  auto load_gc = [&](int i, int li, float (&gv)[4][4], float (&cp)[4][4]) {
    const int s = seq_len - 1 - i;
    const int nt = li / 2, par = li % 2;
    const int row = n0 + rw + nt * 8 + 2 * tig + par;
    const float2 a = pair_at(g, kClH, row, time_of(s), true);
    const float2 b = pair_at(cs, kClH, row, s > 0 ? time_of(s - 1) : 0, s > 0);
    gv[nt][par] = a.x;
    gv[nt][par + 2] = a.y;
    cp[nt][par] = b.x;
    cp[nt][par + 2] = b.y;
  };

  copy_w_slice(s_w, w_hh + (size_t)dir * kClH * 4 * kClH, rank, tid);
  float4 hv[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) load_h(0, k, hv);
  store_h(hv);
  // c_t of the first iteration from device memory; each later one is the
  // c_{t-1} this thread read the iteration before
  float ct[4][4], dh[4][4], dc[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int par = 0; par < 2; ++par) {
      const float2 v = pair_at(cs, kClH, n0 + rw + nt * 8 + 2 * tig + par,
                               time_of(seq_len - 1), true);
      ct[nt][par] = v.x;
      ct[nt][par + 2] = v.y;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dh[nt][e] = 0.0f;
      dc[nt][e] = 0.0f;
    }
  }
  // this thread's ldmatrix row of the warp's rows of the shared tile
  const int x_row = (rw + (lane >> 4) * 8 + (lane & 7)) * kClLdh +
                    ((lane >> 3) & 1) * 8;
  __syncthreads();  // the slice and bf16 h_{t-1} whole
  cluster_arrive();  // this CTA runs: peers may write into its slots

  for (int i = 0; i < seq_len; ++i) {
    const int s = seq_len - 1 - i;
    const int t = time_of(s);
    float acc[4][4][4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[q][nt][e] = 0.0f;
    // the cell's inputs: g and c_{t-1} in k-tiles 0-3, xp in 4-11
    float xin[4][4][4], gin[4][4], cin[4][4];
    cluster_gates(acc, s_w, s_x + x_row, ug, lane, [&](int kt) {
      if (kt < 4) {
        load_gc(i, 2 * kt, gin, cin);
        load_gc(i, 2 * kt + 1, gin, cin);
      } else if (kt < 12) {
#pragma unroll
        for (int li = 4 * (kt - 4); li < 4 * (kt - 3); ++li)
          load_xp(i, li, xin);
      }
    });
    __syncthreads();  // every read of h_{t-1} done: the tile takes dgates

#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      float tc[4], dq[4][4];
#pragma unroll
      for (int e = 0; e < 4; ++e) tc[e] = ct[nt][e];
      tanh2(tc[0], tc[1]);
      tanh2(tc[2], tc[3]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = rw + nt * 8 + 2 * tig + (e & 1);
        float g4[4] = {acc[0][nt][e] + xin[0][nt][e],
                       acc[1][nt][e] + xin[1][nt][e],
                       acc[3][nt][e] + xin[3][nt][e],
                       2.0f * (acc[2][nt][e] + xin[2][nt][e])};
        sigmoid4(g4);
        const float ig = g4[0], fg = g4[1], og = g4[2];
        const float gg = fmaf(2.0f, g4[3], -1.0f);
        const float dhv = gin[nt][e] + dh[nt][e];
        const float dcv = dhv * og * (1.0f - tc[e] * tc[e]) + dc[nt][e];
        dq[e][0] = dcv * gg * ig * (1.0f - ig);
        dq[e][1] = dcv * cin[nt][e] * fg * (1.0f - fg);
        dq[e][2] = dcv * ig * (1.0f - gg * gg);
        dq[e][3] = dhv * tc[e] * og * (1.0f - og);
        dc[nt][e] = dcv * fg;
        ct[nt][e] = cin[nt][e];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          s_x[r * kClLdh + q * kClU + jl + (e < 2 ? 0 : 8)] =
              __float2bfloat16_rn(dq[e][q]);
      }
#pragma unroll
      for (int par = 0; par < 2; ++par) {
        const int row = n0 + rw + nt * 8 + 2 * tig + par;
        if (row < n) {
          float* dst =
              dxp + (((size_t)row * seq_len + t) * 2 + dir) * 4 * kClH + jg;
#pragma unroll
          for (int q = 0; q < 4; ++q)
            *reinterpret_cast<float2*>(dst + q * kClH) =
                make_float2(dq[par][q], dq[par + 2][q]);
        }
      }
    }
    if (i + 1 == seq_len) break;  // h_{-1} = 0: no dh_{t-1} to form
    __syncthreads();  // all of bf16(dgates) is in the tile

    // P_r for the units of every CTA q: p[q][nt][e] is unit q U + ug 16 +
    // 2 grp + e / 2 (row ug 16 + grp (+8) of the slice), batch row rw +
    // nt 8 + 2 tig + (e & 1)
    float p[4][4][4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[q][nt][e] = 0.0f;
    // with the next h_{t-1}, a piece a k-tile, in flight during the
    // product and the exchange
#pragma unroll
    for (int kt = 0; kt < 4 * kClU / 16; ++kt) {
      load_h(i + 1, kt, hv);
      uint32_t b[2][4];
      ldmatrix_x4(b[0], s_x + x_row + kt * 16);
      ldmatrix_x4(b[1], s_x + x_row + 16 * kClLdh + kt * 16);
#pragma unroll
      for (int q = 0; q < kClC; ++q) {
        uint32_t a[4];
        a_w(a, s_w, kClLdw, q * kClU + ug * 16, kt * 16, lane);
#pragma unroll
        for (int pp = 0; pp < 2; ++pp) {
          mma_bf16(p[q][2 * pp], a, b[pp][0], b[pp][1]);
          mma_bf16(p[q][2 * pp + 1], a, b[pp][2], b[pp][3]);
        }
      }
    }

    cluster_wait();  // every peer has read its slots (the last sum)
    float4 keep[4];
#pragma unroll
    for (int q = 0; q < kClC; ++q)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float4 v =
            make_float4(p[q][nt][0], p[q][nt][1], p[q][nt][2], p[q][nt][3]);
        if (q == rank)
          keep[nt] = v;
        else
          *(cluster.map_shared_rank(slot(s_slot, rank, q), q) + nt * 32) = v;
      }
    cluster_arrive();  // this CTA's partials are out
    cluster_wait();    // every partial is in; every read of dgates done
    store_h(hv);
    // dh_{t-1} of this CTA's units: the four partials in rank order
#pragma unroll
    for (int q = 0; q < kClC; ++q)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float4 v = q == rank ? keep[nt] : slot(s_slot, q, rank)[nt * 32];
        if (q == 0) {
          dh[nt][0] = v.x;
          dh[nt][1] = v.y;
          dh[nt][2] = v.z;
          dh[nt][3] = v.w;
        } else {
          dh[nt][0] += v.x;
          dh[nt][1] += v.y;
          dh[nt][2] += v.z;
          dh[nt][3] += v.w;
        }
      }
    cluster_arrive();  // this CTA's slots are read
    __syncthreads();  // bf16 h_{t-1} whole
  }
  cluster_wait();  // no peer still writes into this CTA's shared memory
}

int fwd_cluster_bytes() {
  return kClH * kClLdw * 2 + 2 * kClBN * kClLdh * 2;
}

int bwd_cluster_bytes() {
  return kClH * kClLdw * 2 + kClBN * kClLdh * 2 +
         (kClC - 1) * kClBN * kClU * 4;
}

bool cluster_plan_ok(int n, int seq_len, int hidden, int csize, int bn,
                     int grid_x) {
  return n > 0 && seq_len > 0 && hidden == kClH && csize == kClC &&
         bn == kClBN && grid_x == (n + kClBN - 1) / kClBN * kClC;
}

cudaLaunchConfig_t cluster_config(int smem, int grid_x, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid_x, 2, 1);
  cfg.blockDim = dim3(kClThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kClC;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// clusters of `kernel` at `smem` bytes the card holds at once, or a
// negated cudaError
template <typename Kernel>
int cluster_occupancy(Kernel kernel, int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config(smem, kClC, 0, attr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return -(int)err;
  return clusters;
}

// the occupancy is asked once a process (a launch needs at least one
// cluster resident; kNoCluster where none fits)
template <typename Kernel, typename... Args>
int launch_cluster(Kernel kernel, int& resident, int smem, int grid_x,
                   cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (resident <= 0) {
    const int got = cluster_occupancy(kernel, smem);
    if (got < 0) return -got;
    if (got == 0) return kNoCluster;
    resident = got;
  }
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config(smem, grid_x, stream, attr);
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int g_fwd_resident = 0;
int g_bwd_resident = 0;
int g_infer_resident[2] = {0, 0};  // f32 xp, bf16 xp

// ---------------------------------------------------------------------------
// The f32 inference recurrence (nsp_lstm_infer_f32), the counterpart of the
// JAX package's lax.scan route in f32 (nanosnp_tpu/models/bilstm.py
// _bilstm_layer with use_pallas False), which no Pallas kernel computes:
// gates = xp_t + h_{t-1} . W_hh with f32 h and W, nothing rounded, f32
// gate and cell math with accurate expf / tanhf, both directions.
//
// The products run as FFMA on the CUDA cores: TF32 keeps 10 bits of
// mantissa and would break the parity the route exists for. One CTA per
// (direction, kF32BN = 64 batch rows), 256 threads:
// - h_{t-1} sits in shared memory transposed, [H][64] f32, two buffers by
//   step parity (one barrier a step where W is resident, else the ring's);
// - the 4H gate columns are taken in chunks of kF32Units = 64 units, all
//   four gates of each (256 columns); thread (rg, ug) owns batch rows
//   4 rg..4 rg+3 and units 4 ug..4 ug+3 of the chunk: 64 accumulators, a
//   float4 of h (four rows of one k) and four of W (four units of each
//   gate) from shared memory for 64 FFMA. The chunk loop is not unrolled,
//   so that its code (the product, and the accurate gate math of 16
//   values, some 2,400 instructions) exists once and stays in the
//   instruction cache (unrolled over H=256's four chunks it ran markedly
//   slower on an H100: PERF.md section 6). The thread's cell states,
//   c_state[kChunks][4][4] (kChunks = ceil(H / 64), the template
//   parameter), are then indexed by the chunk at run time and live in its
//   local memory, cached in L1;
// - W_hh streams from L2 in tiles of kF32KT = 16 k rows x 256 columns
//   (16 KiB) through a ring of kF32Stages by cp.async: the same cyclic
//   sequence of tiles every step, so the ring runs ahead across chunk and
//   step boundaries. Where a step's tiles fit the ring (H <= 64, W 64 KiB
//   a direction) they are loaded once and stay;
// - after a chunk's last tile each thread adds its xp (prefetched into L2
//   as the chunk starts), forms the gates, writes h_t to hs and to the
//   other h buffer.
// Units past H (H not a multiple of 64) read zeros of W and are not stored.
// Bound: FFMA, H^2 16 N L (two directions, 4H x H each), against the
// card's 67 TFLOP/s outside the tensor cores; xp in and hs out are under
// that at H >= 64.
constexpr int kF32BN = 64;
constexpr int kF32Threads = 256;
constexpr int kF32Units = 64;
constexpr int kF32KT = 16;
constexpr int kF32Stages = 4;
constexpr int kF32Tile = kF32KT * 4 * kF32Units;  // floats a W tile

int f32_smem_bytes(int hidden) {
  return (2 * hidden * kF32BN + kF32Stages * kF32Tile) * 4;
}

bool f32_plan_ok(int n, int seq_len, int hidden, int bn, int grid_x) {
  return n > 0 && seq_len > 0 && hidden >= 16 && hidden % 16 == 0 &&
         hidden <= 256 && bn == kF32BN &&
         grid_x == (n + kF32BN - 1) / kF32BN;
}

// W tile (chunk c, k tile kt) of w [H, 4H] f32 into dst [kF32KT][4][64]:
// row kk, gate g, unit u of the chunk is w[kt 16 + kk, g H + 64 c + u];
// units past H are zeros
__device__ __forceinline__ void f32_load_tile(float* dst,
                                              const float* __restrict__ w,
                                              int hidden, int c, int kt,
                                              int tid) {
#pragma unroll
  for (int p = 0; p < kF32Tile / 4 / kF32Threads; ++p) {
    const int i = tid + p * kF32Threads;  // 16-byte piece
    const int q = i & 15, g = (i >> 4) & 3, kk = i >> 6;
    const int u = c * kF32Units + 4 * q;
    const bool ok = u < hidden;
    cp_async16(dst + 4 * i,
               w + (size_t)(kt * kF32KT + kk) * 4 * hidden + g * hidden +
                   (ok ? u : 0),
               ok);
  }
}

template <int kChunks>
__global__ void __launch_bounds__(kF32Threads, kChunks == 1 ? 2 : 1)
    lstm_infer_f32_kernel(const float* __restrict__ xp,
                          const float* __restrict__ w_hh,
                          float* __restrict__ hs, int n, int seq_len,
                          int hidden) {
  extern __shared__ uint4 smem_u4[];
  float* s_h = reinterpret_cast<float*>(smem_u4);  // [2][H][kF32BN]
  float* s_w = s_h + 2 * hidden * kF32BN;          // [kF32Stages][tile]
  const int tid = threadIdx.x;
  const int ug = tid & 15, rg = tid >> 4;
  const int dir = blockIdx.y;
  const int n0 = blockIdx.x * kF32BN;
  const float* w = w_hh + (size_t)dir * hidden * 4 * hidden;
  const int k_tiles = hidden / kF32KT;
  const int tiles = kChunks * k_tiles;  // a step's
  const bool resident = tiles <= kF32Stages;

  for (int i = tid; i < hidden * kF32BN; i += kF32Threads) s_h[i] = 0.0f;
  if (resident) {
    for (int s = 0; s < tiles; ++s)
      f32_load_tile(s_w + s * kF32Tile, w, hidden, s / k_tiles,
                    s % k_tiles, tid);
    cp_async_commit();
    cp_async_wait_all();
  } else {
    for (int s = 0; s < kF32Stages - 1; ++s) {
      f32_load_tile(s_w + s * kF32Tile, w, hidden, s / k_tiles, s % k_tiles,
                    tid);
      cp_async_commit();
    }
  }

  float c_state[kChunks][4][4];
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) c_state[c][r][j] = 0.0f;

  int gidx = 0;  // tile of the stream being consumed
  for (int step = 0; step < seq_len; ++step) {
    const int t = dir == 0 ? step : seq_len - 1 - step;
    const float* h_prev = s_h + (step & 1) * hidden * kF32BN;
    float* h_next = s_h + ((step + 1) & 1) * hidden * kF32BN;
    if (resident) __syncthreads();
#pragma unroll 1
    for (int c = 0; c < kChunks; ++c) {
      const int u0 = c * kF32Units + 4 * ug;
      const bool unit_ok = u0 < hidden;
      const float* xp_row[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = n0 + 4 * rg + r;
        xp_row[r] = xp + (((size_t)(row < n ? row : 0) * seq_len + t) * 2 +
                          dir) * 4 * hidden + u0;
        if (unit_ok && row < n)
#pragma unroll
          for (int g = 0; g < 4; ++g)
            asm volatile("prefetch.global.L2 [%0];" ::"l"(xp_row[r] +
                                                          g * hidden));
      }
      float acc[4][4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int g = 0; g < 4; ++g)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[r][g][j] = 0.0f;

      for (int kt = 0; kt < k_tiles; ++kt, ++gidx) {
        int slot;
        if (resident) {
          slot = c * k_tiles + kt;
        } else {
          slot = gidx % kF32Stages;
          cp_async_wait<kF32Stages - 2>();
          __syncthreads();
          const int next = (gidx + kF32Stages - 1) % tiles;
          f32_load_tile(s_w + ((gidx + kF32Stages - 1) % kF32Stages) *
                                  kF32Tile,
                        w, hidden, next / k_tiles, next % k_tiles, tid);
          cp_async_commit();
        }
        const float* wt = s_w + slot * kF32Tile + 4 * ug;
        const float* ht = h_prev + kt * kF32KT * kF32BN + 4 * rg;
#pragma unroll
        for (int kk = 0; kk < kF32KT; ++kk) {
          const float4 hv =
              *reinterpret_cast<const float4*>(ht + kk * kF32BN);
          const float hr[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            const float4 wv = *reinterpret_cast<const float4*>(
                wt + (kk * 4 + g) * kF32Units);
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              acc[r][g][0] = fmaf(hr[r], wv.x, acc[r][g][0]);
              acc[r][g][1] = fmaf(hr[r], wv.y, acc[r][g][1]);
              acc[r][g][2] = fmaf(hr[r], wv.z, acc[r][g][2]);
              acc[r][g][3] = fmaf(hr[r], wv.w, acc[r][g][3]);
            }
          }
        }
      }

      if (unit_ok) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = n0 + 4 * rg + r;
          float x[4][4];
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            const float4 v = row < n ? __ldg(reinterpret_cast<const float4*>(
                                           xp_row[r] + g * hidden))
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
            x[g][0] = v.x;
            x[g][1] = v.y;
            x[g][2] = v.z;
            x[g][3] = v.w;
          }
          float h[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float gi = x[0][j] + acc[r][0][j];
            const float gf = x[1][j] + acc[r][1][j];
            const float gg = x[2][j] + acc[r][2][j];
            const float go = x[3][j] + acc[r][3][j];
            const float cn = sigmoid_f32(gf) * c_state[c][r][j] +
                             sigmoid_f32(gi) * tanhf(gg);
            c_state[c][r][j] = cn;
            h[j] = sigmoid_f32(go) * tanhf(cn);
            h_next[(u0 + j) * kF32BN + 4 * rg + r] = h[j];
          }
          if (row < n)
            *reinterpret_cast<float4*>(
                hs + (((size_t)row * seq_len + t) * 2 + dir) * hidden + u0) =
                make_float4(h[0], h[1], h[2], h[3]);
        }
      }
    }
  }
  if (!resident) cp_async_wait_all();
}

// the f32 kernel instance for H, or nullptr where no chunk count fits
using F32Kernel = void (*)(const float*, const float*, float*, int, int,
                           int);
F32Kernel f32_kernel(int hidden) {
  switch ((hidden + kF32Units - 1) / kF32Units) {
    case 1: return lstm_infer_f32_kernel<1>;
    case 2: return lstm_infer_f32_kernel<2>;
    case 3: return lstm_infer_f32_kernel<3>;
    case 4: return lstm_infer_f32_kernel<4>;
    default: return nullptr;
  }
}

}  // namespace

extern "C" int nsp_lstm_fwd(const void* xp, const void* wpk, void* hs,
                            void* cs, int n, int seq_len, int hidden,
                            void* stream) {
  return launch_fwd<true, float>(xp, wpk, hs, cs, n, seq_len, hidden, stream);
}

// xp f32 (xp_bf16 = 0) or bf16; hs [n, L, 2, H] f32; no cell-state stream
extern "C" int nsp_lstm_infer(const void* xp, int xp_bf16, const void* wpk,
                              void* hs, int n, int seq_len, int hidden,
                              void* stream) {
  if (xp_bf16)
    return launch_fwd<false, __nv_bfloat16>(xp, wpk, hs, nullptr, n, seq_len,
                                            hidden, stream);
  return launch_fwd<false, float>(xp, wpk, hs, nullptr, n, seq_len, hidden,
                                  stream);
}

extern "C" int nsp_lstm_bwd(const void* xp, const void* wpk_t,
                            const void* wpk_h, const void* hs, const void* cs,
                            const void* g, void* dxp, int n, int seq_len,
                            int hidden, void* stream) {
  if (bad_shape(n, seq_len, hidden)) return (int)cudaErrorInvalidValue;
  constexpr int kBN = 8 * kBwdNT;
  const size_t smem = (size_t)kBN *
                      ((hidden + kRowPad) + (4 * hidden + kRowPad)) *
                      sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      lstm_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + kBN - 1) / kBN, 2);
  lstm_bwd_kernel<<<grid, hidden / 16 * 32, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xp), static_cast<const uint4*>(wpk_t),
      static_cast<const uint4*>(wpk_h), static_cast<const float*>(hs),
      static_cast<const float*>(cs), static_cast<const float*>(g),
      static_cast<float*>(dxp), n, seq_len, hidden);
  return (int)cudaGetLastError();
}

// part: scratch [splits, 2, H, 4H] f32; dw [2, H, 4H] bf16. rows, splits,
// smem and grid_x are the wrapper's plan (ops/lstm_train.plan_dw), checked
// here: kPlanError where it does not match the shape.
extern "C" int nsp_lstm_dw(const void* dxp, const void* hs, void* part,
                           void* dw, int n, int seq_len, int hidden, int rows,
                           int splits, int smem, int grid_x, void* stream) {
  if (!dw_plan_ok(n, seq_len, hidden, rows, splits, grid_x) ||
      smem != dw_smem_bytes() || smem > kSmemMax)
    return kPlanError;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      lstm_dw_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  lstm_dw_tc_kernel<<<dim3(grid_x, splits, 2), kDwThreads, smem, st>>>(
      static_cast<const float*>(dxp), static_cast<const float*>(hs),
      static_cast<float*>(part), n, seq_len, hidden, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int size = 2 * hidden * 4 * hidden;
  lstm_dw_sum_kernel<<<(size + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<__nv_bfloat16*>(dw),
      size, splits);
  return (int)cudaGetLastError();
}

// The smem path. w_hh [2, H, 4H] bf16 as the model holds it (no packing);
// bn, smem and grid_x are the wrapper's plan (ops/lstm_train.plan_train),
// checked here: kPlanError where it does not match the shape.
extern "C" int nsp_lstm_fwd_smem(const void* xp, const void* w_hh, void* hs,
                                 void* cs, int n, int seq_len, int hidden,
                                 int bn, int smem, int grid_x, void* stream) {
  if (!smem_plan_ok(n, seq_len, hidden, bn, grid_x)) return kPlanError;
  return launch_fwd_smem<kSmemHidden, true, float>(
      xp, w_hh, hs, cs, n, seq_len, smem, grid_x,
      static_cast<cudaStream_t>(stream));
}

// Inference on the smem path: the forward without the c_t stream, xp f32
// (xp_bf16 = 0) or bf16 staged in its own dtype; w_hh as the model holds
// it, nothing packed; the plan (ops/lstm_train.plan_infer) checked as the
// training forward's, its shared memory infer_smem_bytes of the xp dtype.
extern "C" int nsp_lstm_infer_smem(const void* xp, int xp_bf16,
                                   const void* w_hh, void* hs, int n,
                                   int seq_len, int hidden, int bn, int smem,
                                   int grid_x, void* stream) {
  if (!smem_plan_ok(n, seq_len, hidden, bn, grid_x)) return kPlanError;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (xp_bf16)
    return launch_fwd_smem<kSmemHidden, false, __nv_bfloat16>(
        xp, w_hh, hs, nullptr, n, seq_len, smem, grid_x, st);
  return launch_fwd_smem<kSmemHidden, false, float>(
      xp, w_hh, hs, nullptr, n, seq_len, smem, grid_x, st);
}

// blocks of the smem inference forward (f32 or bf16 xp) an SM holds at
// once, or < 0 (a negated cudaError, or kPlanError for bytes that are not
// the kernel's)
extern "C" int nsp_lstm_infer_smem_occupancy(int xp_bf16, int smem) {
  if (smem != infer_smem_bytes(kSmemHidden, xp_bf16 ? 2 : 4))
    return kPlanError;
  return xp_bf16 ? infer_smem_occupancy<__nv_bfloat16>(smem)
                 : infer_smem_occupancy<float>(smem);
}

// part: scratch [grid_x, 2, H, 4H] f32 and dw [2, H, 4H] bf16, both unused
// without with_dw
extern "C" int nsp_lstm_bwd_smem(const void* xp, const void* w_hh,
                                 const void* hs, const void* cs,
                                 const void* g, void* dxp, void* part,
                                 void* dw, int with_dw, int n, int seq_len,
                                 int hidden, int bn, int smem, int grid_x,
                                 void* stream) {
  if (!smem_plan_ok(n, seq_len, hidden, bn, grid_x)) return kPlanError;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (with_dw)
    return launch_bwd_smem<kSmemHidden, true>(xp, w_hh, hs, cs, g, dxp, part,
                                              dw, n, seq_len, smem, grid_x,
                                              st);
  return launch_bwd_smem<kSmemHidden, false>(xp, w_hh, hs, cs, g, dxp, part,
                                             dw, n, seq_len, smem, grid_x, st);
}

// The cluster path. w_hh [2, H, 4H] bf16 as the model holds it; csize, bn,
// smem and grid_x are the wrapper's plan (ops/lstm_train.plan_train),
// checked here: kPlanError where it does not match the shape, kNoCluster
// where no cluster of it fits the card.
extern "C" int nsp_lstm_fwd_cluster(const void* xp, const void* w_hh,
                                    void* hs, void* cs, int n, int seq_len,
                                    int hidden, int csize, int bn, int smem,
                                    int grid_x, void* stream) {
  if (!cluster_plan_ok(n, seq_len, hidden, csize, bn, grid_x) ||
      smem != fwd_cluster_bytes() || smem > kSmemMax)
    return kPlanError;
  return launch_cluster(lstm_fwd_cluster_kernel<true, float>, g_fwd_resident,
                        smem, grid_x, static_cast<cudaStream_t>(stream),
                        static_cast<const float*>(xp),
                        static_cast<const __nv_bfloat16*>(w_hh),
                        static_cast<float*>(hs), static_cast<float*>(cs), n,
                        seq_len);
}

// Inference on the cluster path: the forward without the c_t stream, xp
// f32 (xp_bf16 = 0) or bf16; the plan (ops/lstm_train.plan_infer) as the
// training forward's, checked the same way.
extern "C" int nsp_lstm_infer_cluster(const void* xp, int xp_bf16,
                                      const void* w_hh, void* hs, int n,
                                      int seq_len, int hidden, int csize,
                                      int bn, int smem, int grid_x,
                                      void* stream) {
  if (!cluster_plan_ok(n, seq_len, hidden, csize, bn, grid_x) ||
      smem != fwd_cluster_bytes() || smem > kSmemMax)
    return kPlanError;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(w_hh);
  float* h = static_cast<float*>(hs);
  if (xp_bf16)
    return launch_cluster(lstm_fwd_cluster_kernel<false, __nv_bfloat16>,
                          g_infer_resident[1], smem, grid_x, st,
                          static_cast<const __nv_bfloat16*>(xp), w, h,
                          static_cast<float*>(nullptr), n, seq_len);
  return launch_cluster(lstm_fwd_cluster_kernel<false, float>,
                        g_infer_resident[0], smem, grid_x, st,
                        static_cast<const float*>(xp), w, h,
                        static_cast<float*>(nullptr), n, seq_len);
}

// the sweep alone: dW is lstm_dw_reduce's (nsp_lstm_dw)
extern "C" int nsp_lstm_bwd_cluster(const void* xp, const void* w_hh,
                                    const void* hs, const void* cs,
                                    const void* g, void* dxp, int n,
                                    int seq_len, int hidden, int csize,
                                    int bn, int smem, int grid_x,
                                    void* stream) {
  if (!cluster_plan_ok(n, seq_len, hidden, csize, bn, grid_x) ||
      smem != bwd_cluster_bytes() || smem > kSmemMax)
    return kPlanError;
  return launch_cluster(lstm_bwd_cluster_kernel, g_bwd_resident, smem, grid_x,
                        static_cast<cudaStream_t>(stream),
                        static_cast<const float*>(xp),
                        static_cast<const __nv_bfloat16*>(w_hh),
                        static_cast<const float*>(hs),
                        static_cast<const float*>(cs),
                        static_cast<const float*>(g), static_cast<float*>(dxp),
                        n, seq_len);
}

// clusters of the forward (sweep 0) or the sweep (1) the card holds at
// once at the plan's shared memory, or < 0 (a negated cudaError, or
// kPlanError for bytes that are not the kernel's)
extern "C" int nsp_lstm_cluster_occupancy(int sweep, int smem) {
  if (smem != (sweep ? bwd_cluster_bytes() : fwd_cluster_bytes()))
    return kPlanError;
  return sweep ? cluster_occupancy(lstm_bwd_cluster_kernel, smem)
               : cluster_occupancy(lstm_fwd_cluster_kernel<true, float>,
                                   smem);
}

// The f32 inference recurrence: xp [n, L, 2, 4H] f32 and w_hh [2, H, 4H]
// f32 as the model holds it, hs [n, L, 2, H] f32; bn, smem and grid_x are
// the wrapper's plan (ops/lstm_train.plan_infer_f32), checked here:
// kPlanError where it does not match the shape.
extern "C" int nsp_lstm_infer_f32(const void* xp, const void* w_hh, void* hs,
                                  int n, int seq_len, int hidden, int bn,
                                  int smem, int grid_x, void* stream) {
  if (!f32_plan_ok(n, seq_len, hidden, bn, grid_x) ||
      smem != f32_smem_bytes(hidden) || smem > kSmemMax)
    return kPlanError;
  const F32Kernel kernel = f32_kernel(hidden);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(grid_x, 2), kF32Threads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xp), static_cast<const float*>(w_hh),
      static_cast<float*>(hs), n, seq_len, hidden);
  return (int)cudaGetLastError();
}

// CTAs of the f32 inference recurrence at width `hidden` an SM holds at
// once (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or < 0 (a negated
// cudaError, or kPlanError for bytes that are not the kernel's)
extern "C" int nsp_lstm_infer_f32_occupancy(int hidden, int smem) {
  if (!f32_plan_ok(1, 1, hidden, kF32BN, 1) || smem != f32_smem_bytes(hidden))
    return kPlanError;
  const F32Kernel kernel = f32_kernel(hidden);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      kF32Threads, smem);
  if (err != cudaSuccess) return -(int)err;
  return blocks;
}
