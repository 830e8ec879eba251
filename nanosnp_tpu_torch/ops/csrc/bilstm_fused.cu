// The pileup encoder's two opt-in fusions, for Hopper (sm_90a). Plain C
// interface, loaded with ctypes.
//
// Replaces the Pallas TPU kernels of nanosnp_tpu/ops/pallas_lstm.py:
//   nsp_bilstm_center_head <- _enc_center_head_kernel: the center layer
//       (fused in-projection + recurrence, only h at t = L//2), then the
//       head on that state inside the kernel,
//         feat   = Wp . bf16([h_dir0 ; h_dir1]) + bp
//         feat   = tanh(Wd . bf16(feat) + bd)
//         logits = Wh . bf16(feat) + bh           -> [n, rows] f32
//   nsp_bilstm2_center     <- _enc2_center_kernel: both encoder layers in
//       one program, bf16 between them, layer 2 emitting only its state at
//       t = L//2 -> [n, 2H] f32. Layer 2 runs only the L//2 + 1 steps each
//       direction needs (the Pallas kernel ran all L).
//
// Math (the cast sites of the Pallas kernels and of bilstm.cu):
//   gates_t = [w_ih | w_hh]^T . [x_t ; bf16(h_{t-1})] + b  (bf16 operands,
//   f32 accumulation), gate order i, f, g, o; f32 gate and cell math; h
//   and c start at zero; direction 1 walks time backwards; bf16 between the
//   layers; the head's products in bf16 with f32 accumulation, f32 bias
//   adds and tanh.
//
// Design. Both kernels run on clusters of two CTAs, one cluster a tile of
// BN batch rows, CTA rank d running direction d with bilstm.cu's fused
// layer code (bilstm_layer.cuh fused_layer: the direction's packed weights
// copied into shared memory once, x_{t+1} fetched by cp.async during step
// t, double-buffered h, ldmatrix B fragments, the SFU gate math). What
// needs both directions in one place goes through the cluster:
//   - nsp_bilstm2_center: layer 1 writes its bf16 h_t of every step into a
//     scratch [n, L, 2H] in device memory (the wrapper's torch.empty), each
//     CTA its half of the columns; a fence and the cluster barrier (arrive
//     .release, wait .acquire) order both halves before layer 2 fetches its
//     input rows from there by cp.async (.cg: through L2, never a stale
//     L1 line), as a layer fetches x. Both layers' weights come into shared
//     memory once, at the start: 48 + 96 KiB at D 18, H 64. Layer 2's input
//     tiles then lie over layer 1's weights and tiles, dead by then.
//   - nsp_bilstm_center_head: at t = L//2 each CTA sends its bf16 h_d of
//     rows [0, BN/2) to CTA 0 and of rows [BN/2, BN) to CTA 1 through
//     distributed shared memory, so each holds the bf16 center [BN/2, 2H]
//     of its half of the rows, and runs the whole head on them: each
//     output's K sum whole in one warp. One exchange of H BN / 2 bf16 each
//     way; the head's weights come as packed A fragments from L2, each
//     m-tile once per 32 rows.
// The Pallas kernel kept layer 1's states of both directions in VMEM. Here
// a slab row is L 2H 2 bytes (8,448 at L 33, H 64), and a tile worth
// running does not fit beside layer 2's 96 KiB of weights: fusing saves a
// launch and the grid-wide wait between layers, not bytes (the scratch's
// 69 MB at N=8192 mostly stays in the 50 MB L2 between write and read).
//
// What bounds them on this card: the latency of L + L//2 + 1 dependent
// steps (two layers) or L//2 + 1 steps and three short products (center +
// head), each step a [4H, Kp] x [Kp, BN] tensor-core product and the gate
// math; the operation count over the bf16 peak gives the bound (0.05 /
// 0.03 ms at N=8192), far below it. Weights read from L2 per call:
// CTAs x one direction's weights, 128 x 144 KiB = 18.9 MB for the two
// layers at N=8192 (BN 128), in place of 3.3 GB when every step re-read
// them for every 16 rows.

#include "bilstm_layer.cuh"

namespace {

constexpr int kMaxThreads = 512;  // 16 warps: (H/16) x (BN/32)
// k-tiles of the layer product unrolled (fused_layer). The two-layer
// kernel holds two layer loops in one function at 128 registers a thread:
// at 2 or 4 ptxas spills there (16 and 680 bytes at H 64), at 1 it does
// not, at no cost in time on the card (PERF.md §6). The center + head
// kernel keeps bilstm.cu's 4.
constexpr int kTwoLayerUnroll = 1;
constexpr int kHeadUnroll = 4;

// One dense layer of the head on `rows` (a multiple of 32) batch rows:
// y = W . in + bias, W as packed A fragments [m_dim/16, k_dim/16, 32, 8]
// bf16 in global memory, `in` a bf16 tile [rows][ld_in] in shared memory.
// Items (m-tile, 32 rows) are dealt to the warps in turn; each sums its
// whole K in k order. emit(batch row, output unit, value) stores.
template <typename Emit>
__device__ __forceinline__ void head_dense(const uint4* __restrict__ w_pk,
                                           const float* __restrict__ bias,
                                           const __nv_bfloat16* s_in,
                                           int ld_in, int k_dim, int m_dim,
                                           int rows, Emit emit) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int grp = lane >> 2;
  const int tig = lane & 3;
  const int k_tiles = k_dim / 16;
  const int groups = rows / 32;
  const __nv_bfloat16* b_lane = s_in + ldmatrix_offset(lane, ld_in);
  for (int item = warp; item < m_dim / 16 * groups; item += n_warps) {
    const int mt = item / groups;
    const int r0 = (item - mt * groups) * 32;
    const float b_lo = bias[mt * 16 + grp];
    const float b_hi = bias[mt * 16 + grp + 8];
    float acc[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      acc[nt][0] = b_lo;
      acc[nt][1] = b_lo;
      acc[nt][2] = b_hi;
      acc[nt][3] = b_hi;
    }
    const uint4* wa = w_pk + (size_t)mt * k_tiles * 32 + lane;
    const __nv_bfloat16* b = b_lane + r0 * ld_in;
#pragma unroll 4
    for (int kt = 0; kt < k_tiles; ++kt) {
      const uint4 a = __ldg(wa + kt * 32);
#pragma unroll
      for (int p = 0; p < kNT / 2; ++p) {
        uint32_t bf[4];
        ldmatrix_x4(bf, b + p * 16 * ld_in + kt * 16);
        mma_bf16(acc[2 * p], a, bf[0], bf[1]);
        mma_bf16(acc[2 * p + 1], a, bf[2], bf[3]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        emit(r0 + nt * 8 + 2 * tig + (e & 1),
             mt * 16 + grp + (e < 2 ? 0 : 8), acc[nt][e]);
  }
}

__host__ __device__ __forceinline__ int pad16(int v) {
  return (v + 15) / 16 * 16;
}

// Dynamic shared memory of each kernel (ops/bilstm_fused.py states the
// same sums in its plans).
int two_layer_smem(int d_x, int hidden, int bn) {
  const int d_pad = pad16(d_x);
  const int w1 = 4 * hidden * (d_pad + hidden) * 2;
  const int x1 = 2 * bn * (d_pad + kRowPad) * 2;
  const int x2 = 2 * bn * (2 * hidden + kRowPad) * 2;
  const int region_a = w1 + x1 > x2 ? w1 + x1 : x2;
  return region_a + 4 * hidden * 3 * hidden * 2 +
         2 * bn * (hidden + kRowPad) * 2;
}

int center_head_smem(int d_x, int hidden, int p_dim, int q_dim, int bn) {
  const int d_pad = pad16(d_x);
  const int half = bn / 2;
  const int x = 2 * bn * (d_pad + kRowPad);
  const int head = half * (p_dim + q_dim + 2 * kRowPad);
  return 4 * hidden * (d_pad + hidden) * 2 + (x > head ? x : head) * 2 +
         2 * bn * (hidden + kRowPad) * 2 + half * (2 * hidden + kRowPad) * 2;
}

// The shared memory of bilstm2_center_kernel (two_layer_smem): region A
// holds layer 1's weights then its x tiles [2][bn][Dp + 8], later layer
// 2's x tiles [2][bn][2H + 8]; then layer 2's weights; then h [2][bn][H + 8]
// (both layers).
struct TwoLayerSmem {
  int w1_u4, w2_u4;
  uint4* w1;
  uint4* w2;
  __nv_bfloat16* x1;
  __nv_bfloat16* x2;
  __nv_bfloat16* h;
};

__device__ __forceinline__ TwoLayerSmem two_layer_layout(uint4* base,
                                                         int d_x, int hidden,
                                                         int bn) {
  const int d_pad = pad16(d_x);
  TwoLayerSmem s;
  s.w1_u4 = 4 * hidden * (d_pad + hidden) / 8;
  s.w2_u4 = 4 * hidden * 3 * hidden / 8;
  const int x1_u4 = 2 * bn * (d_pad + kRowPad) / 8;
  const int x2_u4 = 2 * bn * (2 * hidden + kRowPad) / 8;
  const int a_u4 = s.w1_u4 + x1_u4 > x2_u4 ? s.w1_u4 + x1_u4 : x2_u4;
  s.w1 = base;
  s.x1 = reinterpret_cast<__nv_bfloat16*>(base + s.w1_u4);
  s.x2 = reinterpret_cast<__nv_bfloat16*>(base);
  s.w2 = base + a_u4;
  s.h = reinterpret_cast<__nv_bfloat16*>(base + a_u4 + s.w2_u4);
  return s;
}

// Two layers, center only.
// x    [n, L, d_x] bf16 (L odd, d_x even)
// wpk1 [2, 4H/16, (Dp + H)/16, 32, 8] bf16, b1 [2, 4H] f32
// wpk2 [2, 4H/16, 3H/16, 32, 8] bf16, b2 [2, 4H] f32
// mid  [n, L, 2H] bf16 scratch: layer 1's output
// out  [n, 2H] f32
// grid 2 ceil(n / bn), cluster (2, 1, 1), block (H/16) x (bn/32) warps;
// CTA rank d runs direction d of both layers; shared: TwoLayerSmem
__global__ void __launch_bounds__(kMaxThreads, 1)
bilstm2_center_kernel(const __nv_bfloat16* __restrict__ x,
                      const uint4* __restrict__ wpk1,
                      const float* __restrict__ b1,
                      const uint4* __restrict__ wpk2,
                      const float* __restrict__ b2,
                      __nv_bfloat16* __restrict__ mid,
                      float* __restrict__ out, int n, int seq_len, int d_x,
                      int hidden, int bn) {
  extern __shared__ uint4 smem_u4[];
  {
    const int dir = blockIdx.x & 1;  // the cluster rank
    const TwoLayerSmem s = two_layer_layout(smem_u4, d_x, hidden, bn);
    // both layers' weights of this direction, once
    cp_async_layer_weights(s.w1, wpk1 + (size_t)dir * s.w1_u4, hidden, d_x);
    cp_async_layer_weights(s.w2, wpk2 + (size_t)dir * s.w2_u4, hidden,
                           2 * hidden);
    cp_async_commit();
    fused_layer<false, true, __nv_bfloat16, kTwoLayerUnroll>(
        x, s.w1, b1 + dir * 4 * hidden, mid, s.x1, s.h, n, seq_len, d_x,
        hidden, bn, dir, (blockIdx.x >> 1) * bn);
  }
  __threadfence();  // this CTA's half of every mid row is written ...
  cluster_arrive();
  cluster_wait();   // ... and so is the peer's; layer 1 is done in both
  {
    const int dir = blockIdx.x & 1;
    const TwoLayerSmem s = two_layer_layout(smem_u4, d_x, hidden, bn);
    fused_layer<true, true, float, kTwoLayerUnroll>(
        mid, s.w2, b2 + dir * 4 * hidden, out, s.x2, s.h, n, seq_len,
        2 * hidden, hidden, bn, dir, (blockIdx.x >> 1) * bn);
  }
}

// Center layer + head.
// x     [n, L, d_x] bf16 (L odd, d_x even)
// wpk   [2, 4H/16, (Dp + H)/16, 32, 8] bf16, bias [2, 4H] f32
// wp_pk [P/16, 2H/16, 32, 8], wd_pk [Q/16, P/16, 32, 8],
// wh_pk [R/16, Q/16, 32, 8] bf16 (R = head rows zero-padded to 16);
// bp [P], bd [Q], bh [R] f32
// out   [n, n_out] f32, n_out <= R
// grid 2 ceil(n / bn), cluster (2, 1, 1), block (H/16) x (bn/32) warps; CTA
// d runs direction d, then the head on rows [d bn/2, (d + 1) bn/2) of the
// cluster's tile
// shared: weights; x [2][bn][Dp + 8], after the layer the head's bf16
//         tiles [bn/2][P + 8] and [bn/2][Q + 8]; h [2][bn][H + 8]; the
//         center [bn/2][2H + 8]
__global__ void __launch_bounds__(kMaxThreads, 1)
bilstm_center_head_kernel(const __nv_bfloat16* __restrict__ x,
                          const uint4* __restrict__ wpk,
                          const float* __restrict__ bias,
                          const uint4* __restrict__ wp_pk,
                          const float* __restrict__ bp,
                          const uint4* __restrict__ wd_pk,
                          const float* __restrict__ bd,
                          const uint4* __restrict__ wh_pk,
                          const float* __restrict__ bh,
                          float* __restrict__ out, int n, int seq_len,
                          int d_x, int hidden, int p_dim, int q_dim,
                          int r_dim, int n_out, int bn) {
  extern __shared__ uint4 smem_u4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int dir = (int)cluster.block_rank();
  const int n0 = (blockIdx.x >> 1) * bn;
  const int half = bn / 2;
  const int d_pad = pad16(d_x);
  const int ldh = hidden + kRowPad;
  const int ldc = 2 * hidden + kRowPad;
  const int ldp = p_dim + kRowPad;
  const int ldq = q_dim + kRowPad;
  const int w_u4 = 4 * hidden * (d_pad + hidden) / 8;
  const int x_bf = 2 * bn * (d_pad + kRowPad);
  const int head_bf = half * (ldp + ldq);
  const int x_u4 = (x_bf > head_bf ? x_bf : head_bf) / 8;
  uint4* s_w = smem_u4;
  __nv_bfloat16* s_x = reinterpret_cast<__nv_bfloat16*>(smem_u4 + w_u4);
  __nv_bfloat16* s_h =
      reinterpret_cast<__nv_bfloat16*>(smem_u4 + w_u4 + x_u4);
  __nv_bfloat16* s_ctr = s_h + 2 * bn * ldh;

  cp_async_layer_weights(s_w, wpk + (size_t)dir * w_u4, hidden, d_x);
  cp_async_commit();
  cluster_arrive();  // this CTA runs: its peer may write into s_ctr
  const int steps = fused_layer<true, false, float, kHeadUnroll>(
      x, s_w, bias + dir * 4 * hidden, nullptr, s_x, s_h, n, seq_len, d_x,
      hidden, bn, dir, n0);
  __syncthreads();  // bf16 h at t = L//2 is whole in s_h
  cluster_wait();   // the peer runs too

  // each half of the rows to its CTA, at this direction's columns
  const __nv_bfloat16* s_fin = s_h + (steps & 1) * bn * ldh;
  const int per_row = hidden / 8;
  for (int i = threadIdx.x; i < bn * per_row; i += blockDim.x) {
    const int r = i / per_row;
    const int k = (i - r * per_row) * 8;
    const int to = r < half ? 0 : 1;
    __nv_bfloat16* dst = s_ctr + (r - to * half) * ldc + dir * hidden + k;
    *reinterpret_cast<uint4*>(cluster.map_shared_rank(dst, to)) =
        *reinterpret_cast<const uint4*>(s_fin + r * ldh + k);
  }
  cluster_arrive();
  cluster_wait();  // both halves of this CTA's center rows are here

  __nv_bfloat16* s_p = s_x;
  __nv_bfloat16* s_q = s_x + half * ldp;
  head_dense(wp_pk, bp, s_ctr, ldc, 2 * hidden, p_dim, half,
             [&](int r, int j, float v) {
               s_p[r * ldp + j] = __float2bfloat16_rn(v);
             });
  __syncthreads();
  head_dense(wd_pk, bd, s_p, ldp, p_dim, q_dim, half,
             [&](int r, int j, float v) {
               s_q[r * ldq + j] = __float2bfloat16_rn(tanhf(v));
             });
  __syncthreads();
  const int row0 = n0 + dir * half;
  head_dense(wh_pk, bh, s_q, ldq, q_dim, r_dim, half,
             [&](int r, int j, float v) {
               const int row = row0 + r;
               if (row < n && j < n_out) out[(size_t)row * n_out + j] = v;
             });
}

cudaLaunchConfig_t pair_config(int hidden, int bn, int smem, int grid_x,
                               cudaStream_t stream,
                               cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid_x, 1, 1);
  cfg.blockDim = dim3(hidden / 16 * (bn / 32) * 32, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

bool layer_plan_ok(int n, int seq_len, int d_x, int hidden, int bn,
                   int smem, int grid_x) {
  return n > 0 && seq_len > 0 && seq_len % 2 == 1 && d_x > 0 &&
         d_x % 2 == 0 && hidden > 0 && hidden % 16 == 0 && bn > 0 &&
         bn % 32 == 0 && hidden / 16 * (bn / 32) * 32 <= kMaxThreads &&
         smem <= kSmemMax && grid_x == 2 * ((n + bn - 1) / bn);
}

// active 2-CTA clusters of `kernel` at this plan, or < 0 on an error
template <typename Kernel>
int pair_occupancy(Kernel kernel, int hidden, int bn, int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = pair_config(hidden, bn, smem, 2, 0, attr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return -(int)err;
  return clusters;
}

template <typename Kernel, typename... Args>
int launch_pair(Kernel kernel, int hidden, int bn, int smem, int grid_x,
                void* stream, Args... args) {
  const int clusters = pair_occupancy(kernel, hidden, bn, smem);
  if (clusters < 0) return -clusters;
  if (clusters == 0) return kNoCluster;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = pair_config(
      hidden, bn, smem, grid_x, static_cast<cudaStream_t>(stream), attr);
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

bool head_plan_ok(int hidden, int p_dim, int q_dim, int r_dim, int n_out,
                  int bn) {
  return bn % 64 == 0 && p_dim > 0 && p_dim % 16 == 0 && q_dim > 0 &&
         q_dim % 16 == 0 && r_dim > 0 && r_dim % 16 == 0 && n_out > 0 &&
         n_out <= r_dim && hidden > 0;
}

}  // namespace

extern "C" int nsp_bilstm_center_head(
    const void* x, const void* wpk, const void* b, const void* wp_pk,
    const void* bp, const void* wd_pk, const void* bd, const void* wh_pk,
    const void* bh, void* out, int n, int seq_len, int d_x, int hidden,
    int p_dim, int q_dim, int r_dim, int n_out, int bn, int smem, int grid_x,
    void* stream) {
  if (!layer_plan_ok(n, seq_len, d_x, hidden, bn, smem, grid_x) ||
      !head_plan_ok(hidden, p_dim, q_dim, r_dim, n_out, bn) ||
      smem != center_head_smem(d_x, hidden, p_dim, q_dim, bn))
    return kPlanError;
  return launch_pair(
      bilstm_center_head_kernel, hidden, bn, smem, grid_x, stream,
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint4*>(wpk),
      static_cast<const float*>(b), static_cast<const uint4*>(wp_pk),
      static_cast<const float*>(bp), static_cast<const uint4*>(wd_pk),
      static_cast<const float*>(bd), static_cast<const uint4*>(wh_pk),
      static_cast<const float*>(bh), static_cast<float*>(out), n, seq_len,
      d_x, hidden, p_dim, q_dim, r_dim, n_out, bn);
}

extern "C" int nsp_bilstm2_center(const void* x, const void* wpk1,
                                  const void* b1, const void* wpk2,
                                  const void* b2, void* mid, void* out, int n,
                                  int seq_len, int d_x, int hidden, int bn,
                                  int smem, int grid_x, void* stream) {
  if (!layer_plan_ok(n, seq_len, d_x, hidden, bn, smem, grid_x) ||
      smem != two_layer_smem(d_x, hidden, bn))
    return kPlanError;
  return launch_pair(
      bilstm2_center_kernel, hidden, bn, smem, grid_x, stream,
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint4*>(wpk1),
      static_cast<const float*>(b1), static_cast<const uint4*>(wpk2),
      static_cast<const float*>(b2), static_cast<__nv_bfloat16*>(mid),
      static_cast<float*>(out), n, seq_len, d_x, hidden, bn);
}

// active clusters of a plan on this card (head: the center + head kernel,
// else the two-layer one), or < 0 on an error
extern "C" int nsp_bilstm_fused_occupancy(int head, int d_x, int hidden,
                                          int p_dim, int q_dim, int bn,
                                          int smem) {
  if (head ? smem != center_head_smem(d_x, hidden, p_dim, q_dim, bn)
           : smem != two_layer_smem(d_x, hidden, bn))
    return kPlanError;
  return head ? pair_occupancy(bilstm_center_head_kernel, hidden, bn, smem)
              : pair_occupancy(bilstm2_center_kernel, hidden, bn, smem);
}
