// Bidirectional LSTM layer for Hopper (sm_90a). Plain C interface, loaded
// with ctypes.
//
// Replaces the Pallas TPU kernels of nanosnp_tpu/ops/pallas_lstm.py:
//   _enc_stream_kernel, _enc_stream_kfused_kernel (every h_t out, bf16 for
//   inner layers, f32 last) and _enc_center_kernel,
//   _enc_center_kfused_kernel (only h at t = L//2, f32). The K-fusion of
//   the kfused kernels only filled the TPU's 128-deep matrix tile; it
//   computes the same function.
//
// Math (the Pallas kernels' cast sites):
//   gates_t = w_ih^T . x_t + w_hh^T . bf16(h_{t-1}) + b   (bf16 operands,
//             f32 accumulation), gate order i, f, g, o, one folded bias;
//   c_t = sig(f) c_{t-1} + sig(i) tanh(g);  h_t = sig(o) tanh(c_t)  (f32);
//   h and c start at zero; direction 1 walks time backwards, reading and
//   writing in true time order; the center variant stops where its
//   direction reaches t = L//2. D is zero-padded to a multiple of 16 (Dp)
//   in the packed weights, and those columns meet zeros in x.
//
// Two paths; the wrapper (ops/bilstm.py plan_layer) picks one per shape and
// passes its plan as ints, which the launchers check.
//
// 1. Fused, one block per (direction, tile of BN rows): nsp_bilstm_stream /
//    nsp_bilstm_center. Taken where a direction's packed [4H, Kp] weights
//    (Kp = Dp + H) fit in shared memory with the tiles: the pileup model's
//    H=64 layers, 48 KiB (D 18) and 96 KiB (D 128). The weights are copied
//    into shared memory once per block, each unit group's four gates side
//    by side, and read from there every step. x_{t+1} is fetched with
//    cp.async into a second buffer while step t computes, and h is double
//    buffered, so a step has one barrier; a block of 128 rows steps as two
//    groups of 64, each on its own named barrier. The layer's device code
//    is bilstm_layer.cuh fused_layer, which bilstm_fused.cu's kernels and
//    the probe (bilstm_probe.cu, its knock-outs) share.
//    Bound on the card: L
//    dependent steps, each a short [4H, Kp] x [Kp, BN] tensor-core product
//    plus gate math; the latency of a step, not bytes or operations (the bound,
//    0.01-0.03 ms, is far below it). Weight bytes read from L2 per call:
//    blocks x 4H Kp 2, once per block: 12 MiB at N=8192 (D 18 with BN 64,
//    D 128 with BN 128), in place of 0.8 GB when they were re-read every
//    step for every 32 rows (the first design of this kernel).
//
// 2. Split, for H=256 (the haplotype model), where one direction's weights
//    (736 KiB at D 105, 1.5 MiB at D 512) do not fit an SM:
//    a. nsp_bilstm_inproj: xp = x . w_ih + b for every (direction, step)
//       the recurrence runs (center: t <= L//2 for direction 0, t >= L//2
//       for direction 1), one GEMM on wgmma (bf16 in, f32 accumulate): a
//       block is 4 warpgroups, 256 gate rows x 128 batch rows; A (w_ih^T)
//       goes from the packed fragments into registers, B (x rows) into
//       shared memory as 8x8 core matrices, both through a 4-stage
//       cp.async ring of 64-deep k-chunks, three chunks in flight. xp is
//       f32 in the accumulator's fragment order, [2, T, Np/8, 4H/16, 32
//       lanes, 4] (T steps a direction, Np = N rounded up to 128): one
//       float4 a lane per 16x8 tile, so the GEMM writes and the recurrence
//       reads 512 contiguous bytes a warp. w_ih is read only here: once per
//       output tile, 8 bytes of L2 reads per xp element (4.4 GB at N=8192,
//       L 33, D 512), x 4 bytes; xp is written once (2.2 GB). Bound: those
//       bytes, L2 -> SM and the write to device memory, not the tensor
//       cores (0.57 ms of bf16 work at D 512).
//    b. nsp_bilstm_cluster: the recurrence on a thread-block cluster of C
//       CTAs per (direction, tile of BN rows). CTA r owns hidden units
//       [r H/C, (r+1) H/C) with all four gates, so the cell update stays in
//       registers; its w_hh slice [4H/C, H] (128 KiB at C 4) is copied into
//       shared memory once, at kernel start. Each step reads its xp slice
//       into registers (the next step's is loaded while this one
//       computes), runs [4H/C, H] x [H, BN] from shared memory, writes its
//       slice of bf16 h_t into its own h buffer, copies that slice into
//       every peer's buffer through distributed shared memory as 16-byte
//       pieces, and arrives at the cluster barrier; a bf16 output leaves
//       the shared slice as 16-byte rows while the peers catch up, and the
//       next step waits at the barrier. Two h buffers by step parity, so no
//       CTA overwrites an h_{t-1} a peer still reads. w_hh read per call:
//       clusters x 4H H 2 (256 x 512 KiB = 128 MiB at N=8192, BN 64), in
//       place of blocks x steps x 1.5 MiB (26.6 GB at pileup L2) when
//       every step re-read them for every 32 rows.
//       Bound: L dependent steps, each a chain of latencies (barrier, xp,
//       product, gate math, exchange), in N/BN x 2 / (clusters resident)
//       rounds; reading xp back (0.66 ms at N=8192, L 33) is under it.
//
// Gate math on the SFU (bilstm_layer.cuh, shared with bilstm_fused.cu):
// sigmoid within 1e-6 and tanh within 2e-6 of the exact values.

#include "bilstm_layer.cuh"

namespace {

// in-projection GEMM tiles
constexpr int kGemmM = 256;       // gate rows a block: 4 warpgroups x 64
constexpr int kGemmN = 128;       // batch rows a block
constexpr int kGemmKT = 4;        // k-tiles of 16 a stage
constexpr int kGemmStages = 4;
constexpr int kGemmStageA = kGemmM / 16 * kGemmKT * 32;  // uint4 a stage
constexpr int kGemmStageB = kGemmN * kGemmKT * 16 * 2 / 16;
constexpr int kGemmSmem = kGemmStages * (kGemmStageA + kGemmStageB) * 16;
// B stage: core matrix (row group g, k group q) at (2 kGemmKT g + q) 128
// bytes
constexpr int kDescLbo = 128;                 // next k group
constexpr int kDescSbo = 2 * kGemmKT * 128;   // next row group

// acc[g][nt] += A(gate g, k-tiles [ka, ka + count)) . B(the warp's 32 rows,
// k-tiles [0, count) of the shared tile at b). wg[g] points at the lane's
// piece of gate g's first packed A tile; b is this thread's ldmatrix row
// (tile + warp row offset + ldmatrix_offset).
__device__ __forceinline__ void mma_rows(float (&acc)[4][kNT][4],
                                         const uint4* const (&wg)[4], int ka,
                                         const __nv_bfloat16* b, int ld,
                                         int count) {
#pragma unroll 4
  for (int kt = 0; kt < count; ++kt) {
    uint4 a[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) a[g] = wg[g][(ka + kt) * 32];
#pragma unroll
    for (int p = 0; p < kNT / 2; ++p) {
      uint32_t bf[4];
      ldmatrix_x4(bf, b + p * 16 * ld + kt * 16);
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        mma_bf16(acc[g][2 * p], a[g], bf[0], bf[1]);
        mma_bf16(acc[g][2 * p + 1], a[g], bf[2], bf[3]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 1. Fused layer, weights in shared memory (C = 1)
//
// x     [n, seq_len, d_x] bf16, d_x even (the wrapper pads an odd D)
// wpk   [2, 4H/16, Kp/16, 32 lanes, 8] bf16 (ops/bilstm.py pack_weights)
// bias  [2, 4H] f32
// out   kCenter ? [n, 2H] f32 : [n, seq_len, 2H] OutT (dir 0 in [0, H))
// block = (H/16) x (bn/32) warps (bilstm_layer.cuh fused_layer); grid =
// (ceil(n / bn), 2 directions)
// shared: weights 4H Kp, then x [2][bn][Dp + 8], then h [2][bn][H + 8]
template <bool kCenter, typename OutT>
__global__ void __launch_bounds__(512)
bilstm_fused_kernel(const __nv_bfloat16* __restrict__ x,
                    const uint4* __restrict__ wpk,
                    const float* __restrict__ bias, OutT* __restrict__ out,
                    int n, int seq_len, int d_x, int hidden, int bn) {
  extern __shared__ uint4 smem_u4[];
  const int d_pad = (d_x + 15) / 16 * 16;
  const int w_u4 = 4 * hidden * (d_pad + hidden) / 8;
  uint4* s_w = smem_u4;
  __nv_bfloat16* s_x = reinterpret_cast<__nv_bfloat16*>(smem_u4 + w_u4);
  __nv_bfloat16* s_h = s_x + 2 * bn * (d_pad + kRowPad);
  const int dir = blockIdx.y;

  // the direction's weights, once
  cp_async_layer_weights(s_w, wpk + (size_t)dir * w_u4, hidden, d_x);
  cp_async_commit();
  fused_layer<kCenter, true, OutT, 4>(x, s_w, bias + dir * 4 * hidden, out,
                                      s_x, s_h, n, seq_len, d_x, hidden, bn,
                                      dir, blockIdx.x * bn);
}

template <bool kCenter, typename OutT>
int launch_fused(const void* x, const void* wpk, const void* b, void* out,
                 int n, int seq_len, int d_x, int hidden, int bn, int smem,
                 int grid_x, cudaStream_t stream) {
  if (!fused_plan_ok(n, seq_len, d_x, hidden, bn, smem, grid_x))
    return kPlanError;
  const int warps = hidden / 16 * (bn / 32);
  auto kernel = bilstm_fused_kernel<kCenter, OutT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(grid_x, 2), warps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint4*>(wpk),
      static_cast<const float*>(b), static_cast<OutT*>(out), n, seq_len, d_x,
      hidden, bn);
  return (int)cudaGetLastError();
}

// wgmma (Hopper's warpgroup product): D[64 x 128] += A[64 x 16] B[16 x 128]
// over the four warps of a warpgroup, A from registers (warp w holds rows
// 16w.., in the mma.m16n8k16 A-fragment layout, so a packed tile is one
// uint4 a lane), B from shared memory through a matrix descriptor; D in
// registers, per 8 columns j the m16n8 accumulator layout (d[4j..4j+3]).
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], const uint4& a,
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
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// an empty asm that reads and writes the registers: the compiler keeps
// their values where they are up to here, so registers that an issued
// wgmma still reads are not reused before its wait
template <int kN>
__device__ __forceinline__ void reg_fence(uint4 (&a)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i)
    asm volatile("" : "+r"(a[i].x), "+r"(a[i].y), "+r"(a[i].z), "+r"(a[i].w)
                 :: "memory");
}

// cp.async writes (the generic proxy) visible to wgmma's reads (the async
// proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// descriptor of a K-major B tile without swizzle: 8-row x 16-byte core
// matrices, k-adjacent ones kLbo bytes apart, n-adjacent ones kSbo apart
template <int kLbo, int kSbo>
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(kLbo >> 4) << 16) | ((uint64_t)(kSbo >> 4) << 32);
}

// ---------------------------------------------------------------------------
// 2a. In-projection GEMM
//
// x     [n, seq_len, d_x] bf16, d_x a multiple of 8 (the wrapper pads)
// wpk   as above; k-tiles [0, Dp/16) of each row are w_ih^T
// bias  [2, 4H] f32
// xp    [2, T, n_pad/8, 4H/16, 32, 4] f32: direction d, time index ti
//       (t = ti for d 0; t = t1_lo + ti for d 1), n-tile, m-tile, lane,
//       the lane's four accumulator values of that 16x8 tile
// grid  (n_pad/128, 4H/256, 2T); block 512 threads, 4 warpgroups:
//       warpgroup w computes gate rows [64 w, 64 w + 64) of the block's 256
//       for all 128 batch rows (wgmma m64n128k16), its warp j the 16-row
//       m-tile 4 w + j
__global__ void __launch_bounds__(512, 1)
bilstm_inproj_kernel(const __nv_bfloat16* __restrict__ x,
                     const uint4* __restrict__ wpk,
                     const float* __restrict__ bias, float4* __restrict__ xp,
                     int n, int seq_len, int d_x, int hidden, int kp_tiles,
                     int n_pad, int steps_t, int t0_count, int t1_lo) {
  extern __shared__ uint4 smem_u4[];
  const int dir = blockIdx.z / steps_t;
  const int ti = blockIdx.z - dir * steps_t;
  if (ti >= (dir == 0 ? t0_count : seq_len - t1_lo)) return;  // no barrier yet
  const int t = dir == 0 ? ti : t1_lo + ti;
  const int m_tiles = 4 * hidden / 16;
  const int dp_tiles = (d_x + 15) / 16;
  const int n_chunks = (dp_tiles + kGemmKT - 1) / kGemmKT;
  const int mt0 = blockIdx.y * (kGemmM / 16);
  const int nb0 = blockIdx.x * kGemmN;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;  // warpgroup warp / 4 owns m-tiles 4 (warp/4)..
  const int grp = lane >> 2;

  const uint4* wdir = wpk + (size_t)dir * m_tiles * kp_tiles * 32;
  // a stage: A [16 m-tiles][kGemmKT k-tiles][32 lanes] uint4, then B as
  // 8x8 core matrices [16 row groups][2 kGemmKT k groups][8 rows][8 bf16]
  auto load_stage = [&](int slot, int kc) {
    uint4* sa = smem_u4 + slot * (kGemmStageA + kGemmStageB);
    uint4* sb = sa + kGemmStageA;
#pragma unroll
    for (int q = 0; q < kGemmStageA / 512; ++q) {
      const int i = tid + q * 512;
      const int mt = i / (kGemmKT * 32), kk = (i / 32) % kGemmKT, l = i & 31;
      const int kt = kc * kGemmKT + kk;
      const bool ok = kt < dp_tiles && mt0 + mt < m_tiles;
      cp_async16(sa + i,
                 wdir + ((size_t)(ok ? mt0 + mt : 0) * kp_tiles +
                         (ok ? kt : 0)) * 32 + l,
                 ok);
    }
#pragma unroll
    for (int q = 0; q < kGemmStageB / 512; ++q) {
      const int i = tid + q * 512;
      const int r = i / (2 * kGemmKT), kq = i % (2 * kGemmKT);
      const int k = kc * kGemmKT * 16 + kq * 8;
      const int row = nb0 + r;
      const bool ok = row < n && k < d_x;
      cp_async16(sb + ((r >> 3) * 2 * kGemmKT + kq) * 8 + (r & 7),
                 x + ((size_t)(ok ? row : 0) * seq_len + (ok ? t : 0)) * d_x +
                     (ok ? k : 0),
                 ok);
    }
  };

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;

  // chunk kc lands in slot kc % 4, three chunks ahead of the products;
  // the products of a chunk end before the next chunk's step, so its slot
  // (and its A registers) can be refilled then
  auto step = [&](int kc, uint4 (&a)[kGemmKT]) {
    cp_async_wait<2>();
    fence_proxy_async();
    __syncthreads();  // chunk kc landed; chunk kc - 1's slot is free
    if (kc + 3 < n_chunks) load_stage((kc + 3) % kGemmStages, kc + 3);
    cp_async_commit();
    const uint4* sa =
        smem_u4 + (kc % kGemmStages) * (kGemmStageA + kGemmStageB);
#pragma unroll
    for (int kk = 0; kk < kGemmKT; ++kk)
      a[kk] = sa[(warp * kGemmKT + kk) * 32 + lane];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kGemmKT; ++kk)
      wgmma_m64n128k16(acc, a[kk], smem_desc<kDescLbo, kDescSbo>(
                                       sa + kGemmStageA + kk * 16));
    wgmma_commit_wait();
  };
  for (int kc = 0; kc < 3; ++kc) {
    if (kc < n_chunks) load_stage(kc, kc);
    cp_async_commit();
  }
  uint4 a[kGemmKT];
  for (int kc = 0; kc < n_chunks; ++kc) {
    step(kc, a);
    reg_fence(a);  // the chunk's products have ended
  }
  cp_async_wait<0>();

  // bias, then one float4 a lane per 16x8 tile, in fragment order
  const int mt = mt0 + warp;
  if (mt >= m_tiles) return;  // 4H not a multiple of the block's 256
  const float b_lo = bias[dir * 4 * hidden + mt * 16 + grp];
  const float b_hi = bias[dir * 4 * hidden + mt * 16 + grp + 8];
  const size_t base =
      ((size_t)(dir * steps_t + ti) * (n_pad / 8) + nb0 / 8) * m_tiles + mt;
#pragma unroll
  for (int j = 0; j < 16; ++j)
    xp[(base + (size_t)j * m_tiles) * 32 + lane] =
        make_float4(acc[4 * j] + b_lo, acc[4 * j + 1] + b_lo,
                    acc[4 * j + 2] + b_hi, acc[4 * j + 3] + b_hi);
}

int launch_inproj(const void* x, const void* wpk, const void* b, void* xp,
                  int n, int seq_len, int d_x, int hidden, int kp_tiles,
                  int n_pad, int steps_t, int t0_count, int t1_lo, int smem,
                  int grid_x, int grid_y, int grid_z, cudaStream_t stream) {
  if (n <= 0 || seq_len <= 0 || d_x <= 0 || d_x % 8 || hidden <= 0 ||
      hidden % 16 ||
      kp_tiles != (d_x + 15) / 16 + hidden / 16 || n_pad % kGemmN ||
      n_pad < n || t0_count < 1 || t0_count > seq_len || t1_lo < 0 ||
      t1_lo >= seq_len || steps_t < t0_count || steps_t < seq_len - t1_lo ||
      smem != kGemmSmem || grid_x != n_pad / kGemmN ||
      grid_y != (4 * hidden + kGemmM - 1) / kGemmM || grid_z != 2 * steps_t)
    return kPlanError;
  cudaError_t err = cudaFuncSetAttribute(
      bilstm_inproj_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  bilstm_inproj_kernel<<<dim3(grid_x, grid_y, grid_z), 512, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint4*>(wpk),
      static_cast<const float*>(b), static_cast<float4*>(xp), n, seq_len, d_x,
      hidden, kp_tiles, n_pad, steps_t, t0_count, t1_lo);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// 2b. Cluster recurrence
//
// xp    as written by bilstm_inproj_kernel (bias included)
// wpk   as above; k-tiles [w_kt0, w_kt0 + H/16) of each row are w_hh^T
// out   kCenter ? [n, 2H] f32 : [n, seq_len, 2H] OutT
// grid  (ceil(n / bn) * C, 2), cluster (C, 1, 1); CTA rank r of a cluster
//       owns units [r U, (r+1) U), U = H/C; block (U/16) x (bn/32) warps
// shared: w_hh slice [4][U/16][H/16][32] uint4 (gate g, unit group u ->
//       packed m-tile g H/16 + r U/16 + u), then h [2][bn][H + 8] bf16
template <bool kCenter, typename OutT>
__global__ void __launch_bounds__(256, 1)
bilstm_cluster_kernel(const float4* __restrict__ xp,
                      const uint4* __restrict__ wpk, OutT* __restrict__ out,
                      int n, int seq_len, int hidden, int kp_tiles, int w_kt0,
                      int n_pad, int steps_t, int t1_lo, int bn) {
  extern __shared__ uint4 smem_u4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int units = hidden / csize;
  const int u_tiles = units / 16;
  const int h_tiles = hidden / 16;
  const int m_tiles = 4 * h_tiles;
  const int ldh = hidden + kRowPad;
  const int w_u4 = 4 * u_tiles * h_tiles * 32;
  uint4* s_w = smem_u4;
  __nv_bfloat16* s_h = reinterpret_cast<__nv_bfloat16*>(smem_u4 + w_u4);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int grp = lane >> 2;
  const int tig = lane & 3;
  const int ug = warp % u_tiles;
  const int wn = warp / u_tiles;
  const int dir = blockIdx.y;
  const int n0 = (blockIdx.x / csize) * bn;

  // this CTA's w_hh slice, once: per (gate, unit group) H/16 contiguous
  // packed tiles
  const uint4* wdir = wpk + (size_t)dir * m_tiles * kp_tiles * 32;
  const int chunk_u4 = h_tiles * 32;
  for (int i = tid; i < w_u4; i += blockDim.x) {
    const int q = i / chunk_u4;
    const int g = q / u_tiles, u = q - g * u_tiles;
    const int mt = g * h_tiles + rank * u_tiles + u;
    cp_async16(s_w + i,
               wdir + ((size_t)mt * kp_tiles + w_kt0) * 32 + (i - q * chunk_u4),
               true);
  }
  cp_async_commit();
  for (int i = tid; i < 2 * bn * ldh; i += blockDim.x)
    s_h[i] = __float2bfloat16_rn(0.0f);  // h_{-1} = 0

  const int center = seq_len / 2;
  const int steps =
      kCenter ? (dir == 0 ? center + 1 : seq_len - center) : seq_len;
  const int j_lo = rank * units + ug * 16 + grp;  // column in h and out

  // xp float4 of (gate g, n-tile nt) at time index ti
  const float4* xq = xp + ((size_t)dir * steps_t * (n_pad / 8) +
                           (n0 + wn * 32) / 8) * m_tiles * 32 + lane;
  const size_t ti_stride = (size_t)(n_pad / 8) * m_tiles * 32;
  int mt_of[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) mt_of[g] = g * h_tiles + rank * u_tiles + ug;
  auto load_xp = [&](int s, float4 (&v)[4][kNT]) {
    const int t = dir == 0 ? s : seq_len - 1 - s;
    const float4* p = xq + (size_t)(dir == 0 ? t : t - t1_lo) * ti_stride;
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
        v[g][nt] = __ldg(p + ((size_t)nt * m_tiles + mt_of[g]) * 32);
  };

  const uint4* wg[4];
#pragma unroll
  for (int g = 0; g < 4; ++g)
    wg[g] = s_w + (size_t)(g * u_tiles + ug) * h_tiles * 32 + lane;

  float c[kNT][4];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[nt][e] = 0.0f;

  // bf16 stream output leaves from the shared h slice as 16-byte rows;
  // f32 and center outputs from the registers
  constexpr bool kSmemOut =
      !kCenter && std::is_same<OutT, __nv_bfloat16>::value;
  const int h_row = wn * 32 * ldh + ldmatrix_offset(lane, ldh);
  const int slice_u4 = units / 8;  // 16-byte pieces of a row's slice
  float4 xcur[4][kNT];
  load_xp(0, xcur);
  cp_async_wait<0>();
  // weights in and every CTA's h zeroed before any peer writes into it
  cluster_arrive();

  for (int s = 0; s < steps; ++s) {
    const int t = dir == 0 ? s : seq_len - 1 - s;
    // h_{t-1} whole in every CTA; every read of the other buffer done
    cluster_wait();
    float acc[4][kNT][4];
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        acc[g][nt][0] = xcur[g][nt].x;
        acc[g][nt][1] = xcur[g][nt].y;
        acc[g][nt][2] = xcur[g][nt].z;
        acc[g][nt][3] = xcur[g][nt].w;
      }
    if (s + 1 < steps) load_xp(s + 1, xcur);  // in flight during the step
    mma_rows(acc, wg, 0, s_h + (s & 1) * bn * ldh + h_row, ldh, h_tiles);
    float h[kNT][4];
    cell_update<kCenter, !kSmemOut, OutT>(acc, c, h, out, n, n0 + wn * 32,
                                          seq_len, t, dir * hidden + j_lo,
                                          hidden, tig);
    __nv_bfloat16* h_next = s_h + ((s + 1) & 1) * bn * ldh;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        h_next[(wn * 32 + nt * 8 + 2 * tig + (e & 1)) * ldh + j_lo +
               (e < 2 ? 0 : 8)] = __float2bfloat16_rn(h[nt][e]);
    __syncthreads();  // this CTA's slice of h_t is whole ...
    // ... and goes to every peer's buffer of the same parity: bn U / 8
    // pieces of 16 bytes, two a thread (the block has bn U / 16 threads)
    uint4 mine[2];
    int row_of[2], k_of[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int i = tid + q * blockDim.x;
      row_of[q] = i / slice_u4;
      k_of[q] = rank * units + (i - row_of[q] * slice_u4) * 8;
      __nv_bfloat16* src = h_next + row_of[q] * ldh + k_of[q];
      mine[q] = *reinterpret_cast<const uint4*>(src);
      for (int p = 1; p < csize; ++p)
        *reinterpret_cast<uint4*>(
            cluster.map_shared_rank(src, (rank + p) % csize)) = mine[q];
    }
    cluster_arrive();
    if (kSmemOut) {  // while the peers catch up
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int row = n0 + row_of[q];
        if (row < n)
          *reinterpret_cast<uint4*>(
              out + ((size_t)row * seq_len + t) * 2 * hidden +
              dir * hidden + k_of[q]) = mine[q];
      }
    }
  }
  cluster_wait();  // no peer still writes into this CTA's shared memory
}

int cluster_smem(int hidden, int csize, int bn) {
  return 4 * (hidden / csize) * hidden * 2 + 2 * bn * (hidden + kRowPad) * 2;
}

cudaLaunchConfig_t cluster_config(int csize, int bn, int hidden, int smem,
                                  int grid_x, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid_x, 2, 1);
  cfg.blockDim = dim3(hidden / csize / 16 * (bn / 32) * 32, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

bool cluster_plan_ok(int hidden, int csize, int bn, int smem) {
  const int units = csize > 0 ? hidden / csize : 0;
  return hidden > 0 && hidden % 16 == 0 && csize >= 1 && csize <= 8 &&
         hidden % csize == 0 && units % 16 == 0 && bn > 0 && bn % 32 == 0 &&
         units / 16 * (bn / 32) <= 8 &&
         smem == cluster_smem(hidden, csize, bn) && smem <= kSmemMax;
}

// active clusters of a plan on this card, or < 0 on an error
template <bool kCenter, typename OutT>
int occupancy(int csize, int bn, int hidden, int smem) {
  if (!cluster_plan_ok(hidden, csize, bn, smem)) return kPlanError;
  auto kernel = bilstm_cluster_kernel<kCenter, OutT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg =
      cluster_config(csize, bn, hidden, smem, csize, 0, attr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return -(int)err;
  return clusters;
}

template <bool kCenter, typename OutT>
int launch_cluster(const void* xp, const void* wpk, void* out, int n,
                   int seq_len, int hidden, int kp_tiles, int w_kt0,
                   int n_pad, int steps_t, int t1_lo, int csize, int bn,
                   int smem, int grid_x, cudaStream_t stream) {
  if (n <= 0 || seq_len <= 0 || !cluster_plan_ok(hidden, csize, bn, smem) ||
      w_kt0 < 0 || kp_tiles != w_kt0 + hidden / 16 || n_pad % bn ||
      n_pad < n || grid_x != (n + bn - 1) / bn * csize || grid_x % csize ||
      t1_lo < 0 || t1_lo >= seq_len || steps_t < seq_len - t1_lo)
    return kPlanError;
  const int clusters = occupancy<kCenter, OutT>(csize, bn, hidden, smem);
  if (clusters < 0) return -clusters;
  if (clusters == 0) return kNoCluster;
  auto kernel = bilstm_cluster_kernel<kCenter, OutT>;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg =
      cluster_config(csize, bn, hidden, smem, grid_x, stream, attr);
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const float4*>(xp),
      static_cast<const uint4*>(wpk), static_cast<OutT*>(out), n, seq_len,
      hidden, kp_tiles, w_kt0, n_pad, steps_t, t1_lo, bn);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int nsp_bilstm_stream(const void* x, const void* wpk,
                                 const void* b, void* out, int out_f32, int n,
                                 int seq_len, int d_x, int hidden, int bn,
                                 int smem, int grid_x, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_f32)
    return launch_fused<false, float>(x, wpk, b, out, n, seq_len, d_x, hidden,
                                      bn, smem, grid_x, st);
  return launch_fused<false, __nv_bfloat16>(x, wpk, b, out, n, seq_len, d_x,
                                            hidden, bn, smem, grid_x, st);
}

extern "C" int nsp_bilstm_center(const void* x, const void* wpk,
                                 const void* b, void* out, int n, int seq_len,
                                 int d_x, int hidden, int bn, int smem,
                                 int grid_x, void* stream) {
  return launch_fused<true, float>(x, wpk, b, out, n, seq_len, d_x, hidden,
                                   bn, smem, grid_x,
                                   static_cast<cudaStream_t>(stream));
}

extern "C" int nsp_bilstm_inproj(const void* x, const void* wpk,
                                 const void* b, void* xp, int n, int seq_len,
                                 int d_x, int hidden, int kp_tiles, int n_pad,
                                 int steps_t, int t0_count, int t1_lo,
                                 int smem, int grid_x, int grid_y, int grid_z,
                                 void* stream) {
  return launch_inproj(x, wpk, b, xp, n, seq_len, d_x, hidden, kp_tiles,
                       n_pad, steps_t, t0_count, t1_lo, smem, grid_x, grid_y,
                       grid_z, static_cast<cudaStream_t>(stream));
}

extern "C" int nsp_bilstm_cluster(const void* xp, const void* wpk, void* out,
                                  int center, int out_f32, int n, int seq_len,
                                  int hidden, int kp_tiles, int w_kt0,
                                  int n_pad, int steps_t, int t1_lo,
                                  int csize, int bn, int smem, int grid_x,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (center)
    return launch_cluster<true, float>(xp, wpk, out, n, seq_len, hidden,
                                       kp_tiles, w_kt0, n_pad, steps_t, t1_lo,
                                       csize, bn, smem, grid_x, st);
  if (out_f32)
    return launch_cluster<false, float>(xp, wpk, out, n, seq_len, hidden,
                                        kp_tiles, w_kt0, n_pad, steps_t,
                                        t1_lo, csize, bn, smem, grid_x, st);
  return launch_cluster<false, __nv_bfloat16>(
      xp, wpk, out, n, seq_len, hidden, kp_tiles, w_kt0, n_pad, steps_t,
      t1_lo, csize, bn, smem, grid_x, st);
}

// active clusters of the recurrence's plan on this card (the stream, bf16
// instantiation; the three share their resources), or < 0 on an error
extern "C" int nsp_bilstm_cluster_occupancy(int csize, int bn, int hidden,
                                            int smem) {
  return occupancy<false, __nv_bfloat16>(csize, bn, hidden, smem);
}
