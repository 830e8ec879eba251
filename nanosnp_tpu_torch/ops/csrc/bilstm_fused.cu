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
//       one program; layer 1 keeps bf16 h of every step and both
//       directions in shared memory at its true time index, layer 2 reads
//       that slab and emits only its state at t = L//2 -> [n, 2H] f32.
//
// Math (the cast sites of the Pallas kernels and of bilstm.cu):
//   gates_t = [w_ih | w_hh]^T . [x_t ; bf16(h_{t-1})] + b  (bf16 operands,
//   f32 accumulation), gate order i, f, g, o; f32 gate and cell math; h
//   and c start at zero; direction 1 walks time backwards; bf16 between the
//   layers; the head's products in bf16 with f32 accumulation, f32 bias
//   adds and tanh.
//
// Both kernels need the two directions' states in one place (the head
// contracts over the concatenated 2H center; layer 2 reads both halves of
// every slab row), so one block runs both directions of a batch tile:
// 2 * H/16 warps, warp w serving direction w / (H/16) and the 16 hidden
// units (w % (H/16)) * 16 ..., all four gates of them, so the cell update
// runs on the mma accumulator registers as in bilstm.cu. L is odd, so both
// directions reach t = L//2 at step L//2: the center layer stops there.
//
// What bounds them on this card: as bilstm.cu, a chain of small dependent
// tensor-core products (mma.sync.m16n8k16), each step waiting on the one
// before; the operation count over the bf16 peak gives the bound, the
// latency of a step is what the time goes on. The weights are read as
// packed A fragments from global memory (L2/L1 resident) every step; the
// head's weights are read once a block. The slab of nsp_bilstm2_center is
// L * (2H + 8) bf16 a batch row (8,976 bytes at L 33, H 64), which sets its
// batch tile to 16 rows (140 KiB of shared memory, one block an SM).
// Layer 2 runs only the L//2 + 1 steps each direction needs (the Pallas
// kernel ran all L).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kMaxWarps = 16;  // both directions: H <= 128
constexpr int kRowPad = 8;     // bf16 pad per shared row (bank conflicts)
constexpr int kHeadNT = 4;     // center + head: 32 batch rows a block
constexpr int kEnc2NT = 2;     // two layers: 16 batch rows a block (slab)

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

// Accumulator element e of n-tile nt of this thread: batch row in the tile.
__device__ __forceinline__ int frag_row(int nt, int tig, int e) {
  return nt * 8 + 2 * tig + (e & 1);
}

template <int kNT>
__device__ __forceinline__ void set_bias(float (&acc)[4][kNT][4],
                                         const float (&b_lo)[4],
                                         const float (&b_hi)[4]) {
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      acc[g][nt][0] = b_lo[g];
      acc[g][nt][1] = b_lo[g];
      acc[g][nt][2] = b_hi[g];
      acc[g][nt][3] = b_hi[g];
    }
}

// acc[g] += A_g[:, kt0 .. kt0 + kts) . B, where A_g is gate g's m-tile of
// this warp (wg[g], already offset to the lane) and B is a [rows, 16 * kts]
// bf16 segment in shared memory, `stride` bf16 between batch rows.
template <int kNT>
__device__ __forceinline__ void gate_product(float (&acc)[4][kNT][4],
                                             const uint4* const (&wg)[4],
                                             int kt0, int kts,
                                             const __nv_bfloat16* s_b,
                                             int stride, int grp, int tig) {
  for (int k = 0; k < kts; ++k) {
    uint4 a[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) a[g] = __ldg(wg[g] + (kt0 + k) * 32);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const __nv_bfloat16* bp = s_b + (nt * 8 + grp) * stride + k * 16 + 2 * tig;
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(bp);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(bp + 8);
#pragma unroll
      for (int g = 0; g < 4; ++g) mma_bf16(acc[g][nt], a[g], b0, b1);
    }
  }
}

// c <- sig(f) c + sig(i) tanh(g); h[nt][e] = sig(o) tanh(c)
template <int kNT>
__device__ __forceinline__ void cell_update(const float (&acc)[4][kNT][4],
                                            float (&c)[kNT][4],
                                            float (&h)[kNT][4]) {
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float ig = sigmoid_f32(acc[0][nt][e]);
      const float fg = sigmoid_f32(acc[1][nt][e]);
      const float gg = tanhf(acc[2][nt][e]);
      const float og = sigmoid_f32(acc[3][nt][e]);
      c[nt][e] = fg * c[nt][e] + ig * gg;
      h[nt][e] = og * tanhf(c[nt][e]);
    }
}

// x_t of both directions into their operand tiles (columns [0, d_in) of
// s_v[dir]); rows past n read as zero and are never stored.
__device__ __forceinline__ void stage_x(__nv_bfloat16* s_v, int ld, int rows,
                                        const __nv_bfloat16* __restrict__ x,
                                        int n, int n0, int seq_len, int d_in,
                                        int step) {
  const int per_dir = rows * d_in;
  for (int i = threadIdx.x; i < 2 * per_dir; i += blockDim.x) {
    const int dir = i / per_dir;
    const int rem = i - dir * per_dir;
    const int r = rem / d_in;
    const int d = rem - r * d_in;
    const int t = dir == 0 ? step : seq_len - 1 - step;
    const int row = n0 + r;
    s_v[(dir * rows + r) * ld + d] =
        row < n ? x[((size_t)row * seq_len + t) * d_in + d]
                : __float2bfloat16_rn(0.0f);
  }
}

// One dense layer of the head on the block's batch tile, m-tiles dealt to
// the warps in turn: y = W . in + bias, W as packed A fragments
// [m_dim/16, k_dim/16, 32, 8]; `in` a bf16 tile in shared memory.
// emit(batch row in tile, output unit, value) stores the result.
template <int kNT, typename Emit>
__device__ __forceinline__ void head_dense(const uint4* __restrict__ w_pk,
                                           const float* __restrict__ bias,
                                           const __nv_bfloat16* s_in,
                                           int ld_in, int k_dim, int m_dim,
                                           int warp, int n_warps, int lane,
                                           Emit emit) {
  const int grp = lane >> 2;
  const int tig = lane & 3;
  const int k_tiles = k_dim / 16;
  for (int mt = warp; mt < m_dim / 16; mt += n_warps) {
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
    for (int kt = 0; kt < k_tiles; ++kt) {
      const uint4 a = __ldg(wa + kt * 32);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const __nv_bfloat16* bp =
            s_in + (nt * 8 + grp) * ld_in + kt * 16 + 2 * tig;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(bp);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(bp + 8);
        mma_bf16(acc[nt], a, b0, b1);
      }
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        emit(frag_row(nt, tig, e), mt * 16 + grp + (e < 2 ? 0 : 8),
             acc[nt][e]);
  }
}

// Center layer + head.
// x     [n, L, d_in] bf16 (L odd)
// wpk   [2, 4H/16, Kp/16, 32, 8] bf16, Kp = d_in padded to 16 + H
// bias  [2, 4H] f32
// wp_pk [P/16, 2H/16, 32, 8], wd_pk [Q/16, P/16, 32, 8],
// wh_pk [R/16, Q/16, 32, 8] bf16 (R = head rows zero-padded to 16);
// bp [P], bd [Q], bh [R] f32
// out   [n, n_out] f32, n_out <= R
// block = 2 * H/16 warps, grid = ceil(n / 32)
__global__ void __launch_bounds__(kMaxWarps * 32)
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
                          int d_in, int hidden, int p_dim, int q_dim,
                          int r_dim, int n_out) {
  constexpr int kNT = kHeadNT;
  constexpr int kBN = 8 * kNT;
  extern __shared__ uint4 smem_u4[];
  const int d_pad = (d_in + 15) / 16 * 16;
  const int k_tiles = (d_pad + hidden) / 16;
  const int ld = d_pad + hidden + kRowPad;
  const int ld_c = 2 * hidden + kRowPad;
  const int ld_p = p_dim + kRowPad;
  const int ld_q = q_dim + kRowPad;
  __nv_bfloat16* s_v = reinterpret_cast<__nv_bfloat16*>(smem_u4);
  __nv_bfloat16* s_ctr = s_v + 2 * kBN * ld;   // [kBN, 2H]
  __nv_bfloat16* s_p = s_ctr + kBN * ld_c;     // [kBN, P]
  __nv_bfloat16* s_q = s_p + kBN * ld_p;       // [kBN, Q]

  const int warps_dir = hidden / 16;
  const int n_warps = 2 * warps_dir;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grp = lane >> 2;
  const int tig = lane & 3;
  const int dir = warp / warps_dir;
  const int wj = warp - dir * warps_dir;
  const int n0 = blockIdx.x * kBN;

  // zero both operand tiles once: the D padding stays zero, and h_{-1} = 0
  for (int i = threadIdx.x; i < 2 * kBN * ld; i += blockDim.x)
    s_v[i] = __float2bfloat16_rn(0.0f);

  const int j_lo = wj * 16 + grp;
  float b_lo[4], b_hi[4];
  const uint4* wg[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    b_lo[g] = bias[dir * 4 * hidden + g * hidden + j_lo];
    b_hi[g] = bias[dir * 4 * hidden + g * hidden + j_lo + 8];
    wg[g] = wpk + ((size_t)(dir * 4 + g) * warps_dir + wj) * k_tiles * 32
            + lane;
  }
  float c[kNT][4];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[nt][e] = 0.0f;

  const int center = seq_len / 2;
  __nv_bfloat16* s_mine = s_v + dir * kBN * ld;
  __syncthreads();

  for (int s = 0; s <= center; ++s) {
    stage_x(s_v, ld, kBN, x, n, n0, seq_len, d_in, s);
    __syncthreads();
    float acc[4][kNT][4];
    set_bias<kNT>(acc, b_lo, b_hi);
    gate_product<kNT>(acc, wg, 0, k_tiles, s_mine, ld, grp, tig);
    __syncthreads();  // every read of h_{t-1} is done before it changes
    float h[kNT][4];
    cell_update<kNT>(acc, c, h);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = frag_row(nt, tig, e);
        const int j = e < 2 ? j_lo : j_lo + 8;
        const __nv_bfloat16 hb = __float2bfloat16_rn(h[nt][e]);
        s_mine[r * ld + d_pad + j] = hb;
        if (s == center) s_ctr[r * ld_c + dir * hidden + j] = hb;
      }
  }
  __syncthreads();  // the center state of both directions is staged

  head_dense<kNT>(wp_pk, bp, s_ctr, ld_c, 2 * hidden, p_dim, warp, n_warps,
                  lane, [&](int r, int j, float v) {
                    s_p[r * ld_p + j] = __float2bfloat16_rn(v);
                  });
  __syncthreads();
  head_dense<kNT>(wd_pk, bd, s_p, ld_p, p_dim, q_dim, warp, n_warps, lane,
                  [&](int r, int j, float v) {
                    s_q[r * ld_q + j] = __float2bfloat16_rn(tanhf(v));
                  });
  __syncthreads();
  head_dense<kNT>(wh_pk, bh, s_q, ld_q, q_dim, r_dim, warp, n_warps, lane,
                  [&](int r, int j, float v) {
                    const int row = n0 + r;
                    if (row < n && j < n_out)
                      out[(size_t)row * n_out + j] = v;
                  });
}

// Two layers, center only.
// x    [n, L, d_in] bf16 (L odd)
// wpk1 [2, 4H/16, (d_in padded to 16 + H)/16, 32, 8], b1 [2, 4H]
// wpk2 [2, 4H/16, (2H + H)/16, 32, 8], b2 [2, 4H]
// out  [n, 2H] f32
// block = 2 * H/16 warps, grid = ceil(n / 16)
__global__ void __launch_bounds__(kMaxWarps * 32)
bilstm2_center_kernel(const __nv_bfloat16* __restrict__ x,
                      const uint4* __restrict__ wpk1,
                      const float* __restrict__ b1,
                      const uint4* __restrict__ wpk2,
                      const float* __restrict__ b2, float* __restrict__ out,
                      int n, int seq_len, int d_in, int hidden) {
  constexpr int kNT = kEnc2NT;
  constexpr int kBN = 8 * kNT;
  extern __shared__ uint4 smem_u4[];
  const int d_pad = (d_in + 15) / 16 * 16;
  const int k_tiles1 = (d_pad + hidden) / 16;
  const int k_tiles2 = 3 * hidden / 16;
  const int ld1 = d_pad + hidden + kRowPad;  // layer 1: [x_t ; h]
  const int ld2 = hidden + kRowPad;          // layer 2: h
  const int ld_s = 2 * hidden + kRowPad;     // a slab row: both directions
  const int row_s = seq_len * ld_s;          // slab stride between batch rows
  __nv_bfloat16* s_slab = reinterpret_cast<__nv_bfloat16*>(smem_u4);
  __nv_bfloat16* s_v1 = s_slab + kBN * row_s;  // [2, kBN, ld1]
  __nv_bfloat16* s_h2 = s_v1 + 2 * kBN * ld1;  // [2, kBN, ld2]

  const int warps_dir = hidden / 16;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grp = lane >> 2;
  const int tig = lane & 3;
  const int dir = warp / warps_dir;
  const int wj = warp - dir * warps_dir;
  const int n0 = blockIdx.x * kBN;
  const int j_lo = wj * 16 + grp;

  // h_{-1} = 0 for both layers; the D padding of layer 1 stays zero
  for (int i = threadIdx.x; i < 2 * kBN * (ld1 + ld2); i += blockDim.x)
    s_v1[i] = __float2bfloat16_rn(0.0f);

  float b_lo[4], b_hi[4];
  const uint4* wg[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    b_lo[g] = b1[dir * 4 * hidden + g * hidden + j_lo];
    b_hi[g] = b1[dir * 4 * hidden + g * hidden + j_lo + 8];
    wg[g] = wpk1 + ((size_t)(dir * 4 + g) * warps_dir + wj) * k_tiles1 * 32
            + lane;
  }
  float c[kNT][4];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[nt][e] = 0.0f;
  __nv_bfloat16* s_mine = s_v1 + dir * kBN * ld1;
  __syncthreads();

  // ---- layer 1: every step, h into the slab at its true time index ----
  for (int s = 0; s < seq_len; ++s) {
    const int t = dir == 0 ? s : seq_len - 1 - s;
    stage_x(s_v1, ld1, kBN, x, n, n0, seq_len, d_in, s);
    __syncthreads();
    float acc[4][kNT][4];
    set_bias<kNT>(acc, b_lo, b_hi);
    gate_product<kNT>(acc, wg, 0, k_tiles1, s_mine, ld1, grp, tig);
    __syncthreads();  // every read of h_{t-1} is done before it changes
    float h[kNT][4];
    cell_update<kNT>(acc, c, h);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = frag_row(nt, tig, e);
        const int j = e < 2 ? j_lo : j_lo + 8;
        const __nv_bfloat16 hb = __float2bfloat16_rn(h[nt][e]);
        s_mine[r * ld1 + d_pad + j] = hb;
        s_slab[r * row_s + t * ld_s + dir * hidden + j] = hb;
      }
  }

  // ---- layer 2: off the slab, up to the center step ----
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    b_lo[g] = b2[dir * 4 * hidden + g * hidden + j_lo];
    b_hi[g] = b2[dir * 4 * hidden + g * hidden + j_lo + 8];
    wg[g] = wpk2 + ((size_t)(dir * 4 + g) * warps_dir + wj) * k_tiles2 * 32
            + lane;
  }
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[nt][e] = 0.0f;
  __nv_bfloat16* s_hm = s_h2 + dir * kBN * ld2;
  const int center = seq_len / 2;
  const int kt_in = 2 * hidden / 16;
  __syncthreads();  // the slab is complete

  for (int s = 0; s <= center; ++s) {
    const int t = dir == 0 ? s : seq_len - 1 - s;
    float acc[4][kNT][4];
    set_bias<kNT>(acc, b_lo, b_hi);
    gate_product<kNT>(acc, wg, 0, kt_in, s_slab + t * ld_s, row_s, grp, tig);
    gate_product<kNT>(acc, wg, kt_in, k_tiles2 - kt_in, s_hm, ld2, grp, tig);
    __syncthreads();  // every read of h_{t-1} is done before it changes
    float h[kNT][4];
    cell_update<kNT>(acc, c, h);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = frag_row(nt, tig, e);
        const int j = e < 2 ? j_lo : j_lo + 8;
        s_hm[r * ld2 + j] = __float2bfloat16_rn(h[nt][e]);
        const int row = n0 + r;
        if (s == center && row < n)
          out[(size_t)row * 2 * hidden + dir * hidden + j] = h[nt][e];
      }
    __syncthreads();  // h_t is in shared memory before the next product
  }
}

bool bad_shape(int n, int seq_len, int d_in, int hidden) {
  return n <= 0 || seq_len <= 0 || seq_len % 2 == 0 || d_in <= 0 ||
         hidden <= 0 || hidden % 16 || 2 * (hidden / 16) > kMaxWarps;
}

// Dynamic shared memory of each kernel (ops/bilstm_fused.py states the
// same sums as the wrappers' limit).
int center_head_smem(int d_in, int hidden, int p_dim, int q_dim) {
  const int d_pad = (d_in + 15) / 16 * 16;
  const int kBN = 8 * kHeadNT;
  return kBN * (2 * (d_pad + hidden + kRowPad) + (2 * hidden + kRowPad) +
                (p_dim + kRowPad) + (q_dim + kRowPad)) *
         (int)sizeof(__nv_bfloat16);
}

int enc2_smem(int seq_len, int d_in, int hidden) {
  const int d_pad = (d_in + 15) / 16 * 16;
  const int kBN = 8 * kEnc2NT;
  return kBN * (seq_len * (2 * hidden + kRowPad) +
                2 * (d_pad + hidden + kRowPad) + 2 * (hidden + kRowPad)) *
         (int)sizeof(__nv_bfloat16);
}

}  // namespace

extern "C" int nsp_bilstm_center_head(
    const void* x, const void* wpk, const void* b, const void* wp_pk,
    const void* bp, const void* wd_pk, const void* bd, const void* wh_pk,
    const void* bh, void* out, int n, int seq_len, int d_in, int hidden,
    int p_dim, int q_dim, int r_dim, int n_out, void* stream) {
  if (bad_shape(n, seq_len, d_in, hidden) || p_dim <= 0 || p_dim % 16 ||
      q_dim <= 0 || q_dim % 16 || r_dim <= 0 || r_dim % 16 || n_out <= 0 ||
      n_out > r_dim)
    return (int)cudaErrorInvalidValue;
  const int smem = center_head_smem(d_in, hidden, p_dim, q_dim);
  cudaError_t err = cudaFuncSetAttribute(
      bilstm_center_head_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const int kBN = 8 * kHeadNT;
  bilstm_center_head_kernel<<<(n + kBN - 1) / kBN, 2 * (hidden / 16) * 32,
                              smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint4*>(wpk),
      static_cast<const float*>(b), static_cast<const uint4*>(wp_pk),
      static_cast<const float*>(bp), static_cast<const uint4*>(wd_pk),
      static_cast<const float*>(bd), static_cast<const uint4*>(wh_pk),
      static_cast<const float*>(bh), static_cast<float*>(out), n, seq_len,
      d_in, hidden, p_dim, q_dim, r_dim, n_out);
  return (int)cudaGetLastError();
}

extern "C" int nsp_bilstm2_center(const void* x, const void* wpk1,
                                  const void* b1, const void* wpk2,
                                  const void* b2, void* out, int n,
                                  int seq_len, int d_in, int hidden,
                                  void* stream) {
  if (bad_shape(n, seq_len, d_in, hidden)) return (int)cudaErrorInvalidValue;
  const int smem = enc2_smem(seq_len, d_in, hidden);
  cudaError_t err = cudaFuncSetAttribute(
      bilstm2_center_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const int kBN = 8 * kEnc2NT;
  bilstm2_center_kernel<<<(n + kBN - 1) / kBN, 2 * (hidden / 16) * 32, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint4*>(wpk1),
      static_cast<const float*>(b1), static_cast<const uint4*>(wpk2),
      static_cast<const float*>(b2), static_cast<float*>(out), n, seq_len,
      d_in, hidden);
  return (int)cudaGetLastError();
}
