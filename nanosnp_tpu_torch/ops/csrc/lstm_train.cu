// LSTM recurrence over precomputed input projections, both directions, for
// Hopper (sm_90a): the inference forward, and training's forward and
// backward. Plain C interface, loaded with ctypes.
//
// Replaces the Pallas TPU kernels of nanosnp_tpu/ops/pallas_lstm.py behind
// the custom VJP `_recurrence` (its primal, and the differentiable
// recurrence of training):
//   nsp_lstm_infer <- _kernel       (no gradient wanted: streams h_t only,
//                                    xp f32 or bf16)
//   nsp_lstm_fwd  <- _train_kernel  (forward; streams h_t and c_t)
//   nsp_lstm_bwd  <- _bwd_kernel    (reverse-time sweep: gates recomputed,
//                                    dxp streamed, dh/dc carried)
//   nsp_lstm_dw   <- the dW accumulation of _bwd_kernel (its VMEM sum over
//                    batch tiles, then the wrapper's sum over tiles):
//                    dW[d] = sum_{t,n} h_{t-1}[d, n, :]^T dxp[t, d, n, :]
//
// Layouts (true time order; direction 1 walks time backwards inside the
// kernels, so no reversed copies are made):
//   xp, dxp [n, L, 2, 4H] f32   input projections x W_ih + b / their grads
//   hs, cs  [n, L, 2, H]  f32   h_t and c_t, direction d at [..., d, :]
//   g       [n, L, 2, H]  f32   gradient of the loss with respect to hs
// (the inference kernel also takes xp in bf16 and widens it on load)
//   dW      [2, H, 4H]    bf16  gradient of w_hh (x @ w layout)
// Gate order i, f, g, o. h and c start at zero.
//
// Cast sites (those of the Pallas path): w_hh bf16; xp f32; h_{t-1} rounded
// to bf16 before W.h with f32 accumulation; gate and cell math f32; hs, cs
// f32. Backward: gates recomputed from xp + W.bf16(h_{t-1}); dgates f32;
// dh_{t-1} = W^T.bf16(dgates) with f32 accumulation; dc <- dc.f;
// dW += dgates (x) h_{t-1} in f32 with f32 h_{t-1}, rounded to bf16 once,
// after the whole sum.
//
// What bounds them on this card. Each step is a [4H, H] x [H, BN] product
// (the backward adds a [H, 4H] x [4H, BN] one) that depends on the step
// before, L steps in a row. The f32 streams (xp in, hs and cs out; in the
// backward xp, hs, cs, g in and dxp out) are the least traffic, and at the
// training batch sizes they, not the operations, give the bound; so too
// for the inference kernel, which moves xp in and hs out and nothing else. The
// weights (w_hh^T: 512 KiB a direction at H=256) do not fit one SM's
// shared memory, so every step re-reads them from L2, as bilstm.cu does;
// at H=64 (32 KiB) they stay in L1. Design:
//   - one block per (direction, tile of BN batch rows); one warp per 16
//     hidden units, owning all four gate rows of those units, so the cell
//     (forward and backward) runs on the mma accumulator registers with
//     no exchange; the dh product's output lands on the same registers;
//   - products on the tensor cores as mma.sync.m16n8k16 (bf16 in, f32
//     accumulate) with A packed by the wrapper in fragment order (one
//     coalesced 512-byte load per warp and tile): w_hh^T for the gates,
//     w_hh for dh;
//   - bf16 h_{t-1} (and in the backward bf16 dgates) sit in shared memory
//     as the B operand, rows padded so fragment loads are conflict free;
//   - xp, g, hs, cs are read straight into registers: each warp access is
//     four full 32-byte sectors.
//   - dW is its own kernel, an f32 SIMT product with a fixed split over the
//     n*L rows and a second pass that sums the splits in order: no
//     atomics, so the gradient is the same on every run.
// Keeping the weights on chip across steps (thread-block clusters), wgmma,
// TMA, and fusing dW into the sweep at H=64 are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

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

// dW partial sums. Rows m of direction d are the (n, t) pairs whose step
// has a predecessor: m = n_idx * (L-1) + q, t = q + 1 - d, t_prev = q + d.
// part [splits, 2, H, 4H] f32. Block tile 64 (h) x 64 (k), 256 threads of
// 4 x 4 outputs, 16 rows per stage. grid = (ceil(4H/64), ceil(H/64),
// 2 * splits), blockIdx.z = d * splits + split.
constexpr int kTile = 64;
constexpr int kRows = 16;

__global__ void __launch_bounds__(256)
lstm_dw_partial_kernel(const float* __restrict__ dxp,
                       const float* __restrict__ hs, float* __restrict__ part,
                       int n, int seq_len, int hidden, int splits,
                       int chunk) {
  __shared__ __align__(16) float s_a[kRows][kTile];  // h_{t-1}[m, h]
  __shared__ __align__(16) float s_b[kRows][kTile];  // dxp[m, k]
  const int four_h = 4 * hidden;
  const int k0 = blockIdx.x * kTile;
  const int h0 = blockIdx.y * kTile;
  const int d = blockIdx.z / splits;
  const int split = blockIdx.z - d * splits;
  const int steps = seq_len - 1;
  const long long rows = (long long)n * steps;
  const long long m_begin = (long long)split * chunk;
  const long long m_end =
      m_begin + chunk < rows ? m_begin + chunk : rows;
  const int tx = threadIdx.x & 15;  // k: 4 * tx .. 4 * tx + 3
  const int ty = threadIdx.x >> 4;  // h: 4 * ty .. 4 * ty + 3
  // this thread's loads: row lr of the stage, 4 columns from 4 * lc
  const int lr = threadIdx.x >> 4;
  const int lc = (threadIdx.x & 15) * 4;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (long long m0 = m_begin; m0 < m_end; m0 += kRows) {
    const long long m = m0 + lr;
    float4 va = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 vb = va;
    if (m < m_end) {
      const long long n_idx = m / steps;
      const int q = (int)(m - n_idx * steps);
      const int t = q + 1 - d;
      const int tp = q + d;
      if (h0 + lc < hidden)
        va = *reinterpret_cast<const float4*>(
            hs + ((n_idx * seq_len + tp) * 2 + d) * hidden + h0 + lc);
      if (k0 + lc < four_h)
        vb = *reinterpret_cast<const float4*>(
            dxp + ((n_idx * seq_len + t) * 2 + d) * four_h + k0 + lc);
    }
    *reinterpret_cast<float4*>(&s_a[lr][lc]) = va;
    *reinterpret_cast<float4*>(&s_b[lr][lc]) = vb;
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(&s_a[r][4 * ty]);
      const float4 b = *reinterpret_cast<const float4*>(&s_b[r][4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = part + (((size_t)split * 2 + d) * hidden) * four_h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int h = h0 + 4 * ty + i;
    if (h >= hidden) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + 4 * tx + j;
      if (k < four_h) out[(size_t)h * four_h + k] = acc[i][j];
    }
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

// part: scratch [splits, 2, H, 4H] f32; dw [2, H, 4H] bf16
extern "C" int nsp_lstm_dw(const void* dxp, const void* hs, void* part,
                           void* dw, int n, int seq_len, int hidden,
                           int splits, void* stream) {
  if (bad_shape(n, seq_len, hidden) || splits <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long rows = (long long)n * (seq_len - 1);
  long long chunk = (rows + splits - 1) / splits;
  chunk = (chunk + kRows - 1) / kRows * kRows;
  if (chunk > 0x7fffffff) return (int)cudaErrorInvalidValue;
  dim3 grid((4 * hidden + kTile - 1) / kTile, (hidden + kTile - 1) / kTile,
            2 * splits);
  lstm_dw_partial_kernel<<<grid, 256, 0, st>>>(
      static_cast<const float*>(dxp), static_cast<const float*>(hs),
      static_cast<float*>(part), n, seq_len, hidden, splits, (int)chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int size = 2 * hidden * 4 * hidden;
  lstm_dw_sum_kernel<<<(size + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<__nv_bfloat16*>(dw),
      size, splits);
  return (int)cudaGetLastError();
}
