// Knock-out probe of the fused BiLSTM layer kernel, for Hopper (sm_90a).
// Plain C interface, loaded with ctypes.
//
// Replaces the Pallas TPU kernel `_variant_kernel` of
// scripts/kernel_probe.py: the pileup model's first layer (L 33, D 18,
// H 64) with one resource of the per-step cost removed at a time, so that
// timing the variants against each other says where a step's time sits.
//
// It is the design of csrc/bilstm.cu's bilstm_layer_kernel, kept as a
// second copy so that the production kernel's code, registers and times
// cannot move with the probe: one block per (direction, tile of 32 batch
// rows), one warp per 16 hidden units owning all four gates, the product
// [4H, Kp] x [Kp, 32] as mma.sync.m16n8k16 (bf16 in, f32 accumulate) with
// the weights read from L1/L2 in A-fragment order, x_t and bf16 h_{t-1}
// side by side in shared memory as the B operand. Every h_t is written,
// bf16, [n, seq_len, 2H].
//
// The mode is a compile-time parameter. What each computes, and which
// barriers and stores remain (a full step has: x_t global -> shared,
// barrier A, the product, barrier B, gate math, h -> shared and global):
//   kFull    exactly nsp_bilstm_stream with bf16 output.
//   kNoGate  c = 0.5 c + 0.25 (g_i + g_f), h = 0.5 c + 0.125 (g_g + g_o)
//            on the f32 gate sums: no expf, no tanhf. Loads, both
//            barriers, the whole product and both stores of h remain.
//   kNoMm    gates = W_ih x_t + b: the k-tiles of W_hh . h are skipped.
//            h is still rounded to bf16 and stored to shared memory every
//            step (through a volatile pointer, so the compiler cannot drop
//            a store that nothing reads), and both barriers remain.
//   kNoLoad  the TPU probe's "nodma": there is no DMA engine to knock out
//            on this card, what stands in for it is the per-step
//            global -> shared staging of x_t. It is hoisted out of the
//            time loop: the slab of the direction's first step (x[0] for
//            direction 0, x[L-1] for direction 1) is staged once and used
//            at every step. Both barriers remain in the loop: A still
//            orders the h store of the previous step before the product.
// What bounds it: at H 64 a step is a [256, 96] x [96, 32] product between
// two barriers in a 4-warp block, far below both the memory and the
// tensor-core rate; the probe exists to say which part of that step's
// latency dominates.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kMaxWarps = 16;  // H <= 256
constexpr int kNT = 4;         // n-tiles of 8 batch rows per block
constexpr int kBN = 8 * kNT;   // batch rows per block
constexpr int kRowPad = 8;     // bf16 pad per shared row (bank conflicts)

enum Mode { kFull = 0, kNoGate = 1, kNoMm = 2, kNoLoad = 3 };

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

// stage x at time t of the block's tile into the x columns of the shared
// rows; rows past n read as zero and are never stored
__device__ __forceinline__ void stage_x(__nv_bfloat16* s_v,
                                        const __nv_bfloat16* __restrict__ x,
                                        int n, int n0, int seq_len, int d_in,
                                        int ld, int t) {
  for (int i = threadIdx.x; i < kBN * d_in; i += blockDim.x) {
    const int r = i / d_in;
    const int d = i - r * d_in;
    const int row = n0 + r;
    s_v[r * ld + d] = row < n ? x[((size_t)row * seq_len + t) * d_in + d]
                              : __float2bfloat16_rn(0.0f);
  }
}

// x     [n, seq_len, d_in] bf16
// wpk   [2, 4H/16, Kp/16, 32 lanes, 8] bf16 (bilstm.py pack_weights)
// bias  [2, 4H] f32
// out   [n, seq_len, 2H] bf16 (dir 0 in [0, H))
// block = H/16 warps, grid = (ceil(n / kBN), 2 directions)
template <int kMode>
__global__ void __launch_bounds__(kMaxWarps * 32)
bilstm_probe_kernel(const __nv_bfloat16* __restrict__ x,
                    const uint4* __restrict__ wpk,
                    const float* __restrict__ bias,
                    __nv_bfloat16* __restrict__ out, int n, int seq_len,
                    int d_in, int hidden) {
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* s_v = reinterpret_cast<__nv_bfloat16*>(smem_u4);

  const int d_pad = (d_in + 15) / 16 * 16;
  const int k_pad = d_pad + hidden;
  const int k_tiles = k_pad / 16;
  // kNoMm: only the k-tiles that hold x_t enter the product
  const int k_tiles_used = kMode == kNoMm ? d_pad / 16 : k_tiles;
  const int ld = k_pad + kRowPad;  // shared row stride, in bf16
  const int m_tiles_gate = hidden / 16;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grp = lane >> 2;  // fragment row group
  const int tig = lane & 3;   // thread in group
  const int dir = blockIdx.y;
  const int n0 = blockIdx.x * kBN;

  // zero the whole tile once: the D padding stays zero, and h_{-1} = 0
  for (int i = threadIdx.x; i < kBN * ld; i += blockDim.x)
    s_v[i] = __float2bfloat16_rn(0.0f);

  const int j_lo = warp * 16 + grp;
  const int j_hi = j_lo + 8;
  float b_lo[4], b_hi[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    b_lo[g] = bias[dir * 4 * hidden + g * hidden + j_lo];
    b_hi[g] = bias[dir * 4 * hidden + g * hidden + j_hi];
  }
  const uint4* wdir =
      wpk + (size_t)dir * 4 * m_tiles_gate * k_tiles * 32 + lane;
  const uint4* wg[4];
#pragma unroll
  for (int g = 0; g < 4; ++g)
    wg[g] = wdir + (size_t)(g * m_tiles_gate + warp) * k_tiles * 32;

  float c[kNT][4];
#pragma unroll
  for (int t = 0; t < kNT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[t][e] = 0.0f;

  __syncthreads();
  if (kMode == kNoLoad) {
    // the one staging of this mode; barrier A of the first step orders it
    // before the first product
    stage_x(s_v, x, n, n0, seq_len, d_in, ld, dir == 0 ? 0 : seq_len - 1);
  }

  for (int s = 0; s < seq_len; ++s) {
    const int t = dir == 0 ? s : seq_len - 1 - s;
    if (kMode != kNoLoad) stage_x(s_v, x, n, n0, seq_len, d_in, ld, t);
    __syncthreads();  // barrier A: x_t and h_{t-1} are in shared memory

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
    for (int kt = 0; kt < k_tiles_used; ++kt) {
      uint4 a[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) a[g] = __ldg(wg[g] + kt * 32);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const __nv_bfloat16* bp =
            s_v + (nt * 8 + grp) * ld + kt * 16 + 2 * tig;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(bp);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(bp + 8);
#pragma unroll
        for (int g = 0; g < 4; ++g) mma_bf16(acc[g][nt], a[g], b0, b1);
      }
    }
    __syncthreads();  // barrier B: every read of h_{t-1} is done

#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float h;
        if (kMode == kNoGate) {
          c[nt][e] = 0.5f * c[nt][e] +
                     0.25f * (acc[0][nt][e] + acc[1][nt][e]);
          h = 0.5f * c[nt][e] + 0.125f * (acc[2][nt][e] + acc[3][nt][e]);
        } else {
          const float ig = sigmoid_f32(acc[0][nt][e]);
          const float fg = sigmoid_f32(acc[1][nt][e]);
          const float gg = tanhf(acc[2][nt][e]);
          const float og = sigmoid_f32(acc[3][nt][e]);
          c[nt][e] = fg * c[nt][e] + ig * gg;
          h = og * tanhf(c[nt][e]);
        }
        const int r = nt * 8 + 2 * tig + (e & 1);
        const int j = e < 2 ? j_lo : j_hi;
        const __nv_bfloat16 hb = __float2bfloat16_rn(h);
        if (kMode == kNoMm) {
          // nothing reads it: keep the store all the same
          *reinterpret_cast<volatile unsigned short*>(
              s_v + r * ld + d_pad + j) = __bfloat16_as_ushort(hb);
        } else {
          s_v[r * ld + d_pad + j] = hb;
        }
        const int row = n0 + r;
        if (row < n)
          out[((size_t)row * seq_len + t) * 2 * hidden + dir * hidden + j] =
              hb;
      }
    }
  }
}

template <int kMode>
int launch(const void* x, const void* wpk, const void* b, void* out, int n,
           int seq_len, int d_in, int hidden, cudaStream_t stream) {
  const int d_pad = (d_in + 15) / 16 * 16;
  const size_t smem =
      (size_t)kBN * (d_pad + hidden + kRowPad) * sizeof(__nv_bfloat16);
  auto kernel = bilstm_probe_kernel<kMode>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + kBN - 1) / kBN, 2);
  kernel<<<grid, hidden / 16 * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint4*>(wpk),
      static_cast<const float*>(b), static_cast<__nv_bfloat16*>(out), n,
      seq_len, d_in, hidden);
  return (int)cudaGetLastError();
}

}  // namespace

// mode: 0 full, 1 nogate, 2 nomm, 3 noload
extern "C" int nsp_bilstm_probe(const void* x, const void* wpk, const void* b,
                                void* out, int mode, int n, int seq_len,
                                int d_in, int hidden, void* stream) {
  if (n <= 0 || seq_len <= 0 || d_in <= 0 || hidden <= 0 || hidden % 16 ||
      hidden > 16 * kMaxWarps)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kFull:
      return launch<kFull>(x, wpk, b, out, n, seq_len, d_in, hidden, st);
    case kNoGate:
      return launch<kNoGate>(x, wpk, b, out, n, seq_len, d_in, hidden, st);
    case kNoMm:
      return launch<kNoMm>(x, wpk, b, out, n, seq_len, d_in, hidden, st);
    case kNoLoad:
      return launch<kNoLoad>(x, wpk, b, out, n, seq_len, d_in, hidden, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
