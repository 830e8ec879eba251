// Bidirectional LSTM layer with the input projection fused into the
// recurrence, for Hopper (sm_90a). Plain C interface, loaded with ctypes.
//
// Replaces the Pallas TPU kernels of nanosnp_tpu/ops/pallas_lstm.py:
//   nsp_bilstm_stream  <- _enc_stream_kernel and _enc_stream_kfused_kernel
//                         (every h_t out, bf16 for inner layers, f32 last)
//   nsp_bilstm_center  <- _enc_center_kernel (only h at t = L//2, f32)
// The K-fusion of _enc_stream_kfused_kernel only filled the TPU's 128-deep
// matrix tile; it computes the same function, so one kernel serves both.
//
// Math (identical cast sites to the Pallas kernels):
//   gates_t = [w_ih | w_hh]^T . [x_t ; bf16(h_{t-1})] + b   (bf16 operands,
//             f32 accumulation), gate order i, f, g, o, one folded bias;
//   c_t = sig(f) c_{t-1} + sig(i) tanh(g);  h_t = sig(o) tanh(c_t)  (f32);
//   h and c start at zero; direction 1 walks time backwards, reading and
//   writing in true time order. D is zero-padded to a multiple of 16 in
//   the packed weights and in shared memory, which adds exact zeros.
//
// What bounds it on this card: each step is a [4H, Kp] x [Kp, BN] product
// (Kp = D padded + H) that depends on the previous step, L steps in a
// row. The operation count over the bf16 tensor-core peak gives the bound
// (about 0.9 ms per H=256 layer at N=8192), but at H=256 the weights
// (1.5 MiB a direction) do not fit one SM's shared memory, so this kernel
// reads them from L2 every step: L2 bandwidth, not the tensor cores, is
// what it spends its time on. Design:
//   - one block per (direction, tile of BN=32 batch rows); one warp per 16
//     hidden units, which owns all four gate blocks of those units, so the
//     cell update runs on the mma accumulator registers with no exchange;
//   - the product runs on the tensor cores as mma.sync.m16n8k16 (bf16 in,
//     f32 accumulate); the weights are packed by the wrapper in fragment
//     order, so one warp's A fragment is one coalesced 512-byte load;
//   - x_t and bf16 h_{t-1} sit side by side in shared memory as the B
//     operand, rows padded so the fragment loads are free of conflicts;
//   - the center variant stops at the step where its direction reaches
//     t = L//2, half the steps of the Pallas kernel, which ran all L.
// Keeping the weights on chip across steps (a thread-block cluster with
// distributed shared memory), wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kMaxWarps = 16;  // H <= 256
constexpr int kNT = 4;         // n-tiles of 8 batch rows per block
constexpr int kBN = 8 * kNT;   // batch rows per block
constexpr int kRowPad = 8;     // bf16 pad per shared row (bank conflicts)

__device__ __forceinline__ float sigmoid_f32(float v) {
  return 1.0f / (1.0f + expf(-v));
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

// x     [n, seq_len, d_in] bf16
// wpk   [2, 4H/16, Kp/16, 32 lanes, 8] bf16: per direction the matrix
//       A = [w_ih (D padded to Dp) ; w_hh]^T of shape [4H, Kp] in m16n8k16
//       A-fragment order (see bilstm.py pack_weights)
// bias  [2, 4H] f32
// out   kCenter ? [n, 2H] f32 : [n, seq_len, 2H] OutT (dir 0 in [0, H))
// block = H/16 warps, grid = (ceil(n / kBN), 2 directions)
template <bool kCenter, typename OutT>
__global__ void __launch_bounds__(kMaxWarps * 32)
bilstm_layer_kernel(const __nv_bfloat16* __restrict__ x,
                    const uint4* __restrict__ wpk,
                    const float* __restrict__ bias, OutT* __restrict__ out,
                    int n, int seq_len, int d_in, int hidden) {
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* s_v = reinterpret_cast<__nv_bfloat16*>(smem_u4);

  const int d_pad = (d_in + 15) / 16 * 16;
  const int k_pad = d_pad + hidden;
  const int k_tiles = k_pad / 16;
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

  // this thread's hidden units (rows of the accumulator fragments)
  const int j_lo = warp * 16 + grp;
  const int j_hi = j_lo + 8;
  float b_lo[4], b_hi[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    b_lo[g] = bias[dir * 4 * hidden + g * hidden + j_lo];
    b_hi[g] = bias[dir * 4 * hidden + g * hidden + j_hi];
  }
  // A fragments of gate g: m-tile g * m_tiles_gate + warp
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

  const int center = seq_len / 2;
  const int steps =
      kCenter ? (dir == 0 ? center + 1 : seq_len - center) : seq_len;
  __syncthreads();

  for (int s = 0; s < steps; ++s) {
    const int t = dir == 0 ? s : seq_len - 1 - s;
    // stage x_t of the tile; rows past n read as zero, are never stored
    for (int i = threadIdx.x; i < kBN * d_in; i += blockDim.x) {
      const int r = i / d_in;
      const int d = i - r * d_in;
      const int row = n0 + r;
      s_v[r * ld + d] = row < n ? x[((size_t)row * seq_len + t) * d_in + d]
                                : __float2bfloat16_rn(0.0f);
    }
    __syncthreads();

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
    for (int kt = 0; kt < k_tiles; ++kt) {
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
    __syncthreads();  // every read of h_{t-1} is done before it changes

#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float ig = sigmoid_f32(acc[0][nt][e]);
        const float fg = sigmoid_f32(acc[1][nt][e]);
        const float gg = tanhf(acc[2][nt][e]);
        const float og = sigmoid_f32(acc[3][nt][e]);
        c[nt][e] = fg * c[nt][e] + ig * gg;
        const float h = og * tanhf(c[nt][e]);
        const int r = nt * 8 + 2 * tig + (e & 1);
        const int j = e < 2 ? j_lo : j_hi;
        s_v[r * ld + d_pad + j] = __float2bfloat16_rn(h);
        const int row = n0 + r;
        if (row < n) {
          if (!kCenter) {
            out[((size_t)row * seq_len + t) * 2 * hidden + dir * hidden + j] =
                to_out<OutT>(h);
          } else if (t == center) {
            out[(size_t)row * 2 * hidden + dir * hidden + j] = to_out<OutT>(h);
          }
        }
      }
    }
  }
}

template <bool kCenter, typename OutT>
int launch(const void* x, const void* wpk, const void* b, void* out, int n,
           int seq_len, int d_in, int hidden, cudaStream_t stream) {
  if (n <= 0 || seq_len <= 0 || d_in <= 0 || hidden <= 0 || hidden % 16 ||
      hidden > 16 * kMaxWarps)
    return (int)cudaErrorInvalidValue;
  const int d_pad = (d_in + 15) / 16 * 16;
  const size_t smem =
      (size_t)kBN * (d_pad + hidden + kRowPad) * sizeof(__nv_bfloat16);
  auto kernel = bilstm_layer_kernel<kCenter, OutT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + kBN - 1) / kBN, 2);
  kernel<<<grid, hidden / 16 * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint4*>(wpk),
      static_cast<const float*>(b), static_cast<OutT*>(out), n, seq_len,
      d_in, hidden);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int nsp_bilstm_stream(const void* x, const void* wpk,
                                 const void* b, void* out, int out_f32, int n,
                                 int seq_len, int d_in, int hidden,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_f32)
    return launch<false, float>(x, wpk, b, out, n, seq_len, d_in, hidden, st);
  return launch<false, __nv_bfloat16>(x, wpk, b, out, n, seq_len, d_in,
                                      hidden, st);
}

extern "C" int nsp_bilstm_center(const void* x, const void* wpk,
                                 const void* b, void* out, int n, int seq_len,
                                 int d_in, int hidden, void* stream) {
  return launch<true, float>(x, wpk, b, out, n, seq_len, d_in, hidden,
                             static_cast<cudaStream_t>(stream));
}
