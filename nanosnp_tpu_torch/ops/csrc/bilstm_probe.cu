// Knock-out probe of the fused BiLSTM layer, for Hopper (sm_90a). Plain C
// interface, loaded with ctypes.
//
// Replaces the Pallas TPU kernel `_variant_kernel` of
// scripts/kernel_probe.py: the pileup model's first layer (L 33, D 18,
// H 64) with one part of the per-step cost removed at a time, so that
// timing the variants against each other says where a step's time sits.
//
// The kernel is bilstm.cu's fused stream kernel with bf16 output, the
// layer `bilstm_stream` runs, built from the same device code
// (bilstm_layer.cuh fused_layer) with a KnockOut parameter; it keeps no
// layer code of its own. Its plan is the stream kernel's
// (ops/bilstm.py plan_layer, center false), checked as bilstm.cu checks
// it. The modes (bilstm_layer.cuh states each):
//   0 full    KnockOut::kNone: the code of nsp_bilstm_stream with bf16
//             output, the same bits;
//   1 nogate  KnockOut::kNoGate: no SFU gate math, a linear combine;
//   2 nomm    KnockOut::kNoMm: no W_hh . h product;
//   3 nodma   KnockOut::kNoDma: x staged once, the first step's slab used
//             at every step. The TPU probe knocked out its DMA; on this
//             card the per-step cp.async of x_t stands in for it.
// What bounds it: the layer's own bound (bilstm.cu, path 1), the latency
// of L dependent steps; each mode's time against `full` is the share of a
// step that its part takes.

#include "bilstm_layer.cuh"

namespace {

// x     [n, seq_len, d_x] bf16, d_x even (the wrapper pads an odd D)
// wpk   [2, 4H/16, Kp/16, 32 lanes, 8] bf16 (ops/bilstm.py pack_weights)
// bias  [2, 4H] f32
// out   [n, seq_len, 2H] bf16 (dir 0 in [0, H))
// block = (H/16) x (bn/32) warps; grid = (ceil(n / bn), 2 directions);
// shared: weights 4H Kp, then x [2][bn][Dp + 8], then h [2][bn][H + 8]
template <KnockOut kKnock>
__global__ void __launch_bounds__(512)
bilstm_probe_kernel(const __nv_bfloat16* __restrict__ x,
                    const uint4* __restrict__ wpk,
                    const float* __restrict__ bias,
                    __nv_bfloat16* __restrict__ out, int n, int seq_len,
                    int d_x, int hidden, int bn) {
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
  fused_layer<false, true, __nv_bfloat16, 4, kKnock>(
      x, s_w, bias + dir * 4 * hidden, out, s_x, s_h, n, seq_len, d_x, hidden,
      bn, dir, blockIdx.x * bn);
}

template <KnockOut kKnock>
int launch(const void* x, const void* wpk, const void* b, void* out, int n,
           int seq_len, int d_x, int hidden, int bn, int smem, int grid_x,
           cudaStream_t stream) {
  auto kernel = bilstm_probe_kernel<kKnock>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(grid_x, 2), hidden / 16 * (bn / 32) * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint4*>(wpk),
      static_cast<const float*>(b), static_cast<__nv_bfloat16*>(out), n,
      seq_len, d_x, hidden, bn);
  return (int)cudaGetLastError();
}

}  // namespace

// bn, smem and grid_x are the wrapper's plan (ops/bilstm.py plan_layer,
// center false), checked here: kPlanError where it does not match the
// shape. mode: 0 full, 1 nogate, 2 nomm, 3 nodma.
extern "C" int nsp_bilstm_probe(const void* x, const void* wpk, const void* b,
                                void* out, int n, int seq_len, int d_x,
                                int hidden, int bn, int smem, int grid_x,
                                int mode, void* stream) {
  if (!fused_plan_ok(n, seq_len, d_x, hidden, bn, smem, grid_x))
    return kPlanError;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0:
      return launch<KnockOut::kNone>(x, wpk, b, out, n, seq_len, d_x, hidden,
                                     bn, smem, grid_x, st);
    case 1:
      return launch<KnockOut::kNoGate>(x, wpk, b, out, n, seq_len, d_x,
                                       hidden, bn, smem, grid_x, st);
    case 2:
      return launch<KnockOut::kNoMm>(x, wpk, b, out, n, seq_len, d_x, hidden,
                                     bn, smem, grid_x, st);
    case 3:
      return launch<KnockOut::kNoDma>(x, wpk, b, out, n, seq_len, d_x,
                                      hidden, bn, smem, grid_x, st);
    default:
      return kPlanError;
  }
}
