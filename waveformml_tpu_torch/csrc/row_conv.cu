// Row-space submanifold convolution, forward: a gather-fused GEMM.
//
// Replaces waveformml_tpu/ops/row_conv.py:subm_conv_rows (_masked_gather +
// _gather_gemm), which XLA ran on the TPU as a gather into an [N, K², Cin]
// operand followed by one GEMM:
//
//   out[r] = mask[r] · (Σ_k feats[plan[r, k]] @ W[k] + bias),  plan = -1 → 0
//
// Bound on the H100: in fp32 without tensor cores the dense-tap work
// 2·N·K²·Cin·Cout is compute-bound (arithmetic intensity ~100 FLOP/byte for
// the 130→104 layer), but most taps are absent (-1): a real row has ~1 of 9
// neighbours at detector occupancy, so the data needs ~1/8 of that work.
// Design: the gather is fused into the operand load, so the [N, K², Cin]
// operand never exists in device memory; a block skips every tap that is
// absent for all of its rows; the sum is kept in fp32 registers (FFMA, no
// TF32, so the plain PyTorch version can be held to a tight tolerance).
//
// Each block owns a BM x BN tile of out. For each tap it streams BK-channel
// slices of the gathered rows (zeros for -1 taps and channels past Cin) and
// of W[k] through shared memory; each of 256 threads accumulates 4 x 4
// outputs. The epilogue adds the bias and zeroes rows whose mask is off.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // rows per block
constexpr int BN = 64;        // output channels per block
constexpr int BK = 16;        // input channels per shared-memory stage
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

__global__ void __launch_bounds__(THREADS)
subm_conv_rows_kernel(const float* __restrict__ feats,
                      const int32_t* __restrict__ plan,
                      const float* __restrict__ weight,
                      const float* __restrict__ bias,
                      const uint8_t* __restrict__ mask,
                      float* __restrict__ out,
                      int n, int cin, int cout, int kk) {
  __shared__ __align__(16) float a_tile[BK][BM];  // gathered rows, transposed
  __shared__ __align__(16) float b_tile[BK][BN];  // W[k] slice

  const int t = threadIdx.x;
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  // compute coordinates: rows ty*4.., output channels tx*4..
  const int ty = t / 16, tx = t % 16;
  // load coordinates: A is BM rows x BK channels, 4 threads per row;
  // B is BK channels x BN outputs, 16 threads per channel
  const int a_row = t / 4, a_col = (t % 4) * 4;
  const int b_row = t / 16, b_col = (t % 16) * 4;
  const int r = row0 + a_row;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k = 0; k < kk; ++k) {
    const int src = (r < n) ? plan[(int64_t)r * kk + k] : -1;
    // a tap absent for every row of the tile contributes nothing
    if (!__syncthreads_or(src >= 0)) continue;
    const float* src_row = feats + (int64_t)(src < 0 ? 0 : src) * cin;
    const float* w_k = weight + (int64_t)k * cin * cout;
    for (int c0 = 0; c0 < cin; c0 += BK) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = c0 + a_col + q;
        a_tile[a_col + q][a_row] = (src >= 0 && c < cin) ? src_row[c] : 0.f;
      }
      const int wc = c0 + b_row;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int o = col0 + b_col + q;
        b_tile[b_row][b_col + q] =
            (wc < cin && o < cout) ? w_k[(int64_t)wc * cout + o] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kq = 0; kq < BK; ++kq) {
        const float4 a = *reinterpret_cast<const float4*>(&a_tile[kq][ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&b_tile[kq][tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    if (row >= n) continue;
    const bool keep = mask[row] != 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = col0 + tx * 4 + j;
      if (o >= cout) continue;
      const float b = bias != nullptr ? bias[o] : 0.f;
      out[(int64_t)row * cout + o] = keep ? acc[i][j] + b : 0.f;
    }
  }
}

}  // namespace

extern "C" {

// All pointers are device pointers; bias may be null. Launches on `stream`
// and returns the launch's cudaError_t (0 on success) without synchronising.
int subm_conv_rows_fwd(const float* feats, const int32_t* plan,
                       const float* weight, const float* bias,
                       const uint8_t* mask, float* out, int n, int cin,
                       int cout, int kk, void* stream) {
  if (n == 0 || cout == 0) return 0;
  const dim3 grid((n + BM - 1) / BM, (cout + BN - 1) / BN);
  subm_conv_rows_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      feats, plan, weight, bias, mask, out, n, cin, cout, kk);
  return static_cast<int>(cudaGetLastError());
}

const char* wf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
