// Per-waveform DSP features: arrival, PSD, total and peak, one thread per
// waveform row.
//
// Replaces waveformml_tpu/ops/pallas_dsp.py:waveform_features_pallas (the
// Pallas kernel `_kernel`, math in `_features_math`, TILE_N = 256 rows per
// grid step), which worked on whole [TILE_N, S] tiles with one-hot selects
// and full-row weight vectors, the form a TPU's vector unit wants.
//
// Bound on the H100: bytes. Each sample is read once and feeds a few
// operations; the four outputs are 16 bytes a row.
//
// Design: the work of a row is a scan whose indices depend on its data (the
// first crossing of half the peak, then two windows placed by the arrival),
// so each thread owns one row and reads it sequentially. A block stages
// `rows` rows into shared memory first, with coalesced loads: 16-byte loads
// over the block's span when rows are contiguous (stride == S) and the
// pointer 16-byte aligned, 4-byte loads along each row otherwise. In shared
// memory a row takes `sp` words, S padded to an odd number, so that the
// threads of a warp, each reading the same sample of its own row, hit 32
// distinct banks. Three passes per thread:
//   1. peak and total;
//   2. the first sample above 0.5·peak and the arrival, with the cases of
//      the plain version (crossing at sample 0, none at all);
//   3. the fast and slow integrals over only the samples in
//      [ceil(r0) - 1, floor(r1) + 1] of each window, with the boundary
//      weights of integrate_lininterp_range (samples outside [0, S) add
//      nothing).
// The float operations are those of the plain version, except that the
// kernel accumulates the three sums (of fp32 products) in double, so that
// each rounds once: the plain version sums in fp32 in another order, and
// where a sum cancels (signed noise) the two then differ by the plain
// version's rounding alone, which features_close in
// ops/waveform_features.py bounds by the row's condition number.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// PSD_WINDOW_LO, PSD_DIVIDER and PSD_WINDOW_HI of ops/waveform_features.py
constexpr float PSD_WINDOW_LO = -3.0f;
constexpr float PSD_DIVIDER = 11.0f;
constexpr float PSD_WINDOW_HI = 50.0f;

// Σ_i w[i]·x[i] over the samples of the fractional range [r0, r1], with the
// per-sample weights of the plain version's _window_weights.
__device__ __forceinline__ float window_integral(const float* x, int s, float r0, float r1) {
  const float i0 = ceilf(r0), d0 = i0 - r0;
  const float i1 = floorf(r1), d1 = r1 - i1;
  const float c0 = (1 - d0) * (1 - d0) / 2, e0 = d0 * d0 / 2;
  const float c1 = (1 - d1) * (1 - d1) / 2, e1 = d1 * d1 / 2;
  // clamp in float first, so that no out-of-range value is converted
  const int lo = static_cast<int>(fmaxf(i0 - 1.0f, 0.0f));
  const int hi = static_cast<int>(fminf(i1 + 1.0f, static_cast<float>(s - 1)));
  double sum = 0.0;
  for (int i = lo; i <= hi; ++i) {
    const float fi = static_cast<float>(i);
    float w = (fi >= i0 && fi <= i1) ? 1.f : 0.f;
    w = w - (fi == i0 ? c0 : 0.f);
    w = w + (fi == i0 - 1 ? e0 : 0.f);
    w = w - (fi == i1 ? c1 : 0.f);
    w = w + (fi == i1 + 1 ? e1 : 0.f);
    sum += static_cast<double>(x[i] * w);   // the product rounds to float first
  }
  return static_cast<float>(sum);
}

__global__ void waveform_features_kernel(const float* __restrict__ wfs,
                                         float* __restrict__ arrival_out,
                                         float* __restrict__ psd_out,
                                         float* __restrict__ total_out,
                                         float* __restrict__ peak_out,
                                         int n, int s, int64_t stride, int sp,
                                         int vec_span) {
  extern __shared__ __align__(16) float tile[];   // [rows, sp]
  const int rows = blockDim.x;
  const int t = threadIdx.x;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * rows;
  const int nrows = n - row0 < rows ? static_cast<int>(n - row0) : rows;

  // -- stage the block's rows, each sample read once, coalesced --------------
  if (vec_span) {
    // rows are contiguous: one span of nrows·S floats, 16-byte aligned
    const float* base = wfs + row0 * s;
    const int total = nrows * s;
    const int n4 = total / 4;
    const float4* base4 = reinterpret_cast<const float4*>(base);
    for (int i = t; i < n4; i += rows) {
      const float4 v = base4[i];
      const float vals[4] = {v.x, v.y, v.z, v.w};
      int e = 4 * i;
      int r = e / s, c = e - r * s;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        tile[r * sp + c] = vals[q];
        if (++c == s) { c = 0; ++r; }
      }
    }
    for (int e = 4 * n4 + t; e < total; e += rows) {
      const int r = e / s;
      tile[r * sp + (e - r * s)] = base[e];
    }
  } else {
    // general row stride: each warp reads rows along their samples
    const int warps = rows / 32, lane = t & 31;
    for (int r = t / 32; r < nrows; r += warps) {
      const float* src = wfs + (row0 + r) * stride;
      for (int c = lane; c < s; c += 32) tile[r * sp + c] = src[c];
    }
  }
  __syncthreads();
  if (t >= nrows) return;

  const float* x = tile + t * sp;
  // -- 1. peak and total ------------------------------------------------------
  float peak = x[0];
  double total = 0.0;
  for (int i = 0; i < s; ++i) {
    peak = fmaxf(peak, x[i]);
    total += x[i];
  }
  // -- 2. first crossing and arrival ------------------------------------------
  const float thresh = 0.5f * peak;
  int first = s + 1;                 // no crossing
  for (int i = 0; i < s; ++i) {
    if (x[i] > thresh) { first = i; break; }
  }
  float arrival = 0.f;
  if (first <= s) {
    const float cur = x[first];
    if (first == 0) {
      arrival = cur != 0.f ? thresh / cur : 0.f;
    } else {
      const float prev = x[first - 1];
      const float diff = cur - prev;
      arrival = static_cast<float>(first) + (thresh - prev) / (diff == 0.f ? 1e-30f : diff);
    }
  }
  // -- 3. the two integration windows ------------------------------------------
  const float fast = window_integral(x, s, arrival + PSD_WINDOW_LO, arrival + PSD_DIVIDER);
  const float slow = window_integral(x, s, arrival + PSD_DIVIDER, arrival + PSD_WINDOW_HI);
  const float den = fast + slow;
  const int64_t row = row0 + t;
  arrival_out[row] = arrival;
  psd_out[row] = den == 0.f ? 0.f : slow / den;
  total_out[row] = static_cast<float>(total);
  peak_out[row] = peak;
}

}  // namespace

extern "C" {

// wfs: device pointer to n rows of s floats, `stride` floats apart; outputs
// are n floats each. `rows` rows per block (a multiple of 32), `sp` the
// shared-memory row stride in words (>= s). Launches on `stream` and returns
// the launch's cudaError_t (0 on success) without synchronising.
int waveform_features_fwd(const float* wfs, float* arrival, float* psd,
                          float* total, float* peak, int n, int s,
                          long long stride, int rows, int sp, void* stream) {
  if (n == 0) return 0;
  if (rows <= 0 || rows % 32 != 0 || sp < s) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * static_cast<size_t>(rows) * sp;
  static size_t configured = 48 * 1024;   // dynamic shared memory allowed so far
  if (smem > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        waveform_features_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = smem;
  }
  const int vec_span = stride == s && reinterpret_cast<uintptr_t>(wfs) % 16 == 0 &&
                       (static_cast<long long>(rows) * s) % 4 == 0;
  const int blocks = (n + rows - 1) / rows;
  waveform_features_kernel<<<blocks, rows, smem, static_cast<cudaStream_t>(stream)>>>(
      wfs, arrival, psd, total, peak, n, s, stride, sp, vec_span);
  return static_cast<int>(cudaGetLastError());
}

const char* wf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
