// Site-grouped head GEMM, forward: a grouped GEMM with a gather prologue and
// a scatter-add epilogue.
//
// Replaces waveformml_tpu/ops/site_head.py:site_grouped_matmul, which XLA
// ran on the TPU as a row gather, one batched einsum over the site groups
// and an event scatter-add:
//
//   rs[g, m]        = rows[take1[g, m] - 1]          (take1 = 0: empty slot)
//   out[ev1[g,m]-1] += rs[g, m] @ k3[:, site1[g] - 1, :]   (ev1 = 0: dropped)
//
// Bound on the H100: bytes. With C = 8 channels and F = 50 features the work
// is 2·C·F = 800 FLOP per filled slot against ~C·4 bytes of row plus 200
// bytes of output traffic, far below the card's ridge point; the whole
// operation moves ~2 MB at 4096 events, so a launch costs more than either
// bound. Design: one block per (site group, tile of SLOTS slots) reads its
// group's [C, F] weight slice and its gathered rows into shared memory once,
// skips tiles whose slots are all empty, and adds each slot's F outputs into
// the event's row with fp32 atomics. The atomics' order varies from run to
// run, so a sum of m rows differs from the plain version's by at most
// ~m ulp of the result.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SLOTS = 32;     // slots per block
constexpr int THREADS = 128;  // must be >= SLOTS

__global__ void __launch_bounds__(THREADS)
site_grouped_matmul_kernel(const float* __restrict__ rows,
                           const float* __restrict__ k3,
                           const int32_t* __restrict__ take1,
                           const int32_t* __restrict__ ev1,
                           const int32_t* __restrict__ site1,
                           float* __restrict__ out,
                           int c, int s, int f, int max_slots, int n_events) {
  extern __shared__ float smem[];
  float* kg = smem;               // [c, f]  weight slice of this group's site
  float* rs = smem + c * f;       // [SLOTS, c] gathered rows
  __shared__ int ev_tile[SLOTS];  // 0-based event per slot, -1 = skip
  __shared__ int take_tile[SLOTS];

  const int g = blockIdx.x;
  const int m0 = blockIdx.y * SLOTS;
  const int t = threadIdx.x;

  int live = 0;
  if (t < SLOTS) {
    const int slot = m0 + t;
    const int64_t at = (int64_t)g * max_slots + slot;
    const int take = slot < max_slots ? take1[at] : 0;
    const int ev = slot < max_slots ? ev1[at] : 0;
    live = take > 0 && ev > 0 && ev <= n_events;
    take_tile[t] = take;
    ev_tile[t] = live ? ev - 1 : -1;
  }
  if (!__syncthreads_or(live)) return;

  int site = site1[g] - 1;
  site = site < 0 ? 0 : (site >= s ? s - 1 : site);
  for (int i = t; i < c * f; i += THREADS) {
    const int cc = i / f, ff = i % f;
    kg[i] = k3[((int64_t)cc * s + site) * f + ff];
  }
  for (int i = t; i < SLOTS * c; i += THREADS) {
    const int m = i / c, cc = i % c;
    const int take = take_tile[m];
    rs[i] = (ev_tile[m] >= 0) ? rows[(int64_t)(take - 1) * c + cc] : 0.f;
  }
  __syncthreads();

  for (int i = t; i < SLOTS * f; i += THREADS) {
    const int m = i / f, ff = i % f;
    const int ev = ev_tile[m];
    if (ev < 0) continue;
    float acc = 0.f;
    for (int cc = 0; cc < c; ++cc) acc = fmaf(rs[m * c + cc], kg[cc * f + ff], acc);
    atomicAdd(&out[(int64_t)ev * f + ff], acc);
  }
}

}  // namespace

extern "C" {

// All pointers are device pointers; out must be zero-filled [n_events, f].
// Launches on `stream` and returns the launch's cudaError_t (0 on success).
int site_grouped_matmul_fwd(const float* rows, const float* k3,
                            const int32_t* take1, const int32_t* ev1,
                            const int32_t* site1, float* out, int groups,
                            int max_slots, int c, int s, int f, int n_events,
                            void* stream) {
  if (groups == 0 || max_slots == 0 || f == 0) return 0;
  const size_t smem = sizeof(float) * (size_t)(c * f + SLOTS * c);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        site_grouped_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(groups, (max_slots + SLOTS - 1) / SLOTS);
  site_grouped_matmul_kernel<<<grid, THREADS, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      rows, k3, take1, ev1, site1, out, c, s, f, max_slots, n_events);
  return static_cast<int>(cudaGetLastError());
}

const char* wf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
