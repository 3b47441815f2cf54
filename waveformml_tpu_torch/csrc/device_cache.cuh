// A host-side cache of one value per CUDA device, for the launch functions.
//
// A kernel's dynamic shared-memory limit (cudaFuncSetAttribute) and the
// opt-in shared-memory size of a block are properties of a device. A process
// may launch on several devices, and from several host threads, so each
// launch function keeps what it has set or read in a DeviceCache, keyed by
// cudaGetDevice() and guarded by a mutex.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <mutex>

constexpr int WF_MAX_DEVICES = 64;

struct DeviceCache {
  std::mutex mu;
  size_t value[WF_MAX_DEVICES] = {};   // per device; 0 = nothing cached yet
};

// The current device, checked against the cache's size.
inline cudaError_t current_device(int* device) {
  const cudaError_t err = cudaGetDevice(device);
  if (err != cudaSuccess) return err;
  return *device >= 0 && *device < WF_MAX_DEVICES ? cudaSuccess : cudaErrorInvalidDevice;
}

// Where `need` exceeds the value cached for the current device, call `set()`
// (a cudaFuncSetAttribute of the caller's kernel), and cache `need` if it
// succeeds.
template <typename Set>
cudaError_t raise_per_device(DeviceCache& cache, size_t need, Set set) {
  int device = 0;
  cudaError_t err = current_device(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(cache.mu);
  if (need <= cache.value[device]) return cudaSuccess;
  err = set();
  if (err == cudaSuccess) cache.value[device] = need;
  return err;
}

// The current device's opt-in shared memory per block, read once a device.
inline cudaError_t optin_smem(DeviceCache& cache, size_t* bytes) {
  int device = 0;
  cudaError_t err = current_device(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(cache.mu);
  if (cache.value[device] == 0) {
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return err;
    cache.value[device] = static_cast<size_t>(optin);
  }
  *bytes = cache.value[device];
  return cudaSuccess;
}
