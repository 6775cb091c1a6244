// The device of a launcher's C entry point. DeviceScope makes `device`
// the thread's current CUDA device for the launch and gives the caller's
// device back when the entry point returns, so that a launch on one card
// of a mesh leaves the current device, which PyTorch reads for every call
// that names no card, as it found it. It switches only when the two
// differ: a launch that a stream of `device` captures into a CUDA graph
// calls no cudaSetDevice.

#pragma once

#include <cuda_runtime.h>

class DeviceScope {
 public:
  explicit DeviceScope(int device) {
    err_ = cudaGetDevice(&prev_);
    if (err_ == cudaSuccess && prev_ != device) {
      err_ = cudaSetDevice(device);
      restore_ = err_ == cudaSuccess;
    }
  }
  ~DeviceScope() {
    if (restore_) cudaSetDevice(prev_);
  }
  DeviceScope(const DeviceScope&) = delete;
  DeviceScope& operator=(const DeviceScope&) = delete;

  // cudaSuccess, or the error of reading or switching the device
  cudaError_t error() const { return err_; }

 private:
  int prev_ = -1;
  bool restore_ = false;
  cudaError_t err_;
};
