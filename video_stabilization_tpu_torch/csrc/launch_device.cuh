// The device of a kernel launch, named by the caller.
//
// Each kernel library is linked with its own (static) copy of the CUDA
// runtime, whose idea of the thread's current device need not follow
// PyTorch's.  A launch on a stream of device d must run with d current, so
// every entry point takes the device index of its tensors and makes it
// current for the launch: the launch does not depend on what the caller
// left current.  Every runtime of the process shares the device's primary
// context, so PyTorch's stream handle is valid here.  The previous device
// is made current again when the guard goes out of scope.

#pragma once

#include <cuda_runtime.h>

class LaunchDevice {
 public:
  explicit LaunchDevice(int device) {
    err_ = cudaGetDevice(&prev_);
    if (err_ == cudaSuccess) err_ = cudaSetDevice(device);
    restore_ = err_ == cudaSuccess && prev_ != device;
  }
  ~LaunchDevice() {
    if (restore_) cudaSetDevice(prev_);
  }
  LaunchDevice(const LaunchDevice&) = delete;
  LaunchDevice& operator=(const LaunchDevice&) = delete;

  cudaError_t error() const { return err_; }

 private:
  int prev_ = 0;
  bool restore_ = false;
  cudaError_t err_ = cudaSuccess;
};
