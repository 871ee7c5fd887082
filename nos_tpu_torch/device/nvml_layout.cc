// The layout of the NVML structs and the values of the NVML constants
// that nos_tpu_torch/device/nvml.py binds through ctypes, as the
// toolkit's nvml.h declares them.  One line each on stdout:
//
//   size <struct> <sizeof>
//   field <struct> <member> <offsetof>
//   const <name> <value>
//
// nvml.py's ``header_layout`` compiles and runs it; ``layout_mismatches``
// holds the lines against the ctypes declarations.  It calls nothing of
// NVML, so it needs the header and no driver.

#include <cstddef>
#include <cstdio>

#include <nvml.h>

#define SIZE(T) std::printf("size %s %zu\n", #T, sizeof(T))
#define FIELD(T, F) std::printf("field %s %s %zu\n", #T, #F, offsetof(T, F))
#define CONST(C) std::printf("const %s %lld\n", #C, static_cast<long long>(C))

int main() {
  SIZE(nvmlMemory_v2_t);
  FIELD(nvmlMemory_v2_t, version);
  FIELD(nvmlMemory_v2_t, total);
  FIELD(nvmlMemory_v2_t, reserved);
  FIELD(nvmlMemory_v2_t, free);
  FIELD(nvmlMemory_v2_t, used);

  SIZE(nvmlGpuInstanceProfileInfo_t);
  FIELD(nvmlGpuInstanceProfileInfo_t, id);
  FIELD(nvmlGpuInstanceProfileInfo_t, isP2pSupported);
  FIELD(nvmlGpuInstanceProfileInfo_t, sliceCount);
  FIELD(nvmlGpuInstanceProfileInfo_t, instanceCount);
  FIELD(nvmlGpuInstanceProfileInfo_t, multiprocessorCount);
  FIELD(nvmlGpuInstanceProfileInfo_t, copyEngineCount);
  FIELD(nvmlGpuInstanceProfileInfo_t, decoderCount);
  FIELD(nvmlGpuInstanceProfileInfo_t, encoderCount);
  FIELD(nvmlGpuInstanceProfileInfo_t, jpegCount);
  FIELD(nvmlGpuInstanceProfileInfo_t, ofaCount);
  FIELD(nvmlGpuInstanceProfileInfo_t, memorySizeMB);

  SIZE(nvmlGpuInstancePlacement_t);
  FIELD(nvmlGpuInstancePlacement_t, start);
  FIELD(nvmlGpuInstancePlacement_t, size);

  SIZE(nvmlGpuInstanceInfo_t);
  FIELD(nvmlGpuInstanceInfo_t, device);
  FIELD(nvmlGpuInstanceInfo_t, id);
  FIELD(nvmlGpuInstanceInfo_t, profileId);
  FIELD(nvmlGpuInstanceInfo_t, placement);

  SIZE(nvmlComputeInstanceProfileInfo_t);
  FIELD(nvmlComputeInstanceProfileInfo_t, id);
  FIELD(nvmlComputeInstanceProfileInfo_t, sliceCount);
  FIELD(nvmlComputeInstanceProfileInfo_t, instanceCount);
  FIELD(nvmlComputeInstanceProfileInfo_t, multiprocessorCount);
  FIELD(nvmlComputeInstanceProfileInfo_t, sharedCopyEngineCount);
  FIELD(nvmlComputeInstanceProfileInfo_t, sharedDecoderCount);
  FIELD(nvmlComputeInstanceProfileInfo_t, sharedEncoderCount);
  FIELD(nvmlComputeInstanceProfileInfo_t, sharedJpegCount);
  FIELD(nvmlComputeInstanceProfileInfo_t, sharedOfaCount);

  CONST(NVML_SUCCESS);
  CONST(NVML_ERROR_INVALID_ARGUMENT);
  CONST(NVML_ERROR_NOT_SUPPORTED);
  CONST(NVML_ERROR_NO_PERMISSION);
  CONST(NVML_ERROR_NOT_FOUND);
  CONST(NVML_ERROR_INSUFFICIENT_RESOURCES);
  CONST(NVML_ERROR_IN_USE);
  CONST(NVML_DEVICE_MIG_ENABLE);
  CONST(NVML_DEVICE_NAME_V2_BUFFER_SIZE);
  CONST(nvmlMemory_v2);
  CONST(NVML_GPU_INSTANCE_PROFILE_1_SLICE);
  CONST(NVML_GPU_INSTANCE_PROFILE_1_SLICE_REV1);
  CONST(NVML_GPU_INSTANCE_PROFILE_1_SLICE_REV2);
  CONST(NVML_GPU_INSTANCE_PROFILE_2_SLICE);
  CONST(NVML_GPU_INSTANCE_PROFILE_3_SLICE);
  CONST(NVML_GPU_INSTANCE_PROFILE_4_SLICE);
  CONST(NVML_GPU_INSTANCE_PROFILE_7_SLICE);
  CONST(NVML_COMPUTE_INSTANCE_PROFILE_1_SLICE);
  CONST(NVML_COMPUTE_INSTANCE_PROFILE_2_SLICE);
  CONST(NVML_COMPUTE_INSTANCE_PROFILE_3_SLICE);
  CONST(NVML_COMPUTE_INSTANCE_PROFILE_4_SLICE);
  CONST(NVML_COMPUTE_INSTANCE_PROFILE_7_SLICE);
  CONST(NVML_COMPUTE_INSTANCE_ENGINE_PROFILE_SHARED);
  return 0;
}
