// GPU build of the wave pass (XLA FFI target for CUDA, sm_90a).
//
// One thread runs one lane from its seed to its trimmed tip in a single
// launch: the band ring lives in the thread's local memory (L1-resident),
// sequence bytes are read straight from device memory, and pebbles are
// written to the lane's rows of the pool.  See wave_lane.h.

#include <cstdint>

#include <cuda_runtime.h>

#include "wave_lane.h"
#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

constexpr int kThreads = 32;

template <int W>
__global__ void wave_kernel(int64_t n, bool reverse, const int32_t* lanes,
                            const uint8_t* a, int64_t la, const uint8_t* b,
                            int64_t lb, const int16_t* table,
                            const int16_t* score, const int32_t* params,
                            int32_t* out, int32_t* pool, int P) {
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const wave::Spec sp{params[0], params[1], table, score};
  wave::run_lane<W>(reverse, lanes + i * wave::NLANE, wave::Seq{a, la},
                    wave::Seq{b, lb}, sp, pool + i * int64_t(P) * 4, P,
                    out + i * wave::NOUT);
}

static ffi::Error WaveCuda(cudaStream_t stream, ffi::Buffer<ffi::S32> lanes,
                           ffi::Buffer<ffi::U8> a, ffi::Buffer<ffi::U8> b,
                           ffi::Buffer<ffi::S16> table,
                           ffi::Buffer<ffi::S16> score,
                           ffi::Buffer<ffi::S32> params,
                           ffi::ResultBuffer<ffi::S32> out,
                           ffi::ResultBuffer<ffi::S32> pool,
                           int32_t reverse, int32_t band) {
  const int64_t n = lanes.dimensions()[0];
  if (n == 0) return ffi::Error::Success();
  const int P = static_cast<int>(pool->dimensions()[1]);
  const int64_t la = static_cast<int64_t>(a.element_count());
  const int64_t lb = static_cast<int64_t>(b.element_count());
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
#define WAVE_LAUNCH(WB)                                                     \
  wave_kernel<WB><<<blocks, kThreads, 0, stream>>>(                         \
      n, reverse != 0, lanes.typed_data(), a.typed_data(), la,              \
      b.typed_data(), lb, table.typed_data(), score.typed_data(),           \
      params.typed_data(), out->typed_data(), pool->typed_data(), P)
  switch (band) {
    case 64: WAVE_LAUNCH(64); break;
    case 128: WAVE_LAUNCH(128); break;
    case 256: WAVE_LAUNCH(256); break;
    default: return ffi::Error::InvalidArgument("band must be 64/128/256");
  }
#undef WAVE_LAUNCH
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess)
    return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

XLA_FFI_DEFINE_HANDLER_SYMBOL(DamapperWave, WaveCuda,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Arg<ffi::Buffer<ffi::S16>>()
                                  .Arg<ffi::Buffer<ffi::S16>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Attr<int32_t>("reverse")
                                  .Attr<int32_t>("band"));
