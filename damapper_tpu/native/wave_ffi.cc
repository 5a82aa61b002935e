// Host build of the wave pass (XLA FFI target for the CPU platform).  It
// runs the same per-lane code as the GPU kernel in wave_ffi.cu, so the
// tests check the kernel's arithmetic and its JAX wrapper without a card.

#include <cstdint>

#include "wave_lane.h"
#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

static ffi::Error WaveHost(ffi::Buffer<ffi::S32> lanes,
                           ffi::Buffer<ffi::U8> a, ffi::Buffer<ffi::U8> b,
                           ffi::Buffer<ffi::S16> table,
                           ffi::Buffer<ffi::S16> score,
                           ffi::Buffer<ffi::S32> params,
                           ffi::ResultBuffer<ffi::S32> out,
                           ffi::ResultBuffer<ffi::S32> pool,
                           int32_t reverse, int32_t band) {
  const int64_t n = lanes.dimensions()[0];
  const int P = static_cast<int>(pool->dimensions()[1]);
  const int32_t* prm = params.typed_data();
  const wave::Spec sp{prm[0], prm[1], table.typed_data(), score.typed_data()};
  const wave::Seq A{a.typed_data(), static_cast<int64_t>(a.element_count())};
  const wave::Seq B{b.typed_data(), static_cast<int64_t>(b.element_count())};
  for (int64_t i = 0; i < n; ++i) {
    const int32_t* ln = lanes.typed_data() + i * wave::NLANE;
    int32_t* o = out->typed_data() + i * wave::NOUT;
    int32_t* pl = pool->typed_data() + i * int64_t(P) * 4;
    switch (band) {
      case 64: wave::run_lane<64>(reverse, ln, A, B, sp, pl, P, o); break;
      case 128: wave::run_lane<128>(reverse, ln, A, B, sp, pl, P, o); break;
      case 256: wave::run_lane<256>(reverse, ln, A, B, sp, pl, P, o); break;
      default: return ffi::Error::InvalidArgument("band must be 64/128/256");
    }
  }
  return ffi::Error::Success();
}

XLA_FFI_DEFINE_HANDLER_SYMBOL(DamapperWave, WaveHost,
                              ffi::Ffi::Bind()
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
