"""The wave kernel (ops/wave_kernel.py): its host build against the oracle
on the CPU, its lowering for CUDA, and, on a card, the GPU build itself."""

import jax
import jax.numpy as jnp
import pytest

from damapper_tpu.ops import wave
from damapper_tpu.ops.spec import new_align_spec
from damapper_tpu.ops.wave_kernel import (BANDS, TARGET, KernelWaveEngine,
                                          ffi_platform)
from tests.test_wave_jax import assert_matches_oracle, make_cases

SPEC = new_align_spec(0.85, 100, [.25, .25, .25, .25], True)


def _with_flags(insts, flags):
    return [dict(s, flags=flags) for s in insts]


@pytest.mark.parametrize("err", [0.05, 0.15, 0.30])
@pytest.mark.parametrize("flags", [0, wave.ACOMP_FLAG])
def test_wave_kernel_matches_oracle(err, flags):
    """Forward and reverse passes of the kernel's host build, with and
    without the complemented-A trace offsets, equal the oracle."""
    seqmem, insts = make_cases(5000 + int(err * 100), ncases=6, err=err)
    eng = KernelWaveEngine(SPEC, band_cap=128, pool_cap=2048,
                           platform="cpu")
    assert_matches_oracle(eng, seqmem, _with_flags(insts, flags), SPEC)
    assert eng.n_fallback == 0


def test_wave_kernel_boundary_reach():
    """Seeds near contig boundaries: sentinel clipping and REACH."""
    seqmem, insts = make_cases(2000, ncases=4, glen=2600, rlen=2500)
    eng = KernelWaveEngine(SPEC, band_cap=128, pool_cap=2048,
                           platform="cpu")
    assert_matches_oracle(eng, seqmem, insts, SPEC)


def test_wave_kernel_overflow_falls_back():
    """Lanes that outgrow the pebble pool report overflow and rerun on the
    host oracle, so the records stay identical."""

    class SmallPool(KernelWaveEngine):
        def _get_fns(self, P):
            return super()._get_fns(128)

    seqmem, insts = make_cases(5030, ncases=6, err=0.15, rlen=4000)
    eng = SmallPool(SPEC, band_cap=64, pool_cap=2048, platform="cpu")
    assert_matches_oracle(eng, seqmem, insts, SPEC)
    assert eng.n_fallback > 0


def test_wave_kernel_sharded_lanes():
    """Under a mesh the kernel's lanes split over every device."""
    from damapper_tpu.parallel.mesh import make_mesh

    seqmem, insts = make_cases(5100, ncases=6, err=0.15)
    eng = KernelWaveEngine(SPEC, band_cap=128, pool_cap=2048,
                           mesh=make_mesh(4, ref_shards=2), platform="cpu")
    assert eng._ndp == 4
    assert_matches_oracle(eng, seqmem, insts, SPEC)


def test_wave_kernel_band_256_matches_oracle():
    """The widest band the kernel is built for equals the oracle too."""
    seqmem, insts = make_cases(5150, ncases=4, err=0.30)
    eng = KernelWaveEngine(SPEC, band_cap=256, pool_cap=2048,
                           platform="cpu")
    assert_matches_oracle(eng, seqmem, insts, SPEC)


def test_wave_kernel_sharded_lanes_eight_ways():
    """Lanes split over an eight-device dp axis, with batches padded to a
    multiple of it."""
    from damapper_tpu.parallel.mesh import make_mesh

    seqmem, insts = make_cases(5160, ncases=5, err=0.15)
    eng = KernelWaveEngine(SPEC, band_cap=128, pool_cap=2048,
                           mesh=make_mesh(8), platform="cpu")
    assert eng._ndp == 8
    assert_matches_oracle(eng, seqmem, insts, SPEC)


def test_wave_kernel_rejects_other_bands():
    from damapper_tpu.ops.wave_kernel import wave_pass

    with pytest.raises(ValueError, match="band"):
        wave_pass(jnp.zeros((8, 6), jnp.int32), None, None, None, None,
                  None, pool_rows=256, reverse=False, band=96)
    assert BANDS == (64, 128, 256)


def test_wave_kernel_lowers_for_cuda():
    """The engine's jitted pass lowers for CUDA at the production bucket,
    band and pool shapes, as one call of the kernel's FFI target."""
    from jax import export

    eng = KernelWaveEngine(SPEC, platform="cpu")
    fn = eng._get_fns(2048)[1]
    B, L = KernelWaveEngine.BUCKET, 1 << 20
    lane = jax.ShapeDtypeStruct((B,), jnp.int32)
    seq = jax.ShapeDtypeStruct((L,), jnp.uint8)
    consts = [jax.ShapeDtypeStruct(c.shape, c.dtype) for c in eng._consts]
    exp = export.export(
        fn, platforms=["cuda"],
        disabled_checks=[export.DisabledSafetyCheck.custom_call(TARGET)],
    )(*([lane] * 6), seq, seq, *consts)
    text = exp.mlir_module()
    assert text.count(f"custom_call @{TARGET}(") == 1
    assert "band = 128 : i32, reverse = 1 : i32" in text
    assert f"tensor<{B}x2048x4xi32>" in text
    assert exp.platforms == ("cuda",)


@pytest.mark.parametrize("platform,ffi", [("gpu", "cuda"), ("cpu", "cpu"),
                                          ("rocm", None)])
def test_wave_kernel_ffi_platform(platform, ffi):
    if ffi is None:
        with pytest.raises(ValueError):
            ffi_platform(platform)
    else:
        assert ffi_platform(platform) == ffi


# --- on the card -------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("err", [0.05, 0.15, 0.30])
def test_wave_kernel_gpu_matches_oracle(gpu, err):
    """The CUDA build on the card equals the oracle lane for lane."""
    seqmem, insts = make_cases(6000 + int(err * 100), ncases=32, err=err,
                               mix=True)
    eng = KernelWaveEngine(SPEC)
    assert eng._ffi == "cuda"
    assert_matches_oracle(eng, seqmem, insts, SPEC)


@pytest.mark.gpu
def test_wave_kernel_gpu_boundary_reach(gpu):
    seqmem, insts = make_cases(2000, ncases=4, glen=2600, rlen=2500)
    assert_matches_oracle(KernelWaveEngine(SPEC), seqmem, insts, SPEC)


@pytest.mark.gpu
def test_mapper_default_path_on_gpu(gpu, tmp_path):
    """The mapper's GPU defaults (device index, wave kernel) give the same
    records as the plain host path."""
    from damapper_tpu.io import las as lasio
    from damapper_tpu.pipeline.mapper import DamapperConfig, run_damapper
    from tests.test_e2e_golden import make_dataset

    make_dataset(tmp_path, seed=23, glen=24_000, ncontigs=2, nreads=6,
                 bsize=14_000, max_len=3500)
    cfg = DamapperConfig()
    assert (cfg.wave_backend, cfg.index_backend) == ("device", "device")
    outs = []
    for name, c in (("gpu", cfg), ("host", DamapperConfig(
            wave_backend="oracle", index_backend="host"))):
        (tmp_path / name).mkdir()
        a, _ = run_damapper(str(tmp_path / "ref.dam"),
                            str(tmp_path / "reads.db"), c,
                            out_dir=str(tmp_path / name))
        outs.append(lasio.read_las(a)[0])
    assert len(outs[0]) > 0
    assert lasio.las_equal(outs[0], outs[1])
