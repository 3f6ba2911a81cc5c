"""The counts against numbers worked out by hand for each cell's shapes."""
import pytest

from bench.counts import kv, kv_cache, moe, peaks


def test_moe_prefill_skew():
    # 4 ranks x 4096 rows, each 2 x 7168 x 4096 (GEMM1) + 2 x 2048 x 7168
    assert moe.flops(4, 4096, 7168, 2048) == 1_443_109_011_456
    assert moe.flops(4, 4096, 7168, 2048) == pytest.approx(1.443e12,
                                                           rel=1e-3)
    # x and y (2 x 16384 x 7168 floats) + 4 experts' 3 x 7168 x 2048
    assert moe.nbytes(4, 4096, 7168, 2048) == 4 * (234_881_024
                                                   + 176_160_768)


def test_moe_decode_shared():
    # 1024 rows through a routed and the shared expert, both of 2048
    assert moe.flops(4, 256, 7168, 2048, 2048) == 180_388_626_432
    assert moe.nbytes(4, 256, 7168, 2048, 2048) == 4 * (
        2 * 1024 * 7168 + 5 * 3 * 7168 * 2048)


def test_moe_table5_shape():
    assert moe.flops(2, 6144, 7168, 2048) == 1_082_331_758_592


def test_kv_handoff():
    assert kv.flops(4096, 4096, 1024) == 68_719_476_736
    assert kv.nbytes(4096, 4096, 1024) == 4 * (4096 * 4096
                                               + 2 * 4096 * 1024 * 2)


def test_kv_cache_handoff():
    # the pool's longest prompt: 16 layers x 31395 positions x 8 heads x
    # 128 of K and of V in bfloat16, read once and written once
    cache = 2 * 16 * 31395 * 8 * 128 * 2
    assert cache == 2_057_502_720
    assert kv_cache.nbytes(16, 31395, 8, 128, 2) == 2 * cache
    assert kv_cache.flops(16, 31395, 8, 128) == 0
    assert peaks.bound_s(0, 2 * cache, "bfloat16") == pytest.approx(
        4_115_005_440 / 3.35e12)


def test_bounds_take_the_larger_term():
    f, b = moe.flops(4, 4096, 7168, 2048), moe.nbytes(4, 4096, 7168, 2048)
    assert peaks.bound_s(f, b, "float32") == pytest.approx(f / 495e12)
    assert peaks.bound_s(1e6, 3.35e12, "float32") == pytest.approx(1.0)
    assert peaks.FLOPS["bfloat16"] == 989e12
