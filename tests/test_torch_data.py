"""The port's synthetic token pipeline against the JAX package's, on the
CPU: both are numpy, so every batch must be the reference's bit for bit —
tokens, labels, the enc-dec ``frames`` and the VLM ``patches`` — for
every seed, step and host split, and the prefetch thread must hand over
the batches ``batch`` gives."""
import numpy as np
import pytest

pytest.importorskip("hypothesis")       # optional test dep: skip, not error
from hypothesis import given, settings, strategies as st

from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticTokenPipeline as JPipeline
from repro_torch.data import DataConfig, SyntheticTokenPipeline

BASE = dict(vocab_size=97, seq_len=32, global_batch=8)
STUBS = dict(frames=6, patches=4, d_model=16)


def _both(host_index=0, num_hosts=1, **kw):
    kw = dict(BASE, **kw)
    return (JPipeline(JDataConfig(**kw), host_index=host_index,
                      num_hosts=num_hosts),
            SyntheticTokenPipeline(DataConfig(**kw), host_index=host_index,
                                   num_hosts=num_hosts))


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k],
                                                                want[k]), k


@given(st.integers(0, 10**6), st.integers(0, 3))
@settings(max_examples=20, deadline=None)
def test_batches_equal_reference(step, seed):
    ref, port = _both(seed=seed, **STUBS)
    _assert_same(port.batch(step), ref.batch(step))


@pytest.mark.parametrize("num_hosts", [2, 4, 8])
@given(step=st.integers(0, 1000))
@settings(max_examples=10, deadline=None)
def test_host_splits_equal_reference(num_hosts, step):
    for h in range(num_hosts):
        ref, port = _both(h, num_hosts, seed=5, **STUBS)
        _assert_same(port.batch(step), ref.batch(step))


@pytest.mark.parametrize("kw", [dict(copy_period=8, seq_len=64),
                                dict(zipf_a=1.5, vocab_size=50000),
                                dict(frames=3, d_model=8),
                                dict(patches=5, d_model=8)])
def test_config_variants_equal_reference(kw):
    ref, port = _both(seed=1, **kw)
    for step in (0, 7):
        _assert_same(port.batch(step), ref.batch(step))


def test_prefetch_equals_direct_batches():
    _, port = _both(seed=2)
    port.start_prefetch(first_step=5)
    try:
        got = [port.next_prefetched() for _ in range(3)]
    finally:
        port.stop()
    assert [s for s, _ in got] == [5, 6, 7]
    for s, b in got:
        _assert_same(b, port.batch(s))
