"""The program's own trace (``repro_torch.core.telemetry``): ``span`` is
off without a profiler and, inside one, lands in the profiler's timeline
and in the program's log on the same clock; the kernels' counters are
handed out only while a profiler records, and ``collect`` /
``cycle_share`` read them. CPU only (the counters' tensors live on the
CPU here)."""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch.core import telemetry

NAMES = ("t.call", "t.prepare", "t.alloc", "t.launch")


@pytest.fixture(autouse=True)
def clean_trace():
    telemetry.reset()
    yield
    telemetry.reset()


def _wrapper():
    """A wrapper call's shape: ``.call`` over its three children."""
    with telemetry.span("t.call"):
        for child in NAMES[1:]:
            with telemetry.span(child):
                sum(range(2000))


def test_span_is_off_without_a_profiler(monkeypatch):
    opened = []
    monkeypatch.setattr(telemetry, "_RecordFunctionFast",
                        lambda name: opened.append(name))
    for _ in range(3):
        _wrapper()
    assert opened == []
    assert telemetry.spans() == []
    assert telemetry.TRACE.snapshot()["histograms"] == {}
    assert telemetry.kernel_counters("k", ("a",), "cpu") is None
    assert telemetry.collect() == {}
    assert telemetry.cycle_share("k", "wait") is None


def test_spans_nest_in_the_profiler_and_the_log_on_one_clock():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _wrapper()          # first ranges pay the profiler's warm-up
        telemetry.reset()
        for _ in range(3):
            with record_function("t.outer"):
                _wrapper()
    log = telemetry.spans()
    assert [s[0] for s in log] == list(NAMES[1:] + NAMES[:1]) * 3
    calls = [s[1] for s in log]
    for i in range(3):        # one call id a wrapper call, a new one each
        assert len(set(calls[4 * i:4 * i + 4])) == 1
    assert len(set(calls)) == 3
    for name, _, parent, t0, t1 in log:
        assert parent == (None if name == "t.call" else "t.call")
        assert t0 <= t1
    # each child lies inside its call, in order
    for i in range(3):
        kids, call = log[4 * i:4 * i + 3], log[4 * i + 3]
        assert call[3] <= kids[0][3] and kids[-1][4] <= call[4]
        assert all(a[4] <= b[3] for a, b in zip(kids, kids[1:]))

    events = [e for e in prof.profiler.kineto_results.events()
              if e.name() in NAMES]
    events = events[-12:]     # the three calls after the warm-up
    by_name = {n: sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                         for e in events if e.name() == n) for n in NAMES}
    for n in NAMES:
        assert len(by_name[n]) == 3
        mine = sorted((t0, t1) for name, _, _, t0, t1 in log if name == n)
        for (p0, p1), (t0, t1) in zip(by_name[n], mine):
            assert abs(p0 - t0) <= 50_000 and abs(p1 - t1) <= 50_000
    # the profiler nests the children under the call, and the call under
    # the range around it; the ranges are function-scope, not user
    # annotations (which a CUDA trace would copy onto the device)
    ranges = [e for e in prof.events() if e.name in NAMES][-12:]
    for e in ranges:
        assert e.cpu_parent is not None
        assert e.cpu_parent.name == ("t.outer" if e.name == "t.call"
                                     else "t.call")
    kinds = {e.is_user_annotation() for e in events}
    assert kinds == {False}

    assert telemetry.TRACE.snapshot()["histograms"] == {}
    telemetry.collect()
    hist = telemetry.TRACE.snapshot()["histograms"]
    assert set(hist) == set(NAMES)
    assert all(h["count"] == 3 for h in hist.values())


def test_a_span_closes_on_an_exception():
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(ValueError):
            with telemetry.span("t.call"):
                with telemetry.span("t.prepare"):
                    raise ValueError("refused")
        _wrapper()
    names = [(s[0], s[2]) for s in telemetry.spans()]
    assert names[:2] == [("t.prepare", "t.call"), ("t.call", None)]
    assert names[-1] == ("t.call", None)


def test_histogram_keeps_every_call_of_a_window():
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(8192):
            with telemetry.span("t.call"):
                pass
    telemetry.collect()
    h = telemetry.TRACE.histogram("t.call")
    assert h.count == 8192 and len(h.samples) == 8192
    telemetry.collect()           # made anew, not observed twice
    assert telemetry.TRACE.histogram("t.call").count == 8192


def test_the_log_keeps_the_newest_spans(monkeypatch):
    monkeypatch.setattr(telemetry, "_LOG",
                        telemetry.collections.deque(maxlen=4))
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(6):
            with telemetry.span(f"t.{i}"):
                pass
    assert [s[0] for s in telemetry.spans()] == ["t.2", "t.3", "t.4", "t.5"]


@pytest.mark.parametrize("bucket,want", [("wait", 25.0), ("gemm", 50.0),
                                         ("cycles", 100.0)])
def test_counters_are_handed_out_and_read_while_a_profiler_records(bucket,
                                                                   want):
    with profile(activities=[ProfilerActivity.CPU]):
        got = [telemetry.kernel_counters("k", ("a", "b"), "cpu")
               for _ in range(2 * telemetry.COUNT_EVERY + 1)]
    # every COUNT_EVERY-th traced launch counts, the first included
    acc = got[0]
    assert [i for i, a in enumerate(got) if a is not None] \
        == [0, telemetry.COUNT_EVERY, 2 * telemetry.COUNT_EVERY]
    assert all(a is acc for a in got if a is not None)
    assert acc.dtype == torch.int64
    assert acc.shape == (2, len(telemetry.KERNEL_BUCKETS))
    assert not acc.any()
    assert telemetry.cycle_share("k", bucket) is None   # no CTA counted
    # ctas, cycles, wait, gemm of each role
    acc[0] = torch.tensor([10, 300, 100, 100])
    acc[1] = torch.tensor([1, 100, 0, 100])
    got = telemetry.collect()
    assert got["k.a.cycles"] == 300 and got["k.b.gemm"] == 100
    assert telemetry.TRACE.snapshot()["counters"]["k.a.ctas"] == 10
    assert telemetry.cycle_share("k", bucket) == pytest.approx(want)
    assert telemetry.cycle_share("other", bucket) is None
    telemetry.reset()
    assert telemetry.collect() == {}
