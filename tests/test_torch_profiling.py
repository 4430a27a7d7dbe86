"""The port's tracer (``m3p2i_aip_tpu_torch/utils/profiling.py``) on the CPU:
parents and self time of nested spans, request ids, the ring's wrap, the
profiler's timeline, the device span's no-op off CUDA, a run's window of
records, and the spans a point tick and a chunked run record."""
import pytest
import torch

from m3p2i_aip_tpu_torch.config.config_store import load_config
from m3p2i_aip_tpu_torch.tamp.sim_loop import SimLoop
from m3p2i_aip_tpu_torch.utils import profiling

POINT = ["task=push_pull", "multi_modal=True", "goal=[-3.75,-3.75]", "mppi.num_samples=16", "mppi.horizon=4"]


def _fake_clock(monkeypatch, times):
    """``perf_counter_ns`` replaced by the values ``times`` in turn."""
    it = iter(times)
    monkeypatch.setattr(profiling, "_clock", lambda: next(it))


def test_nested_spans_record_their_parents_and_self_time(monkeypatch):
    tr = profiling.Tracer(capacity=16)
    _fake_clock(monkeypatch, [0, 10, 30, 35, 40, 100])  # a [0, 100]: b [10, 30], c [35, 40]
    with tr.span("a", 1):
        with tr.span("b"):
            pass
        with tr.span("c"):
            pass
    recs = {r[0]: r for r in tr.records()}
    assert recs["a"][2] is None and recs["b"][2] == "a" and recs["c"][2] == "a"
    assert [recs[n][3:] for n in "abc"] == [(0, 100, 75), (10, 30, 20), (35, 40, 5)]
    snap = tr.snapshot()["spans"]
    assert snap["a"]["total_s"] == pytest.approx(100e-9) and snap["a"]["self_s"] == pytest.approx(75e-9)
    assert snap["b"]["count"] == snap["c"]["count"] == 1
    assert tr.last_span("b") == (10, 30)


def test_request_ids_are_given_or_taken_from_the_enclosing_span():
    tr = profiling.Tracer(capacity=16)
    with tr.span("tick", 7):
        with tr.span("inner"):
            with tr.span("own", 3):
                pass
    with tr.span("alone"):
        pass
    reqs = {r[0]: r[1] for r in tr.records()}
    assert reqs == {"tick": 7, "inner": 7, "own": 3, "alone": None}


def test_the_ring_wraps_with_exact_totals_and_the_retained_quantiles(monkeypatch):
    tr = profiling.Tracer(capacity=8)
    times = []
    for k in range(1, 21):  # span k lasts k ns
        times += [1000 * k, 1000 * k + k]
    _fake_clock(monkeypatch, times)
    for k in range(1, 21):
        with tr.span("a", k):
            pass
    snap = tr.snapshot()["spans"]["a"]
    assert snap["count"] == 20 and snap["total_s"] == pytest.approx(210e-9) and snap["self_s"] == pytest.approx(210e-9)
    assert [r[1] for r in tr.records()] == list(range(13, 21))  # the last eight kept, in order
    assert snap["p50_s"] == pytest.approx(16.5e-9)
    with pytest.raises(ValueError):
        profiling.Tracer(capacity=12)


def test_no_record_function_while_the_profiler_is_off(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with the profiler off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    tr = profiling.Tracer(capacity=16)
    for name in sorted(profiling.HOST_ONLY) + ["tamp.tick"]:
        with tr.span(name, 0):
            pass
    assert sum(s["count"] for s in tr.snapshot()["spans"].values()) == len(profiling.HOST_ONLY) + 1


def test_only_host_only_spans_enter_the_profilers_timeline():
    tr = profiling.Tracer(capacity=16)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span("loop.observe", 4):
            torch.ones(4).sum()
        with tr.span("tamp.tick", 4):
            torch.ones(4).sum()
    cpu = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU]
    assert [e.name for e in cpu].count("loop.observe") == 1
    assert "tamp.tick" not in {e.name for e in prof.events()}
    assert tr.snapshot()["spans"]["tamp.tick"]["count"] == 1  # in the ring all the same


def test_a_device_span_is_a_no_op_on_the_cpu():
    tr = profiling.Tracer(capacity=16)
    with tr.device_span("tick", 0, torch.device("cpu")) as ctx:
        torch.ones(2).sum()
    assert ctx is None and tr.snapshot()["device"] == {}


@pytest.mark.parametrize("last, skip, p50_ns", [
    (None, 0, 10.5),  # every retained record
    (4, 0, 18.5),  # the newest four: 17-20
    (6, 2, 15.5),  # six ahead of the newest two: 13-18
    (30, 15, 3.0),  # fewer than asked for: 1-5
    (4, 20, None),  # nothing ahead of the skipped
])
def test_the_median_over_a_window_of_records(monkeypatch, last, skip, p50_ns):
    tr = profiling.Tracer(capacity=32)
    times = []
    for k in range(1, 21):  # span k lasts k ns
        times += [1000 * k, 1000 * k + k]
    _fake_clock(monkeypatch, times)
    for k in range(1, 21):
        with tr.span("a", k):
            pass
    snap = tr.snapshot(last=last, skip=skip)["spans"]["a"]
    assert snap["count"] == 20 and snap["total_s"] == pytest.approx(210e-9)  # the window is the median's only
    assert snap.get("p50_s") == (None if p50_ns is None else pytest.approx(p50_ns * 1e-9))


@pytest.fixture
def point_loop():
    loop = SimLoop(load_config("config_point", POINT), device="cpu")
    loop.warmup(2)
    profiling.reset()
    return loop


def test_a_point_tick_records_its_four_spans_with_its_tick_index(point_loop):
    point_loop.tick(5)
    recs = [r for r in profiling.TRACER.records()]
    assert sorted((r[0], r[1]) for r in recs) == sorted(
        [("tamp.plan", 5), ("tamp.tick", 5), ("loop.fetch", 5), ("loop.observe", 5)])
    by_name = {r[0]: r for r in recs}
    assert by_name["tamp.plan"][4] <= by_name["tamp.tick"][3] and by_name["tamp.tick"][4] <= by_name["loop.fetch"][3]
    # the log's replan seconds run from the plan's start to the fetch's end
    assert point_loop.log.replan_s == [(by_name["loop.fetch"][4] - by_name["tamp.plan"][3]) / 1e9]
    assert profiling.snapshot()["device"] == {}


def test_a_pipelined_chunked_run_records_each_chunk(point_loop):
    point_loop.run_chunked(6, chunk=2, pipelined=True)
    recs = profiling.TRACER.records()
    for name in ("tamp.plan", "tamp.chunk", "loop.fetch", "loop.drain"):
        assert sorted(r[1] for r in recs if r[0] == name) == [0, 2, 4], name
    chunk_end = {r[1]: r[4] for r in recs if r[0] == "tamp.chunk"}
    fetch_end = {r[1]: r[4] for r in recs if r[0] == "loop.fetch"}
    # a row's seconds: the chunk's enqueue end to its fetch's end, over its ticks
    assert point_loop.log.replan_s == [(fetch_end[i] - chunk_end[i]) / 1e9 / 2 for i in (0, 2, 4) for _ in range(2)]
