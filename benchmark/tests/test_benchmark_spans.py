"""The span metrics on the CPU: a traced run of the per-tick and chunked
mixes reads the program's host spans, and the device spans and the set-up
spans of the compiled programs (CUDA only) read nothing."""
from __future__ import annotations

import pytest

from benchmark import spec as spec_mod
from benchmark.tests import tiny

HOST = {
    "point-pushpull-pertick": ["plan_ms_p50.pertick", "launch_ms_p50.pertick", "fetch_ms_p50.pertick",
                               "observe_ms_p50.pertick"],
    "point-pushpull-chunked": ["enqueue_ms_p50.chunked", "drain_ms_p50.chunked"],
}
CUDA_ONLY = {"kernel_load_s", "first_run_s", "capture_s", "tick_device_ms_p50.pertick", "chunk_device_ms_p50.chunked"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("cell", sorted(HOST))
def test_a_traced_cpu_run_reads_the_host_spans(cell, root, monkeypatch):
    from m3p2i_aip_tpu_torch.utils import profiling

    profiling.reset()
    line = tiny.run(root, monkeypatch, "--workload", cell, "--seed", "2147483811", "--seconds", "1", "--trace", "1")
    assert line["correct"]
    for name in HOST[cell]:
        assert line["metrics"][name]["value"] > 0, name
    listed = {m["name"] for m in spec_mod.per_layer(spec_mod.load(root), spec_mod.cell(spec_mod.load(root), cell))}
    assert CUDA_ONLY & listed and not CUDA_ONLY & set(line["metrics"])


def test_a_program_without_the_tracer_reads_none(monkeypatch):
    from benchmark import spans
    from m3p2i_aip_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "snapshot")
    assert spans.read("spans", "tamp.plan", "p50_s") is None


@pytest.mark.parametrize("metric, span, ctx", [
    ("plan_ms_p50.pertick", "tamp.plan", {"ticks": 3, "trace": {"ticks": 2}}),
    ("observe_ms_p50.pertick", "loop.observe", {"ticks": 3, "trace": None}),
    ("enqueue_ms_p50.chunked", "tamp.chunk", {"chunk_s": [0.3] * 3, "trace": {"ticks": 20}}),
    ("drain_ms_p50.chunked", "loop.drain", {"chunk_s": [0.3] * 3, "trace": None}),
])
def test_a_p50_metric_reads_the_window_alone(metric, span, ctx, monkeypatch):
    """Warm-up records of 100 ms, the window's of 1, 2 and 3 ms, and the
    traced stretch's (a chunk, or the ticks the summary names) of 50 ms: the
    median is the window's."""
    from m3p2i_aip_tpu_torch.utils import profiling

    stretch = (ctx["trace"]["ticks"] if "ticks" in ctx else 1) if ctx["trace"] else 0
    ms = [100] * 7 + [1, 2, 3] + [50] * stretch
    clock = iter(t for k, d in enumerate(ms) for t in (10**9 * k, 10**9 * k + 10**6 * d))
    monkeypatch.setattr(profiling, "_clock", lambda: next(clock))
    profiling.reset()
    for _ in ms:
        with profiling.span(span):
            pass
    assert spec_mod.reader(metric)(ctx) == pytest.approx(2.0)
    profiling.reset()
