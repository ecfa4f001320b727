"""The trace readers and the per-layer metrics on a made-up profiler trace."""

import pathlib

import pytest

from ltebench import harness, roofline, trace
from ltebench.trace import WINDOW, Event

ROOT = pathlib.Path(__file__).resolve().parents[2]
MAP = "void (anonymous namespace)::map_kernel<__nv_bfloat16, false>(float const*, int)"
ITER = "(anonymous namespace)::iter_kernel(float const*, float*, int)"


def synthetic():
    """A 1 ms window: a graph launch, then map_kernel 100-300 us and
    iter_kernel 300-400 us, a kernel launch, an elementwise kernel 600-700 us
    (a gap of 200 us under a sync), and a device event outside the window."""
    us = 1000
    return [
        Event(WINDOW, False, 0, 1000 * us),
        Event("cudaGraphLaunch", False, 10 * us, 90 * us),
        Event(MAP, True, 100 * us, 300 * us),
        Event(ITER, True, 300 * us, 400 * us),
        Event("cudaLaunchKernel", False, 410 * us, 420 * us),
        Event("cudaEventSynchronize", False, 400 * us, 600 * us),
        Event("void at::native::elementwise_kernel<128, 2>(x)", True, 600 * us, 700 * us),
        Event("aten::add", False, 405 * us, 430 * us),
        Event(MAP, True, 2000 * us, 2100 * us),
    ]


def test_busy_idle_launches_and_kernels():
    ev = synthetic()
    busy_s, window_s = trace.busy(ev)
    assert busy_s == pytest.approx(400e-6) and window_s == pytest.approx(1e-3)
    assert trace.host_launches(ev) == 2
    assert trace.kernel_seconds(ev, "map_kernel") == (pytest.approx(200e-6), 1)
    assert trace.kernel_seconds(ev, "iter_kernel") == (pytest.approx(100e-6), 1)
    assert trace.kernel_seconds(ev, "map_v1_kernel") == (0.0, 0)
    ops = trace.device_ops(ev)
    assert ops[0] == [MAP, pytest.approx(200e-6)] and len(ops) == 3
    gaps = dict(trace.idle_gaps(ev))
    assert gaps["cudaGraphLaunch"] == pytest.approx(100e-6)  # 0-100 us: launch under the mid
    assert gaps["cudaEventSynchronize"] == pytest.approx(200e-6)  # 400-600 us
    assert gaps[WINDOW] == pytest.approx(300e-6)  # 700-1000 us: nothing on the host
    assert sum(gaps.values()) == pytest.approx(window_s - busy_s)


@pytest.mark.parametrize("name,base", [(MAP, "map_kernel"), (ITER, "iter_kernel"),
                                       ("sm80_xmma_gemm_f32f32_nn", "sm80_xmma_gemm_f32f32_nn"),
                                       ("void at::native::vectorized_elementwise_kernel<4>(x)",
                                        "vectorized_elementwise_kernel")])
def test_base_name(name, base):
    assert trace.base_name(name) == base


def test_a_trace_without_device_events_fails():
    ev = [e for e in synthetic() if not e.device]
    with pytest.raises(trace.EmptyTrace):
        trace.busy(ev)
    with pytest.raises(trace.EmptyTrace):
        trace.busy([Event("cudaGraphLaunch", False, 0, 10)])  # no window either


class FakeDriver:
    def map_work(self, rows):
        return [(5504, rows * 6 / 9, 32, True), (5568, rows * 3 / 9, 32, True)]

    def info(self):
        return {"graph_build_s": 2.5}


def ctx(**kw):
    c = dict(events=synthetic(), traced_calls=2, traced_map_rows=2304, map_rows=9000, calls=3,
             encode_ms=[1.0, 2.0], decode_ms=[3.0, 5.0], driver=FakeDriver())
    c.update(kw)
    return c


def read(name, c):
    return harness.reader(ROOT, name)(c)


def test_metric_readers():
    c = ctx()
    assert read("host_launches_per_call.link", c) == 1.0
    assert read("encode_ms.link", c) == 1.5
    assert read("decode_ms.link", c) == 4.0
    assert read("map_rows_per_call.link", c) == 3000.0
    assert read("device_idle_pct.link", c) == pytest.approx(60.0)
    assert read("graph_build_s", c) == 2.5
    bound = (roofline.map_bound(5504, 1536, 32, True) + roofline.map_bound(5568, 768, 32, True))
    assert read("turbo_map_roofline_pct.link", c) == pytest.approx(100 * bound / 200e-6)
    it = roofline.iter_bound(1536, 5504) + roofline.iter_bound(768, 5568)
    assert read("turbo_iter_roofline_pct.link", c) == pytest.approx(100 * it / 100e-6)


def test_readers_with_nothing_to_read_return_none():
    c = ctx(events=[e for e in synthetic() if "kernel" not in e.name or not e.device]
            + [Event("x", True, 1, 2)], encode_ms=[], traced_map_rows=0)
    assert read("turbo_map_roofline_pct.link", c) is None
    assert read("turbo_iter_roofline_pct.link", c) is None
    assert read("encode_ms.link", c) is None


def test_roofline_bounds():
    # the program's smoke test: 768 x K=5504 bf16, 15.1 us (bytes); one pass of turbo_iter
    # at 768 x 5504 21.5 us (bytes)
    assert roofline.map_bound(5504, 768, 32, True) == pytest.approx(15.1e-6, rel=0.01)
    assert roofline.iter_bound(768, 5504) == pytest.approx(21.5e-6, rel=0.01)
    assert roofline.viterbi_bound(2816, 44, 3) == pytest.approx(3.54e-6, rel=0.01)
