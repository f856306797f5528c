"""The reading of a profiler trace, on a made-up timeline: the busy time is
the union of the device's intervals inside the profiled span, kernels are
counted and grouped apart from copies, and each idle gap carries the
outermost host op that covers it."""

import pytest

from benchmark import trace as TR


def test_union_groups_and_idle_labels():
    main, other = 1, 2
    spans = [(0, 100, main)]
    dev = [(10, 30, "lstm_fwd_cluster_kernel"), (20, 40, "ampere_bf16_gemm"), (60, 70, "Memcpy DtoH"),
           (-5, 5, "ctc_alpha_kernel")]  # the last starts before the span: clipped
    cpu = [(0, 50, "aten::linear", main), (42, 48, "aten::mul", main),  # nested: the outer one labels
           (50, 100, "autograd::engine", other), (75, 80, "aten::add", main)]
    t = TR.summarise(dev, cpu, spans)
    assert t.span_s == pytest.approx(100e-9)
    assert t.busy_s == pytest.approx((5 + 30 + 10) * 1e-9)  # [0,5], [10,40], [60,70]
    assert t.launches == 3  # the copy is not a launch
    assert t.groups["lstm_fwd"] == (pytest.approx(20e-9), 1) and t.groups["GEMMs (cuBLAS)"][1] == 1
    idle = dict(t.idle)
    # gaps [5,10] (mid 7.5: under aten::linear), [40,60] (mid 50: past its end, under the other thread's op)
    # and [70,100] (mid 85: no main-thread op covers it, the other thread's does)
    assert idle == {"aten::linear": pytest.approx(5e-9), "other thread: autograd::engine": pytest.approx(50e-9)}
    assert sum(idle.values()) == pytest.approx(t.span_s - t.busy_s)


def test_no_device_operation_is_an_error():
    with pytest.raises(RuntimeError):
        TR.summarise([], [], [(0, 1, 1)])
