"""The trace reader on a hand-made trace: spans from the marks, busy time
as the union of device activity, idle gaps by span and by host read."""

import torch

from perfbench import trace as tr

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


class _Event:
    def __init__(self, name, start, dur, device=CUDA):
        self._n, self._s, self._d, self._dev = name, start, dur, device

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._s + self._d

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._dev

    def is_user_annotation(self):
        return self._n.startswith("annotation")


class _Prof:
    def __init__(self, events):
        results = type("R", (), {"events": lambda self: events})()
        self.profiler = type("P", (), {"kineto_results": results})()


MARK = "void at::cuda::(anonymous namespace)::spin_kernel(long)"


def test_spans_busy_time_and_gaps():
    events = [
        _Event("void settle(int)", -50, 5),      # before the window
        _Event(MARK, 0, 1),                      # fit starts
        _Event("void lbs_kernel(int const*)", 10, 20),
        _Event(MARK, 40, 1),                     # broad phase starts
        _Event("void k2_gather_rows(float const*)", 50, 30),
        _Event("void k2_gather_rows(float const*)", 70, 30),   # overlaps
        _Event(MARK, 110, 1),                    # broad phase ends
        _Event("Memcpy DtoH (Device -> Pageable)", 200, 5),
        _Event("cudaMemcpyAsync", 150, 60, CPU),
        _Event("void k3_join(int const*)", 300, 10),
        _Event(MARK, 400, 1),                    # fit ends
        _Event("annotation.fit", 0, 400),
    ]
    marks = [("fit", "start"), ("broad_phase", "start"),
             ("broad_phase", "end"), ("fit", "end")]
    got = tr.read(_Prof(events), marks)
    assert got["launches"] == 4
    assert [k[3] for k in got["kernels"]] == ["fit", "broad_phase",
                                              "broad_phase", "fit"]
    # busy: 20 + (50..100) + 5 + 10; the marks and annotations left out
    assert got["busy_s"] == 85e-9
    # A gap is named by the span it starts in, and as a host read where a
    # read overlaps it: 30..50 launches in the fit, 100..200 a read that
    # starts in the broad phase, 205..300 the same read's tail in the fit.
    assert dict(got["idle_gaps"]) == {"fit.launch": 20e-9,
                                      "broad_phase.host_read": 100e-9,
                                      "fit.host_read": 95e-9}
    assert got["device_ops"][0] == ["k2_gather_rows", 60e-9]


def test_a_missing_mark_raises():
    try:
        tr.read(_Prof([_Event(MARK, 0, 1)]), [("fit", "start"), ("fit", "end")])
    except RuntimeError as e:
        assert "holds 1 span marks" in str(e)
    else:
        raise AssertionError("a missing mark went unnoticed")


def test_kernel_base_drops_namespaces_and_template_arguments():
    assert tr.kernel_base("(anonymous namespace)::lbs_kernel<4>") == "lbs_kernel"
    assert tr.kernel_base("k3_join") == "k3_join"


def test_kernel_names_drop_the_parameter_list():
    assert tr.kernel_name("void k3_join(int const*, float*)") == "k3_join"
    assert tr.kernel_name("void f<float, (x)2>(int)") == "f<float, (x)2>"
    assert tr.kernel_name(MARK) == "at::cuda::(anonymous namespace)::spin_kernel"
    assert tr.kernel_name("lbs_kernel(int const*, float*)") == "lbs_kernel"
    assert tr.kernel_name("Memset (Device)") == "Memset"
