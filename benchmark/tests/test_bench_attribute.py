"""Device time and host syncs by span on hand-made events, the per-layer
metrics that read the program's spans on hand-made records, and the
attribution end to end on the CPU's tiny cell."""

import attribute
from registry import Registry

WINDOW = (0, 1000)
# prove [0, 900) > msm/v8 [100, 500) > msm/v8/scan [200, 300)
SPANS = [("prove", 0, 900), ("msm/v8", 100, 500), ("msm/v8/scan", 200, 300)]


def call(start, name, corr, kind="cuda_runtime", length=5):
    return (start, start + length, name, corr, kind)


def test_device_time_by_the_span_of_its_launch():
    dev = [(210, 260, "seg_scan_kernel", 1),        # launched in the scan
           (400, 450, "at::native::gather", 2),     # in msm/v8
           (600, 650, "at::native::gather", 3),     # launched by the driver
           (700, 760, "fill", 4),                   # no launch found
           (950, 990, "cat", 5)]                    # launched between proves
    calls = [call(205, "cudaLaunchKernel", 1),
             call(350, "cudaLaunchKernel", 2),
             call(351, "cuLaunchKernel", 2, "cuda_driver"),
             call(590, "cuLaunchKernel", 3, "cuda_driver"),
             call(920, "cudaLaunchKernel", 5)]
    out = attribute.attribute(dev, calls, SPANS, *WINDOW, "between proves")
    assert out["device_s_by_span"] == {
        "msm/v8/scan": 50e-9, "msm/v8": 50e-9, "prove": 50e-9,
        "between proves": 40e-9}
    assert out["device_s_by_span_name"]["msm/v8"] == {
        "at::native::gather": 50e-9}
    assert abs(out["unmatched_s"] - 60e-9) < 1e-18
    assert abs(out["device_s"] - 250e-9) < 1e-18
    names = {"seg_scan_kernel"}
    by_name = out["device_s_by_span_name"]
    assert abs(attribute.torch_op_s(by_name, names, "msm/") - 50e-9) < 1e-18
    assert abs(attribute.torch_op_s(by_name, names) - 140e-9) < 1e-18


def test_syncs_by_span():
    calls = [call(220, "cudaStreamSynchronize", 10),
             # the runtime's own driver call: not a second sync
             call(221, "cuStreamSynchronize", 11, "cuda_driver", 1),
             call(120, "cudaMemcpyAsync", 12),
             call(130, "cudaMemcpy", 13),
             call(600, "cuCtxSynchronize", 14, "cuda_driver"),
             call(700, "cudaEventSynchronize", 15),
             call(950, "cudaDeviceSynchronize", 16),
             call(1200, "cudaDeviceSynchronize", 17)]   # after the window
    out = attribute.attribute([], calls, SPANS, *WINDOW, "between proves")
    assert out["syncs_by_span"] == {"msm/v8/scan": 1, "msm/v8": 1,
                                    "prove": 2, "between proves": 1}
    assert out["device_s"] == 0 and out["device_s_by_span"] == {}


def test_no_spans_label_everything_outside():
    dev = [(10, 20, "k", 1)]
    out = attribute.attribute(dev, [call(5, "cudaLaunchKernel", 1)], [],
                              *WINDOW, "between proves")
    assert out["device_s_by_span"] == {"between proves": 10e-9}


def test_self_time_by_name():
    from quill_tpu_torch.utils import profiling

    with profiling.recording() as rec:
        with profiling.phase("attribute/a"):
            with profiling.phase("attribute/b"):
                pass
    own = attribute.self_s_by_name(rec)
    total = (rec.spans[-1].end_ns - rec.spans[-1].start_ns) / 1e9
    assert set(own) == {"attribute/a", "attribute/b"}
    assert abs(sum(own.values()) - total) < 1e-12


def reader(name):
    return Registry().reader(name)


def traced_record(idle, busy=1.0, proves=2):
    return {"traced": {"proves": proves, "busy_s": busy,
                       "idle_by_span": idle}}


def test_unspanned_idle_s():
    read = reader("unspanned_idle_s")
    idle = {"prove": 3.0, "between proves": 1.0, "msm/v8": 5.0,
            "kzg/open_msm": 2.0}
    assert read(traced_record(idle)) == 2.0
    assert read(traced_record({"msm/cd": 1.0})) == 0.0
    # no device event in the trace (a CPU run): left out
    assert read(traced_record(idle, busy=0.0)) is None
    assert read({"window": {}}) is None


def test_msm_host_idle_s():
    read = reader("msm_host_idle_s")
    idle = {"prove": 3.0, "msm/v8": 5.0, "msm/v8/combine": 1.0,
            "msm/cd/sort": 0.5, "kzg/open_msm": 2.0}
    assert read(traced_record(idle)) == 3.25
    # a program with no MSM span (the parent of the spans): left out
    assert read(traced_record({"prove": 3.0, "kzg/open_msm": 2.0})) is None
    assert read(traced_record(idle, busy=0.0)) is None


def test_witness_prep_s():
    read = reader("witness_prep_s")
    spans = {"prove/check_constraints": 4.0, "prove/witness_upload": 2.0,
             "prove/zerocheck": 9.0}
    assert read({"window": {"proves": 3, "spans": spans}}) == 2.0
    assert read({"window": {"proves": 3,
                            "spans": {"prove/zerocheck": 9.0}}}) is None


def test_the_tiny_cell_attributed_on_the_cpu(tiny):
    from harness import Cell
    from conftest import TINY

    cell = Cell(TINY, 12345, "cpu", tiny)
    cell.set_up()
    out = attribute.traced(cell, 1, tiny.kernel_names())
    # the CPU has no device events and no runtime calls; the spans do
    assert out["device_events"] == 0 and out["unmatched_pct"] is None
    assert out["spans_a_prove"] > 100
    host = out["host_self_s_by_span"]
    assert {"prove", "prove/check_constraints", "prove/witness_upload",
            "msm/cd", "msm/cd/sort", "proof_io/serialize"} <= set(host)
    cost = attribute.recorder_cost(cell, 1)
    assert cost["spans_a_prove"] == out["spans_a_prove"]
    assert len(cost["off_s"]) == len(cost["on_s"]) == 1


class Event:
    def __init__(self, name, kind=None):
        self._name = name
        if kind is not None:
            self.activity_type = lambda: kind

    def name(self):
        return self._name


def test_call_kind_by_activity_or_by_name():
    assert attribute.call_kind(Event("cudaLaunchKernel")) == "cuda_runtime"
    assert attribute.call_kind(Event("cuLaunchKernel")) == "cuda_driver"
    assert attribute.call_kind(Event("cub::DeviceRadixSort")) is None
    assert attribute.call_kind(Event("aten::add")) is None
    assert attribute.call_kind(Event("cudaLaunchKernel",
                                     "cuda_runtime")) == "cuda_runtime"
    assert attribute.call_kind(Event("aten::add", "cpu_op")) is None
