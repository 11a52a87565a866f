"""The trace reduction on hand-made events: names, the busy union and the
idle time by host span."""

import devtrace


def test_ident():
    assert devtrace.ident("void tree_up_kernel<2, false>(unsigned int const*, "
                          "long long)") == "tree_up_kernel"
    assert devtrace.ident("sc_round_kernel<3>(ScParams)") == "sc_round_kernel"
    assert devtrace.ident("void at::native::(anonymous namespace)::f<int>"
                          "(int)") == "at::native::f"
    assert devtrace.ident("Memcpy HtoD (Pageable -> Device)") == "Memcpy HtoD"


def test_union_and_idle_by_span():
    ev = [(10, 20, "a"), (15, 30, "b"), (40, 50, "a")]
    merged = devtrace.union(ev)
    assert merged == [[10, 30], [40, 50]]
    assert devtrace.by_name(ev) == {"a": 20e-9, "b": 15e-9}
    spans = [("prove", 0, 100), ("kzg/open_msm", 25, 45)]
    idle = devtrace.idle_by_span(merged, spans, 0, 100, "between proves")
    # gaps [0, 10) and [50, 100) in prove, [30, 40) inside the MSM span
    assert abs(idle["prove"] - 60e-9) < 1e-15
    assert abs(idle["kzg/open_msm"] - 10e-9) < 1e-15
    assert devtrace.top(idle, 1) == [["prove", idle["prove"]]]


def test_busy_within():
    merged = [[10, 30], [40, 50], [60, 70]]
    # [25, 45) holds 5 + 5 busy; [55, 58) none; [65, 100) 5
    got = devtrace.busy_within(merged, [(25, 45), (55, 58), (65, 100)])
    assert abs(got - 15e-9) < 1e-18
    assert devtrace.busy_within(merged, []) == 0
