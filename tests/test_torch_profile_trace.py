"""The profiler's trace-count check (``launch/profile_serve.whole_trace``)
on synthetic traces, on the CPU.

A profiled run on the card returns the trace's device spans (start, stop,
name) and the launches the port kernels' wrappers noted. A trace that
holds no device activity, or fewer calls of a port kernel than its wrapper
noted (the profiler dropped a record), is taken once more; only a second
short trace fails, naming both counts.
"""

import pytest

from repro_torch.launch.profile_serve import PORT_KERNELS, trace_shortfall, whole_trace

FLASH = "void (anonymous namespace)::flash_attention_mma_kernel<64>"
SLSTM = "void (anonymous namespace)::slstm_scan_kernel<false>(Args)"


def _spans(n_flash, n_slstm=0):
    spans, t = [(0, 3, "gemm")], 3
    for name, n in ((FLASH, n_flash), (SLSTM, n_slstm)):
        for _ in range(n):
            spans.append((t, t + 2, name))
            t += 3
    return spans


def _launched(n_flash, n_slstm=0):
    return [("flash_attention", "whisper.encoder")] * n_flash + [
        ("slstm_scan", "xlstm.slstm_loop")] * n_slstm


def _tracer(*traces):
    """A ``trace`` callable that returns the given (spans, launched) in
    turn, each with its index as the record, and counts its calls."""
    calls = []

    def trace():
        spans, launched = traces[len(calls)]
        calls.append(len(calls))
        return spans, launched, len(calls) - 1

    return trace, calls


def test_a_whole_trace_is_taken_once():
    trace, calls = _tracer((_spans(12, 6), _launched(12, 6)))
    assert whole_trace(trace, PORT_KERNELS) == 0 and calls == [0]


def test_a_short_first_trace_is_taken_again(capsys):
    again = []
    trace, calls = _tracer((_spans(11), _launched(12)), (_spans(12), _launched(12)))
    assert whole_trace(trace, PORT_KERNELS, again=lambda: again.append(1)) == 1
    assert calls == [0, 1] and again == [1]
    out = capsys.readouterr().out
    assert "flash_attention: 12 launches noted, 11 in the trace" in out
    assert "calls flash_attention 12" in out


def test_two_short_traces_fail_naming_both_counts():
    trace, _ = _tracer((_spans(11), _launched(12)), (_spans(10), _launched(12)))
    with pytest.raises(RuntimeError) as err:
        whole_trace(trace, PORT_KERNELS)
    assert "12 launches noted, 11 in the trace" in str(err.value)
    assert "12 launches noted, 10 in the trace" in str(err.value)


def test_a_trace_without_device_activity_is_taken_again():
    trace, calls = _tracer(([], []), (_spans(0, 6), _launched(0, 6)))
    assert whole_trace(trace, PORT_KERNELS) == 1 and calls == [0, 1]
    trace, _ = _tracer(([], []), ([], []))
    with pytest.raises(RuntimeError, match="no device activity; then the profiler recorded no"):
        whole_trace(trace, {})


@pytest.mark.parametrize("spans,launched,want", [
    (_spans(12, 6), _launched(12, 6), None),
    (_spans(12, 5), _launched(12, 6), "slstm_scan: 6 launches noted, 5 in the trace"),
    (_spans(3), [], None),  # no wrapper noted a launch: nothing to count
    ([], [], "the profiler recorded no device activity"),
])
def test_trace_shortfall(spans, launched, want):
    assert trace_shortfall(spans, launched, PORT_KERNELS) == want


def test_the_records_probe_needs_a_card(monkeypatch):
    """``launch/profile_records`` measures the profiler on the card only."""
    import torch

    from repro_torch.launch import profile_records

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        profile_records.main(["--rounds", "1"])
