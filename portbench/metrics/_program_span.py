"""What the program-span readers share: the closed loop's spans and
stage samples (``amps_tpu_torch.utils.profiling``) of the calls in the
run's timed window that no profiled sub-window recorded.

Those calls are the last ``len(tr.host["call"])`` calls whose
``loop.entry`` span no profiler recorded: the warm-up calls come before
them, and the profiled calls carry the flag.  A reader returns None
where the trace records no window or the program has no such spans."""

import statistics


def _window(tr):
    """(the window's unprofiled ``loop.entry`` spans, the program's
    ``stage_samples``), or None."""
    n = len(tr.host.get("call", ())) if tr is not None else 0
    if not n:
        return None
    try:
        from amps_tpu_torch.utils.profiling import (collect, spans,
                                                    stage_samples)
    except ImportError:
        return None
    collect()
    entries = [s for s in spans("loop.entry") if not s.profiled][-n:]
    return entries, stage_samples


def _median(ms):
    return statistics.median(ms) if ms else None


def stage_ms(label: str):
    """A reader: the median over the window's calls of stage ``label``'s
    device ms in a call's last block."""
    def read(tr):
        found = _window(tr)
        if found is None:
            return None
        calls = {s.call for s in found[0]}
        return _median([m for c, m in found[1](label) if c in calls])
    return read


def entry_ms(tr):
    """The median over the window's calls of ``loop.entry``'s host ms."""
    found = _window(tr)
    return _median([s.ms for s in found[0]] if found else [])
