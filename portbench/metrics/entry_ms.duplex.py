"""``_program_span.entry_ms``: host ms of the loop's ``loop.entry`` a
call, median over the window's calls, of the device-paced loop cell
(duplex_msps)."""

from portbench.metrics._program_span import entry_ms as read  # noqa: F401
