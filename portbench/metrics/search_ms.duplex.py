"""``_program_span.stage_ms`` of the loop's ``loop.search`` stage: device
ms of a call's last block, median over the window's calls, of the
device-paced loop cell (duplex_msps)."""

from portbench.metrics._program_span import stage_ms

read = stage_ms("loop.search")
