"""``trace.device_idle_pct`` of a block of the host-paced loop cells
(duplex_msps.host)."""

from portbench.trace import device_idle_pct as read  # noqa: F401
