"""``trace.device_idle_pct`` of a block of the device-paced loop cells
(duplex_msps)."""

from portbench.trace import device_idle_pct as read  # noqa: F401
