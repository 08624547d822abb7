"""``trace.k5_roofline`` of a block of the device-paced loop cells
(duplex_msps)."""

from portbench.trace import k5_roofline as read  # noqa: F401
