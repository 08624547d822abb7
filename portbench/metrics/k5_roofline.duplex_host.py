"""``trace.k5_roofline`` of a block of the host-paced loop cells
(duplex_msps.host)."""

from portbench.trace import k5_roofline as read  # noqa: F401
