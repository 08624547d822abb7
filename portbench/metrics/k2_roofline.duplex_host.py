"""``trace.k2_roofline`` of a block of the host-paced loop cells
(duplex_msps.host)."""

from portbench.trace import k2_roofline as read  # noqa: F401
