"""``trace.torch_ops_ms`` of a block of the host-paced loop cells
(duplex_msps.host)."""

from portbench.trace import torch_ops_ms as read  # noqa: F401
