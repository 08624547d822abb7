"""``trace.torch_ops_ms`` of a block of the device-paced loop cells
(duplex_msps)."""

from portbench.trace import torch_ops_ms as read  # noqa: F401
