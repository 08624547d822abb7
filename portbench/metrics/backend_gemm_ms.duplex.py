"""``trace.backend_gemm_ms`` of a block of the device-paced loop cells
(duplex_msps)."""

from portbench.trace import backend_gemm_ms as read  # noqa: F401
