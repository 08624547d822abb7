"""``trace.backend_gemm_ms`` of a block of the host-paced loop cells
(duplex_msps.host)."""

from portbench.trace import backend_gemm_ms as read  # noqa: F401
