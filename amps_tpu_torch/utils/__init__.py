"""Host utilities: logging with µs UTC timestamps and rate meters."""
