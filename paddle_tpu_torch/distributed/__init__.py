"""paddle.distributed subset of the port (single device so far)."""
