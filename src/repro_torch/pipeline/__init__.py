"""Stage partitioning and the pipelined serve executor."""
