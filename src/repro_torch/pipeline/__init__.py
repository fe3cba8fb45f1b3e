"""Stage partitioning and the pipelined serve and train executors."""
