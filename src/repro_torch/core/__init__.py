"""Planning layer of the port: the schedule-plan IR, the simulator and
BaPipe's analytic planner (profiler, partitioner, schedule cost models,
explorer, auto-plan)."""
