"""Planning layer of the port: the schedule-plan IR (serve ring share)."""
