"""Training plane of the port: the step, its state, the fused optimizer,
the schedules and the loop."""
