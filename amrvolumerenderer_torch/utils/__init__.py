"""Host utilities of the port: stage timing and profiling."""
