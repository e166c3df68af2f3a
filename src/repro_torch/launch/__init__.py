"""Launch helpers of the port: the simulated multi-host cluster."""
