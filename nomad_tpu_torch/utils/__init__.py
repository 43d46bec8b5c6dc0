"""Host-side helpers of the port: the config reader and the eval metrics."""
