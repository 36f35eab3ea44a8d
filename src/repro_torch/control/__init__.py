"""The control plane of the port: so far only the serving engine's tick
sample (``telemetry.TickSample``); the rest waits for its slice."""
