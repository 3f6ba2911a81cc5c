"""Search machinery of the port: design space, schedules, verifier,
cost model, cascade and fast path."""
