"""Training step and the fault-tolerant loop around it."""
