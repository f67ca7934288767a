"""conv1d: plain version (ref) and device-dispatching wrapper (ops)."""
