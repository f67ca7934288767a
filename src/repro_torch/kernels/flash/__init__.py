"""flash: plain version (ref) and device-dispatching wrapper (ops)."""
