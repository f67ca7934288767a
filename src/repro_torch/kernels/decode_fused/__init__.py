"""decode_fused: plain version (ref) and device-dispatching wrapper (ops)."""
