"""scan1: plain version (ref) and device-dispatching wrapper (ops)."""
