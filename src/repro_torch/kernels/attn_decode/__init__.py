"""attn_decode: plain version (ref) and device-dispatching wrapper (ops)."""
