"""Serving: bucketing, chunked prefill and the slot engine."""
