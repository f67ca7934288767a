"""Configuration and device helpers."""
