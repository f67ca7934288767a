"""Synthetic data pipelines and the byte tokenizer (numpy)."""
