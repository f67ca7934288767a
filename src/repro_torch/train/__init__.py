"""Training: AdamW, the loss and train step, and the fault-tolerant loop."""
