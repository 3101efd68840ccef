"""Training: AdamW, the single-GPU train step and the fault-tolerant loop."""
