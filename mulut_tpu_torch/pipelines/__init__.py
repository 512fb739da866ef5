"""Entry points: evaluation (step 4), training, LUT transfer and LUT
fine-tuning (steps 1-3)."""
