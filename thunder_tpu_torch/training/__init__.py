"""Training: the optimizer factories, WER/CER and the CTC training loop."""
