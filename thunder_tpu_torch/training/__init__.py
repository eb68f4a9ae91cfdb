"""Training: optimizers and schedules, WER/CER, loggers, checkpoints and the CTC training loop."""
