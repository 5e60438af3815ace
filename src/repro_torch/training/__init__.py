"""Training substrate: optimizer and interruptible multi-LoRA trainers."""
