"""Hand-written CUDA kernels of the serving path, their plain PyTorch
versions, the build that compiles them, and the LoRA dispatch."""
