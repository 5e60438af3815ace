"""PyTorch/CUDA port of the Loquetier runtime.

Mirrors the layout of the JAX package ``repro`` module for module, so each
counterpart is easy to find.  The port imports ``torch``, ``numpy`` and the
standard library only.  Its entry points run on ``cuda`` unless the caller
passes ``device="cpu"``; on CUDA tensors the hand-written kernels under
``repro_torch.kernels`` are the path, and their plain PyTorch versions run
only for tensors that lie on the CPU.
"""
