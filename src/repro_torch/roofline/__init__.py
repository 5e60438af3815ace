"""Roofline terms of the port on the NVIDIA H100 SXM."""
