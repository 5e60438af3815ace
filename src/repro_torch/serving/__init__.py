"""Serving substrate: requests, paged KV cache management, SLO tracking,
the scheduler and the unified engine."""
