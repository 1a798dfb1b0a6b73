"""Serving runtime: paged KV cache and the continuous-batching scheduler."""
