"""Serving: the continuous-batching engine and compressed KV paging."""
