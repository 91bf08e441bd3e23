"""Data sources and the prefetching loader."""
