"""Paged serving: prefill, decode quantum and engine."""
