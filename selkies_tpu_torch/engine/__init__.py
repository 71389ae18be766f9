"""Encoder sessions and their host-side plumbing."""
