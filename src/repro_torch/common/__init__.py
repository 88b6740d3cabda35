"""Shared helpers: parameter trees, RNG plumbing, device resolution."""
