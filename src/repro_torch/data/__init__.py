"""Synthetic federated data (numpy; the reference's draw order)."""
