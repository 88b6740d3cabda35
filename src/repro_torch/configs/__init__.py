"""The paper's client-model configurations (copied from the reference)."""
