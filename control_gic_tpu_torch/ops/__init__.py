"""Numerics on tensors; see each module for its JAX counterpart."""
