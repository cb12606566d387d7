"""Fused and plain tensor ops of the inference path."""
