"""Transformer building blocks (the functional attention of this slice)."""
