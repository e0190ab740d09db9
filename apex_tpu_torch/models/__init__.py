"""Model definitions (the GPT inference subset of this slice)."""
