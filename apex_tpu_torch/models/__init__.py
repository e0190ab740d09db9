"""Model definitions: GPT (inference subset) and BERT with its MLM loss."""
