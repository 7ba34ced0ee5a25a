"""Subpackage: the port's own audio and tokenizer helpers."""
