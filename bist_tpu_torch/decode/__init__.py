"""Decoding: beam search."""
