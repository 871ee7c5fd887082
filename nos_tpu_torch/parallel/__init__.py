"""Sequence attention (dense and ring) and the device mesh."""
