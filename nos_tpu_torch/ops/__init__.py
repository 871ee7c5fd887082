"""Attention op and its hand-written Hopper kernels (csrc/)."""
