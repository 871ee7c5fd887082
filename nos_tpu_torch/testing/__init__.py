"""Helpers for the port's tests that must import torch only (spawned ranks)."""
