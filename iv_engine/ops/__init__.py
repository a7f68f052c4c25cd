"""Compute kernels: the device-native replacement for the reference's
pandas/NumPy/SciPy compute tier (SURVEY.md §2, L3 layer)."""
