"""Parallel plans (single device only in this package so far)."""
