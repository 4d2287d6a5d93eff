"""Fused NEP-SPIN kernels: K1 (atom pass) and K2 (force pass)."""
