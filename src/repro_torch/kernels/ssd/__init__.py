"""Mamba-2 SSD chunk kernel (hand-written for sm_90a) and its wrapper."""
