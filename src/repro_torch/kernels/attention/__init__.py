"""Flash-attention forward kernel (hand-written for sm_90a) and its wrapper."""
