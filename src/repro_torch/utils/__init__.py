"""Units and device helpers."""
