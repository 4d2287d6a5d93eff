"""Checkpoint-restart."""
