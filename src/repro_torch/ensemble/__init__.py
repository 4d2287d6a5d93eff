"""Schedules and (later) the replica ensemble."""
