"""Model and run configurations."""
