"""LM zoo: configuration schema, blocks and the serving entry points."""
