"""The benchmark's harness: the manifest, the inputs made from the seed, the
program's run, the traced window, the work arithmetic and the check."""
