"""The plain reference the benchmark holds the port against.

Plain PyTorch, float32 with TF32 off, computed in blocks of atoms.  It
imports nothing of the program (``repro_torch``) and nothing of the JAX
package: the NEP-SPIN mathematics (:mod:`.nep_spin`), the neighbor search
(:mod:`.neighbors`) and the integrator step (:mod:`.integrator`) are frozen
copies of the published equations, worked out again from the inputs the
benchmark makes (:mod:`perfbench.harness.inputs`).
"""
