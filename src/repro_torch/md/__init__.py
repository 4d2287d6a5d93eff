"""Spin-lattice MD: lattice, state, neighbor tables, integrator, analysis,
engine, simulation facades."""
